"""The port's device tooling (ROADMAP A11) against the JAX package's, on
the CPU.

``GET /debug/profile`` (a twin of tests/test_telemetry.py::
test_debug_profile_endpoint: 200, 409 while a window is open, 400 on a bad
``seconds``), with ``torch.profiler`` writing the window's Chrome trace,
which holds the engine's dispatch labels (the dispatches run on the
engine's own thread); ``start()`` on a process that never imported torch
reports an error and leaves torch out of ``sys.modules``; the prebake
manifest (a twin of tests/test_goodput.py::test_prebake_manifest_roundtrip)
and the ``--tiny`` prebake's manifest, read by the reference's
``load_prebaked_labels`` to the port's labels; and the kernel-cache
directory knob.
"""

import asyncio
import json
import os
import subprocess
import sys

from dynamo_tpu.telemetry import goodput as ref_goodput
from dynamo_tpu_torch.telemetry import profile as dprofile
from dynamo_tpu_torch.telemetry.goodput import (
    load_prebaked_labels,
    normalize_label,
    write_prebake_manifest,
)
from tests.test_torch_frontend import afetch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


async def test_debug_profile_endpoint_writes_a_trace_with_dispatch_labels(tmp_path):
    from dynamo_tpu_torch.entrypoint.inputs import EngineConfig, run_http
    from dynamo_tpu_torch.graphs.common import build_tiny_torch_engine, word_level_mdc

    engine = build_tiny_torch_engine(device="cpu")
    service = await run_http(EngineConfig.static_(engine, word_level_mdc("tele-prof")),
                             host="127.0.0.1", port=0)
    try:
        status, _, body = await afetch(service.port, "GET",
                                       f"/debug/profile?seconds=1.5&dir={tmp_path}")
        assert status == 200, body
        info = json.loads(body)
        assert info["profile_dir"].startswith(str(tmp_path)) and info["seconds"] == 1.5
        assert dprofile.active()
        status, _, _ = await afetch(service.port, "GET", "/debug/profile?seconds=0.2")
        assert status == 409
        status, _, _ = await afetch(service.port, "GET", "/debug/profile?seconds=abc")
        assert status == 400
        # a request inside the window: its dispatches carry their labels
        chat = {"model": "tele-prof", "max_tokens": 4, "temperature": 0,
                "messages": [{"role": "user", "content": "w1 w2 w3"}]}
        status, _, body = await afetch(service.port, "POST", "/v1/chat/completions", chat)
        assert status == 200, body
        for _ in range(60):
            if not dprofile.active():
                break
            await asyncio.sleep(0.1)
        assert not dprofile.active()
        trace = json.loads(open(os.path.join(info["profile_dir"], dprofile.TRACE_FILE)).read())
        names = {e.get("name") for e in trace["traceEvents"]}
        assert {"decode"} & names and any(str(n).startswith("prefill") for n in names), sorted(
            n for n in names if n and not str(n).startswith("aten::"))[:40]
        assert any(str(n).startswith("aten::") for n in names)  # the ops under them
        # the window is closed: a new one opens
        status, _, _ = await afetch(service.port, "GET", f"/debug/profile?seconds=0.1&dir={tmp_path}")
        assert status == 200
        for _ in range(30):
            if not dprofile.active():
                break
            await asyncio.sleep(0.1)
    finally:
        await service.close()
        await engine.close()


def test_start_on_a_torch_free_process_reports_an_error():
    """A frontend never imports torch: ``start()`` answers an error (the
    route's 501) instead of importing it; ``annotate`` is a no-op."""
    code = ("import sys, json; from dynamo_tpu_torch.telemetry import profile as p\n"
            "info = p.start(0.1)\n"
            "with p.annotate('decode'):\n    pass\n"
            "print(json.dumps([info, p.active(), 'torch' in sys.modules]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": ROOT}, timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    info, active, has_torch = json.loads(out.stdout.strip().splitlines()[-1])
    assert "error" in info and "torch" in info["error"]
    assert active is False and has_torch is False


def test_prebake_manifest_roundtrip(tmp_path):
    assert normalize_label("prefill@2048") == "prefill"
    assert normalize_label("decode_eos") == "decode"
    assert normalize_label("decode_multi@H4") == "decode_multi"
    programs = [("prefill@512", 3.1), ("prefill@2048", 6.0), ("decode", 11.2),
                ("decode_eos", 10.9), ("decode_multi@H4", 31.0)]
    path = write_prebake_manifest(str(tmp_path), programs)
    assert path is not None
    assert load_prebaked_labels(str(tmp_path)) == frozenset({"prefill", "decode", "decode_multi"})
    doc = json.loads((tmp_path / "prebake_manifest.json").read_text())
    assert doc["programs"] == [[lbl, s] for lbl, s in programs]
    assert load_prebaked_labels(str(tmp_path / "nope")) == frozenset()
    assert load_prebaked_labels(None) == frozenset()
    # the two packages read each other's manifests to the same labels
    other = tmp_path / "ref"
    other.mkdir()
    ref_goodput.write_prebake_manifest(str(other), programs)
    assert load_prebaked_labels(str(other)) == ref_goodput.load_prebaked_labels(str(tmp_path))


def test_tiny_prebake_writes_a_manifest_the_reference_reads(tmp_path):
    cache = tmp_path / "kernels"
    env = {**os.environ, "PYTHONPATH": ROOT, "DYN_KERNEL_CACHE_DIR": str(cache)}
    out = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.tools.prebake", "--tiny", "--device", "cpu",
         "--decode-horizon", "4", "--spec-k", "2", "--json", str(tmp_path / "doc.json")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    doc = json.loads((tmp_path / "doc.json").read_text())
    assert doc["cache_dir"] == str(cache)
    assert doc["kernels"]["built"] is False and "CPU" in doc["kernels"]["reason"]
    manifest = json.loads((cache / "prebake_manifest.json").read_text())
    assert manifest["kernels"]["built"] is False and manifest["graphs"] == []
    labels = load_prebaked_labels(str(cache))
    assert labels == ref_goodput.load_prebaked_labels(str(cache))
    assert {"prefill", "prefill_packed", "prefill_chunk", "mixed_step", "decode",
            "decode_multi", "spec_verify"} <= labels
    assert [p[0] for p in doc["programs"]][:1] == ["prefill@16"]


def test_the_kernel_cache_directory_follows_its_knob(tmp_path, monkeypatch):
    from dynamo_tpu_torch.ops import _build
    from dynamo_tpu_torch.runtime.config import kernel_cache_dir

    monkeypatch.delenv("DYN_KERNEL_CACHE_DIR", raising=False)
    assert kernel_cache_dir() == os.path.join(ROOT, "build", "kernels")
    monkeypatch.setenv("DYN_KERNEL_CACHE_DIR", str(tmp_path / "k"))
    assert kernel_cache_dir() == str(tmp_path / "k")
    assert _build._target("flash_prefill_attention").parent == tmp_path / "k"
