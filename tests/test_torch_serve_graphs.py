"""The port's serve graphs and their supervisor, on the CPU.

- The graphs' word-level card tokenizes as the reference's (which the
  ``tokenizers`` package builds), and ``load_graph`` orders services as the
  reference's.
- ``hello_world`` through the CLI (``python -m dynamo_tpu_torch.serve``):
  brought up, asked, and exit 0 on SIGTERM; ``agg`` with the echo engine and
  with ``tiny-torch`` on the CPU in KV mode (its greedy text equal to an
  in-process engine's), each brought up, asked and shut down.
- ``DYN_FAULT`` arms the fault injector in a graph's child; a malformed spec
  fails the launch and the child.
- ``slow``, as their module's: twins of ``tests/test_fault_tolerance.py``'s
  agg-graph kill cases (a worker, the fabric) and its three supervisor cases.
"""

import asyncio
import http.client
import json
import os
import signal
import subprocess
import sys
import time

import pytest

from dynamo_tpu.graphs import common as j_common
from dynamo_tpu.sdk import load_graph as j_load_graph
from dynamo_tpu_torch.graphs import common as t_common
from dynamo_tpu_torch.sdk import load_graph
from dynamo_tpu_torch.sdk.supervisor import ManagedProcess
from dynamo_tpu_torch.serve import _free_port, check_faults, serve_graph
from dynamo_tpu_torch.testing.faults import FaultSpecError
from tests.test_torch_frontend import afetch, sse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fast discovery removal and a quick echo, as the reference's FT suite (a
# 2 s lease a slow boot may lose; the supervisor restarts such a child)
FT_ENV = {"DYN_LEASE_TTL_S": "2", "DYN_TOKEN_ECHO_DELAY_MS": "50", "DYN_HTTP_HOST": "127.0.0.1"}
GRAPH_ENV = {"DYN_HTTP_HOST": "127.0.0.1"}  # the default lease, for the tier-1 graphs


async def wait_models(port: int, timeout: float = 60.0) -> list:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        try:
            st, _, body = await afetch(port, "GET", "/v1/models", timeout=5)
            if st == 200 and json.loads(body)["data"]:
                return json.loads(body)["data"]
        except OSError:
            pass
        await asyncio.sleep(0.2)
    raise TimeoutError("models never appeared")


async def chat(port: int, text: str, max_tokens: int = 8, stream: bool = False,
               model: str = "graph-model"):
    return await afetch(port, "POST", "/v1/chat/completions", {
        "model": model, "messages": [{"role": "user", "content": text}],
        "max_tokens": max_tokens, "stream": stream}, timeout=60)


async def complete(port: int, text: str, model: str = "graph-model", stream: bool = False):
    """A completion of the raw text: the echo engine streams its words back."""
    st, _, data = await afetch(port, "POST", "/v1/completions", {
        "model": model, "prompt": text, "max_tokens": 16, "stream": stream}, timeout=60)
    if stream:
        return st, "".join(e.json()["choices"][0]["text"] for e in sse(data)
                           if e.event is None and e.json().get("choices"))
    return st, json.loads(data)["choices"][0]["text"]


def test_word_level_card_tokenizes_as_the_reference():
    ref = j_common.word_level_mdc("m").load_tokenizer()
    ours = t_common.word_level_mdc("m").load_tokenizer()
    for text in ("w1 w2 w3", "w0 hello w60 w61", "  w5\tw6\nw7 ", "w1,w2 w3.", ""):
        assert ours.encode(text).ids == ref.encode(text).ids, text
        ids = ref.encode(text).ids
        assert ours.decode(ids) == ref.decode(ids)
    assert ours.decode(list(range(64))) == ref.decode(list(range(64)))
    assert t_common.word_level_mdc("m").eos_token_ids == [2]


@pytest.mark.parametrize("graph", ["agg", "disagg", "hello_world"])
def test_load_graph_orders_services_as_the_reference(graph):
    ours = [(s.name, s.replicas, s.deps) for s in load_graph(f"dynamo_tpu_torch.graphs.{graph}")]
    ref = [(s.name, s.replicas, s.deps) for s in j_load_graph(f"dynamo_tpu.graphs.{graph}")]
    assert ours == ref


async def test_hello_world_graph_through_the_cli_exits_0_on_sigterm(tmp_path):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("DYN_FABRIC_ADDR", None)
    log = open(tmp_path / "serve.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.serve", "dynamo_tpu_torch.graphs.hello_world",
         "--env", f"DYN_HTTP_PORT={port}", "--env", "DYN_HTTP_HOST=127.0.0.1"],
        cwd=str(tmp_path), env=env, stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
    try:
        models = await wait_models(port)
        st, text = await complete(port, "w1 w2 w3", model=models[0]["id"], stream=True)
        assert st == 200 and text.split() == ["w1", "w2", "w3"]
        proc.send_signal(signal.SIGTERM)
        assert await asyncio.to_thread(proc.wait, 60) == 0
    finally:
        # the supervisor's children too, whatever happened to it
        stop_group(proc)
        log.close()


def stop_group(proc) -> None:
    """SIGTERM the process group ``proc`` leads, then SIGKILL what is left."""
    for sig, wait in ((signal.SIGTERM, 30), (signal.SIGKILL, 10)):
        try:
            os.killpg(proc.pid, sig)
        except ProcessLookupError:
            return
        try:
            proc.wait(wait)
        except subprocess.TimeoutExpired:
            pass


async def test_agg_graph_with_the_echo_engine():
    port = _free_port()
    sup = await serve_graph("agg", extra_env={**GRAPH_ENV, "DYN_HTTP_PORT": str(port)})
    try:
        assert set(sup.procs) == {"fabric", "Worker-0", "Worker-1", "Frontend-0"}
        await wait_models(port)
        for _ in range(2):
            st, text = await complete(port, "w4 w5 w6")
            assert st == 200 and text.split() == ["w4", "w5", "w6"]
    finally:
        await sup.stop_all()
    assert all(not p.running for p in sup.procs.values())


async def test_agg_graph_with_tiny_torch_workers_in_kv_mode():
    """Two tiny-torch workers on the CPU behind a KV frontend: the greedy
    text equals an in-process engine's with the same seeded weights."""
    from dynamo_tpu_torch.http.service import ModelExecution
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.pipeline.context import Context

    port = _free_port()
    sup = await serve_graph("dynamo_tpu_torch.graphs.agg", extra_env={
        **GRAPH_ENV, "DYN_HTTP_PORT": str(port), "DYN_GRAPH_ENGINE": "tiny-torch", "DYN_DEVICE": "cpu",
        "DYN_ROUTER_MODE": "kv"})
    body = {"model": "graph-model", "messages": [{"role": "user", "content": "w1 w2 w3 w4 " * 6}],
            "max_tokens": 8, "temperature": 0}
    try:
        await wait_models(port)
        texts = []
        for _ in range(2):
            st, _, data = await afetch(port, "POST", "/v1/chat/completions", body, timeout=60)
            assert st == 200
            texts.append(json.loads(data)["choices"][0]["message"]["content"])
    finally:
        await sup.stop_all()
    engine = t_common.build_tiny_torch_engine(device="cpu")
    try:
        execution = ModelExecution(t_common.word_level_mdc("graph-model"), engine.generate)
        local = ""
        async for item in execution.chat_stream(ChatCompletionRequest.from_dict(body), Context()):
            for ch in (item.data or {}).get("choices", []):
                local += (ch.get("delta") or {}).get("content") or ""
    finally:
        await engine.close()
    assert texts == [local, local] and local


async def test_dyn_fault_arms_the_injector_in_a_graphs_child():
    """``DYN_FAULT`` reaches every child and arms its injector there (the
    child logs it before it serves); a malformed spec fails the launch and a
    child alike, with the parser's error, instead of running unfaulted."""
    with pytest.raises(FaultSpecError, match="unknown DYN_FAULT action"):
        await serve_graph("hello_world", extra_env={"DYN_FAULT": "kill_after_tokns=3"})
    check_faults({"DYN_FAULT": "delay_dispatch=1,every=2"})
    check_faults({})
    cmd = [sys.executable, "-m", "dynamo_tpu_torch.sdk.runner", "dynamo_tpu_torch.graphs.agg:Worker"]
    rc = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, DYN_FAULT="corrupt_kv=rot"),
                        capture_output=True, text=True, timeout=60)
    assert rc.returncode != 0 and "corrupt_kv mode must be bits|truncate" in rc.stderr
    # a good spec: the child arms it, then goes on to serve (no fabric here;
    # it is stopped once the line is seen)
    env = dict(os.environ, DYN_FAULT="kill_after_tokens=3")
    env.pop("DYN_FABRIC_ADDR", None)
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    try:
        armed = await asyncio.wait_for(asyncio.to_thread(_line_with, proc.stderr, "armed"), 60)
    finally:
        proc.kill()
        proc.wait(10)
    assert "fault injection armed: DYN_FAULT=kill_after_tokens=3" in armed


def _line_with(stream, text: str) -> str:
    for line in stream:
        if text in line:
            return line
    return ""


# ------------------------------------ twins of tests/test_fault_tolerance.py


@pytest.mark.slow
async def test_worker_kill_restart_and_recovery():
    port = _free_port()
    sup = await serve_graph("dynamo_tpu_torch.graphs.agg",
                            extra_env={**FT_ENV, "DYN_HTTP_PORT": str(port)},
                            replica_overrides={"Worker": 1})
    try:
        await wait_models(port)
        st, _, _ = await chat(port, "w1 w2 w3")
        assert st == 200
        worker = sup["Worker-0"]
        prev = worker.restarts
        kill = asyncio.get_running_loop().call_later(0.3, worker.kill)
        st, _, data = await chat(port, " ".join(f"w{i}" for i in range(40)), max_tokens=40, stream=True)
        kill.cancel()
        assert st == 200  # the stream ended (an error event or its end), never hung
        await worker.wait_restarted(prev, timeout=30)
        for _ in range(100):
            st, _, data = await chat(port, "w5 w6")
            if st == 200 and json.loads(data).get("choices"):
                break
            await asyncio.sleep(0.3)
        else:
            pytest.fail("traffic never recovered after the worker's restart")
    finally:
        await sup.stop_all()


@pytest.mark.slow
async def test_fabric_kill_restart_recovery():
    port = _free_port()
    sup = await serve_graph("dynamo_tpu_torch.graphs.agg",
                            extra_env={**FT_ENV, "DYN_HTTP_PORT": str(port)},
                            replica_overrides={"Worker": 1})
    try:
        await wait_models(port)
        assert (await chat(port, "w1 w2 w3"))[0] == 200
        fabric = sup["fabric"]
        prev = fabric.restarts
        kill = asyncio.get_running_loop().call_later(0.3, fabric.kill)
        try:
            await chat(port, " ".join(f"w{i}" for i in range(40)), max_tokens=40, stream=True)
        except (OSError, http.client.HTTPException):
            pass  # the frontend may die with its lease, cutting the stream: it must not hang
        kill.cancel()
        await fabric.wait_restarted(prev, timeout=30)
        deadline = time.monotonic() + 90
        while True:
            try:
                st, _, data = await chat(port, "w7 w8 w9", max_tokens=4)
                if st == 200 and json.loads(data)["choices"][0]["message"]["content"]:
                    break
            except (OSError, http.client.HTTPException):
                pass  # the frontend may be mid-restart
            if time.monotonic() > deadline:
                pytest.fail("traffic never recovered after the fabric's restart")
            await asyncio.sleep(0.5)
    finally:
        await sup.stop_all()


@pytest.mark.slow
async def test_supervisor_crash_loop_quarantines_instead_of_giving_up():
    gaveup: list[str] = []
    proc = ManagedProcess([sys.executable, "-c", "import sys; sys.exit(3)"], name="crasher",
                          max_restarts=2, backoff_s=0.05, restart_window_s=60,
                          quarantine_retry_s=0.2, quarantine_retry_max_s=0.5, on_giveup=gaveup.append)
    await proc.start()
    for _ in range(600):
        if proc.quarantined:
            break
        await asyncio.sleep(0.1)
    assert proc.quarantined and proc.state == "quarantined"
    assert gaveup == ["crasher"]
    assert not proc._monitor_task.done()
    before = proc.restarts
    for _ in range(600):
        if proc.restarts > before:
            break
        await asyncio.sleep(0.05)
    assert proc.restarts > before and proc.quarantines == 1
    await proc.stop()


@pytest.mark.slow
async def test_supervisor_injected_kills_exempt_from_crash_budget():
    proc = ManagedProcess([sys.executable, "-c", "import time; time.sleep(60)"], name="victim",
                          max_restarts=2, backoff_s=0.05, restart_window_s=60, forward_output=False)
    await proc.start()
    try:
        for _ in range(4):
            prev = proc.restarts
            for _ in range(600):
                if proc.running:
                    break
                await asyncio.sleep(0.05)
            proc.kill()
            await proc.wait_restarted(prev, timeout=30.0)
        assert not proc.quarantined and proc.restarts == 4 and proc._crash_times == []
    finally:
        await proc.stop()


@pytest.mark.slow
async def test_supervisor_planned_exit_exempt_from_crash_budget():
    for sig in (signal.SIGTERM, signal.SIGKILL):  # the drain, then its deadline's SIGKILL
        proc = ManagedProcess([sys.executable, "-c", "import time; time.sleep(60)"], name="retiree",
                              max_restarts=2, backoff_s=0.05, restart_window_s=60, forward_output=False)
        await proc.start()
        try:
            proc.mark_planned_exit()
            os.kill(proc.pid, sig)
            for _ in range(600):
                if not proc.running and proc._monitor_task.done():
                    break
                await asyncio.sleep(0.05)
            assert proc._monitor_task.done() and proc.restarts == 0
            assert not proc.quarantined and proc._crash_times == []
            assert proc.planned_exits_total == 1 and proc.state == "stopped"
        finally:
            await proc.stop()
