"""The frontend stays free of the accelerator framework.

A frontend's event loop must never block on importing torch (or, in the
JAX package, jax): importing torch takes seconds, and a frontend whose loop
stalls that long loses its fabric lease. Each case imports one module in a
fresh interpreter and fails if ``torch`` (the port) or ``jax`` (the
reference) is then in ``sys.modules``: the HTTP service, discovery, the
routers, the fabric client, the distributed runtime, the CLI and the
supervisor, the engine-facing inputs, the rendezvous barrier, and the
multi-node config a supervisor may read (the port's
``parallel/multinode.py``; the reference's ``parallel/multihost.py``, which
holds it there); on the port's side also the profiler hooks the HTTP
service imports, model resolution, the image processor, the encode
client's module and the multimodal graph.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRONTEND = ["http.service", "discovery", "router", "kv_router", "fabric.client",
            "runtime.distributed", "run", "serve", "entrypoint.inputs", "runtime.barrier"]
# the port's own frontend-side modules whose reference twins import jax
# (the encode worker's module holds EncodeClient, which a prefill-side
# process or a frontend imports; the multimodal graph's Frontend)
PORT_ONLY = ["telemetry.profile", "hub", "multimodal.processor", "multimodal.encode_worker",
             "graphs.multimodal"]
CASES = ([(f"dynamo_tpu_torch.{m}", "torch")
          for m in FRONTEND + ["parallel.multinode"] + PORT_ONLY]
         + [(f"dynamo_tpu.{m}", "jax") for m in FRONTEND + ["parallel.multihost"]])


@pytest.mark.parametrize("module,framework", CASES, ids=[m for m, _ in CASES])
def test_a_frontend_module_imports_without_the_framework(module, framework):
    code = (f"import importlib, sys; importlib.import_module({module!r}); "
            f"print(sorted(m for m in sys.modules if m == {framework!r} "
            f"or m.startswith({framework + '.'!r})))")
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]", f"{module} imports {framework}: {out.stdout.strip()}"


# a graph worker holds its lease from its first line: what it imports on its
# event loop before the engine is built must leave torch to the executor
GRAPH_WORKER = """
import asyncio, importlib.abc, sys, threading
first = []


class Watch(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "torch" and not first:
            first.append(threading.current_thread() is threading.main_thread())


sys.meta_path.insert(0, Watch())
from dynamo_tpu_torch.graphs.common import build_engine_from_env


async def main():
    engine, mdc = await build_engine_from_env()
    await engine.close()
    return engine.config.max_batch


print(asyncio.run(main()), first)
"""


def test_a_graph_worker_imports_torch_off_its_event_loop(tmp_path):
    """``build_engine_from_env`` with ``DYN_GRAPH_ENGINE=torch`` (the disagg
    and agg graphs' workers) imports torch first on an executor thread,
    never on the event loop that keeps the worker's fabric lease alive."""
    import json

    from tests.util import make_test_tokenizer

    (tmp_path / "config.json").write_text(json.dumps({
        "vocab_size": 64, "hidden_size": 64, "intermediate_size": 128,
        "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
        "head_dim": 16, "rope_theta": 10000.0, "max_position_embeddings": 64}))
    make_test_tokenizer()._hf.save(str(tmp_path / "tokenizer.json"))
    env = {**os.environ, "PYTHONPATH": REPO, "DYN_GRAPH_ENGINE": "torch",
           "DYN_MODEL_PATH": str(tmp_path), "DYN_DEVICE": "cpu", "DYN_MAX_BATCH": "2"}
    out = subprocess.run([sys.executable, "-c", GRAPH_WORKER], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split("\n")[-2] == "2 [False]", out.stdout[-2000:]
