"""The port's KV events, hash chains, stuck-dispatch watchdog and
``POST /clear_kv_blocks`` against the JAX package's, on the CPU.

* ``tokens.py``: block hashes and chains BIT-IDENTICAL to
  ``dynamo_tpu.tokens``'s pure-Python path (and its native one, where the
  build has it) for random token lists with partial tails, salts, and
  ``TokenBlockSequence`` grown token by token and truncated;
* ``TorchEngine`` and ``JaxEngine`` (the tiny Llama, f32) given the same
  requests emit equal ``on_blocks_stored`` event lists (block hash, parent
  hash, tokens, block id) and equal removed hashes, with and without a
  block manager, through preemption;
* the watchdog: the reference's lifeguard case
  (test_lifeguard.py:512) on the port, its stuck call patched into the
  runner call the port's loop dispatches; it trips with
  ``watchdog_stuck`` and refuses new work with ``worker_unavailable``;
* ``POST /clear_kv_blocks`` answers as the JAX frontend does: the same
  body, the tiers emptied, ``on_cache_cleared`` fired.
"""

import asyncio
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dynamo_tpu import tokens as jtok
from dynamo_tpu.block_manager.layout import LayoutConfig as JLayout
from dynamo_tpu.block_manager.manager import TieredBlockManager as JManager
from dynamo_tpu.engine.jax_engine.engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.engine.jax_engine.model_runner import ModelRunner
from dynamo_tpu.entrypoint import inputs as ref_inputs
from dynamo_tpu.models import llama as jl
from dynamo_tpu.pipeline.context import Context as JaxContext
from dynamo_tpu.protocols import common as jp
from dynamo_tpu.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch import tokens as ttok
from dynamo_tpu_torch.block_manager import LayoutConfig, TieredBlockManager
from dynamo_tpu_torch.engine.torch_engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.engine.torch_engine.model_runner import TorchModelRunner
from dynamo_tpu_torch.engine.torch_engine.weights import params_from_jax
from dynamo_tpu_torch.entrypoint import inputs as port_inputs
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.protocols import common as tp
from tests.test_torch_frontend import afetch, cards, write_model_dir

BS, VOCAB = 4, 128


# ------------------------------------------------------------ hash chains

@pytest.mark.parametrize("seed,n,block_size,salt", [
    (0, 0, 4, 0), (1, 3, 4, 0), (2, 16, 4, 0), (3, 37, 4, 7), (4, 129, 16, 0),
    (5, 1000, 16, 2**40 + 3), (6, 64, 1, 0),
])
def test_hash_chains_are_bit_identical(seed, n, block_size, salt):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 2**32, n, dtype=np.uint64).astype(int).tolist()
    ours = ttok.compute_seq_hash_chain(toks, block_size, salt)
    assert ours == jtok._py_seq_hash_chain(toks, block_size, salt)
    assert ours == jtok.compute_seq_hash_chain(toks, block_size, salt)
    assert len(ours) == n // block_size
    parent = 0
    for i, h in enumerate(ours):
        blk = toks[i * block_size:(i + 1) * block_size]
        assert h == ttok.compute_block_hash(parent, blk, salt) == jtok._py_block_hash(parent, blk, salt)
        parent = h


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_token_block_sequence_grows_and_truncates_as_the_reference(seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 50000, 75).tolist()
    ours, ref = ttok.TokenBlockSequence(toks[:10], 8), jtok.TokenBlockSequence(toks[:10], 8)
    for t in toks[10:]:
        a, b = ours.append(t), ref.append(t)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.tokens, a.block_hash, a.parent_hash, a.position) == (
                b.tokens, b.block_hash, b.parent_hash, b.position)
    for cut in (74, 33, 32, 5, 0):
        ours.truncate(cut)
        ref.truncate(cut)
        assert (len(ours), ours.tokens, ours.block_hashes(), ours.last_hash()) == (
            len(ref), ref.tokens, ref.block_hashes(), ref.last_hash())
    assert [b.block_hash for b in ours.extend(toks)] == [b.block_hash for b in ref.extend(toks)]
    with pytest.raises(ValueError):
        ttok.TokenBlockSequence(block_size=0)


# ----------------------------------------------------------------- engines

@pytest.fixture(scope="module")
def params():
    cfg = jl.LlamaConfig.tiny(vocab_size=VOCAB)
    jparams = jl.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    return cfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _engines(params, *, nb=64, chunk=0, bm=False, ekw=None):
    cfg, jparams, tparams = params
    dims = dict(num_blocks=nb, block_size=BS, max_batch=4, max_model_len=64)
    ecfg = dict(dims, watermark_blocks=2, preempt_backoff_ms=0.0, **(ekw or {}))
    lay = dict(num_layers=cfg.num_layers, page_size=BS, num_kv_heads=cfg.num_kv_heads,
               head_dim=cfg.head_dim, dtype="float32")
    jeng = JaxEngine(ModelRunner(cfg, jparams, kv_dtype=jnp.float32, prefill_chunk_tokens=chunk,
                                 **dims), JaxEngineConfig(**ecfg),
                     block_manager=JManager(JLayout(**lay), 64) if bm else None)
    teng = TorchEngine(TorchModelRunner(tl.LlamaConfig.tiny(vocab_size=VOCAB), tparams,
                                        device="cpu", prefill_chunk_tokens=chunk, **dims),
                       TorchEngineConfig(**ecfg),
                       block_manager=TieredBlockManager(LayoutConfig(**lay), 64) if bm else None)
    return jeng, teng


def _req(mod, prompt, n):
    return mod.PreprocessedRequest(token_ids=list(prompt), sampling=mod.SamplingOptions(greedy=True),
                                   stop=mod.StopConditions(max_tokens=n, ignore_eos=True))


async def _stream(engine, prompt, n):
    mod, ctx = (tp, tp.Context) if isinstance(engine, TorchEngine) else (jp, JaxContext)
    toks, final = [], None
    async for o in engine.generate(_req(mod, prompt, n), ctx()):
        toks.extend(o.token_ids)
        if o.finish_reason is not None:
            final = (o.finish_reason.value, (o.error or {}).get("code"))
    return toks, final


SHARED = [7, 3, 9, 12, 40, 41, 42, 43, 5]
EVENT_PROMPTS = [SHARED + [1, 2, 3], SHARED + [60], list(range(20, 31)), SHARED]


@pytest.mark.parametrize("case", ["plain", "chunked_with_tiers", "preempting"])
async def test_kv_events_equal_the_reference(params, case):
    """The same requests, concurrently: equal Stored event lists (in
    order) and equal Removed hashes, chains the recomputation from the
    tokens gives."""
    kw = {"plain": {}, "chunked_with_tiers": dict(chunk=8, bm=True),
          "preempting": dict(nb=14)}[case]
    got = {}
    for name, eng in zip(("jax", "torch"), _engines(params, **kw)):
        stored, removed = [], []
        eng.on_blocks_stored = stored.extend
        eng.on_blocks_removed = removed.extend
        outs = await asyncio.gather(*(_stream(eng, p, 14) for p in EVENT_PROMPTS))
        if eng.block_manager is not None:
            for _ in range(100):  # the offloads' Removed events come with their frees
                if not (eng._tier_tasks if name == "torch" else eng._remote_tasks):
                    break
                await asyncio.sleep(0.02)
        got[name] = (outs, stored, sorted(removed), eng)
    assert got["torch"][0] == got["jax"][0]
    assert got["torch"][1] == got["jax"][1]
    assert got["torch"][2] == got["jax"][2]
    stored = got["torch"][1]
    assert stored and all(set(e) == {"block_hash", "parent_hash", "tokens", "block_id"}
                          for e in stored)
    for (toks, _), prompt in zip(got["torch"][0], EVENT_PROMPTS):
        chain = ttok.compute_seq_hash_chain(prompt + toks, BS)
        assert set(chain[:len(prompt) // BS]) <= {e["block_hash"] for e in stored}
    if case == "preempting":
        jstats = got["jax"][3].stats
        assert got["torch"][3].stats.preemptions == sum(jstats.preemptions_by_class.values()) > 0
    for *_, eng in got.values():
        await eng.close()


# ---------------------------------------------------------------- watchdog

async def test_watchdog_trips_on_a_stuck_dispatch(params):
    """test_lifeguard.py:512 on the port: the warm budget is 0.15 s, a
    dispatch sleeps 1.5 s; every stream ends with ``watchdog_stuck``,
    ``on_watchdog_trip`` fires once, the trip is counted and new work is
    refused with ``worker_unavailable``."""
    _, teng = _engines(params, ekw=dict(watchdog_min_s=0.15, watchdog_cold_s=10.0,
                                        watchdog_mult=1.0))
    toks, _ = await _stream(teng, [3, 7, 11], 14)
    assert len(toks) == 14
    assert {"prefill", "decode"} <= set(teng._dispatch_ema)
    tripped = []
    teng.on_watchdog_trip = lambda: tripped.append(1)
    runner = teng.runner
    H = teng.config.decode_horizon
    name = "decode_multi" if H > 1 else "decode"  # the call the loop dispatches
    real = getattr(runner, name)

    def stuck(*a, **k):
        time.sleep(1.5)
        return real(*a, **k)

    setattr(runner, name, stuck)
    toks, final = await asyncio.wait_for(_stream(teng, [9, 2, 5], 8), timeout=15)
    assert final == ("error", "watchdog_stuck")
    assert teng.stats.watchdog_trips == 1 and tripped == [1]
    _, final = await _stream(teng, [1, 2], 2)
    assert final == ("error", "worker_unavailable")
    await teng.close()
    assert teng.stats.watchdog_trips == 1


async def test_watchdog_stays_quiet_under_its_budget_and_can_be_off(params):
    """A warm engine under its budget never trips; watchdog_min_s <= 0
    starts no watchdog at all."""
    _, teng = _engines(params, ekw=dict(watchdog_min_s=0.5, watchdog_cold_s=10.0))
    for p in ([4, 5, 6], [7, 8, 9, 10]):
        toks, final = await _stream(teng, p, 6)
        assert len(toks) == 6 and final == ("length", None)
    assert teng.stats.watchdog_trips == 0 and teng._watchdog_task is not None
    await teng.close()
    _, off = _engines(params, ekw=dict(watchdog_min_s=0.0))
    await _stream(off, [4, 5, 6], 3)
    assert off._watchdog_task is None
    await off.close()


# ------------------------------------------------------------ clear route

async def test_clear_kv_blocks_route_answers_as_the_jax_frontend(params, tmp_path):
    """test_protocol_parity.py:124 on both frontends: each engine's host
    tier holds a block, and a live request is running; the answers are
    equal, the tiers empty and ``on_cache_cleared`` fired."""
    model_dir = write_model_dir(tmp_path / "tiny")
    ref_mdc, port_mdc = cards(model_dir)
    jeng, teng = _engines(params, bm=True)
    cleared = []
    for eng in (jeng, teng):
        eng.on_cache_cleared = lambda e=eng: cleared.append(type(e).__name__)
    cfg = params[0]
    kb = np.zeros((cfg.num_layers, cfg.num_kv_heads, 1, BS, cfg.head_dim), np.float32)
    jeng.block_manager.store_blocks([12345], kb, kb)
    teng.block_manager.store_blocks([12345], kb, kb)
    drt = await DistributedRuntime.detached()
    ref_svc = await ref_inputs.run_http(drt, ref_inputs.EngineConfig.static_(jeng, ref_mdc),
                                        host="127.0.0.1", port=0)
    port_svc = await port_inputs.run_http(port_inputs.EngineConfig.static_(teng, port_mdc),
                                          host="127.0.0.1", port=0)
    try:
        bodies = []
        for port in (ref_svc.port, port_svc.port):
            status, _, body = await afetch(port, "POST", "/clear_kv_blocks")
            assert status == 200
            bodies.append(body)
        import json

        ref_body, port_body = (json.loads(b) for b in bodies)
        assert port_body == ref_body
        workers = port_body["cleared_worker_groups"][0]["workers"][0]
        assert workers == {"instance": "local", "status": "cleared",
                           "offload_blocks_dropped": 1, "active_sequences_kept": 0}
        assert jeng.block_manager.stats.host_blocks_used == 0
        assert teng.block_manager.stats.host_blocks_used == 0
        assert sorted(cleared) == ["JaxEngine", "TorchEngine"]
        assert teng.block_manager.lookup_prefix([12345]) == 0
    finally:
        await port_svc.close()
        await ref_svc.close()
        await drt.close()
        await jeng.close()
        await teng.close()


async def test_clear_kv_blocks_without_support_or_models():
    """A model without ``clear_fn`` lands in failed_worker_groups; no model
    at all gets the reference's message."""
    from dynamo_tpu_torch.http.service import HttpService, ModelExecution, ModelManager

    class NoClear:
        async def generate(self, *a):
            yield None

    manager = ModelManager()
    svc = HttpService(manager, host="127.0.0.1", port=0)
    await svc.start()
    try:
        import json

        _, _, body = await afetch(svc.port, "POST", "/clear_kv_blocks")
        assert json.loads(body) == {"message": "No active worker groups found"}
        mdc = type("Card", (), {"name": "m"})
        execution = ModelExecution.__new__(ModelExecution)
        execution.mdc, execution.engine_fn, execution.clear_fn = mdc, NoClear().generate, None
        manager.add_model("m", execution)
        _, _, body = await afetch(svc.port, "POST", "/clear_kv_blocks")
        assert json.loads(body) == {"cleared_worker_groups": [], "failed_worker_groups": [
            {"name": "m", "status": "worker group doesn't support clear_kv_blocks"}]}
    finally:
        await svc.close()


def test_cli_checkpoints_the_tiers_at_shutdown_and_restores_them(tmp_path):
    """``python -m dynamo_tpu_torch.run`` with tiers and
    ``DYN_WARM_RESTART_DIR``: the first run checkpoints what its requests
    offloaded (a manifest and its pages), the second restores it before
    serving and onboards the repeated prompt's prefix."""
    import json
    import os
    import subprocess
    import sys

    from tests.test_torch_frontend import ROOT

    model_dir = write_model_dir(tmp_path / "model")
    batch = tmp_path / "batch.jsonl"
    prompt = "the quick brown fox jumps over the lazy dog " * 2
    batch.write_text(json.dumps({"text": prompt, "max_tokens": 6}) + "\n")
    warm = tmp_path / "warm"
    env = dict(os.environ, PYTHONPATH=ROOT, DYN_KV_HOST_OFFLOAD_GB="0.001",
               DYN_WARM_RESTART_DIR=str(warm))
    texts = []
    for _ in range(2):
        proc = subprocess.run(
            [sys.executable, "-m", "dynamo_tpu_torch.run", f"in=batch:{batch}", "out=torch",
             "--model-path", model_dir, "--device", "cpu", "--context-length", "64",
             "--num-blocks", "64", "--max-batch", "4", "--kv-block-size", "4"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stderr[-2000:]
        texts.append(json.loads((tmp_path / "batch.jsonl.out.jsonl").read_text())["text"])
        manifest = json.loads((warm / "manifest.json").read_text())
        assert manifest["version"] == 2 and len(manifest["blocks"]) >= 4
        assert len(os.listdir(warm / "pages")) == len(manifest["blocks"])
    assert "warm restart: {'restored':" in proc.stderr
    assert texts[0] == texts[1]
