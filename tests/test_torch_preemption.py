"""The port's preemption-storm guard against the JAX engine's, on the CPU.

Under the same block pressure (13 usable blocks of 4 tokens, four lanes
growing to 26-36 tokens), ``TorchEngine`` and ``JaxEngine`` with the same
``max_preemptions`` and no backoff preempt the same sequences: a sequence
preempted more often than the limit fails with the structured
``preempted_too_often`` error, the others stream the same greedy tokens,
and the ``preempted_too_often`` counts are equal. Then the backoff: a
preempted sequence waits ``preempt_backoff_ms`` doubled per preemption
before it may be admitted again.

Class-aware preemption, the contract of tests/test_priority.py:197 and :317:
with 9 usable blocks for a bulk and an interactive sequence that want 6
each, every preemption lands on bulk (an interactive grower takes bulk's
blocks; a bulk grower facing only interactive lanes yields itself), the
interactive stream is untouched and equal to JaxEngine's greedy tokens, the
greedy bulk stream equals JaxEngine's and the seeded one the port's own
unpressured run; the victims and self-yields equal JaxEngine's, and
``preemptions_by_class`` reaches ``load_metrics``.
"""

import asyncio
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dynamo_tpu.engine.jax_engine.engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.engine.jax_engine.model_runner import ModelRunner
from dynamo_tpu.models import llama as jl
from dynamo_tpu.pipeline.context import Context as JaxContext
from dynamo_tpu.protocols import common as jp
from dynamo_tpu_torch.engine.torch_engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.engine.torch_engine.model_runner import TorchModelRunner
from dynamo_tpu_torch.engine.torch_engine.weights import params_from_jax
from dynamo_tpu_torch.entrypoint.inputs import load_metrics
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.protocols import common as tp

BS, NB, MAX_BATCH, MAX_LEN, VOCAB = 4, 14, 4, 64, 128
PROMPTS = [[5, 9, 17, 23, 2, 40], [1, 2, 3], [77, 3, 91, 14, 8, 8], [42] * 6]


def _engines(max_preemptions, backoff_ms=0.0):
    cfg = jl.LlamaConfig.tiny(vocab_size=VOCAB)
    jparams = jl.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    dims = dict(num_blocks=NB, block_size=BS, max_batch=MAX_BATCH, max_model_len=MAX_LEN)
    guard = dict(watermark_blocks=0, max_preemptions=max_preemptions,
                 preempt_backoff_ms=backoff_ms)
    jeng = JaxEngine(
        ModelRunner(cfg, jparams, kv_dtype=jnp.float32, prefill_chunk_tokens=0, **dims),
        JaxEngineConfig(**dims, **guard))
    trunner = TorchModelRunner(
        tl.LlamaConfig.tiny(vocab_size=VOCAB),
        params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"), device="cpu",
        prefill_chunk_tokens=0, **dims)
    return jeng, TorchEngine(trunner, TorchEngineConfig(**dims, **guard))


async def _stream(engine, mod, prompt, ctx, max_tokens):
    toks, final = [], None
    async for out in engine.generate(mod.PreprocessedRequest(
            token_ids=list(prompt), sampling=mod.SamplingOptions(greedy=True),
            stop=mod.StopConditions(max_tokens=max_tokens)), ctx):
        toks.extend(out.token_ids)
        if out.finish_reason is not None:
            final = (out.finish_reason.value, (out.error or {}).get("code"))
    return toks, final


async def _serve(engine, mod, ctx, max_tokens=20):
    try:
        return await asyncio.gather(*(_stream(engine, mod, p, ctx(), max_tokens) for p in PROMPTS))
    finally:
        await engine.close()


# (limit, max_tokens): at 30 tokens one sequence is preempted twice
@pytest.mark.parametrize("max_preemptions,max_tokens", [(0, 20), (1, 30)])
async def test_storm_guard_fails_and_keeps_what_the_jax_engine_does(max_preemptions, max_tokens):
    jeng, teng = _engines(max_preemptions)
    want = await _serve(jeng, jp, JaxContext, max_tokens)
    got = await _serve(teng, tp, tp.Context, max_tokens)
    assert got == want
    codes = [final[1] for _, final in got]
    assert "preempted_too_often" in codes
    assert teng.stats.preempted_too_often == codes.count("preempted_too_often")
    assert teng.stats.preempted_too_often == jeng.stats.preempted_too_often
    assert teng.allocator.free_count == NB - 1


async def test_a_preempted_sequence_waits_out_its_backoff():
    """Backoff 400 ms: a preempted sequence is not re-admitted before it,
    though blocks free up at once."""
    _, teng = _engines(8, backoff_ms=400.0)
    admitted = {}
    orig = teng._try_admit

    def spy(seq):
        ok = orig(seq)
        if ok and seq.preemptions:
            admitted.setdefault(seq.seq_id, time.monotonic() - seq.requeue_after)
        return ok

    teng._try_admit = spy
    got = await _serve(teng, tp, tp.Context)
    assert teng.stats.preemptions > 0 and admitted
    assert all(lag >= 0 for lag in admitted.values())
    assert all(final == ("length", None) and len(toks) == 20 for toks, final in got)


# ------------------------------------------------ class-aware preemption


def _class_engines(num_blocks):
    """(JaxEngine, TorchEngine) with the reference test's shapes: block 4,
    4 lanes, watermark 2, backoff 1 ms."""
    cfg = jl.LlamaConfig.tiny(vocab_size=64)
    jparams = jl.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    dims = dict(num_blocks=num_blocks, block_size=4, max_batch=4, max_model_len=64)
    kw = dict(dims, watermark_blocks=2, preempt_backoff_ms=1.0)
    jeng = JaxEngine(ModelRunner(cfg, jparams, kv_dtype=jnp.float32, prefill_chunk_tokens=0, **dims),
                     JaxEngineConfig(**kw))
    trunner = TorchModelRunner(
        tl.LlamaConfig.tiny(vocab_size=64),
        params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"), device="cpu",
        prefill_chunk_tokens=0, **dims)
    return jeng, TorchEngine(trunner, TorchEngineConfig(**kw))


def _spy_preemptions(engine, seq_preempt: str):
    """Record each preemption as (victim class, chosen by the victim search
    or a self-yield)."""
    log, inside = [], []
    victim_fn, preempt_fn = engine._preempt_victim, getattr(engine, seq_preempt)

    def victim(exclude):
        inside.append(True)
        try:
            return victim_fn(exclude)
        finally:
            inside.pop()

    def preempt(seq):
        log.append((seq.priority, "victim" if inside else "self_yield"))
        return preempt_fn(seq)

    engine._preempt_victim = victim
    setattr(engine, seq_preempt, preempt)
    return log


def _class_req(mod, prompt, priority, sampling):
    return mod.PreprocessedRequest(
        token_ids=list(prompt), sampling=mod.SamplingOptions(**sampling),
        stop=mod.StopConditions(max_tokens=20, ignore_eos=True), extra={"priority": priority})


async def _class_stream(engine, mod, ctx, prompt, priority, sampling):
    toks = []
    async for out in engine.generate(_class_req(mod, prompt, priority, sampling), ctx()):
        toks.extend(out.token_ids)
    return toks


PB, PI = [5, 9, 17, 23], [40, 41, 42, 43]
GREEDY = dict(greedy=True)
SEEDED = dict(temperature=0.9, top_k=8, seed=424242)


@pytest.mark.parametrize("sampling", [GREEDY, SEEDED], ids=["greedy", "seeded"])
async def test_class_aware_preemption_lands_on_bulk(sampling):
    runs = {}
    for pressured in (False, True):
        jeng, teng = _class_engines(10 if pressured else 64)
        logs = {"jax": _spy_preemptions(jeng, "_preempt_seq"),
                "torch": _spy_preemptions(teng, "_preempt")}
        for name, eng, mod, ctx in (("jax", jeng, jp, JaxContext), ("torch", teng, tp, tp.Context)):
            if pressured:
                got = await asyncio.wait_for(asyncio.gather(
                    _class_stream(eng, mod, ctx, PB, "bulk", sampling),
                    _class_stream(eng, mod, ctx, PI, "interactive", sampling)), timeout=60)
            else:
                got = [await _class_stream(eng, mod, ctx, PB, "bulk", sampling),
                       await _class_stream(eng, mod, ctx, PI, "interactive", sampling)]
            runs[(name, pressured)] = (got, logs[name], eng)
            await eng.close()
    (t_bulk, t_inter), t_log, teng = runs[("torch", True)]
    (j_bulk, j_inter), j_log, jeng = runs[("jax", True)]
    (u_bulk, u_inter), _, _ = runs[("torch", False)]
    by_class = teng.stats.preemptions_by_class
    assert by_class.get("bulk", 0) >= 1 and "interactive" not in by_class, by_class
    assert by_class == jeng.stats.preemptions_by_class
    assert t_log == j_log and all(c == "bulk" for c, _ in t_log)
    # interactive never preempted: untouched
    assert t_inter == u_inter and len(t_inter) == 20
    # bulk was preempted and resumed to the same tokens
    assert t_bulk == u_bulk and len(t_bulk) == 20
    if sampling is GREEDY:
        assert t_inter == j_inter == runs[("jax", False)][0][1]
        assert t_bulk == j_bulk == runs[("jax", False)][0][0]
    ws = load_metrics(teng).worker_stats
    assert ws.preemptions_by_class == by_class
    assert teng.allocator.free_count == teng.config.num_blocks - 1


async def test_a_bulk_grower_yields_itself_to_interactive_lanes():
    """A bulk lane and two interactive lanes on 11 usable blocks: the bulk
    grower finds only lanes that outrank it and yields itself (its tokens
    kept, re-queued), then an interactive grower takes the younger
    interactive lane, the same preemptions as JaxEngine's in the same
    order; every stream ends whole with JaxEngine's greedy tokens."""
    logs, outs, stats = {}, {}, {}
    reqs = [(PB, "bulk"), ([40, 41, 42, 43], "interactive"), ([50, 51, 52, 53], "interactive")]
    for name in ("jax", "torch"):
        jeng, teng = _class_engines(12)
        eng, mod, ctx = (jeng, jp, JaxContext) if name == "jax" else (teng, tp, tp.Context)
        logs[name] = _spy_preemptions(eng, "_preempt_seq" if name == "jax" else "_preempt")
        outs[name] = await asyncio.wait_for(asyncio.gather(
            *(_class_stream(eng, mod, ctx, p, c, GREEDY) for p, c in reqs)), timeout=60)
        stats[name] = dict(eng.stats.preemptions_by_class)
        await jeng.close()
        await teng.close()
    assert outs["torch"] == outs["jax"]
    assert all(len(t) == 20 for t in outs["torch"])
    assert logs["torch"] == logs["jax"] == [("bulk", "self_yield"), ("interactive", "victim")]
    assert stats["torch"] == stats["jax"] == {"bulk": 1, "interactive": 1}
