"""The port's preemption-storm guard against the JAX engine's, on the CPU.

Under the same block pressure (13 usable blocks of 4 tokens, four lanes
growing to 26-36 tokens), ``TorchEngine`` and ``JaxEngine`` with the same
``max_preemptions`` and no backoff preempt the same sequences: a sequence
preempted more often than the limit fails with the structured
``preempted_too_often`` error, the others stream the same greedy tokens,
and the ``preempted_too_often`` counts are equal. Then the backoff: a
preempted sequence waits ``preempt_backoff_ms`` doubled per preemption
before it may be admitted again.
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
