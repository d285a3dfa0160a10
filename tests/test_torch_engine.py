"""The port's worker engine against the JAX engine, on the CPU.

Slice parity: ``TorchEngine(device="cpu")`` and ``JaxEngine``, both over a
runner with ``prefill_chunk_tokens=0`` (every prompt through
``ModelRunner.prefill``, the path whose attention is the flash prefill
kernel), both f32 with the same parameters (the JAX init carried over by
``params_from_jax``), serve the same concurrent greedy requests -- more than
``max_batch`` -- and must stream token-identical outputs. The same holds
with frequency / presence / repetition penalties, with ``min_tokens`` past
an EOS the model would emit early (also with more stop ids than the device
mask holds), and in batches that mix plain and penalty lanes. Then the
engine's own contract: EOS, cancellation, prompt_too_long, preemption,
seeded sampling, logprobs.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dynamo_tpu.engine.jax_engine.engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.engine.jax_engine.model_runner import ModelRunner
from dynamo_tpu.models import llama as jl
from dynamo_tpu.pipeline.context import Context as JaxContext
from dynamo_tpu.protocols import common as jp
from dynamo_tpu_torch.engine.torch_engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
from dynamo_tpu_torch.engine.torch_engine.model_runner import TorchModelRunner
from dynamo_tpu_torch.engine.torch_engine.weights import params_from_jax
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.protocols import common as tp

BS, NB, MAX_BATCH, MAX_LEN = 4, 64, 4, 64


def _jax_params():
    cfg = jl.LlamaConfig.tiny(vocab_size=128)
    return cfg, jl.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)


def make_torch_engine(num_blocks=NB, watermark=2, params=None):
    cfg = tl.LlamaConfig.tiny(vocab_size=128)
    if params is None:
        params = params_from_jax(jax.tree.map(np.asarray, _jax_params()[1]), device="cpu")
    runner = TorchModelRunner(
        cfg, params, num_blocks=num_blocks, block_size=BS, max_batch=MAX_BATCH,
        max_model_len=MAX_LEN, device="cpu", prefill_chunk_tokens=0,
    )
    return TorchEngine(runner, TorchEngineConfig(
        max_batch=MAX_BATCH, block_size=BS, num_blocks=num_blocks,
        max_model_len=MAX_LEN, watermark_blocks=watermark,
    ))


def make_jax_engine():
    cfg, params = _jax_params()
    runner = ModelRunner(
        cfg, params, num_blocks=NB, block_size=BS, max_batch=MAX_BATCH,
        max_model_len=MAX_LEN, kv_dtype=jnp.float32, prefill_chunk_tokens=0,
    )
    return JaxEngine(runner, JaxEngineConfig(
        max_batch=MAX_BATCH, block_size=BS, num_blocks=NB, max_model_len=MAX_LEN,
        watermark_blocks=2,
    ))


def request(mod, prompt, max_tokens, **sampling):
    sampling = sampling or {"greedy": True}
    return mod.PreprocessedRequest(
        token_ids=list(prompt),
        sampling=mod.SamplingOptions(**sampling),
        stop=mod.StopConditions(max_tokens=max_tokens),
    )


async def collect(engine, req, ctx):
    toks, reason, frames = [], None, []
    async for out in engine.generate(req, ctx):
        frames.append(out)
        toks.extend(out.token_ids)
        if out.finish_reason is not None:
            reason = out.finish_reason
    return toks, reason, frames


PROMPTS = [
    [5, 9, 17, 23, 2, 40],
    [1, 2, 3],
    [77, 3, 91, 14, 8, 8, 8, 60, 12, 33, 101],
    [42] * 9,
    [7, 100, 27],
    [64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 77],
]
MAX_NEW = [8, 12, 6, 10, 9, 7]


async def test_slice_parity_token_identical_with_jax_engine():
    jeng, teng = make_jax_engine(), make_torch_engine()
    try:
        jres = await asyncio.gather(*(
            collect(jeng, request(jp, p, n), JaxContext()) for p, n in zip(PROMPTS, MAX_NEW)
        ))
        tres = await asyncio.gather(*(
            collect(teng, request(tp, p, n), tp.Context()) for p, n in zip(PROMPTS, MAX_NEW)
        ))
    finally:
        await jeng.close()
        await teng.close()
    for (jt, jr, _), (tt, tr, _), n in zip(jres, tres, MAX_NEW):
        assert tt == jt
        assert len(tt) == n
        assert jr.value == tr.value == "length"
    assert teng.stats.prefills == len(PROMPTS)
    assert teng.allocator.free_count == NB - 1


async def test_eos_stops_and_stays_hidden():
    eng = make_torch_engine()
    try:
        toks, _, _ = await collect(eng, request(tp, PROMPTS[0], 5), tp.Context())
        req = request(tp, PROMPTS[0], 5)
        req.eos_token_ids = [toks[2]]
        got, reason, _ = await collect(eng, req, tp.Context())
        assert reason is tp.FinishReason.EOS
        assert got == toks[: toks.index(toks[2])]
        req.stop.ignore_eos = True
        got, reason, _ = await collect(eng, req, tp.Context())
        assert (got, reason) == (toks, tp.FinishReason.LENGTH)
        hidden = request(tp, PROMPTS[0], 5)
        hidden.stop.stop_token_ids_hidden = [toks[1]]
        got, reason, _ = await collect(eng, hidden, tp.Context())
        assert reason is tp.FinishReason.EOS and got == toks[:1]
    finally:
        await eng.close()


async def test_cancellation_frees_blocks():
    eng = make_torch_engine()
    try:
        ctx = tp.Context()
        seen = []

        async def consume():
            async for out in eng.generate(request(tp, PROMPTS[2], 40), ctx):
                seen.append(out)
                if len(seen) == 3:
                    ctx.kill()

        await asyncio.wait_for(consume(), timeout=60)
        assert seen[-1].finish_reason is tp.FinishReason.CANCELLED
        assert len(seen) < 40
        # the engine stays healthy and every block came back
        toks, reason, _ = await collect(eng, request(tp, PROMPTS[1], 3), tp.Context())
        assert reason is tp.FinishReason.LENGTH and len(toks) == 3
        assert eng.allocator.free_count == NB - 1
        assert all(s is None for s in eng.slots)
    finally:
        await eng.close()


async def test_prompt_too_long_is_refused():
    eng = make_torch_engine()
    try:
        _, reason, frames = await collect(eng, request(tp, [1] * (MAX_LEN + 1), 4), tp.Context())
        assert reason is tp.FinishReason.ERROR
        assert frames[-1].error["code"] == "prompt_too_long"
    finally:
        await eng.close()


async def test_preemption_completes_with_the_same_tokens():
    params = params_from_jax(jax.tree.map(np.asarray, _jax_params()[1]), device="cpu")
    roomy = make_torch_engine(params=params)
    # 13 usable blocks of 4 tokens: four lanes growing to ~30 tokens each
    # cannot all fit, so the youngest are preempted and re-prefilled
    tight = make_torch_engine(num_blocks=14, watermark=0, params=params)
    prompts = [p[:6] for p in PROMPTS[:4]]
    try:
        want = await asyncio.gather(*(
            collect(roomy, request(tp, p, 20), tp.Context()) for p in prompts
        ))
        got = await asyncio.gather(*(
            collect(tight, request(tp, p, 20), tp.Context()) for p in prompts
        ))
    finally:
        await roomy.close()
        await tight.close()
    assert tight.stats.preemptions > 0
    assert tight.stats.prefills > len(prompts)
    for (wt, _, _), (gt, gr, _) in zip(want, got):
        assert gr is tp.FinishReason.LENGTH and gt == wt
    assert tight.allocator.free_count == 13


async def test_seeded_sampling_repeats_and_logprobs_stream():
    eng = make_torch_engine()
    try:
        def req():
            r = request(tp, PROMPTS[0], 8, temperature=0.9, top_k=20, seed=77,
                        logprobs=True, top_logprobs=3)
            return r

        a, _, frames = await collect(eng, req(), tp.Context())
        # a busy batch around it must not change a seeded request's tokens
        others = [collect(eng, request(tp, p, 6, temperature=1.0), tp.Context())
                  for p in PROMPTS[1:4]]
        b, *_ = await asyncio.gather(collect(eng, req(), tp.Context()), *others)
        assert a == b[0]
        tok_frames = [f for f in frames if f.token_ids]
        assert all(len(f.log_probs) == 1 and len(f.top_logprobs[0]) == 3 for f in tok_frames)
        assert all(f.log_probs[0] <= 0.0 for f in tok_frames)
    finally:
        await eng.close()


async def test_build_torch_engine_on_cpu_serves():
    eng = build_torch_engine(
        tl.LlamaConfig.tiny(vocab_size=64), device="cpu", kv_block_size=4,
        max_batch=2, max_model_len=32, dtype=torch.float32,
    )
    try:
        assert eng.config.num_blocks == 2 * 8 + 64
        toks, reason, _ = await collect(eng, request(tp, [3, 4, 5], 4), tp.Context())
        assert reason is tp.FinishReason.LENGTH and len(toks) == 4
        assert all(0 <= t < 64 for t in toks)
    finally:
        await eng.close()


# ------------------------------------------------- penalties and min_tokens


def pen_request(mod, prompt, max_tokens, eos=(), min_tokens=None, **sampling):
    return mod.PreprocessedRequest(
        token_ids=list(prompt),
        sampling=mod.SamplingOptions(greedy=True, **sampling),
        stop=mod.StopConditions(max_tokens=max_tokens, min_tokens=min_tokens),
        eos_token_ids=list(eos),
    )


async def serve_both(make_reqs):
    """The same requests through JaxEngine and TorchEngine, concurrently."""
    jeng, teng = make_jax_engine(), make_torch_engine()
    try:
        jres = await asyncio.gather(*(
            collect(jeng, r, JaxContext()) for r in make_reqs(jp)))
        tres = await asyncio.gather(*(
            collect(teng, r, tp.Context()) for r in make_reqs(tp)))
    finally:
        await jeng.close()
        await teng.close()
    assert teng.allocator.free_count == NB - 1
    return [(t, r.value) for t, r, _ in jres], [(t, r.value) for t, r, _ in tres]


PENALTIES = [
    {"frequency_penalty": 0.9},
    {"presence_penalty": 1.5},
    {"repetition_penalty": 1.8},
    {"frequency_penalty": 0.4, "presence_penalty": 0.6, "repetition_penalty": 1.3},
    {"repetition_penalty": 0.7},
    {"frequency_penalty": -0.5, "presence_penalty": 0.2},
]


async def test_penalties_token_identical_with_jax_engine():
    def reqs(mod):
        return [pen_request(mod, p, 14, **pen) for p, pen in zip(PROMPTS, PENALTIES)]

    want, got = await serve_both(reqs)
    assert got == want
    # the penalties change what greedy decoding says
    plain, _ = await serve_both(lambda mod: [pen_request(mod, p, 14) for p in PROMPTS])
    assert sum(a != b for a, b in zip(plain, got)) >= 3


async def test_min_tokens_past_an_early_eos_token_identical_with_jax_engine():
    plain, _ = await serve_both(lambda mod: [pen_request(mod, p, 12) for p in PROMPTS[:4]])
    # each request's first greedy token that is new to its stream, as its
    # EOS: without min_tokens the stream stops there, early
    first_new = [next(j for j in range(1, len(t)) if t[j] not in t[:j]) for t, _ in plain]
    eos = [[t[j]] for (t, _), j in zip(plain, first_new)]
    # lane 3: five stop ids, one more than the device mask's MAX_EOS_IDS,
    # and the one the model emits sorts last, past the mask: it is dropped
    # and redrawn (the same greedy token) until the engine gives up
    t3 = eos[3][0]
    eos[3] = [i for i in range(t3) if i not in plain[3][0]][:4] + [t3]
    assert len(eos[3]) == 5

    def reqs(mod, mins=(6, 9, 0, 5)):
        return [pen_request(mod, p, 12, eos=e, min_tokens=m or None)
                for p, e, m in zip(PROMPTS[:4], eos, mins)]

    stopped, _ = await serve_both(lambda mod: reqs(mod, (0, 0, 0, 0)))
    assert [(len(t), r) for t, r in stopped] == [(j, "eos") for j in first_new]
    want, got = await serve_both(reqs)
    assert got == want
    for (toks, reason), m in zip(got[:2], (6, 9)):
        assert len(toks) >= m and reason in ("eos", "length")
    assert got[2] == stopped[2]  # no min_tokens: stops at its EOS
    assert got[3] == stopped[3]  # the unmasked stop id: dropped, then given up


async def test_mixed_plain_and_penalty_lanes_token_identical_with_jax_engine():
    """More requests than lanes: plain, penalty and min_tokens lanes share
    steps and take over each other's slots."""
    def reqs(mod):
        out = []
        for i, (p, n) in enumerate(zip(PROMPTS, MAX_NEW)):
            if i % 2:
                out.append(pen_request(mod, p, n, **PENALTIES[i]))
            elif i == 2:
                out.append(pen_request(mod, p, n, eos=[p[0]], min_tokens=4))
            else:
                out.append(pen_request(mod, p, n))
        return out

    want, got = await serve_both(reqs)
    assert got == want
