"""The port's decode horizon against the JAX package's, on the CPU.

The reference's horizon cases (tests/test_decode_horizon.py), each run as
``TorchEngine`` against ``JaxEngine`` on the same tiny f32 parameters (the
JAX init carried over by ``params_from_jax``), both on the default
admission path with ``decode_horizon`` 4 (8 near max_model_len): greedy
streams must be token-identical, with the same finish reasons, through
max_tokens not divisible by H, min_tokens, an EOS mid-horizon, block
crossings, a lane near max_model_len beside a fresh one, penalty lanes in
the horizon, and the lazy ramp. Seeded sampling is held to the port's own
single steps (its counter-based keys are not threefry). Spec decode with
the chained horizon (E = 3) streams what the JAX engine streams.

At the runner: ``decode_multi`` (H = 4) and ``spec_verify`` (S = 4, E =
3) against the JAX runner's on the same cache contents, greedy: tokens,
frozen -1 steps and top ids equal, logprobs within rtol / atol 1e-4 (the
tolerance of tests/test_torch_spec_decode.py).

Failures: under ``lazy_horizon`` a failed horizon dispatch degrades (its
lanes fail with ERROR, H drops to 1); otherwise it ends the engine loop;
graphs off the card are refused.
"""

import asyncio
import functools
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

VOCAB = 64
TOL = dict(rtol=1e-4, atol=1e-4)


@functools.cache
def _params():
    jparams = jl.init_params(jl.LlamaConfig.tiny(vocab_size=VOCAB), jax.random.PRNGKey(0),
                             jnp.float32)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _dims(num_blocks=64, max_batch=4, block_size=4, max_len=64):
    return dict(num_blocks=num_blocks, block_size=block_size, max_batch=max_batch,
                max_model_len=max_len)


def torch_engine(H, lazy_horizon=False, spec_k=0, fused=False, **kw):
    d = _dims(**kw)
    runner = TorchModelRunner(tl.LlamaConfig.tiny(vocab_size=VOCAB), _params()[1], device="cpu",
                              fused_decode=fused, **d)
    return TorchEngine(runner, TorchEngineConfig(
        watermark_blocks=2, decode_horizon=H, lazy_horizon=lazy_horizon, spec_k=spec_k, **d))


def jax_engine(H, spec_k=0, fused=False, **kw):
    d = _dims(**kw)
    runner = ModelRunner(jl.LlamaConfig.tiny(vocab_size=VOCAB), _params()[0],
                         kv_dtype=jnp.float32, fused_decode=fused, **d)
    return JaxEngine(runner, JaxEngineConfig(
        watermark_blocks=2, decode_horizon=H, spec_k=spec_k, **d))


def greedy(mod, prompt, max_tokens, eos=(), **stop):
    return mod.PreprocessedRequest(
        token_ids=list(prompt), sampling=mod.SamplingOptions(greedy=True),
        stop=mod.StopConditions(max_tokens=max_tokens, **stop), eos_token_ids=list(eos))


def penalised(mod, prompt, max_tokens, **pen):
    return mod.PreprocessedRequest(
        token_ids=list(prompt), sampling=mod.SamplingOptions(greedy=True, **pen),
        stop=mod.StopConditions(max_tokens=max_tokens, ignore_eos=True))


async def collect(engine, req, ctx):
    toks, reason = [], None
    async for out in engine.generate(req, ctx):
        toks.extend(out.token_ids)
        if out.finish_reason is not None:
            reason = out.finish_reason.value
    return toks, reason


async def serve(engine, mod, make_reqs, *, concurrent=True):
    """``make_reqs(mod)``'s requests through ``engine`` (together or one
    after another); the engine is closed after."""
    ctx = JaxContext if mod is jp else tp.Context
    try:
        if concurrent:
            return list(await asyncio.gather(*(collect(engine, r, ctx()) for r in make_reqs(mod))))
        return [await collect(engine, r, ctx()) for r in make_reqs(mod)]
    finally:
        await engine.close()


async def both(make_reqs, H=4, concurrent=True, **kw):
    """The same requests through a JaxEngine and a TorchEngine at horizon H;
    asserts the streams are equal and returns the port's engine too."""
    want = await serve(jax_engine(H, **kw), jp, make_reqs, concurrent=concurrent)
    engine = torch_engine(H, **kw)
    got = await serve(engine, tp, make_reqs, concurrent=concurrent)
    assert got == want
    return got, engine


def spy_multi(engine):
    calls = []
    orig = engine.runner.decode_multi

    def spy(H, *a, **kw):
        calls.append(H)
        return orig(H, *a, **kw)

    engine.runner.decode_multi = spy
    return calls


# ------------------------------------------------------ the reference's cases


async def test_horizon_matches_single_step_greedy():
    prompts = [[5, 9, 17, 23], [2, 40, 41], [60, 3, 3, 3, 8, 1]]

    def reqs(mod):
        return [greedy(mod, p, 11) for p in prompts]

    got, engine = await both(reqs, concurrent=False)
    assert engine.stats.horizon_dispatches > 0 and engine.stats.decode_steps == 0
    assert await serve(torch_engine(1), tp, reqs, concurrent=False) == got
    for toks, reason in got:
        assert len(toks) == 11 and reason == "length"


async def test_horizon_matches_single_step_seeded_sampling():
    def reqs(mod):
        return [mod.PreprocessedRequest(
            token_ids=[7, 12, 30],
            sampling=mod.SamplingOptions(temperature=0.9, top_p=0.95, seed=1234),
            stop=mod.StopConditions(max_tokens=10, ignore_eos=True))]

    multi = torch_engine(3)
    calls = spy_multi(multi)
    got = await serve(multi, tp, reqs)
    assert got == await serve(torch_engine(1), tp, reqs)
    assert calls and max(calls) == 3 and len(got[0][0]) == 10


async def test_horizon_respects_max_tokens_not_divisible_by_h():
    (got,), _ = await both(lambda mod: [greedy(mod, [5, 6, 7], 7)])
    assert len(got[0]) == 7 and got[1] == "length"


async def test_horizon_min_tokens_suppresses_eos():
    # EOS pinned to what greedy emits first, so the mask must hold it off
    (probe,) = await serve(torch_engine(1), tp, lambda mod: [greedy(mod, [4, 4, 4], 1)])
    eos = probe[0][0]
    (got,), _ = await both(
        lambda mod: [greedy(mod, [4, 4, 4], 12, eos=[eos], min_tokens=6)])
    assert len(got[0]) >= 6


async def test_horizon_eos_finish_mid_horizon():
    # the third greedy token declared EOS: the stream ends before it
    (probe,) = await serve(torch_engine(1), tp, lambda mod: [greedy(mod, [9, 9, 21], 8)])
    toks1 = probe[0]
    eos = toks1[2]
    (got,), _ = await both(lambda mod: [greedy(mod, [9, 9, 21], 8, eos=[eos])])
    assert got == (toks1[:toks1.index(eos)], "eos")


async def test_horizon_crosses_block_boundaries():
    (got,), engine = await both(lambda mod: [greedy(mod, [11, 13], 13)])
    assert len(got[0]) == 13 and engine.allocator.free_count == 63


async def test_horizon_lane_near_model_len_with_fresh_lane():
    # preallocation caps at each lane's own budget, not the global H
    got, _ = await both(lambda mod: [greedy(mod, [1] * 13, 8), greedy(mod, [2, 3], 8)],
                        H=8, max_len=16)
    assert len(got[0][0]) == 3 and got[0][1] == "length"
    assert len(got[1][0]) == 8


async def test_horizon_mixed_batch_and_penalty_fallback():
    def reqs(mod):
        return [greedy(mod, [5, 9, 17], 9),
                mod.PreprocessedRequest(
                    token_ids=[8, 2, 44],
                    sampling=mod.SamplingOptions(greedy=True, repetition_penalty=1.3),
                    stop=mod.StopConditions(max_tokens=9))]

    got, _ = await both(reqs)
    assert got == await serve(torch_engine(1), tp, reqs)


async def test_lazy_horizon_single_steps_then_ramps():
    """lazy_horizon: single steps until the runner has prepared H on the
    engine's device thread (without graphs there is nothing to capture),
    then the horizon; the JAX engine's tokens either way."""
    def reqs(mod):
        return [greedy(mod, [5, 9, 17, 23], 24, ignore_eos=True)]

    (ref,) = await serve(jax_engine(4), jp, reqs)
    lazy = torch_engine(4, lazy_horizon=True)
    calls = spy_multi(lazy)
    try:
        first = await collect(lazy, reqs(tp)[0], tp.Context())
        assert first == ref and lazy.stats.decode_steps > 0
        deadline = time.monotonic() + 60
        while not lazy.runner.decode_multi_ready(4):
            assert time.monotonic() < deadline, "the horizon was never prepared"
            await asyncio.sleep(0.05)
        second = await collect(lazy, reqs(tp)[0], tp.Context())
    finally:
        await lazy.close()
    assert second == ref and calls and max(calls) == 4
    assert lazy.stats.horizon_degrades == 0


async def test_horizon_penalties_match_single_step_and_keep_h():
    def reqs(mod):
        return [penalised(mod, [5, 9, 17, 23], 10, frequency_penalty=0.7, presence_penalty=0.3,
                          repetition_penalty=1.3),
                greedy(mod, [2, 40, 41], 10, ignore_eos=True)]

    want = await serve(jax_engine(4), jp, reqs)
    single = torch_engine(1)
    single_calls = spy_multi(single)
    assert await serve(single, tp, reqs) == want
    multi = torch_engine(4)
    multi_calls = spy_multi(multi)
    assert await serve(multi, tp, reqs) == want
    assert not single_calls and multi_calls and max(multi_calls) > 1


async def test_horizon_penalty_only_batch_diverges_from_unpenalized():
    def reqs(mod):
        return [penalised(mod, [3, 3, 3, 3], 12, frequency_penalty=1.5),
                greedy(mod, [3, 3, 3, 3], 12, ignore_eos=True)]

    (pen, _), (plain, _) = (await both(reqs, concurrent=False))[0]
    assert len(pen) == len(plain) == 12 and pen != plain


# -------------------------------------------------- spec with the horizon


async def test_spec_with_the_chained_horizon_matches_the_jax_engine():
    """spec_k 3 with H 4: each verify dispatch chains E = 3 decode steps
    from the device's accept point; repeating prompts make drafts land."""
    seg = [11, 12, 13, 14, 15, 16]

    def reqs(mod):
        return [greedy(mod, seg * 3, 14), greedy(mod, [7, 8, 9] * 4, 12),
                greedy(mod, [20, 21, 22, 23, 20, 21, 22], 10)]

    got, engine = await both(reqs, spec_k=3, fused=True)
    s = engine.stats
    assert s.verify_steps > 0 and s.verify_chained_steps == 3 * s.verify_steps
    assert s.num_accepted_tokens > 0
    assert await serve(torch_engine(1, spec_k=3, fused=True), tp, reqs) == got


# ------------------------------------------------------------------ runners

BS, NB, MB, B = 4, 64, 16, 4
LENS = [9, 5, 14, 3]
EOS = 7


def _runners():
    jparams, tparams = _params()
    d = _dims()
    jr = ModelRunner(jl.LlamaConfig.tiny(vocab_size=VOCAB), jparams, kv_dtype=jnp.float32,
                     prefill_chunk_tokens=0, **d)
    tr = TorchModelRunner(tl.LlamaConfig.tiny(vocab_size=VOCAB), tparams, device="cpu",
                          prefill_chunk_tokens=0, **d)
    rng = np.random.default_rng(3)
    tables = np.zeros((B, MB), np.int32)
    nxt = 1
    for b, n in enumerate(LENS):  # blocks for the prompt and 8 more tokens
        used = (n + 8 + BS - 1) // BS
        tables[b, :used] = np.arange(nxt, nxt + used)
        nxt += used
        prompt = [int(t) for t in rng.integers(1, VOCAB, n)]
        jr.prefill(prompt, list(tables[b, :used]), 0.0, 1.0, 0)
        tr.prefill(prompt, list(tables[b, :used]), 0.0, 1.0, 0)
    last = rng.integers(1, VOCAB, B)
    return jr, tr, tables, last


def _lanes():
    active = np.array([True, True, False, True])
    limit = np.array([4, 2, 1, 3], np.int64)
    min_rem = np.array([0, 0, 0, 2], np.int64)
    eos = np.full((B, 4), -1, np.int64)
    eos[:, 0] = EOS
    return active, limit, min_rem, eos


def _common_inputs(last, tables):
    positions = np.array(LENS, np.int64)
    keys = np.stack([np.arange(B) + 100, np.zeros(B)], 1).astype(np.int64)
    return dict(tokens=last.astype(np.int64), positions=positions, tables=tables,
                temps=np.zeros(B, np.float32), top_ps=np.ones(B, np.float32),
                top_ks=np.zeros(B, np.int64), keys=keys)


def _assert_packed_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    k = (got.shape[-1] - 2) // 2
    np.testing.assert_array_equal(got[..., 0], want[..., 0])  # tokens and -1
    live = got[..., 0] >= 0
    np.testing.assert_array_equal(got[..., 2:2 + k][live], want[..., 2:2 + k][live])
    np.testing.assert_allclose(got[..., 1][live], want[..., 1][live], **TOL)
    np.testing.assert_allclose(got[..., 2 + k:][live], want[..., 2 + k:][live], **TOL)


def test_decode_multi_packed_output_matches_the_jax_runner():
    jr, tr, tables, last = _runners()
    x = _common_inputs(last, tables)
    active, limit, min_rem, eos = _lanes()
    args = (x["tokens"], x["positions"], x["tables"], x["temps"], x["top_ps"], x["top_ks"],
            x["keys"], active, limit, min_rem, eos)
    want = np.asarray(jr.decode_multi(
        4, *(a.astype(np.uint32) if a is x["keys"] else a.astype(np.int32)
             if a.dtype == np.int64 else a for a in args)))
    got = tr.decode_multi(4, *args).numpy()
    _assert_packed_equal(got, want)
    assert got.shape == (4, B, 42)
    assert (got[:, 2, 0] == -1).all() and (got[2:, 1, 0] == -1).all()  # inactive, budget


def test_spec_verify_with_extras_matches_the_jax_runner():
    jr, tr, tables, last = _runners()
    x = _common_inputs(last, tables)
    active, limit, min_rem, eos = _lanes()
    limit = np.array([7, 3, 1, 6], np.int64)
    K = 3
    rng = np.random.default_rng(8)
    drafts = rng.integers(1, VOCAB, (B, K)).astype(np.int64)
    draft_len = np.array([3, 1, 0, 2], np.int64)
    # the model's own greedy first token as lane 0's first draft, so a
    # draft is accepted and the chain starts past it
    probe = tr.decode_multi(1, x["tokens"], x["positions"], x["tables"], x["temps"],
                            x["top_ps"], x["top_ks"], x["keys"], active, limit, min_rem, eos)
    drafts[0, 0] = int(probe[0, 0, 0])
    args = (drafts, draft_len, x["positions"], x["tables"], x["temps"], x["top_ps"],
            x["top_ks"], x["keys"], active, limit, min_rem, eos)
    jargs = [a.astype(np.uint32) if a is x["keys"] else a.astype(np.int32)
             if a.dtype == np.int64 else a for a in (x["tokens"], *args)]
    want = np.asarray(jr.spec_verify(K, 3, *jargs))
    got = tr.spec_verify(K, 3, x["tokens"], *args).numpy()
    _assert_packed_equal(got, want)
    assert got.shape == (K + 1 + 3, B, 42)


@pytest.mark.parametrize("kind", ["decode_multi", "verify"])
def test_decode_multi_and_verify_are_one_upload_of_inputs(kind):
    """Every input of a dispatch lies in one buffer of its key (one copy to
    the card there); a second dispatch reuses it."""
    _, tr, tables, last = _runners()
    x = _common_inputs(last, tables)
    active, limit, min_rem, eos = _lanes()
    for _ in range(2):
        if kind == "decode_multi":
            tr.decode_multi(2, x["tokens"], x["positions"], x["tables"], x["temps"],
                            x["top_ps"], x["top_ks"], x["keys"], active, limit, min_rem, eos)
        else:
            tr.spec_verify(1, 0, x["tokens"], np.full((B, 1), -1), np.zeros(B, np.int64),
                           x["positions"], x["tables"], x["temps"], x["top_ps"], x["top_ks"],
                           x["keys"], active, limit, min_rem, eos)
    (key,) = tr._inputs
    assert key[0] == kind and tr.graph_replays == 0 and not tr.cuda_graphs


# ------------------------------------------------------------ failures


async def serve_open(engine, make_reqs):
    """``make_reqs``' requests through the port's engine, left open."""
    return list(await asyncio.gather(*(collect(engine, r, tp.Context()) for r in make_reqs(tp))))


def _failing_multi(engine):
    def boom(*a, **kw):
        raise RuntimeError("injected horizon failure")

    engine.runner.decode_multi = boom


async def test_a_failed_horizon_degrades_under_lazy_horizon_and_raises_otherwise():
    """lazy_horizon: a horizon dispatch that fails is logged, every lane
    holding a slot fails with ERROR and H drops to 1 (the reference's
    degrade); later requests single-step. Without lazy_horizon the failure
    ends the engine loop: nothing runs a single step in its place."""
    def req(mod):
        return [greedy(mod, [5, 9, 17, 23], 12, ignore_eos=True)]

    lazy = torch_engine(4, lazy_horizon=True)
    _failing_multi(lazy)
    try:
        (failed,) = await serve_open(lazy, req)
        assert failed[1] == "error" and lazy.config.decode_horizon == 1
        assert lazy.stats.horizon_degrades == 1
        (after,) = await serve_open(lazy, req)
    finally:
        await lazy.close()
    (want,) = await serve(torch_engine(1), tp, req)
    assert after == want
    strict = torch_engine(4)
    _failing_multi(strict)
    toks, final = [], None
    try:
        async for out in strict.generate(req(tp)[0], tp.Context()):
            toks.extend(out.token_ids)
            final = out
    finally:
        await strict.close()
    assert final.error["code"] == "engine_loop_crash" and strict.stats.horizon_degrades == 0


def test_graphs_are_refused_off_the_card():
    with pytest.raises(ValueError, match="cuda_graphs needs a CUDA device"):
        TorchModelRunner(tl.LlamaConfig.tiny(vocab_size=VOCAB), _params()[1], device="cpu",
                         cuda_graphs=True, **_dims())
