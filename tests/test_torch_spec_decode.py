"""The port's speculative decoding against the JAX package, on the CPU.

* ``paged_verify_attention_plain`` -- what ``chip_smoke.py`` and the ``cuda``
  test hold the verify kernel against -- equals the JAX Pallas verify kernel
  in interpret mode and the JAX XLA gather branch (f32, atol 1e-5): ragged
  bases, lanes whose drafts stop early (table entries 0 past their last
  block), window, scale and softcap;
* ``llama.decode_verify`` equals the JAX one, fused heads on and off (f32
  logits, rtol 1e-4), and scores what S single decode steps score;
* the port's ``NgramDrafter`` proposes what the JAX one proposes;
* slice parity: ``TorchEngine`` with spec_k=3 and fused decode, and
  ``JaxEngine`` over ``ModelRunner(prefill_chunk_tokens=0,
  fused_decode=True)`` with spec_k=3 and no horizon, both f32 and greedy,
  stream token-identical outputs with equal draft and accept counts;
* spec on equals spec off in the port, greedy and seeded sampling alike;
* with frequency / presence / repetition penalties and min_tokens, spec on
  in both engines still streams token-identical outputs (the verify pass
  penalises position h with the drafts fed before it and masks EOS while
  h < min_tokens - generated).
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.jax_engine.drafter import NgramDrafter as JaxNgramDrafter
from dynamo_tpu.engine.jax_engine.engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.engine.jax_engine.model_runner import ModelRunner
from dynamo_tpu.models import llama as jl
from dynamo_tpu.ops import attention as ja
from dynamo_tpu.ops.pallas_attention import paged_verify_attention_pallas
from dynamo_tpu.pipeline.context import Context as JaxContext
from dynamo_tpu.protocols import common as jp
from dynamo_tpu_torch.engine.torch_engine.drafter import NgramDrafter, make_drafter
from dynamo_tpu_torch.engine.torch_engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.engine.torch_engine.model_runner import TorchModelRunner
from dynamo_tpu_torch.engine.torch_engine.weights import params_from_jax
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.ops import attention as ta
from dynamo_tpu_torch.protocols import common as tp

ATOL = 1e-5
FEATURES = {
    "full": {},
    "window": {"window": 6},
    "scale_softcap": {"scale": 0.3, "logit_softcap": 2.0},
    "window_softcap": {"window": 3, "logit_softcap": 4.0},
}


def _verify_inputs(seed, S=4):
    """B=4 lanes, G=4 (Hq 8 / Hkv 2), S=4; bases ragged across page edges;
    lanes 1 and 3 drafted fewer than S-1 tokens, so their tables end early."""
    rng = np.random.default_rng(seed)
    B, Hq, Hkv, D, nb, bs, max_blocks = 4, 8, 2, 16, 32, 4, 7
    bases = np.array([0, 6, 13, 22], np.int32)
    draft_lens = np.array([3, 1, 3, 0], np.int32)
    pages = rng.permutation(np.arange(1, nb))
    tables = np.zeros((B, max_blocks), np.int32)
    off = 0
    for b in range(B):
        n = (bases[b] + draft_lens[b]) // bs + 1
        tables[b, :n] = pages[off:off + n]
        off += n
    positions = (bases[:, None] + np.arange(S)[None, :]).astype(np.int32)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    kc = rng.standard_normal((Hkv, nb, bs, D)).astype(np.float32)
    vc = rng.standard_normal((Hkv, nb, bs, D)).astype(np.float32)
    return q, kc, vc, tables, positions


@pytest.mark.parametrize("feature", sorted(FEATURES))
def test_plain_verify_matches_pallas_and_xla(feature):
    kw = FEATURES[feature]
    arrs = _verify_inputs(sorted(FEATURES).index(feature))
    got = ta.paged_verify_attention(*(torch.from_numpy(a) for a in arrs), **kw).numpy()
    jargs = [jnp.asarray(a) for a in arrs]
    pallas = paged_verify_attention_pallas(*jargs, interpret=True, **kw)
    xla = ja.paged_verify_attention(*jargs, impl="xla", **kw)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(xla), atol=ATOL, rtol=0)


# ------------------------------------------------------------------ model

BS, NB = 4, 96


def _models(variant="llama", vocab=128):
    kw = {"qwen2_bias_window": {"attn_bias": True, "sliding_window": 6}}.get(variant, {})
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=vocab), **kw)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    if jcfg.attn_bias:
        rng = np.random.default_rng(0)
        for layer in jparams["layers"]:
            for name in ("bq", "bk", "bv"):
                layer[name] = jnp.asarray(rng.standard_normal(layer[name].shape) * 0.5, jnp.float32)
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=vocab), **kw)
    return jcfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _verify_batch():
    """Two lanes with prompts already in the cache, then a verify window of
    S=4 fed tokens each; lane 1's last position is invalid (slot 0)."""
    rng = np.random.default_rng(5)
    tables = np.array([[3, 5, 9, 11, 0, 0], [7, 2, 4, 0, 0, 0]], np.int32)
    lens = [10, 5]
    prompts = [rng.integers(0, 128, n) for n in lens]
    S = 4
    fed = rng.integers(0, 128, (2, S))
    positions = np.array(lens)[:, None] + np.arange(S)[None, :]
    slots = tables[np.arange(2)[:, None], positions // BS] * BS + positions % BS
    slots[1, 3] = 0
    return tables, prompts, fed, positions, slots


def _port_verify(cfg, params):
    tables, prompts, fed, positions, slots = _verify_batch()
    shape = (cfg.num_layers, cfg.num_kv_heads, NB, BS, cfg.head_dim)
    k, v = torch.zeros(shape), torch.zeros(shape)
    for b, p in enumerate(prompts):
        toks = torch.zeros(12, dtype=torch.long)
        toks[: len(p)] = torch.from_numpy(p)
        tl.prefill(params, cfg, toks, len(p), k, v, torch.from_numpy(tables[b, :3]).long())
    return tl.decode_verify(
        params, cfg, torch.from_numpy(fed), torch.from_numpy(positions), k, v,
        torch.from_numpy(tables), torch.from_numpy(slots),
    ), (k, v)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("variant", ["llama", "qwen2_bias_window"])
def test_decode_verify_matches_jax(variant, fused):
    jcfg, jparams, tcfg, tparams = _models(variant)
    jcfg = dataclasses.replace(jcfg, fused_decode=fused)
    tcfg = dataclasses.replace(tcfg, fused_decode=fused)
    got, _ = _port_verify(tcfg, tparams)
    tables, prompts, fed, positions, slots = _verify_batch()
    shape = (jcfg.num_layers, jcfg.num_kv_heads, NB, BS, jcfg.head_dim)
    jk, jv = jnp.zeros(shape), jnp.zeros(shape)
    for b, p in enumerate(prompts):
        toks = np.zeros(12, np.int32)
        toks[: len(p)] = p
        _, jk, jv = jl.prefill(jparams, jcfg, jnp.asarray(toks), jnp.int32(len(p)), jk, jv,
                               jnp.asarray(tables[b, :3]))
    want, _, _ = jl.decode_verify(
        jparams, jcfg, jnp.asarray(fed, jnp.int32), jnp.asarray(positions, jnp.int32),
        jk, jv, jnp.asarray(tables), jnp.asarray(slots, jnp.int32),
    )
    assert got.shape == (2, 4, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_decode_verify_scores_what_single_decode_steps_score():
    _, _, cfg, params = _models()
    cfg = dataclasses.replace(cfg, fused_decode=True)
    got, _ = _port_verify(cfg, params)
    tables, prompts, fed, positions, slots = _verify_batch()
    shape = (cfg.num_layers, cfg.num_kv_heads, NB, BS, cfg.head_dim)
    k, v = torch.zeros(shape), torch.zeros(shape)
    for b, p in enumerate(prompts):
        toks = torch.zeros(12, dtype=torch.long)
        toks[: len(p)] = torch.from_numpy(p)
        tl.prefill(params, cfg, toks, len(p), k, v, torch.from_numpy(tables[b, :3]).long())
    for s in range(3):  # lane 1's position 3 is invalid in the verify pass
        want = tl.decode(
            params, cfg, torch.from_numpy(fed[:, s]), torch.from_numpy(positions[:, s]),
            k, v, torch.from_numpy(tables), torch.from_numpy(slots[:, s]),
        )
        np.testing.assert_allclose(got[:, s].numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ drafter


def test_ngram_drafter_proposes_what_the_jax_one_proposes():
    rng = np.random.default_rng(0)
    seg = list(rng.integers(0, 20, 7))
    histories = [
        seg * 3 + [1, 2],
        seg * 2 + seg[:3],
        list(rng.integers(0, 6, 40)),
        [4, 4, 4, 4],
        [9],
        [],
        list(rng.integers(0, 50, 30)) + seg + [3] + seg[:2],
    ]
    for min_n, max_n in ((2, 4), (1, 3), (3, 3)):
        for k in (None, 1, 3, 5):
            mine, ref = NgramDrafter(4, min_n, max_n), JaxNgramDrafter(4, min_n, max_n)
            for h in histories:
                assert mine.draft(h, k) == ref.draft(h, k), (h, k, min_n, max_n)
    assert make_drafter("prompt_lookup", 3).draft(seg * 2 + seg[:2]) == seg[2:5]
    with pytest.raises(ValueError):
        make_drafter("eagle", 3)


# ------------------------------------------------------------------ engine

# a 24-token vocabulary: histories repeat bigrams often, so lanes draft on
# most steps whatever is sampled (a random model does not continue a
# repeated prompt by itself)
MAX_BATCH, MAX_LEN, K, VOCAB = 6, 96, 3, 24


def _prompts():
    """Six prompts that repeat a random segment 2-4 times."""
    rng = np.random.default_rng(7)
    out = []
    for i in range(6):
        seg = [int(t) for t in rng.integers(0, VOCAB, 4 + i)]
        out.append(seg * (2 + i % 3))
    return out


MAX_NEW = [14, 18, 12, 20, 16, 15]


def _torch_engine(params, spec_k=K, fused=True, coverage=0.5, num_blocks=NB, watermark=2):
    cfg = tl.LlamaConfig.tiny(vocab_size=VOCAB)
    runner = TorchModelRunner(
        cfg, params, num_blocks=num_blocks, block_size=BS, max_batch=MAX_BATCH,
        max_model_len=MAX_LEN, device="cpu", fused_decode=fused, prefill_chunk_tokens=0,
    )
    return TorchEngine(runner, TorchEngineConfig(
        max_batch=MAX_BATCH, block_size=BS, num_blocks=num_blocks, max_model_len=MAX_LEN,
        watermark_blocks=watermark, spec_k=spec_k, spec_min_coverage=coverage,
    ))


def _jax_engine(jcfg, jparams):
    runner = ModelRunner(
        jcfg, jparams, num_blocks=NB, block_size=BS, max_batch=MAX_BATCH,
        max_model_len=MAX_LEN, kv_dtype=jnp.float32, prefill_chunk_tokens=0,
        fused_decode=True,
    )
    return JaxEngine(runner, JaxEngineConfig(
        max_batch=MAX_BATCH, block_size=BS, num_blocks=NB, max_model_len=MAX_LEN,
        watermark_blocks=2, spec_k=K, decode_horizon=1,
    ))


def _request(mod, prompt, n, eos=(), **sampling):
    return mod.PreprocessedRequest(
        token_ids=list(prompt), sampling=mod.SamplingOptions(**(sampling or {"greedy": True})),
        stop=mod.StopConditions(max_tokens=n), eos_token_ids=list(eos),
    )


async def _collect(engine, req, ctx):
    toks, reason = [], None
    async for out in engine.generate(req, ctx):
        toks.extend(out.token_ids)
        if out.finish_reason is not None:
            reason = out.finish_reason
    return toks, reason


async def _serve(engine, mod, ctx_cls, eos=(), **sampling):
    try:
        return await asyncio.gather(*(
            _collect(engine, _request(mod, p, n, eos, **sampling), ctx_cls())
            for p, n in zip(_prompts(), MAX_NEW)
        ))
    finally:
        await engine.close()


async def test_slice_parity_spec_fused_token_identical_with_jax_engine():
    jcfg, jparams, _, tparams = _models(vocab=VOCAB)
    jeng, teng = _jax_engine(jcfg, jparams), _torch_engine(tparams)
    jres = await _serve(jeng, jp, JaxContext)
    tres = await _serve(teng, tp, tp.Context)
    for (jt, jr), (tt, tr), n in zip(jres, tres, MAX_NEW):
        assert tt == jt
        assert len(tt) == n and jr.value == tr.value == "length"
    js, ts = jeng.stats, teng.stats
    assert ts.num_drafts > 0 and ts.num_accepted_tokens > 0 and ts.verify_steps > 0
    assert (ts.num_drafts, ts.num_draft_tokens, ts.num_accepted_tokens) == (
        js.num_drafts, js.num_draft_tokens, js.num_accepted_tokens
    )
    assert ts.accepted_per_pos == js.accepted_per_pos
    assert teng.allocator.free_count == NB - 1


@pytest.mark.parametrize("sampling", [
    {"greedy": True},
    {"temperature": 0.9, "top_k": 40, "seed": 1234},
    {"temperature": 1.5, "seed": 99},
], ids=["greedy", "seeded_topk", "seeded_full_vocab"])
async def test_spec_on_equals_spec_off(sampling):
    _, _, _, params = _models(vocab=VOCAB)
    # any drafting lane triggers a verify dispatch, so sampled runs verify too
    on, off = _torch_engine(params, coverage=0.01), _torch_engine(params, spec_k=0)
    got = await _serve(on, tp, tp.Context, **sampling)
    want = await _serve(off, tp, tp.Context, **sampling)
    assert got == want
    assert on.stats.verify_steps > 0 and off.stats.verify_steps == 0
    if "greedy" in sampling:  # greedy output repeats itself, so drafts land
        assert on.stats.num_accepted_tokens > 0


async def test_spec_under_block_pressure_preempts_and_keeps_the_tokens():
    """39 usable blocks for ~54 blocks of final context: verify dispatches
    fall back to single steps when their blocks cannot be preallocated,
    lanes are preempted and re-prefilled, and the tokens stay the same."""
    _, _, _, params = _models(vocab=VOCAB)
    want = await _serve(_torch_engine(params, spec_k=0), tp, tp.Context)
    tight = _torch_engine(params, coverage=0.01, num_blocks=40, watermark=0)
    got = await _serve(tight, tp, tp.Context)
    assert got == want
    assert tight.stats.preemptions > 0 and tight.stats.verify_steps > 0
    assert tight.allocator.free_count == 39


async def test_spec_stops_at_eos_and_max_tokens_inside_a_draft():
    _, _, _, params = _models(vocab=VOCAB)
    plain = await _serve(_torch_engine(params, spec_k=0), tp, tp.Context)
    eos = [plain[3][0][5]]  # greedy output repeats itself: hit mid-stream
    want = await _serve(_torch_engine(params, spec_k=0), tp, tp.Context, eos=eos)
    engine = _torch_engine(params, coverage=0.01)
    got = await _serve(engine, tp, tp.Context, eos=eos)
    assert got == want
    reasons = {r for _, r in got}
    assert tp.FinishReason.EOS in reasons and tp.FinishReason.LENGTH in reasons
    assert engine.stats.num_accepted_tokens > 0
    assert engine.allocator.free_count == NB - 1


def test_spec_verify_refuses_the_chained_horizon():
    """The chained horizon rides penalty-free verify passes only: with
    penalties ``extras`` > 0 raises (the count tables cannot take a
    rejected draft back out); without them the dispatch returns S + E
    rows."""
    _, _, cfg, params = _models()
    runner = TorchModelRunner(cfg, params, num_blocks=NB, block_size=BS, max_batch=2,
                              max_model_len=MAX_LEN, device="cpu")
    z = np.zeros(2, np.int64)
    args = (z, np.full((2, K), -1), z, z, np.zeros((2, 24), np.int32),
            z, z + 1, z, np.zeros((2, 2), np.int64), z.astype(bool), z + 1)
    pen = (np.zeros((2, MAX_LEN), np.int64), z, z, z.astype(np.float32),
           z.astype(np.float32), np.ones(2, np.float32))
    with pytest.raises(ValueError, match="extras=0"):
        runner.spec_verify(K, 1, *args, penalties=pen)
    assert tuple(runner.spec_verify(K, 1, *args).shape) == (K + 2, 2, 42)


SPEC_PENALTIES = [{}, {"frequency_penalty": 0.6}, {"repetition_penalty": 1.4},
                  {"presence_penalty": 0.8, "repetition_penalty": 1.2}, {},
                  {"frequency_penalty": 0.3}]


def _pen_requests(mod):
    """Plain and penalty lanes; lanes 0 and 4 carry a prompt token as EOS
    and min_tokens 8, so verify positions mask it."""
    out = []
    for i, (p, n) in enumerate(zip(_prompts(), MAX_NEW)):
        mt = i in (0, 4)
        out.append(mod.PreprocessedRequest(
            token_ids=list(p), sampling=mod.SamplingOptions(greedy=True, **SPEC_PENALTIES[i]),
            stop=mod.StopConditions(max_tokens=n, min_tokens=8 if mt else None),
            eos_token_ids=[p[1]] if mt else [],
        ))
    return out


async def test_spec_with_penalties_and_min_tokens_token_identical_with_jax_engine():
    jcfg, jparams, _, tparams = _models(vocab=VOCAB)
    jeng, teng = _jax_engine(jcfg, jparams), _torch_engine(tparams)
    try:
        jres = await asyncio.gather(*(_collect(jeng, r, JaxContext()) for r in _pen_requests(jp)))
        tres = await asyncio.gather(*(_collect(teng, r, tp.Context()) for r in _pen_requests(tp)))
    finally:
        await jeng.close()
        await teng.close()
    assert [(t, r.value) for t, r in tres] == [(t, r.value) for t, r in jres]
    for i in (0, 4):
        assert len(tres[i][0]) >= 8
    js, ts = jeng.stats, teng.stats
    assert ts.verify_steps > 0 and ts.num_drafts > 0
    assert (ts.num_drafts, ts.num_draft_tokens, ts.num_accepted_tokens) == (
        js.num_drafts, js.num_draft_tokens, js.num_accepted_tokens
    )
    assert teng.allocator.free_count == NB - 1
