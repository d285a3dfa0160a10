"""The port's default admission path against the JAX package, on the CPU.

Packed, chunked and mixed-step prefill, op by op and end to end, in f32 at
the tiny size of the reference's own chunking tests (block 4, chunk 8,
max_model_len 64). Inputs are made from a seed with numpy; parameters come
from the JAX init, carried over bit for bit with ``params_from_jax``.

* ``packed_prefill_attention``, ``chunked_prefill_attention`` (the port
  gathers only the blocks a chunk can see; the reference the whole table)
  and ``apply_repetition_penalty_packed`` equal the JAX ops (atol / rtol
  1e-5; the penalty 1e-6); ``write_chunk_kv`` writes exactly what the JAX
  one writes, also for a final chunk that runs past the table;
* ``pack_prefill`` gives the JAX runner's arrays bit for bit;
  ``llama.prefill_chunk`` over consecutive chunks gives the one-shot JAX
  prefill's logits and caches (1e-5); the runners' ``prefill_chunk``,
  ``prefill_packed_arrays`` and ``mixed_step`` give the JAX runners'
  samples (tokens exactly, logprobs 1e-5) and caches (1e-5);
* ``TorchEngine`` with its defaults (chunking on, mixed steps on) streams
  ``JaxEngine``'s greedy tokens while a long prompt is chunked alone, then
  beside a decode lane, and short prompts are packed; it really chunks,
  packs and mixes. Seeded sampling gives the same streams with mixed steps
  on and off; a lane with penalties turns mixing off; cancellation
  mid-chunk and preemption of a sequence still being chunked leave the
  engine consistent; a chunk budget off the block grid raises.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.jax_engine.engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.engine.jax_engine.model_runner import ModelRunner
from dynamo_tpu.models import llama as jl
from dynamo_tpu.ops import attention as JA
from dynamo_tpu.ops import sampling as JS
from dynamo_tpu.pipeline.context import Context as JaxContext
from dynamo_tpu.protocols import common as jp
from dynamo_tpu_torch.engine.torch_engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
from dynamo_tpu_torch.engine.torch_engine.model_runner import TorchModelRunner
from dynamo_tpu_torch.engine.torch_engine.weights import params_from_jax
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.ops import attention as TA
from dynamo_tpu_torch.ops import sampling as TS
from dynamo_tpu_torch.protocols import common as tp

BS, C, MAX_LEN, NB, MAX_BATCH, VOCAB = 4, 8, 64, 64, 4, 64
TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


# ------------------------------------------------------------------- ops

ATTN_KW = {
    "plain": {},
    "window": {"window": 3},
    "scale_softcap": {"scale": 0.3, "logit_softcap": 5.0},
}


@pytest.mark.parametrize("kw", sorted(ATTN_KW))
def test_packed_prefill_attention_matches_jax(kw):
    rng = np.random.default_rng(0)
    P, Hq, Hkv, D = 16, 4, 2, 8  # GQA group 2
    q = rng.standard_normal((P, Hq, D), dtype=np.float32)
    k = rng.standard_normal((P, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((P, Hkv, D), dtype=np.float32)
    seg = np.array([0] * 5 + [1] * 3 + [2] * 6 + [-1] * 2, np.int32)  # padding at the end
    want = JA.packed_prefill_attention(_j(q), _j(k), _j(v), _j(seg), **ATTN_KW[kw])
    got = TA.packed_prefill_attention(_t(q), _t(k), _t(v), _t(seg), **ATTN_KW[kw])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _paged_cache(rng, Hkv=2, D=8, nblocks=NB):
    shape = (Hkv, nblocks, BS, D)
    return (rng.standard_normal(shape, dtype=np.float32),
            rng.standard_normal(shape, dtype=np.float32))


@pytest.mark.parametrize("kw", sorted(ATTN_KW))
@pytest.mark.parametrize("chunk_start", [0, 8, 24])
def test_chunked_prefill_attention_matches_jax_on_a_full_width_table(chunk_start, kw):
    rng = np.random.default_rng(chunk_start)
    kc, vc = _paged_cache(rng)
    q = rng.standard_normal((C, 4, 8), dtype=np.float32)
    # a prompt of 30 tokens in 8 shuffled blocks, the table padded with null
    # block 0 to max_model_len (the mixed step's width)
    table = np.zeros(MAX_LEN // BS, np.int32)
    table[:8] = rng.permutation(np.arange(1, NB))[:8]
    want = JA.chunked_prefill_attention(
        _j(q), _j(kc), _j(vc), _j(table), jnp.int32(chunk_start), **ATTN_KW[kw])
    got = TA.chunked_prefill_attention(
        _t(q), _t(kc), _t(vc), _t(table), chunk_start, **ATTN_KW[kw])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the port gathers only the blocks up to the chunk's end
    assert TA.chunk_visible_blocks(chunk_start, C, BS, len(table)) == (chunk_start + C) // BS


@pytest.mark.parametrize("chunk_start", [0, 8, 16])
def test_write_chunk_kv_matches_jax_also_past_the_table(chunk_start):
    """A 5-block table (a 20-token prompt's bucket): the chunk at 16 covers
    blocks 4 and 5, and block 5 is past the table, so its half goes to null
    block 0 and no earlier block is touched."""
    rng = np.random.default_rng(chunk_start)
    kc, vc = _paged_cache(rng)
    k_new = rng.standard_normal((C, 2, 8), dtype=np.float32)
    v_new = rng.standard_normal((C, 2, 8), dtype=np.float32)
    table = np.array([7, 3, 11, 5, 9], np.int32)
    jk, jv = JA.write_chunk_kv(_j(kc), _j(vc), _j(k_new), _j(v_new), _j(table),
                               jnp.int32(chunk_start))
    tk, tv = _t(kc.copy()), _t(vc.copy())
    TA.write_chunk_kv(tk, tv, _t(k_new), _t(v_new), _t(table), chunk_start)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if chunk_start == 16:
        np.testing.assert_array_equal(tk.numpy()[:, 0], k_new[BS:].transpose(1, 0, 2))
        untouched = [b for b in range(NB) if b not in (0, 9)]
        np.testing.assert_array_equal(tk.numpy()[:, untouched], kc[:, untouched])


def test_write_chunk_kv_refuses_a_start_off_the_block_grid():
    kc = torch.zeros(2, NB, BS, 8)
    new = torch.zeros(C, 2, 8)
    with pytest.raises(ValueError, match="not a multiple of the KV block size"):
        TA.write_chunk_kv(kc, kc.clone(), new, new, torch.arange(1, 9), 6)


def test_apply_repetition_penalty_packed_matches_jax():
    rng = np.random.default_rng(3)
    N, V = 4, VOCAB
    logits = rng.standard_normal((N, V), dtype=np.float32) * 3
    tokens = rng.integers(0, V, 16).astype(np.int32)
    seg = np.array([0] * 4 + [1] * 6 + [2] * 3 + [-1] * 3, np.int32)
    rep = np.array([1.8, 1.0, 0.7, 1.3], np.float32)  # row 3 is unused
    want = JS.apply_repetition_penalty_packed(_j(logits), _j(tokens), _j(seg), _j(rep))
    got = TS.apply_repetition_penalty_packed(_t(logits), _t(tokens), _t(seg), _t(rep))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_array_equal(got.numpy()[1], logits[1])  # rep 1: untouched
    # each segment sees its own tokens only
    np.testing.assert_array_equal(got.numpy()[3], logits[3])


# ------------------------------------------------------------ model and runner


def _models(vocab=VOCAB):
    jcfg = jl.LlamaConfig.tiny(vocab_size=vocab)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tl.LlamaConfig.tiny(vocab_size=vocab), tparams


def _runners(chunk=C):
    jcfg, jparams, tcfg, tparams = _models()
    jr = ModelRunner(jcfg, jparams, num_blocks=NB, block_size=BS, max_batch=MAX_BATCH,
                     max_model_len=MAX_LEN, kv_dtype=jnp.float32, prefill_chunk_tokens=chunk)
    tr = TorchModelRunner(tcfg, tparams, num_blocks=NB, block_size=BS, max_batch=MAX_BATCH,
                          max_model_len=MAX_LEN, device="cpu", prefill_chunk_tokens=chunk)
    return jr, tr


def _same_caches(jr, tr, blocks=None):
    for j, t in ((jr.k_cache, tr.k_cache), (jr.v_cache, tr.v_cache)):
        j, t = np.asarray(j), t.numpy()
        if blocks is not None:
            j, t = j[:, :, blocks], t[:, :, blocks]
        np.testing.assert_allclose(t, j, **TOL)


def _same_sample(jout, tout):
    """(token, logprob, top ids, top logprobs) of both runners, fetched."""
    jt, jlp, jids, jlps = (np.asarray(a) for a in jout)
    tt, tlp, tids, tlps = tout
    np.testing.assert_array_equal(tt.reshape(jt.shape), jt)
    np.testing.assert_allclose(tlp.reshape(jlp.shape), jlp, **TOL)
    np.testing.assert_array_equal(tids.reshape(jids.shape), jids)
    np.testing.assert_allclose(tlps.reshape(jlps.shape), jlps, **TOL)


def test_runner_chunk_size_rounds_to_blocks_and_caps_at_the_largest_bucket():
    for chunk in (0, 6, 8, 512):
        jr, tr = _runners(chunk)
        assert tr.prefill_chunk_tokens == jr.prefill_chunk_tokens
    assert [_runners(c)[1].prefill_chunk_tokens for c in (0, 6, 512)] == [0, 8, MAX_LEN]


def test_prefill_chunk_over_consecutive_chunks_equals_one_shot_jax_prefill():
    jcfg, jparams, tcfg, tparams = _models()
    prompt = np.random.default_rng(0).integers(1, VOCAB, 23)
    blocks = list(range(3, 9))  # 6 blocks of 4 hold 23 tokens
    shape = (tcfg.num_layers, tcfg.num_kv_heads, NB, BS, tcfg.head_dim)
    # one shot, JAX: the prompt padded to its bucket of 32
    tokens = np.zeros(32, np.int32)
    tokens[:23] = prompt
    jtable = np.zeros(8, np.int32)
    jtable[:6] = blocks
    jlogits, jk, jv = jl.prefill(jparams, jcfg, _j(tokens), jnp.int32(23),
                                 jnp.zeros(shape), jnp.zeros(shape), _j(jtable))
    # chunk by chunk, the port: chunks at 0, 8, 16 (the last one 7 tokens)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    table = torch.tensor(jtable, dtype=torch.int64)
    for start in (0, 8, 16):
        chunk = np.zeros(C, np.int64)
        part = prompt[start:start + C]
        chunk[:len(part)] = part
        logits = tl.prefill_chunk(tparams, tcfg, torch.from_numpy(chunk), start, 23, tk, tv, table)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for got, want in ((tk, jk), (tv, jv)):
        got, want = got.numpy()[:, :, blocks], np.asarray(want)[:, :, blocks]
        pos = np.arange(6 * BS).reshape(6, BS) < 23  # positions the prompt filled
        np.testing.assert_allclose(got[:, :, pos], want[:, :, pos], **TOL)


def test_runner_prefill_chunk_matches_jax_runner_with_its_penalty_approximation():
    """Greedy, repetition penalty 1.6 and a masked stop id on the final
    chunk: both penalise from the final chunk's tokens only."""
    jr, tr = _runners()
    prompt = [int(t) for t in np.random.default_rng(1).integers(1, VOCAB, 20)]
    blocks = list(range(10, 15))
    eos = np.array([prompt[-1], -1, -1, -1], np.int32)
    for start in (0, 8, 16):
        part = prompt[start:start + C]
        args = (part, start, len(prompt), blocks, 0.0, 1.0, 0)
        kw = dict(rep_pen=1.6, eos_ids=eos, eos_suppress=True)
        jout = jr.prefill_chunk(*args, **kw)
        tout = tr.prefill_chunk(*args, **kw)
    _same_sample(jout, tr.fetch_sample(tout))
    _same_caches(jr, tr, blocks)


def _pack_specs(jax_keys=False):
    rng = np.random.default_rng(4)
    specs = []
    for i, n in enumerate((3, 1, 2)):
        toks = [int(t) for t in rng.integers(1, VOCAB, n)]
        key = np.array([100 + i, i], np.uint32 if jax_keys else np.int64)
        eos = np.array([toks[0], -1, -1, -1], np.int32)
        specs.append((toks, [20 + 2 * i, 21 + 2 * i], 0.0, 1.0, 0, (1.0, 1.5, 0.8)[i],
                      key, eos, i == 2))
    return specs


def test_pack_prefill_arrays_equal_the_jax_runners_bit_for_bit():
    jr, tr = _runners()
    want = jr.pack_prefill(_pack_specs(jax_keys=True))
    got = tr.pack_prefill(_pack_specs())
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_prefill_packed_arrays_matches_the_jax_runner():
    jr, tr = _runners()
    jout = jr.prefill_packed_arrays(**jr.pack_prefill(_pack_specs(jax_keys=True)))
    tout = tr.prefill_packed_arrays(**tr.pack_prefill(_pack_specs()))
    _same_sample([np.asarray(a)[:3] for a in jout], [a[:3] for a in tr.fetch_sample(tout)])
    _same_caches(jr, tr, list(range(20, 26)))


def test_mixed_step_matches_the_jax_runner():
    """Two lanes decode while a 20-token prompt goes through in two mixed
    steps: two of its chunks in the first (one sequence, two slots, in
    order), the final one in the second; a third lane is inactive."""
    jr, tr = _runners()
    rng = np.random.default_rng(5)
    lanes = {0: ([int(t) for t in rng.integers(1, VOCAB, 6)], [1, 2, 3]),
             2: ([int(t) for t in rng.integers(1, VOCAB, 9)], [4, 5, 6])}
    fed = {}
    for i, (p, b) in lanes.items():
        jo = jr.fetch_sample(jr.prefill(p, b, 0.0, 1.0, 0))
        to = tr.fetch_sample(tr.prefill(p, b, 0.0, 1.0, 0))
        assert int(jo[0]) == int(to[0][0])
        fed[i] = int(to[0][0])
    prompt = [int(t) for t in rng.integers(1, VOCAB, 20)]
    pblocks = list(range(30, 35))
    B = MAX_BATCH
    tokens, positions = np.zeros(B, np.int32), np.zeros(B, np.int32)
    tables = np.zeros((B, MAX_LEN // BS), np.int32)
    slots = np.zeros(B, np.int32)
    for i, (p, b) in lanes.items():
        tables[i, :3] = b
    temps, top_ps, top_ks = np.zeros(B, np.float32), np.ones(B, np.float32), np.zeros(B, np.int32)
    keys = np.zeros((B, 2), np.uint32)
    eos_ids = np.full((B, 4), -1, np.int32)
    eos_sup = np.zeros(B, bool)
    eos_ids[2, 0] = 7
    eos_sup[2] = True  # a min_tokens lane: its stop id is masked
    for step, starts in enumerate(((0, 8), (16,))):
        for i, (p, _) in lanes.items():
            pos = len(p) + step
            tokens[i], positions[i] = fed[i], pos
            slots[i] = tables[i, pos // BS] * BS + pos % BS
        chunks = [(prompt[s:s + C], s, len(prompt), pblocks, 0.0, 1.0, 0, 1.0, None,
                   None, False) for s in starts]
        args = (tokens, positions, tables, slots, keys, temps, top_ps, top_ks)
        jc, jd = jr.mixed_step(chunks, *args, eos_ids=eos_ids, eos_suppress=eos_sup)
        tc, td = tr.mixed_step(chunks, *map(np.copy, args), eos_ids=eos_ids,
                               eos_suppress=eos_sup)
        assert len(tc) == len(starts)
        active = sorted(lanes)
        _same_sample([np.asarray(a)[active] for a in jd],
                     [a[active] for a in tr.fetch_sample(td)])
        for i in active:
            fed[i] = int(np.asarray(jd[0])[i])
    _same_sample(jc[-1], tr.fetch_sample(tc[-1]))  # the prompt's first token
    _same_caches(jr, tr, pblocks + [1, 2, 3, 4, 5, 6])


# ----------------------------------------------------------------- engines


def _torch_engine(tparams, chunk=C, num_blocks=NB, watermark=2, **cfg):
    runner = TorchModelRunner(
        tl.LlamaConfig.tiny(vocab_size=VOCAB), tparams, num_blocks=num_blocks, block_size=BS,
        max_batch=MAX_BATCH, max_model_len=MAX_LEN, device="cpu", prefill_chunk_tokens=chunk,
    )
    return TorchEngine(runner, TorchEngineConfig(
        max_batch=MAX_BATCH, block_size=BS, num_blocks=num_blocks, max_model_len=MAX_LEN,
        watermark_blocks=watermark, **cfg))


def _jax_engine(jcfg, jparams, **cfg):
    runner = ModelRunner(jcfg, jparams, num_blocks=NB, block_size=BS, max_batch=MAX_BATCH,
                         max_model_len=MAX_LEN, kv_dtype=jnp.float32, prefill_chunk_tokens=C)
    return JaxEngine(runner, JaxEngineConfig(
        max_batch=MAX_BATCH, block_size=BS, num_blocks=NB, max_model_len=MAX_LEN,
        watermark_blocks=2, **cfg))


def _request(mod, prompt, max_tokens, **sampling):
    return mod.PreprocessedRequest(
        token_ids=list(prompt), sampling=mod.SamplingOptions(**(sampling or {"greedy": True})),
        stop=mod.StopConditions(max_tokens=max_tokens, ignore_eos=True),
    )


async def _collect(engine, req, ctx, first=None):
    toks, reason = [], None
    async for out in engine.generate(req, ctx):
        toks.extend(out.token_ids)
        if first is not None and toks:
            first.set()
        if out.finish_reason is not None:
            reason = out.finish_reason.value
    return toks, reason


LONG = [int(t) for t in np.random.default_rng(1).integers(1, VOCAB, 40)]
LONG2 = [int(t) for t in np.random.default_rng(2).integers(1, VOCAB, 30)]


async def _overlapped(engine, mod, ctx, make=None):
    """A 40-token prompt is chunked alone (no decode lane yet) and then
    decodes 24 tokens; meanwhile a 30-token prompt is chunked beside it
    and two short prompts are packed into one prefill."""
    make = make or (lambda p, n, i: _request(mod, p, n))
    first = asyncio.Event()
    a = asyncio.create_task(_collect(engine, make(LONG, 24, 0), ctx(), first))
    await asyncio.wait_for(first.wait(), 60)
    rest = [(LONG2, 6), ([1, 2, 3], 12), ([9, 8, 7, 6, 5], 10)]
    outs = await asyncio.gather(*(
        _collect(engine, make(p, n, i + 1), ctx()) for i, (p, n) in enumerate(rest)))
    out = [await a, *outs]
    await engine.close()
    return out


async def test_default_engine_streams_jax_engines_tokens_and_packs_chunks_and_mixes():
    jcfg, jparams, _, tparams = _models()
    want = await _overlapped(_jax_engine(jcfg, jparams), jp, JaxContext)
    engine = _torch_engine(tparams)
    got = await _overlapped(engine, tp, tp.Context)
    assert got == want
    assert [len(t) for t, _ in got] == [24, 6, 12, 10]
    s = engine.stats
    assert s.packed_prefills > 0 and s.chunk_steps >= 5 and s.mixed_steps > 0
    assert s.prefills == 0
    assert engine.allocator.free_count == NB - 1 and not engine._prefilling


async def test_seeded_sampling_is_the_same_with_mixed_steps_on_and_off():
    *_, tparams = _models()

    def make(p, n, i):
        return _request(tp, p, n, temperature=0.9, top_k=8, seed=4242 + i)

    on = _torch_engine(tparams, mixed_step=True)
    off = _torch_engine(tparams, mixed_step=False)
    got_on = await _overlapped(on, tp, tp.Context, make)
    got_off = await _overlapped(off, tp, tp.Context, make)
    assert got_on == got_off
    assert on.stats.mixed_steps > 0 and off.stats.mixed_steps == 0
    assert off.stats.chunk_steps > on.stats.chunk_steps


async def test_a_lane_with_penalties_turns_mixing_off():
    jcfg, jparams, _, tparams = _models()

    def make(mod):
        def f(p, n, i):
            pen = {"repetition_penalty": 1.5} if i == 0 else {}
            return _request(mod, p, n, greedy=True, **pen)
        return f

    want = await _overlapped(_jax_engine(jcfg, jparams), jp, JaxContext, make(jp))
    engine = _torch_engine(tparams)
    got = await _overlapped(engine, tp, tp.Context, make(tp))
    assert got == want
    assert engine.stats.mixed_steps == 0 and engine.stats.chunk_steps >= 5 + 4


async def test_cancellation_mid_chunk_frees_the_sequence():
    *_, tparams = _models()
    engine = _torch_engine(tparams)
    ctx = tp.Context()
    calls = []
    orig = engine.runner.prefill_chunk

    def spy(*a, **k):
        calls.append(a[1])
        if len(calls) == 2:
            ctx.kill()  # the consumer goes away while the prompt is chunked
        return orig(*a, **k)

    engine.runner.prefill_chunk = spy
    try:
        toks, reason = await asyncio.wait_for(
            _collect(engine, _request(tp, LONG, 8), ctx), 60)
        assert reason == "cancelled" and toks == []
        assert calls == [0, 8]
        assert not engine._prefilling and all(s is None for s in engine.slots)
        assert engine.allocator.free_count == NB - 1
        # the engine goes on serving
        toks, reason = await _collect(engine, _request(tp, LONG2, 3), tp.Context())
        assert reason == "length" and len(toks) == 3
    finally:
        await engine.close()


async def test_preempting_a_sequence_still_being_chunked_recomputes_it():
    """14 usable blocks: a short prompt decodes while a 48-token prompt (12
    blocks) is chunked one 8-token chunk per mixed step; the short lane's
    third block preempts the long one mid-prefill, which re-queues and
    re-prefills from scratch once the short one is done."""
    *_, tparams = _models()
    roomy = _torch_engine(tparams, chunk_budget=C)
    tight = _torch_engine(tparams, num_blocks=15, watermark=0, chunk_budget=C)
    prompts = [([1, 2, 3], 12), (LONG + LONG2[:8], 4)]

    async def serve(engine):
        try:
            return await asyncio.gather(*(
                _collect(engine, _request(tp, p, n), tp.Context()) for p, n in prompts))
        finally:
            await engine.close()

    victims = []
    orig = tight._preempt

    def spy(victim):
        victims.append((victim.prefilling, victim.prefill_pos))
        orig(victim)

    tight._preempt = spy
    want = await serve(roomy)
    got = await serve(tight)
    assert got == want
    assert roomy.stats.preemptions == 0 and tight.stats.preemptions >= 1
    assert victims[0][0] and 0 < victims[0][1] < 48
    assert tight.stats.mixed_steps > 0
    assert tight.allocator.free_count == 14 and not tight._prefilling


def test_a_chunk_budget_off_the_block_grid_raises(monkeypatch):
    *_, tparams = _models()
    with pytest.raises(ValueError, match="not a multiple of the KV block size 4"):
        _torch_engine(tparams, chunk_budget=10)
    monkeypatch.setenv("DYN_CHUNK_BUDGET", "10")
    with pytest.raises(ValueError, match="not a multiple of the KV block size 4"):
        build_torch_engine(tl.LlamaConfig.tiny(vocab_size=VOCAB), device="cpu",
                           kv_block_size=4, max_model_len=MAX_LEN)
    monkeypatch.setenv("DYN_CHUNK_BUDGET", "12")
    monkeypatch.setenv("DYN_MIXED_STEP", "0")
    engine = build_torch_engine(tl.LlamaConfig.tiny(vocab_size=VOCAB), device="cpu",
                                kv_block_size=4, max_model_len=MAX_LEN, prefill_chunk_tokens=C,
                                dtype=torch.float32)
    assert engine.config.chunk_budget == 12 and engine.config.mixed_step is False
    assert engine._mixed_max_slots == 2 and not engine._mixed_enabled
