"""The port's MoE layer and Mixtral serving against the JAX package's, on the CPU.

Inputs come from numpy seeds (or the JAX init, carried over bit for bit with
``params_from_jax``); the JAX side runs ``dynamo_tpu.ops.moe`` and
``dynamo_tpu.models.mixtral`` on the CPU as tests/test_moe.py does.
Everything is f32, so the bars are the reference's own held tighter:

* ``router_topk``: the same ids (ties to the lower expert, as
  ``lax.top_k``) and weights within 1e-6; ``make_dispatch`` equal with
  capacity drops and with the mask; ``moe_ffn`` (GShard) chunked equal to
  unchunked and to the JAX op, renormalized on drops;
* ``moe_ffn_dropless`` under the imbalance of tests/test_moe.py:238: the
  device-side expert order equals the stable argsort and bincount,
  ``grouped_ffn_plain`` equals the JAX ``_grouped_ffn`` (``ragged_dot``) at
  atol / rtol 1e-5, the whole op the JAX op at 1e-5 and the reference's
  per-token ``naive_moe`` oracle at 1e-4;
* ``tiny_moe`` prefill and decode logits against ``mixtral.prefill`` /
  ``mixtral.decode`` at tests/test_torch_model.py's f32 tolerance (rtol
  1e-4, atol 1e-4 of the largest |logit|), dropless and GShard, and with
  int8 dense projections (experts unquantized) through ``params_from_jax``;
* ``TorchEngine`` streams ``JaxEngine``'s greedy tokens, token for token, on
  ``tiny_moe`` with the default admission (packed, chunked, mixed steps),
  with decode horizon 4 and with spec_k 3; a tp = 2 gloo engine streams a
  tp = 2 ``JaxEngine``'s (``build_mesh(tp=2)``), and its expert slices equal
  the JAX shards;
* ``param_count`` and ``default_num_blocks`` equal the JAX factory's for
  Mixtral-8x7B, bf16 and int8 weights; expert parallelism raises
  NotImplementedError; the card refuses MoE shapes the grouped kernel does
  not take, before any request.
"""

import asyncio
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.jax_engine import factory as jfactory
from dynamo_tpu.engine.jax_engine.engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.engine.jax_engine.model_runner import ModelRunner
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models import mixtral as jmix
from dynamo_tpu.ops import moe as jm
from dynamo_tpu.parallel.mesh import build_mesh
from dynamo_tpu.parallel.sharding import shard_llama as jshard_llama
from dynamo_tpu.pipeline.context import Context as JaxContext
from dynamo_tpu.protocols import common as jp
from dynamo_tpu_torch.engine.torch_engine import factory as tfactory
from dynamo_tpu_torch.engine.torch_engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.engine.torch_engine.model_runner import TorchModelRunner
from dynamo_tpu_torch.engine.torch_engine.weights import init_params, params_from_jax
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models import mixtral as tmix
from dynamo_tpu_torch.ops import kernels
from dynamo_tpu_torch.ops import moe as tm
from dynamo_tpu_torch.parallel.sharding import shard_llama
from dynamo_tpu_torch.protocols import common as tp
from tests.test_moe import naive_moe

OP_TOL = dict(atol=1e-5, rtol=1e-5)
ORACLE_TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _weights(E, D, F, seed):
    rng = np.random.default_rng(seed)
    return (
        (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32),
        (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32),
        (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32),
        (rng.standard_normal((E, F, D)) / np.sqrt(F)).astype(np.float32),
    )


# ---------------------------------------------------------------- routing


def test_router_topk_matches_jax_with_ties():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((12, 8)).astype(np.float32)
    logits[0] = 1.0  # every expert tied
    logits[1, [2, 5, 7]] = 9.0  # a three-way tie for the top
    logits[2, [1, 6]] = [3.0, 3.0]  # a tie for second place
    logits[2, 4] = 5.0
    logits[3] = np.round(logits[3])  # integer logits: ties among the rest
    for k in (1, 2, 3):
        jidx, jw = jm.router_topk(jnp.asarray(logits), k)
        tidx, tw = tm.router_topk(_t(logits), k)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6, rtol=1e-6)
    idx, _ = tm.router_topk(_t(logits), 3)
    assert idx[0].tolist() == [0, 1, 2] and idx[1].tolist() == [2, 5, 7]
    assert idx[2, :2].tolist() == [4, 1]


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_make_dispatch_matches_jax_with_capacity_drops(masked):
    rng = np.random.default_rng(1)
    T, k, E, C = 10, 2, 4, 3
    idx = np.stack([rng.choice(E, k, replace=False) for _ in range(T)]).astype(np.int32)
    idx[:6, 0] = 1  # expert 1 overflows its 3 slots
    w = rng.random((T, k)).astype(np.float32)
    mask = rng.random((T, k)) > 0.3 if masked else None
    jd, jc = jm.make_dispatch(jnp.asarray(idx), jnp.asarray(w), E, C,
                              None if mask is None else jnp.asarray(mask))
    td, tc = tm.make_dispatch(_t(idx), _t(w), E, C, None if mask is None else _t(mask))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert td.sum() < T * k  # something was dropped (or masked)


def test_moe_ffn_chunked_equals_unchunked_and_the_jax_op():
    T, D, F, E = 40, 8, 16, 4
    rw, wg, wu, wd = _weights(E, D, F, seed=7)
    x = np.random.default_rng(14).standard_normal((T, D)).astype(np.float32)
    args = [_t(a) for a in (x, rw, wg, wu, wd)]
    whole = tm.moe_ffn(*args, top_k=2, token_chunk=0)
    chunked = tm.moe_ffn(*args, top_k=2, token_chunk=16)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), **OP_TOL)
    want = jm.moe_ffn(*(jnp.asarray(a) for a in (x, rw, wg, wu, wd)), top_k=2, token_chunk=16)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(want), **OP_TOL)
    np.testing.assert_allclose(chunked.numpy(), naive_moe(x, rw, wg, wu, wd, 2), **ORACLE_TOL)


def test_moe_ffn_renormalizes_on_drops_as_jax():
    """tests/test_moe.py:258's routing: expert 0 overflows at token 2, which
    keeps only its expert-2 assignment at weight 1."""
    T, D, F, E = 3, 8, 16, 3
    _, wg, wu, wd = _weights(E, D, F, seed=6)
    rw = np.zeros((D, E), np.float32)
    rw[0, 0], rw[1, 1], rw[1, 2] = 5.0, 1.0, -1.0
    x = np.random.default_rng(13).standard_normal((T, D)).astype(np.float32)
    x[:, 0] = 1.0
    x[:2, 1], x[2, 1] = 1.0, -1.0
    got = tm.moe_ffn(*(_t(a) for a in (x, rw, wg, wu, wd)), top_k=2, capacity=2)
    want = jm.moe_ffn(*(jnp.asarray(a) for a in (x, rw, wg, wu, wd)), top_k=2, capacity=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)
    h = x[2]
    gate, up = h @ wg[2], h @ wu[2]
    expect = (gate / (1 + np.exp(-gate)) * up) @ wd[2]
    np.testing.assert_allclose(got.numpy()[2], expect, atol=1e-3, rtol=1e-3)


# --------------------------------------------------------------- dropless


def _imbalanced(T=96):
    """tests/test_moe.py:238: every token routed to experts 1 and 2 (T > 64,
    where a capacity path would drop)."""
    D, F, E = 8, 16, 4
    _, wg, wu, wd = _weights(E, D, F, seed=5)
    rw = np.zeros((D, E), np.float32)
    rw[:, 1], rw[:, 2] = 5.0, 4.0
    x = np.random.default_rng(12).standard_normal((T, D)).astype(np.float32)
    return x, rw, wg, wu, wd


def test_expert_order_is_the_stable_argsort_and_bincount():
    idx = np.random.default_rng(3).integers(0, 5, 37)
    idx[:9] = 2
    order, pos, offsets = tm.expert_order(_t(idx), 6)
    want = np.argsort(idx, kind="stable")
    np.testing.assert_array_equal(order.numpy(), want)
    np.testing.assert_array_equal(pos.numpy()[want], np.arange(len(idx)))
    assert offsets.dtype == torch.int32
    np.testing.assert_array_equal(offsets.numpy(),
                                  np.concatenate([[0], np.cumsum(np.bincount(idx, minlength=6))]))


def test_grouped_ffn_plain_matches_the_jax_ragged_dot():
    x, rw, wg, wu, wd = _imbalanced()
    rng = np.random.default_rng(4)
    sizes = np.array([0, 50, 0, 46], np.int32)  # empty groups at both ends of a full one
    xs = rng.standard_normal((96, 8)).astype(np.float32)
    want = jm._grouped_ffn(*(jnp.asarray(a) for a in (xs, sizes, wg, wu, wd)))
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), dtype=torch.int32)
    got = tm.grouped_ffn_plain(_t(xs), offsets, _t(wg), _t(wu), _t(wd))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


def test_moe_ffn_dropless_matches_jax_and_the_naive_oracle_under_imbalance():
    x, rw, wg, wu, wd = _imbalanced()
    kernels.reset_launch_counts()
    got = tm.moe_ffn_dropless(*(_t(a) for a in (x, rw, wg, wu, wd)), top_k=2)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)  # CPU: the plain path
    want = jm.moe_ffn_dropless(*(jnp.asarray(a) for a in (x, rw, wg, wu, wd)), top_k=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)
    np.testing.assert_allclose(got.numpy(), naive_moe(x, rw, wg, wu, wd, 2), **ORACLE_TOL)


@pytest.mark.parametrize("T", [1, 5, 64])
def test_moe_ffn_dropless_matches_jax_on_random_routing(T):
    rw, wg, wu, wd = _weights(8, 16, 32, seed=T)
    x = np.random.default_rng(T + 100).standard_normal((T, 16)).astype(np.float32)
    got = tm.moe_ffn_dropless(*(_t(a) for a in (x, rw, wg, wu, wd)), top_k=2)
    want = jm.moe_ffn_dropless(*(jnp.asarray(a) for a in (x, rw, wg, wu, wd)), top_k=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


# ------------------------------------------------------------------ model

VOCAB, BS, NB = 64, 4, 64


@functools.cache
def _models(quantize=False, moe_impl=None):
    jcfg = dataclasses.replace(jmix.tiny_moe(vocab_size=VOCAB), moe_impl=moe_impl)
    jparams = jmix.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32, quantize=quantize)
    tcfg = dataclasses.replace(tmix.tiny_moe(vocab_size=VOCAB), moe_impl=moe_impl)
    return jcfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _logits_both(quantize=False, moe_impl=None):
    """A 10-token prefill, then two decode steps of two lanes (the prompt's
    and a fresh one), through both packages' model functions."""
    jcfg, jparams, tcfg, tparams = _models(quantize, moe_impl)
    shape = (jcfg.num_layers, jcfg.num_kv_heads, NB, BS, jcfg.head_dim)
    jk, jv = jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    rng = np.random.default_rng(1)
    T, P = 10, 12
    tokens = np.zeros(P, np.int32)
    tokens[:T] = rng.integers(0, VOCAB, T)
    table = np.array([3, 5, 9], np.int32)
    jlog, jk, jv = jmix.prefill(jparams, jcfg, jnp.asarray(tokens), jnp.int32(T), jk, jv,
                                jnp.asarray(table))
    tlog = tmix.prefill(tparams, tcfg, _t(tokens).long(), T, tk, tv, _t(table))
    out = [(tlog.numpy(), np.asarray(jlog))]
    bt = np.zeros((2, 8), np.int32)
    bt[0, :3], bt[1, 0] = table, 12
    feed = np.array([int(np.argmax(out[0][1])), 7], np.int32)
    pos = np.array([T, 0], np.int32)
    for _ in range(2):
        slots = np.array([bt[b, pos[b] // BS] * BS + pos[b] % BS for b in range(2)], np.int32)
        jlog, jk, jv = jmix.decode(jparams, jcfg, jnp.asarray(feed), jnp.asarray(pos), jk, jv,
                                   jnp.asarray(bt), jnp.asarray(slots))
        tlog = tmix.decode(tparams, tcfg, _t(feed).long(), _t(pos).long(), tk, tv, _t(bt),
                           _t(slots).long())
        out.append((tlog.numpy(), np.asarray(jlog)))
        feed = np.array(jnp.argmax(jlog, axis=-1), np.int32)
        pos = pos + 1
    return out


@pytest.mark.parametrize("quantize,moe_impl", [(False, None), (False, "gshard"), (True, None)],
                         ids=["dropless", "gshard", "int8_dense"])
def test_tiny_moe_prefill_and_decode_logits_match_mixtral(quantize, moe_impl):
    for got, want in _logits_both(quantize, moe_impl):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_quantized_moe_keeps_its_experts_unquantized():
    *_, tparams = _models(quantize=True)
    layer = tparams["layers"][0]
    assert isinstance(layer["wq"], dict) and layer["wq"]["q"].dtype == torch.int8
    for name in ("router", "wg", "wu", "wd"):
        assert isinstance(layer[name], torch.Tensor) and layer[name].dtype == torch.float32
    p = init_params(tmix.tiny_moe(), seed=0, device="cpu", dtype=torch.bfloat16, quantize=True)
    lay = p["layers"][1]
    assert isinstance(lay["wo"], dict) and lay["wg"].dtype == torch.bfloat16
    E, D, F = 4, 64, 128
    assert lay["router"].shape == (D, E) and lay["wg"].shape == (E, D, F)
    assert lay["wd"].shape == (E, F, D)


def test_init_params_draws_the_experts_at_the_reference_scales():
    cfg = dataclasses.replace(tmix.tiny_moe(), intermediate_size=256)
    p = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    lay = p["layers"][0]
    for name, fan in (("router", 64), ("wg", 64), ("wu", 64), ("wd", 256)):
        assert abs(float(lay[name].std()) - fan ** -0.5) < 0.1 * fan ** -0.5, name
    again = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    assert torch.equal(again["layers"][0]["wd"], lay["wd"])


# ---------------------------------------------------------------- engines

C, MAX_LEN, MAX_BATCH = 8, 64, 4
LONG = [int(t) for t in np.random.default_rng(1).integers(1, VOCAB, 40)]
LONG2 = [int(t) for t in np.random.default_rng(2).integers(1, VOCAB, 30)]


def _dims():
    return dict(num_blocks=NB, block_size=BS, max_batch=MAX_BATCH, max_model_len=MAX_LEN)


def _torch_engine(H=1, spec_k=0):
    *_, tcfg, tparams = _models()
    runner = TorchModelRunner(tcfg, tparams, device="cpu", prefill_chunk_tokens=C, **_dims())
    return TorchEngine(runner, TorchEngineConfig(
        watermark_blocks=2, decode_horizon=H, spec_k=spec_k, **_dims()))


def _jax_engine(H=1, spec_k=0):
    jcfg, jparams, *_ = _models()
    runner = ModelRunner(jcfg, jparams, kv_dtype=jnp.float32, prefill_chunk_tokens=C, **_dims())
    return JaxEngine(runner, JaxEngineConfig(
        watermark_blocks=2, decode_horizon=H, spec_k=spec_k, **_dims()))


def _request(mod, prompt, max_tokens):
    return mod.PreprocessedRequest(
        token_ids=list(prompt), sampling=mod.SamplingOptions(greedy=True),
        stop=mod.StopConditions(max_tokens=max_tokens, ignore_eos=True))


async def _collect(engine, req, ctx, first=None):
    toks = []
    async for out in engine.generate(req, ctx):
        toks.extend(out.token_ids)
        if first is not None and toks:
            first.set()
    return toks


async def _overlapped(engine, mod, ctx):
    """A 40-token prompt is chunked alone, then decodes 16 tokens; meanwhile
    a 30-token prompt is chunked beside it (mixed steps) and two short
    prompts are packed into one prefill. The engine is closed after."""
    try:
        first = asyncio.Event()
        a = asyncio.create_task(_collect(engine, _request(mod, LONG, 16), ctx(), first))
        await asyncio.wait_for(first.wait(), 60)
        rest = [(LONG2, 6), ([1, 2, 3], 8), ([9, 8, 7, 6, 5], 6)]
        outs = await asyncio.gather(*(_collect(engine, _request(mod, p, n), ctx())
                                      for p, n in rest))
        return [await a, *outs]
    finally:
        await engine.close()


async def _together(engine, mod, ctx, reqs):
    try:
        return list(await asyncio.gather(*(_collect(engine, r, ctx()) for r in reqs)))
    finally:
        await engine.close()


async def test_default_engine_streams_the_jax_engines_greedy_tokens():
    want = await _overlapped(_jax_engine(), jp, JaxContext)
    engine = _torch_engine()
    got = await _overlapped(engine, tp, tp.Context)
    assert got == want and [len(t) for t in got] == [16, 6, 8, 6]
    s = engine.stats
    assert s.packed_prefills > 0 and s.chunk_steps > 0 and s.mixed_steps > 0


async def test_horizon_engine_streams_the_jax_engines_greedy_tokens():
    def reqs(mod):
        return [_request(mod, p, n) for p, n in (([5, 9, 17, 23], 13), ([2, 40, 41], 10),
                                                 ([60, 3, 3, 3, 8, 1], 7), (LONG2, 9))]

    want = await _together(_jax_engine(H=4), jp, JaxContext, reqs(jp))
    engine = _torch_engine(H=4)
    got = await _together(engine, tp, tp.Context, reqs(tp))
    assert got == want and [len(t) for t in got] == [13, 10, 7, 9]
    assert engine.stats.horizon_dispatches > 0


async def test_spec_engine_streams_the_jax_engines_greedy_tokens():
    seg = [11, 12, 13, 14, 15, 16]

    def reqs(mod):
        return [_request(mod, seg * 3, 14), _request(mod, [7, 8, 9] * 4, 12),
                _request(mod, [20, 21, 22, 23, 20, 21, 22], 10)]

    want = await _together(_jax_engine(spec_k=3), jp, JaxContext, reqs(jp))
    engine = _torch_engine(spec_k=3)
    got = await _together(engine, tp, tp.Context, reqs(tp))
    assert got == want and [len(t) for t in got] == [14, 12, 10]
    assert engine.stats.verify_steps > 0 and engine.stats.num_accepted_tokens > 0


# ---------------------------------------------------------- tensor parallel


class _Rank:  # what shard_llama reads of a group
    def __init__(self, rank, world_size):
        self.rank, self.world_size = rank, world_size


def test_expert_slices_equal_the_jax_shards_at_tp2():
    jcfg, jparams, tcfg, tparams = _models()
    mesh = build_mesh(tp=2)
    jsharded, _ = jshard_llama(mesh, jcfg, jparams)
    devices = list(mesh.devices.reshape(-1))
    for r in range(2):
        mine = shard_llama(_Rank(r, 2), tcfg, tparams)
        for li, layer in enumerate(jsharded["layers"]):
            for name in ("router", "wg", "wu", "wd"):
                shard = next(s for s in layer[name].addressable_shards if s.device == devices[r])
                np.testing.assert_array_equal(mine["layers"][li][name].numpy(),
                                              np.asarray(shard.data), err_msg=f"{li} {name}")
        assert mine["layers"][0]["wg"].shape == (4, 64, 64)
        assert mine["layers"][0]["wd"].shape == (4, 64, 64)


def _sharded_ffns(group, x, rw, wg, wu, wd):
    """Both MoE paths on this rank's FFN slice of every expert, summed over
    the group."""
    r, n = group.rank, group.world_size
    f = wg.shape[-1] // n
    mine = (wg[:, :, r * f:(r + 1) * f], wu[:, :, r * f:(r + 1) * f], wd[:, r * f:(r + 1) * f])
    args = (x, rw, *(m.contiguous() for m in mine), 2)
    return [tm.moe_ffn_dropless(*args, group=group),
            tm.moe_ffn(*args, token_chunk=16, group=group)]


def test_both_moe_paths_on_expert_slices_sum_to_the_whole_at_tp2():
    """Each rank holds every expert's F / 2 slice: the dropless and the
    GShard (chunked) outputs summed over two gloo ranks equal one rank's."""
    from dynamo_tpu_torch.parallel.launch import run_ranks

    rw, wg, wu, wd = (_t(a) for a in _weights(4, 8, 16, seed=11))
    x = _t(np.random.default_rng(15).standard_normal((40, 8)).astype(np.float32))
    want = [tm.moe_ffn_dropless(x, rw, wg, wu, wd, 2),
            tm.moe_ffn(x, rw, wg, wu, wd, 2, token_chunk=16)]
    ranks = run_ranks(2, _sharded_ffns, [(x, rw, wg, wu, wd)] * 2, timeout_s=120)
    for got in ranks:
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g), w.numpy(), **OP_TOL)


async def test_tp2_engine_streams_the_tp2_jax_engines_greedy_tokens():
    jcfg, jparams, tcfg, tparams = _models()
    mesh = build_mesh(tp=2)
    sp, kv_sharding = jshard_llama(mesh, jcfg, jparams)
    jrunner = ModelRunner(jcfg, sp, kv_dtype=jnp.float32, prefill_chunk_tokens=C, mesh=mesh,
                          kv_sharding=kv_sharding, **_dims())
    want = await _overlapped(JaxEngine(jrunner, JaxEngineConfig(watermark_blocks=2, **_dims())),
                             jp, JaxContext)
    engine = tfactory.build_torch_engine(
        tcfg, device="cpu", params=tparams, dtype=torch.float32, kv_block_size=BS,
        max_batch=MAX_BATCH, num_blocks=NB, max_model_len=MAX_LEN, prefill_chunk_tokens=C,
        tensor_parallel_size=2)
    runner = engine.runner
    got = await _overlapped(engine, tp, tp.Context)
    assert got == want and [len(t) for t in got] == [16, 6, 8, 6]
    assert [p.exitcode for p in runner._processes] == [0]


# ------------------------------------------------------ sizing and refusals


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_param_count_and_default_num_blocks_match_the_jax_factory(monkeypatch, quantized):
    """Mixtral-8x7B under an 80 GiB budget, where the budget decides: the
    experts count at 2 bytes whatever ``quantized`` says."""
    j, t = jmix.mixtral_8x7b(), tmix.mixtral_8x7b()
    assert tl.param_count(t) == jl.param_count(j)
    assert tl.param_count(t) == 46_702_788_608
    monkeypatch.setenv("DYN_HBM_GB", "80")
    half = dataclasses.replace(j, num_layers=16)
    for jc, tc in ((j, t), (half, dataclasses.replace(t, num_layers=16))):
        want = jfactory.default_num_blocks(jc, 32768, 64, block_size=16, quantized=quantized)
        got = tfactory.default_num_blocks(tc, 32768, 64, block_size=16, quantized=quantized,
                                          budget_bytes=80 * 2**30, dtype_bytes=2)
        assert got == want
    assert got < 64 * 32768 // 16  # the cap binds at 16 layers
    # the full depth does not fit one card: 16 blocks, the floor
    assert tfactory.default_num_blocks(t, 32768, 64, budget_bytes=80 * 2**30,
                                       quantized=quantized) == 16


def test_graph_pool_room_comes_out_of_the_block_budget():
    cfg = dataclasses.replace(tmix.mixtral_8x7b(), num_layers=16)
    kw = dict(block_size=16, budget_bytes=80 * 2**30)
    reserve = tfactory.graph_pool_bytes(cfg, 8)
    assert 0 < reserve < 2**30
    assert tfactory.graph_pool_bytes(cfg, 8, spec_k=3) == 4 * reserve
    a = tfactory.default_num_blocks(cfg, 32768, 64, **kw)
    b = tfactory.default_num_blocks(cfg, 32768, 64, reserve_bytes=reserve, **kw)
    block = 2 * 16 * 16 * 8 * 128 * 2
    assert a - b in (reserve // block, reserve // block + 1)


def test_expert_parallelism_raises_not_implemented():
    with pytest.raises(NotImplementedError, match="moe_ffn_shard_map / moe_ffn_ep_a2a"):
        tfactory.build_torch_engine(tmix.tiny_moe(), device="cpu", expert_parallel_size=2)


def test_the_card_refuses_moe_shapes_the_grouped_kernel_does_not_take():
    full = tmix.mixtral_8x7b()
    assert kernels.card_shape_problems(full) == []
    assert kernels.card_shape_problems(full, tp=2) == []
    assert kernels.card_shape_problems(full, fused_decode=True, tp=4) == []
    odd = dataclasses.replace(full, intermediate_size=14336 + 32)
    assert kernels.card_shape_problems(odd) == [
        "grouped MoE FFN: expert FFN width 14368 is not a multiple of 64"]
    f32 = kernels.card_shape_problems(full, dtype=torch.float32)
    assert f32 == ["grouped MoE FFN: dtype torch.float32 is not torch.bfloat16"]
    with pytest.raises(ValueError, match="grouped MoE FFN: expert FFN width 14368"):
        tfactory.build_torch_engine(odd, device="cuda")
    with pytest.raises(ValueError, match="grouped MoE FFN: dtype torch.float32"):
        tfactory.build_torch_engine(full, device="cuda", dtype=torch.float32)
