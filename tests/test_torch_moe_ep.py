"""The port's expert-parallel MoE against the JAX package's, on the CPU.

The JAX side runs ``moe_ffn_shard_map`` / ``moe_ffn_ep_a2a`` and the Mixtral
engine over ``build_mesh(ep=..., tp=...)`` on the suite's 8 host devices, as
tests/test_moe.py does; the port's side runs its ranks as gloo processes on
a grid with an ep axis (``run_ranks(..., axes=...)``, or the factory's own
followers). Everything is f32, so the bars are tests/test_moe.py's own
(atol / rtol 1e-4 against the per-token ``naive_moe`` oracle) and, against
the JAX functions on the same inputs, 1e-5:

* ``shard_llama`` on an ep x tp grid: each rank's expert block equals the
  JAX shard on that rank's device (``P("ep", None, "tp")``), bit for bit;
* the psum form at ep = 4 and ep x tp = 2 x 2, the all-to-all form at ep = 4
  (bounded capacity, and dropless) and at ep x tp = 2 x 2: every rank's
  output equals the JAX op's, and the oracle;
* ``build_torch_engine(expert_parallel_size=2, tensor_parallel_size=2)``
  streams the greedy tokens of a JaxEngine over an ep x tp = 2 x 2 mesh,
  exactly, with chunking off, so every prompt's prefill takes the
  all-to-all form and every decode step the psum form (the reference's
  dispatch rule).
"""

import asyncio
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.jax_engine.engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.engine.jax_engine.model_runner import ModelRunner
from dynamo_tpu.models import mixtral as jmix
from dynamo_tpu.ops import moe as jm
from dynamo_tpu.parallel.mesh import build_mesh
from dynamo_tpu.parallel.sharding import shard_llama as jshard_llama
from dynamo_tpu.pipeline.context import Context as JaxContext
from dynamo_tpu.protocols import common as jp
from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
from dynamo_tpu_torch.engine.torch_engine.weights import params_from_jax
from dynamo_tpu_torch.models import mixtral as tmix
from dynamo_tpu_torch.ops import moe as tm
from dynamo_tpu_torch.parallel.launch import call_each, run_ranks
from dynamo_tpu_torch.parallel.sharding import shard_llama
from dynamo_tpu_torch.protocols import common as tp
from tests.test_moe import naive_moe

OP_TOL = dict(atol=1e-5, rtol=1e-5)
ORACLE_TOL = dict(atol=1e-4, rtol=1e-4)
TIMEOUT_S = 120


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


def _x(T, D, seed):
    return np.random.default_rng(seed).standard_normal((T, D)).astype(np.float32)


def _grid(ep_rank, ep, tp_rank=0, tp=1):
    """What shard_llama reads of a rank of an ep x tp grid."""
    return types.SimpleNamespace(rank=tp_rank, world_size=tp,
                                 ep=types.SimpleNamespace(rank=ep_rank, world_size=ep))


# -------------------------------------------------------------- sharding


@pytest.mark.parametrize("ep,tpn", [(2, 2), (4, 1)], ids=["ep2tp2", "ep4"])
def test_expert_blocks_equal_the_jax_shards_on_an_ep_grid(ep, tpn):
    jcfg = jmix.tiny_moe(vocab_size=64, num_experts=4)
    jparams = jmix.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tcfg = tmix.tiny_moe(vocab_size=64, num_experts=4)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    mesh = build_mesh(ep=ep, tp=tpn)
    jsharded, _ = jshard_llama(mesh, jcfg, jparams)
    devices = list(mesh.devices.reshape(-1))
    for r in range(ep * tpn):
        mine = shard_llama(_grid(r // tpn, ep, r % tpn, tpn), tcfg, tparams)
        for li, layer in enumerate(jsharded["layers"]):
            for name in ("router", "wg", "wu", "wd", "wq", "wo", "attn_norm"):
                shard = next(s for s in layer[name].addressable_shards if s.device == devices[r])
                np.testing.assert_array_equal(mine["layers"][li][name].numpy(),
                                              np.asarray(shard.data), err_msg=f"{r} {li} {name}")
        assert mine["layers"][0]["wg"].shape == (4 // ep, 64, 128 // tpn)


def test_experts_that_do_not_split_over_ep_are_refused():
    with pytest.raises(ValueError, match="num_experts=4 not divisible by ep=3"):
        shard_llama(_grid(0, 3), tmix.tiny_moe(num_experts=4), {"layers": []})


# ------------------------------------------------------------------- ops

# (T, D, F, E[, capacity_factor]) of tests/test_moe.py's ep cases (top_k 2)
PSUM = (12, 8, 16, 8)
A2A = (32, 8, 16, 8, 4.0)
A2A_TP = (16, 8, 16, 4, 4.0)


def _rank_slices(w, ep_rank, ep, tp_rank, tpn):
    rw, wg, wu, wd = w
    e = wg.shape[0] // ep
    f = wg.shape[2] // tpn
    ex = slice(ep_rank * e, (ep_rank + 1) * e)
    fx = slice(tp_rank * f, (tp_rank + 1) * f)
    return (_t(rw), _t(np.ascontiguousarray(wg[ex, :, fx])),
            _t(np.ascontiguousarray(wu[ex, :, fx])), _t(np.ascontiguousarray(wd[ex, fx])))


def _cases(ep, tpn):
    """(name, form, T, D, F, E, capacity_factor) run on an ep x tp grid."""
    if tpn == 1:
        return [("psum", "psum", *PSUM, None), ("a2a", "a2a", *A2A),
                ("a2a_dropless", "a2a", *A2A[:4], None)]
    return [("psum", "psum", *A2A_TP[:4], None), ("a2a", "a2a", *A2A_TP)]


@functools.lru_cache(maxsize=None)
def _port_ops(ep, tpn):
    calls = [[] for _ in range(ep * tpn)]
    for name, form, T, D, F, E, cf in _cases(ep, tpn):
        w = _weights(E, D, F, seed=T + E)
        x = _t(_x(T, D, seed=T))
        for r in range(ep * tpn):
            rw, wg, wu, wd = _rank_slices(w, r // tpn, ep, r % tpn, tpn)
            if form == "psum":
                calls[r].append((tm.moe_ffn_shard_map, (x, rw, wg, wu, wd, 2), {}))
            else:
                calls[r].append((tm.moe_ffn_ep_a2a, (x, rw, wg, wu, wd, 2),
                                 dict(capacity_factor=cf)))
    ranks = run_ranks(ep * tpn, call_each, [(c,) for c in calls], timeout_s=TIMEOUT_S,
                      axes={"ep": ep, "tp": tpn})
    return {case[0]: [ranks[r][i] for r in range(ep * tpn)]
            for i, case in enumerate(_cases(ep, tpn))}


def _jax_op(ep, tpn, form, T, D, F, E, cf):
    mesh = build_mesh(ep=ep, tp=tpn)
    rw, wg, wu, wd = (jnp.asarray(a) for a in _weights(E, D, F, seed=T + E))
    x = jnp.asarray(_x(T, D, seed=T))
    tp_axis = "tp" if tpn > 1 else None
    if form == "psum":
        out = jm.moe_ffn_shard_map(mesh, x, rw, wg, wu, wd, top_k=2, tp_axis=tp_axis)
    else:
        out = jax.jit(lambda x: jm.moe_ffn_ep_a2a(mesh, x, rw, wg, wu, wd, top_k=2,
                                                  capacity_factor=cf, tp_axis=tp_axis))(x)
    return np.asarray(out), naive_moe(x, rw, wg, wu, wd, 2)


@pytest.mark.parametrize("ep,tpn,name", [
    (4, 1, "psum"), (4, 1, "a2a"), (4, 1, "a2a_dropless"), (2, 2, "psum"), (2, 2, "a2a"),
], ids=["ep4-psum", "ep4-a2a", "ep4-a2a_dropless", "ep2tp2-psum", "ep2tp2-a2a"])
def test_expert_parallel_forms_match_the_jax_shard_map(ep, tpn, name):
    case = next(c for c in _cases(ep, tpn) if c[0] == name)
    want, oracle = _jax_op(ep, tpn, *case[1:])
    got = _port_ops(ep, tpn)[name]
    for g in got:  # the replicated stream, the same bits on every rank
        np.testing.assert_array_equal(g, got[0])
    np.testing.assert_allclose(got[0], want, **OP_TOL)
    np.testing.assert_allclose(got[0], oracle, **ORACLE_TOL)


# ---------------------------------------------------------------- engine

VOCAB, BS, NB, MAX_LEN, MAX_BATCH = 64, 4, 64, 64, 4
PROMPTS = [(list(range(2, 30)), 6), ([9, 8, 7, 6, 5, 4], 5), ([3, 1, 4, 1, 5], 4)]


def _request(mod, prompt, n):
    return mod.PreprocessedRequest(
        token_ids=list(prompt), sampling=mod.SamplingOptions(greedy=True),
        stop=mod.StopConditions(max_tokens=n, ignore_eos=True))


async def _serve(engine, mod, ctx):
    async def one(prompt, n):
        toks = []
        async for out in engine.generate(_request(mod, prompt, n), ctx()):
            toks.extend(out.token_ids)
        return toks

    try:
        return list(await asyncio.gather(*(one(p, n) for p, n in PROMPTS)))
    finally:
        await engine.close()


async def test_mixtral_engine_on_an_ep_tp_grid_streams_the_jax_ep_engines_greedy_tokens():
    """ep x tp = 2 x 2 against a JaxEngine over an ep x tp mesh with the same
    weights, chunking off on both (every prefill is one ``prefill`` call of
    a bucket of at least 4 tokens per ep rank: the all-to-all form; every
    decode step of up to 3 lanes: the psum form)."""
    jcfg = jmix.tiny_moe(vocab_size=VOCAB, num_experts=4)
    jparams = jmix.init_params(jcfg, jax.random.PRNGKey(2), jnp.float32)
    tcfg = tmix.tiny_moe(vocab_size=VOCAB, num_experts=4)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    mesh = build_mesh(ep=2, tp=2)
    sp, kv_sharding = jshard_llama(mesh, jcfg, jparams)
    dims = dict(num_blocks=NB, block_size=BS, max_batch=MAX_BATCH, max_model_len=MAX_LEN)
    jrunner = ModelRunner(jcfg, sp, kv_dtype=jnp.float32, prefill_chunk_tokens=0, mesh=mesh,
                          kv_sharding=kv_sharding, **dims)
    want = await _serve(JaxEngine(jrunner, JaxEngineConfig(**dims)), jp, JaxContext)
    engine = build_torch_engine(
        tcfg, device="cpu", params=tparams, dtype=torch.float32, kv_block_size=BS,
        max_batch=MAX_BATCH, num_blocks=NB, max_model_len=MAX_LEN, prefill_chunk_tokens=0,
        expert_parallel_size=2, tensor_parallel_size=2)
    runner = engine.runner
    assert runner.group.axes == {"dp": 1, "pp": 1, "sp": 1, "ep": 2, "tp": 2}
    assert runner.params["layers"][0]["wg"].shape == (2, 64, 64)
    got = await _serve(engine, tp, tp.Context)
    assert got == want and [len(t) for t in got] == [6, 5, 4]
    assert [p.exitcode for p in runner._processes] == [0, 0, 0]
    assert len(runner.final_stats) == 4
