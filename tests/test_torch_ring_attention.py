"""Ring attention and the context-parallel prefill against the JAX
package's, on the CPU.

The JAX side runs ``ring_prefill_attention`` / ``prefill_context_parallel``
over an ``sp`` (and ``tp``) mesh of the suite's host devices, as
tests/test_ring_attention.py does; the port's side runs gloo ranks on a
grid with an sp axis (``run_ranks(..., axes=...)``), the K/V chunks
rotating through ``AxisGroup.ppermute``. Inputs come from numpy seeds, in
f32, at tests/test_ring_attention.py's shapes and tolerances:

* the ring at sp = 2 and 4 over valid lengths 64, 41 and 8 (2e-5 against
  the JAX ring and the serial XLA oracle), with the heads split over tp at
  sp x tp = 2 x 2, and with sliding windows, a score scale and the Gemma-2
  soft-cap (3e-5);
* ``prefill_context_parallel`` of a Mistral-style tiny model (every layer
  slides) with the paged cache written per layer: logits within 2e-4 and
  every rank's cache within 2e-5 of the serial prefill (tp x sp = 2 x 2: the
  rank's heads); the cacheless form's [L, P, Hkv, D] K/V equal the JAX
  form's;
* the Mixtral family takes the same CP prefill (tiny_moe at sp = 2 against
  the serial JAX prefill, 2e-4);
* ``build_torch_engine(context_parallel_size=4)`` streams the serial
  JaxEngine's greedy tokens, and its long prompt's prefill (bucket 512,
  the runner's ``cp_min_tokens``) took the ring.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dynamo_tpu.engine.jax_engine.engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.engine.jax_engine.model_runner import ModelRunner
from dynamo_tpu.models import llama as jl
from dynamo_tpu.ops.attention import causal_prefill_attention
from dynamo_tpu.parallel.ring_attention import ring_prefill_attention as jring
from dynamo_tpu.pipeline.context import Context as JaxContext
from dynamo_tpu.protocols import common as jp
from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
from dynamo_tpu_torch.engine.torch_engine.weights import params_from_jax
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.parallel.launch import call_each, run_ranks
from dynamo_tpu_torch.parallel.ring_attention import ring_prefill_attention
from dynamo_tpu_torch.parallel.sharding import shard_leaf
from dynamo_tpu_torch.protocols import common as tp

TIMEOUT_S = 120


def _mesh(shape: dict) -> Mesh:
    devs = np.array(jax.devices()[: int(np.prod(list(shape.values())))])
    return Mesh(devs.reshape(tuple(shape.values())), tuple(shape.keys()))


def _qkv(seed, Pn, hq, hkv, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((Pn, hq, D), (Pn, hkv, D), (Pn, hkv, D)))


# (name, seed, valid, features) of the sp-only cases: the valid-length grid,
# then the sliding-window grid of tests/test_ring_attention.py at valid 64
# and 41
FEATURES = {"w8": dict(window=8), "w40": dict(window=40), "w1": dict(window=1),
            "w16_scale_softcap": dict(window=16, scale=0.4, logit_softcap=20.0)}
CASES = ([(f"valid{v}", 0, v, {}) for v in (64, 41, 8)]
         + [(f"{f}_valid{v}", 3, v, kw) for f, kw in FEATURES.items() for v in (64, 41)])


def _ring_calls(sp):
    calls = []
    for _, seed, valid, kw in CASES:
        q, k, v = (torch.from_numpy(a) for a in _qkv(seed, 64, 8, 2, 32))
        calls.append((ring_prefill_attention, (q, k, v, valid), kw))
    return calls


@functools.lru_cache(maxsize=None)
def _port_rings(sp):
    ranks = run_ranks(sp, call_each, [(_ring_calls(sp),)] * sp, timeout_s=TIMEOUT_S,
                      axes={"sp": sp})
    return {c[0]: [r[i] for r in ranks] for i, c in enumerate(CASES)}


@pytest.mark.parametrize("name", [c[0] for c in CASES])
@pytest.mark.parametrize("sp", [2, 4])
def test_ring_matches_the_jax_ring_and_the_oracle(sp, name):
    _, seed, valid, kw = next(c for c in CASES if c[0] == name)
    q, k, v = (jnp.asarray(a) for a in _qkv(seed, 64, 8, 2, 32))
    vl = jnp.int32(valid)
    oracle = causal_prefill_attention(q, k, v, vl, impl="xla", **kw)
    want = jring(_mesh({"sp": sp}), q, k, v, vl, **kw)
    got = _port_rings(sp)[name]
    for g in got:  # the all-gathered result, the same bits on every rank
        np.testing.assert_array_equal(g, got[0])
    tol = 3e-5 if kw else 2e-5
    np.testing.assert_allclose(got[0][:valid], np.asarray(want)[:valid], atol=tol, rtol=tol)
    np.testing.assert_allclose(got[0][:valid], np.asarray(oracle)[:valid], atol=tol, rtol=tol)
    assert not got[0][valid:].any()  # padding rows are zeros


def test_ring_with_tp_split_heads():
    q, k, v = _qkv(1, 32, 8, 4, 16)
    mesh = _mesh({"sp": 2, "tp": 2})
    spec = NamedSharding(mesh, P("sp", "tp", None))
    jq, jk, jv = (jax.device_put(jnp.asarray(a), spec) for a in (q, k, v))
    want = jring(mesh, jq, jk, jv, jnp.int32(30), head_axis="tp")
    oracle = causal_prefill_attention(*(jnp.asarray(a) for a in (q, k, v)), jnp.int32(30))
    args = (*(torch.from_numpy(a) for a in (q, k, v)), 30)
    got = run_ranks(4, call_each, [([(ring_prefill_attention, args, dict(head_axis="tp"))],)] * 4,
                    timeout_s=TIMEOUT_S, axes={"sp": 2, "tp": 2})
    for g in got:
        np.testing.assert_array_equal(g[0], got[0][0])
    np.testing.assert_allclose(got[0][0][:30], np.asarray(want)[:30], atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got[0][0][:30], np.asarray(oracle)[:30], atol=2e-5, rtol=2e-5)


# ------------------------------------------------------- the CP prefill

BS, NBLK, PL = 8, 12, 32


@functools.lru_cache(maxsize=None)
def _sliding_models():
    import dataclasses

    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=64), sliding_window=8,
                               num_kv_heads=4)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(4), jnp.float32)
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=64), sliding_window=8,
                               num_kv_heads=4)
    return jcfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _rank_cp(group, cfg, full, valid):
    """The CP prefill on this rank's tp slice, with the cache and without."""
    tpn = group.world_size
    params = {k: shard_leaf(k, v, group.rank, tpn) for k, v in full.items() if k != "layers"}
    params["layers"] = [{k: shard_leaf(k, v, group.rank, tpn) for k, v in layer.items()}
                        for layer in full["layers"]]
    shape = (cfg.num_layers, cfg.num_kv_heads // tpn, NBLK, BS, cfg.head_dim)
    kc, vc = torch.zeros(shape), torch.zeros(shape)
    tokens = torch.arange(PL) % cfg.vocab_size
    table = torch.arange(1, 1 + PL // BS)
    logits = tl.prefill_context_parallel(params, cfg, group, tokens, valid, k_cache=kc,
                                         v_cache=vc, block_table=table)
    logits2, k_new, v_new = tl.prefill_context_parallel(params, cfg, group, tokens, valid)
    return logits, kc, vc, logits2, k_new, v_new


@functools.lru_cache(maxsize=None)
def _port_cp(sp, tpn, valid):
    *_, tcfg, tparams = _sliding_models()
    return run_ranks(sp * tpn, _rank_cp, [(tcfg, tparams, valid)] * (sp * tpn),
                     timeout_s=TIMEOUT_S, axes={"sp": sp, "tp": tpn})


@pytest.mark.parametrize("sp,tpn,valid", [(2, 1, PL), (2, 2, 27)], ids=["sp2", "sp2tp2_valid27"])
def test_context_parallel_prefill_matches_the_serial_prefill(sp, tpn, valid):
    jcfg, jparams, *_ = _sliding_models()
    cache_shape = (jcfg.num_layers, jcfg.num_kv_heads, NBLK, BS, jcfg.head_dim)
    tokens = jnp.arange(PL, dtype=jnp.int32) % jcfg.vocab_size
    table = jnp.arange(1, 1 + PL // BS, dtype=jnp.int32)
    kc, vc = jnp.zeros(cache_shape), jnp.zeros(cache_shape)
    ref_logits, ref_kc, ref_vc = jl.prefill(jparams, jcfg, tokens, jnp.int32(valid), kc, vc,
                                            table)
    _, j_k, j_v = jl.prefill_context_parallel(jparams, jcfg, _mesh({"sp": sp}), tokens,
                                              jnp.int32(valid))
    hk = jcfg.num_kv_heads // tpn

    def tokens_of(cache):  # the prompt's blocks 1-4 as [L, P, H, D], valid positions only
        c = np.asarray(cache)[:, :, 1:5]
        return c.transpose(0, 2, 3, 1, 4).reshape(c.shape[0], PL, c.shape[1], -1)[:, :valid]

    for r, (logits, kc_r, vc_r, logits2, k_new, v_new) in enumerate(_port_cp(sp, tpn, valid)):
        heads = slice((r % tpn) * hk, (r % tpn + 1) * hk)
        np.testing.assert_allclose(logits, np.asarray(ref_logits), atol=2e-4, rtol=2e-4)
        np.testing.assert_array_equal(logits2, logits)
        # every rank holds its heads of the whole prompt (padding rows are
        # unspecified: the ring zeroes their attention, the serial path not)
        np.testing.assert_allclose(tokens_of(kc_r), tokens_of(ref_kc)[:, :, heads],
                                   atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(tokens_of(vc_r), tokens_of(ref_vc)[:, :, heads],
                                   atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(k_new[:, :valid], np.asarray(j_k)[:, :valid, heads],
                                   atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(v_new[:, :valid], np.asarray(j_v)[:, :valid, heads],
                                   atol=2e-5, rtol=2e-5)


# --------------------------------------------------------------- engine


LONG_PROMPT = [2 + i % 126 for i in range(300)]


async def _serve(engine, mod, ctx):
    async def one(prompt, n):
        req = mod.PreprocessedRequest(
            token_ids=list(prompt), sampling=mod.SamplingOptions(greedy=True),
            stop=mod.StopConditions(max_tokens=n, ignore_eos=True))
        toks = []
        async for out in engine.generate(req, ctx()):
            toks.extend(out.token_ids)
        return toks

    try:
        return [await one(LONG_PROMPT, 8), await one([5, 9, 2, 7], 6)]
    finally:
        await engine.close()


async def test_engine_on_an_sp_grid_streams_the_serial_engines_greedy_tokens(monkeypatch):
    """sp = 4, chunking off so the 300-token prompt (bucket 512) is one
    ``prefill`` call: it takes the ring (the runner's ``cp_min_tokens``,
    512), the 4-token one (bucket 16) the serial path; decode steps run
    replicated over sp."""
    jcfg = jl.LlamaConfig.tiny(vocab_size=128)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(5), jnp.float32)
    dims = dict(num_blocks=64, block_size=16, max_batch=4, max_model_len=640)
    jrunner = ModelRunner(jcfg, jparams, kv_dtype=jnp.float32, prefill_chunk_tokens=0, **dims)
    want = await _serve(JaxEngine(jrunner, JaxEngineConfig(**dims)), jp, JaxContext)
    rings = []
    cp = tl.prefill_context_parallel

    def counted(*a, **kw):
        rings.append(a[3].shape[0])  # the bucket
        return cp(*a, **kw)

    monkeypatch.setattr(tl, "prefill_context_parallel", counted)
    engine = build_torch_engine(
        tl.LlamaConfig.tiny(vocab_size=128), device="cpu",
        params=params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"),
        dtype=torch.float32, kv_block_size=16, max_batch=4, num_blocks=64, max_model_len=640,
        prefill_chunk_tokens=0, context_parallel_size=4)
    runner = engine.runner
    assert runner.group.sp.world_size == 4
    assert runner.uses_cp_prefill(512) and not runner.uses_cp_prefill(256)
    got = await _serve(engine, tp, tp.Context)
    assert got == want and [len(t) for t in got] == [8, 6]
    assert rings == [512]  # the leader's ring prefill; the short prompt ran serially
    assert [p.exitcode for p in runner._processes] == [0, 0, 0]


def _rank_moe_cp(group, cfg, params):
    from dynamo_tpu_torch.models import mixtral as tmix

    shape = (cfg.num_layers, cfg.num_kv_heads, NBLK, BS, cfg.head_dim)
    kc, vc = torch.zeros(shape), torch.zeros(shape)
    tokens = torch.arange(PL) % cfg.vocab_size
    return tmix.prefill_context_parallel(params, cfg, group, tokens, 29, k_cache=kc, v_cache=vc,
                                         block_table=torch.arange(1, 1 + PL // BS))


def test_mixtral_takes_the_context_parallel_prefill():
    """The MoE family rides the same ring (reference models/mixtral.py:21):
    tiny_moe's CP prefill at sp = 2 (each chunk's tokens through the
    dropless experts) equals the serial JAX prefill's logits (2e-4)."""
    from dynamo_tpu.models import mixtral as jmix
    from dynamo_tpu_torch.models import mixtral as tmix

    jcfg = jmix.tiny_moe(vocab_size=64, num_experts=4)
    jparams = jmix.init_params(jcfg, jax.random.PRNGKey(6), jnp.float32)
    shape = (jcfg.num_layers, jcfg.num_kv_heads, NBLK, BS, jcfg.head_dim)
    tokens = jnp.arange(PL, dtype=jnp.int32) % jcfg.vocab_size
    want, _, _ = jmix.prefill(jparams, jcfg, tokens, jnp.int32(29), jnp.zeros(shape),
                              jnp.zeros(shape), jnp.arange(1, 1 + PL // BS, dtype=jnp.int32))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    got = run_ranks(2, _rank_moe_cp, [(tmix.tiny_moe(vocab_size=64, num_experts=4), tparams)] * 2,
                    timeout_s=TIMEOUT_S, axes={"sp": 2})
    for g in got:
        np.testing.assert_allclose(g, np.asarray(want), atol=2e-4, rtol=2e-4)
