"""The port's pipeline-parallel forward against the JAX package's, on the
CPU.

The JAX side runs ``prefill_pp`` / ``decode_pp`` over a ``pp`` mesh of the
suite's host devices and the serial ``prefill`` / ``decode``, as
tests/test_pipeline_parallel.py does, at its shapes; the port's side runs
each stage as a gloo rank on a grid with a pp axis, holding its slice of
``stack_layer_params`` (carried over from the JAX init with
``params_from_jax``) and its layers' cache. In f32, at the reference test's
tolerance (rtol / atol 2e-3 against the serial forward) and 1e-5 against
the JAX pipelined functions:

* a prompt's ``prefill_pp`` logits and every stage's cache pages, then one
  ``decode_pp`` step of four lanes (two microbatches at pp = 2, four of one
  lane at pp = 4), with the cache written by the step;
* int8 weight-only stacks, and Qwen2 attention biases (non-zero, so they
  must be applied);
* ``stack_layer_params`` refuses MoE layers and keeps int8 leaves' {"q",
  "s"} with a leading layer axis; ``_check_pp_supported`` refuses Gemma's
  and sliding-window configs.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as L
from dynamo_tpu.parallel.mesh import build_mesh
from dynamo_tpu.parallel import pipeline as jpp
from dynamo_tpu_torch.engine.torch_engine.weights import init_params, params_from_jax
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models import mixtral as tmix
from dynamo_tpu_torch.parallel.launch import call_each, run_ranks
from dynamo_tpu_torch.parallel.pipeline import (
    _check_pp_supported,
    decode_pp,
    prefill_pp,
    shard_stacked_pp,
    stack_layer_params,
)

BS, NB, TIMEOUT_S = 4, 16, 120
SERIAL_TOL = dict(rtol=2e-3, atol=2e-3)
PP_TOL = dict(rtol=1e-5, atol=1e-5)
VARIANTS = {"f32": {}, "int8": dict(quantize=True), "qwen2_bias": dict(attn_bias=True)}


@functools.lru_cache(maxsize=None)
def _models(quantize=False, attn_bias=False):
    kw = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=4, num_heads=4,
              num_kv_heads=2, head_dim=8, rope_theta=10000.0, max_position_embeddings=64,
              attn_bias=attn_bias)
    jcfg = L.LlamaConfig(**kw)
    params = L.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32, quantize=quantize)
    if attn_bias:  # zero biases carry no signal
        key = jax.random.PRNGKey(7)
        for lyr in params["layers"]:
            for b in ("bq", "bk", "bv"):
                key, sub = jax.random.split(key)
                lyr[b] = 0.1 * jax.random.normal(sub, lyr[b].shape, jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, tl.LlamaConfig(**kw), tparams


PROMPT = list(range(2, 10))  # 8 tokens = 2 blocks (blocks 1, 2)
TOKS_B, SLOTS = [5, 9, 11, 3], [12, 13, 14, 15]  # four lanes on that context, block 3


def _step_arrays(mod):
    B = len(TOKS_B)
    return (mod.asarray(np.array(TOKS_B)), mod.asarray(np.full(B, len(PROMPT))),
            mod.asarray(np.tile(np.array([1, 2, 3]), (B, 1))), mod.asarray(np.array(SLOTS)))


def _stage(group, tcfg, tparams):
    """prefill_pp then one decode_pp step on this stage's layers."""
    stacked = shard_stacked_pp(group, stack_layer_params(tparams))
    n = tcfg.num_layers // group.pp.world_size
    shape = (n, tcfg.num_kv_heads, NB, BS, tcfg.head_dim)
    kc, vc = torch.zeros(shape), torch.zeros(shape)
    pl = prefill_pp(stacked, tcfg, group, torch.tensor(PROMPT), len(PROMPT), kc, vc,
                    torch.tensor([1, 2]))
    kp = kc.clone()
    toks, pos, bt, slots = (torch.from_numpy(np.asarray(a)).long() for a in _step_arrays(np))
    ld = decode_pp(stacked, tcfg, group, toks, pos, kc, vc, bt, slots)
    return pl, kp, ld, kc


@functools.lru_cache(maxsize=None)
def _port(pp):
    names = sorted(VARIANTS) if pp == 2 else ["f32"]
    calls = [(_stage, _models(**VARIANTS[n])[2:], {}) for n in names]
    ranks = run_ranks(pp, call_each, [(calls,)] * pp, timeout_s=TIMEOUT_S, axes={"pp": pp})
    return {n: [r[i] for r in ranks] for i, n in enumerate(names)}


def _jax(pp, name):
    jcfg, params, *_ = _models(**VARIANTS[name])
    mesh = build_mesh(pp=pp)
    stacked, kv_sharding = jpp.shard_stacked_pp(mesh, jpp.stack_layer_params(params))
    shape = (jcfg.num_layers, jcfg.num_kv_heads, NB, BS, jcfg.head_dim)
    tokens, table = jnp.asarray(np.array(PROMPT, np.int32)), jnp.array([1, 2], jnp.int32)
    k, v = jnp.zeros(shape), jnp.zeros(shape)
    s_pl, k, v = L.prefill(params, jcfg, tokens, jnp.int32(len(PROMPT)), k, v, table)
    s_kp = k
    step = [a.astype(jnp.int32) for a in _step_arrays(jnp)]
    s_ld, s_kd, _ = L.decode(params, jcfg, step[0], step[1], k, v, step[2], step[3])
    k = jax.device_put(jnp.zeros(shape), kv_sharding)
    v = jax.device_put(jnp.zeros(shape), kv_sharding)
    p_pl, k, v = jpp.prefill_pp(stacked, jcfg, mesh, tokens, jnp.int32(len(PROMPT)), k, v, table)
    p_ld, _, _ = jpp.decode_pp(stacked, jcfg, mesh, *step[:2], k, v, *step[2:])
    return [np.asarray(a) for a in (s_pl, s_kp, s_ld, s_kd, p_pl, p_ld)]


@pytest.mark.parametrize("pp,name", [(2, "f32"), (2, "int8"), (2, "qwen2_bias"), (4, "f32")],
                         ids=["pp2", "pp2-int8", "pp2-qwen2_bias", "pp4"])
def test_prefill_pp_and_decode_pp_match_the_jax_pipeline_and_the_serial_forward(pp, name):
    s_pl, s_kp, s_ld, s_kd, p_pl, p_ld = _jax(pp, name)
    stages = _port(pp)[name]
    for pl, kp, ld, kd in stages:  # the logits are summed over pp: every stage has them
        np.testing.assert_array_equal(pl, stages[0][0])
        np.testing.assert_array_equal(ld, stages[0][2])
    pl, ld = stages[0][0], stages[0][2]
    np.testing.assert_allclose(pl, p_pl, **PP_TOL)
    np.testing.assert_allclose(ld, p_ld, **PP_TOL)
    np.testing.assert_allclose(pl, s_pl, **SERIAL_TOL)
    np.testing.assert_allclose(ld, s_ld, **SERIAL_TOL)
    # every stage wrote its own layers' pages: stacked, the serial caches
    np.testing.assert_allclose(np.concatenate([s[1] for s in stages]), s_kp, **SERIAL_TOL)
    np.testing.assert_allclose(np.concatenate([s[3] for s in stages]), s_kd, **SERIAL_TOL)


def test_stack_rejects_moe_and_keeps_int8_leaves():
    with pytest.raises(NotImplementedError, match="expert parallelism"):
        stack_layer_params(init_params(tmix.tiny_moe(num_experts=4), seed=0, device="cpu",
                                       dtype=torch.float32))
    cfg = tl.LlamaConfig.tiny(vocab_size=64)
    q = stack_layer_params(init_params(cfg, seed=0, device="cpu", dtype=torch.float32,
                                       quantize=True))
    assert q["layers"]["wq"]["q"].shape[0] == cfg.num_layers
    assert q["layers"]["wq"]["s"].shape[0] == cfg.num_layers
    assert q["layers"]["wq"]["q"].dtype == torch.int8


@pytest.mark.parametrize("over", [dict(mlp_act="gelu_tanh"), dict(sliding_window=4)],
                         ids=["gemma_geglu", "sliding_window"])
def test_the_pipeline_refuses_what_it_does_not_implement(over):
    with pytest.raises(NotImplementedError):
        _check_pp_supported(dataclasses.replace(tl.LlamaConfig.tiny(), **over))
