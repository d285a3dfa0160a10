"""The port's tensor-parallel fused decode heads against the JAX package,
on the CPU.

* #5's ``partial_out`` mode: the plain version the card's kernel is held to
  (``fused_attn_out_partial_plain``, reached through
  ``fused_attn_out_residual(partial_out=True)`` on CPU tensors) equals the
  JAX Pallas program in interpret mode, for float weights and int8
  mantissas (as a raw int8 array, and as an int8 leaf whose scale the mode
  ignores), over the whole ``wo`` and over one column chunk of it (a
  strided view on the port's side, the reference's ``dynamic_slice``):
  atol / rtol 1e-5 (f32 products, only the summation order differs).
* ops/collective.py's ``fused_qkv_rope_meshed``,
  ``fused_attn_out_residual_meshed`` and ``fused_tail_overlap``, each rank
  a gloo process on the CPU holding its Megatron slice
  (parallel/sharding.shard_leaf), against the JAX functions under
  ``shard_map`` on a tp-device mesh of the host devices (the reference's
  ``shard_llama`` placement, ``interpret=True``), at tp = 2 and 4, float and
  int8 weights: f32 inputs made with numpy, atol / rtol 1e-5 (the f32 sums
  run in another order: gloo's all-reduce, not XLA's psum). The replicated
  outputs are bit-identical on every rank.
* the gates: the ring tail needs a group, the fused heads and splittable
  widths; a one-rank group runs the ring with zero hops and equals the
  plain meshed path.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jl
from dynamo_tpu.ops import collective as jcol
from dynamo_tpu.ops import linear as jlin
from dynamo_tpu.parallel.mesh import build_mesh
from dynamo_tpu.parallel.sharding import shard_llama as jshard_llama
from dynamo_tpu_torch.engine.torch_engine.weights import params_from_jax
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.ops import collective as tcol
from dynamo_tpu_torch.ops import linear as tlin
from dynamo_tpu_torch.parallel.launch import call_each, run_ranks
from dynamo_tpu_torch.parallel.sharding import shard_leaf

TOL = dict(atol=1e-5, rtol=1e-5)
B, H, HQ, HKV, D, F, EPS = 3, 64, 8, 4, 16, 128, 1e-5
QD, KVD = HQ * D, HKV * D
TIMEOUT_S = 120


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree(a):
    return params_from_jax(jax.tree.map(np.asarray, a), device="cpu")


# ------------------------------------------------------------- partial_out


def _partial_inputs(seed):
    rng = np.random.default_rng(seed)
    attn = rng.standard_normal((5, QD)).astype(np.float32)
    wo = (rng.standard_normal((QD, H)) / np.sqrt(QD)).astype(np.float32)
    return attn, wo


CHUNKS = {"whole": None, "chunk0": 0, "chunk1": 1}


@pytest.mark.parametrize("chunk", sorted(CHUNKS))
@pytest.mark.parametrize("form", ["float", "int8_mantissas", "int8_leaf"])
def test_partial_out_plain_matches_pallas_interpret(form, chunk):
    attn, wo = _partial_inputs(seed=len(form) + 7 * len(chunk))
    w = wo if form == "float" else jax.tree.map(np.asarray, jlin.quantize_int8(jnp.asarray(wo)))
    jw = w if form != "int8_mantissas" else w["q"]
    c = CHUNKS[chunk]
    n = H // 2
    if c is not None:  # the ring's column chunk c of 2
        if isinstance(jw, dict):
            jw = {"q": jax.lax.dynamic_slice_in_dim(jnp.asarray(jw["q"]), c * n, n, 1), "s": jw["s"]}
        else:
            jw = jax.lax.dynamic_slice_in_dim(jnp.asarray(jw), c * n, n, 1)
    want = np.asarray(jlin.fused_attn_out_residual(
        jnp.asarray(attn), jw, partial_out=True, interpret=True))
    tw = _tree(w if form != "int8_mantissas" else w["q"])
    if c is not None:
        if isinstance(tw, dict):
            tw = {"q": tw["q"][:, c * n:(c + 1) * n], "s": tw["s"]}
        else:
            tw = tw[:, c * n:(c + 1) * n]
        assert not (tw["q"] if isinstance(tw, dict) else tw).is_contiguous()
    got = tlin.fused_attn_out_residual(_t(attn), tw, partial_out=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_partial_out_refuses_a_residual_and_ignores_the_scale():
    attn, wo = _partial_inputs(seed=3)
    w8 = tlin.quantize_int8(_t(wo))
    with pytest.raises(ValueError, match="no residual"):
        tlin.fused_attn_out_residual(_t(attn), w8, _t(attn[:, :H]), partial_out=True)
    got = tlin.fused_attn_out_residual(_t(attn), w8, partial_out=True)
    np.testing.assert_array_equal(got.numpy(), (_t(attn) @ w8["q"].float()).numpy())


# --------------------------------------------------------- the meshed heads


def _cfg():
    return dataclasses.replace(
        jl.LlamaConfig.tiny(), hidden_size=H, num_heads=HQ, num_kv_heads=HKV, head_dim=D,
        intermediate_size=F, num_layers=1)


@functools.lru_cache(maxsize=None)
def _layer(quant: bool):
    """One layer's weights (numpy f32, or int8 leaves of the JAX quantizer)
    and the step's activations, from a numpy seed."""
    rng = np.random.default_rng(11 + quant)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q = (lambda w: jax.tree.map(np.asarray, jlin.quantize_int8(jnp.asarray(w)))) if quant else (
        lambda w: w)
    layer = {
        "attn_norm": 1.0 + 0.1 * f(H), "mlp_norm": 1.0 + 0.1 * f(H),
        "wq": q(f(H, QD) / np.sqrt(H)), "wk": q(f(H, KVD) / np.sqrt(H)),
        "wv": q(f(H, KVD) / np.sqrt(H)), "wo": q(f(QD, H) / np.sqrt(QD)),
        "wg": q(f(H, F) / np.sqrt(H)), "wu": q(f(H, F) / np.sqrt(H)),
        "wd": q(f(F, H) / np.sqrt(F)),
    }
    positions = rng.integers(0, 200, B)
    inv = 1.0 / (10000.0 ** (np.arange(0, D, 2, dtype=np.float32) / D))
    angles = (positions[:, None] * inv[None, :]).astype(np.float32)
    acts = {"x": f(B, H), "attn": f(B, QD), "cos": np.cos(angles), "sin": np.sin(angles)}
    return layer, acts


OPS = ("qkv", "out", "tail")


@functools.lru_cache(maxsize=None)
def _jax_results(tp: int, quant: bool):
    layer, a = _layer(quant)
    cfg = _cfg()
    mesh = build_mesh(tp=tp)
    params = {"embed": np.zeros((cfg.vocab_size, H), np.float32), "final_norm": np.ones(H, np.float32),
              "layers": [layer]}
    sl = jshard_llama(mesh, cfg, jax.tree.map(jnp.asarray, params))[0]["layers"][0]
    x, attn = jnp.asarray(a["x"]), jnp.asarray(a["attn"])
    q, k, v = jcol.fused_qkv_rope_meshed(
        mesh, x, sl["attn_norm"], sl["wq"], sl["wk"], sl["wv"], jnp.asarray(a["cos"]),
        jnp.asarray(a["sin"]), eps=EPS, num_heads=HQ, num_kv_heads=HKV, head_dim=D,
        interpret=True)
    out = jcol.fused_attn_out_residual_meshed(mesh, attn, sl["wo"], x, interpret=True)
    tail = jcol.fused_tail_overlap(mesh, attn, sl["wo"], x, sl["mlp_norm"], sl["wg"], sl["wu"],
                                   sl["wd"], eps=EPS, interpret=True)
    return {"qkv": tuple(np.asarray(t) for t in (q, k, v)), "out": np.asarray(out),
            "tail": np.asarray(tail)}


@functools.lru_cache(maxsize=None)
def _port_results(tp: int) -> dict:
    """Every op in both weight forms, all on one group of tp gloo ranks."""
    calls = [[] for _ in range(tp)]
    keys = []
    for quant in (False, True):
        layer, a = _layer(quant)
        t = {k: _tree(v) for k, v in layer.items()}
        x, attn, cos, sin = (_t(a[k]) for k in ("x", "attn", "cos", "sin"))
        for r in range(tp):
            s = {k: shard_leaf(k, v, r, tp) for k, v in t.items()}
            attn_r = attn[:, r * QD // tp:(r + 1) * QD // tp].contiguous()
            calls[r] += [
                (tcol.fused_qkv_rope_meshed, (x, s["attn_norm"], s["wq"], s["wk"], s["wv"], cos, sin),
                 dict(eps=EPS, num_heads=HQ, num_kv_heads=HKV, head_dim=D)),
                (tcol.fused_attn_out_residual_meshed, (attn_r, s["wo"], x), {}),
                (tcol.fused_tail_overlap, (attn_r, s["wo"], x, s["mlp_norm"], s["wg"], s["wu"],
                                           s["wd"]), dict(eps=EPS)),
            ]
        keys += [(op, quant) for op in OPS]
    ranks = run_ranks(tp, call_each, [(c,) for c in calls], timeout_s=TIMEOUT_S)
    return {key: [ranks[r][i] for r in range(tp)] for i, key in enumerate(keys)}


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("tp", [2, 4])
def test_meshed_op_matches_the_jax_shard_map(tp, op, quant):
    want = _jax_results(tp, quant)[op]
    got = _port_results(tp)[(op, quant)]
    if op == "qkv":  # each rank holds its heads
        for i in range(3):
            np.testing.assert_allclose(np.concatenate([g[i] for g in got], axis=1), want[i], **TOL)
        return
    for g in got:  # the replicated stream, the same bits on every rank
        np.testing.assert_array_equal(g, got[0])
    np.testing.assert_allclose(got[0], want, **TOL)


def test_one_rank_group_runs_the_ring_with_zero_hops():
    """A one-rank group (how one card exercises NCCL) runs the ring tail:
    no hop, and the result equals the plain meshed o-proj followed by the
    unfused MLP."""
    layer, a = _layer(False)
    t = {k: _tree(v) for k, v in layer.items()}
    x, attn = _t(a["x"]), _t(a["attn"])
    (tail, out), = run_ranks(1, call_each, [([
        (tcol.fused_tail_overlap, (attn, t["wo"], x, t["mlp_norm"], t["wg"], t["wu"], t["wd"]),
         dict(eps=EPS)),
        (tcol.fused_attn_out_residual_meshed, (attn, t["wo"], x), {}),
    ],)], timeout_s=TIMEOUT_S)
    cfg = tl.LlamaConfig(hidden_size=H, num_heads=HQ, num_kv_heads=HKV, head_dim=D,
                         intermediate_size=F, rms_eps=EPS)
    want = tl._mlp(torch.from_numpy(out), t, cfg).numpy()
    np.testing.assert_allclose(tail, want, **TOL)


class _Group:  # what the gates read of a group
    def __init__(self, tp):
        self.world_size = tp


def test_overlap_gate_needs_a_group_the_fused_heads_and_ring_chunks():
    cfg = tl.LlamaConfig.tiny()  # hidden 64, ffn 128, 4 / 2 heads
    on = dataclasses.replace(cfg, fused_decode=True, collective_overlap=True)
    layer = {"attn_norm": None}
    assert not tl._use_overlap_tail(on, layer, None)
    assert tl._use_overlap_tail(on, layer, _Group(1))  # zero hops, unlike the reference
    assert tl._use_overlap_tail(on, layer, _Group(2))
    assert not tl._use_overlap_tail(dataclasses.replace(on, collective_overlap=False), layer,
                                    _Group(2))
    assert not tl._use_overlap_tail(dataclasses.replace(on, fused_decode=False), layer, _Group(2))
    assert not tl._use_overlap_tail(on, {"post_mlp_norm": None}, _Group(2))
    assert not tl._use_overlap_tail(on, layer, _Group(4))  # 2 kv heads do not split in 4
    assert tl._use_fused_decode(on, layer, _Group(2))
    assert not tl._use_fused_decode(on, {"q_norm": None}, _Group(2))
