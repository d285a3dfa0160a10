"""The fused decode heads under tensor parallelism, and the ring tail.

Counterpart of dynamo_tpu/ops/collective.py. There the fused Pallas
programs run per shard under ``shard_map``; here every rank is a process
of its own (parallel/mesh.TPGroup) holding its Megatron slice
(parallel/sharding.py), so each function runs on the rank's tensors and
issues its collectives through the group:

  * ``fused_qkv_rope_meshed`` (:55-132): #4 on the rank's head slice
    (column-parallel projections need no collective);
  * ``fused_attn_out_residual_meshed`` (:135-178): #5's partial_out mode
    gives the rank's raw f32 partial of the row-parallel o-projection, the
    group sums the partials in f32, then the per-channel scale, the cast
    and the residual apply, in that order (where GSPMD puts the unfused
    path's all-reduce);
  * ``fused_tail_overlap`` (:179-340, ``DYN_COLLECTIVE_OVERLAP``): the
    layer's whole post-attention tail with both all-reduces decomposed
    into rings: the o-proj reduce-scatter ring (one partial_out launch per
    column chunk of ``wo``, handed to the kernel as a strided view), the
    RMSNorm on scattered chunks with one scalar-per-row all-reduce, the
    gate/up all-gather ring, the down-proj reduce-scatter ring and the
    final tiled all-gather. The ring order and the f32 summation order are
    the reference's. The JAX package pipelines each hop behind the next
    chunk's product; here a hop is a blocking ``ppermute``, so the
    decomposition runs in the same order without the overlap.

Unlike the reference's gate, which needs tp > 1 for the ring, a one-rank
group runs it too, with zero hops: that is how one card exercises the
NCCL path.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.ops.basics import swiglu
from dynamo_tpu_torch.ops.linear import (
    Params,
    _is_int8,
    _mm_f32,
    fused_attn_out_residual,
    fused_qkv_rope,
)


def _parts(w: Params):
    """(mantissas or weights, f32 scale | None), the reference's
    ``_wq_parts``."""
    if _is_int8(w):
        return w["q"], w["s"].float()
    return w, None


def _finish(acc: torch.Tensor, s: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """f32 sum -> (per-channel scale, f32) -> cast."""
    return (acc * s if s is not None else acc).to(dtype)


def fused_qkv_rope_meshed(
    group,
    x: torch.Tensor,  # [B, hidden] residual stream (replicated)
    attn_norm: torch.Tensor,
    wq: Params, wk: Params, wv: Params,  # the rank's column slices
    cos: torch.Tensor,
    sin: torch.Tensor,
    *,
    eps: float,
    num_heads: int,  # the model's (all ranks') head counts
    num_kv_heads: int,
    head_dim: int,
    bq: Optional[torch.Tensor] = None,
    bk: Optional[torch.Tensor] = None,
    bv: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """#4 on the rank's head slice: (q [B, Hq / tp, D], k, v [B, Hkv / tp,
    D]), the rank's heads of what the one-device head gives."""
    tp = group.world_size
    assert num_heads % tp == 0 and num_kv_heads % tp == 0, (num_heads, num_kv_heads, tp)
    return fused_qkv_rope(
        x, attn_norm, wq, wk, wv, cos, sin, eps=eps, num_heads=num_heads // tp,
        num_kv_heads=num_kv_heads // tp, head_dim=head_dim, bq=bq, bk=bk, bv=bv,
    )


def fused_attn_out_residual_meshed(
    group,
    attn: torch.Tensor,  # [B, q_dim / tp] the rank's heads, flat
    wo: Params,  # the rank's rows [q_dim / tp, hidden]
    x: torch.Tensor,  # [B, hidden] residual stream (replicated)
) -> torch.Tensor:
    """Row-parallel o-projection + residual: the rank's raw f32 partial
    (#5 partial_out), summed over the group in f32, then the scale, the
    cast and the residual add. Returns the replicated [B, hidden]."""
    wo_q, so = _parts(wo)
    partial = fused_attn_out_residual(attn, wo_q, partial_out=True)
    red = group.all_reduce(partial)
    return x + _finish(red, so, x.dtype)


def fused_tail_overlap(
    group,
    attn: torch.Tensor,  # [B, q_dim / tp] the rank's heads, flat
    wo: Params,  # the rank's rows [q_dim / tp, hidden]
    x: torch.Tensor,  # [B, hidden] residual stream (replicated)
    mlp_norm: torch.Tensor,
    wg: Params, wu: Params,  # the rank's columns [hidden, F / tp]
    wd: Params,  # the rank's rows [F / tp, hidden]
    *,
    eps: float,
    mlp_act: str = "silu",
) -> torch.Tensor:
    """The post-attention layer tail -- o-proj + residual + MLP norm +
    gate/up/act/down + residual -- with both all-reduces decomposed into
    rings (see the module docstring). Returns the post-MLP residual
    stream, replicated."""
    tp, d = group.world_size, group.rank
    wo_q, so = _parts(wo)
    wg_q, sg = _parts(wg)
    wu_q, su = _parts(wu)
    wd_q, sd = _parts(wd)
    H = wo_q.shape[1]
    assert H % tp == 0, (H, tp)
    chunk = H // tp
    dtype = x.dtype
    own = slice(d * chunk, (d + 1) * chunk)

    # o-proj ring reduce-scatter: one partial_out launch per column chunk of
    # wo (a strided view, no copy); the running f32 partial moves one rank
    # back after each chunk, so after tp steps this rank holds its own chunk
    # fully reduced
    acc = None
    for k in range(tp):
        c = (d + 1 + k) % tp
        p = fused_attn_out_residual(attn, wo_q[:, c * chunk:(c + 1) * chunk], partial_out=True)
        acc = p if acc is None else acc + p
        if k < tp - 1:
            acc = group.ppermute(acc, shift=-1)
    h_c = x[:, own] + _finish(acc, so[own] if so is not None else None, dtype)

    # RMSNorm on the scattered chunks: the full row's sum of squares by one
    # all-reduce of [B] (ops/basics.rms_norm's f32 arithmetic)
    hf = h_c.float()
    ssq = group.all_reduce((hf * hf).sum(dim=-1))
    inv = torch.rsqrt(ssq / H + eps)
    n_c = (hf * inv[:, None] * mlp_norm[own].float()).to(dtype)

    # gate/up: all-gather the normed chunks around the ring, each chunk in
    # hand multiplied by its rows of wg / wu
    g_acc = u_acc = None
    cur = n_c
    for k in range(tp):
        src = (d - k) % tp
        rows = slice(src * chunk, (src + 1) * chunk)
        pg = _mm_f32(cur, wg_q[rows].to(dtype))
        pu = _mm_f32(cur, wu_q[rows].to(dtype))
        g_acc = pg if g_acc is None else g_acc + pg
        u_acc = pu if u_acc is None else u_acc + pu
        if k < tp - 1:
            cur = group.ppermute(cur, shift=1)
    gate = _finish(g_acc, sg, dtype)
    up = _finish(u_acc, su, dtype)
    if mlp_act == "gelu_tanh":  # Gemma GeGLU (models/llama._mlp)
        act = F.gelu(gate.float(), approximate="tanh").to(gate.dtype) * up
    else:
        act = swiglu(gate, up)

    # down-proj ring reduce-scatter, the o-proj ring's schedule
    acc2 = None
    for k in range(tp):
        c = (d + 1 + k) % tp
        p = _mm_f32(act, wd_q[:, c * chunk:(c + 1) * chunk].to(act.dtype))
        acc2 = p if acc2 is None else acc2 + p
        if k < tp - 1:
            acc2 = group.ppermute(acc2, shift=-1)
    out_c = h_c + _finish(acc2, sd[own] if sd is not None else None, dtype)

    # the final tiled all-gather back to the replicated residual stream
    return group.all_gather(out_c, dim=1)
