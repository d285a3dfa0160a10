"""Linear layers: ``x @ w`` for bf16 / f32 weights stored ``[in, out]``, and
the fused decode-step heads.

Counterpart of dynamo_tpu/ops/linear.py for unquantized weights. The plain
product is left to ``torch.matmul`` (cuBLAS on the card), as the JAX package
leaves it to XLA outside any kernel. int8 weights are not ported yet.

The fused decode-step heads (``fused_qkv_rope``, ``fused_attn_out_residual``)
collapse a layer's norm -> QKV -> bias -> RoPE and o-proj -> residual into
one hand-written CUDA kernel each (ops/cuda_linear.py). The dispatch is by
where the tensors are: CUDA tensors launch the kernel (or raise), CPU
tensors run the plain version here, which keeps the reference's op and
dtype order (linear.py ``_finish`` / ``_rope_rotate``): RMSNorm in f32 cast
back, the product accumulated in f32, cast, bias, RoPE in f32, cast.
"""

from __future__ import annotations

from typing import Optional

import torch

from dynamo_tpu_torch.ops.basics import rms_norm
from dynamo_tpu_torch.ops.cuda_linear import (
    fused_attn_out_residual_cuda,
    fused_qkv_rope_cuda,
)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError("int8-quantized weights are not ported yet")
    return torch.matmul(x, w.to(x.dtype))


def _no_int8(*ws) -> None:
    if any(not isinstance(w, torch.Tensor) for w in ws):
        raise NotImplementedError(
            "int8-quantized weights ({'q', 's'} dicts) are not ported yet"
        )


def _finish(acc: torch.Tensor, bias: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """f32 product -> cast -> bias, in the unfused path's order and dtypes."""
    y = acc.to(dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _rope_rotate(y, cos, sin, heads: int, head_dim: int, dtype) -> torch.Tensor:
    """apply_rope's rotation on a flat [M, heads * head_dim] projection,
    given cos / sin [M, head_dim // 2] (same formula, f32)."""
    yh = y.reshape(y.shape[0], heads, head_dim).float()
    x1, x2 = yh.chunk(2, dim=-1)
    c = cos[:, None, :]
    s = sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dtype)


def fused_qkv_rope(
    x: torch.Tensor,  # [M, hidden] residual stream
    attn_norm: torch.Tensor,  # [hidden]
    wq, wk, wv,
    cos: torch.Tensor,  # [M, head_dim // 2] f32 (positions x inv_freqs)
    sin: torch.Tensor,
    *,
    eps: float,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    bq: Optional[torch.Tensor] = None,
    bk: Optional[torch.Tensor] = None,
    bv: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RMSNorm + QKV projections (+ bias) + RoPE: (q [M, Hq, D],
    k [M, Hkv, D], v [M, Hkv, D]), what ops/layers.qkv_head gives for
    layers without qk-norm."""
    _no_int8(wq, wk, wv)
    kw = dict(
        eps=eps, num_heads=num_heads, num_kv_heads=num_kv_heads,
        head_dim=head_dim, bq=bq, bk=bk, bv=bv,
    )
    if x.is_cuda:
        return fused_qkv_rope_cuda(x, attn_norm, wq, wk, wv, cos, sin, **kw)
    return fused_qkv_rope_plain(x, attn_norm, wq, wk, wv, cos, sin, **kw)


def fused_qkv_rope_plain(
    x, attn_norm, wq, wk, wv, cos, sin, *, eps, num_heads, num_kv_heads,
    head_dim, bq=None, bk=None, bv=None,
):
    """Plain version of the fused QKV kernel (dynamo_tpu/ops/linear.py
    ``_fused_qkv_kernel``, op for op)."""
    M = x.shape[0]
    h = rms_norm(x, attn_norm, eps).float()
    # weights cast to the activations' dtype first, as ``linear`` does
    q, k, v = (
        _finish(torch.matmul(h, w.to(x.dtype).float()), b, x.dtype)
        for w, b in ((wq, bq), (wk, bk), (wv, bv))
    )
    cos, sin = cos.float(), sin.float()
    return (
        _rope_rotate(q, cos, sin, num_heads, head_dim, x.dtype),
        _rope_rotate(k, cos, sin, num_kv_heads, head_dim, x.dtype),
        v.reshape(M, num_kv_heads, head_dim),
    )


def fused_attn_out_residual(
    attn: torch.Tensor,  # [M, q_dim] flattened attention output
    wo,
    x: torch.Tensor,  # [M, hidden] residual stream
    *,
    partial_out: bool = False,
) -> torch.Tensor:
    """Attention-output projection + residual add: x + (attn @ wo), what
    ops/layers.attn_out gives for layers without a sandwich norm."""
    if partial_out:
        raise NotImplementedError(
            "partial_out (the tensor-parallel raw f32 partial) is not ported yet"
        )
    _no_int8(wo)
    if attn.is_cuda:
        return fused_attn_out_residual_cuda(attn, wo, x)
    return fused_attn_out_residual_plain(attn, wo, x)


def fused_attn_out_residual_plain(attn, wo, x) -> torch.Tensor:
    """Plain version of the fused o-proj kernel (dynamo_tpu/ops/linear.py
    ``_fused_out_kernel``): f32 product, cast, then ``x + y`` in x's dtype."""
    y = _finish(torch.matmul(attn.float(), wo.to(attn.dtype).float()), None, x.dtype)
    return x + y
