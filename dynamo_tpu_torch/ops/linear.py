"""Linear layers: ``x @ w`` for bf16 / f32 weights stored ``[in, out]`` or
int8 weight-only quantized ones, and the fused decode-step heads.

Counterpart of dynamo_tpu/ops/linear.py. The plain product is left to
``torch.matmul`` (cuBLAS on the card), as the JAX package leaves it to XLA
outside any kernel. int8 weights are per-output-channel quantized,
``{"q": int8 [in, out], "s": bf16 [out]}`` (``quantize_int8``), and keep
the reference's accumulation contract (linear.py:10-19):

  * float activations x int8 weights: the mantissas are widened to the
    activations' dtype (lossless: |q| <= 127 is exact in bf16), the product
    accumulates in f32, the scale applies in f32, then the cast. On the
    card that is one bf16 x bf16 -> f32 cuBLAS product
    (``torch.mm(..., out_dtype=torch.float32)``) over a bf16 copy of the
    mantissas made per call (2 bytes written and read per weight on top of
    the int8 read: the unfused int8 product moves more bytes than the bf16
    one; a W8A16 kernel is an option, not a debt, since the reference's is
    an XLA op); on the CPU, where that overload does not exist, an f32
    product of the same values;
  * int8 activations x int8 weights: exact integer accumulation (an f64
    product: every partial sum is an integer below 2^53), then the scales.

The fused decode-step heads (``fused_qkv_rope``, ``fused_attn_out_residual``)
collapse a layer's norm -> QKV -> bias -> RoPE and o-proj -> residual into
one hand-written CUDA kernel each (ops/cuda_linear.py), for bf16 weights
and, in their int8 mode, for int8 ones. The dispatch is by where the
tensors are: CUDA tensors launch the kernel (or raise), CPU tensors run the
plain version here, which keeps the reference's op and dtype order
(linear.py ``_finish`` / ``_rope_rotate``): RMSNorm in f32 cast back, the
product accumulated in f32, the per-channel scale in f32, cast, bias, RoPE
in f32, cast.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from dynamo_tpu_torch.ops.basics import rms_norm
from dynamo_tpu_torch.ops.cuda_linear import (
    fused_attn_out_residual_cuda,
    fused_attn_out_residual_int8_cuda,
    fused_qkv_rope_cuda,
    fused_qkv_rope_int8_cuda,
)

Params = Union[torch.Tensor, dict]


def quantize_int8(w: torch.Tensor) -> dict:
    """Per-output-channel symmetric int8 quantization of [in, out] weights
    (dynamo_tpu/ops/linear.py:45-56): scale amax / 127 per output column, 1.0
    for an all-zero column (its mantissas are 0 either way, and the scale
    stays finite), mantissas rounded half to even and clipped at +-127;
    the scale is stored as bf16."""
    wf = w.float()
    amax = wf.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.round(wf / scale).clamp_(-127, 127).to(torch.int8)
    return {"q": q, "s": scale.to(torch.bfloat16)}


def maybe_quantize(w: torch.Tensor, quantize: bool) -> Params:
    return quantize_int8(w) if quantize else w


def _is_int8(w) -> bool:
    if not isinstance(w, dict):
        return False
    if w["q"].dtype != torch.int8:
        raise TypeError(f"int8 weights carry int8 mantissas, got {w['q'].dtype}")
    return True


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with the product accumulated and returned in f32: one
    bf16 x bf16 -> f32 cuBLAS call on the card, an f32 product of the same
    values on the CPU."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        lead = x.shape[:-1]
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*lead, w.shape[-1])
    return torch.matmul(x.float(), w.float())


def linear(x: torch.Tensor, w: Params) -> torch.Tensor:
    """x @ w for float or int8-quantized weights (see the module docstring
    for the accumulation contract)."""
    if not _is_int8(w):
        return torch.matmul(x, w.to(x.dtype))
    s = w["s"].float()
    if not x.dtype.is_floating_point:
        # int8 x int8: exact in f64 (partial sums are integers < 2^53)
        y = torch.matmul(x.double(), w["q"].double()).to(torch.int32)
        return y.float() * s
    return (_mm_f32(x, w["q"].to(x.dtype)) * s).to(x.dtype)


def _parts(w: Params):
    """(weights widened to a float dtype's values, f32 scale | None)."""
    if _is_int8(w):
        return w["q"], w["s"].float()
    return w, None


def _finish(acc: torch.Tensor, scale: Optional[torch.Tensor], bias: Optional[torch.Tensor],
            dtype) -> torch.Tensor:
    """f32 product -> (per-channel scale, f32) -> cast -> bias, in the
    reference's order and dtypes (linear.py ``_finish``)."""
    y = (acc * scale if scale is not None else acc).to(dtype)
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


def _all_or_none_int8(*ws) -> bool:
    kinds = {_is_int8(w) for w in ws}
    if len(kinds) > 1:
        raise TypeError("a fused head takes all of its weights int8 or none of them")
    return kinds.pop()


def fused_qkv_rope(
    x: torch.Tensor,  # [M, hidden] residual stream
    attn_norm: torch.Tensor,  # [hidden]
    wq: Params, wk: Params, wv: Params,
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
    layers without qk-norm. int8 weights launch the kernel's int8 mode."""
    quant = _all_or_none_int8(wq, wk, wv)
    kw = dict(
        eps=eps, num_heads=num_heads, num_kv_heads=num_kv_heads,
        head_dim=head_dim, bq=bq, bk=bk, bv=bv,
    )
    if x.is_cuda:
        fn = fused_qkv_rope_int8_cuda if quant else fused_qkv_rope_cuda
        return fn(x, attn_norm, wq, wk, wv, cos, sin, **kw)
    return fused_qkv_rope_plain(x, attn_norm, wq, wk, wv, cos, sin, **kw)


def fused_qkv_rope_plain(
    x, attn_norm, wq, wk, wv, cos, sin, *, eps, num_heads, num_kv_heads,
    head_dim, bq=None, bk=None, bv=None,
):
    """Plain version of the fused QKV kernel in both modes
    (dynamo_tpu/ops/linear.py ``_fused_qkv_kernel``, op for op)."""
    M = x.shape[0]
    h = rms_norm(x, attn_norm, eps).float()
    outs = []
    for w, b in ((wq, bq), (wk, bk), (wv, bv)):
        m, sc = _parts(w)
        # weights (or mantissas) cast to the activations' dtype first, as
        # ``linear`` does
        outs.append(_finish(torch.matmul(h, m.to(x.dtype).float()), sc, b, x.dtype))
    q, k, v = outs
    cos, sin = cos.float(), sin.float()
    return (
        _rope_rotate(q, cos, sin, num_heads, head_dim, x.dtype),
        _rope_rotate(k, cos, sin, num_kv_heads, head_dim, x.dtype),
        v.reshape(M, num_kv_heads, head_dim),
    )


def fused_attn_out_residual(
    attn: torch.Tensor,  # [M, q_dim] flattened attention output
    wo: Params,
    x: torch.Tensor,  # [M, hidden] residual stream
    *,
    partial_out: bool = False,
) -> torch.Tensor:
    """Attention-output projection + residual add: x + (attn @ wo), what
    ops/layers.attn_out gives for layers without a sandwich norm. int8
    weights launch the kernel's int8 mode."""
    if partial_out:
        raise NotImplementedError(
            "partial_out (the tensor-parallel raw f32 partial) is not ported yet"
        )
    if attn.is_cuda:
        fn = fused_attn_out_residual_int8_cuda if _is_int8(wo) else fused_attn_out_residual_cuda
        return fn(attn, wo, x)
    return fused_attn_out_residual_plain(attn, wo, x)


def fused_attn_out_residual_plain(attn, wo, x) -> torch.Tensor:
    """Plain version of the fused o-proj kernel in both modes
    (dynamo_tpu/ops/linear.py ``_fused_out_kernel``): f32 product, the
    per-channel scale in f32, cast, then ``x + y`` in x's dtype."""
    m, sc = _parts(wo)
    y = _finish(torch.matmul(attn.float(), m.to(attn.dtype).float()), sc, None, x.dtype)
    return x + y
