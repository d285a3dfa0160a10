"""Wrappers of the port's hand-written CUDA fused decode-step kernels.

Counterpart of the two Pallas programs of dynamo_tpu/ops/linear.py,
rewritten for Hopper in ``dynamo_tpu_torch/csrc/`` (each source says what
bounds it on the card and how its design answers that):

  * ``fused_qkv_rope_cuda`` <- ``fused_qkv_rope`` (csrc/fused_qkv_rope.cu):
    RMSNorm -> Q/K/V products -> bias -> RoPE;
  * ``fused_attn_out_residual_cuda`` <- ``fused_attn_out_residual``
    (csrc/fused_attn_out_residual.cu): o-projection -> residual add;
  * ``fused_qkv_rope_int8_cuda`` / ``fused_attn_out_residual_int8_cuda``
    <- the same two programs' int8 mode (weights ``{"q": int8 [in, out],
    "s": bf16 [out]}``, the per-channel scale applied before the cast):
    the kernels' int8 instantiations, the second entry point of the same
    two sources;
  * ``fused_attn_out_partial_cuda`` / ``fused_attn_out_partial_int8_cuda``
    <- ``fused_attn_out_residual(partial_out=True)``, the tensor-parallel
    path's raw f32 partial product of the rank's o-projection shard (bf16
    weights, or int8 mantissas widened and never scaled); its weight may be
    a column slice of a wider matrix (the ring tail's chunk of ``wo``),
    whose row stride the kernel takes as it is: no copy per ring step.

Both cut the contraction into splits so enough blocks stream the weights,
and sum the splits inside one launch (a thread block cluster), so neither
needs scratch: each wrapper allocates only its outputs. As in
ops/cuda_attention.py, each wrapper checks device, dtype, shape,
contiguity and alignment, launches one kernel on the current stream without
synchronising or reading any tensor on the host, raises if the launch is
refused, and counts its launches in ``<wrapper>.launches`` right after a
launch succeeds (M = 0 launches nothing and counts nothing). The plain
PyTorch versions live in ops/linear.py.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dynamo_tpu_torch.ops.cuda_attention import _check, _device_ok, _fn, _raise_on

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

_QKV_ARGTYPES = [_P] * 13 + [_I] * 5 + [_F, _P]
_OUT_ARGTYPES = [_P] * 4 + [_I] * 3 + [_P]
# the int8 modes: the weights' scales after the weights
_QKV_INT8_ARGTYPES = [_P] * 16 + [_I] * 5 + [_F, _P]
_OUT_INT8_ARGTYPES = [_P] * 5 + [_I] * 3 + [_P]
# the partial_out mode: attn, w, out, then M, K, N and w's row stride
_PARTIAL_ARGTYPES = [_P] * 3 + [_I] * 4 + [_P]
GEMM_COLS = 128  # output widths: whole 128-column tiles (kCols of #4, H of #5)
GEMM_KC = 32  # the o-projection's contraction: a multiple of this


def qkv_shape_problems(hidden: int, hq: int, hkv: int, d: int) -> list[str]:
    """Why the fused QKV kernel refuses heads of this shape (empty: it
    takes it): a column tile owns both halves of each RoPE pair, so D is 64
    (two heads a tile) or a multiple of 128."""
    out = []
    if hidden % 8:
        out.append(f"hidden size {hidden} is not a multiple of 8")
    if d % 2 or not (d == 64 or d % 128 == 0):
        out.append(f"head_dim {d} is neither 64 nor a multiple of 128")
    for name, n in (("Hq * head_dim", hq * d), ("Hkv * head_dim", hkv * d)):
        if n % GEMM_COLS:
            out.append(f"{name} = {n} is not a multiple of {GEMM_COLS}")
    return out


def out_proj_shape_problems(k: int, hidden: int) -> list[str]:
    """Why the fused o-proj kernel refuses an [k, hidden] projection
    (empty: it takes it)."""
    out = []
    if k % GEMM_KC:
        out.append(f"attention width {k} is not a multiple of {GEMM_KC}")
    if hidden % GEMM_COLS:
        out.append(f"hidden size {hidden} is not a multiple of {GEMM_COLS}")
    return out


def _weights(ws, int8: bool, dev, H: int, widths) -> list:
    """The weights' pointers (int8 mode: then their scales'), checked."""
    ptrs, scales = [], []
    for (name, w), n in zip(ws, widths):
        if int8:
            if not isinstance(w, dict):
                raise TypeError(f"{name}: the int8 mode takes {{'q', 's'}} weights")
            m, sc = w["q"], w["s"]
            _check(m, f"{name}['q']", torch.int8, 2, dev)
            _check(sc, f"{name}['s']", torch.bfloat16, 1, dev)
            if tuple(sc.shape) != (n,):
                raise ValueError(f"{name}['s'] is {tuple(sc.shape)}, expected {(n,)}")
            scales.append(sc.data_ptr())
        else:
            m = w
            _check(m, name, torch.bfloat16, 2, dev)
        if tuple(m.shape) != (H, n):
            raise ValueError(f"{name} is {tuple(m.shape)}, expected {(H, n)}")
        ptrs.append(m.data_ptr())
    return ptrs + scales


def _fused_qkv(counted, x, attn_norm, wq, wk, wv, cos, sin, eps, num_heads, num_kv_heads,
               head_dim, bq, bk, bv, int8: bool):
    """One launch of #4 in its bf16 or int8 mode, counted on ``counted``."""
    _device_ok(x)
    M, H = x.shape
    q_dim, kv_dim = num_heads * head_dim, num_kv_heads * head_dim
    dev = x.device
    _check(x, "x", torch.bfloat16, 2, dev)
    _check(attn_norm, "attn_norm", torch.bfloat16, 1, dev)
    weights = _weights((("wq", wq), ("wk", wk), ("wv", wv)), int8, dev, H,
                       (q_dim, kv_dim, kv_dim))
    for name, t in (("cos", cos), ("sin", sin)):
        _check(t, name, torch.float32, 2, dev)
        if tuple(t.shape) != (M, head_dim // 2):
            raise ValueError(f"{name} is {tuple(t.shape)}, expected {(M, head_dim // 2)}")
    biases = (bq, bk, bv)
    if any(b is not None for b in biases):
        if any(b is None for b in biases):
            raise ValueError("bq, bk and bv come together")
        for name, b, n in (("bq", bq, q_dim), ("bk", bk, kv_dim), ("bv", bv, kv_dim)):
            _check(b, name, torch.bfloat16, 1, dev)
            if b.shape[0] != n:
                raise ValueError(f"{name} has {b.shape[0]} entries, expected {n}")
    if tuple(attn_norm.shape) != (H,):
        raise ValueError(f"attn_norm is {tuple(attn_norm.shape)}, expected {(H,)}")
    problems = qkv_shape_problems(H, num_heads, num_kv_heads, head_dim)
    if problems:
        raise ValueError("; ".join(problems))
    # one launch; the outputs are the only allocations
    q = torch.empty(M, num_heads, head_dim, dtype=x.dtype, device=dev)
    k = torch.empty(M, num_kv_heads, head_dim, dtype=x.dtype, device=dev)
    v = torch.empty_like(k)
    if M == 0:
        return q, k, v
    lib = "fused_qkv_rope"
    fn = _fn(lib, "fused_qkv_rope_int8" if int8 else "fused_qkv_rope_bf16",
             _QKV_INT8_ARGTYPES if int8 else _QKV_ARGTYPES)
    err = fn(
        x.data_ptr(), attn_norm.data_ptr(), *weights,
        *(b.data_ptr() if b is not None else None for b in biases),
        cos.data_ptr(), sin.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        M, H, num_heads, num_kv_heads, head_dim, float(eps),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, lib)
    counted.launches += 1
    return q, k, v


def fused_qkv_rope_cuda(
    x: torch.Tensor,  # [M, H] bf16 residual stream
    attn_norm: torch.Tensor,  # [H] bf16
    wq: torch.Tensor,  # [H, Hq * D] bf16
    wk: torch.Tensor,  # [H, Hkv * D] bf16
    wv: torch.Tensor,
    cos: torch.Tensor,  # [M, D // 2] f32
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
    """RMSNorm + Q/K/V products (+ bias) + RoPE on the card; returns
    (q [M, Hq, D], k [M, Hkv, D], v [M, Hkv, D]) bf16."""
    return _fused_qkv(fused_qkv_rope_cuda, x, attn_norm, wq, wk, wv, cos, sin, eps, num_heads,
                      num_kv_heads, head_dim, bq, bk, bv, int8=False)


fused_qkv_rope_cuda.launches = 0


def fused_qkv_rope_int8_cuda(
    x: torch.Tensor,  # [M, H] bf16 residual stream
    attn_norm: torch.Tensor,  # [H] bf16
    wq: dict,  # {"q": int8 [H, Hq * D], "s": bf16 [Hq * D]}
    wk: dict,  # {"q": int8 [H, Hkv * D], "s": bf16 [Hkv * D]}
    wv: dict,
    cos: torch.Tensor,  # [M, D // 2] f32
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
    """#4's int8 mode: int8 weight tiles widened on the card, each output
    channel's scale applied to the f32 product before the cast."""
    return _fused_qkv(fused_qkv_rope_int8_cuda, x, attn_norm, wq, wk, wv, cos, sin, eps,
                      num_heads, num_kv_heads, head_dim, bq, bk, bv, int8=True)


fused_qkv_rope_int8_cuda.launches = 0


def _fused_out(counted, attn, wo, x, int8: bool) -> torch.Tensor:
    """One launch of #5 in its bf16 or int8 mode, counted on ``counted``."""
    _device_ok(attn)
    M, K = attn.shape
    dev = attn.device
    _check(attn, "attn", torch.bfloat16, 2, dev)
    _check(x, "x", torch.bfloat16, 2, dev)
    H = x.shape[1]
    if tuple(x.shape) != (M, H):
        raise ValueError(f"x is {tuple(x.shape)}, expected {(M, H)}")
    weights = _weights((("wo", wo),), int8, dev, K, (H,))
    problems = out_proj_shape_problems(K, H)
    if problems:
        raise ValueError("; ".join(problems))
    out = torch.empty_like(x)
    if M == 0:
        return out
    lib = "fused_attn_out_residual"
    fn = _fn(lib, "fused_attn_out_residual_int8" if int8 else "fused_attn_out_residual_bf16",
             _OUT_INT8_ARGTYPES if int8 else _OUT_ARGTYPES)
    err = fn(
        attn.data_ptr(), *weights, x.data_ptr(), out.data_ptr(),
        M, K, H, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, lib)
    counted.launches += 1
    return out


def fused_attn_out_residual_cuda(
    attn: torch.Tensor,  # [M, q_dim] bf16 flattened attention output
    wo: torch.Tensor,  # [q_dim, H] bf16
    x: torch.Tensor,  # [M, H] bf16 residual stream
) -> torch.Tensor:
    """o-projection + residual add on the card: x + bf16(attn @ wo)."""
    return _fused_out(fused_attn_out_residual_cuda, attn, wo, x, int8=False)


fused_attn_out_residual_cuda.launches = 0


def fused_attn_out_residual_int8_cuda(
    attn: torch.Tensor,  # [M, q_dim] bf16 flattened attention output
    wo: dict,  # {"q": int8 [q_dim, H], "s": bf16 [H]}
    x: torch.Tensor,  # [M, H] bf16 residual stream
) -> torch.Tensor:
    """#5's int8 mode on the card: x + bf16((attn @ q) * s)."""
    return _fused_out(fused_attn_out_residual_int8_cuda, attn, wo, x, int8=True)


fused_attn_out_residual_int8_cuda.launches = 0


def _fused_partial(counted, attn, w, int8: bool) -> torch.Tensor:
    """One launch of #5's partial_out mode, counted on ``counted``: the f32
    product attn @ w of an [M, K] bf16 attn and a [K, N] weight whose rows
    may lie ``w.stride(0)`` elements apart (a column slice)."""
    _device_ok(attn)
    M, K = attn.shape
    dev = attn.device
    _check(attn, "attn", torch.bfloat16, 2, dev)
    dtype = torch.int8 if int8 else torch.bfloat16
    if w.device != dev:
        raise ValueError(f"w is on {w.device}, expected {dev}")
    if w.dtype != dtype:
        raise TypeError(f"w must be {dtype}, got {w.dtype}")
    if w.dim() != 2 or w.shape[0] != K:
        raise ValueError(f"w is {tuple(w.shape)}, expected ({K}, N)")
    N, ldw = w.shape[1], w.stride(0)
    # TMA: the base and the row pitch 16-byte aligned, the columns contiguous
    if w.stride(1) != 1 or ldw < N or (ldw * w.element_size()) % 16 or w.data_ptr() % 16:
        raise ValueError(
            f"w must have contiguous columns and 16-byte aligned rows (strides {w.stride()})")
    problems = out_proj_shape_problems(K, N)
    if problems:
        raise ValueError("; ".join(problems))
    out = torch.empty(M, N, dtype=torch.float32, device=dev)
    if M == 0:
        return out
    lib = "fused_attn_out_residual"
    fn = _fn(lib, "fused_attn_out_partial_int8" if int8 else "fused_attn_out_partial_bf16",
             _PARTIAL_ARGTYPES)
    err = fn(attn.data_ptr(), w.data_ptr(), out.data_ptr(), M, K, N, ldw,
             torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib)
    counted.launches += 1
    return out


def fused_attn_out_partial_cuda(
    attn: torch.Tensor,  # [M, K] bf16 flattened attention output (the rank's heads)
    w: torch.Tensor,  # [K, N] bf16, rows w.stride(0) elements apart
) -> torch.Tensor:
    """#5's partial_out mode on the card: the raw f32 product attn @ w
    ([M, N] f32), no scale, no cast, no residual."""
    return _fused_partial(fused_attn_out_partial_cuda, attn, w, int8=False)


fused_attn_out_partial_cuda.launches = 0


def fused_attn_out_partial_int8_cuda(
    attn: torch.Tensor,  # [M, K] bf16 flattened attention output (the rank's heads)
    w: torch.Tensor,  # [K, N] int8 mantissas, rows w.stride(0) elements apart
) -> torch.Tensor:
    """#5's partial_out mode over int8 mantissas: widened exactly to bf16,
    not scaled (the caller applies the channel scale after the ranks'
    partials are summed); returns attn @ w as [M, N] f32."""
    return _fused_partial(fused_attn_out_partial_int8_cuda, attn, w, int8=True)


fused_attn_out_partial_int8_cuda.launches = 0
