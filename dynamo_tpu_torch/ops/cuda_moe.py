"""Wrapper of the port's hand-written CUDA grouped SwiGLU FFN, the dropless
MoE layer's expert products.

Counterpart of ``_grouped_ffn`` in dynamo_tpu/ops/moe.py (three
``lax.ragged_dot`` grouped products: an XLA op upstream, not a Pallas
kernel), rewritten for Hopper in ``csrc/grouped_swiglu_ffn.cu``, which says
what bounds it on the card and how its design answers that. The kernel
reads the group offsets on the card, so nothing is read back to the host
and the decode graphs capture it; a block whose expert has no rows returns
before reading any weight, so only the routed experts' weights are read.

As the other wrappers (ops/cuda_attention.py), it checks device, dtype,
shape, contiguity and alignment, allocates its output and the [R, F]
activation scratch with ``torch.empty``, launches on the current stream
without synchronising or reading any tensor on the host, raises if a launch
is refused, and counts one in ``grouped_swiglu_ffn_cuda.launches`` per call
whose two launches (gate/up, then down) both succeeded; R = 0 launches
nothing and counts nothing. The plain version, ``grouped_ffn_plain``, lives
in ops/moe.py.
"""

from __future__ import annotations

import ctypes

import torch

from dynamo_tpu_torch.ops.cuda_attention import _check, _device_ok, _fn, _raise_on

_P = ctypes.c_void_p
_I = ctypes.c_int

_ARGTYPES = [_P] * 7 + [_I] * 4 + [_P]
GROUPED_TILE = 64  # D and F: whole 64-column tiles and 64-deep contraction slices


def grouped_ffn_shape_problems(hidden: int, ffn: int, dtype=torch.bfloat16) -> list[str]:
    """Why the grouped FFN kernel refuses experts of this shape (empty: it
    takes them): bf16 weights, hidden size and (per-rank) FFN width on its
    64-wide tile grid."""
    out = []
    if dtype != torch.bfloat16:
        out.append(f"dtype {dtype} is not torch.bfloat16")
    for name, n in (("hidden size", hidden), ("expert FFN width", ffn)):
        if n <= 0 or n % GROUPED_TILE:
            out.append(f"{name} {n} is not a multiple of {GROUPED_TILE}")
    return out


def grouped_swiglu_ffn_cuda(
    xs: torch.Tensor,  # [R, D] bf16, rows sorted by expert
    offsets: torch.Tensor,  # [E + 1] int32 on the card: expert e owns rows [offsets[e], offsets[e + 1])
    wg: torch.Tensor,  # [E, D, F] bf16
    wu: torch.Tensor,  # [E, D, F] bf16
    wd: torch.Tensor,  # [E, F, D] bf16
) -> torch.Tensor:
    """The grouped SwiGLU FFN on the card: for each row of expert e,
    bf16(act @ wd[e]) with act = bf16(bf16(silu(bf16(x @ wg[e]))) *
    bf16(x @ wu[e])); returns [R, D] bf16. Rows past ``offsets[E]`` are
    left unwritten (the dropless dispatch covers every row)."""
    _device_ok(xs)
    dev = xs.device
    _check(xs, "xs", torch.bfloat16, 2, dev)
    _check(offsets, "offsets", torch.int32, 1, dev)
    for name, w in (("wg", wg), ("wu", wu), ("wd", wd)):
        _check(w, name, torch.bfloat16, 3, dev)
    R, D = xs.shape
    E, _, F = wg.shape
    for name, w, want in (("wg", wg, (E, D, F)), ("wu", wu, (E, D, F)), ("wd", wd, (E, F, D))):
        if tuple(w.shape) != want:
            raise ValueError(f"{name} is {tuple(w.shape)}, expected {want}")
    if tuple(offsets.shape) != (E + 1,):
        raise ValueError(f"offsets is {tuple(offsets.shape)}, expected {(E + 1,)}")
    problems = grouped_ffn_shape_problems(D, F)
    if problems:
        raise ValueError("; ".join(problems))
    out = torch.empty(R, D, dtype=xs.dtype, device=dev)
    if R == 0:
        return out
    act = torch.empty(R, F, dtype=xs.dtype, device=dev)
    lib = "grouped_swiglu_ffn"
    fn = _fn(lib, "grouped_swiglu_ffn_bf16", _ARGTYPES)
    err = fn(xs.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(), offsets.data_ptr(),
             act.data_ptr(), out.data_ptr(), R, E, D, F,
             torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib)
    grouped_swiglu_ffn_cuda.launches += 1
    return out


grouped_swiglu_ffn_cuda.launches = 0
