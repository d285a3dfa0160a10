"""Wrappers of the port's hand-written CUDA attention kernels.

Counterpart of dynamo_tpu/ops/pallas_attention.py: the three TPU attention
kernels of the serving path, rewritten for Hopper in
``dynamo_tpu_torch/csrc/`` (each source says what bounds it on the card and
how its design answers that):

  * ``paged_decode_attention_cuda`` <- ``paged_decode_attention_pallas``
    (csrc/paged_decode_attention.cu, over csrc/paged_attention.cuh);
  * ``flash_prefill_attention_cuda`` <- ``flash_prefill_attention_pallas``
    (csrc/flash_prefill_attention.cu);
  * ``paged_verify_attention_cuda`` <- ``paged_verify_attention_pallas``
    (csrc/paged_verify_attention.cu, the same template);
  * ``paged_decode_attention_int8_cuda`` / ``paged_verify_attention_int8_cuda``
    <- the same two Pallas kernels' int8 mode (``quantized=True``: int8
    pages and per-(head, page) f32 scale planes), the template's int8
    instantiation, the second entry point of the same two sources.

Each wrapper checks device, dtype, shape, contiguity and alignment, allocates
its output with ``torch.empty`` (the paged kernels also their f32 split
partials; their int32 tickets are cached per device), launches one kernel on
the current stream without synchronising or reading any tensor on the host,
and raises if the launch is refused. It counts its launches in
a plain integer attribute, ``<wrapper>.launches`` (ops/kernels.py resets and
reads them all), raised right after the launch succeeds (a call with nothing
to compute launches nothing and counts nothing), so a run can show that the
serving path went through the kernel. There is no fallback: a failed build or
launch raises. The plain PyTorch versions live in ops/attention.py.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from dynamo_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

_DECODE_ARGTYPES = [_P] * 9 + [_I] * 8 + [_F, _F, _I, _P]
_PREFILL_ARGTYPES = [_P] * 4 + [_I] * 5 + [_F, _F, _I, _P]
_VERIFY_ARGTYPES = [_P] * 9 + [_I] * 9 + [_F, _F, _I, _P]
# the int8 modes: two more pointers (the scale planes) after the caches
_DECODE_INT8_ARGTYPES = [_P] * 11 + [_I] * 8 + [_F, _F, _I, _P]
_VERIFY_INT8_ARGTYPES = [_P] * 11 + [_I] * 9 + [_F, _F, _I, _P]
# head dims every attention kernel is instantiated for; any GQA group
# G = Hq / Hkv, up to PREFILL_MAX_GROUP for prefill (its 128-row query tile
# holds floor(128 / G) positions)
HEAD_DIMS = (64, 128, 256)
PREFILL_MAX_GROUP = 128
# The decode and verify kernels share csrc/paged_attention.cuh: query rows in
# tiles of PAGED_ROWS (kRows), each (pair, tile) cut into splits whose count
# the library picks from the shapes and the SM count (paged::num_splits).
PAGED_ROWS = 16

# int32 split tickets per device, shared by the decode and verify kernels:
# zero between calls (each kernel resets the counters it used), so they are
# allocated once and grown, never cleared per call. Calls on one device must
# run in stream order (the engine uses one stream). A buffer that is grown
# past stays allocated: a captured CUDA graph keeps launching on the
# buffer it was captured with (engine/torch_engine/graphs.py), so none is
# ever freed, and none is grown inside a capture (``reserve_tickets``
# sizes it before).
_tickets: dict[int, torch.Tensor] = {}
_outgrown: list[torch.Tensor] = []


def reserve_tickets(dev: torch.device, n: int) -> torch.Tensor:
    """The device's ticket buffer, at least ``n`` long."""
    t = _tickets.get(dev.index)
    if t is None or t.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"the split-ticket buffer would grow to {n} inside a CUDA graph capture; "
                "reserve_tickets must size it before")
        if t is not None:
            _outgrown.append(t)
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=dev)
        _tickets[dev.index] = t
    return t



def _partials(n_part: int, d: int, dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 split partials of n_part (pair, tile, split) slots: the
    unnormalised [PAGED_ROWS, D] accumulator and the (max, sum) of each row."""
    acc = torch.empty(n_part * PAGED_ROWS * d, dtype=torch.float32, device=dev)
    ml = torch.empty(n_part * PAGED_ROWS * 2, dtype=torch.float32, device=dev)
    return acc, ml


def _fn(lib_name: str, sym: str, argtypes):
    fn = getattr(_build.load(lib_name), sym)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _device_ok(t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError("the CUDA kernels take CUDA tensors only")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(
            f"tensors on {t.device} but the current device is "
            f"cuda:{torch.cuda.current_device()}"
        )


def attention_shape_problems(hq: int, hkv: int, d: int, prefill: bool = True) -> list[str]:
    """Why the attention kernels refuse heads of this shape (empty: they
    take it). Decode and verify take any group; prefill up to
    PREFILL_MAX_GROUP."""
    out = []
    if hkv <= 0 or hq <= 0 or hq % hkv:
        out.append(f"Hq / Hkv = {hq} / {hkv} is not a whole GQA group")
    elif prefill and hq // hkv > PREFILL_MAX_GROUP:
        out.append(f"GQA group {hq // hkv} exceeds the prefill kernel's {PREFILL_MAX_GROUP}")
    if d not in HEAD_DIMS:
        out.append(f"head_dim {d} is not one of {HEAD_DIMS}")
    return out


def _common(q: torch.Tensor, hq: int, hkv: int, d: int, prefill: bool = False) -> None:
    _device_ok(q)
    problems = attention_shape_problems(hq, hkv, d, prefill)
    if problems:
        raise ValueError("; ".join(problems))


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def _check_pages(q, k_cache, v_cache, k_scales, v_scales, dev) -> None:
    """The caches (bf16, or int8 with [Hkv, num_blocks] f32 scale planes)."""
    dtype = torch.bfloat16 if k_scales is None else torch.int8
    _check(k_cache, "k_cache", dtype, 4, dev)
    _check(v_cache, "v_cache", dtype, 4, dev)
    D = q.shape[-1]
    if k_cache.shape[-1] != D or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"cache shapes {tuple(k_cache.shape)}/{tuple(v_cache.shape)} "
            f"do not match q {tuple(q.shape)}"
        )
    if k_scales is not None:
        for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
            _check(t, name, torch.float32, 2, dev)
            if tuple(t.shape) != tuple(k_cache.shape[:2]):
                raise ValueError(
                    f"{name} is {tuple(t.shape)}, expected {tuple(k_cache.shape[:2])}")


def _paged_decode(counted, q, k_cache, v_cache, block_tables, context_lens, k_scales,
                  v_scales, window, scale, logit_softcap) -> torch.Tensor:
    """One launch of #1 in its bf16 mode (no scales) or its int8 mode,
    counted on ``counted`` (the public wrapper of that mode)."""
    B, Hq, D = q.shape
    Hkv, num_blocks, block_size, _ = k_cache.shape
    _common(q, Hq, Hkv, D)
    dev = q.device
    _check(q, "q", torch.bfloat16, 3, dev)
    _check_pages(q, k_cache, v_cache, k_scales, v_scales, dev)
    _check(block_tables, "block_tables", torch.int32, 2, dev)
    _check(context_lens, "context_lens", torch.int32, 1, dev)
    if block_tables.shape[0] != B or context_lens.shape[0] != B:
        raise ValueError("block_tables / context_lens batch does not match q")
    out = torch.empty_like(q)
    if B == 0:
        return out
    # one launch: the splits' f32 partials of every (sequence, kv head,
    # 16-row tile of the group), and a ticket per (sequence, kv head, tile)
    # that tells the last split to merge them
    lib = "paged_decode_attention"
    max_blocks = block_tables.shape[1]
    tiles = -(-(Hq // Hkv) // PAGED_ROWS)
    splits = _fn(lib, "paged_decode_num_splits", [_I] * 5)(
        B, Hq, Hkv, max_blocks, block_size)
    part_acc, part_ml = _partials(B * Hkv * tiles * splits, D, dev)
    tickets = reserve_tickets(dev, B * Hkv * tiles)
    sc = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    caches = [k_cache.data_ptr(), v_cache.data_ptr()]
    if k_scales is None:
        fn = _fn(lib, "paged_decode_attention_bf16", _DECODE_ARGTYPES)
    else:
        fn = _fn(lib, "paged_decode_attention_int8", _DECODE_INT8_ARGTYPES)
        caches += [k_scales.data_ptr(), v_scales.data_ptr()]
    err = fn(
        q.data_ptr(), *caches,
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), tickets.data_ptr(),
        B, Hq, Hkv, D, num_blocks, block_size, max_blocks, splits,
        sc, float(logit_softcap or 0.0), int(window or 0),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, lib)
    counted.launches += 1
    return out


def paged_decode_attention_cuda(
    q: torch.Tensor,  # [B, Hq, D] bf16
    k_cache: torch.Tensor,  # [Hkv, num_blocks, block_size, D] bf16 (one layer)
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_blocks] int32
    context_lens: torch.Tensor,  # [B] int32, INCLUDING the token just written
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Flash paged decode attention on the card (see the module docstring)."""
    return _paged_decode(paged_decode_attention_cuda, q, k_cache, v_cache, block_tables,
                         context_lens, None, None, window, scale, logit_softcap)


paged_decode_attention_cuda.launches = 0


def paged_decode_attention_int8_cuda(
    q: torch.Tensor,  # [B, Hq, D] bf16
    k_cache: torch.Tensor,  # [Hkv, num_blocks, block_size, D] int8 mantissas (one layer)
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_blocks] int32
    context_lens: torch.Tensor,  # [B] int32, INCLUDING the token just written
    k_scales: torch.Tensor,  # [Hkv, num_blocks] f32, one scale per (head, page)
    v_scales: torch.Tensor,
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """#1's int8 mode: int8 pages read as such, each page's scale applied
    to its score columns (k) and its softmax weights (v) in f32."""
    return _paged_decode(paged_decode_attention_int8_cuda, q, k_cache, v_cache, block_tables,
                         context_lens, k_scales, v_scales, window, scale, logit_softcap)


paged_decode_attention_int8_cuda.launches = 0


def flash_prefill_attention_cuda(
    q: torch.Tensor,  # [P, Hq, D] bf16
    k: torch.Tensor,  # [P, Hkv, D] bf16
    v: torch.Tensor,
    valid_len: int,
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Blockwise causal flash prefill attention on the card. Rows at or past
    ``valid_len`` are padding: their output is unspecified (zeros for whole
    padding tiles)."""
    P, Hq, D = q.shape
    Hkv = k.shape[1]
    _common(q, Hq, Hkv, D, prefill=True)
    dev = q.device
    _check(q, "q", torch.bfloat16, 3, dev)
    _check(k, "k", torch.bfloat16, 3, dev)
    _check(v, "v", torch.bfloat16, 3, dev)
    if k.shape != (P, Hkv, D) or v.shape != k.shape:
        raise ValueError(
            f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match "
            f"q {tuple(q.shape)}"
        )
    valid_len = int(valid_len)
    if not 0 <= valid_len <= P:
        raise ValueError(f"valid_len {valid_len} outside [0, {P}]")
    out = torch.empty_like(q)
    if P == 0:
        return out
    fn = _fn("flash_prefill_attention", "flash_prefill_attention_bf16", _PREFILL_ARGTYPES)
    sc = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        P, Hq, Hkv, D, valid_len,
        sc, float(logit_softcap or 0.0), int(window or 0),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "flash_prefill_attention")
    flash_prefill_attention_cuda.launches += 1
    return out


flash_prefill_attention_cuda.launches = 0


def _paged_verify(counted, q, k_cache, v_cache, block_tables, positions, k_scales, v_scales,
                  window, scale, logit_softcap) -> torch.Tensor:
    """One launch of #2 in its bf16 mode (no scales) or its int8 mode,
    counted on ``counted`` (the public wrapper of that mode)."""
    B, S, Hq, D = q.shape
    Hkv, num_blocks, block_size, _ = k_cache.shape
    _common(q, Hq, Hkv, D)
    dev = q.device
    _check(q, "q", torch.bfloat16, 4, dev)
    _check_pages(q, k_cache, v_cache, k_scales, v_scales, dev)
    _check(block_tables, "block_tables", torch.int32, 2, dev)
    _check(positions, "positions", torch.int32, 2, dev)
    if block_tables.shape[0] != B or tuple(positions.shape) != (B, S):
        raise ValueError("block_tables / positions do not match q's [B, S]")
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    # one launch: the splits' f32 partials of every (lane, kv head, 16-row
    # tile), and a ticket per (lane, kv head, tile) for the merge
    lib = "paged_verify_attention"
    max_blocks = block_tables.shape[1]
    tiles = -(-S * (Hq // Hkv) // PAGED_ROWS)
    splits = _fn(lib, "paged_verify_num_splits", [_I] * 6)(
        B, S, Hq, Hkv, max_blocks, block_size)
    part_acc, part_ml = _partials(B * Hkv * tiles * splits, D, dev)
    tickets = reserve_tickets(dev, B * Hkv * tiles)
    sc = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    caches = [k_cache.data_ptr(), v_cache.data_ptr()]
    if k_scales is None:
        fn = _fn(lib, "paged_verify_attention_bf16", _VERIFY_ARGTYPES)
    else:
        fn = _fn(lib, "paged_verify_attention_int8", _VERIFY_INT8_ARGTYPES)
        caches += [k_scales.data_ptr(), v_scales.data_ptr()]
    err = fn(
        q.data_ptr(), *caches,
        block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), tickets.data_ptr(),
        B, S, Hq, Hkv, D, num_blocks, block_size, max_blocks, splits,
        sc, float(logit_softcap or 0.0), int(window or 0),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, lib)
    counted.launches += 1
    return out


def paged_verify_attention_cuda(
    q: torch.Tensor,  # [B, S, Hq, D] bf16, S consecutive positions per lane
    k_cache: torch.Tensor,  # [Hkv, num_blocks, block_size, D] bf16 (one layer)
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_blocks] int32
    positions: torch.Tensor,  # [B, S] int32, positions[b, s] = positions[b, 0] + s
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Spec-decode verify attention on the card: each lane's S draft
    positions, whose K/V are already in the cache, attend causally over the
    lane's pages, read once for all S * G rows. The positions must be
    consecutive per lane (what ``decode_verify`` feeds); the kernel reads
    only ``positions[b, 0]`` and ``positions[b, S - 1]``."""
    return _paged_verify(paged_verify_attention_cuda, q, k_cache, v_cache, block_tables,
                         positions, None, None, window, scale, logit_softcap)


paged_verify_attention_cuda.launches = 0


def paged_verify_attention_int8_cuda(
    q: torch.Tensor,  # [B, S, Hq, D] bf16, S consecutive positions per lane
    k_cache: torch.Tensor,  # [Hkv, num_blocks, block_size, D] int8 mantissas (one layer)
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_blocks] int32
    positions: torch.Tensor,  # [B, S] int32, positions[b, s] = positions[b, 0] + s
    k_scales: torch.Tensor,  # [Hkv, num_blocks] f32, one scale per (head, page)
    v_scales: torch.Tensor,
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """#2's int8 mode, over int8 pages and their scale planes as #1's."""
    return _paged_verify(paged_verify_attention_int8_cuda, q, k_cache, v_cache, block_tables,
                         positions, k_scales, v_scales, window, scale, logit_softcap)


paged_verify_attention_int8_cuda.launches = 0
