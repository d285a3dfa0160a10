"""Int8-resident paged KV cache: the container and its quantized writes.

Counterpart of dynamo_tpu/ops/kv_quant.py. With ``kv_dtype="int8"`` the
paged cache stores int8 mantissas and one f32 scale per (layer, kv head,
block), so every decode step reads about half the KV bytes of a bf16
cache, and the attention kernels dequantize inside their loops (plain
versions: right after the gather). The container is a plain dict, as in
the reference:

    cache = {"q": int8 [L, Hkv, num_blocks, block_size, D],
             "s": f32  [L, Hkv, num_blocks]}

The scale scheme is the reference's: amax / 127 per block, inverse 0 for an
all-zero block, round half to even, clip at +-127. Unlike the reference,
whose writes return updated arrays, the writes here land IN PLACE in the
layer views they are given (``cache_layer`` returns views of the full
container), as the port's bf16 writes do.

  * whole-block writes (prefill, chunked prefill) take each block's exact
    absmax;
  * token writes (decode, spec verify, packed prefill) grow a block's scale
    monotonically, max(old, token amax / 127), and rescale the block's
    existing mantissas once when it grows. A token at block offset 0 resets
    a recycled block's scale. Several tokens may land in one block in one
    call: the per-block maxima combine by ``scatter_reduce(..., "amax")``,
    so the write is duplicate-safe without ``unique``, ``nonzero`` or any
    other read back to the host.
"""

from __future__ import annotations

from typing import Any, Union

import torch

KVCache = Union[torch.Tensor, dict]


def is_quantized(cache: Any) -> bool:
    """True for the int8-resident {"q", "s"} container."""
    return isinstance(cache, dict)


def make_cache(shape: tuple, dtype: torch.dtype, *, quantized: bool, device=None) -> KVCache:
    """A zeroed cache of ``shape`` [..., num_blocks, block_size, D]: a plain
    ``dtype`` tensor, or the int8 + scale container."""
    if not quantized:
        return torch.zeros(shape, dtype=dtype, device=device)
    return {
        "q": torch.zeros(shape, dtype=torch.int8, device=device),
        "s": torch.zeros(shape[:-2], dtype=torch.float32, device=device),
    }


def cache_nbytes(cache: KVCache) -> int:
    leaves = cache.values() if is_quantized(cache) else (cache,)
    return sum(t.numel() * t.element_size() for t in leaves)


def cache_layer(cache: KVCache, i: int) -> KVCache:
    """Layer i's view: [Hkv, nb, bs, D] (and its [Hkv, nb] scales)."""
    if is_quantized(cache):
        return {"q": cache["q"][i], "s": cache["s"][i]}
    return cache[i]


def pages(cache: KVCache) -> torch.Tensor:
    """The page tensor of a cache or a layer (the mantissas when quantized)."""
    return cache["q"] if is_quantized(cache) else cache


# ------------------------------------------------------------ quant math
#
# The reference's formulas (kv_quant.py:113-135), each in f32.


def block_scale(amax: torch.Tensor) -> torch.Tensor:
    return (amax / 127.0).float()


def scale_inv(scale: torch.Tensor) -> torch.Tensor:
    return torch.where(scale > 0, 1.0 / scale.clamp_min(1e-30), 0.0)


def quantize_with(x: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """Quantize f32 values with a broadcastable inverse scale (torch.round
    rounds half to even, as jnp.round does)."""
    return torch.round(x * inv).clamp_(-127, 127).to(torch.int8)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 mantissas [..., bs, D] times the per-block scale [...] -> f32."""
    return q.float() * scale[..., None, None]


# ---------------------------------------------------------------- writes


def write_blocks_quant(
    layer: dict,  # {"q": [Hkv, nb, bs, D] int8, "s": [Hkv, nb] f32}, written in place
    blocks: torch.Tensor,  # [Hkv, n, bs, D] new whole blocks, any float dtype
    block_table: torch.Tensor,  # [n] block ids
) -> None:
    """Whole-block write (prefill, chunk): each block's exact absmax scale."""
    xf = blocks.float()
    scale = block_scale(xf.abs().amax(dim=(-2, -1)))  # [Hkv, n]
    ids = block_table.long()
    layer["q"][:, ids] = quantize_with(xf, scale_inv(scale)[..., None, None])
    layer["s"][:, ids] = scale


def write_tokens_quant(
    layer: dict,  # {"q": [Hkv, nb, bs, D] int8, "s": [Hkv, nb] f32}, written in place
    new: torch.Tensor,  # [T, Hkv, D] new tokens, any float dtype
    slot_indices: torch.Tensor,  # [T] flat slots (block * bs + offset)
) -> None:
    """Token write (decode, verify, packed prefill), in the reference's
    order: per-block incoming absmax and fresh flags by scatter-max, the
    grown scale, every touched block's mantissas rescaled once, then the
    tokens quantized by their block's new scale and scattered."""
    q_cache, s = layer["q"], layer["s"]
    Hkv, nb, bs, D = q_cache.shape
    slots = slot_indices.long()
    bids = slots // bs
    offs = slots % bs
    T = slots.shape[0]
    xf = new.float().transpose(0, 1)  # [Hkv, T, D]
    tok_amax = xf.abs().amax(dim=-1)  # [Hkv, T]
    dev = q_cache.device
    idx = bids[None, :].expand(Hkv, T)
    inc = torch.zeros(Hkv, nb, dtype=torch.float32, device=dev).scatter_reduce_(
        1, idx, tok_amax, "amax")
    # per block: 0 untouched, 1 touched, 2 touched at offset 0 (fresh)
    mark = torch.zeros(nb, dtype=torch.int32, device=dev).scatter_reduce_(
        0, bids, 1 + (offs == 0).to(torch.int32), "amax")
    touched, fresh = mark > 0, mark > 1
    base = torch.where(fresh[None, :], 0.0, s)  # the scale the old content keeps
    new_s = torch.where(touched[None, :], torch.maximum(base, block_scale(inc)), s)
    # rescale the touched blocks' mantissas (gathered once per token: a
    # block gathered twice is written back twice with the same values)
    inv_g = scale_inv(new_s)[:, bids]  # [Hkv, T]
    ratio = (base[:, bids] * inv_g)[..., None, None]
    q_cache[:, bids] = quantize_with(q_cache[:, bids].float(), ratio)
    # the tokens, quantized by their block's (possibly grown) scale
    q_cache.view(Hkv, nb * bs, D)[:, slots] = quantize_with(xf, inv_g[..., None])
    s.copy_(new_s)
