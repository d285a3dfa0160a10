"""Attention over a paged KV cache: causal prefill, paged decode, the
spec-decode verify pass, packed and chunked prefill, and the cache writes.

Counterpart of dynamo_tpu/ops/attention.py. The cache of one layer is
head-major and block-paged, ``[Hkv, num_blocks, block_size, D]``, addressed by
per-sequence block tables; block 0 is the null block that padding writes to.

Each attention op has a plain PyTorch version here (the JAX package's XLA
branch, op for op: f32 scores and softmax, output cast to the input dtype)
and a hand-written CUDA kernel in ops/cuda_attention.py. The dispatch is by
where the tensors are and nothing else: CUDA tensors launch the kernel (or
raise), CPU tensors run the plain version. The sliding window, custom score
scale and logit softcap are carried on every path.

A cache (or a layer of one) is either a tensor or the int8-resident
``{"q": int8 pages, "s": f32 [Hkv, num_blocks] scales}`` container of
ops/kv_quant.py. Over the container, the paged decode and verify ops launch
their kernels' int8 modes on the card, and their plain versions (which take
the scale planes as ``k_scales`` / ``v_scales``) dequantize right after the
gather, as the reference's XLA branch does (attention.py:312-320); chunked
prefill dequantizes its gathered blocks the same way; the writes quantize
on write (kv_quant.write_blocks_quant / write_tokens_quant).

Packed and chunked prefill attention are XLA ops in the JAX package, with no
Pallas kernel (ops/attention.py:172, :462), so their PyTorch versions here
are the card path too: one implementation on both devices, f32 scores as in
the reference, so that the CPU parity tests cover the card's arithmetic.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from dynamo_tpu_torch.ops import kv_quant
from dynamo_tpu_torch.ops.cuda_attention import (
    flash_prefill_attention_cuda,
    paged_decode_attention_cuda,
    paged_decode_attention_int8_cuda,
    paged_verify_attention_cuda,
    paged_verify_attention_int8_cuda,
)

NEG_INF = -1e30


def _softcap(scores: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap * tanh(scores / cap)."""
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def _scale(scale: Optional[float], d: int) -> float:
    return float(scale) if scale is not None else 1.0 / math.sqrt(d)


def _gather(pages: torch.Tensor, scales: Optional[torch.Tensor], tables: torch.Tensor):
    """Every table entry's page, [Hkv, *tables.shape, bs, D] in f32: int8
    pages dequantized by their gathered scales right after the gather."""
    if scales is None:
        return pages[:, tables].float()
    return kv_quant.dequantize(pages[:, tables], scales[:, tables])


def _split(cache):
    """(pages, scales | None) of one layer's cache."""
    if kv_quant.is_quantized(cache):
        return cache["q"], cache["s"]
    return cache, None


def causal_prefill_attention(
    q: torch.Tensor,  # [P, Hq, D]
    k: torch.Tensor,  # [P, Hkv, D]
    v: torch.Tensor,  # [P, Hkv, D]
    valid_len: int,  # true sequence length (<= P)
    window: Optional[int] = None,  # sliding-window size; None = full
    scale: Optional[float] = None,  # score scale; None = 1/sqrt(D)
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Single-sequence causal self-attention over a padded prompt window:
    the flash kernel for CUDA tensors, the plain version for CPU ones."""
    if q.is_cuda:
        return flash_prefill_attention_cuda(
            q, k, v, valid_len, window=window, scale=scale,
            logit_softcap=logit_softcap,
        )
    return causal_prefill_attention_plain(
        q, k, v, valid_len, window=window, scale=scale,
        logit_softcap=logit_softcap,
    )


def causal_prefill_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid_len: int,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of the prefill kernel (dynamo_tpu/ops/attention.py
    XLA branch, :149-169): token i attends to j iff j <= i, j < valid_len
    and, with a window, i - j < window."""
    P, Hq, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    qr = q.reshape(P, Hkv, G, D).float()
    scores = torch.einsum("qhgd,khd->hgqk", qr, k.float()) * _scale(scale, D)
    scores = _softcap(scores, logit_softcap)
    pos = torch.arange(P, device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] < valid_len)
    if window is not None:
        mask &= pos[:, None] - pos[None, :] < window
    scores = torch.where(mask[None, None], scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("hgqk,khd->qhgd", weights, v.float())
    return out.reshape(P, Hq, D).to(q.dtype)


def paged_decode_attention(
    q: torch.Tensor,  # [B, Hq, D] — one new token per sequence
    k_cache: torch.Tensor,  # [Hkv, num_blocks, block_size, D] (this layer)
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_blocks] int32 block ids
    context_lens: torch.Tensor,  # [B] int32 — INCLUDING the token just written
    window: Optional[int] = None,
    scale: Optional[float] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Decode-step attention over each sequence's pages: the paged flash
    kernel (its int8 mode over an int8 cache) for CUDA tensors, the plain
    gather version for CPU ones."""
    kp, ks = _split(k_cache)
    vp, vs = _split(v_cache)
    kw = dict(window=window, scale=scale, logit_softcap=logit_softcap)
    if q.is_cuda:
        if ks is not None:
            return paged_decode_attention_int8_cuda(
                q, kp, vp, block_tables, context_lens, ks, vs, **kw)
        return paged_decode_attention_cuda(q, kp, vp, block_tables, context_lens, **kw)
    return paged_decode_attention_plain(
        q, kp, vp, block_tables, context_lens, k_scales=ks, v_scales=vs, **kw)


def paged_decode_attention_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    logit_softcap: Optional[float] = None,
    *,
    k_scales: Optional[torch.Tensor] = None,  # [Hkv, num_blocks] f32 with int8 pages
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the decode kernel in both modes
    (dynamo_tpu/ops/attention.py gather branch, :304-339): gather every
    table entry's page into a dense [Hkv, B, max_blocks * block_size, D]
    window (int8 pages dequantized right after the gather) and attend with
    a mask."""
    B, Hq, D = q.shape
    Hkv, _, block_size, _ = k_cache.shape
    G = Hq // Hkv
    S = block_tables.shape[1] * block_size
    tables = block_tables.long()
    k = _gather(k_cache, k_scales, tables).reshape(Hkv, B, S, D)
    v = _gather(v_cache, v_scales, tables).reshape(Hkv, B, S, D)
    qr = q.reshape(B, Hkv, G, D).float()
    scores = torch.einsum("bhgd,hbsd->bhgs", qr, k) * _scale(scale, D)
    scores = _softcap(scores, logit_softcap)
    kpos = torch.arange(S, device=q.device)[None, :]
    lens = context_lens.long()[:, None]
    mask = kpos < lens
    if window is not None:
        # the query sits at position context_len-1; it sees the last
        # `window` positions (itself included)
        mask &= kpos >= lens - window
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,hbsd->bhgd", weights, v)
    return out.reshape(B, Hq, D).to(q.dtype)


def paged_verify_attention(
    q: torch.Tensor,  # [B, S, Hq, D] -- S speculative positions per lane
    k_cache: torch.Tensor,  # [Hkv, num_blocks, block_size, D] (this layer)
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_blocks] int32 block ids
    positions: torch.Tensor,  # [B, S] int32 true positions, consecutive per lane
    window: Optional[int] = None,
    scale: Optional[float] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Draft-verify attention: each lane's S new tokens, whose K/V are
    already in the cache, attend causally over the lane's pages. The paged
    verify kernel for CUDA tensors (positions must be consecutive per lane,
    as ``decode_verify`` feeds them; its int8 mode over an int8 cache), the
    plain gather version for CPU ones."""
    kp, ks = _split(k_cache)
    vp, vs = _split(v_cache)
    kw = dict(window=window, scale=scale, logit_softcap=logit_softcap)
    if q.is_cuda:
        if ks is not None:
            return paged_verify_attention_int8_cuda(
                q, kp, vp, block_tables, positions, ks, vs, **kw)
        return paged_verify_attention_cuda(q, kp, vp, block_tables, positions, **kw)
    return paged_verify_attention_plain(
        q, kp, vp, block_tables, positions, k_scales=ks, v_scales=vs, **kw)


def paged_verify_attention_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,
    positions: torch.Tensor,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    logit_softcap: Optional[float] = None,
    *,
    k_scales: Optional[torch.Tensor] = None,  # [Hkv, num_blocks] f32 with int8 pages
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the verify kernel in both modes
    (dynamo_tpu/ops/attention.py gather branch, :426-459): every table
    entry's page gathered into a dense [Hkv, B, max_blocks * block_size, D]
    window (int8 pages dequantized right after the gather); query (b, s)
    sees key kpos iff kpos <= positions[b, s] and, with a window,
    positions[b, s] - kpos < window."""
    B, S, Hq, D = q.shape
    Hkv, _, block_size, _ = k_cache.shape
    G = Hq // Hkv
    S_ctx = block_tables.shape[1] * block_size
    tables = block_tables.long()
    k = _gather(k_cache, k_scales, tables).reshape(Hkv, B, S_ctx, D)
    v = _gather(v_cache, v_scales, tables).reshape(Hkv, B, S_ctx, D)
    qr = q.reshape(B, S, Hkv, G, D).float()
    scores = torch.einsum("bshgd,hbkd->bhgsk", qr, k) * _scale(scale, D)
    scores = _softcap(scores, logit_softcap)
    kpos = torch.arange(S_ctx, device=q.device)[None, None, :]
    qpos = positions.long()[:, :, None]
    mask = kpos <= qpos  # [B, S, S_ctx]
    if window is not None:
        mask &= qpos - kpos < window
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgsk,hbkd->bshgd", weights, v)
    return out.reshape(B, S, Hq, D).to(q.dtype)


def write_prefill_kv(
    k_cache: torch.Tensor,  # [Hkv, num_blocks, block_size, D] (this layer)
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # [P, Hkv, D] (P = padded prompt, multiple of block)
    v_new: torch.Tensor,
    block_table: torch.Tensor,  # [P // block_size] block ids
) -> None:
    """Scatter a prompt's K/V into its blocks, IN PLACE (the JAX version
    returns updated caches; here the runner owns one buffer per cache and
    every write lands in it). Padding blocks map to the null block 0. An
    int8 cache takes each block's exact absmax scale."""
    Hkv, _, block_size, D = kv_quant.pages(k_cache).shape
    nb = k_new.shape[0] // block_size
    k_blocks = k_new.reshape(nb, block_size, Hkv, D).permute(2, 0, 1, 3)
    v_blocks = v_new.reshape(nb, block_size, Hkv, D).permute(2, 0, 1, 3)
    if kv_quant.is_quantized(k_cache):
        kv_quant.write_blocks_quant(k_cache, k_blocks, block_table)
        kv_quant.write_blocks_quant(v_cache, v_blocks, block_table)
        return
    ids = block_table.long()
    k_cache[:, ids] = k_blocks.to(k_cache.dtype)
    v_cache[:, ids] = v_blocks.to(v_cache.dtype)


def write_decode_kv(
    k_cache: torch.Tensor,  # [Hkv, num_blocks, block_size, D] (this layer)
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # [B, Hkv, D]
    v_new: torch.Tensor,
    slot_indices: torch.Tensor,  # [B] flat slot = block_id * block_size + offset
) -> None:
    """Scatter one new K/V token per sequence into its slot, IN PLACE.
    Inactive lanes point at slot 0 (the null block). An int8 cache grows
    each touched block's scale (kv_quant.write_tokens_quant; several tokens
    of one block in one call, as verify and packed prefill write, are
    fine)."""
    if kv_quant.is_quantized(k_cache):
        kv_quant.write_tokens_quant(k_cache, k_new, slot_indices)
        kv_quant.write_tokens_quant(v_cache, v_new, slot_indices)
        return
    Hkv, num_blocks, block_size, D = k_cache.shape
    slots = slot_indices.long()
    k_cache.view(Hkv, num_blocks * block_size, D)[:, slots] = k_new.transpose(0, 1).to(k_cache.dtype)
    v_cache.view(Hkv, num_blocks * block_size, D)[:, slots] = v_new.transpose(0, 1).to(v_cache.dtype)


def packed_prefill_attention(
    q: torch.Tensor,  # [P, Hq, D] -- several prompts packed back to back
    k: torch.Tensor,  # [P, Hkv, D]
    v: torch.Tensor,  # [P, Hkv, D]
    segment_ids: torch.Tensor,  # [P] int; -1 marks padding
    window: Optional[int] = None,
    scale: Optional[float] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Causal attention over a packed buffer of independent prompts
    (dynamo_tpu/ops/attention.py:172): token i sees j iff j <= i and both
    lie in the same segment. Padding (segment -1) attends only to padding
    and is never read. A segment's positions differ from the packed indices
    by its start offset, which cancels in i - j, so the window test works on
    packed indices."""
    P, Hq, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    qr = q.reshape(P, Hkv, G, D).float()
    scores = torch.einsum("qhgd,khd->hgqk", qr, k.float()) * _scale(scale, D)
    scores = _softcap(scores, logit_softcap)
    pos = torch.arange(P, device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & (segment_ids[None, :] == segment_ids[:, None])
    if window is not None:
        mask &= pos[:, None] - pos[None, :] < window
    scores = torch.where(mask[None, None], scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("hgqk,khd->qhgd", weights, v.float())
    return out.reshape(P, Hq, D).to(q.dtype)


def chunk_visible_blocks(chunk_start: int, chunk_len: int, block_size: int, table_len: int) -> int:
    """Table entries a prefill chunk can see: the blocks of positions
    [0, chunk_start + chunk_len), at most the whole table."""
    return min(table_len, -(-(chunk_start + chunk_len) // block_size))


def chunked_prefill_attention(
    q: torch.Tensor,  # [C, Hq, D] -- one chunk of a prompt
    k_cache: torch.Tensor,  # [Hkv, num_blocks, block_size, D] (this layer)
    v_cache: torch.Tensor,
    block_table: torch.Tensor,  # [max_nb] block ids of the WHOLE prompt
    chunk_start: int,  # position of q[0] (host int)
    window: Optional[int] = None,
    scale: Optional[float] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """One prefill chunk against everything written so far
    (dynamo_tpu/ops/attention.py:462). The chunk's own K/V must already be
    in the cache (``write_chunk_kv`` runs first); query c at position
    chunk_start + c sees key kpos iff kpos <= its position and, with a
    window, position - kpos < window.

    Unlike the reference, which gathers the whole table, only the
    ``chunk_visible_blocks`` the chunk can see are gathered: every key past
    the chunk's last position is masked to NEG_INF and weighs exactly 0
    after the softmax, so the result is the same (up to the f32 summation
    order) while the scores shrink from [Hq, C, table * block_size] to
    [Hq, C, chunk_start + C]. The width comes from host ints, so nothing is
    read back from the device. Padded table entries point at null block 0
    and are masked by kpos <= qpos."""
    C, Hq, D = q.shape
    kp, ks = _split(k_cache)
    vp, vs = _split(v_cache)
    Hkv, _, block_size, _ = kp.shape
    G = Hq // Hkv
    nb = chunk_visible_blocks(chunk_start, C, block_size, block_table.shape[0])
    S = nb * block_size
    tables = block_table[:nb].long()
    k = _gather(kp, ks, tables).reshape(Hkv, S, D)
    v = _gather(vp, vs, tables).reshape(Hkv, S, D)
    qr = q.reshape(C, Hkv, G, D).float()
    scores = torch.einsum("chgd,hsd->hgcs", qr, k) * _scale(scale, D)
    scores = _softcap(scores, logit_softcap)
    qpos = chunk_start + torch.arange(C, device=q.device)
    kpos = torch.arange(S, device=q.device)
    mask = kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= qpos[:, None] - kpos[None, :] < window
    scores = torch.where(mask[None, None], scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("hgcs,hsd->chgd", weights, v)
    return out.reshape(C, Hq, D).to(q.dtype)


def write_chunk_kv(
    k_cache: torch.Tensor,  # [Hkv, num_blocks, block_size, D] (this layer)
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # [C, Hkv, D], C a multiple of block_size
    v_new: torch.Tensor,
    block_table: torch.Tensor,  # [max_nb] block ids of the WHOLE prompt
    chunk_start: int,  # host int, a multiple of block_size
) -> None:
    """Scatter one prefill chunk's K/V into its slice of the block table,
    IN PLACE (dynamo_tpu/ops/attention.py:522). The table is padded with
    null-block entries first, so a final chunk whose padded tail runs past
    the table writes that tail into null block 0 and never into earlier
    blocks. An unaligned start would scatter K/V to the wrong positions, so
    it raises."""
    block_size = kv_quant.pages(k_cache).shape[2]
    if chunk_start % block_size:
        raise ValueError(
            f"chunk_start {chunk_start} is not a multiple of the KV block size "
            f"{block_size}: the chunk's K/V would land at the wrong positions"
        )
    nb = k_new.shape[0] // block_size
    first = chunk_start // block_size
    padded = torch.cat([block_table, block_table.new_zeros(nb)])
    write_prefill_kv(k_cache, v_cache, k_new, v_new, padded[first:first + nb])
