"""Attention over a paged KV cache: causal prefill, paged decode, the
spec-decode verify pass and the cache writes.

Counterpart of dynamo_tpu/ops/attention.py. The cache of one layer is
head-major and block-paged, ``[Hkv, num_blocks, block_size, D]``, addressed by
per-sequence block tables; block 0 is the null block that padding writes to.

Each attention op has a plain PyTorch version here (the JAX package's XLA
branch, op for op: f32 scores and softmax, output cast to the input dtype)
and a hand-written CUDA kernel in ops/cuda_attention.py. The dispatch is by
where the tensors are and nothing else: CUDA tensors launch the kernel (or
raise), CPU tensors run the plain version. The sliding window, custom score
scale and logit softcap are carried on every path.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from dynamo_tpu_torch.ops.cuda_attention import (
    flash_prefill_attention_cuda,
    paged_decode_attention_cuda,
    paged_verify_attention_cuda,
)

NEG_INF = -1e30


def _softcap(scores: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap * tanh(scores / cap)."""
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def _scale(scale: Optional[float], d: int) -> float:
    return float(scale) if scale is not None else 1.0 / math.sqrt(d)


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
    kernel for CUDA tensors, the plain gather version for CPU ones."""
    if q.is_cuda:
        return paged_decode_attention_cuda(
            q, k_cache, v_cache, block_tables, context_lens,
            window=window, scale=scale, logit_softcap=logit_softcap,
        )
    return paged_decode_attention_plain(
        q, k_cache, v_cache, block_tables, context_lens,
        window=window, scale=scale, logit_softcap=logit_softcap,
    )


def paged_decode_attention_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of the decode kernel (dynamo_tpu/ops/attention.py
    gather branch, :304-339): gather every table entry's page into a dense
    [Hkv, B, max_blocks * block_size, D] window and attend with a mask."""
    B, Hq, D = q.shape
    Hkv, _, block_size, _ = k_cache.shape
    G = Hq // Hkv
    S = block_tables.shape[1] * block_size
    tables = block_tables.long()
    k = k_cache[:, tables].reshape(Hkv, B, S, D)
    v = v_cache[:, tables].reshape(Hkv, B, S, D)
    qr = q.reshape(B, Hkv, G, D).float()
    scores = torch.einsum("bhgd,hbsd->bhgs", qr, k.float()) * _scale(scale, D)
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
    out = torch.einsum("bhgs,hbsd->bhgd", weights, v.float())
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
    as ``decode_verify`` feeds them), the plain gather version for CPU ones."""
    if q.is_cuda:
        return paged_verify_attention_cuda(
            q, k_cache, v_cache, block_tables, positions,
            window=window, scale=scale, logit_softcap=logit_softcap,
        )
    return paged_verify_attention_plain(
        q, k_cache, v_cache, block_tables, positions,
        window=window, scale=scale, logit_softcap=logit_softcap,
    )


def paged_verify_attention_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,
    positions: torch.Tensor,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of the verify kernel (dynamo_tpu/ops/attention.py
    gather branch, :426-459): every table entry's page gathered into a dense
    [Hkv, B, max_blocks * block_size, D] window; query (b, s) sees key kpos
    iff kpos <= positions[b, s] and, with a window,
    positions[b, s] - kpos < window."""
    B, S, Hq, D = q.shape
    Hkv, _, block_size, _ = k_cache.shape
    G = Hq // Hkv
    S_ctx = block_tables.shape[1] * block_size
    tables = block_tables.long()
    k = k_cache[:, tables].reshape(Hkv, B, S_ctx, D)
    v = v_cache[:, tables].reshape(Hkv, B, S_ctx, D)
    qr = q.reshape(B, S, Hkv, G, D).float()
    scores = torch.einsum("bshgd,hbkd->bhgsk", qr, k.float()) * _scale(scale, D)
    scores = _softcap(scores, logit_softcap)
    kpos = torch.arange(S_ctx, device=q.device)[None, None, :]
    qpos = positions.long()[:, :, None]
    mask = kpos <= qpos  # [B, S, S_ctx]
    if window is not None:
        mask &= qpos - kpos < window
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgsk,hbkd->bshgd", weights, v.float())
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
    every write lands in it). Padding blocks map to the null block 0."""
    Hkv, _, block_size, D = k_cache.shape
    nb = k_new.shape[0] // block_size
    ids = block_table.long()
    k_cache[:, ids] = k_new.reshape(nb, block_size, Hkv, D).permute(2, 0, 1, 3).to(k_cache.dtype)
    v_cache[:, ids] = v_new.reshape(nb, block_size, Hkv, D).permute(2, 0, 1, 3).to(v_cache.dtype)


def write_decode_kv(
    k_cache: torch.Tensor,  # [Hkv, num_blocks, block_size, D] (this layer)
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # [B, Hkv, D]
    v_new: torch.Tensor,
    slot_indices: torch.Tensor,  # [B] flat slot = block_id * block_size + offset
) -> None:
    """Scatter one new K/V token per sequence into its slot, IN PLACE.
    Inactive lanes point at slot 0 (the null block)."""
    Hkv, num_blocks, block_size, D = k_cache.shape
    slots = slot_indices.long()
    k_cache.view(Hkv, num_blocks * block_size, D)[:, slots] = k_new.transpose(0, 1).to(k_cache.dtype)
    v_cache.view(Hkv, num_blocks * block_size, D)[:, slots] = v_new.transpose(0, 1).to(v_cache.dtype)
