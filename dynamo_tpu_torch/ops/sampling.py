"""On-device batched token sampling: greedy / temperature / top-k / top-p,
frequency / presence / repetition penalties, the min_tokens EOS mask,
per-sequence counter-based random streams, and logprobs.

Counterpart of dynamo_tpu/ops/sampling.py: the penalty tables and appliers,
``apply_repetition_penalty_packed`` and ``mask_eos_logits`` (:28-175, the
same semantics; XLA ops there, so these tensor ops are the card path too),
and ``sample_tokens``,
``sample_tokens_full``, ``make_key_data`` (:202-319): the same 256-candidate
pool for restricted rows, the same full-vocab draw for unrestricted rows and
the same wide-nucleus rule, batched over [B, V] with per-row parameters and
no per-sequence Python.

Random draws come from a key row ``(stream_id, counter)`` per sequence, as in
the JAX package, so a request's seed gives the same token at the same output
position regardless of batch composition or preemption. The draw is a
Gumbel-max over integer-hashed uniforms: the integer hash is exact on every
device, so CPU and GPU draw the same noise. The bits are NOT JAX's threefry
bits: the same seed gives different (equally distributed) tokens here and in
the JAX engine.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30
# Candidate-pool width for top-k / top-p rows (see the JAX module).
SAMPLE_CANDIDATES = 256
_M32 = 0xFFFFFFFF


# eos-id slots carried into a step (the engine's per-sequence stop-id row)
MAX_EOS_IDS = 4


def penalty_count_tables(
    hist: torch.Tensor,  # [B, L] int token history (prompt + generated)
    hist_len: torch.Tensor,  # [B] valid tokens in hist
    prompt_len: torch.Tensor,  # [B] prompt prefix length within hist
    vocab_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The history scattered into per-vocab tables: (out_counts [B, V] f32,
    generated-token counts; seen [B, V] f32, 1 where the token appears in
    prompt or generated)."""
    B, L = hist.shape
    idx = torch.arange(L, device=hist.device)[None, :]
    valid = idx < hist_len[:, None]
    is_out = valid & (idx >= prompt_len[:, None])
    safe = hist.long().clamp(0, vocab_size - 1)
    out_counts = torch.zeros(B, vocab_size, device=hist.device).scatter_add_(
        1, safe, is_out.float())
    seen = torch.zeros(B, vocab_size, device=hist.device).scatter_reduce_(
        1, safe, valid.float(), reduce="amax")
    return out_counts, seen


def advance_count_tables(
    out_counts: torch.Tensor,  # [B, V] f32
    seen: torch.Tensor,  # [B, V] f32
    tokens: torch.Tensor,  # [B] int token each lane appended
    advance: torch.Tensor,  # [B] bool: whether it did
) -> tuple[torch.Tensor, torch.Tensor]:
    """The count tables after each advancing lane appended its token (a
    chained step's history update, the reference's ``.at[rows, tok]``
    add / max)."""
    idx = tokens.long().clamp(0, out_counts.shape[-1] - 1)[:, None]
    adv = advance.to(out_counts.dtype)[:, None]
    return out_counts.scatter_add(1, idx, adv), seen.scatter_reduce(1, idx, adv, reduce="amax")


def _repetition(logits: torch.Tensor, rp: torch.Tensor, seen: torch.Tensor) -> torch.Tensor:
    """HF-style: positive logits of seen tokens divided by rp, negative ones
    multiplied by it."""
    penalized = torch.where(logits > 0, logits / rp, logits * rp)
    return torch.where(seen > 0, penalized, logits)


def apply_penalties_from_tables(
    logits: torch.Tensor,  # [B, V] f32
    out_counts: torch.Tensor,  # [B, V] f32 generated-token counts
    seen: torch.Tensor,  # [B, V] f32 (> 0 where the token appeared at all)
    frequency_penalty: torch.Tensor,  # [B] f32; 0 disables
    presence_penalty: torch.Tensor,  # [B] f32; 0 disables
    repetition_penalty: torch.Tensor,  # [B] f32; 1 disables
) -> torch.Tensor:
    """vLLM-semantics penalties: frequency and presence over GENERATED
    tokens only (``logits -= freq * count + pres * [count > 0]``),
    repetition over prompt + generated tokens. A lane with 0 / 0 / 1 passes
    through bit-exactly."""
    logits = (
        logits
        - frequency_penalty[:, None] * out_counts
        - presence_penalty[:, None] * (out_counts > 0).float()
    )
    return _repetition(logits, repetition_penalty[:, None], seen)


def apply_penalties(
    logits: torch.Tensor,  # [B, V] f32
    hist: torch.Tensor,  # [B, L] token history (prompt + generated)
    hist_len: torch.Tensor,  # [B]
    prompt_len: torch.Tensor,  # [B]
    frequency_penalty: torch.Tensor,
    presence_penalty: torch.Tensor,
    repetition_penalty: torch.Tensor,
) -> torch.Tensor:
    """One step's penalties: build the tables, then apply them."""
    out_counts, seen = penalty_count_tables(hist, hist_len, prompt_len, logits.shape[-1])
    return apply_penalties_from_tables(
        logits, out_counts, seen, frequency_penalty, presence_penalty, repetition_penalty)


def apply_repetition_penalty_from_prompt(
    logits: torch.Tensor,  # [V] or [B, V]
    prompt: torch.Tensor,  # [T] int (padded; positions >= valid_len ignored)
    valid_len: int,
    repetition_penalty: float,  # 1 disables
) -> torch.Tensor:
    """Prompt-only repetition penalty for the prefill-sampled first token
    (frequency and presence are zero by definition there)."""
    V = logits.shape[-1]
    valid = (torch.arange(prompt.shape[0], device=prompt.device) < valid_len).float()
    seen = torch.zeros(V, device=logits.device).scatter_reduce_(
        0, prompt.long().clamp(0, V - 1), valid, reduce="amax")
    rp = torch.tensor(repetition_penalty, dtype=logits.dtype, device=logits.device)
    return _repetition(logits, rp, seen)


def apply_repetition_penalty_packed(
    logits: torch.Tensor,  # [N, V] each segment's last-token logits
    tokens: torch.Tensor,  # [P] int packed prompt tokens
    segment_ids: torch.Tensor,  # [P] int; -1 marks padding
    repetition_penalty: torch.Tensor,  # [N] f32; 1 disables
) -> torch.Tensor:
    """Per-segment prompt repetition penalty for the packed prefill's first
    tokens: each segment's seen-set comes from its own tokens only."""
    N, V = logits.shape
    valid = (segment_ids >= 0).float()
    flat = segment_ids.long().clamp(0, N - 1) * V + tokens.long().clamp(0, V - 1)
    seen = torch.zeros(N * V, device=logits.device).scatter_reduce_(
        0, flat, valid, reduce="amax").reshape(N, V)
    return _repetition(logits, repetition_penalty[:, None], seen)


def mask_eos_logits(
    logits: torch.Tensor,  # [B, V] or [V]
    eos_ids: torch.Tensor,  # [B, K] or [K] int; -1 pads unused slots
    suppress: torch.Tensor,  # [B] or scalar bool: min_tokens not reached
) -> torch.Tensor:
    """min_tokens, the vLLM way: while a sequence has not generated its
    minimum, its EOS logits are NEG_INF, so no EOS can be sampled."""
    squeeze = logits.dim() == 1
    if squeeze:
        logits, eos_ids, suppress = logits[None], eos_ids[None], suppress.reshape(1)
    V = logits.shape[-1]
    is_eos = torch.zeros_like(logits).scatter_reduce_(
        1, eos_ids.long().clamp(0, V - 1), (eos_ids >= 0).to(logits.dtype), reduce="amax") > 0
    out = torch.where(is_eos & suppress[:, None], NEG_INF, logits)
    return out[0] if squeeze else out


def make_key_data(stream_id: int, counter: int) -> np.ndarray:
    """Host-side key row (stream, counter) for ``sample_tokens(keys=...)``."""
    return np.array([stream_id & _M32, counter & _M32], np.int64)


def advance_keys(keys: torch.Tensor, h) -> torch.Tensor:
    """[B, 2] key rows with each counter advanced by ``h`` (an int or a [B]
    tensor) on the device: the row the per-token path would send h tokens
    later (the reference's ``keys.at[:, 1].add(h)``)."""
    return torch.stack([keys[:, 0], (keys[:, 1] + h) & _M32], dim=1)


def spec_accept_len(
    sampled: torch.Tensor,  # [B, S] model tokens at the verify positions
    drafts: torch.Tensor,  # [B, S - 1] drafts fed at positions 1..S-1
    draft_len: torch.Tensor,  # [B] valid drafts per lane
) -> torch.Tensor:
    """Accepted drafts per lane [B]: draft h+1 is accepted iff it equals the
    model's token at position h and every earlier draft was accepted (the
    reference's longest-matching-prefix rule, ops/sampling.py:146)."""
    S = sampled.shape[1]
    step = torch.arange(1, S, device=sampled.device)[None, :]
    match = (sampled[:, :-1].long() == drafts.long()) & (step <= draft_len[:, None])
    return torch.cumprod(match.long(), dim=1).sum(dim=1)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer finaliser on int64 tensors holding values < 2^32 (the
    multipliers are < 2^31, so no product overflows int64)."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def gumbel_noise(keys: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n] f32 standard Gumbel noise, a pure function of each row's
    (stream, counter) key and the column index."""
    keys = keys.long()
    base = _mix32(_mix32(keys[:, :1] ^ 0x9E3779B9) ^ keys[:, 1:2])  # [B, 1]
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    bits = _mix32(base ^ _mix32(idx + 1))
    # 23 random bits -> u in (0, 1), exact in f32
    u = ((bits >> 9) * 2 + 1).float() * (2.0 ** -24)
    return -torch.log(-torch.log(u))


def _filtered_candidates(scaled, top_p, top_k):
    """Mask the candidate pool to the top-k / nucleus support; returns
    (vals [B, C] descending filtered logits, idx [B, C] vocab ids)."""
    V = scaled.shape[-1]
    C = min(SAMPLE_CANDIDATES, V)
    vals, idx = torch.topk(scaled, C, dim=-1)
    k = torch.where(top_k <= 0, C, torch.clamp(top_k, max=C)).clamp(1, C)
    pos = torch.arange(C, device=scaled.device)[None, :]
    vals = torch.where(pos >= k[:, None], NEG_INF, vals)
    probs = torch.softmax(vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p[:, None]
    return torch.where(keep, vals, NEG_INF), idx


def sample_tokens(
    logits: torch.Tensor,  # [B, V] f32
    temperature: torch.Tensor,  # [B] f32; <= 0 means greedy
    top_p: torch.Tensor,  # [B] f32 in (0, 1]; 1.0 disables
    top_k: torch.Tensor,  # [B] int; 0 disables
    keys: torch.Tensor,  # [B, 2] int64 (stream, counter) rows
) -> torch.Tensor:
    """Sampled token ids [B] int32 (see the JAX docstring for the pool and
    wide-nucleus rules, which are the same here)."""
    greedy_ids = torch.argmax(logits, dim=-1)
    temp = torch.clamp(temperature, min=1e-6)[:, None]
    scaled = logits / temp
    vals, idx = _filtered_candidates(scaled, top_p, top_k)
    wide_nucleus = (top_k <= 0) & (top_p >= 0.99) & (temperature > 1.25)
    unrestricted = ((top_k <= 0) & (top_p >= 1.0)) | wide_nucleus
    choice = torch.argmax(vals + gumbel_noise(keys, vals.shape[-1]), dim=-1)
    full_choice = torch.argmax(scaled + gumbel_noise(keys, scaled.shape[-1]), dim=-1)
    pool_sampled = torch.gather(idx, 1, choice[:, None])[:, 0]
    sampled = torch.where(unrestricted, full_choice, pool_sampled)
    return torch.where(temperature <= 0.0, greedy_ids, sampled).to(torch.int32)


def sample_tokens_full(
    logits: torch.Tensor,
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    top_k: torch.Tensor,
    keys: torch.Tensor,
    num_top: int = 20,
    all_greedy: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """sample_tokens + logprob surface: (tokens [B] i32, chosen logprob [B]
    f32, top ids [B, num_top] i32, top logprobs [B, num_top] f32). Logprobs
    are of the raw distribution (before temperature / top-k / top-p).
    ``all_greedy`` (the caller knows every row has temperature <= 0) skips
    the draw; the result is the same."""
    logits = logits.float()
    if all_greedy:
        tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    else:
        tokens = sample_tokens(logits, temperature, top_p, top_k, keys)
    logz = torch.log_softmax(logits, dim=-1)
    chosen = torch.gather(logz, 1, tokens[:, None].long())[:, 0]
    top_lps, top_ids = torch.topk(logz, min(num_top, logz.shape[-1]), dim=-1)
    return tokens, chosen, top_ids.to(torch.int32), top_lps


def sample_args(
    temps, top_ps, top_ks, keys: Optional[np.ndarray], device
) -> tuple[torch.Tensor, ...]:
    """Host per-row sampling parameters -> device tensors."""
    return (
        torch.as_tensor(np.asarray(temps, np.float32), device=device),
        torch.as_tensor(np.asarray(top_ps, np.float32), device=device),
        torch.as_tensor(np.asarray(top_ks, np.int64), device=device),
        torch.as_tensor(np.asarray(keys, np.int64), device=device),
    )
