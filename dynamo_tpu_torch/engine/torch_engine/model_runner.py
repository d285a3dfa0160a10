"""TorchModelRunner: owns the device state (parameters and the paged KV
cache) and runs prefill / decode + sampling.

Counterpart of dynamo_tpu/engine/jax_engine/model_runner.py (``prefill``
:1142 with ``_prefill_impl`` :490, ``prefill_chunk`` :1252 with
``_prefill_chunk_impl`` :542, ``pack_prefill`` :1323,
``prefill_packed_arrays`` :1371 with ``_prefill_packed_impl`` :562,
``mixed_step`` :980 with ``_mixed_impl`` :924, ``decode`` :1603 with
``_decode_impl`` :579, ``spec_verify`` :1696 with ``_spec_verify_impl``
:704, ``fetch_sample`` :1049, ``default_prefill_buckets`` :41), for the
single-device path:

  * the caches are single buffers written IN PLACE by every call (the JAX
    runner donates them through jit; PyTorch simply updates them);
  * prompts are padded to the same power-of-two buckets of whole KV blocks,
    so the prefill shapes match the JAX program set;
  * ``prefill_chunk_tokens`` (C, default 512, rounded up to whole blocks
    and capped at the largest bucket; 0 turns chunking off) sizes the
    chunked prefill's chunks and the packed prefill's token buffer; the
    engine routes prompts longer than C through ``prefill_chunk`` /
    ``mixed_step`` and packs shorter ones through ``pack_prefill`` /
    ``prefill_packed_arrays``;
  * ``mixed_step`` runs k chunk slots (in list order) and then the whole
    decode batch in one call; its inputs have one shape per k = 1..the
    engine's slot cap (C-wide chunks, max_model_len-wide chunk tables), the
    closed family a CUDA-graph capture would key on;
  * sampling runs on the device right behind the model step, and the host
    reads a step's results with ONE device-to-host copy (``fetch_sample``,
    or the packed array of ``spec_verify``); ``prefill_chunk``,
    ``prefill_packed_arrays`` and ``mixed_step`` read nothing back: every
    length they need is a host int;
  * ``fused_decode`` runs every decode and verify step (and the decode half
    of a mixed step) through the fused norm+QKV+RoPE and o-proj+residual
    heads (models/llama.py); packed and chunked prefill keep the unfused
    heads, as in the reference;
  * ``kv_dtype="int8"`` makes the paged cache int8-resident (the
    reference's ``DYN_KV_DTYPE=int8``, :181-233): int8 mantissas and one
    f32 scale per (layer, kv head, block), allocated on the device as the
    ops/kv_quant.py container and handed to every attention call, which
    takes the kernels' int8 modes; nothing is read back for it;
  * the repetition / frequency / presence penalties and the min_tokens EOS
    mask run on the device before sampling, as the JAX runner's
    ``_sample_one`` (:475-482), ``_decode_pen_impl`` / ``_decode_eos_impl``
    (:889, :909) and the verify pass (:778, :800-820) apply them; the token
    history goes up only when a lane has penalties.

  * with a ``group`` (parallel/mesh.TPGroup) the runner is one rank of a
    tensor-parallel engine: its params are the rank's Megatron slice, its
    KV pool (and an int8 pool's scale planes) holds the rank's Hkv / tp kv
    heads, and every model call issues the group's collectives, so every
    rank must make the same calls in the same order
    (parallel/multihost.SpmdModelRunner replays the leader's on the
    followers, with the leader's sampling keys);
    ``collective_overlap`` runs the fused decode step's tail as the ring
    decomposition.

Not ported yet: the decode horizon (also after a verify pass),
disaggregated block moves (with their int8 extract / inject), and spec
decode under tensor parallelism.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.ops import kv_quant
from dynamo_tpu_torch.ops.sampling import (
    MAX_EOS_IDS,
    apply_penalties,
    apply_penalties_from_tables,
    apply_repetition_penalty_from_prompt,
    apply_repetition_penalty_packed,
    make_key_data,
    mask_eos_logits,
    penalty_count_tables,
    sample_args,
    sample_tokens_full,
)


def default_prefill_buckets(block_size: int, max_len: int) -> list[int]:
    """Power-of-two padded prompt lengths; every bucket is a whole number of
    KV blocks (prefill scatters whole blocks)."""

    def round_up(n: int) -> int:
        return ((n + block_size - 1) // block_size) * block_size

    buckets = []
    size = block_size
    while size < max_len:
        buckets.append(round_up(size))
        size *= 2
    top = round_up(max_len)
    if not buckets or buckets[-1] != top:
        buckets.append(top)
    return buckets


SampleOut = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class TorchModelRunner:
    # decode defaults draw from a distinct stream id so (stream, counter)
    # rows never collide with prefill's (seed, step) rows (same as JAX)
    _DECODE_STREAM_SALT = 0x9E3779B9

    def __init__(
        self,
        config: llama.LlamaConfig,
        params: Any,
        *,
        num_blocks: int,
        block_size: int,
        max_batch: int,
        max_model_len: int,
        device="cuda",
        rng_seed: int = 0,
        fused_decode: bool = False,
        prefill_chunk_tokens: int = 512,
        kv_dtype: str = "bf16",
        group=None,
        collective_overlap: bool = False,
    ) -> None:
        self.device = resolve_device(device)
        self.group = group
        self.config = dataclasses.replace(
            config, fused_decode=bool(fused_decode) or config.fused_decode,
            collective_overlap=bool(collective_overlap) or config.collective_overlap,
        )
        self.params = params
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.max_batch = max_batch
        self.max_model_len = max_model_len
        self.max_blocks_per_seq = (max_model_len + block_size - 1) // block_size
        self._rng_seed = rng_seed
        self._step_counter = 0
        self._key_offset = 0
        self.prefill_buckets = default_prefill_buckets(block_size, max_model_len)
        # chunk size in whole KV blocks, at most the largest bucket; 0 = off
        chunk = -(-prefill_chunk_tokens // block_size) * block_size
        self.prefill_chunk_tokens = min(chunk, self.prefill_buckets[-1])
        # head-major layout: each (head, page) is a contiguous [bs, D] tile
        # (what the decode kernel streams); the cache takes the embeddings'
        # dtype, or is the int8 + scale container
        kv = kv_dtype.strip().lower()
        if kv not in ("bf16", "bfloat16", "int8"):
            raise ValueError(f"kv_dtype {kv_dtype!r} is neither 'bf16' nor 'int8'")
        self.kv_quantized = kv == "int8"
        tp = 1 if group is None else group.world_size
        shape = (
            config.num_layers, config.num_kv_heads // tp, num_blocks, block_size,
            config.head_dim,
        )
        dtype = params["embed"].dtype
        self.k_cache = kv_quant.make_cache(
            shape, dtype, quantized=self.kv_quantized, device=self.device)
        self.v_cache = kv_quant.make_cache(
            shape, dtype, quantized=self.kv_quantized, device=self.device)

    @property
    def kv_cache_bytes(self) -> int:
        return kv_quant.cache_nbytes(self.k_cache) + kv_quant.cache_nbytes(self.v_cache)

    def _dev(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype), device=self.device)

    def pick_bucket(self, length: int) -> int:
        for b in self.prefill_buckets:
            if b >= length:
                return b
        raise ValueError(
            f"prompt length {length} exceeds max_model_len {self.max_model_len}"
        )

    def _next_key_data(self) -> np.ndarray:
        self._step_counter += 1
        return make_key_data(self._rng_seed, self._step_counter)

    def _next_decode_keys(self, B: int) -> np.ndarray:
        keys = np.stack(
            [
                np.full(B, (self._rng_seed ^ self._DECODE_STREAM_SALT) & 0xFFFFFFFF, np.int64),
                (np.arange(B, dtype=np.int64) + self._key_offset) & 0xFFFFFFFF,
            ],
            axis=1,
        )
        self._key_offset += B
        return keys

    @torch.inference_mode()
    def prefill(
        self,
        token_ids: list[int],
        block_ids: list[int],
        temperature: float,
        top_p: float,
        top_k: int,
        rep_pen: float = 1.0,
        key_data: Optional[np.ndarray] = None,
        eos_ids: Optional[np.ndarray] = None,  # [MAX_EOS_IDS], -1 pads
        eos_suppress: bool = False,  # min_tokens not yet reached
    ) -> SampleOut:
        """Run one prompt (its K/V lands in ``block_ids``); returns
        (token, logprob, top_ids, top_logprobs) device tensors, each with a
        leading batch dim of 1, for the first sampled token, after the
        prompt's repetition penalty and the min_tokens EOS mask."""
        T = len(token_ids)
        bucket = self.pick_bucket(T)
        tokens = np.zeros(bucket, np.int64)
        tokens[:T] = token_ids
        table = np.zeros(bucket // self.block_size, np.int64)
        used = (T + self.block_size - 1) // self.block_size
        table[:used] = block_ids[:used]  # padding blocks go to null block 0
        if key_data is None:
            key_data = self._next_key_data()
        tokens_d = self._dev(tokens, np.int64)
        logits = llama.prefill(
            self.params, self.config, tokens_d, T,
            self.k_cache, self.v_cache, self._dev(table, np.int64), group=self.group,
        )
        return self._sample_first(
            logits, tokens_d, T, key_data, temperature, top_p, top_k, rep_pen,
            eos_ids, eos_suppress,
        )

    def _sample_first(
        self, logits, prompt_d, n_prompt, key_data, temperature, top_p, top_k,
        rep_pen, eos_ids, eos_suppress,
    ) -> SampleOut:
        """The prefill's tail (the JAX ``_sample_one``): the prompt's
        repetition penalty, the min_tokens EOS mask, then the first sample.
        The reference applies both always; they are bitwise no-ops when
        off, so they are skipped then."""
        if rep_pen != 1.0:
            logits = apply_repetition_penalty_from_prompt(logits, prompt_d, n_prompt, rep_pen)
        if eos_suppress and eos_ids is not None:
            logits = mask_eos_logits(
                logits, self._dev(eos_ids, np.int64), torch.tensor(True, device=self.device))
        args = sample_args([temperature], [top_p], [top_k], [key_data], self.device)
        return sample_tokens_full(logits[None], *args, all_greedy=temperature <= 0)

    def _chunk(
        self, token_chunk, chunk_start, total_len, block_ids, table_blocks,
        temperature, top_p, top_k, rep_pen, key_data, eos_ids, eos_suppress,
    ) -> SampleOut:
        """One chunk through the model (its table ``table_blocks`` wide,
        padded with null block 0) and the JAX ``_prefill_chunk_impl`` tail:
        the repetition penalty sees this chunk's tokens only (earlier chunks
        already left the program) -- the reference's documented
        approximation for the first token of a chunked prompt, kept for
        parity; decode steps use the full history."""
        C = self.prefill_chunk_tokens
        n = len(token_chunk)
        tokens = np.zeros(C, np.int64)
        tokens[:n] = token_chunk
        table = np.zeros(table_blocks, np.int64)
        table[: len(block_ids)] = block_ids
        if key_data is None:
            key_data = self._next_key_data()
        tokens_d = self._dev(tokens, np.int64)
        logits = llama.prefill_chunk(
            self.params, self.config, tokens_d, chunk_start, total_len,
            self.k_cache, self.v_cache, self._dev(table, np.int64), group=self.group,
        )
        n_in_chunk = min(max(total_len - chunk_start, 0), C)
        return self._sample_first(
            logits, tokens_d, n_in_chunk, key_data, temperature, top_p, top_k,
            rep_pen, eos_ids, eos_suppress,
        )

    @torch.inference_mode()
    def prefill_chunk(
        self,
        token_chunk: list[int],
        chunk_start: int,  # a multiple of block_size
        total_len: int,
        block_ids: list[int],
        temperature: float,
        top_p: float,
        top_k: int,
        rep_pen: float = 1.0,
        key_data: Optional[np.ndarray] = None,
        eos_ids: Optional[np.ndarray] = None,  # [MAX_EOS_IDS], -1 pads
        eos_suppress: bool = False,
    ) -> SampleOut:
        """One chunk of a chunked prefill; chunks must arrive in order.
        The table is as wide as the prompt's bucket, as in the reference.
        Returns (token, logprob, top_ids, top_logprobs) device tensors, each
        with a leading batch dim of 1, meaningful only on the final
        chunk."""
        return self._chunk(
            token_chunk, chunk_start, total_len, block_ids,
            self.pick_bucket(total_len) // self.block_size,
            temperature, top_p, top_k, rep_pen, key_data, eos_ids, eos_suppress,
        )

    def pack_prefill(self, seqs: list[tuple]) -> dict[str, np.ndarray]:
        """Pure host-side packing for the packed prefill, the JAX runner's
        arrays bit for bit.

        seqs: [(token_ids, block_ids, temp, top_p, top_k, rep_pen,
        key_row [2], eos_row [MAX_EOS_IDS], suppress), ...] with at most
        ``prefill_chunk_tokens`` tokens in all and at most ``max_batch``
        segments. Padding carries segment -1 and writes to null slot 0."""
        P = self.prefill_chunk_tokens
        N = self.max_batch
        bs = self.block_size
        if len(seqs) > N:
            raise ValueError(f"{len(seqs)} segments > max_batch {N}")
        tokens = np.zeros(P, np.int32)
        positions = np.zeros(P, np.int32)
        segment_ids = np.full(P, -1, np.int32)
        slot_indices = np.zeros(P, np.int32)
        last_idx = np.zeros(N, np.int32)
        temps = np.zeros(N, np.float32)
        top_ps = np.ones(N, np.float32)
        top_ks = np.zeros(N, np.int32)
        rep_pens = np.ones(N, np.float32)
        keys = np.zeros((N, 2), np.uint32)
        eos_ids = np.full((N, MAX_EOS_IDS), -1, np.int32)
        eos_suppress = np.zeros(N, bool)
        off = 0
        for i, (tids, bids, te, tp_, tk, rp, kd, er, sup) in enumerate(seqs):
            T = len(tids)
            if off + T > P:
                raise ValueError(f"pack overflow: {off}+{T} > {P}")
            tokens[off:off + T] = tids
            positions[off:off + T] = np.arange(T)
            segment_ids[off:off + T] = i
            t_idx = np.arange(T)
            slot_indices[off:off + T] = (
                np.asarray(bids, np.int64)[t_idx // bs] * bs + t_idx % bs
            )
            last_idx[i] = off + T - 1
            temps[i], top_ps[i], top_ks[i], rep_pens[i] = te, tp_, tk, rp
            keys[i] = kd
            eos_ids[i] = er
            eos_suppress[i] = sup
            off += T
        return dict(
            tokens=tokens, positions=positions, segment_ids=segment_ids,
            slot_indices=slot_indices, last_idx=last_idx, temps=temps,
            top_ps=top_ps, top_ks=top_ks, rep_pens=rep_pens, keys=keys,
            eos_ids=eos_ids, eos_suppress=eos_suppress,
        )

    @torch.inference_mode()
    def prefill_packed_arrays(
        self, tokens, positions, segment_ids, slot_indices, last_idx,
        temps, top_ps, top_ks, rep_pens, keys, eos_ids=None, eos_suppress=None,
    ) -> SampleOut:
        """The packed prefill over ``pack_prefill``'s arrays (the JAX
        ``_prefill_packed_impl``): the model, each segment's prompt
        repetition penalty, the EOS mask, then sampling. Returns (tokens,
        logprobs, top_ids, top_logprobs), each [max_batch]-major; only the
        first len(seqs) rows mean something."""
        tokens_d = self._dev(tokens, np.int64)
        seg_d = self._dev(segment_ids, np.int64)
        logits = llama.prefill_packed(
            self.params, self.config, tokens_d, self._dev(positions, np.int64), seg_d,
            self._dev(slot_indices, np.int64), self.k_cache, self.v_cache,
            self._dev(last_idx, np.int64), group=self.group,
        )
        # both are bitwise no-ops on neutral rows, so they are skipped when
        # every row is neutral
        if (np.asarray(rep_pens) != 1.0).any():
            logits = apply_repetition_penalty_packed(
                logits, tokens_d, seg_d, self._dev(rep_pens, np.float32))
        if eos_suppress is not None and np.asarray(eos_suppress).any():
            logits = mask_eos_logits(
                logits, self._dev(eos_ids, np.int64), self._dev(eos_suppress, bool))
        args = sample_args(temps, top_ps, top_ks, keys, self.device)
        return sample_tokens_full(
            logits, *args, all_greedy=bool((np.asarray(temps) <= 0).all()))

    @torch.inference_mode()
    def mixed_step(
        self,
        chunks: list[tuple],  # (token_chunk, chunk_start, total_len, block_ids,
        # temperature, top_p, top_k, rep_pen, key_data, eos_ids, eos_suppress)
        # per chunk slot
        tokens, positions, block_tables, slot_indices, keys, temps, top_ps, top_ks,
        eos_ids: Optional[np.ndarray] = None,  # [B, MAX_EOS_IDS], -1 pads
        eos_suppress: Optional[np.ndarray] = None,  # [B] bool
    ) -> tuple[tuple[SampleOut, ...], SampleOut]:
        """One mixed step (the JAX ``mixed_step`` / ``_mixed_impl``): the k
        chunk slots first, in list order (two slots of one sequence are
        fine), then the whole decode batch. Every sub-computation touches
        its own KV blocks, so the step equals the separate calls. Chunk
        tables are max_model_len wide, so the inputs take one shape per k.
        The decode half always runs the EOS-masked variant: a neutral row
        (ids -1, suppress False) passes through bitwise. Returns
        (chunk_outs, decode_out): one sample tuple per chunk slot (meaningful
        only on a final chunk) and one for the decode batch."""
        chunk_outs = tuple(
            self._chunk(
                token_chunk, chunk_start, total_len, block_ids, self.max_blocks_per_seq,
                temperature, top_p, top_k, rep_pen, key_data, c_eos_ids, c_sup,
            )
            for (token_chunk, chunk_start, total_len, block_ids, temperature, top_p,
                 top_k, rep_pen, key_data, c_eos_ids, c_sup) in chunks
        )
        B = len(np.asarray(tokens))
        if eos_ids is None:
            eos_ids = np.full((B, MAX_EOS_IDS), -1, np.int64)
        if eos_suppress is None:
            eos_suppress = np.zeros(B, bool)
        d_out = self.decode(
            tokens, positions, block_tables, slot_indices, temps, top_ps, top_ks,
            keys=keys, eos_mask=(eos_ids, eos_suppress),
        )
        return chunk_outs, d_out

    @torch.inference_mode()
    def decode(
        self,
        tokens: np.ndarray,  # [B] token fed this step
        positions: np.ndarray,  # [B] its position
        block_tables: np.ndarray,  # [B, max_blocks_per_seq]
        slot_indices: np.ndarray,  # [B] flat cache slot for its K/V
        temps: np.ndarray,
        top_ps: np.ndarray,
        top_ks: np.ndarray,
        keys: Optional[np.ndarray] = None,  # [B, 2] (stream, counter) rows
        penalties: Optional[tuple] = None,
        # (hist [B, L], hist_len [B], prompt_len [B], freq [B], pres [B],
        # rep [B], eos_ids [B, MAX_EOS_IDS], eos_suppress [B]): penalties
        # from the full history, then the EOS mask
        eos_mask: Optional[tuple] = None,
        # (eos_ids, eos_suppress): min_tokens without penalties, no history
        # upload; ignored when penalties is given
    ) -> SampleOut:
        """One batched decode step. Returns (tokens, logprobs, top_ids,
        top_logprobs) device tensors, batch-major."""
        if keys is None:
            keys = self._next_decode_keys(len(tokens))
        logits = self.decode_logits(tokens, positions, block_tables, slot_indices)
        if penalties is not None:
            hist, hist_len, prompt_len, freq, pres, rep, eos_ids, eos_sup = penalties
            logits = apply_penalties(
                logits, self._dev(hist, np.int64), self._dev(hist_len, np.int64),
                self._dev(prompt_len, np.int64), self._dev(freq, np.float32),
                self._dev(pres, np.float32), self._dev(rep, np.float32),
            )
            eos_mask = (eos_ids, eos_sup)
        if eos_mask is not None:
            logits = mask_eos_logits(
                logits, self._dev(eos_mask[0], np.int64), self._dev(eos_mask[1], bool))
        args = sample_args(temps, top_ps, top_ks, keys, self.device)
        return sample_tokens_full(
            logits, *args, all_greedy=bool((np.asarray(temps) <= 0).all())
        )

    @torch.inference_mode()
    def decode_logits(self, tokens, positions, block_tables, slot_indices) -> torch.Tensor:
        """The model half of ``decode``: one step's logits [B, V] (f32) on
        the device, no sampling (what a check compares between engines)."""
        return llama.decode(
            self.params, self.config,
            self._dev(tokens, np.int64), self._dev(positions, np.int64),
            self.k_cache, self.v_cache,
            self._dev(block_tables, np.int32), self._dev(slot_indices, np.int64),
            group=self.group,
        )

    def shutdown(self) -> None:
        """Release what the runner holds beyond its tensors: nothing on one
        device (a tensor-parallel leader stops its followers here)."""

    @torch.inference_mode()
    def spec_verify(
        self,
        spec_k: int,
        extras: int,
        tokens: np.ndarray,  # [B] last accepted token per lane
        drafts: np.ndarray,  # [B, spec_k] draft tokens (-1 pads)
        draft_len: np.ndarray,  # [B] valid drafts per lane (0 = none)
        positions: np.ndarray,  # [B] position of `tokens`
        block_tables: np.ndarray,  # [B, max_blocks_per_seq], covering every
        # position up to positions + draft_len
        temps: np.ndarray,
        top_ps: np.ndarray,
        top_ks: np.ndarray,
        keys: np.ndarray,  # [B, 2] (stream, counter) rows of position 0
        active: np.ndarray,  # [B] bool
        limit_remaining: np.ndarray,  # [B] tokens the lane may still emit
        min_remaining: Optional[np.ndarray] = None,  # [B] positions whose EOS stays masked
        eos_ids: Optional[np.ndarray] = None,  # [B, MAX_EOS_IDS], -1 pads
        penalties: Optional[tuple] = None,
        # (hist [B, L], hist_len, prompt_len, freq, pres, rep): the
        # history's count tables, advanced by each fed draft token
    ) -> torch.Tensor:
        """Speculative draft-verify dispatch: ONE weight pass
        (llama.decode_verify) scores S = spec_k + 1 positions per lane --
        position 0 re-feeds the last accepted token, 1..draft_len the
        drafts. Every position is sampled with the key the per-token path
        would use, (stream, counter + h), so the emitted stream equals
        non-speculative decoding under greedy and seeded sampling alike.
        Positions past a lane's drafts, and inactive lanes, write their K/V
        to the null slot 0 and come back as token -1. Rejected draft
        positions leave K/V ahead of the accepted frontier; the next fed
        token overwrites it before anything attends to it.

        Position h of a lane masks its EOS ids while h < min_remaining.
        With penalties, position h is penalised from the history plus the
        drafts fed at positions 1..h (a rejected draft only changes
        positions whose outputs the host discards).

        Returns the packed [S, B, 2 + 2 * num_top] f32 device array (token
        or -1, logprob, top ids, top logprobs per position), for one
        device-to-host copy. ``extras`` (decode steps chained after the
        verify pass) must be 0: the horizon is not ported yet."""
        if extras:
            raise NotImplementedError(
                "decode steps chained after the verify pass (the horizon) are "
                "not ported yet"
            )
        if self.group is not None:
            raise NotImplementedError("spec decode under tensor parallelism is not ported yet")
        S = spec_k + 1
        tokens = np.asarray(tokens, np.int64)
        B = tokens.shape[0]
        draft_len = np.asarray(draft_len, np.int64)
        active = np.asarray(active, bool)
        if (active & (draft_len >= np.asarray(limit_remaining))).any():
            raise ValueError("a lane drafts past the tokens it may still emit")
        step = np.arange(S)[None, :]
        valid = active[:, None] & (step <= draft_len[:, None])  # [B, S]
        fed = np.concatenate(
            [tokens[:, None], np.asarray(drafts, np.int64).reshape(B, spec_k)], axis=1
        )
        fed = np.where(valid, fed, 0)  # pads are never embedded as -1
        qpos = np.asarray(positions, np.int64)[:, None] + step
        tables = np.asarray(block_tables, np.int32)
        page = np.minimum(qpos // self.block_size, tables.shape[1] - 1)
        slot = (
            tables[np.arange(B)[:, None], page].astype(np.int64) * self.block_size
            + qpos % self.block_size
        )
        slot = np.where(valid, slot, 0)  # invalid positions hit the null sink
        logits = llama.decode_verify(
            self.params, self.config, self._dev(fed, np.int64),
            self._dev(qpos, np.int64), self.k_cache, self.v_cache,
            self._dev(tables, np.int32), self._dev(slot, np.int64),
        )
        V = logits.shape[-1]
        # EOS masked at position h of a lane while h < min_remaining
        suppress = None
        if min_remaining is not None and eos_ids is not None:
            sup = step < np.asarray(min_remaining, np.int64)[:, None]  # [B, S]
            if sup.any():
                suppress = self._dev(sup, bool)
                eos_d = self._dev(np.asarray(eos_ids).reshape(B, MAX_EOS_IDS), np.int64)
        if penalties is not None:
            hist, hist_len, prompt_len, freq, pres, rep = penalties
            out_counts, seen = penalty_count_tables(
                self._dev(hist, np.int64), self._dev(hist_len, np.int64),
                self._dev(prompt_len, np.int64), V)
            freq, pres, rep = (self._dev(a, np.float32) for a in (freq, pres, rep))
            fed_d = self._dev(fed, np.int64).clamp(0, V - 1)
            adv = self._dev(valid, np.float32)
            rows = []
            for h in range(S):
                if h >= 1:
                    # the draft fed at position h entered the context
                    out_counts = out_counts.scatter_add(1, fed_d[:, h:h + 1], adv[:, h:h + 1])
                    seen = seen.scatter_reduce(1, fed_d[:, h:h + 1], adv[:, h:h + 1], reduce="amax")
                lg = apply_penalties_from_tables(logits[:, h], out_counts, seen, freq, pres, rep)
                if suppress is not None:
                    lg = mask_eos_logits(lg, eos_d, suppress[:, h])
                rows.append(lg)
            logits = torch.stack(rows, dim=1)  # [B, S, V]
        elif suppress is not None:
            logits = mask_eos_logits(
                logits.reshape(B * S, V), eos_d.repeat_interleave(S, dim=0), suppress.reshape(-1))
        # fold S into the batch and sample every position in one pass; the
        # sampler is row-wise, so this equals S single steps
        keys_rep = np.repeat(np.asarray(keys, np.int64), S, axis=0)
        keys_rep[:, 1] = (keys_rep[:, 1] + np.tile(np.arange(S), B)) & 0xFFFFFFFF
        temps_rep = np.repeat(np.asarray(temps, np.float32), S)
        args = sample_args(
            temps_rep, np.repeat(top_ps, S), np.repeat(top_ks, S), keys_rep, self.device
        )
        tok, lp, top_ids, top_lps = sample_tokens_full(
            logits.reshape(B * S, V), *args, all_greedy=bool((temps_rep <= 0).all())
        )
        tok = torch.where(self._dev(valid, bool), tok.reshape(B, S), -1)
        packed = torch.cat(
            [
                tok[..., None].float(),
                lp.reshape(B, S, 1),
                top_ids.reshape(B, S, -1).float(),
                top_lps.reshape(B, S, -1),
            ],
            dim=-1,
        )
        return packed.transpose(0, 1).contiguous()  # [S, B, 2 + 2K]

    def fetch_sample(self, out: SampleOut) -> tuple[np.ndarray, ...]:
        """Bring a sample tuple to the host with ONE device-to-host copy: the
        pieces are packed into one flat f32 tensor on the device (token ids
        < 2^24 are exact in f32) and split back, each in its own dtype."""
        with torch.inference_mode():
            flat = torch.cat([t.reshape(-1).float() for t in out]).cpu().numpy()
        outs, off = [], 0
        for t in out:
            n = t.numel()
            piece = flat[off:off + n].reshape(tuple(t.shape))
            off += n
            outs.append(piece.astype(np.int32 if t.dtype == torch.int32 else np.float32))
        return tuple(outs)
