"""TorchEngine: the worker's continuous-batching loop over a TorchModelRunner.

Counterpart of dynamo_tpu/engine/jax_engine/engine.py (``JaxEngine``), with
the same contract: ``generate(PreprocessedRequest, Context)`` streams
``LLMEngineOutput`` token frames and ends with one frame that carries the
finish reason. It is the JAX engine's loop with chunking off, reduced to:

  * a FIFO waiting queue; a prompt is admitted when a batch lane and its
    blocks (plus a watermark reserve) are free, and prefilled on its own;
  * one batched decode step over every running lane per loop iteration,
    or, with ``spec_k > 0``, one speculative verify dispatch when enough
    lanes carry a draft: an n-gram drafter (drafter.py) proposes up to
    spec_k tokens per lane from its own history, one weight pass scores
    them all, and the host accepts each lane's longest matching prefix plus
    the model's next token (``_collect_drafts`` / ``_spec_decode_phase``,
    after the JAX engine's, without the chained horizon);
  * stop conditions: ``max_tokens`` (default 16), EOS and
    ``stop_token_ids_hidden`` unless ``ignore_eos`` (the stop token itself
    is not streamed), and ``max_model_len``;
  * frequency / presence / repetition penalties and ``min_tokens``, as the
    JAX engine applies them (engine.py:304-345): the runner penalises the
    logits on the device (the history goes up only when a lane has
    penalties) and masks the first MAX_EOS_IDS stop ids until a sequence
    has its minimum; a stop id past those that is still sampled early is
    dropped and redrawn with a fresh key, at most four times;
  * a prompt longer than ``max_model_len`` is refused (``prompt_too_long``);
  * cancellation (``Context.kill`` or the consumer leaving the stream)
    frees the lane and its blocks at the next loop step;
  * when a growing sequence finds no free block, the youngest other running
    sequence is preempted: its blocks are freed and it is re-queued, in
    arrival order, with its generated tokens, which are re-prefilled on
    re-admission (recompute preemption).

Per-token sampling keys are (request seed or engine stream + sequence id,
number of generated tokens), as in the JAX engine, so a seeded request gives
the same tokens whatever the batch around it. Device calls run one at a time
on a single worker thread so the event loop keeps streaming while the card
works.

Left out (ROADMAP.md lists them): packed / chunked / mixed prefill, the
decode horizon, the tiered block manager and KV events, disaggregation, QoS
classes and deadlines, tracing and the watchdog.
"""

from __future__ import annotations

import asyncio
import bisect
import itertools
import logging
from collections.abc import AsyncIterator
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from dynamo_tpu_torch.engine.torch_engine.drafter import make_drafter
from dynamo_tpu_torch.engine.torch_engine.kv_cache import BlockAllocator, OutOfBlocks
from dynamo_tpu_torch.engine.torch_engine.model_runner import TorchModelRunner
from dynamo_tpu_torch.ops.sampling import MAX_EOS_IDS, SAMPLE_CANDIDATES, make_key_data
from dynamo_tpu_torch.protocols.common import (
    Context,
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
)

logger = logging.getLogger("dynamo_tpu_torch.engine")


@dataclass
class TorchEngineConfig:
    max_batch: int = 8
    block_size: int = 16
    num_blocks: int = 512
    max_model_len: int = 2048
    watermark_blocks: int = 8  # admission reserve
    rng_seed: int = 0
    # self-drafting speculative decoding (0 = off): up to spec_k drafted
    # tokens per lane, verified in one weight pass (runner.spec_verify)
    spec_k: int = 0
    spec_drafter: str = "ngram"
    spec_ngram_min: int = 2
    spec_ngram_max: int = 4
    # least fraction of active lanes with a draft for a verify dispatch to
    # replace a plain decode step
    spec_min_coverage: float = 0.5


@dataclass
class EngineStats:
    prefills: int = 0  # prefill calls (re-prefills after preemption included)
    decode_steps: int = 0  # batched decode calls
    generated_tokens: int = 0
    preemptions: int = 0
    # speculative decoding: a "draft" is one lane-dispatch carrying >= 1
    # proposed token; verify_steps counts verify dispatches
    num_drafts: int = 0
    num_draft_tokens: int = 0
    num_accepted_tokens: int = 0
    accepted_per_pos: list = field(default_factory=list)  # len spec_k
    verify_steps: int = 0


class _Sequence:
    def __init__(self, seq_id: int, request: PreprocessedRequest, ctx: Context) -> None:
        self.seq_id = seq_id
        self.request = request
        self.ctx = ctx
        self.token_ids = list(request.token_ids)  # prompt + generated
        self.num_prompt = len(self.token_ids)
        self.block_ids: list[int] = []
        self.slot: Optional[int] = None
        self.arrival_order = 0
        self.out: asyncio.Queue = asyncio.Queue()
        self.eos: set[int] = set()
        if not request.stop.ignore_eos:
            self.eos = set(request.eos_token_ids) | set(request.stop.stop_token_ids_hidden)
        s = request.sampling
        self.temperature = 0.0 if s.greedy else (
            s.temperature if s.temperature is not None else 1.0
        )
        self.top_p = s.top_p if s.top_p is not None else 1.0
        # the sampler draws restricted rows from a SAMPLE_CANDIDATES pool
        self.top_k = min(s.top_k if s.top_k is not None else 0, SAMPLE_CANDIDATES)
        self.max_new = request.stop.max_tokens or 16
        self.min_tokens = request.stop.min_tokens or 0
        self.freq_pen = float(s.frequency_penalty or 0.0)
        self.pres_pen = float(s.presence_penalty or 0.0)
        self.rep_pen = float(s.repetition_penalty or 1.0) or 1.0
        self.has_penalties = bool(self.freq_pen or self.pres_pen or self.rep_pen != 1.0)
        self.seed = s.seed
        self.want_logprobs = bool(s.logprobs)
        self.num_top_lp = min(int(s.top_logprobs or 0), 20)
        # min_tokens: the first MAX_EOS_IDS sorted stop ids are masked on the
        # device until the minimum is generated
        self.eos_row = np.full(MAX_EOS_IDS, -1, np.int64)
        for j, t in enumerate(sorted(self.eos)[:MAX_EOS_IDS]):
            self.eos_row[j] = t
        self.eos_drops = 0  # early stop ids past the mask, dropped and redrawn
        # spec decoding: consecutive fully rejected drafts, and dispatches
        # left before this lane drafts again
        self.spec_fail = 0
        self.spec_backoff = 0

    @property
    def num_generated(self) -> int:
        return len(self.token_ids) - self.num_prompt

    @property
    def needs_eos_suppress(self) -> bool:
        return self.min_tokens > 0 and self.num_generated < self.min_tokens and bool(self.eos)

    def blocks_needed(self, block_size: int) -> int:
        return (len(self.token_ids) + block_size - 1) // block_size


class TorchEngine:
    """AsyncEngine over a TorchModelRunner (see the module docstring)."""

    def __init__(
        self, runner: TorchModelRunner, config: Optional[TorchEngineConfig] = None
    ) -> None:
        self.runner = runner
        self.config = config or TorchEngineConfig(
            max_batch=runner.max_batch,
            block_size=runner.block_size,
            num_blocks=runner.num_blocks,
            max_model_len=runner.max_model_len,
        )
        self.allocator = BlockAllocator(self.config.num_blocks)
        self.slots: list[Optional[_Sequence]] = [None] * self.config.max_batch
        self.waiting: list[_Sequence] = []
        self.stats = EngineStats()
        self._seq_ids = itertools.count(1)
        self._arrivals = itertools.count(1)
        self._admit_order: list[_Sequence] = []  # youngest last, for preemption
        self._loop_task: Optional[asyncio.Task] = None
        self._wake = asyncio.Event()
        self._closed = False
        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="torch-engine")
        # persistent host-side decode arrays
        B = self.config.max_batch
        self._tokens = np.zeros(B, np.int64)
        self._positions = np.zeros(B, np.int64)
        self._block_tables = np.zeros((B, runner.max_blocks_per_seq), np.int32)
        self._slot_indices = np.zeros(B, np.int64)
        self._temps = np.zeros(B, np.float32)
        self._top_ps = np.ones(B, np.float32)
        self._top_ks = np.zeros(B, np.int64)
        self._keys = np.zeros((B, 2), np.int64)
        # unseeded sequences draw from (engine seed base + seq_id) streams
        self._seed_base = (self.config.rng_seed ^ 0x9E3779B9) & 0x7FFFFFFF
        self.drafter = None
        if self.config.spec_k > 0:
            self.drafter = make_drafter(
                self.config.spec_drafter, self.config.spec_k,
                min_n=self.config.spec_ngram_min, max_n=self.config.spec_ngram_max,
            )
            self.stats.accepted_per_pos = [0] * self.config.spec_k

    # --------------------------------------------------------------- api

    async def generate(
        self, request: PreprocessedRequest, context: Context
    ) -> AsyncIterator[LLMEngineOutput]:
        if self._closed:
            yield LLMEngineOutput.final_error(
                context.id, "admission", "engine is closed", "worker_unavailable"
            )
            return
        n = len(request.token_ids)
        if n == 0:
            yield LLMEngineOutput.final_error(
                context.id, "admission", "empty prompt", "invalid_request"
            )
            return
        if n > self.config.max_model_len:
            yield LLMEngineOutput.final_error(
                context.id, "admission",
                f"prompt of {n} tokens exceeds max_model_len {self.config.max_model_len}",
                "prompt_too_long",
            )
            return
        seq = _Sequence(next(self._seq_ids), request, context)
        self._enqueue(seq)
        self._ensure_loop()
        self._wake.set()
        try:
            while True:
                item = await seq.out.get()
                yield item
                if item.finish_reason is not None:
                    return
        finally:
            # consumer went away (or the stream ended): let the loop reap it
            context.kill()
            self._wake.set()

    async def close(self) -> None:
        self._closed = True
        self._wake.set()
        if self._loop_task is not None:
            await asyncio.gather(self._loop_task, return_exceptions=True)
        self._executor.shutdown(wait=True)

    # ---------------------------------------------------------- schedule

    def _enqueue(self, seq: _Sequence) -> None:
        if not seq.arrival_order:
            seq.arrival_order = next(self._arrivals)
        # a preempted sequence keeps its arrival number: back at the head
        bisect.insort(self.waiting, seq, key=lambda s: s.arrival_order)

    def _ensure_loop(self) -> None:
        if self._loop_task is None or self._loop_task.done():
            self._loop_task = asyncio.get_running_loop().create_task(self._engine_loop())

    def _key_row(self, seq: _Sequence) -> np.ndarray:
        stream = seq.seed if seq.seed is not None else self._seed_base + seq.seq_id
        # dropped early stop ids ride the high counter bits, so a redraw uses
        # a fresh key (generation counters stay far below 2^16)
        return make_key_data(stream, seq.num_generated + (seq.eos_drops << 16))

    def _free_seq(self, seq: _Sequence) -> None:
        if seq.slot is not None:
            self.slots[seq.slot] = None
            seq.slot = None
        if seq.block_ids:
            self.allocator.free(seq.block_ids)
            seq.block_ids = []
        if seq in self._admit_order:
            self._admit_order.remove(seq)

    def _finish(self, seq: _Sequence, reason: FinishReason) -> None:
        self._free_seq(seq)
        seq.out.put_nowait(LLMEngineOutput.final(reason))

    def _try_admit(self, seq: _Sequence) -> bool:
        free_slots = [i for i, s in enumerate(self.slots) if s is None]
        if not free_slots:
            return False
        need = seq.blocks_needed(self.config.block_size)
        if self.allocator.free_count < need + self.config.watermark_blocks:
            return False
        seq.block_ids = self.allocator.alloc(need)
        seq.slot = free_slots[0]
        self.slots[seq.slot] = seq
        self._admit_order.append(seq)
        return True

    def _preempt(self, victim: _Sequence) -> None:
        """Recompute preemption: drop the victim's KV and re-queue it with
        its generated tokens (re-prefilled on re-admission)."""
        logger.debug("preempting seq %d", victim.seq_id)
        self.stats.preemptions += 1
        self._free_seq(victim)
        self._enqueue(victim)

    async def _device(self, fn):
        """Run one device call (and its host fetch) on the worker thread."""
        return await asyncio.get_running_loop().run_in_executor(self._executor, fn)

    # ---------------------------------------------------------- main loop

    async def _engine_loop(self) -> None:
        try:
            while not self._closed:
                self._reap_cancelled()
                admitted = await self._admit_phase()
                active = [s for s in self.slots if s is not None]
                if not active:
                    if not self.waiting:
                        self._wake.clear()
                        await self._wake.wait()
                    else:
                        await asyncio.sleep(0.001)  # backlog waits for blocks
                    continue
                await self._decode_phase(active)
                if not admitted:
                    await asyncio.sleep(0)  # fairness for the stream consumers
        except Exception as e:
            logger.exception("engine loop crashed")
            for seq in [s for s in self.slots if s is not None] + list(self.waiting):
                self._free_seq(seq)
                seq.out.put_nowait(LLMEngineOutput.final_error(
                    seq.ctx.id, "decode", f"{type(e).__name__}: {e}", "engine_loop_crash"
                ))
            self.waiting.clear()
            raise

    def _reap_cancelled(self) -> None:
        for seq in list(self.waiting):
            if seq.ctx.is_killed() or seq.ctx.is_stopped():
                self.waiting.remove(seq)
                seq.out.put_nowait(LLMEngineOutput.final(FinishReason.CANCELLED))
        for seq in list(self._admit_order):
            if seq.ctx.is_killed():
                self._finish(seq, FinishReason.CANCELLED)

    async def _admit_phase(self) -> bool:
        admitted = False
        while self.waiting:
            seq = self.waiting[0]
            if not self._try_admit(seq):
                break
            self.waiting.pop(0)
            admitted = True
            replay = list(seq.token_ids)  # after preemption: prompt + generated
            key_row = self._key_row(seq)
            runner = self.runner
            eos_suppress = seq.needs_eos_suppress
            sample = await self._device(
                lambda: runner.fetch_sample(runner.prefill(
                    replay, seq.block_ids, seq.temperature, seq.top_p,
                    seq.top_k, rep_pen=seq.rep_pen, key_data=key_row,
                    eos_ids=seq.eos_row, eos_suppress=eos_suppress,
                ))
            )
            self.stats.prefills += 1
            if seq.slot is None:  # cancelled during the device call
                continue
            tok, lp, tids, tlps = sample
            self._append_token(seq, int(tok[0]), float(lp[0]), tids[0], tlps[0])
        return admitted

    def _lane_remaining(self, seq: _Sequence) -> int:
        """Tokens this lane may still emit (max_new and model-length caps)."""
        return max(1, min(
            seq.max_new - seq.num_generated,
            self.config.max_model_len - len(seq.token_ids),
        ))

    def _clear_lanes(self) -> None:
        self._block_tables.fill(0)
        self._positions.fill(0)
        self._tokens.fill(0)
        self._slot_indices.fill(0)  # null block slot 0
        self._temps.fill(0.0)
        self._top_ps.fill(1.0)
        self._top_ks.fill(0)

    def _fill_lane(self, seq: _Sequence) -> int:
        """Write one active lane's per-step inputs into the batch arrays;
        returns the position of the token being fed."""
        i = seq.slot
        pos = len(seq.token_ids) - 1
        self._tokens[i] = seq.token_ids[-1]
        self._positions[i] = pos
        self._block_tables[i, : len(seq.block_ids)] = seq.block_ids
        self._temps[i] = seq.temperature
        self._top_ps[i] = seq.top_p
        self._top_ks[i] = seq.top_k
        self._keys[i] = self._key_row(seq)
        return pos

    async def _decode_phase(self, active: list[_Sequence]) -> None:
        if self.drafter is not None:
            drafts = self._collect_drafts(active)
            if drafts is not None:
                await self._spec_decode_phase(active, drafts)
                return
        await self._decode_single_phase(active)

    def _eos_rows(self, active: list[_Sequence]) -> tuple[np.ndarray, np.ndarray]:
        """Each lane's stop-id row and whether its EOS is masked this step."""
        B = self.config.max_batch
        eos_ids = np.full((B, MAX_EOS_IDS), -1, np.int64)
        eos_sup = np.zeros(B, bool)
        for seq in active:
            eos_ids[seq.slot] = seq.eos_row
            eos_sup[seq.slot] = seq.needs_eos_suppress
        return eos_ids, eos_sup

    def _penalty_rows(self, active: list[_Sequence]) -> tuple[np.ndarray, ...]:
        """(hist, hist_len, prompt_len, freq, pres, rep) of every lane, the
        history padded to max_model_len."""
        B, L = self.config.max_batch, self.config.max_model_len
        hist = np.zeros((B, L), np.int64)
        hist_len = np.zeros(B, np.int64)
        prompt_len = np.zeros(B, np.int64)
        freq = np.zeros(B, np.float32)
        pres = np.zeros(B, np.float32)
        rep = np.ones(B, np.float32)
        for seq in active:
            i = seq.slot
            n = min(len(seq.token_ids), L)
            hist[i, :n] = seq.token_ids[:n]
            hist_len[i] = n
            prompt_len[i] = min(seq.num_prompt, n)
            freq[i], pres[i], rep[i] = seq.freq_pen, seq.pres_pen, seq.rep_pen
        return hist, hist_len, prompt_len, freq, pres, rep

    async def _decode_single_phase(self, active: list[_Sequence]) -> None:
        bs = self.config.block_size
        self._clear_lanes()
        for seq in active:
            pos = self._fill_lane(seq)
            self._slot_indices[seq.slot] = seq.block_ids[pos // bs] * bs + pos % bs
        # the history goes up only when a lane has penalties; a min_tokens
        # lane alone needs only the stop-id rows
        penalties = eos_mask = None
        if any(s.has_penalties for s in active):
            penalties = (*self._penalty_rows(active), *self._eos_rows(active))
        elif any(s.needs_eos_suppress for s in active):
            eos_mask = self._eos_rows(active)
        runner = self.runner
        args = (
            self._tokens.copy(), self._positions.copy(), self._block_tables.copy(),
            self._slot_indices.copy(), self._temps.copy(), self._top_ps.copy(),
            self._top_ks.copy(), self._keys.copy(),
        )
        toks, lps, tids, tlps = await self._device(
            lambda: runner.fetch_sample(runner.decode(
                *args[:7], keys=args[7], penalties=penalties, eos_mask=eos_mask))
        )
        self.stats.decode_steps += 1
        for seq in active:
            if seq.slot is None:
                continue  # finished, cancelled or preempted meanwhile
            i = seq.slot
            self._append_token(seq, int(toks[i]), float(lps[i]), tids[i], tlps[i])

    def _collect_drafts(self, active: list[_Sequence]) -> Optional[dict[int, list[int]]]:
        """Host drafting pass: seq_id -> proposed continuation tokens, or
        None for a plain decode step (no lane drafted, or fewer than
        ``spec_min_coverage`` of them, or a min_tokens lane holds more stop
        ids than the device mask: its early stop ids need a redraw per
        token, as in the JAX engine)."""
        if any(s.needs_eos_suppress and len(s.eos) > MAX_EOS_IDS for s in active):
            return None
        out: dict[int, list[int]] = {}
        for seq in active:
            if seq.spec_backoff > 0:
                seq.spec_backoff -= 1
                out[seq.seq_id] = []
                continue
            # the verify pass emits one token past the accepted drafts: cap
            # the drafts so the lane's writes stay inside its budget
            cap = min(self.config.spec_k, self._lane_remaining(seq) - 1)
            out[seq.seq_id] = self.drafter.draft(seq.token_ids, cap) if cap > 0 else []
        drafted = sum(1 for d in out.values() if d)
        need = max(1, int(np.ceil(self.config.spec_min_coverage * len(active))))
        return out if drafted >= need else None

    async def _spec_decode_phase(
        self, active: list[_Sequence], drafts: dict[int, list[int]]
    ) -> None:
        """One verify dispatch, then host-side accept: each lane's samples
        go in order through ``_append_token`` (streaming, stops and block
        growth as on every other step) and the lane stops at its first
        draft mismatch. Every emitted token is the model's own sample; the
        draft only decides how many weight passes those tokens cost."""
        B = self.config.max_batch
        K = self.config.spec_k
        bs = self.config.block_size
        # blocks for every write of this dispatch: the last emitted token is
        # not fed, so the writes reach lane_steps - 1 positions past the fed
        # one; under block pressure a plain step (its allocation preempts)
        for seq in active:
            lane_steps = min(len(drafts[seq.seq_id]) + 1, self._lane_remaining(seq))
            need = (len(seq.token_ids) - 1 + lane_steps - 1) // bs + 1 - len(seq.block_ids)
            if need > 0:
                try:
                    seq.block_ids.extend(self.allocator.alloc(need))
                except OutOfBlocks:
                    await self._decode_single_phase(active)
                    return
        self._clear_lanes()
        act = np.zeros(B, bool)
        limit_rem = np.ones(B, np.int64)
        min_rem = np.zeros(B, np.int64)
        draft_arr = np.full((B, K), -1, np.int64)
        draft_len = np.zeros(B, np.int64)
        eos_ids, _ = self._eos_rows(active)
        for seq in active:
            i = seq.slot
            self._fill_lane(seq)
            act[i] = True
            limit_rem[i] = self._lane_remaining(seq)
            min_rem[i] = max(0, seq.min_tokens - seq.num_generated)
            d = drafts[seq.seq_id]
            draft_len[i] = len(d)
            if d:
                draft_arr[i, : len(d)] = d
                self.stats.num_drafts += 1
                self.stats.num_draft_tokens += len(d)
        # penalties ride the verify positions: one history upload per dispatch
        penalties = (
            self._penalty_rows(active) if any(s.has_penalties for s in active) else None
        )
        runner = self.runner
        args = (
            self._tokens.copy(), draft_arr, draft_len, self._positions.copy(),
            self._block_tables.copy(), self._temps.copy(), self._top_ps.copy(),
            self._top_ks.copy(), self._keys.copy(), act, limit_rem, min_rem, eos_ids,
        )
        # one device-to-host copy of the packed [S, B, 2 + 2K] samples
        packed = await self._device(
            lambda: runner.spec_verify(K, 0, *args, penalties=penalties).cpu().numpy())
        self.stats.verify_steps += 1
        n_top = (packed.shape[-1] - 2) // 2
        for seq in active:
            if seq.slot is None:
                continue
            i = seq.slot
            d = drafts[seq.seq_id]
            accepted = 0
            for h in range(len(d) + 1):
                row = packed[h, i]
                tok = int(row[0])
                if tok < 0:
                    break  # the device marked the position invalid
                accept = h < len(d) and d[h] == tok
                self._append_token(
                    seq, tok, float(row[1]), row[2:2 + n_top].astype(np.int32),
                    row[2 + n_top:],
                )
                if accept:
                    accepted += 1
                    self.stats.num_accepted_tokens += 1
                    self.stats.accepted_per_pos[h] += 1
                if seq.slot is None or not accept:
                    break
            if d:
                if accepted:
                    seq.spec_fail = 0
                else:
                    # the history stopped predicting: back off this lane's
                    # drafting exponentially
                    seq.spec_fail += 1
                    seq.spec_backoff = min(1 << seq.spec_fail, 32)

    def _append_token(self, seq: _Sequence, token: int, lp: float, top_ids, top_lps) -> None:
        """Record a newly generated token: stream it, grow blocks, stop."""
        self.stats.generated_tokens += 1
        if seq.ctx.is_stopped():
            self._finish(seq, FinishReason.CANCELLED)
            return
        if token in seq.eos:
            if seq.num_generated >= seq.min_tokens:
                self._finish(seq, FinishReason.EOS)  # the stop token stays hidden
                return
            # min_tokens not reached, yet a stop id past the device mask's
            # MAX_EOS_IDS was sampled: drop it and redraw next step with a
            # fresh key (_key_row); a greedy lane may repeat it, so finish
            # after a few drops
            seq.eos_drops += 1
            if seq.eos_drops > 4:
                self._finish(seq, FinishReason.EOS)
            return
        seq.token_ids.append(token)
        out = LLMEngineOutput(token_ids=[token])
        if seq.want_logprobs:
            out.log_probs = [lp]
            k = seq.num_top_lp
            if k:
                out.top_logprobs = [
                    [[int(t), float(v)] for t, v in zip(top_ids[:k], top_lps[:k])]
                ]
        seq.out.put_nowait(out)
        if (
            seq.num_generated >= seq.max_new
            or len(seq.token_ids) >= self.config.max_model_len
        ):
            self._finish(seq, FinishReason.LENGTH)
            return
        # the NEXT decode step writes KV at position len-1; allocate its
        # block just in time when the sequence crosses a block boundary
        if (len(seq.token_ids) - 1) // self.config.block_size >= len(seq.block_ids):
            try:
                seq.block_ids.extend(self.allocator.alloc(1))
            except OutOfBlocks:
                victim = next(
                    (v for v in reversed(self._admit_order) if v is not seq), None
                )
                if victim is not None:
                    self._preempt(victim)
                    seq.block_ids.extend(self.allocator.alloc(1))
                else:
                    self._free_seq(seq)
                    seq.out.put_nowait(LLMEngineOutput.final_error(
                        seq.ctx.id, "decode",
                        "out of KV blocks with no preemptable sequence",
                        "out_of_kv_blocks",
                    ))
