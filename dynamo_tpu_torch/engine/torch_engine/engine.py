"""TorchEngine: the worker's continuous-batching loop over a TorchModelRunner.

Counterpart of dynamo_tpu/engine/jax_engine/engine.py (``JaxEngine``), with
the same contract: ``generate(PreprocessedRequest, Context)`` streams
``LLMEngineOutput`` token frames and ends with one frame that carries the
finish reason. It is the JAX engine's single-worker loop with its defaults,
reduced to:

  * a FIFO waiting queue; a prompt is admitted when a batch lane and its
    blocks (plus a watermark reserve) are free. With chunking on (the
    runner's ``prefill_chunk_tokens`` C > 0, the default), admission routes
    as ``JaxEngine._admit_phase`` does: a prompt (or, after a preemption,
    prompt + generated tokens) longer than C is prefilled chunk by chunk,
    and shorter ones are packed greedily, up to C tokens and ``max_batch``
    segments, into one packed prefill per group. With C = 0 every prompt
    is prefilled on its own (the reference's chunking-off path);
  * per loop iteration, with prompts still being chunked and decode lanes
    running, one mixed step (``DYN_MIXED_STEP``, on by default) carries up
    to ``chunk_budget`` prompt tokens (``DYN_CHUNK_BUDGET``; 0 means 2 x C)
    in at most ceil(budget / C) chunk slots together with the whole decode
    batch. Mixing is off while a drafter is active or a lane has penalties;
    then one chunk runs on its own, followed by the decode step. A chunk's
    sample is read back only on the prompt's final chunk;
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
    frees the lane and its blocks at the next loop step, also mid-chunk;
  * when a growing sequence finds no free block, the youngest other running
    sequence (one still being chunked included) is preempted: its blocks
    are freed and it is re-queued, in arrival order, with its generated
    tokens, which are re-prefilled on re-admission (recompute preemption).

A ``chunk_budget`` that is not a multiple of the KV block size raises: the
reference slices chunks by the remaining budget, so such a budget would
start a chunk off a block boundary and scatter its K/V to the wrong
positions.

Per-token sampling keys are (request seed or engine stream + sequence id,
number of generated tokens), as in the JAX engine, so a seeded request gives
the same tokens whatever the batch around it. Device calls run one at a time
on a single worker thread so the event loop keeps streaming while the card
works.

Left out (ROADMAP.md lists them): the decode horizon, the tiered block
manager, prefix onboarding and KV events, disaggregation, multimodal
prompts, QoS classes, deadlines and brownout, tracing and the watchdog.
"""

from __future__ import annotations

import asyncio
import bisect
import itertools
import logging
import os
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
    # prompt tokens that may ride one mixed step, over all its chunk slots;
    # 0 = two chunks' worth. A multiple of block_size.
    chunk_budget: int = field(
        default_factory=lambda: int(os.environ.get("DYN_CHUNK_BUDGET", "0") or 0)
    )
    # mixed steps (chunks inside the decode batch's step); off alternates a
    # chunk and a decode step, with the same output streams
    mixed_step: bool = field(
        default_factory=lambda: os.environ.get("DYN_MIXED_STEP", "1").lower()
        not in ("0", "false", "no", "off")
    )


def check_chunk_budget(chunk_budget: int, block_size: int) -> None:
    """A mixed step slices chunks by the budget left, so a budget off the
    block grid would start a chunk mid-block."""
    if chunk_budget > 0 and chunk_budget % block_size:
        raise ValueError(
            f"chunk_budget (DYN_CHUNK_BUDGET) {chunk_budget} is not a multiple of "
            f"the KV block size {block_size}: a chunk would start off a block "
            "boundary and its K/V would land at the wrong positions"
        )


@dataclass
class EngineStats:
    prefills: int = 0  # per-sequence prefill calls (re-prefills after preemption included)
    packed_prefills: int = 0  # packed prefill calls
    chunk_steps: int = 0  # prefill chunks run on their own
    mixed_steps: int = 0  # mixed steps (chunk slots + the decode batch)
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
        self.prefilling = False  # admitted, chunked prefill in progress
        self.prefill_pos = 0  # tokens chunked so far
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
        check_chunk_budget(self.config.chunk_budget, self.config.block_size)
        self.allocator = BlockAllocator(self.config.num_blocks)
        self.slots: list[Optional[_Sequence]] = [None] * self.config.max_batch
        self.waiting: list[_Sequence] = []
        self.stats = EngineStats()
        self._seq_ids = itertools.count(1)
        self._arrivals = itertools.count(1)
        self._admit_order: list[_Sequence] = []  # youngest last, for preemption
        # admitted prompts being prefilled one chunk at a time
        self._prefilling: list[_Sequence] = []
        # per-step prompt-token budget of a mixed step and its chunk-slot cap
        C = runner.prefill_chunk_tokens
        budget = self.config.chunk_budget if self.config.chunk_budget > 0 else 2 * C
        self._chunk_budget = budget
        self._mixed_max_slots = max(1, -(-budget // C)) if C else 0
        self._mixed_enabled = self.config.mixed_step and C > 0
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
        # a tensor-parallel leader stops its followers here
        self.runner.shutdown()

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
        if seq in self._prefilling:
            self._prefilling.remove(seq)
        seq.prefilling = False
        seq.prefill_pos = 0  # a preempted sequence re-prefills from scratch

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
                if self._prefilling:
                    active = self._decode_lanes()
                    if active and self._can_mix(active):
                        # every decode lane and up to the budget of prompt
                        # tokens in one step
                        await self._mixed_step_phase(active)
                        if not admitted:
                            await asyncio.sleep(0)
                        continue
                # else at most one chunk per iteration, so the decode step
                # below never waits longer than one chunk
                chunked = False
                if self._prefilling:
                    await self._prefill_chunk_step()
                    chunked = True
                active = self._decode_lanes()
                if not active:
                    if chunked:
                        continue
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

    def _decode_lanes(self) -> list[_Sequence]:
        return [s for s in self.slots if s is not None and not s.prefilling]

    def _reap_cancelled(self) -> None:
        for seq in list(self.waiting):
            if seq.ctx.is_killed() or seq.ctx.is_stopped():
                self.waiting.remove(seq)
                seq.out.put_nowait(LLMEngineOutput.final(FinishReason.CANCELLED))
        for seq in list(self._admit_order):
            if seq.ctx.is_killed():
                self._finish(seq, FinishReason.CANCELLED)

    async def _admit_phase(self) -> bool:
        """Admit from the head of the queue while a lane and blocks are free
        (``JaxEngine._admit_phase``, engine.py:1549-1760). Not ported, and
        so not branched on here: the block manager's prefix lookup and
        onboarding (ROADMAP A7), remote prefill (A12), multimodal prompts
        (A11) and QoS re-admission backoff (A7)."""
        admitted = False
        C = self.runner.prefill_chunk_tokens
        to_pack: list[_Sequence] = []
        while self.waiting:
            seq = self.waiting[0]
            if not self._try_admit(seq):
                break
            self.waiting.pop(0)
            admitted = True
            # after a preemption the replay is prompt + generated tokens
            if C and len(seq.token_ids) > C:
                seq.prefilling = True
                seq.prefill_pos = 0
                self._prefilling.append(seq)
            elif C:
                to_pack.append(seq)
            else:
                await self._run_prefill(seq)
        # greedily fill each packed prefill up to C tokens and max_batch
        # segments, one call per group
        while to_pack:
            group, total = [], 0
            while (
                to_pack
                and total + len(to_pack[0].token_ids) <= C
                and len(group) < self.config.max_batch
            ):
                s = to_pack.pop(0)
                if s.slot is None:  # preempted by an earlier group's growth
                    continue
                group.append(s)
                total += len(s.token_ids)
            if group:
                await self._run_packed_prefill(group)
        return admitted

    async def _run_prefill(self, seq: _Sequence) -> None:
        """One prompt prefilled on its own (chunking off)."""
        replay = list(seq.token_ids)
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
            return
        tok, lp, tids, tlps = sample
        self._append_token(seq, int(tok[0]), float(lp[0]), tids[0], tlps[0])

    async def _run_packed_prefill(self, group: list[_Sequence]) -> None:
        """Short prompts packed into one prefill (engine.py:1771)."""
        specs = [
            (
                list(s.token_ids), s.block_ids, s.temperature, s.top_p, s.top_k,
                s.rep_pen, self._key_row(s), s.eos_row, s.needs_eos_suppress,
            )
            for s in group
        ]
        runner = self.runner
        packed = runner.pack_prefill(specs)
        toks, lps, tids, tlps = await self._device(
            lambda: runner.fetch_sample(runner.prefill_packed_arrays(**packed)))
        self.stats.packed_prefills += 1
        for i, seq in enumerate(group):
            if seq.slot is None:  # preempted by an earlier segment's growth
                continue
            self._append_token(seq, int(toks[i]), float(lps[i]), tids[i], tlps[i])

    async def _prefill_chunk_step(self) -> None:
        """One chunk of the oldest prompt being chunked, on its own
        (engine.py:1804). Only the final chunk's sample is read back; the
        earlier chunks are queued on the card without a wait."""
        seq = self._prefilling[0]
        C = self.runner.prefill_chunk_tokens
        start = seq.prefill_pos
        total = len(seq.token_ids)
        chunk = seq.token_ids[start:start + C]
        final = start + C >= total
        key_row = self._key_row(seq)
        runner = self.runner
        eos_suppress = seq.needs_eos_suppress

        def run_chunk():
            out = runner.prefill_chunk(
                chunk, start, total, seq.block_ids, seq.temperature, seq.top_p,
                seq.top_k, rep_pen=seq.rep_pen, key_data=key_row,
                eos_ids=seq.eos_row, eos_suppress=eos_suppress,
            )
            return runner.fetch_sample(out) if final else None

        sample = await self._device(run_chunk)
        self.stats.chunk_steps += 1
        if seq.slot is None:  # cancelled during the device call
            return
        seq.prefill_pos = min(start + C, total)
        if seq.prefill_pos >= total:
            self._prefilling.remove(seq)
            seq.prefilling = False
            tok, lp, tids, tlps = sample
            self._append_token(seq, int(tok[0]), float(lp[0]), tids[0], tlps[0])

    def _can_mix(self, active: list[_Sequence]) -> bool:
        """Whether one mixed step can replace this iteration's chunk and
        decode step (engine.py:1853): not while a drafter is active (the
        port has no brownout pause of drafting), nor when a lane has
        penalties, whose full-history program the mixed step does not
        carry. (The port has no decode horizon, the reference's third
        gate.) Read-only: it must not touch the drafter."""
        if not self._mixed_enabled or self.drafter is not None:
            return False
        return not any(s.has_penalties for s in active)

    async def _mixed_step_phase(self, active: list[_Sequence]) -> None:
        """One step for the whole iteration (engine.py:1870-1990): every
        decode lane plus prompt chunks, oldest prompt first, up to the
        budget and the slot cap (several chunks of one prompt, or chunks of
        several prompts, may share a step). One device-to-host copy brings
        back the decode samples with the samples of every chunk that ends
        its prompt."""
        C = self.runner.prefill_chunk_tokens
        budget = self._chunk_budget
        chunks: list[tuple] = []
        packed: list[tuple[_Sequence, int, int]] = []  # (seq, start, n)
        plan: list[tuple[_Sequence, int]] = []  # tokens each sequence advances
        for seq in sorted(self._prefilling, key=lambda s: s.arrival_order):
            if budget <= 0 or len(chunks) >= self._mixed_max_slots:
                break
            total = len(seq.token_ids)
            pos = seq.prefill_pos
            advanced = 0
            key_row = self._key_row(seq)
            while pos < total and budget > 0 and len(chunks) < self._mixed_max_slots:
                # the budget is a multiple of the block size, so every chunk
                # but a prompt's last starts and ends on a block boundary
                n = min(C, total - pos, budget)
                chunks.append((
                    seq.token_ids[pos:pos + n], pos, total, seq.block_ids,
                    seq.temperature, seq.top_p, seq.top_k, seq.rep_pen, key_row,
                    seq.eos_row, seq.needs_eos_suppress,
                ))
                packed.append((seq, pos, n))
                pos += n
                budget -= n
                advanced += n
            if advanced:
                plan.append((seq, advanced))
        # decode lanes: single-step semantics, and always the EOS-masked
        # variant (neutral rows are a bitwise no-op)
        bs = self.config.block_size
        self._clear_lanes()
        for seq in active:
            pos = self._fill_lane(seq)
            self._slot_indices[seq.slot] = seq.block_ids[pos // bs] * bs + pos % bs
        eos_ids, eos_sup = self._eos_rows(active)
        final_slots = [
            i for i, (seq, start, n) in enumerate(packed) if start + n >= len(seq.token_ids)
        ]
        runner = self.runner
        args = (
            self._tokens.copy(), self._positions.copy(), self._block_tables.copy(),
            self._slot_indices.copy(), self._keys.copy(), self._temps.copy(),
            self._top_ps.copy(), self._top_ks.copy(),
        )

        def run_mixed():
            chunk_outs, d_out = runner.mixed_step(
                chunks, *args, eos_ids=eos_ids, eos_suppress=eos_sup)
            fetch = [t for i in final_slots for t in chunk_outs[i]]
            return runner.fetch_sample((*fetch, *d_out))

        out = await self._device(run_mixed)
        self.stats.mixed_steps += 1
        final_samples = {slot: out[4 * j:4 * j + 4] for j, slot in enumerate(final_slots)}
        toks, lps, tids, tlps = out[4 * len(final_slots):]
        for seq, advanced in plan:
            seq.prefill_pos = min(seq.prefill_pos + advanced, len(seq.token_ids))
            if seq.prefill_pos >= len(seq.token_ids):
                self._prefilling.remove(seq)
                seq.prefilling = False
        for i, (seq, _, _) in enumerate(packed):
            if i in final_samples and seq.slot is not None:
                tok, lp, tid, tlp = final_samples[i]
                self._append_token(seq, int(tok[0]), float(lp[0]), tid[0], tlp[0])
        for seq in active:
            if seq.slot is None:
                continue  # finished, cancelled or preempted meanwhile
            i = seq.slot
            self._append_token(seq, int(toks[i]), float(lps[i]), tids[i], tlps[i])

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
