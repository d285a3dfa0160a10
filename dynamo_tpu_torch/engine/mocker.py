"""MockEngine: a simulated paged-KV engine (no torch import).

The port's own copy of dynamo_tpu/engine/mocker.py, with the same cost
model, KV events, block bookkeeping and disagg frames, so a KV router, a
disagg router, the metrics component and the planner run end to end with
no card; ``python -m dynamo_tpu_torch.run in=... out=mocker`` serves it.

Role-equivalent of lib/llm/src/mocker/* (MockVllmEngine engine.rs:60,
watermark Scheduler scheduler.rs:197, simulated KvManager kv_manager.rs:524,
LRU evictor): real block bookkeeping with prefix reuse, LRU eviction, and
genuine KV store/remove events, but fake compute timed by a cost model
(quadratic prefill + linear decode, scheduler.rs:28-43). Tokens are a
deterministic cycle over the prompt.

Disaggregation: with a ``remote_prefill_client`` wired, prompts at or past
``disagg_threshold`` ship to the prefill fleet (``MockPrefillEngine`` is the
prefill-role twin, streaming KvStreamFrames chunk by chunk; building its
payloads imports the port's ``disagg/protocols.py``, and torch with it).

Telemetry: per-request phase spans (queue_wait, prefill, remote_prefill,
kv_land per streamed frame, decode) and deadline / preemption span events
behind ``DYN_TRACE``; always-on phase histograms; a goodput ledger over
simulated seconds; preemption and re-admission decision records.
"""

from __future__ import annotations

import asyncio
import bisect
import collections
import itertools
import os
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Callable, Optional

from dynamo_tpu_torch import qos
from dynamo_tpu_torch.pipeline.context import Context
from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
)
from dynamo_tpu_torch.runtime import clock as dclock
from dynamo_tpu_torch.telemetry import brownout as dbrownout
from dynamo_tpu_torch.telemetry import provenance as dprov
from dynamo_tpu_torch.telemetry import trace as dtrace
from dynamo_tpu_torch.telemetry.goodput import GoodputLedger
from dynamo_tpu_torch.telemetry.histogram import PhaseHistograms
from dynamo_tpu_torch.testing import faults
from dynamo_tpu_torch.tokens import TokenBlockSequence


@dataclass
class MockEngineArgs:
    """Mirrors reference mocker/protocols.rs:160 MockEngineArgs."""

    num_blocks: int = 1024
    block_size: int = 16
    max_batch: int = 64
    watermark: float = 0.01  # fraction of blocks kept free for decode growth
    speedup_ratio: float = 100.0  # sim time = real time / speedup
    # cost model (seconds at speedup 1): prefill a*n + b*n^2, decode per-tok c
    prefill_linear_s: float = 0.0001
    prefill_quadratic_s: float = 1e-8
    decode_per_token_s: float = 0.01
    # Unified mixed steps (parity with the engines' chunk budget): per-
    # iteration prefill token budget riding along the decode batch in one
    # simulated dispatch (cost = the slower of the two halves — the chunk
    # hides behind decode or vice versa). 0 = legacy whole-prompt prefill
    # at admission; brownout's chunk_cap rung halves the effective value,
    # latched once per iteration.
    chunk_budget: int = 0
    dp_rank: Optional[int] = None
    # preemption-storm guard (parity with TorchEngineConfig)
    max_preemptions: int = field(
        default_factory=lambda: int(os.environ.get("DYN_MAX_PREEMPTIONS", "8"))
    )
    preempt_backoff_ms: float = field(
        default_factory=lambda: float(
            os.environ.get("DYN_PREEMPT_BACKOFF_MS", "25")
        )
    )


class _SimKvCache:
    """Paged cache with hash-chain prefix reuse + LRU eviction, emitting
    real KV events (reference mocker/kv_manager.rs:524)."""

    def __init__(
        self,
        args: MockEngineArgs,
        on_stored: Optional[Callable[[list[dict]], None]] = None,
        on_removed: Optional[Callable[[list[int]], None]] = None,
    ) -> None:
        self.args = args
        self.free_blocks = args.num_blocks
        # block_hash -> refcount; 0-ref blocks stay cached until evicted
        self.refs: dict[int, int] = {}
        self.lru: collections.OrderedDict[int, None] = collections.OrderedDict()
        self.on_stored = on_stored
        self.on_removed = on_removed

    @property
    def used_blocks(self) -> int:
        return self.args.num_blocks - self.free_blocks

    @property
    def usage(self) -> float:
        return self.used_blocks / max(1, self.args.num_blocks)

    @property
    def available_blocks(self) -> int:
        """Free + evictable (cached but unreferenced) blocks."""
        return self.free_blocks + sum(
            1 for h in self.lru if self.refs.get(h) == 0
        )

    def cached_prefix_blocks(self, hashes: list[int]) -> int:
        n = 0
        for h in hashes:
            if h in self.refs:
                n += 1
            else:
                break
        return n

    def _evict(self, need: int, protected: frozenset = frozenset()) -> bool:
        evicted: list[int] = []
        skipped: list[int] = []
        while need > 0 and self.lru:
            h, _ = self.lru.popitem(last=False)
            if h in protected:
                # cached block of the request being admitted — evicting it
                # would un-cache what we just counted as a prefix hit
                skipped.append(h)
                continue
            if self.refs.get(h, 1) == 0:
                del self.refs[h]
                self.free_blocks += 1
                evicted.append(h)
                need -= 1
        for h in skipped:
            self.lru[h] = None
        if evicted and self.on_removed:
            self.on_removed(evicted)
        return need <= 0

    def try_allocate(self, hashes: list[int], extra_unique: int) -> bool:
        """Acquire refs on all chain blocks (+unique partial blocks)."""
        new_hashes = [h for h in hashes if h not in self.refs]
        need = len(new_hashes) + extra_unique
        if need > self.free_blocks and not self._evict(
            need - self.free_blocks, frozenset(hashes)
        ):
            return False
        stored: list[dict] = []
        parent = 0
        for h in hashes:
            if h in self.refs:
                self.refs[h] += 1
                self.lru.pop(h, None)
            else:
                self.refs[h] = 1
                self.free_blocks -= 1
                stored.append({"block_hash": h, "parent_hash": parent})
            parent = h
        self.free_blocks -= extra_unique
        if stored and self.on_stored:
            self.on_stored(stored)
        return True

    def grow(self, new_blocks: list) -> bool:
        """A decode step completed new block(s) (TokenBlock instances)."""
        stored = []
        for b in new_blocks:
            h = b.block_hash
            if h in self.refs:
                self.refs[h] += 1
                self.lru.pop(h, None)
            else:
                if self.free_blocks <= 0 and not self._evict(1):
                    return False
                self.refs[h] = 1
                self.free_blocks -= 1
                stored.append({"block_hash": h, "parent_hash": b.parent_hash})
        if stored and self.on_stored:
            self.on_stored(stored)
        return True

    def release(self, hashes: list[int], unique: int) -> None:
        """Drop refs; 0-ref blocks become evictable (stay cached)."""
        for h in hashes:
            n = self.refs.get(h)
            if n is None:
                continue
            if n <= 1:
                self.refs[h] = 0
                self.lru[h] = None
                self.lru.move_to_end(h)
            else:
                self.refs[h] = n - 1
        self.free_blocks += unique


@dataclass
class _MockSeq:
    request: PreprocessedRequest
    context: Context
    out: asyncio.Queue
    hash_seq: TokenBlockSequence
    generated: int = 0
    prompt_len: int = 0  # original prompt length (< len(token_ids) on resume)
    acquired_hashes: list[int] = field(default_factory=list)
    unique_blocks: int = 1
    remote_prefilled: bool = False  # KV arrived from the prefill fleet
    prefill_remaining: int = 0  # unprefilled prompt tokens (mixed-step mode)
    spans: dict = field(default_factory=dict)  # open telemetry phase spans
    # QoS plane (parity with TorchEngine._Sequence)
    priority: str = qos.DEFAULT_CLASS
    rank: int = qos.CLASS_RANK[qos.DEFAULT_CLASS]
    arrival_order: int = 0
    preemptions: int = 0
    requeue_after: float = 0.0
    # always-on phase-timing marks (feed the engine's phase histograms)
    t_arrival: float = 0.0
    t_admitted: Optional[float] = None
    t_first: Optional[float] = None
    t_last: Optional[float] = None

    @property
    def prompt(self) -> list[int]:
        return self.request.token_ids[: self.prompt_len]


class MockFleetPrefixRegistry:
    """Zero-chip twin of the PeerBlockService/Client advert plane (fleet
    prefix cache): each registered MockEngine's _SimKvCache IS its
    advertised block inventory, and a "pull" is a simulated transfer
    (`pull_block_s` per block) that lets the pulling engine skip
    recomputing those prefix tokens. Fenced peers are never pulled from
    (counted as the fenced fallback when they were the only holder), and
    `fail_every` fails every Nth pull attempt deterministically — no RNG,
    so replay stays bit-identical — exercising the fallback-to-recompute
    path. Only prefill ACCOUNTING changes on any outcome; the token
    stream is identical either way (token-identity invariant)."""

    def __init__(
        self, pull_block_s: float = 0.0005, fail_every: int = 0
    ) -> None:
        self.engines: list["MockEngine"] = []
        self.pull_block_s = pull_block_s
        self.fail_every = max(0, int(fail_every))
        self._attempts = 0
        self.pulled_blocks = 0
        self.pull_outcomes: dict[str, int] = {}

    def register(self, engine: "MockEngine") -> None:
        self.engines.append(engine)
        engine.peer_registry = self

    def _note(self, engine: "MockEngine", outcome: str, blocks: int) -> None:
        if blocks <= 0:
            return
        self.pull_outcomes[outcome] = (
            self.pull_outcomes.get(outcome, 0) + blocks
        )
        engine.pull_outcomes[outcome] = (
            engine.pull_outcomes.get(outcome, 0) + blocks
        )

    def pull(
        self, engine: "MockEngine", hashes: list[int], cached: int
    ) -> tuple[int, float]:
        """(blocks pulled past `engine`'s local `cached` prefix, simulated
        transfer cost). 0 blocks on miss/failure — the engine recomputes."""
        best = fenced_best = 0
        for peer in self.engines:
            if peer is engine:
                continue
            n = peer.cache.cached_prefix_blocks(hashes)
            if peer.fenced:
                fenced_best = max(fenced_best, n)
            else:
                best = max(best, n)
        gap = best - cached
        if gap <= 0:
            if fenced_best > cached:
                # the only holder is fenced: never pull from a zombie
                self._note(engine, "fallback_fenced", fenced_best - cached)
            return 0, 0.0
        self._attempts += 1
        if self.fail_every and self._attempts % self.fail_every == 0:
            self._note(engine, "fallback_error", gap)
            return 0, 0.0
        self.pulled_blocks += gap
        self._note(engine, "pulled", gap)
        return gap, gap * self.pull_block_s


class MockEngine:
    """AsyncEngine-compatible: generate(request, context) -> LLMEngineOutput
    stream, same surface as TorchEngine/EchoEngine."""

    def __init__(
        self,
        args: Optional[MockEngineArgs] = None,
        on_blocks_stored: Optional[Callable[[list[dict]], None]] = None,
        on_blocks_removed: Optional[Callable[[list[int]], None]] = None,
        remote_prefill_client: Optional[Any] = None,
        disagg_threshold: Optional[int] = None,
        peer_registry: Optional[MockFleetPrefixRegistry] = None,
    ) -> None:
        self.args = args or MockEngineArgs()
        self.cache = _SimKvCache(self.args, on_blocks_stored, on_blocks_removed)
        self.active: list[_MockSeq] = []
        # priority-then-deadline ordered admission queue (kept sorted by
        # _enqueue — parity with TorchEngine.waiting)
        self.waiting: list[_MockSeq] = []
        self._arrivals = itertools.count(1)
        self._loop_task: Optional[asyncio.Task] = None
        self._wake = asyncio.Event()
        self.generated_tokens = 0
        # cumulative UNCACHED prompt tokens actually prefilled; the routing
        # tests compare this (deterministic) rather than wall-clock TTFT
        self.prefilled_tokens = 0
        # lifeguard counters (same names the TorchEngine stats carry)
        self.deadline_exceeded = 0
        self.injected_aborts = 0
        # QoS counters + brownout rung (parity with EngineStats)
        self.preemptions_by_class: dict[str, int] = {}
        self.preempted_too_often = 0
        self.shed_brownout = 0
        self.brownout_level = 0
        self.spec_paused = False  # recorded for parity (mocker has no spec)
        self.fenced = False  # self-fenced on primary-lease loss
        # streaming-disagg: prompts >= threshold ship to the prefill fleet
        self.remote_prefill_client = remote_prefill_client
        self.disagg_threshold = disagg_threshold or 2 * self.args.block_size
        self.remote_prefills = 0
        self.kv_frames_rx = 0
        # fleet prefix cache (zero-chip): pulls ride the shared registry
        self.peer_registry = peer_registry
        if peer_registry is not None and self not in peer_registry.engines:
            peer_registry.engines.append(self)
        self.kv_pulled_blocks = 0
        self.pull_outcomes: dict[str, int] = {}
        # always-on per-phase latency distributions (same instrumentation
        # points as the DYN_TRACE spans, but distribution-valued and never
        # gated) — ride stats() -> ForwardPassMetrics to the fleet planes
        self.phase_hist = PhaseHistograms()
        # goodput ledger (parity with EngineStats.goodput): steps
        # recorded in SIMULATED seconds (the deterministic cost model, not
        # wall clock) so fleet-vs-direct comparisons are exact
        self.goodput = GoodputLedger()
        # trace process track (set by the worker host; None = process name)
        self.trace_proc: Optional[str] = None

    # Hook properties matching TorchEngine's surface so worker hosting can
    # attach a KvEventPublisher uniformly (entrypoint/inputs.py).
    @property
    def on_blocks_stored(self):
        return self.cache.on_stored

    @on_blocks_stored.setter
    def on_blocks_stored(self, fn) -> None:
        self.cache.on_stored = fn

    @property
    def on_blocks_removed(self):
        return self.cache.on_removed

    @on_blocks_removed.setter
    def on_blocks_removed(self, fn) -> None:
        self.cache.on_removed = fn

    # ----------------------------------------------------------- telemetry

    def _sp_begin(self, seq: _MockSeq, name: str, **attrs) -> None:
        sp = dtrace.begin(name, ctx=seq.context, proc=self.trace_proc, **attrs)
        if sp is not None:
            seq.spans[name] = sp

    def _sp_finish(self, seq: _MockSeq, name: str, **attrs) -> None:
        dtrace.finish(seq.spans.pop(name, None), **attrs)

    def _sp_event(self, seq: _MockSeq, name: str, **attrs) -> None:
        for sp in seq.spans.values():
            sp.event(name, **attrs)
            return

    def _sp_close_all(self, seq: _MockSeq) -> None:
        for name in list(seq.spans):
            self._sp_finish(seq, name)

    # ------------------------------------------------------------- public

    def _observe_stream(self, seq: _MockSeq, item: LLMEngineOutput) -> None:
        """Always-on phase histogram recording at the stream edge (same
        contract as TorchEngine._observe_stream)."""
        ph = self.phase_hist
        now = dclock.now()
        if item.token_ids:
            if seq.t_first is None:
                seq.t_first = now
                ph.observe("ttft", (now - seq.t_arrival) * 1e3)
                if seq.t_admitted is not None:
                    ph.observe("prefill", (now - seq.t_admitted) * 1e3)
            elif seq.t_last is not None:
                ph.observe("inter_token", (now - seq.t_last) * 1e3)
            seq.t_last = now
        if item.finish_reason is not None:
            ph.observe("e2e", (now - seq.t_arrival) * 1e3)

    async def generate(
        self, request: PreprocessedRequest, context: Optional[Context] = None
    ) -> AsyncIterator[LLMEngineOutput]:
        t_arrival = dclock.now()
        ctx = context or Context()
        if self.fenced:
            yield LLMEngineOutput.final_error(
                ctx.id, "admission",
                "worker is fenced (primary lease lost); request must be "
                "served elsewhere",
                "worker_fenced",
            )
            return
        if ctx.expired() or ctx.ttft_expired():
            self.deadline_exceeded += 1
            yield LLMEngineOutput.final_error(
                ctx.id, "admission", "deadline expired before admission",
                "deadline_exceeded",
            )
            return
        priority = qos.priority_of(ctx, request)
        if self.brownout_level and priority in dbrownout.shed_classes_for(
            self.brownout_level
        ):
            self.shed_brownout += 1
            yield LLMEngineOutput.final_error(
                ctx.id, "admission",
                f"brownout level {self.brownout_level} "
                f"({dbrownout.LADDER[self.brownout_level]}) sheds "
                f"{priority}-class requests",
                "brownout_shed",
            )
            return
        # in-flight migration replay (see TorchEngine._Sequence): the tail of
        # token_ids past resume_prompt_len was already streamed by a dead
        # worker; counting it as generated keeps the deterministic token
        # cycle and the max_tokens budget identical to an unfaulted run
        prompt_len = len(request.token_ids)
        resume = int(request.extra.get("resume_prompt_len") or 0)
        if 0 < resume < prompt_len:
            # replayed tail: already streamed by a dead worker, but its KV
            # must be re-prefilled here (goodput taxonomy: migration)
            self.goodput.record_waste(
                "migration_replay", prompt_len - resume
            )
            prompt_len = resume
        first_remote: Optional[int] = None
        if (
            self.remote_prefill_client is not None
            and resume == 0
            and prompt_len >= self.disagg_threshold
        ):
            first_remote = await self._remote_prefill(request, ctx)
            if first_remote is None and (ctx.is_killed() or ctx.is_stopped()):
                yield LLMEngineOutput.final(FinishReason.CANCELLED)
                return
        seq = _MockSeq(
            request=request,
            context=ctx,
            out=asyncio.Queue(),
            prompt_len=prompt_len,
            generated=len(request.token_ids) - prompt_len,
            hash_seq=TokenBlockSequence(
                block_size=self.args.block_size,
                tokens=list(request.token_ids),
            ),
            t_arrival=t_arrival,
            priority=priority,
            rank=qos.rank_of(priority),
        )
        if first_remote is not None:
            # the prefill worker sampled the first token (the same
            # deterministic cycle value the local path would produce);
            # count it against the budget and continue decode after it
            self.remote_prefills += 1
            seq.remote_prefilled = True
            seq.generated += 1
            self.generated_tokens += 1
            max_tokens = request.stop.max_tokens or 64
            if seq.generated >= max_tokens:
                yield LLMEngineOutput(
                    token_ids=[first_remote],
                    finish_reason=FinishReason.LENGTH,
                )
                return
            seq.out.put_nowait(LLMEngineOutput(token_ids=[first_remote]))
        if dtrace.enabled():
            self._sp_begin(
                seq, "queue_wait", tokens=prompt_len, priority=seq.priority
            )
        self._enqueue(seq)
        self._wake.set()
        self._ensure_loop()
        try:
            while True:
                item = await seq.out.get()
                self._observe_stream(seq, item)
                yield item
                if item.finish_reason is not None:
                    return
        finally:
            # consumer disconnected mid-stream: mark the request dead so the
            # sim loop releases its cache blocks instead of generating into
            # a queue nobody reads (mirrors TorchEngine.generate)
            ctx.kill()
            self._wake.set()

    async def _remote_prefill(
        self, request: PreprocessedRequest, ctx: Context
    ) -> Optional[int]:
        """Ship the prompt to the prefill fleet over the streaming KV data
        plane; returns the remotely-sampled first token, or None to fall
        back to the local (simulated) prefill path."""
        frames = 0
        with dtrace.span(
            "remote_prefill", ctx=ctx, proc=self.trace_proc,
            tokens=len(request.token_ids),
        ) as rsp:
            async def on_frame(frame) -> None:
                nonlocal frames
                frames += 1
                self.kv_frames_rx += 1
                # sim engine: nothing to inject (the cache is hash-based);
                # the span records when/that each frame landed
                with dtrace.span(
                    "kv_land", parent=rsp, proc=self.trace_proc,
                    seq=frame.seq, blocks=frame.payload.num_blocks,
                ):
                    pass

            extra = None
            if rsp.trace_id:
                extra = {"trace": {"tid": rsp.trace_id, "sid": rsp.span_id}}
            try:
                resp = await self.remote_prefill_client.prefill(
                    list(request.token_ids),
                    cached_blocks=0,
                    stream=True,
                    on_frame=on_frame,
                    deadline=ctx.deadline,
                    ctx=ctx,
                    extra=extra,
                )
            except Exception:  # noqa: BLE001 — disagg is an optimization
                rsp.set(fallback="transfer_failed")
                return None
            rsp.set(frames=frames)
            if resp is None or resp.error or resp.first_token < 0:
                rsp.set(fallback=resp.code if resp else "no_response")
                return None
            rsp.set(streamed_blocks=resp.streamed_blocks)
            return int(resp.first_token)

    def stats(self) -> dict:
        return {
            "active_slots": len(self.active),
            "total_slots": self.args.max_batch,
            "waiting": len(self.waiting),
            "used_blocks": self.cache.used_blocks,
            "total_blocks": self.args.num_blocks,
            "cache_usage": self.cache.usage,
            "deadline_exceeded": self.deadline_exceeded,
            "phase_histograms": self.phase_hist,
            "preemptions_by_class": dict(self.preemptions_by_class),
            "preempted_too_often": self.preempted_too_often,
            "shed_brownout": self.shed_brownout,
            "brownout_level": self.brownout_level,
            "goodput": self.goodput,
            "kv_pulled_blocks": self.kv_pulled_blocks,
            "kv_pull_outcomes": dict(self.pull_outcomes),
        }

    def apply_brownout(self, level: int) -> None:
        """Brownout-ladder rung (parity with TorchEngine.apply_brownout):
        >= 1 sheds bulk arrivals, >= 2 records spec pause (the mocker has
        no drafter — the flag exists so the policy is testable
        engine-free), >= 4 sheds standard arrivals too."""
        self.brownout_level = max(0, int(level))
        self.spec_paused = self.brownout_level >= 2

    async def close(self) -> None:
        if self._loop_task is not None:
            self._loop_task.cancel()
            try:
                await self._loop_task
            except asyncio.CancelledError:
                pass
            self._loop_task = None

    # -------------------------------------------------------------- sched

    def _ensure_loop(self) -> None:
        if self._loop_task is None or self._loop_task.done():
            self._loop_task = asyncio.create_task(self._run())

    @staticmethod
    def _queue_key(seq: _MockSeq) -> tuple:
        dl = seq.context.deadline
        return (seq.rank, dl if dl is not None else float("inf"),
                seq.arrival_order)

    def _enqueue(self, seq: _MockSeq) -> None:
        if not seq.arrival_order:
            seq.arrival_order = next(self._arrivals)
        bisect.insort(self.waiting, seq, key=self._queue_key)

    async def _sim_sleep(self, sim_s: float) -> None:
        await asyncio.sleep(sim_s / self.args.speedup_ratio)

    def _admit(self) -> float:
        """Watermark admission (scheduler.rs:197); returns prefill sim-cost."""
        cost = 0.0
        n_prefill_total = 0
        watermark_blocks = int(self.args.num_blocks * self.args.watermark)
        # reap abandoned requests before they consume sim capacity
        for seq in [s for s in self.waiting if s.context.is_killed()]:
            self.waiting.remove(seq)
            self._sp_close_all(seq)
            seq.out.put_nowait(LLMEngineOutput.final(FinishReason.CANCELLED))
        # shed queued requests past their deadline / TTFT budget
        for seq in [
            s for s in self.waiting
            if s.context.expired() or s.context.ttft_expired()
        ]:
            self.waiting.remove(seq)
            self.deadline_exceeded += 1
            seq.context.kill()
            self._sp_event(seq, "deadline_exceeded", phase="queue")
            self._sp_close_all(seq)
            seq.out.put_nowait(
                LLMEngineOutput.final_error(
                    seq.context.id, "queue",
                    "deadline exceeded while queued", "deadline_exceeded",
                )
            )
        idx = 0
        while idx < len(self.waiting) and len(self.active) < self.args.max_batch:
            seq = self.waiting[idx]
            if seq.requeue_after and dclock.now() < seq.requeue_after:
                # preemption re-admission backoff: don't head-block others
                idx += 1
                continue
            hashes = [b.block_hash for b in seq.hash_seq.blocks]
            cached = self.cache.cached_prefix_blocks(hashes)
            if (
                self.cache.available_blocks - (len(hashes) - cached)
                < watermark_blocks
            ):
                break
            if not self.cache.try_allocate(hashes, extra_unique=1):
                break
            self.waiting.pop(idx)
            if seq.t_admitted is None:  # first admission (not a resume)
                seq.t_admitted = dclock.now()
                self.phase_hist.observe(
                    "queue_wait", (seq.t_admitted - seq.t_arrival) * 1e3
                )
            seq.acquired_hashes = list(hashes)
            self.active.append(seq)
            pulled = 0
            if (
                self.peer_registry is not None
                and not seq.remote_prefilled
                and cached < len(hashes)
            ):
                # fleet prefix pull: a peer's cache may hold the rest of
                # the prefix — pulled blocks skip prefill compute; the
                # simulated transfer cost joins this admission's dispatch
                # (so a kill/blackout wave can land MID-pull)
                pulled, pull_cost = self.peer_registry.pull(
                    self, hashes, cached
                )
                if pulled:
                    self.kv_pulled_blocks += pulled
                    cost += pull_cost
            if seq.remote_prefilled:
                # KV already arrived over the streaming data plane — no
                # local prefill compute to simulate
                n_prefill = 0
            else:
                n_prefill = max(0, len(seq.request.token_ids)
                                - (cached + pulled) * self.args.block_size)
            self.prefilled_tokens += n_prefill
            if self.args.chunk_budget > 0:
                # mixed-step mode: prefill compute rides along future
                # decode iterations chunk-by-chunk instead of blocking
                # the whole batch at admission (always assigned: a
                # preempted victim re-admitted fully-cached must clear
                # any stale remainder)
                seq.prefill_remaining = n_prefill
            else:
                n_prefill_total += n_prefill
                cost += (
                    self.args.prefill_linear_s * n_prefill
                    + self.args.prefill_quadratic_s * n_prefill * n_prefill
                )
            if seq.spans:
                self._sp_finish(
                    seq, "queue_wait", cached_blocks=cached
                )
                if n_prefill:
                    self._sp_begin(seq, "prefill", tokens=n_prefill)
                else:
                    self._sp_begin(seq, "decode")
        if cost > 0:
            # one simulated prefill "dispatch" for the admitted batch,
            # recorded in sim-seconds (deterministic cost model)
            self.goodput.record_step(
                "prefill", cost, prefill_tokens=n_prefill_total
            )
        return cost

    def _chunk_budget(self) -> int:
        """Per-iteration prefill token budget (mixed-step mode).

        Brownout's chunk_cap rung halves it (floored at one KV block);
        the caller latches the value ONCE at the top of each loop
        iteration — parity with TorchEngine's step-boundary latch, so a
        brownout transition landing mid-iteration never re-slices work
        the iteration already planned."""
        return qos.effective_chunk_budget(
            self.args.chunk_budget,
            chunk_cap=dbrownout.chunk_capped(self.brownout_level),
            block_size=self.args.block_size,
        )

    async def _run(self) -> None:
        while True:
            if not self.active and not self.waiting:
                self._wake.clear()
                await self._wake.wait()
            chunk_budget = self._chunk_budget()  # step-boundary latch
            prefill_cost = self._admit()
            if prefill_cost:
                await self._sim_sleep(prefill_cost)
            for seq in self.active:
                if "prefill" in seq.spans and not seq.prefill_remaining:
                    self._sp_finish(seq, "prefill")
                    self._sp_begin(seq, "decode")
            if not self.active:
                # blocked: waiting head cannot be admitted yet
                if self.waiting:
                    await asyncio.sleep(0.001)
                continue
            # mixed-step packing: decode lanes keep stepping while queued
            # prefill work drains chunk-by-chunk under the latched budget
            # (priority order — same key the admission queue sorts by)
            decoding = [s for s in self.active if not s.prefill_remaining]
            prefilling = sorted(
                (s for s in self.active if s.prefill_remaining > 0),
                key=self._queue_key,
            )
            chunk_tokens = 0
            slots = 0
            budget = chunk_budget
            for seq in prefilling:
                if budget <= 0:
                    break
                n = min(seq.prefill_remaining, budget)
                seq.prefill_remaining -= n
                budget -= n
                chunk_tokens += n
                slots += 1
                if not seq.prefill_remaining and "prefill" in seq.spans:
                    self._sp_finish(seq, "prefill")
                    self._sp_begin(seq, "decode")
            chunk_cost = (
                self.args.prefill_linear_s * chunk_tokens
                + self.args.prefill_quadratic_s * chunk_tokens * chunk_tokens
            )
            # one decode iteration for the whole batch (a gray-worker
            # fault stretches the simulated step: slow, never dead)
            step_s = self.args.decode_per_token_s
            if faults.active():
                inj = faults.get_injector()
                if inj is not None:
                    await inj.on_dispatch()
                    step_s *= inj.dispatch_slow_factor()
            if decoding and chunk_tokens:
                # unified device step: the chunk hides behind the decode
                # half (or vice versa) — cost is the slower of the two
                step_s = max(step_s, chunk_cost)
                await self._sim_sleep(step_s)
                self.goodput.record_step(
                    f"mixed_step@c{slots}",
                    step_s,
                    lanes=len(decoding),
                    capacity=self.args.max_batch,
                    prefill_tokens=chunk_tokens,
                )
            elif chunk_tokens:
                await self._sim_sleep(chunk_cost)
                self.goodput.record_step(
                    "prefill_chunk", chunk_cost,
                    prefill_tokens=chunk_tokens,
                )
            else:
                await self._sim_sleep(step_s)
                self.goodput.record_step(
                    "decode",
                    step_s,
                    lanes=len(decoding),
                    capacity=self.args.max_batch,
                )
            # deadline expiry mid-generation: cancel + structured error
            for seq in [
                s for s in list(self.active) if s.context.expired()
            ]:
                self.deadline_exceeded += 1
                # partial output discarded (goodput taxonomy: deadline)
                self.goodput.record_waste("deadline_partial", seq.generated)
                seq.context.kill()
                self.active.remove(seq)
                self.cache.release(seq.acquired_hashes, seq.unique_blocks)
                self._sp_event(seq, "deadline_exceeded", phase="decode")
                self._sp_close_all(seq)
                seq.out.put_nowait(
                    LLMEngineOutput.final_error(
                        seq.context.id, "decode",
                        "deadline exceeded mid-generation",
                        "deadline_exceeded",
                    )
                )
            for seq in decoding:
                # lanes still mid-prefill emit no tokens this iteration
                self._step_seq(seq)

    def _abort_all(self, cause: str, code: str = "injected_fault") -> None:
        """Injected crash (faults.abort_after_tokens) or self-fence: fail
        every live sequence with a structured error and release every
        cache ref — the simulated twin of a worker process dying (or
        being fenced) mid-stream."""
        if code == "injected_fault":
            self.injected_aborts += 1
        for seq in list(self.waiting):
            self.waiting.remove(seq)
            self._sp_close_all(seq)
            seq.out.put_nowait(
                LLMEngineOutput.final_error(
                    seq.context.id, "queue", cause, code
                )
            )
        for seq in list(self.active):
            self.active.remove(seq)
            self.cache.release(seq.acquired_hashes, seq.unique_blocks)
            self._sp_close_all(seq)
            seq.out.put_nowait(
                LLMEngineOutput.final_error(
                    seq.context.id, "decode", cause, code
                )
            )

    def fence(self, reason: str) -> None:
        """Worker self-fence (parity with TorchEngine.fence): the primary
        lease is gone — stop admitting, fail every lane with a structured
        `worker_fenced` error between simulated steps, and decode no more."""
        if self.fenced:
            return
        self.fenced = True
        dtrace.event("worker_fenced", reason=reason)
        self._abort_all(f"worker fenced: {reason}", code="worker_fenced")
        if self._loop_task is not None:
            self._loop_task.cancel()
            self._loop_task = None

    def _step_seq(self, seq: _MockSeq) -> None:
        if seq not in self.active:
            # released mid-iteration (an injected abort earlier in this
            # batch step): stepping a zombie would re-acquire cache refs
            return
        if faults.active():
            inj = faults.get_injector()
            if inj is not None and inj.on_token():
                self._abort_all("injected engine fault (abort_after_tokens)")
                return
        # Deterministic fake token: cycle over the ORIGINAL prompt (on a
        # migration replay, token_ids carries already-emitted output too —
        # cycling over it would diverge from the unfaulted run)
        prompt = seq.prompt
        tok = prompt[seq.generated % max(1, len(prompt))]
        seq.generated += 1
        self.generated_tokens += 1
        self.goodput.record_decode_tokens()
        prev_blocks = len(seq.hash_seq.blocks)
        seq.hash_seq.append(tok)
        new_blocks = seq.hash_seq.blocks[prev_blocks:]
        if new_blocks:
            if not self.cache.grow(new_blocks):
                self._preempt_for(seq)
                return
            seq.acquired_hashes.extend(b.block_hash for b in new_blocks)
        max_tokens = seq.request.stop.max_tokens or 64
        finished = seq.generated >= max_tokens or seq.context.is_stopped()
        reason = None
        if finished:
            reason = (
                FinishReason.CANCELLED
                if seq.context.is_stopped()
                else FinishReason.LENGTH
            )
            if reason is FinishReason.CANCELLED:
                # consumer disconnected mid-stream (goodput taxonomy:
                # cancelled partial — same attribution as TorchEngine)
                self.goodput.record_waste(
                    "cancelled_partial", seq.generated
                )
        seq.out.put_nowait(
            LLMEngineOutput(
                token_ids=[tok],
                finish_reason=reason,
            )
        )
        if finished:
            self.active.remove(seq)
            self.cache.release(seq.acquired_hashes, seq.unique_blocks)
            if seq.spans:
                self._sp_finish(seq, "decode", tokens=seq.generated)
                self._sp_close_all(seq)

    def _preempt_for(self, seq: _MockSeq) -> None:
        """Class-aware victim choice (parity with TorchEngine._preempt_victim):
        lowest class first, youngest within a class, never a victim whose
        class strictly outranks the grower's — the grower yields itself
        when everyone else is more important."""
        victim = None
        worst = max(qos.CLASS_RANK.values())
        for rank in range(worst, seq.rank - 1, -1):
            for cand in reversed(self.active):
                if cand is seq or cand.rank != rank:
                    continue
                victim = cand
                break
            if victim is not None:
                break
        chosen = victim if victim is not None else seq
        if dprov.enabled():
            dprov.record(
                "engine", "preempt", chosen.priority,
                reason="self_yield" if victim is None else "class_rank",
                ctx=chosen.context,
                proc=self.trace_proc,
                alternatives=[
                    {
                        "request": c.context.id,
                        "class": c.priority,
                        "rank": c.rank,
                        "generated": c.generated,
                    }
                    for c in self.active
                    if c is not seq
                ][:8],
                grower=seq.context.id,
                grower_class=seq.priority,
            )
        self._preempt_seq(chosen)

    def _preempt_seq(self, victim: _MockSeq) -> None:
        if victim in self.active:
            self.active.remove(victim)
        self.cache.release(victim.acquired_hashes, victim.unique_blocks)
        victim.acquired_hashes = []
        victim.preemptions += 1
        self.preemptions_by_class[victim.priority] = (
            self.preemptions_by_class.get(victim.priority, 0) + 1
        )
        # every token whose simulated KV this preemption released must be
        # recomputed on re-admission (goodput taxonomy: preempt replay)
        self.goodput.record_waste(
            "preempt_replay", victim.prompt_len + victim.generated
        )
        if victim.preemptions > self.args.max_preemptions:
            # preemption-storm guard (parity with TorchEngine._preempt_seq)
            self.preempted_too_often += 1
            self._sp_event(victim, "preempted_too_often")
            self._sp_close_all(victim)
            victim.out.put_nowait(
                LLMEngineOutput.final_error(
                    victim.context.id, "preemption",
                    f"preempted {victim.preemptions} times under sustained "
                    f"pressure (DYN_MAX_PREEMPTIONS="
                    f"{self.args.max_preemptions}); giving up",
                    "preempted_too_often",
                )
            )
            return
        self._sp_event(victim, "preempted", count=victim.preemptions)
        self._sp_finish(victim, "decode", preempted=True)
        backoff_s = min(
            2.0,
            self.args.preempt_backoff_ms
            / 1e3
            * (1 << (victim.preemptions - 1)),
        )
        if dprov.enabled():
            dprov.record(
                "engine", "readmit", victim.priority,
                reason="backoff",
                ctx=victim.context,
                proc=self.trace_proc,
                backoff_ms=round(backoff_s * 1e3, 3),
                preemptions=victim.preemptions,
            )
        victim.requeue_after = dclock.now() + backoff_s
        self._enqueue(victim)


class MockPrefillEngine:
    """Prefill-role twin of MockEngine for the streaming-disagg mocker
    graph: serves RemotePrefillRequests under the same cost model with
    fake (but correctly-shaped, codec-exercising) KV payloads, streaming
    one KvStreamFrame per chunk of completed blocks. First-token sampling
    follows the mocker's deterministic cycle (prompt[0]), so a disagg
    mocker stream is token-identical to the aggregated mocker."""

    def __init__(
        self,
        args: Optional[MockEngineArgs] = None,
        chunk_blocks: int = 2,
    ) -> None:
        self.args = args or MockEngineArgs()
        self.chunk_blocks = max(1, chunk_blocks)
        self.served = 0
        self.frames_emitted = 0
        self.trace_proc: Optional[str] = None

    async def _sim_sleep(self, sim_s: float) -> None:
        await asyncio.sleep(sim_s / self.args.speedup_ratio)

    def _chunk_cost(self, n_tokens: int) -> float:
        return (
            self.args.prefill_linear_s * n_tokens
            + self.args.prefill_quadratic_s * n_tokens * n_tokens
        )

    def _payload(self, nblocks: int, block_size: int):
        import numpy as np

        from dynamo_tpu_torch.disagg.protocols import KvBlockPayload

        k = np.zeros((1, 1, max(1, nblocks), block_size, 1), np.float32)
        return KvBlockPayload.encode(k, k)

    async def prefill_only(self, req: Any) -> Any:
        """Monolithic path: one simulated prefill, one dense payload."""
        from dynamo_tpu_torch.disagg.protocols import RemotePrefillResponse

        await self._sim_sleep(self._chunk_cost(len(req.token_ids)))
        self.served += 1
        bs = req.block_size or self.args.block_size
        total = -(-len(req.token_ids) // bs)
        return RemotePrefillResponse(
            request_id=req.request_id,
            first_token=int(req.token_ids[0]),
            payload=self._payload(total, bs),
            first_block=0,
        )

    async def prefill_only_stream(
        self, req: Any, emit, cancelled=None
    ) -> Optional[Any]:
        """Streaming path: simulate chunked prefill, shipping each chunk's
        completed blocks while the next chunk 'computes'. Returns None on
        requester cancellation (PrefillWorkerService contract)."""
        from dynamo_tpu_torch.disagg.protocols import (
            KvStreamFrame,
            RemotePrefillResponse,
        )

        bs = req.block_size or self.args.block_size
        tokens = list(req.token_ids)
        full_blocks = len(tokens) // bs
        streamed = 0
        seqno = 0
        while streamed < full_blocks:
            if cancelled is not None and cancelled():
                return None
            n = min(self.chunk_blocks, full_blocks - streamed)
            with dtrace.wire_span("prefill_chunk", blocks=n):
                await self._sim_sleep(self._chunk_cost(n * bs))
            await emit(
                KvStreamFrame(
                    request_id=req.request_id,
                    seq=seqno,
                    first_block=streamed,
                    payload=self._payload(n, bs),
                )
            )
            self.frames_emitted += 1
            seqno += 1
            streamed += n
        # tail: the partial block (or the whole prompt when it fits in one)
        tail_tokens = len(tokens) - full_blocks * bs
        with dtrace.wire_span("prefill_chunk", blocks=1, tail=True):
            await self._sim_sleep(self._chunk_cost(max(1, tail_tokens)))
        if cancelled is not None and cancelled():
            return None
        self.served += 1
        return RemotePrefillResponse(
            request_id=req.request_id,
            first_token=int(tokens[0]),
            payload=self._payload(1, bs),
            first_block=streamed,
            streamed_blocks=streamed,
        )
