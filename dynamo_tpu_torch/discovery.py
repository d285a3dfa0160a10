"""Model discovery: workers register models; frontends watch and wire chains.

The port's own copy of dynamo_tpu/discovery.py: ``ModelEntry``,
``register_llm``, ``RemoteEngine`` with in-flight migration and fenced-frame
rejection, and ``ModelWatcher``. A worker publishes its ModelDeploymentCard
to the fabric object store and writes a lease-bound kv entry under
``models/``; every frontend's ModelWatcher sees the entry, downloads the
card, builds the preprocessor -> router -> remote engine chain, and
registers it with its ModelManager. Lease death removes the entry and (on
the last ref) the model.

In KV mode (``RouterMode.KV``) the watcher keeps one ``kv_router.KvRouter``
per worker endpoint, fed by the workers' KV events, and closes it when the
endpoint's last model goes.

Tracing (``telemetry/trace.py``): every dispatch attempt runs under its own
``dispatch`` span parented on the request's root, so a migrated stream stays
one trace (a ``migration`` event marks each failover, ``degraded_hold`` a
replay held through a control-plane blackout); the spans a worker ships on
its final frame are ingested, and with tracing on the watcher subscribes to
each namespace's ``trace-export`` subject, the fallback for streams torn
down before their final frame.

The tail-tolerance plane (``telemetry/health.py``): each worker endpoint
gets one ``HealthScorer`` and one ``HedgeController``, shared by its
Client (ejected workers leave ``_eligible``), its KV scheduler (route set
and deweighting) and its ``RemoteEngine``, which records every dispatch,
first-frame and inter-frame latency against the serving worker, but for a
frame the worker marks ``cold`` (a graph capture or a kernel load held it,
C15; a departure from the reference, which scores those too). The
inter-frame signal, the scorer's own EWMA and exported nowhere, is scored
by delivery (``telemetry/health.StreamPace``): a fetch's frames share its
gap; the frontend's inter-token latency histogram is not. With
``DYN_HEDGE=1`` an interactive request whose first token has not come
within the hedge delay gets one hedge dispatch on another worker
(``_hedged_first``): the first good first frame wins, the loser's stream
is closed (its worker frees the lane and blocks), and the events
``hedge_dispatch_failed`` and ``hedge_won`` mark the trace. A
``WorkerCapacityPoller`` per model scrapes the workers' load metrics every
2 s: their slots set the admission watermark, their phase histograms feed
the scorer, and each scrape ticks it; an ejection is published on the
namespace's ``health-status`` subject. Hedges (budget denied, won, lost)
and migrations are decision records (``telemetry/provenance.py``); the
records a worker ships on its final frame, or on the ``trace-export``
event, are ingested into this process's ledger for
``GET /debug/decisions/{request_id}``.

Role-equivalent of lib/llm/src/discovery/{watcher,model_manager,model_entry}.rs
and the bindings' ``register_llm``.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import os
from dataclasses import dataclass
from typing import Any, AsyncIterator, Callable, Optional

from dynamo_tpu_torch.fabric import mpack
from dynamo_tpu_torch.http.service import ModelExecution, ModelManager
from dynamo_tpu_torch.model_card import ModelDeploymentCard
from dynamo_tpu_torch.pipeline.context import Context
from dynamo_tpu_torch.pipeline.router import PushRouter, RouterMode
from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
)
from dynamo_tpu_torch import qos
from dynamo_tpu_torch.runtime import clock as dclock
from dynamo_tpu_torch.runtime.backoff import full_jitter_delay
from dynamo_tpu_torch.runtime.component import Endpoint, NoInstancesError
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.protocols import MODEL_ROOT, EndpointId
from dynamo_tpu_torch.telemetry import health as dhealth
from dynamo_tpu_torch.telemetry import provenance as dprov
from dynamo_tpu_torch.telemetry import trace as dtrace

logger = logging.getLogger("dynamo_tpu_torch.discovery")


@dataclass
class ModelEntry:
    """The kv record under models/ (reference discovery/model_entry.rs)."""

    name: str
    slug: str
    endpoint: str  # dyn://ns.comp.ep
    model_type: str = "both"

    def to_bytes(self) -> bytes:
        return json.dumps(self.__dict__).encode()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "ModelEntry":
        d = json.loads(raw)
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})


async def register_llm(
    drt: DistributedRuntime,
    endpoint: Endpoint,
    mdc: ModelDeploymentCard,
    lease_id: Optional[int] = None,
) -> str:
    """Publish the model card + discovery entry for a serving worker.

    Returns the kv key (which dies with the lease)."""
    await mdc.publish(drt.fabric)
    lid = lease_id if lease_id is not None else drt.primary_lease
    entry = ModelEntry(
        name=mdc.name,
        slug=mdc.slug,
        endpoint=str(endpoint.id),
        model_type=mdc.model_type,
    )
    key = f"{MODEL_ROOT}{mdc.slug}:{lid:x}"
    await drt.fabric.kv_put(key, entry.to_bytes(), lease_id=lid)
    logger.info("registered model %s -> %s", mdc.name, entry.endpoint)
    return key


class _ResumedStream:
    """A response-stream facade that resumes iteration after the hedging
    logic pulled (or started pulling) the first frame: yields the pending
    first item, then the underlying iterator's. close() cancels the pending
    pull and closes the inner stream (killing its per-attempt context: the
    cancellation cascade the engines honour for consumer disconnects)."""

    def __init__(self, inner: Any, it: Any, pending: Optional[asyncio.Task]):
        self._inner = inner
        self._it = it
        self._pending = pending
        self.context = inner.context

    def __aiter__(self):
        async def gen():
            try:
                if self._pending is not None:
                    item = await self._pending
                    self._pending = None
                    yield item
                while True:
                    yield await self._it.__anext__()
            except StopAsyncIteration:
                return

        return gen()

    async def close(self) -> None:
        if self._pending is not None:
            self._pending.cancel()
            self._pending = None
        await self._inner.close()


def _first_frame_tokens(task: asyncio.Task) -> int:
    """Tokens carried by a completed first-frame pull (0 for errors)."""
    if not task.done() or task.cancelled() or task.exception() is not None:
        return 0
    data = getattr(task.result(), "data", None)
    if isinstance(data, dict):
        return len(data.get("token_ids") or ())
    return 0


def _is_good_first_frame(task: asyncio.Task) -> bool:
    """A completed pull that yielded a non-error frame."""
    if not task.done() or task.cancelled() or task.exception() is not None:
        return False
    return not task.result().is_error()


class RemoteEngine:
    """EngineFn adapter with in-flight migration: forwards
    PreprocessedRequests over a PushRouter; when the serving worker dies
    mid-stream (transport error frame, handshake timeout, or the response
    stream breaking without a finish_reason — the signatures of a killed
    decode worker or a lost discovery lease), the request is REPLAYED —
    prompt plus already-emitted tokens — onto another healthy worker via
    the engines' ``resume_prompt_len`` replay contract, under bounded
    retries with exponential backoff + full jitter (``DYN_MIGRATION_MAX_RETRIES``
    4, ``DYN_MIGRATION_BACKOFF_S`` 0.05, ``DYN_MIGRATION_DISPATCH_TIMEOUT_S``
    5). The resumed stream carries no duplicated and no dropped tokens:
    every engine counts the replayed tail as generated output, so budgets
    and per-token sampling counters continue exactly where the dead worker
    stopped. Frames stamped with a fenced epoch (a partitioned zombie still
    streaming after the cluster declared it dead) are refused and the
    request migrates. ``migrations`` counts the replays.

    Tail tolerance: with a ``health`` scorer, every dispatch / first-frame
    / inter-frame latency is recorded against the serving worker. With
    ``DYN_HEDGE=1`` and a ``hedger``, an interactive request's first
    attempt is hedged (``_hedged_first``). A hedge is a fresh dispatch of
    the same request, not a replay, so the port's counter-based sampling
    keys line up and hedged streams are token-identical under greedy and
    seeded sampling."""

    def __init__(
        self,
        router: PushRouter,
        on_migration: Optional[Callable[[], None]] = None,
        cancel_token: Optional[Any] = None,
        fences: Optional[Any] = None,  # runtime.fencing.FenceRegistry
        on_fenced_reject: Optional[Callable[[], None]] = None,
        health: Optional[Any] = None,  # telemetry.health.HealthScorer
        hedger: Optional[Any] = None,  # telemetry.health.HedgeController
    ) -> None:
        self.router = router
        self.on_migration = on_migration
        self.health = health
        self.hedger = hedger
        # DYN_HEDGE resolved once: the disabled path is one attribute check
        self._hedge = hedger is not None and dhealth.hedge_enabled()
        # the hosting runtime's CancellationToken: when the frontend itself
        # is dying (fabric/lease loss), replays must abort IMMEDIATELY so
        # the structured error still reaches the client before teardown
        self.cancel_token = cancel_token
        self.fences = fences
        self.on_fenced_reject = on_fenced_reject
        self.migrations = 0
        self.max_retries = int(os.environ.get("DYN_MIGRATION_MAX_RETRIES", "4"))
        self.backoff_base_s = float(os.environ.get("DYN_MIGRATION_BACKOFF_S", "0.05"))
        self.dispatch_timeout_s = float(
            os.environ.get("DYN_MIGRATION_DISPATCH_TIMEOUT_S", "5")
        )

    def _runtime_dying(self) -> bool:
        return self.cancel_token is not None and self.cancel_token.is_cancelled()

    def _record_pace(self, wid: Optional[int], done) -> None:
        """A stream's closed delivery (``StreamPace``) as one inter-frame
        sample of its per-token gap; a cold one is not scored (C15)."""
        if done is not None and wid is not None and not done[2]:
            self.health.record(wid, "inter_frame", done[0])

    async def _hedged_first(self, stream: Any, ctx: Context, attempt_ctx: Context,
                            req_dict: dict, exclude: set[int], dsp: Any) -> Any:
        """Hedged first token (discovery.py:202-335, "The Tail at Scale"):
        wait the dynamic hedge delay for the primary's first frame; past
        it, launch one hedge dispatch on another eligible worker (budget
        permitting), race the two first frames, keep the winner and close
        the loser. Always returns a stream to iterate: on any internal
        failure the primary passes through."""
        hedger = self.hedger
        it = stream.__aiter__()
        first_task = asyncio.ensure_future(it.__anext__())
        done, _ = await asyncio.wait({first_task}, timeout=hedger.delay_ms() / 1e3)
        if done:
            # the primary answered inside the delay: no hedge
            return _ResumedStream(stream, it, first_task)
        if not hedger.try_acquire():  # counts outcome=budget_denied
            dsp.set(hedge="budget_denied")
            if dprov.enabled():
                dprov.record("remote", "hedge", None, reason="budget_denied", ctx=ctx)
            return _ResumedStream(stream, it, first_task)
        primary_wid = attempt_ctx.metadata.get("worker_instance_id")
        hx = set(exclude)
        if primary_wid is not None:
            hx.add(primary_wid)
        # the hedge context is a sibling of the primary's attempt context
        # (both children of the request's): closing the loser must not
        # cascade into the winner
        hedge_ctx = ctx.child()
        hstream = None
        try:
            hstream = await asyncio.wait_for(self.router.generate(req_dict, hedge_ctx, exclude=hx),
                                             self.dispatch_timeout_s)
        except Exception as e:  # noqa: BLE001 — a failed hedge is a no-op
            dtrace.event("hedge_dispatch_failed", cause=str(e))
        if hstream is None:
            hedger.note_outcome("lost")
            return _ResumedStream(stream, it, first_task)
        hedge_wid = hedge_ctx.metadata.get("worker_instance_id")
        dsp.set(hedged=True, hedge_worker=f"{hedge_wid:x}" if hedge_wid is not None else None)
        hit = hstream.__aiter__()
        hedge_task = asyncio.ensure_future(hit.__anext__())
        await asyncio.wait({first_task, hedge_task}, return_when=asyncio.FIRST_COMPLETED)
        # the winner is the first good frame, the primary on a tie; a side
        # whose pull errored loses even if first
        if _is_good_first_frame(first_task):
            hedge_wins = False
        elif _is_good_first_frame(hedge_task):
            hedge_wins = True
        else:
            # the primary's pull failed while the hedge is in flight: ride
            # the hedge; the hedge failed first (or both): stay, and the
            # migration logic decides what comes next
            hedge_wins = first_task.done() and not hedge_task.done()
        if hedge_wins:
            wasted = _first_frame_tokens(first_task)
            first_task.cancel()
            with contextlib.suppress(Exception):
                await stream.close()
            hedger.note_outcome("won", wasted_tokens=wasted)
            dsp.set(hedge="won")
            dtrace.event("hedge_won", loser=f"{primary_wid:x}" if primary_wid is not None else None)
            if dprov.enabled():
                dprov.record(
                    "remote", "hedge", f"{hedge_wid:x}" if hedge_wid is not None else None,
                    reason="won", ctx=ctx,
                    alternatives=[{"worker": f"{primary_wid:x}" if primary_wid is not None else None,
                                   "outcome": "lost"}],
                    wasted_tokens=wasted,
                )
            # exclusion and health attribution follow the serving worker
            if hedge_wid is not None:
                attempt_ctx.metadata["worker_instance_id"] = hedge_wid
            return _ResumedStream(hstream, hit, hedge_task)
        wasted = _first_frame_tokens(hedge_task)
        hedge_task.cancel()
        with contextlib.suppress(Exception):
            await hstream.close()
        hedger.note_outcome("lost", wasted_tokens=wasted)
        dsp.set(hedge="lost")
        if dprov.enabled():
            dprov.record(
                "remote", "hedge", f"{primary_wid:x}" if primary_wid is not None else None,
                reason="lost", ctx=ctx,
                alternatives=[{"worker": f"{hedge_wid:x}" if hedge_wid is not None else None,
                               "outcome": "cancelled"}],
                wasted_tokens=wasted,
            )
        return _ResumedStream(stream, it, first_task)

    async def __call__(
        self, request: PreprocessedRequest, ctx: Context
    ) -> AsyncIterator[LLMEngineOutput]:
        prompt_len = len(request.token_ids)
        emitted: list[int] = []
        failures = 0  # consecutive failed attempts (reset on progress)
        exclude: set[int] = set()
        req_dict = request.to_dict()
        # vision requests carry side-channel embeddings keyed off the live
        # worker; a mid-stream replay cannot reproduce them faithfully
        can_replay = not any(
            k in request.extra for k in ("mm", "mm_images", "mm_videos")
        )
        # hedging applies to interactive first attempts only (tail latency
        # is an interactive problem), and needs replayability for the same
        # reason migration does: the hedge must reproduce the stream
        hedge_this = self._hedge and can_replay and qos.priority_of(ctx, request) == "interactive"
        attempt = 0
        while True:
            # per-attempt child context: closing a dead attempt's stream
            # kills only the child, not the request
            attempt_ctx = ctx.child()
            attempt += 1
            failure: Optional[str] = None
            progressed = False
            no_instances = False
            stream = None
            t_attempt = dclock.now()
            t_first: Optional[float] = None
            pace: Optional[dhealth.StreamPace] = None
            # per-attempt dispatch span: replays share the request's trace
            # id (ctx carries it), so a migrated stream stays one trace with
            # one dispatch span per attempt, all parented on the root
            with dtrace.span(
                "dispatch", ctx=attempt_ctx, attach=True, attempt=attempt,
                replayed_tokens=len(emitted),
            ) as dsp:
                try:
                    # bounded dispatch, raced against runtime shutdown: a
                    # dead fabric's failover hunt must not hang the replay
                    # past the frontend's own teardown
                    dispatch = self.router.generate(
                        req_dict, attempt_ctx, exclude=exclude or None
                    )
                    if self.cancel_token is not None:
                        stream = await asyncio.wait_for(
                            self.cancel_token.run_until_cancelled(dispatch),
                            self.dispatch_timeout_s,
                        )
                        if stream is None:
                            failure = "frontend runtime shutting down"
                    else:
                        stream = await asyncio.wait_for(dispatch, self.dispatch_timeout_s)
                except asyncio.TimeoutError:
                    failure = f"dispatch timed out after {self.dispatch_timeout_s:.1f}s"
                except Exception as e:  # noqa: BLE001 — dispatch failure
                    failure = f"dispatch failed: {type(e).__name__}: {e}"
                    no_instances = isinstance(e, NoInstancesError)
                if stream is not None:
                    wid = attempt_ctx.metadata.get("worker_instance_id")
                    if self.health is not None and wid is not None:
                        self.health.record(wid, "dispatch", (dclock.now() - t_attempt) * 1e3)
                    if self.hedger is not None:
                        self.hedger.note_dispatch()
                    if hedge_this and attempt == 1 and not emitted:
                        stream = await self._hedged_first(stream, ctx, attempt_ctx, req_dict,
                                                          exclude, dsp)
                        # the hedge may have won: exclusion and health
                        # attribution follow the serving worker
                        wid = attempt_ctx.metadata.get("worker_instance_id")
                    if wid is not None:
                        dsp.set(worker=f"{wid:x}")
                    finished = False
                    try:
                        async for item in stream:
                            if item.is_error():
                                failure = item.error_message() or "worker stream error"
                                break
                            if item.data is None:
                                continue
                            stamp = (item.data.get("stamp")
                                     if isinstance(item.data, dict) else None)
                            if self.fences is not None and self.fences.check_stamp(
                                    stamp, "dispatch"):
                                # zombie worker: the cluster fenced its
                                # epoch — refuse the frame and migrate
                                failure = f"worker epoch {stamp.get('ep', 0):x} is fenced"
                                if self.on_fenced_reject is not None:
                                    with contextlib.suppress(Exception):
                                        self.on_fenced_reject()
                                break
                            out = LLMEngineOutput.from_dict(item.data)
                            if out.trace:
                                # the worker shipped its completed spans on
                                # the final frame: into this process's ring
                                dtrace.ingest(out.trace)
                                out.trace = None
                            if out.decisions:
                                # the same for the worker's decision records
                                dprov.ingest(out.decisions)
                                out.decisions = None
                            if out.token_ids:
                                emitted.extend(out.token_ids)
                                progressed = True
                                if self.health is not None:
                                    # a cold frame's wait held the worker's
                                    # graph capture or kernel load, and a
                                    # fetch's frames share its gap: scored
                                    # by StreamPace (C15)
                                    now = dclock.now()
                                    if t_first is None:
                                        t_first = now
                                        pace = dhealth.StreamPace(now, out.fetch)
                                        ms = (now - t_attempt) * 1e3
                                        if wid is not None and not out.cold:
                                            self.health.record(wid, "first_frame", ms)
                                        if self.hedger is not None:
                                            self.hedger.note_first_frame(ms)
                                    elif pace is not None:
                                        self._record_pace(wid, pace.token(now, out.fetch, out.cold))
                            if out.finish_reason is not None and pace is not None:
                                self._record_pace(wid, pace.flush())
                            yield out
                            if out.finish_reason is not None:
                                finished = True
                                return
                    except (ConnectionError, OSError) as e:
                        failure = f"stream broke: {e}"
                    finally:
                        with contextlib.suppress(Exception):
                            await stream.close()
                    if failure is None and not finished:
                        # EOF with no final: the response plane died
                        failure = "stream ended without a finish reason"
            # ---- the attempt failed; decide whether to migrate ----
            if ctx.is_killed() or ctx.is_stopped():
                yield LLMEngineOutput.final(FinishReason.CANCELLED)
                return
            if self._runtime_dying():
                # frontend is being torn down (fabric/lease loss): emit the
                # structured final NOW, while the response can still flush
                yield LLMEngineOutput.final_error(
                    ctx.id, "migration",
                    f"frontend runtime shutting down during worker failover ({failure})",
                    "worker_unavailable",
                )
                return
            if ctx.expired():
                yield LLMEngineOutput.final_error(
                    ctx.id, "migration", "deadline exceeded during worker failover",
                    "deadline_exceeded",
                )
                return
            fab = getattr(getattr(getattr(self.router, "client", None), "drt", None), "fabric", None)
            if (
                fab is not None
                and getattr(fab, "in_degraded_mode", False)
                and not getattr(fab, "failed_permanently", False)
            ):
                # control-plane blackout, not a worker failure: the fleet is
                # likely healthy, only the dispatch bus is dark. Hold the
                # replay (without burning its retry budget) until the fabric
                # heals — bounded by the kill checks above each pass and by
                # the client's own degraded budget.
                dtrace.event("degraded_hold", cause=failure)
                await fab.wait_connected(2.0)
                continue
            failures = 1 if progressed else failures + 1
            bad = attempt_ctx.metadata.get("worker_instance_id")
            if bad is not None:
                exclude.add(bad)
            if failures > self.max_retries or (emitted and not can_replay):
                yield LLMEngineOutput.final_error(
                    ctx.id, "migration",
                    f"request failed after {failures} attempt(s): {failure}",
                    "worker_failed",
                )
                return
            logger.warning(
                "request %s: worker %s failed mid-stream (%s) — replaying %d "
                "emitted token(s) onto another worker (attempt %d/%d)",
                ctx.id, bad, failure, len(emitted), failures, self.max_retries,
            )
            dtrace.event(
                "migration",
                failed_worker=f"{bad:x}" if bad is not None else None,
                emitted=len(emitted), cause=failure,
            )
            if dprov.enabled():
                dprov.record("remote", "migrate", f"{bad:x}" if bad is not None else None,
                             reason="worker_failed", ctx=ctx, emitted=len(emitted),
                             cause=failure, attempt=failures)
            if emitted:
                req_dict = dict(req_dict)
                req_dict["token_ids"] = list(request.token_ids) + list(emitted)
                extra = dict(req_dict.get("extra") or {})
                extra["resume_prompt_len"] = prompt_len
                req_dict["extra"] = extra
            self.migrations += 1
            if self.on_migration is not None:
                with contextlib.suppress(Exception):
                    self.on_migration()
            if no_instances:
                # every worker unreachable (mass restart): pause until the
                # discovery watch applies a change instead of burning the
                # retry budget against a stale instance list
                waiter = getattr(self.router.client, "wait_instances_changed", None)
                if waiter is not None:
                    await waiter(2.0)
            await asyncio.sleep(full_jitter_delay(failures, self.backoff_base_s, cap_s=2.0))


class WorkerCapacityPoller:
    """Background scrape of one endpoint's aggregated worker load metrics
    (discovery.py:602-665): the fleet's total request slots feed the
    frontend's AdmissionController (the base of the shed watermark), and
    with a HealthScorer each worker's self-reported phase histograms feed
    the tail-tolerance plane and each scrape advances its score tick."""

    def __init__(self, component: Any, endpoint_id: EndpointId, interval_s: float = 2.0,
                 health: Optional[Any] = None) -> None:
        from dynamo_tpu_torch.kv_router.publisher import KvMetricsAggregator

        self.aggregator = KvMetricsAggregator(component, endpoint_id)
        self.interval_s = interval_s
        self.health = health
        self.total_slots: Optional[int] = None
        self.waiting: int = 0
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._loop())

    async def poll_once(self) -> None:
        try:
            per_worker = await self.aggregator.collect()
            self.total_slots = sum(m.worker_stats.request_total_slots
                                   for m in per_worker.values()) or None
            self.waiting = sum(m.worker_stats.num_requests_waiting for m in per_worker.values())
            if self.health is not None:
                for wid, m in per_worker.items():
                    self.health.observe_worker_hists(wid, m.phase_histograms, m.health_histograms)
        except Exception:  # noqa: BLE001 — scrape gaps are tolerated
            self.total_slots = None
        if self.health is not None:
            # tick even on a failed scrape: staleness must age scores
            self.health.tick()

    async def _loop(self) -> None:
        with contextlib.suppress(asyncio.CancelledError):
            while True:
                await self.poll_once()
                await asyncio.sleep(self.interval_s)

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._task


class ModelWatcher:
    """Watches ``models/`` and keeps a ModelManager in sync
    (reference discovery/watcher.rs:69-346). ``migrations`` counts each
    model's in-flight migrations."""

    def __init__(
        self,
        drt: DistributedRuntime,
        manager: ModelManager,
        router_mode: RouterMode = RouterMode.ROUND_ROBIN,
        kv_router_config: Optional[Any] = None,  # kv_router.KvRouterConfig
        metrics: Optional[Any] = None,  # http.metrics.ServiceMetrics
        admission: Optional[Any] = None,  # http.service.AdmissionController
    ) -> None:
        # refuse at start, not at the first worker's registration
        if router_mode is RouterMode.DIRECT:
            raise ValueError(
                "router mode 'direct' needs an instance id with every request, "
                "which a frontend does not pick: use round_robin or random"
            )
        self.drt = drt
        self.manager = manager
        self.router_mode = router_mode
        self.kv_router_config = kv_router_config
        self.metrics = metrics
        self.admission = admission
        self.migrations: dict[str, int] = {}
        self._task: Optional[asyncio.Task] = None
        self._watch = None
        self._clients: dict[str, Any] = {}  # endpoint str -> Client
        self._key_to_model: dict[str, str] = {}
        # KV mode: endpoint str -> KvRouter, and each model's endpoint
        self.kv_routers: dict[str, Any] = {}
        self._model_endpoint: dict[str, str] = {}
        # the trace-export subscriptions (one per worker namespace)
        self._trace_subs: set[str] = set()
        self._trace_tasks: list[asyncio.Task] = []
        # the tail-tolerance plane: one HealthScorer and HedgeController per
        # worker endpoint (shared by its Client, KV scheduler and
        # RemoteEngine, so ejection and hedging see one truth), and a
        # capacity poller per model
        self.health: dict[str, Any] = {}
        self.hedgers: dict[str, Any] = {}
        self.capacity_pollers: dict[str, WorkerCapacityPoller] = {}

    def _make_eject_publisher(self, namespace: str):
        """Ejections are fleet events: published on ``health-status``
        (discovery.py:705-725), where a planner can read them."""

        def on_eject(worker_id: int, cause: str) -> None:
            async def _pub() -> None:
                with contextlib.suppress(Exception):
                    await self.drt.namespace(namespace).publish_event(
                        dhealth.HEALTH_SUBJECT,
                        {"event": "ejected", "worker": worker_id, "cause": cause})

            with contextlib.suppress(RuntimeError):  # no running loop
                asyncio.get_running_loop().create_task(_pub())

        return on_eject

    async def start(self) -> None:
        self._watch = await self.drt.fabric.watch_prefix(MODEL_ROOT)
        for ev in self._watch.initial:
            await self._on_put(ev.key, ev.value)
        self._task = asyncio.get_running_loop().create_task(self._loop())

    async def stop(self) -> None:
        if self._watch is not None:
            await self._watch.cancel()
        if self._task is not None:
            self._task.cancel()
        # the routers stay listed (closed) for the frontend's exit stats
        for kv_router in self.kv_routers.values():
            await kv_router.close()
        for t in self._trace_tasks:
            t.cancel()
        self._trace_tasks.clear()
        for poller in self.capacity_pollers.values():
            await poller.stop()
        self.capacity_pollers.clear()
        for client in self._clients.values():
            await client.close()
        self._clients.clear()

    async def _loop(self) -> None:
        assert self._watch is not None
        with contextlib.suppress(asyncio.CancelledError):
            async for ev in self._watch:
                try:
                    if ev.type == "put":
                        await self._on_put(ev.key, ev.value)
                    else:
                        await self._on_delete(ev.key)
                except Exception:  # noqa: BLE001 — keep watching
                    logger.exception("model watcher failed applying %s", ev.key)

    async def _ensure_trace_ingest(self, namespace: str) -> None:
        """Subscribe (once per namespace, with tracing or the decision
        ledger on) to the workers' ``trace-export`` subject: the fallback
        for spans and decision records whose response stream was torn down
        before its final frame could carry them."""
        if namespace in self._trace_subs or not (dtrace.enabled() or dprov.enabled()):
            return
        self._trace_subs.add(namespace)
        sub = await self.drt.namespace(namespace).subscribe_event(dtrace.EXPORT_SUBJECT)

        async def ingest_loop() -> None:
            async for _subject, payload in sub:
                try:
                    data = mpack.unpackb(payload)
                    if dtrace.enabled():
                        dtrace.ingest(data.get("trace") or [])
                    if dprov.enabled():
                        dprov.ingest(data.get("decisions") or [])
                except Exception:  # noqa: BLE001 — a malformed export
                    continue

        self._trace_tasks.append(asyncio.get_running_loop().create_task(ingest_loop()))

    async def _on_put(self, key: str, value: bytes) -> None:
        entry = ModelEntry.from_bytes(value)
        if self.manager.get(entry.name) is not None:
            self._key_to_model[key] = entry.name
            self.manager.add_model(entry.name, self.manager.get(entry.name), ref=key)  # type: ignore[arg-type]
            return
        mdc = await ModelDeploymentCard.download(self.drt.fabric, entry.slug)
        eid = EndpointId.parse(entry.endpoint)
        endpoint = (
            self.drt.namespace(eid.namespace).component(eid.component).endpoint(eid.name)
        )
        await self._ensure_trace_ingest(eid.namespace)
        client = self._clients.get(entry.endpoint)
        if client is None:
            client = await endpoint.client()
            self._clients[entry.endpoint] = client
        health = self.health.get(entry.endpoint)
        if health is None:
            health = self.health[entry.endpoint] = dhealth.HealthScorer(
                on_eject=self._make_eject_publisher(eid.namespace))
            # latency-ejected workers leave round-robin / random selection
            # and migration replays beside the dead-worker exclusions
            client.health = health
        hedger = self.hedgers.get(entry.endpoint)
        if hedger is None:
            hedger = self.hedgers[entry.endpoint] = dhealth.HedgeController()
        if self.router_mode is RouterMode.KV:
            from dynamo_tpu_torch.kv_router.router import KvPushRouter, KvRouter

            kv_router = self.kv_routers.get(entry.endpoint)
            if kv_router is None:
                kv_router = KvRouter(endpoint.component, client, block_size=mdc.kv_block_size,
                                     config=self.kv_router_config)
                await kv_router.start()
                kv_router.scheduler.health = health
                self.kv_routers[entry.endpoint] = kv_router
                if self.metrics is not None:
                    # the in-process router's hit accounting on the
                    # frontend's /metrics (dyn_llm_kv_hit_rate)
                    self.metrics.attach_kv_hit_stats(kv_router.scheduler)
            router = PushRouter(client, RouterMode.KV, selector=KvPushRouter(kv_router))
        else:
            router = PushRouter(client, self.router_mode)
        # admin fan-out: POST /clear_kv_blocks on the frontend round-trips
        # every worker's clear_kv_blocks endpoint (ref clear_kv_blocks.rs:88)
        clear_endpoint = endpoint.component.endpoint("clear_kv_blocks")
        clear_client_box: dict[str, Any] = {}

        async def clear_fn() -> list[dict]:
            client_c = clear_client_box.get("c")
            if client_c is None:
                client_c = await clear_endpoint.client()
                clear_client_box["c"] = client_c
            results = []
            for iid in client_c.instance_ids():
                stream = None
                try:
                    stream = await client_c.direct({}, iid)
                    async for item in stream:
                        if item.data is not None:
                            results.append({"instance": iid, **dict(item.data)})
                            break
                except Exception as e:  # noqa: BLE001
                    results.append({"instance": iid, "error": str(e)})
                finally:
                    if stream is not None:
                        await stream.close()
            return results

        model_name = entry.name
        self.migrations.setdefault(model_name, 0)

        def on_migration() -> None:
            self.migrations[model_name] += 1
            if self.metrics is not None:
                self.metrics.request_migrations.labels(model_name).inc()

        # epoch fencing: the frontend's registry of cluster-declared-dead
        # epochs (fence/ tombstones) — dispatch frames from a fenced worker
        # are refused and the stream migrates
        fences = None
        with contextlib.suppress(Exception):
            fences = await self.drt.fences()
        execution = ModelExecution(
            mdc,
            RemoteEngine(router, on_migration=on_migration,
                         cancel_token=self.drt.token, fences=fences,
                         health=health, hedger=hedger),
            clear_fn=clear_fn,
        )
        self.manager.add_model(entry.name, execution, ref=key)
        self._key_to_model[key] = entry.name
        if self.metrics is not None:
            # the tail families (attach-once: the first endpoint wins)
            self.metrics.attach_health(health, hedger)
        if entry.name not in self.capacity_pollers:
            # the poller is also the health plane's scrape loop, so it runs
            # with or without admission control
            poller = WorkerCapacityPoller(endpoint.component, eid, health=health)
            poller.start()
            self.capacity_pollers[entry.name] = poller
            if self.admission is not None:
                # the admission watermark follows the fleet's slot count
                self.admission.set_capacity_fn(entry.name, lambda p=poller: p.total_slots)
        self._model_endpoint[entry.name] = entry.endpoint
        logger.info("watcher wired model %s via %s", entry.name, entry.endpoint)

    async def _on_delete(self, key: str) -> None:
        model = self._key_to_model.pop(key, None)
        if model is None:
            return
        if self.manager.remove_ref(model, key):
            poller = self.capacity_pollers.pop(model, None)
            if poller is not None:
                await poller.stop()
            if self.admission is not None:
                self.admission.remove_capacity_fn(model)
            # the model is gone: close its endpoint's KV router unless
            # another model still routes through that endpoint
            ep = self._model_endpoint.pop(model, None)
            if ep is not None and ep not in self._model_endpoint.values():
                kv_router = self.kv_routers.pop(ep, None)
                if kv_router is not None:
                    await kv_router.close()
