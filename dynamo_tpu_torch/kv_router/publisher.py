"""Worker-side publishers of KV-cache events and load metrics, and the
frontend-side aggregator of the metrics.

The port's own copy of dynamo_tpu/kv_router/publisher.py: payloads packed
by the port's codec (``fabric/mpack.py``), byte for byte what
``msgpack.packb(d, use_bin_type=True)`` writes, so a router of either
package reads a worker of either. ``KvMetricsAggregator.aggregate`` sums
everything the reference sums, the per-phase histograms merged by bucket
addition, except the goodput ledger: the port keeps it as a wire dict and
its merge comes with its typed class (ROADMAP.md A12); ``collect`` passes
each worker's through unchanged.

Role-equivalent of lib/llm/src/kv_router/publisher.rs (KvEventPublisher :99,
WorkerMetricsPublisher :481) and metrics_aggregator.rs. The publisher hooks
the engine's stored/removed callbacks directly (no shim process). Metrics
ride a lease-bound fabric kv key (``stats/...``) instead of NATS $SRV
request-reply: the same pull-based scrape, and a dead worker's entry
expires with its lease.
"""

from __future__ import annotations

import asyncio
import contextlib
import itertools
import logging
from typing import Any, Callable, Optional

from dynamo_tpu_torch.fabric import mpack
from dynamo_tpu_torch.kv_router.protocols import (
    ForwardPassMetrics,
    KvCacheEvent,
    KvCacheStoredBlock,
    KvTransferStats,
    RouterEvent,
    SpecDecodeStats,
)
from dynamo_tpu_torch.runtime.protocols import EndpointId
from dynamo_tpu_torch.telemetry.histogram import PhaseHistograms

logger = logging.getLogger("dynamo_tpu_torch.kv_router.publisher")

KV_EVENT_SUBJECT = "kv_events"
STATS_ROOT = "stats/"


def stats_key(endpoint: EndpointId, instance_id: int) -> str:
    return f"{STATS_ROOT}{endpoint.namespace}/{endpoint.component}/{endpoint.name}:{instance_id:x}"


class KvEventPublisher:
    """Forwards engine block store/remove callbacks as RouterEvents on the
    component's ``kv_events`` subject."""

    def __init__(self, component: Any, worker_id: int) -> None:
        self.component = component
        self.worker_id = worker_id
        self._event_id = itertools.count()
        self._tasks: set[asyncio.Task] = set()

    # these two match TorchEngine's on_blocks_stored / on_blocks_removed

    def on_blocks_stored(self, blocks: list[dict]) -> None:
        if not blocks:
            return
        # split into contiguous chain runs: each block carries its own
        # parent_hash, and a batch may skip blocks already published
        run: list[dict] = []
        for b in blocks:
            if run and b.get("parent_hash") != run[-1]["block_hash"]:
                self._emit_run(run)
                run = []
            run.append(b)
        self._emit_run(run)

    def _emit_run(self, run: list[dict]) -> None:
        if not run:
            return
        self._publish(KvCacheEvent.stored_event(
            next(self._event_id),
            run[0].get("parent_hash") or None,
            [KvCacheStoredBlock(b["block_hash"]) for b in run],
        ))

    def on_blocks_removed(self, block_hashes: list[int]) -> None:
        if not block_hashes:
            return
        self._publish(KvCacheEvent.removed_event(next(self._event_id), block_hashes))

    def publish_cleared(self) -> None:
        self._publish(KvCacheEvent.cleared_event(next(self._event_id)))

    def _publish(self, event: KvCacheEvent) -> None:
        payload = RouterEvent(self.worker_id, event).to_dict()

        async def _send() -> None:
            with contextlib.suppress(Exception):
                await self.component.namespace.publish_event(KV_EVENT_SUBJECT, payload)

        try:
            task = asyncio.get_running_loop().create_task(_send())
        except RuntimeError:
            return  # no loop: an engine driven synchronously
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def drain(self) -> None:
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)


class WorkerMetricsPublisher:
    """Snapshots the engine's stats into the fabric stats key every
    ``interval_s``."""

    def __init__(
        self,
        component: Any,
        endpoint: EndpointId,
        instance_id: int,
        interval_s: float = 1.0,
        stamp: Optional[dict] = None,  # fencing (instance_id, epoch) stamp
    ) -> None:
        self.component = component
        self.endpoint = endpoint
        self.instance_id = instance_id
        self.interval_s = interval_s
        self.stamp = stamp
        self._task: Optional[asyncio.Task] = None
        self._latest: Optional[ForwardPassMetrics] = None

    def publish(self, metrics: ForwardPassMetrics) -> None:
        """Record the latest snapshot (last wins)."""
        self._latest = metrics

    async def start(self, metrics_fn: Optional[Callable[[], ForwardPassMetrics]] = None) -> None:
        """``metrics_fn``: a zero-arg callable polled each interval."""
        if self._task is not None:
            return
        drt = self.component.drt
        key = stats_key(self.endpoint, self.instance_id)

        async def loop() -> None:
            while True:
                m = metrics_fn() if metrics_fn is not None else self._latest
                if m is not None:
                    with contextlib.suppress(Exception):
                        d = m.to_dict()
                        if self.stamp is not None:
                            # aggregators drop publishes of a fenced epoch
                            d["stamp"] = self.stamp
                        await drt.fabric.kv_put(key, mpack.packb(d), lease_id=drt.primary_lease)
                await asyncio.sleep(self.interval_s)

        self._task = asyncio.create_task(loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._task
            self._task = None


def _add_counts(into: Optional[dict], more: Optional[dict]) -> Optional[dict]:
    if not more:
        return into
    into = dict(into or {})
    for k, v in more.items():
        into[k] = into.get(k, 0) + v
    return into


class KvMetricsAggregator:
    """Frontend/router-side scrape of every worker's ForwardPassMetrics
    (reference metrics_aggregator.rs:210 + scoring.rs ProcessedEndpoints)."""

    def __init__(self, component: Any, endpoint: EndpointId) -> None:
        self.component = component
        self.endpoint = endpoint
        self._fences = None

    async def _fence_registry(self):
        if self._fences is None:
            with contextlib.suppress(Exception):  # fencing is best-effort here
                self._fences = await self.component.drt.fences()
        return self._fences

    async def collect(self) -> dict[int, ForwardPassMetrics]:
        prefix = f"{STATS_ROOT}{self.endpoint.namespace}/{self.endpoint.component}/{self.endpoint.name}:"
        raw = await self.component.drt.fabric.kv_get_prefix(prefix)
        fences = await self._fence_registry()
        out: dict[int, ForwardPassMetrics] = {}
        for key, value in raw.items():
            try:
                instance_id = int(key.rsplit(":", 1)[1], 16)
                d = mpack.unpackb(value)
                if fences is not None and fences.check_stamp(d.get("stamp"), "metrics"):
                    continue  # a fenced incarnation's load: never route by it
                out[instance_id] = ForwardPassMetrics.from_dict(d)
            except Exception:  # noqa: BLE001 - one bad entry must not stop the scrape
                logger.exception("bad stats entry at %s", key)
        return out

    async def aggregate(
        self, per_worker: Optional[dict[int, ForwardPassMetrics]] = None
    ) -> ForwardPassMetrics:
        """Sum across workers (gauges averaged, the brownout rung the
        fleet's worst). Pass an already-collected snapshot to avoid a second
        scrape."""
        if per_worker is None:
            per_worker = await self.collect()
        agg = ForwardPassMetrics()
        ws, kv = agg.worker_stats, agg.kv_stats
        # the dataclass defaults are "one idle worker" sentinels; an
        # aggregate starts from zero
        kv.kv_total_blocks = 0
        ws.request_total_slots = 0
        for m in per_worker.values():
            w = m.worker_stats
            for f in ("request_active_slots", "request_total_slots", "num_requests_waiting",
                      "num_deadline_exceeded", "num_watchdog_trips", "num_preempted_too_often",
                      "num_shed_brownout", "num_blocks_quarantined",
                      "decode_hbm_bytes_per_token", "mfu_decode_est",
                      "tp_collective_bytes_per_step"):
                setattr(ws, f, getattr(ws, f) + getattr(w, f))
            ws.brownout_level = max(ws.brownout_level, w.brownout_level)
            for f in ("preemptions_by_class", "integrity_failures_by_path",
                      "fenced_rejects_by_plane", "kv_pulled_blocks_by_outcome"):
                setattr(ws, f, _add_counts(getattr(ws, f), getattr(w, f)))
            for f in ("kv_active_blocks", "kv_total_blocks", "gpu_cache_usage_perc",
                      "gpu_prefix_cache_hit_rate"):
                setattr(kv, f, getattr(kv, f) + getattr(m.kv_stats, f))
            if m.spec_decode_stats is not None:
                if agg.spec_decode_stats is None:
                    agg.spec_decode_stats = SpecDecodeStats()
                agg.spec_decode_stats.merge(m.spec_decode_stats)
            if m.kv_transfer_stats is not None:
                if agg.kv_transfer_stats is None:
                    agg.kv_transfer_stats = KvTransferStats()
                agg.kv_transfer_stats.merge(m.kv_transfer_stats)
            if m.phase_histograms is not None:
                # bucket addition over the shared fixed-log grid: the merged
                # distribution is exact, so fleet percentiles are true ones
                if agg.phase_histograms is None:
                    agg.phase_histograms = PhaseHistograms()
                agg.phase_histograms.merge(m.phase_histograms)
        n = len(per_worker)
        if n:
            kv.gpu_cache_usage_perc /= n
            kv.gpu_prefix_cache_hit_rate /= n
            ws.decode_hbm_bytes_per_token /= n
            ws.mfu_decode_est /= n
            ws.tp_collective_bytes_per_step /= n
        return agg
