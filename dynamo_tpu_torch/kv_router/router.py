"""KvRouter: ties the indexer and the scheduler to live discovery and the
workers' KV events.

The port's own copy of dynamo_tpu/kv_router/router.py, its events decoded by
the port's codec (``fabric/mpack.py``, byte-identical to msgpack).

Role-equivalent of lib/llm/src/kv_router.rs (KvRouter :129, KvPushRouter
:289): subscribes to the component's ``kv_events`` subject, feeds the
indexer, tracks the live instance set from the Client's discovery watch, and
answers ``find_best_match(tokens) -> (worker_id, overlap_blocks)``.
KvPushRouter is the WorkerSelector plugged into PushRouter's KV mode.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
from typing import Any, Optional

from dynamo_tpu_torch.fabric import mpack
from dynamo_tpu_torch.kv_router.indexer import ApproxKvIndexer, KvIndexer
from dynamo_tpu_torch.kv_router.protocols import RouterEvent
from dynamo_tpu_torch.kv_router.scheduler import (
    DefaultWorkerSelector,
    KvRouterConfig,
    KvScheduler,
    WorkerSelectionResult,
    WorkerSelector,
)
from dynamo_tpu_torch.pipeline.context import Context
from dynamo_tpu_torch.tokens import compute_seq_hash_chain

logger = logging.getLogger("dynamo_tpu_torch.kv_router")

KV_EVENT_SUBJECT = "kv_events"
KV_HIT_RATE_SUBJECT = "kv-hit-rate"


class KvRouter:
    """Selects a worker; does not route (that is KvPushRouter/PushRouter)."""

    def __init__(
        self,
        component: Any,  # runtime.component.Component
        client: Any,  # runtime.component.Client of the workers' endpoint
        block_size: int,
        config: Optional[KvRouterConfig] = None,
        selector: Optional[WorkerSelector] = None,
    ) -> None:
        self.component = component
        self.client = client
        self.block_size = block_size
        self.config = config or KvRouterConfig()
        if self.config.use_kv_events:
            horizon = self.config.frequency_horizon_s or None
            self.indexer: KvIndexer | ApproxKvIndexer = KvIndexer(
                block_size, expiration_duration=horizon)
        else:
            self.indexer = ApproxKvIndexer(block_size, self.config.ttl_secs)
        self.scheduler = KvScheduler(
            block_size,
            selector or DefaultWorkerSelector(self.config),
            on_hit_rate_event=self._queue_hit_rate_event,
            config=self.config,
        )
        self.events_applied = 0
        self._tasks: list[asyncio.Task] = []
        self._known_workers: set[int] = set()
        self._started = False

    async def start(self) -> None:
        if self._started:
            return
        self._started = True
        if self.config.use_kv_events:
            sub = await self.component.namespace.subscribe_event(KV_EVENT_SUBJECT)
            self._tasks.append(asyncio.create_task(self._event_loop(sub)))
        self._tasks.append(asyncio.create_task(self._instance_loop()))
        self._sync_workers()

    async def close(self) -> None:
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            with contextlib.suppress(asyncio.CancelledError):
                await t
        self._tasks.clear()

    # ---------------------------------------------------------- event feeds

    async def _event_loop(self, sub) -> None:
        async for _subject, payload in sub:
            try:
                event = RouterEvent.from_dict(mpack.unpackb(payload))
            except Exception:  # noqa: BLE001 - one bad payload must not stop the feed
                logger.exception("bad kv event payload; dropping")
                continue
            self.indexer.apply_event(event)
            self.events_applied += 1

    async def _instance_loop(self) -> None:
        """Poll the client's discovery-fed instance set for worker churn."""
        while True:
            self._sync_workers()
            await asyncio.sleep(0.2)

    def _sync_workers(self) -> None:
        live = set(self.client.instance_ids())
        if live == self._known_workers:
            return
        for dead in self._known_workers - live:
            self.indexer.remove_worker(dead)
            logger.info("kv router: worker %x left", dead)
        for new in live - self._known_workers:
            logger.info("kv router: worker %x joined", new)
        self._known_workers = live
        self.scheduler.update_workers(list(live))

    def _queue_hit_rate_event(self, ev) -> None:
        async def _publish() -> None:
            with contextlib.suppress(Exception):
                await self.component.namespace.publish_event(KV_HIT_RATE_SUBJECT, ev.to_dict())

        with contextlib.suppress(RuntimeError):  # no running loop
            task = asyncio.get_running_loop().create_task(_publish())
            self._tasks.append(task)
            self._tasks = [t for t in self._tasks if not t.done()]

    # ------------------------------------------------------------- routing

    async def route(
        self, token_ids: list[int], request_id: Optional[str] = None
    ) -> WorkerSelectionResult:
        """Full routing decision: the chosen worker, its local overlap and
        the fleet-best overlap."""
        if not self._started:
            await self.start()
        self._sync_workers()
        chain = compute_seq_hash_chain(token_ids, self.block_size)
        overlap = self.indexer.find_matches(chain)
        result = self.scheduler.schedule(token_ids, overlap, request_id, chain=chain)
        if isinstance(self.indexer, ApproxKvIndexer):
            self.indexer.process_routing_decision_for_request(token_ids, result.worker_id)
        logger.debug("kv router: request %s -> worker %x (%d of %d blocks cached; fleet %d)",
                     request_id, result.worker_id, result.overlap_blocks,
                     result.required_blocks, result.fleet_blocks)
        return result

    async def find_best_match(
        self, token_ids: list[int], request_id: Optional[str] = None
    ) -> tuple[int, int]:
        """Returns (worker_id, overlap_blocks)."""
        result = await self.route(token_ids, request_id=request_id)
        return result.worker_id, result.overlap_blocks

    def free(self, request_id: str) -> None:
        self.scheduler.free(request_id)


class KvPushRouter:
    """WorkerSelector adapter: lets PushRouter(mode=KV) consult a KvRouter
    (reference kv_router.rs:289 KvPushRouter)."""

    def __init__(self, router: KvRouter) -> None:
        self.router = router

    async def select_worker(self, token_ids: list[int], context: Context) -> tuple[int, float]:
        result = await self.router.route(token_ids, request_id=context.id)
        # the pull plan and the fleet-matched fraction ride Context.metadata
        # across the hop: the engine reads the plan (its peer tier pulls the
        # gap, its tier takes the plan's fleet heat)
        carrier = context.decisions()
        if result.pull_plan is not None:
            carrier.pull_plan = result.pull_plan
        if result.required_blocks:
            carrier.kv_fleet_frac = round(result.fleet_blocks / result.required_blocks, 4)
        return result.worker_id, float(result.overlap_blocks)

    def on_request_complete(self, context: Context) -> None:
        self.router.free(context.id)
