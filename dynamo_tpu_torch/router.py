"""`python -m dynamo_tpu_torch.router` — the standalone KV-aware router.

The port's own copy of dynamo_tpu/router.py: one process owns the KV-overlap
index (worker cache events -> radix tree -> cost-based selection) and serves
routing decisions on a fabric endpoint, so N stateless frontends share one
routing brain. Left out (ROADMAP.md A10 part 2): the router's own
``/metrics`` and ``/health`` server (``--metrics-port`` is refused) and the
health scorer's ejection of slow workers; the decision provenance and trace
spans in a reply come with A12.

Endpoint: ``<namespace>.router.find_best``
  request : {"token_ids": [...], "request_id": "..."}   (or {"tokens": ...})
  response: {"worker_id": int, "overlap_blocks": int, "fleet_frac": float}
           | {"shed": true, "retry_after_ms": int}   (fleet overloaded)
  request : {"op": "free", "request_id": "..."}  -> {"ok": true}
  request : {"op": "index"} -> {"index_blocks": {worker hex id: blocks},
            "decisions": n, "events": n}   (the port's probe of its index)

A frontend then sends the request to the chosen worker itself and reports
its completion with ``op: free``. A ``shed`` answer means the fleet's
aggregated load (active slots + queued requests from the workers' load
metrics, a snapshot at most 1 s old) is past slots x
``DYN_ADMISSION_QUEUE_FACTOR`` (2.0): the frontend should answer 429 with the
Retry-After, which is the backlog above the watermark over the measured
completion rate (``qos.DrainRateEstimator``).

Role-equivalent of the reference's standalone router bin
(components/router/src/main.rs:97).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal
import time
from typing import Any, Optional

from dynamo_tpu_torch import qos

logger = logging.getLogger("dynamo_tpu_torch.router")

METRICS_PORT_MISSING = (
    "--metrics-port needs the router's Prometheus registry and status server "
    "(prometheus_client, runtime/http_server.py), which the port does not have yet: "
    "ROADMAP.md A10 part 2"
)


class StandaloneRouter:
    """Hosts a KvRouter and serves find_best decisions over the fabric, with
    fleet-level load shedding from the workers' aggregated load metrics."""

    def __init__(
        self,
        drt: Any,
        namespace: str = "dynamo",
        component: str = "backend",
        endpoint: str = "generate",
        block_size: int = 16,
        kv_config: Optional[Any] = None,
        queue_factor: Optional[float] = None,
        metrics_port: Optional[int] = None,
    ) -> None:
        if metrics_port is not None:
            raise NotImplementedError(METRICS_PORT_MISSING)
        self.drt = drt
        self.namespace = namespace
        self.component = drt.namespace(namespace).component(component)
        self.worker_endpoint = self.component.endpoint(endpoint)
        self.block_size = block_size
        self.kv_config = kv_config
        self.queue_factor = (
            queue_factor if queue_factor is not None
            else float(os.environ.get("DYN_ADMISSION_QUEUE_FACTOR", "2.0"))
        )
        self.router = None
        self._service = None
        self._aggregator = None
        self._load: Optional[tuple[int, int]] = None  # (slots, active + waiting)
        self._load_at = 0.0
        self.shed_total = 0
        self.decisions_total = 0
        # completions (op=free) feed the Retry-After of a shed
        self._drain = qos.DrainRateEstimator()

    async def start(self) -> None:
        from dynamo_tpu_torch.kv_router.publisher import KvMetricsAggregator
        from dynamo_tpu_torch.kv_router.router import KvRouter

        client = await self.worker_endpoint.client()
        self.router = KvRouter(self.component, client, block_size=self.block_size,
                               config=self.kv_config)
        await self.router.start()
        self._aggregator = KvMetricsAggregator(self.component, self.worker_endpoint.id)
        serve_ep = self.drt.namespace(self.namespace).component("router").endpoint("find_best")
        self._service = await serve_ep.serve_endpoint(self._handler)
        logger.info("standalone router serving %s.router.find_best for %s", self.namespace,
                    self.worker_endpoint.id)

    async def _overloaded(self) -> bool:
        """Fleet past the admission watermark? From a load snapshot cached
        for 1 s, so a decision never waits on a scrape each."""
        if self._aggregator is None:
            return False
        now = time.monotonic()
        if self._load is None or now - self._load_at > 1.0:
            try:
                per_worker = await self._aggregator.collect()
                slots = sum(m.worker_stats.request_total_slots for m in per_worker.values())
                load = sum(m.worker_stats.request_active_slots + m.worker_stats.num_requests_waiting
                           for m in per_worker.values())
                self._load = (slots, load)
            except Exception:  # noqa: BLE001 - missing stats = no shedding
                self._load = (0, 0)
            self._load_at = now
        slots, load = self._load
        return bool(slots) and load >= slots * self.queue_factor

    def _retry_after_ms(self) -> int:
        """The backlog above the watermark over the measured drain rate
        (1 s with no signal)."""
        excess = 1
        if self._load is not None:
            slots, load = self._load
            excess = max(1, load - int(slots * self.queue_factor) + 1)
        return int(self._drain.retry_after_s(excess, 1.0) * 1e3)

    async def _handler(self, request: dict, ctx):
        op = request.get("op")
        if op == "free":
            self.router.free(str(request.get("request_id", "")))
            self._drain.note()
            yield {"ok": True}
            return
        if op == "index":
            yield {"index_blocks": {f"{w:x}": n for w, n in self.router.indexer.block_counts().items()},
                   "decisions": self.decisions_total, "events": self.router.events_applied}
            return
        if await self._overloaded():
            self.shed_total += 1
            yield {"shed": True, "retry_after_ms": self._retry_after_ms()}
            return
        tokens = request.get("token_ids") or request.get("tokens") or []
        request_id = str(request.get("request_id", ""))
        result = await self.router.route(list(tokens), request_id=request_id or None)
        self.decisions_total += 1
        out = {"worker_id": result.worker_id, "overlap_blocks": result.overlap_blocks}
        if result.required_blocks:
            out["fleet_frac"] = round(result.fleet_blocks / result.required_blocks, 4)
        yield out

    async def close(self) -> None:
        if self._service is not None:
            await self._service.stop()
        if self.router is not None:
            await self.router.close()


async def _amain(args) -> None:
    from dynamo_tpu_torch.kv_router.scheduler import KvRouterConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    router = None
    drt = await DistributedRuntime.from_settings()
    try:
        router = StandaloneRouter(
            drt,
            namespace=args.namespace,
            component=args.component,
            endpoint=args.endpoint,
            block_size=args.block_size,
            kv_config=KvRouterConfig(
                overlap_score_weight=args.kv_overlap_score_weight,
                router_temperature=args.router_temperature,
            ),
            metrics_port=args.metrics_port,
        )
        await router.start()
        print(f"standalone router on {args.namespace}.router.find_best", flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
    finally:
        if router is not None:
            await router.close()
        await drt.close()


def main(argv: Optional[list[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    ap = argparse.ArgumentParser(prog="dynamo_tpu_torch.router", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--namespace", default="dynamo")
    ap.add_argument("--component", default="backend")
    ap.add_argument("--endpoint", default="generate")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--kv-overlap-score-weight", type=float, default=1.0)
    ap.add_argument("--router-temperature", type=float, default=0.0)
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="refused: the router's /metrics comes with ROADMAP.md A10 part 2")
    args = ap.parse_args(argv)
    if args.metrics_port is not None:
        raise SystemExit(METRICS_PORT_MISSING)
    from dynamo_tpu_torch.runtime.config import RuntimeConfig

    if not RuntimeConfig.from_settings().fabric_addr:
        # a router on a process-local fabric would see no worker
        raise SystemExit("the standalone router needs the fabric: set DYN_FABRIC_ADDR=host:port")
    asyncio.run(_amain(args))


if __name__ == "__main__":
    main()
