"""`python -m dynamo_tpu_torch.router` — the standalone KV-aware router.

The port's own copy of dynamo_tpu/router.py: one process owns the KV-overlap
index (worker cache events -> radix tree -> cost-based selection) and serves
routing decisions on a fabric endpoint, so N stateless frontends share one
routing brain. With ``--metrics-port`` it serves ``/metrics``, ``/health``
and ``/live`` (``runtime/http_server.py``) from ``build_router_registry``:
the KV hit rates, the pull-planning counters, the decision and shed
counters, and its health scorer's families. The scorer is fed by the same
load scrape that decides sheds (the workers' self-reported phase
histograms, one tick a scrape), and its ejected workers leave the router's
candidate set. A traced request's decision runs under a ``route_decision``
span on the ``router`` track, shipped back in the reply's ``trace``; its
decision records (``router/route``, ``router/prefix_pull``) in the reply's
``decisions``, and this process's decision counts on ``/metrics``.

Endpoint: ``<namespace>.router.find_best``
  request : {"token_ids": [...], "request_id": "..."}   (or {"tokens": ...})
  response: {"worker_id": int, "overlap_blocks": int, "fleet_frac": float,
             "prefix_pull": {plan}, "trace": [span dicts],
             "decisions": [record dicts]}   (prefix_pull: only when the
             scheduler made a pull plan; trace: only for a traced request;
             decisions: with the decision ledger on and a request id)
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
from dynamo_tpu_torch.runtime import logging as dlog
from dynamo_tpu_torch.telemetry import provenance as dprov
from dynamo_tpu_torch.telemetry import trace as dtrace

logger = logging.getLogger("dynamo_tpu_torch.router")


def build_router_registry(scheduler, decisions_fn, shed_fn, health=None):
    """The standalone router's Prometheus registry (router.py:37-160): the
    hit-rate gauges and monotonic counters with counter semantics, and the
    health scorer's families. Factored out so a lint can walk it without a
    live router."""
    from dynamo_tpu_torch.kv_router.protocols import PULL_OUTCOMES
    from dynamo_tpu_torch.runtime.prom import (
        CallbackCounter,
        CollectorRegistry,
        CounterMetricFamily,
        Gauge,
        GaugeMetricFamily,
    )

    registry = CollectorRegistry()
    if health is not None:
        # per-worker health scores and ejections as this router's scorer
        # sees them (the frontend exports the same families from its own)
        class _HealthCollector:
            def collect(self):
                score = GaugeMetricFamily(
                    "dyn_llm_worker_health_score",
                    "Worker slowness ratio vs the fleet median "
                    "(1.0 typical; >= DYN_EJECT_RATIO is an outlier)",
                    labels=["instance"],
                )
                for wid, v in sorted(health.scores().items()):
                    score.add_metric([f"{wid:x}"], float(v))
                yield score
                yield GaugeMetricFamily(
                    "dyn_llm_workers_ejected",
                    "Workers currently ejected from routing as latency "
                    "outliers (probation trickle still flows)",
                    value=float(len(health.ejected())),
                )
                ej = CounterMetricFamily(
                    "dyn_llm_ejections",
                    "Latency-outlier ejections by dominant slow signal",
                    labels=["cause"],
                )
                for cause, v in sorted(health.ejections_total.items()):
                    ej.add_metric([str(cause)], float(v))
                yield ej

        registry.register(_HealthCollector())
    g = Gauge("dyn_llm_kv_hit_rate", "Router KV hit rate: matched / required prefill blocks",
              registry=registry)
    g.set_function(lambda: scheduler.hit_rate)
    CallbackCounter(registry, "dyn_llm_kv_matched_blocks_total",
                    "Prefill blocks served from a routed worker's cache",
                    lambda: scheduler.hit_stats["matched_blocks"])
    # the fleet-best match rate and the router-side pull planning; realized
    # pull outcomes are engine-side, so that family stays zero here
    g_fleet = Gauge("dyn_llm_kv_fleet_hit_rate",
                    "Fleet-best KV match rate: best matched / required prefill "
                    "blocks held anywhere in the fleet", registry=registry)
    g_fleet.set_function(lambda: scheduler.fleet_hit_rate)
    CallbackCounter(registry, "dyn_llm_kv_pull_plans_total",
                    "Prefix-pull plans attached to routing decisions",
                    lambda: scheduler.pull_stats["plans"])
    CallbackCounter(registry, "dyn_llm_kv_pull_planned_blocks_total",
                    "Prefix blocks the router planned to pull from peers",
                    lambda: scheduler.pull_stats["planned_blocks"])

    class _PullCollector:
        def collect(self):
            fam = CounterMetricFamily(
                "dyn_llm_kv_pulled_blocks",
                "Prefix blocks resolved by peer pull (or fallen back "
                "to local compute), by outcome",
                labels=["outcome"],
            )
            for key in PULL_OUTCOMES:
                fam.add_metric([key], 0.0)
            yield fam

    registry.register(_PullCollector())
    # this process's decision-provenance counts (route / prefix_pull)
    from dynamo_tpu_torch.components.metrics import decision_families

    class _DecisionCollector:
        def describe(self):
            return []

        def collect(self):
            yield from decision_families()

    registry.register(_DecisionCollector())
    CallbackCounter(registry, "dyn_llm_router_decisions_total", "Routing decisions served",
                    decisions_fn)
    CallbackCounter(registry, "dyn_llm_requests_shed_total",
                    "Requests shed by admission control (429)", shed_fn)
    return registry


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
        # the tail-tolerance plane, scored from the workers' self-reported
        # phase histograms (the same load scrape), so latency-ejected
        # stragglers leave this router's candidate set too
        from dynamo_tpu_torch.telemetry.health import HealthScorer

        self.health = HealthScorer()
        # /metrics and /health of the router itself (None: off)
        self.metrics_port = metrics_port
        self._status_server = None

    async def start(self) -> None:
        from dynamo_tpu_torch.kv_router.publisher import KvMetricsAggregator
        from dynamo_tpu_torch.kv_router.router import KvRouter

        client = await self.worker_endpoint.client()
        client.health = self.health
        self.router = KvRouter(self.component, client, block_size=self.block_size,
                               config=self.kv_config)
        await self.router.start()
        self.router.scheduler.health = self.health
        self._aggregator = KvMetricsAggregator(self.component, self.worker_endpoint.id)
        serve_ep = self.drt.namespace(self.namespace).component("router").endpoint("find_best")
        self._service = await serve_ep.serve_endpoint(self._handler)
        if self.metrics_port is not None:
            await self._start_status_server()
        logger.info("standalone router serving %s.router.find_best for %s", self.namespace,
                    self.worker_endpoint.id)

    async def _start_status_server(self) -> int:
        """The router's own observability plane on ``metrics_port``."""
        from dynamo_tpu_torch.runtime.http_server import SystemStatusServer

        registry = build_router_registry(self.router.scheduler, lambda: self.decisions_total,
                                         lambda: self.shed_total, health=self.health)
        self._status_server = SystemStatusServer(port=self.metrics_port, registry=registry)
        port = await self._status_server.start()
        logger.info("standalone router /metrics on :%d", port)
        return port

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
                # the same scrape feeds the health plane
                for wid, m in per_worker.items():
                    self.health.observe_worker_hists(wid, m.phase_histograms, m.health_histograms)
            except Exception:  # noqa: BLE001 - missing stats = no shedding
                self._load = (0, 0)
            self._load_at = now
            self.health.tick()
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
        # the trace context rides Context.metadata over the find_best hop,
        # so the decision lands on the request's assembled timeline; the
        # span ships back in the reply (this process has no final frame of
        # its own on the response plane)
        with dtrace.span("route_decision", ctx=ctx, proc="router") as rsp:
            if await self._overloaded():
                self.shed_total += 1
                retry_ms = self._retry_after_ms()
                rsp.set(shed=True, retry_after_ms=retry_ms)
                yield {"shed": True, "retry_after_ms": retry_ms}
                return
            tokens = request.get("token_ids") or request.get("tokens") or []
            request_id = str(request.get("request_id", ""))
            result = await self.router.route(list(tokens), request_id=request_id or None)
            self.decisions_total += 1
            rsp.set(worker=f"{result.worker_id:x}", overlap_blocks=result.overlap_blocks)
        out = {"worker_id": result.worker_id, "overlap_blocks": result.overlap_blocks}
        # the caller's dispatch puts the plan on its Context, so the chosen
        # engine pulls the missing prefix from the named holder first
        if result.pull_plan is not None:
            out["prefix_pull"] = result.pull_plan
        if result.required_blocks:
            out["fleet_frac"] = round(result.fleet_blocks / result.required_blocks, 4)
        if rsp.trace_id:
            out["trace"] = dtrace.export_for_trace(rsp.trace_id, include_remote=False)
        if dprov.enabled() and request_id:
            # the router has no final frame of its own: the decision's
            # records ride the reply, like the span above
            recs = dprov.export_for_request(request_id)
            if recs:
                out["decisions"] = recs
        yield out

    async def close(self) -> None:
        if self._status_server is not None:
            await self._status_server.close()
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
        if router._status_server is not None:
            print(f"router metrics on :{router._status_server.port}", flush=True)
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
    dlog.init(force=True)
    ap = argparse.ArgumentParser(prog="dynamo_tpu_torch.router", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--namespace", default="dynamo")
    ap.add_argument("--component", default="backend")
    ap.add_argument("--endpoint", default="generate")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--kv-overlap-score-weight", type=float, default=1.0)
    ap.add_argument("--router-temperature", type=float, default=0.0)
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics and /health on this port (0: any free port)")
    args = ap.parse_args(argv)
    from dynamo_tpu_torch.runtime.config import RuntimeConfig

    if not RuntimeConfig.from_settings().fabric_addr:
        # a router on a process-local fabric would see no worker
        raise SystemExit("the standalone router needs the fabric: set DYN_FABRIC_ADDR=host:port")
    asyncio.run(_amain(args))


if __name__ == "__main__":
    main()
