"""Frontend Prometheus metrics.

The port's own copy of dynamo_tpu/http/metrics.py on the port's stdlib
registry (``runtime/prom.py``; the card's machine has no
``prometheus_client``). Role-equivalent of lib/llm/src/http/service/metrics.rs:
per-model request counts by status, inflight, duration, TTFT, inter-token
latency and token counts, class-aware sheds, migrations and deadlines, and
the scrape-time families of the ``attach_*`` hooks (spec decode, the KV data
plane, engine QoS, integrity and fence counters, control-plane health, the
tail-tolerance plane, the brownout ladder, the KV router's hit rates and
peer-pull outcomes, a colocated engine's goodput ledger, this process's
decision-provenance counts). Exposed at ``GET /metrics``. Every family keeps
the reference's name, type, labels and help.

Left out, with the module that feeds them (ROADMAP A12.3): the planner
families (``attach_planner``).
"""

from __future__ import annotations

import time
from contextlib import contextmanager

from dynamo_tpu_torch.runtime.prom import (
    CallbackCounter,
    CollectorRegistry,
    Counter,
    CounterMetricFamily,
    Gauge,
    GaugeMetricFamily,
    Histogram,
    HistogramMetricFamily,
    generate_latest,
)
from dynamo_tpu_torch.telemetry.histogram import BOUNDS, NUM_BUCKETS, PhaseHistograms

PREFIX = "dyn_llm_http_service"

# every 4th bucket of the fixed-log grid (x2 apart) as Prometheus buckets,
# as the reference's metrics component exports the merged histograms
_EXPORT_IDX = tuple(range(3, NUM_BUCKETS, 4))

_DURATION_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
    60.0, 120.0, 300.0,
)
_TTFT_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0,
)


class ServiceMetrics:
    def __init__(self, registry: CollectorRegistry | None = None) -> None:
        self.registry = registry or CollectorRegistry()
        self.requests_total = Counter(
            f"{PREFIX}_requests_total",
            "Total requests",
            ["model", "endpoint", "status"],
            registry=self.registry,
        )
        self.inflight = Gauge(
            f"{PREFIX}_inflight_requests",
            "Currently executing requests",
            ["model", "endpoint"],
            registry=self.registry,
        )
        self.request_duration = Histogram(
            f"{PREFIX}_request_duration_seconds",
            "End-to-end request duration",
            ["model", "endpoint"],
            buckets=_DURATION_BUCKETS,
            registry=self.registry,
        )
        self.time_to_first_token = Histogram(
            f"{PREFIX}_time_to_first_token_seconds",
            "Time to first streamed token",
            ["model"],
            buckets=_TTFT_BUCKETS,
            registry=self.registry,
        )
        self.inter_token_latency = Histogram(
            f"{PREFIX}_inter_token_latency_seconds",
            "Latency between streamed tokens",
            ["model"],
            buckets=_TTFT_BUCKETS,
            registry=self.registry,
        )
        self.prompt_tokens = Counter(
            f"{PREFIX}_prompt_tokens_total",
            "Prompt tokens processed",
            ["model"],
            registry=self.registry,
        )
        self.output_tokens = Counter(
            f"{PREFIX}_output_tokens_total",
            "Output tokens generated",
            ["model"],
            registry=self.registry,
        )
        # request lifeguard: admission-control sheds (429s), in-flight
        # migrations across worker failure, and deadline expiries observed
        # at this frontend
        self.requests_shed = Counter(
            "dyn_llm_requests_shed_total",
            "Requests shed by admission control (429)",
            ["model"],
            registry=self.registry,
        )
        self.request_migrations = Counter(
            "dyn_llm_request_migrations_total",
            "In-flight requests migrated to another worker",
            ["model"],
            registry=self.registry,
        )
        self.deadline_exceeded = Counter(
            "dyn_llm_deadline_exceeded_total",
            "Requests cancelled on deadline/TTFT expiry",
            ["model"],
            registry=self.registry,
        )
        # QoS plane: class-aware sheds (reason = watermark | brownout).
        # The class-blind dyn_llm_requests_shed_total above stays for
        # dashboard continuity; this series carries the per-class story.
        self.class_shed = Counter(
            "dyn_llm_class_requests_shed",
            "Requests shed by class-aware admission control",
            ["model", "priority", "reason"],
            registry=self.registry,
        )
        # per-model phase histograms as THIS FRONTEND observed them
        # (ttft / inter_token / e2e): feed the frontend's SLO engine and
        # the DYN_TRACE=auto retention decisions. NOTE these see one
        # process's requests only — fleet-true percentiles come from the
        # metrics component's merged per-worker histograms.
        self._phase_hist: dict[str, PhaseHistograms] = {}
        # the decision-provenance ledger is process-global: always attached
        self.attach_decisions()

    def phase_hist_for(self, model: str) -> PhaseHistograms:
        ph = self._phase_hist.get(model)
        if ph is None:
            ph = self._phase_hist[model] = PhaseHistograms()
        return ph

    def render(self) -> bytes:
        return generate_latest(self.registry)

    def attach_spec_stats(self, stats_src) -> None:
        """Surface a colocated engine's speculative-decoding counters on
        this registry (in=http out=torch runs frontend and engine in one
        process, so there is no fabric scrape between them). `stats_src`
        is the engine's stats object or a zero-arg callable returning it;
        values are read lazily at scrape time via gauge callbacks."""

        def read(attr, denom_attr=None):
            def _read() -> float:
                s = stats_src() if callable(stats_src) else stats_src
                d = s if isinstance(s, dict) else getattr(s, "__dict__", {})
                v = float(d.get(attr, 0) or 0)
                if denom_attr is not None:
                    v /= max(1.0, float(d.get(denom_attr, 0) or 0))
                return v

            return _read

        for attr, name, doc in (
            ("num_drafts", "spec_decode_drafts",
             "Lane-dispatches carrying draft tokens"),
            ("num_draft_tokens", "spec_decode_draft_tokens",
             "Draft tokens proposed"),
            ("num_accepted_tokens", "spec_decode_accepted_tokens",
             "Draft tokens accepted"),
        ):
            g = Gauge(f"{PREFIX}_{name}", doc, registry=self.registry)
            g.set_function(read(attr))
        rate = Gauge(
            f"{PREFIX}_spec_decode_acceptance_rate",
            "Accepted / proposed draft tokens",
            registry=self.registry,
        )
        rate.set_function(read("num_accepted_tokens", "num_draft_tokens"))

    def attach_kv_transfer_stats(self, stats_src) -> None:
        """Surface a colocated engine's KV data-plane counters (streaming
        disagg): wire bytes shipped/landed, frames in flight, and
        the fraction of transfer hidden behind remote prefill compute.
        Same lazy-gauge contract as attach_spec_stats."""

        def read(attr, denom_attr=None):
            def _read() -> float:
                s = stats_src() if callable(stats_src) else stats_src
                d = s if isinstance(s, dict) else getattr(s, "__dict__", {})
                v = float(d.get(attr, 0) or 0)
                if denom_attr is not None:
                    v /= max(1.0, float(d.get(denom_attr, 0) or 0))
                return v

            return _read

        for attr, name, doc in (
            ("kv_wire_bytes_tx", "kv_wire_tx_bytes",
             "KV wire bytes shipped (prefill role)"),
            ("kv_wire_bytes_rx", "kv_wire_rx_bytes",
             "KV wire bytes landed (decode role)"),
            ("kv_frames_tx", "kv_frames_tx", "KV stream frames shipped"),
            ("kv_frames_rx", "kv_frames_rx", "KV stream frames landed"),
            ("kv_frames_inflight", "kv_frames_inflight",
             "KV frames extracted but not yet on the wire"),
            ("prefill_dropped_expired", "prefill_dropped_expired",
             "Remote prefills dropped past their deadline"),
        ):
            g = Gauge(f"{PREFIX}_{name}", doc, registry=self.registry)
            g.set_function(read(attr))
        overlap = Gauge(
            f"{PREFIX}_kv_stream_overlap",
            "Fraction of received KV bytes landed before the final frame",
            registry=self.registry,
        )
        overlap.set_function(
            read("kv_bytes_overlapped", "kv_wire_bytes_rx")
        )

    def attach_engine_qos(self, stats_src) -> None:
        """Surface a colocated engine's QoS counters on this registry:
        per-class preemptions (class-aware preemption lands on bulk
        first), storm-guard kills, and engine-side brownout sheds. Same
        lazy scrape-time contract as the other attach_* hooks; the metrics
        COMPONENT exports the same families for a fabric-scraped fleet."""
        if getattr(self, "_engine_qos_attached", False):
            return
        self._engine_qos_attached = True

        def read() -> dict:
            s = stats_src() if callable(stats_src) else stats_src
            return s if isinstance(s, dict) else getattr(s, "__dict__", {})

        class _QosCollector:
            def describe(self):
                return []

            def collect(self):
                d = read()
                fam = CounterMetricFamily(
                    "dyn_llm_preemptions",
                    "KV-preserving preemptions by victim priority class",
                    labels=["priority"],
                )
                for cls, v in sorted(
                    (d.get("preemptions_by_class") or {}).items()
                ):
                    fam.add_metric([str(cls)], float(v))
                yield fam
                yield CounterMetricFamily(
                    "dyn_llm_preempted_too_often",
                    "Sequences failed by the preemption-storm guard",
                    value=float(d.get("preempted_too_often", 0) or 0),
                )
                yield CounterMetricFamily(
                    "dyn_llm_brownout_sheds",
                    "Requests shed at engine admission by the brownout "
                    "ladder",
                    value=float(d.get("shed_brownout", 0) or 0),
                )

        self.registry.register(_QosCollector())

    def attach_integrity(self, counters_src) -> None:
        """Surface the process-wide integrity/fence counters
        (dynamo_tpu_torch.integrity.COUNTERS) on this registry: KV payloads that
        failed their content checksum per data-plane path, poison blocks
        quarantined, and epoch-fencing stamp rejects per plane (for a
        frontend that's chiefly the `dispatch` plane — a zombie worker's
        frames refused mid-stream). Scrape-time counter families; same
        names the metrics component exports for the fabric-scraped fleet."""
        if getattr(self, "_integrity_attached", False):
            return
        self._integrity_attached = True

        def read() -> dict:
            c = counters_src() if callable(counters_src) else counters_src
            if hasattr(c, "snapshot"):
                return c.snapshot()
            return c if isinstance(c, dict) else {}

        class _IntegrityCollector:
            def describe(self):
                return []

            def collect(self):
                d = read()
                fam = CounterMetricFamily(
                    "dyn_llm_kv_integrity_failures",
                    "KV payloads that failed their content checksum, by "
                    "data-plane path",
                    labels=["path"],
                )
                for path, v in sorted(
                    (d.get("integrity_failures_by_path") or {}).items()
                ):
                    fam.add_metric([str(path)], float(v))
                yield fam
                yield CounterMetricFamily(
                    "dyn_llm_blocks_quarantined",
                    "KV blocks quarantined after repeated integrity "
                    "failures (never re-offered for prefix reuse)",
                    value=float(d.get("blocks_quarantined", 0) or 0),
                )
                fam = CounterMetricFamily(
                    "dyn_llm_fenced_rejects",
                    "Frames/adverts/publishes rejected because their "
                    "epoch-fencing stamp names a dead worker incarnation, "
                    "by plane",
                    labels=["plane"],
                )
                for plane, v in sorted(
                    (d.get("fenced_rejects_by_plane") or {}).items()
                ):
                    fam.add_metric([str(plane)], float(v))
                yield fam

        self.registry.register(_IntegrityCollector())

    def attach_control_plane(self, status_src) -> None:
        """Surface this process's fabric-client health (control-plane
        blackout tolerance): connected flag, degraded-mode flag, time
        spent degraded, and the buffered-publish flow through a blackout.
        `status_src` is FabricClient.status (or a zero-arg callable
        returning its dict); values read lazily at scrape time."""
        if getattr(self, "_control_plane_attached", False):
            return
        self._control_plane_attached = True

        def read(key):
            def _read() -> float:
                d = status_src() if callable(status_src) else status_src
                return float((d or {}).get(key, 0) or 0)

            return _read

        g = Gauge(
            "dyn_fabric_connected",
            "Is the fabric (control plane) reachable from this process "
            "(1 connected, 0 unreachable)",
            registry=self.registry,
        )
        g.set_function(read("connected"))
        g = Gauge(
            "dyn_llm_degraded_mode",
            "Serving in degraded mode: control plane unreachable, routing "
            "from last-known tables, publishes buffered (1 yes, 0 no)",
            registry=self.registry,
        )
        g.set_function(read("degraded"))
        CallbackCounter(
            self.registry,
            "dyn_llm_degraded_seconds_total",
            "Cumulative seconds this process has served without a "
            "reachable control plane",
            read("degraded_seconds_total"),
        )
        CallbackCounter(
            self.registry,
            "dyn_fabric_blackouts_total",
            "Times the control plane became unreachable",
            read("blackouts_total"),
        )
        CallbackCounter(
            self.registry,
            "dyn_llm_degraded_publishes_buffered_total",
            "Event-plane publishes buffered while the control plane was "
            "unreachable",
            read("buffered_publishes"),
        )
        CallbackCounter(
            self.registry,
            "dyn_llm_degraded_publishes_flushed_total",
            "Buffered publishes flushed to the healed control plane",
            read("flushed_publishes"),
        )

    def attach_health(self, scorer, hedger=None) -> None:
        """Surface the tail-tolerance plane on this frontend's
        /metrics: per-worker health scores (slowness ratio vs the fleet
        median), the live ejected-worker count, ejection causes, and —
        when a HedgeController is wired — hedge outcomes and the tokens
        the cancelled losers wasted. Scrape-time families; attach-once
        guarded (first discovered endpoint wins, like attach_kv_hit_stats);
        the metrics component and the standalone router export the same
        score/ejection families from their own scorers."""
        if getattr(self, "_health_attached", False):
            return
        self._health_attached = True

        class _HealthCollector:
            def describe(self):
                return []

            def collect(self):
                score = GaugeMetricFamily(
                    "dyn_llm_worker_health_score",
                    "Worker slowness ratio vs the fleet median "
                    "(1.0 typical; >= DYN_EJECT_RATIO is an outlier)",
                    labels=["instance"],
                )
                for wid, s in sorted(scorer.scores().items()):
                    score.add_metric([f"{wid:x}"], float(s))
                yield score
                yield GaugeMetricFamily(
                    "dyn_llm_workers_ejected",
                    "Workers currently ejected from routing as latency "
                    "outliers (probation trickle still flows)",
                    value=float(len(scorer.ejected())),
                )
                ej = CounterMetricFamily(
                    "dyn_llm_ejections",
                    "Latency-outlier ejections by dominant slow signal",
                    labels=["cause"],
                )
                for cause, v in sorted(scorer.ejections_total.items()):
                    ej.add_metric([str(cause)], float(v))
                yield ej
                if hedger is None:
                    return
                hedges = CounterMetricFamily(
                    "dyn_llm_hedges",
                    "Hedged dispatches by outcome (won = hedge beat the "
                    "primary, lost = primary answered first, "
                    "budget_denied = DYN_HEDGE_BUDGET spent)",
                    labels=["outcome"],
                )
                for outcome, v in sorted(hedger.outcomes.items()):
                    hedges.add_metric([str(outcome)], float(v))
                yield hedges
                yield CounterMetricFamily(
                    "dyn_llm_hedge_wasted_tokens",
                    "Tokens emitted by cancelled hedge losers (the cost "
                    "side of the hedge budget)",
                    value=float(hedger.wasted_tokens),
                )

        self.registry.register(_HealthCollector())

    def attach_goodput(self, stats_src, hedger=None) -> None:
        """A colocated engine's goodput ledger on this frontend's /metrics
        (metrics.py:457-500): step-duration histograms by dispatch label,
        occupancy, bubbles, the token-waste taxonomy, recompile forensics,
        achieved MFU / HBM bytes per token. ``stats_src`` is the engine's
        stats (or a zero-argument callable returning them; a dict or an
        object whose ``goodput`` is the ledger). A wired ``HedgeController``'s
        wasted tokens overlay the ``hedge_loser`` cause: the engine sees a
        hedge loser only as a consumer gone away. The families are the
        metrics component's (``components/metrics.goodput_families``)."""
        if getattr(self, "_goodput_attached", False):
            return
        self._goodput_attached = True

        def read():
            s = stats_src() if callable(stats_src) else stats_src
            d = s if isinstance(s, dict) else getattr(s, "__dict__", {})
            return d.get("goodput")

        # the same source and overlay for GET /debug/goodput
        self._goodput_read = read
        self._goodput_hedger = hedger

        class _GoodputCollector:
            def describe(self):
                return []

            def collect(self):
                from dynamo_tpu_torch.components.metrics import goodput_families

                yield from goodput_families(
                    read(), hedge_loser_tokens=hedger.wasted_tokens if hedger is not None else 0.0)

        self.registry.register(_GoodputCollector())

    def attach_decisions(self) -> None:
        """This process's decision-provenance ledger on /metrics
        (metrics.py:520-541): ``dyn_llm_decisions{actor,kind}`` over the
        closed taxonomy (every pair seeded at 0) and the ring's evictions.
        Attached once, by the constructor: the ledger is process-global."""
        if getattr(self, "_decisions_attached", False):
            return
        self._decisions_attached = True

        class _DecisionCollector:
            def describe(self):
                return []

            def collect(self):
                from dynamo_tpu_torch.components.metrics import decision_families

                yield from decision_families()

        self.registry.register(_DecisionCollector())

    def attach_brownout(self, controller) -> None:
        """Surface the brownout ladder on /metrics: the live rung as a
        gauge (0 ok .. 4 shed_standard) and the transition count as a real
        counter. Lazy reads at scrape time; attach-once guarded so a
        service rebuild can't double-register."""
        if getattr(self, "_brownout_attached", False):
            return
        self._brownout_attached = True
        g = Gauge(
            "dyn_llm_brownout_level",
            "Brownout degradation ladder rung "
            "(0 ok, 1 shed_bulk, 2 spec_off, 3 chunk_cap, 4 shed_standard)",
            registry=self.registry,
        )
        g.set_function(lambda: controller.level)
        CallbackCounter(
            self.registry,
            "dyn_llm_brownout_transitions_total",
            "Brownout ladder transitions (steps up + steps down)",
            lambda: controller.transitions,
        )

    def attach_kv_hit_stats(self, scheduler, pull_outcomes_fn=None) -> None:
        """Surface an in-process KV router's per-decision hit accounting
        (KvScheduler.hit_stats) on this frontend's /metrics: the fraction
        of prefill blocks served from a routed worker's cache and the
        running matched-blocks total. Lazy gauges — read at scrape time.
        First router wins: one frontend registry can't carry the series
        twice (a second discovered endpoint keeps its own /metrics).

        `pull_outcomes_fn` optionally feeds realized peer-pull outcomes
        (a colocated engine's `pull_outcomes` dict); without it the
        outcome family stays as stable zero-valued series — realized
        outcomes are engine-side and ride the metrics component."""
        if getattr(self, "_kv_hit_attached", False):
            return
        self._kv_hit_attached = True
        g_rate = Gauge(
            "dyn_llm_kv_hit_rate",
            "Router KV hit rate: matched / required prefill blocks",
            registry=self.registry,
        )
        g_rate.set_function(lambda: scheduler.hit_rate)
        # monotonic series: a real counter family (scrape-time callback),
        # not a Gauge wearing a `_total` name
        CallbackCounter(
            self.registry,
            "dyn_llm_kv_matched_blocks_total",
            "Prefill blocks served from a routed worker's cache",
            lambda: scheduler.hit_stats["matched_blocks"],
        )
        # fleet prefix cache: the best match held ANYWHERE in
        # the fleet — the gap to dyn_llm_kv_hit_rate is the prefill
        # compute the peer-pull plane can still close
        g_fleet = Gauge(
            "dyn_llm_kv_fleet_hit_rate",
            "Fleet-best KV match rate: best matched / required prefill "
            "blocks held anywhere in the fleet",
            registry=self.registry,
        )
        g_fleet.set_function(lambda: scheduler.fleet_hit_rate)
        from dynamo_tpu_torch.kv_router.protocols import PULL_OUTCOMES

        outcomes_fn = pull_outcomes_fn or (lambda: {})

        class _PullCollector:
            def describe(self):
                return []  # dynamic family; registry probes collect()

            def collect(self):
                fam = CounterMetricFamily(
                    "dyn_llm_kv_pulled_blocks",
                    "Prefix blocks resolved by peer pull (or fallen back "
                    "to local compute), by outcome",
                    labels=["outcome"],
                )
                got = outcomes_fn() or {}
                # every outcome as a stable zero-valued series: dashboards
                # must not see label churn on the first fallback
                for key in PULL_OUTCOMES:
                    fam.add_metric([key], float(got.get(key, 0)))
                yield fam

        self.registry.register(_PullCollector())

    @contextmanager
    def track(self, model: str, endpoint: str):
        """Track one request: inflight gauge + duration + status count."""
        start = time.monotonic()
        self.inflight.labels(model, endpoint).inc()
        status = "success"
        try:
            yield
        except BaseException:
            status = "error"
            raise
        finally:
            elapsed = time.monotonic() - start
            self.inflight.labels(model, endpoint).dec()
            self.requests_total.labels(model, endpoint, status).inc()
            self.request_duration.labels(model, endpoint).observe(elapsed)
            self.phase_hist_for(model).observe("e2e", elapsed * 1e3)


class TokenTimer:
    """Per-request TTFT / inter-token latency observer. Also keeps the
    request's own ttft_ms / max_itl_ms so the DYN_TRACE=auto retention
    decision can compare this request against its SLO at completion."""

    def __init__(self, metrics: ServiceMetrics, model: str) -> None:
        self.metrics = metrics
        self.model = model
        self.start = time.monotonic()
        self.last: float | None = None
        self.ttft_ms: float | None = None
        self.max_itl_ms: float | None = None

    def on_token(self, count: int = 1) -> None:
        now = time.monotonic()
        phase_hist = self.metrics.phase_hist_for(self.model)
        if self.last is None:
            self.ttft_ms = (now - self.start) * 1e3
            self.metrics.time_to_first_token.labels(self.model).observe(
                now - self.start
            )
            phase_hist.observe("ttft", self.ttft_ms)
        else:
            gap_ms = (now - self.last) * 1e3
            if self.max_itl_ms is None or gap_ms > self.max_itl_ms:
                self.max_itl_ms = gap_ms
            self.metrics.inter_token_latency.labels(self.model).observe(
                now - self.last
            )
            phase_hist.observe("inter_token", gap_ms)
        self.last = now
        self.metrics.output_tokens.labels(self.model).inc(count)


class PhaseCollector:
    """One process's always-on phase histograms as the reference's metrics
    component renders the merged fleet's (components/metrics.py:256-287):
    ``dyn_llm_phase_duration_seconds{phase}`` and the p50 / p95 / p99
    gauges ``dyn_llm_phase_latency_seconds{phase,quantile}``. A worker's
    status server exports its engine's with it."""

    def __init__(self, source) -> None:
        self._source = source  # zero-arg fn -> PhaseHistograms

    def collect(self):
        hist = HistogramMetricFamily(
            "dyn_llm_phase_duration_seconds",
            "Merged fleet latency distribution per request phase "
            "(bucket-added per-worker fixed-log histograms)",
            labels=["phase"],
        )
        quant = GaugeMetricFamily(
            "dyn_llm_phase_latency_seconds",
            "Fleet phase latency percentiles from the merged histograms",
            labels=["phase", "quantile"],
        )
        ph = self._source()
        if ph is not None:
            for phase in sorted(ph.phases):
                h = ph.phases[phase]
                buckets, cum, lo = [], 0, 0
                for idx in _EXPORT_IDX:
                    cum += sum(h.counts[lo: idx + 1])
                    lo = idx + 1
                    buckets.append((f"{BOUNDS[idx] / 1e3:.9g}", float(cum)))
                buckets.append(("+Inf", float(h.count)))
                hist.add_metric([phase], buckets=buckets, sum_value=h.sum_ms / 1e3)
                for q in (50, 95, 99):
                    quant.add_metric([phase, f"p{q}"], h.percentile(q) / 1e3)
        yield hist
        yield quant
