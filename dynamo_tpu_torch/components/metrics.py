"""The standalone metrics component: the fleet's merged view.

The port's own copy of dynamo_tpu/components/metrics.py, built on the
port's stdlib registry (``runtime/prom.py``), status server
(``runtime/http_server.py``) and codec (``fabric/mpack.py``): the card's
machine has no ``aiohttp``, ``prometheus_client`` or ``msgpack``. Every
family keeps the reference's name, type, labels and help.

Every ``--poll-interval`` it collects the ``ForwardPassMetrics`` of every
worker of the target endpoint (their ``stats/...`` keys on the fabric),
aggregates them (``kv_router.publisher.KvMetricsAggregator``) and exports:

  * the fleet's load gauges, the decode-bandwidth gauges
    (``dyn_llm_decode_hbm_bytes_per_token``, ``dyn_llm_mfu_decode_est``,
    ``dyn_llm_tp_collective_bytes_per_step``: fleet means) and the
    spec-decode and KV data-plane counters;
  * the fleet-true latency distributions: per-worker ``PhaseHistograms``
    merged by bucket addition, exported as
    ``dyn_llm_phase_duration_seconds{phase=...}`` with p50 / p95 / p99
    gauges;
  * monotonic worker counters with counter semantics (deadline expiries,
    watchdog trips, storm-guard kills, brownout sheds, preemptions by
    class, peer-pull outcomes, integrity failures, fence rejects);
  * the merged goodput ledger (``goodput_families``: step histograms by
    dispatch label, occupancy, bubbles, the waste taxonomy, recompiles,
    compile seconds, achieved MFU / HBM bytes per token), with the fleet
    and per-worker views at ``GET /debug/goodput``;
  * the health scorer over the workers' self-reported histograms, the SLO
    engine over the merged ones (``GET /debug/slo``; transitions published
    as ``slo-status`` events), this process's decision-provenance counts,
    and the ``kv-hit-rate`` events of the KV routers;
  * the planner's and the rolling upgrade's status from their fabric keys
    (``PLANNER_STATUS_KEY`` / ``UPGRADE_STATUS_KEY``), empty families when
    the keys are absent. The key names and ``PHASES`` are this module's
    constants until the planner and the upgrade coordinator are ported
    (ROADMAP A12.3 / A12.4), each the reference's.

``MockWorkerMetrics`` publishes synthetic stats (the reference's mock
worker, bin/mock_worker.rs) so the plane runs with no engine at all.

Run: python -m dynamo_tpu_torch.components.metrics --namespace NS \
         --component C --endpoint E --port 9091 [--mock-worker]
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import math
from typing import Optional

from dynamo_tpu_torch.fabric import mpack
from dynamo_tpu_torch.kv_router import KV_HIT_RATE_SUBJECT
from dynamo_tpu_torch.kv_router.protocols import (
    PULL_OUTCOMES,
    ForwardPassMetrics,
    KvStats,
    KvTransferStats,
    SpecDecodeStats,
    WorkerStats,
)
from dynamo_tpu_torch.kv_router.publisher import KvMetricsAggregator, WorkerMetricsPublisher
from dynamo_tpu_torch.runtime.component import Component, Endpoint
from dynamo_tpu_torch.runtime.http_server import SystemStatusServer
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.prom import (
    CallbackCounter,
    CollectorRegistry,
    Counter,
    CounterMetricFamily,
    Gauge,
    GaugeMetricFamily,
    HistogramMetricFamily,
)
from dynamo_tpu_torch.runtime.protocols import EndpointId
from dynamo_tpu_torch.telemetry import provenance as dprov
from dynamo_tpu_torch.telemetry import slo as dslo
from dynamo_tpu_torch.telemetry.goodput import (
    WASTE_CAUSES,
    GoodputLedger,
    GoodputStats,
)
from dynamo_tpu_torch.telemetry.health import HealthScorer
from dynamo_tpu_torch.telemetry.histogram import BOUNDS, NUM_BUCKETS, PhaseHistograms

logger = get_logger("dynamo_tpu_torch.components.metrics")

# the planner's status key (dynamo_tpu/planner/planner_core.py:70)
PLANNER_STATUS_KEY = "planner/status"
# the upgrade coordinator's status key and its phases, the wire contract of
# dyn_fleet_upgrade_phase (dynamo_tpu/fleet/upgrade.py:42-57)
UPGRADE_STATUS_KEY = "fleet/upgrade-status"
PHASES = (
    "idle",
    "surging",
    "probation",
    "handoff",
    "draining",
    "retiring",
    "rolling_back",
    "halted",
    "done",
)


def _json(body: dict) -> tuple[int, bytes, str]:
    return 200, json.dumps(body).encode(), "application/json"


PREFIX = "dyn_llm"

# Downsampled export grid for the Prometheus histogram: every 4th internal
# bound (GROWTH^4 = 2, so exported `le` bounds double), 28 buckets + +Inf
# spanning ~0.08 ms to ~3 h. Cumulative counts at these bounds are exact
# sums of the internal buckets, so no precision is invented — only
# resolution traded for a sane exposition size.
_EXPORT_IDX = tuple(range(3, NUM_BUCKETS, 4))

_SLO_STATE_VALUE = {"ok": 0.0, "burning": 1.0, "breached": 2.0}


class _FleetCollector:
    """Scrape-time families derived from the latest aggregate: counter
    semantics for the fleet-summed monotonic series, the merged phase
    histogram, derived percentile gauges, and the SLO plane."""

    _COUNTERS = (
        # (family base name — exposition appends `_total`, doc, reader)
        ("deadline_exceeded",
         "Requests cancelled on deadline/TTFT expiry (fleet sum)",
         lambda agg: agg.worker_stats.num_deadline_exceeded),
        ("watchdog_trips",
         "Stuck-horizon watchdog trips (fleet sum)",
         lambda agg: agg.worker_stats.num_watchdog_trips),
        ("preempted_too_often",
         "Sequences failed by the preemption-storm guard (fleet sum)",
         lambda agg: agg.worker_stats.num_preempted_too_often),
        ("brownout_sheds",
         "Requests shed at engine admission by the brownout ladder "
         "(fleet sum)",
         lambda agg: agg.worker_stats.num_shed_brownout),
    )
    _XFER_COUNTERS = (
        ("kv_wire_tx_bytes", "KV wire bytes shipped (fleet sum)",
         lambda x: x.kv_wire_bytes_tx),
        ("kv_wire_rx_bytes", "KV wire bytes landed (fleet sum)",
         lambda x: x.kv_wire_bytes_rx),
        ("kv_frames_tx", "KV stream frames shipped (fleet sum)",
         lambda x: x.kv_frames_tx),
        ("kv_frames_rx", "KV stream frames landed (fleet sum)",
         lambda x: x.kv_frames_rx),
        ("prefill_dropped_expired",
         "Remote prefills dropped past their deadline (fleet sum)",
         lambda x: x.prefill_dropped_expired),
    )

    def __init__(self, component: "MetricsComponent") -> None:
        self.component = component

    def describe(self):
        return []  # dynamic families; registry probes collect() instead

    def collect(self):
        agg = self.component.last
        for name, doc, read in self._COUNTERS:
            value = float(read(agg)) if agg is not None else 0.0
            yield CounterMetricFamily(f"{PREFIX}_{name}", doc, value=value)
        xfer = agg.kv_transfer_stats if agg is not None else None
        for name, doc, read in self._XFER_COUNTERS:
            value = float(read(xfer)) if xfer is not None else 0.0
            yield CounterMetricFamily(f"{PREFIX}_{name}", doc, value=value)
        # class-aware preemption counts (the QoS acceptance signal: under
        # overload every preemption should land on bulk first)
        preempt = CounterMetricFamily(
            f"{PREFIX}_preemptions",
            "KV-preserving preemptions by victim priority class "
            "(fleet sum)",
            labels=["priority"],
        )
        by_class = (
            agg.worker_stats.preemptions_by_class if agg is not None else None
        ) or {}
        for cls, v in sorted(by_class.items()):
            preempt.add_metric([str(cls)], float(v))
        yield preempt
        # fleet prefix cache: engine-side truth for the
        # router's pull plans — blocks resolved by peer pull vs the
        # fallback-to-local-compute reasons
        pulled = CounterMetricFamily(
            f"{PREFIX}_kv_pulled_blocks",
            "Prefix blocks the engines pulled from peers (or fell back "
            "to recomputing locally), by outcome (fleet sum)",
            labels=["outcome"],
        )
        by_outcome = dict.fromkeys(PULL_OUTCOMES, 0)
        by_outcome.update(
            (
                agg.worker_stats.kv_pulled_blocks_by_outcome
                if agg is not None else None
            ) or {}
        )
        for outcome, v in sorted(by_outcome.items()):
            pulled.add_metric([str(outcome)], float(v))
        yield pulled
        # integrity plane: checksum failures by data-plane path,
        # quarantined poison blocks, epoch-fencing rejects by plane
        integ = CounterMetricFamily(
            f"{PREFIX}_kv_integrity_failures",
            "KV payloads that failed their content checksum, by "
            "data-plane path (fleet sum)",
            labels=["path"],
        )
        by_path = (
            agg.worker_stats.integrity_failures_by_path
            if agg is not None else None
        ) or {}
        for path, v in sorted(by_path.items()):
            integ.add_metric([str(path)], float(v))
        yield integ
        yield CounterMetricFamily(
            f"{PREFIX}_blocks_quarantined",
            "KV blocks quarantined after repeated integrity failures "
            "(fleet sum; never re-offered for prefix reuse)",
            value=float(
                agg.worker_stats.num_blocks_quarantined
                if agg is not None else 0
            ),
        )
        fenced = CounterMetricFamily(
            f"{PREFIX}_fenced_rejects",
            "Frames/adverts/publishes rejected because their epoch-fencing "
            "stamp names a dead worker incarnation, by plane (fleet sum)",
            labels=["plane"],
        )
        by_plane = (
            agg.worker_stats.fenced_rejects_by_plane
            if agg is not None else None
        ) or {}
        for plane, v in sorted(by_plane.items()):
            fenced.add_metric([str(plane)], float(v))
        yield fenced
        yield GaugeMetricFamily(
            f"{PREFIX}_brownout_level",
            "Worst worker brownout rung in the fleet "
            "(0 ok, 1 shed_bulk, 2 spec_off, 3 chunk_cap, 4 shed_standard)",
            value=float(
                agg.worker_stats.brownout_level if agg is not None else 0
            ),
        )
        ph = agg.phase_histograms if agg is not None else None
        yield from self._phase_families(ph)
        yield from goodput_families(
            agg.goodput if agg is not None else None
        )
        yield from self._health_families()
        yield from self._slo_families()
        yield from planner_families(self.component.planner_status)
        yield from fleet_upgrade_families(self.component.upgrade_status)
        yield from decision_families()

    def _health_families(self):
        """Tail-tolerance plane from the component's own scorer (fed by
        the poll loop with each worker's self-reported phase-histogram
        deltas — the fleet-wide view of gray workers, observable with no
        frontend at all)."""
        health = self.component.health
        score = GaugeMetricFamily(
            f"{PREFIX}_worker_health_score",
            "Worker slowness ratio vs the fleet median "
            "(1.0 typical; >= DYN_EJECT_RATIO is an outlier)",
            labels=["instance"],
        )
        for wid, s in sorted(health.scores().items()):
            score.add_metric([f"{wid:x}"], float(s))
        yield score
        yield GaugeMetricFamily(
            f"{PREFIX}_workers_ejected",
            "Workers currently ejected from routing as latency outliers "
            "(probation trickle still flows)",
            value=float(len(health.ejected())),
        )
        ej = CounterMetricFamily(
            f"{PREFIX}_ejections",
            "Latency-outlier ejections by dominant slow signal",
            labels=["cause"],
        )
        for cause, v in sorted(health.ejections_total.items()):
            ej.add_metric([str(cause)], float(v))
        yield ej

    def _phase_families(self, ph: Optional[PhaseHistograms]):
        hist = HistogramMetricFamily(
            f"{PREFIX}_phase_duration_seconds",
            "Merged fleet latency distribution per request phase "
            "(bucket-added per-worker fixed-log histograms)",
            labels=["phase"],
        )
        quant = GaugeMetricFamily(
            f"{PREFIX}_phase_latency_seconds",
            "Fleet phase latency percentiles from the merged histograms",
            labels=["phase", "quantile"],
        )
        if ph is not None:
            for phase in sorted(ph.phases):
                h = ph.phases[phase]
                buckets = []
                cum = 0
                lo = 0
                for idx in _EXPORT_IDX:
                    cum += sum(h.counts[lo : idx + 1])
                    lo = idx + 1
                    buckets.append((f"{BOUNDS[idx] / 1e3:.9g}", float(cum)))
                buckets.append(("+Inf", float(h.count)))
                hist.add_metric(
                    [phase], buckets=buckets, sum_value=h.sum_ms / 1e3
                )
                for q in (50, 95, 99):
                    quant.add_metric(
                        [phase, f"p{q}"], h.percentile(q) / 1e3
                    )
        yield hist
        yield quant

    def _slo_families(self):
        slo = self.component.slo
        status = slo.last_status
        state = GaugeMetricFamily(
            f"{PREFIX}_slo_state",
            "SLO state machine: 0 ok, 1 burning, 2 breached",
            value=_SLO_STATE_VALUE.get(status.get("state"), 0.0),
        )
        yield state
        burn = GaugeMetricFamily(
            f"{PREFIX}_slo_burn_rate",
            "Error-budget burn rate (1.0 = budget consumed exactly as it "
            "accrues) per signal and window",
            labels=["signal", "window"],
        )
        target = GaugeMetricFamily(
            f"{PREFIX}_slo_target_seconds",
            "Configured SLO latency threshold per signal",
            labels=["signal"],
        )
        for name, sig in (status.get("signals") or {}).items():
            burn.add_metric([name, "fast"], sig.get("burn_fast", 0.0))
            burn.add_metric([name, "slow"], sig.get("burn_slow", 0.0))
            target.add_metric([name], (sig.get("target_ms") or 0.0) / 1e3)
        yield burn
        yield target
        yield CounterMetricFamily(
            f"{PREFIX}_slo_breaches",
            "Transitions into the breached SLO state",
            value=float(slo.breaches_total),
        )


def goodput_families(
    gp: Optional[GoodputStats], hedge_loser_tokens: float = 0.0
):
    """Scrape-time `dyn_llm_step_*` / waste / recompile families from a
    merged GoodputStats (telemetry/goodput.py). Shared between
    the metrics component (fleet-merged) and a frontend's attach_goodput
    (colocated engine) — same names, same types, merged views add.
    `hedge_loser_tokens` overlays the frontend HedgeController's waste on
    the taxonomy: hedge losers are attributed where hedging happens (the
    engine only sees a consumer disconnect, i.e. cancelled_partial)."""
    hist = HistogramMetricFamily(
        f"{PREFIX}_step_duration_seconds",
        "Device-step duration per dispatch label (merged fixed-log "
        "bucket histograms; one observation per engine dispatch)",
        labels=["label"],
    )
    if gp is not None:
        for label in sorted(gp.step_hists.phases):
            h = gp.step_hists.phases[label]
            buckets = []
            cum = 0
            lo = 0
            for idx in _EXPORT_IDX:
                cum += sum(h.counts[lo : idx + 1])
                lo = idx + 1
                buckets.append((f"{BOUNDS[idx] / 1e3:.9g}", float(cum)))
            buckets.append(("+Inf", float(h.count)))
            hist.add_metric([label], buckets=buckets, sum_value=h.sum_ms / 1e3)
    yield hist
    yield CounterMetricFamily(
        f"{PREFIX}_steps",
        "Engine device dispatches (fleet sum over all labels)",
        value=float(gp.steps_total if gp is not None else 0),
    )
    yield GaugeMetricFamily(
        f"{PREFIX}_step_occupancy",
        "Decode-family lane occupancy: lanes occupied / lane capacity, "
        "summed over steps (1.0 = every dispatched step ran full)",
        value=float(gp.occupancy if gp is not None else 0.0),
    )
    yield CounterMetricFamily(
        f"{PREFIX}_phase_bubble_seconds",
        "Device idle time between consecutive dispatches while work was "
        "in flight (the phase-transition bubble; fleet sum)",
        value=float(gp.bubble_s_total if gp is not None else 0.0),
    )
    tokens = CounterMetricFamily(
        f"{PREFIX}_device_tokens",
        "Tokens through the device by phase: prefill tokens consumed and "
        "decode tokens emitted (fleet sum)",
        labels=["phase"],
    )
    tokens.add_metric(
        ["prefill"], float(gp.prefill_tokens if gp is not None else 0)
    )
    tokens.add_metric(
        ["decode"], float(gp.decode_tokens if gp is not None else 0)
    )
    yield tokens
    yield CounterMetricFamily(
        f"{PREFIX}_mixed_steps",
        "Unified mixed prefill+decode dispatches — prefill chunks packed "
        "into the decode step instead of alternating with it (fleet sum)",
        value=float(gp.mixed_steps if gp is not None else 0),
    )
    mixed_tokens = CounterMetricFamily(
        f"{PREFIX}_mixed_step_tokens",
        "Tokens through unified mixed steps by half: prefill chunk "
        "tokens packed alongside decode-lane emissions (fleet sum)",
        labels=["half"],
    )
    mixed_tokens.add_metric(
        ["prefill"],
        float(gp.mixed_prefill_tokens if gp is not None else 0),
    )
    mixed_tokens.add_metric(
        ["decode"],
        float(gp.mixed_decode_tokens if gp is not None else 0),
    )
    yield mixed_tokens
    waste = CounterMetricFamily(
        f"{PREFIX}_tokens_wasted",
        "Scheduled-then-discarded tokens by cause (spec_rejected / "
        "preempt_replay / migration_replay / deadline_partial / "
        "cancelled_partial / hedge_loser; fleet sum)",
        labels=["cause"],
    )
    by_cause = dict(gp.waste_by_cause) if gp is not None else {}
    if hedge_loser_tokens:
        by_cause["hedge_loser"] = by_cause.get("hedge_loser", 0) + int(
            hedge_loser_tokens
        )
    for cause in WASTE_CAUSES:
        waste.add_metric([cause], float(by_cause.get(cause, 0)))
    yield waste
    rec = CounterMetricFamily(
        f"{PREFIX}_recompiles",
        "Unexpected post-warmup XLA recompiles by dispatch label and "
        "cause (shape_miss = unbucketed shape; prebake_miss = drifted "
        "prebaked cache)",
        labels=["label", "cause"],
    )
    for key, v in sorted((gp.recompiles if gp is not None else {}).items()):
        label, _, cause = str(key).partition("|")
        rec.add_metric([label, cause or "shape_miss"], float(v))
    yield rec
    comp = GaugeMetricFamily(
        f"{PREFIX}_compile_seconds",
        "First-dispatch (compile-inclusive) wall time per dispatch label "
        "(fleet max — the worst cold-start cost)",
        labels=["label"],
    )
    for label, v in sorted(
        (gp.compile_s_by_label if gp is not None else {}).items()
    ):
        comp.add_metric([label], float(v))
    yield comp
    yield GaugeMetricFamily(
        f"{PREFIX}_mfu_achieved",
        "Achieved decode MFU from real dispatch shapes through the "
        "roofline model (fleet mean)",
        value=float(gp.mfu_achieved if gp is not None else 0.0),
    )
    yield GaugeMetricFamily(
        f"{PREFIX}_hbm_bytes_per_token_achieved",
        "Achieved HBM bytes per emitted token from real dispatch shapes "
        "(fleet mean)",
        value=float(gp.hbm_bytes_per_token if gp is not None else 0.0),
    )


def fleet_upgrade_families(status: Optional[dict]):
    """Scrape-time `dyn_fleet_upgrade_*` families from the rollout
    status snapshot the UpgradeCoordinator publishes under
    UPGRADE_STATUS_KEY (UpgradeStatus.to_wire() form) — the dashboard's
    view of a zero-downtime rolling upgrade in flight."""
    status = status or {}
    phase = GaugeMetricFamily(
        "dyn_fleet_upgrade_phase",
        "Rolling-upgrade state machine position, one-hot by phase "
        "(surging/probation/handoff/draining/retiring/rolling_back/"
        "halted/done; idle when no rollout is active)",
        labels=["phase"],
    )
    current = str(status.get("phase", "idle") or "idle")
    for p in PHASES:
        phase.add_metric([p], 1.0 if p == current else 0.0)
    yield phase
    handoff = CounterMetricFamily(
        "dyn_fleet_upgrade_handoff_blocks_total",
        "KV blocks moved by the live handoff during rollouts, by "
        "peer-pull outcome (pulled = actually transplanted; fallback_* "
        "= successor will re-warm from tokens)",
        labels=["outcome"],
    )
    for outcome, v in sorted((status.get("handoff_blocks") or {}).items()):
        handoff.add_metric([str(outcome)], float(v))
    yield handoff
    yield CounterMetricFamily(
        "dyn_fleet_upgrade_rollbacks_total",
        "Rollouts automatically halted and rolled back (successor "
        "crash-loop, failed probation, or SLO burn)",
        value=float(status.get("rollbacks_total", 0) or 0),
    )
    yield GaugeMetricFamily(
        "dyn_fleet_upgrade_replaced",
        "Workers replaced so far in the current rollout (resets with "
        "each new upgrade intent)",
        value=float(status.get("replaced", 0) or 0),
    )


def planner_families(status: Optional[dict]):
    """Scrape-time `dyn_planner_*` / `dyn_supervisor_*` families from a
    planner-published status dict (Planner.status() wire form under
    PLANNER_STATUS_KEY). Shared between the metrics component (fabric
    scrape) and a frontend's attach_planner — same names, same types."""
    status = status or {}
    dec = CounterMetricFamily(
        "dyn_planner_decisions",
        "Planner decisions by actuation direction (up/down/hold/frozen/"
        "heal) and reason slug",
        labels=["direction", "reason"],
    )
    for key, v in sorted((status.get("decisions_total") or {}).items()):
        direction, _, reason = str(key).partition("|")
        dec.add_metric([direction, reason or "unknown"], float(v))
    yield dec
    yield GaugeMetricFamily(
        "dyn_planner_frozen",
        "Planner fail-static state: 1 when scaling is frozen (stale "
        "signals, degraded control plane, or intent mismatch), else 0",
        value=float(status.get("frozen", 0) or 0),
    )
    target = GaugeMetricFamily(
        "dyn_planner_replicas_target",
        "Planner replica intent per fleet role",
        labels=["role"],
    )
    for role, v in sorted((status.get("replicas_target") or {}).items()):
        target.add_metric([str(role)], float(v))
    yield target
    actual = GaugeMetricFamily(
        "dyn_planner_replicas_actual",
        "Observed replicas per fleet role (workers whose stats answered)",
        labels=["role"],
    )
    for role, v in sorted((status.get("replicas_actual") or {}).items()):
        actual.add_metric([str(role)], float(v))
    yield actual
    sup = status.get("supervisor") or {}
    yield CounterMetricFamily(
        "dyn_supervisor_restarts",
        "Child processes restarted by the supervisor (crashes, health-"
        "probe kills, injected kills)",
        value=float(sup.get("restarts_total", 0) or 0),
    )
    yield GaugeMetricFamily(
        "dyn_supervisor_quarantined",
        "Children currently in crash-loop quarantine (slow-cadence "
        "retries; excluded from the healthy replica count)",
        value=float(sup.get("quarantined", 0) or 0),
    )


def decision_families():
    """Scrape-time `dyn_llm_decisions` / ring-dropped families from this
    process's provenance ledger (telemetry/provenance.py).
    Shared between the metrics component, a frontend's attach_decisions,
    and the standalone router registry — same names, same types; each
    process exports its OWN ledger's counts (decisions are made where
    they are recorded, so fleet totals come from summing scrapes, not
    from merging rings). Every taxonomy (actor, kind) pair is pre-seeded
    at 0 so rate() windows and absent-series alerts behave."""
    dec = CounterMetricFamily(
        f"{PREFIX}_decisions",
        "Control-plane decisions recorded in the provenance ledger, by "
        "deciding actor and decision kind (closed taxonomy)",
        labels=["actor", "kind"],
    )
    counts = dprov.counts() if dprov.enabled() else {}
    for actor, kinds in sorted(dprov.TAXONOMY.items()):
        for kind in kinds:
            dec.add_metric(
                [actor, kind], float(counts.get((actor, kind), 0))
            )
    yield dec
    yield CounterMetricFamily(
        f"{PREFIX}_decision_ring_dropped",
        "Decision records evicted from the bounded provenance ring "
        "before any reader saw them (raise DYN_DECISIONS_RING if >0 "
        "while debugging)",
        value=float(dprov.dropped_total()),
    )


class MetricsComponent:
    """Scrape -> aggregate -> Prometheus, plus kv-hit-rate accounting and
    the fleet SLO engine."""

    def __init__(
        self,
        component: Component,
        endpoint: EndpointId,
        poll_interval: float = 1.0,
        port: int = 0,
    ) -> None:
        self.component = component
        self.endpoint = endpoint
        self.poll_interval = poll_interval
        self.aggregator = KvMetricsAggregator(component, endpoint)
        self.registry = CollectorRegistry()
        self.server = SystemStatusServer(port=port, registry=self.registry)
        self.server.add_route("/debug/slo", self._debug_slo)
        self.server.add_route("/debug/goodput", self._debug_goodput)
        # fleet SLO engine over the merged phase histograms; transitions
        # publish `slo-status` on the namespace (the planner's SLA hook)
        self.slo = dslo.SloEngine(
            dslo.SloConfig.from_env(), on_transition=self._on_slo_transition
        )
        # tail-tolerance plane: scored from the scraped self-reported
        # histograms each poll (no consumer-side signal in this process)
        self.health = HealthScorer()

        def g(name: str, doc: str) -> Gauge:
            return Gauge(f"{PREFIX}_{name}", doc, registry=self.registry)

        self.g_active_slots = g("requests_active_slots", "Busy request slots")
        self.g_total_slots = g("requests_total_slots", "Total request slots")
        self.g_waiting = g("requests_waiting", "Queued requests")
        self.g_kv_active = g("kv_blocks_active", "Active KV blocks")
        self.g_kv_total = g("kv_blocks_capacity", "Total KV blocks")
        self.g_cache_usage = g("kv_cache_usage_percent", "Mean cache usage")
        self.g_hit_rate = g(
            "kv_prefix_cache_hit_rate", "Mean engine prefix hit rate"
        )
        self.g_workers = g("worker_count", "Workers reporting stats")
        # speculative decoding (SpecDecodeStats): absent until a worker
        # reports spec counters, then summed across the fleet
        self.g_spec_drafts = g(
            "spec_decode_drafts", "Lane-dispatches carrying draft tokens"
        )
        self.g_spec_draft_tokens = g(
            "spec_decode_draft_tokens", "Draft tokens proposed"
        )
        self.g_spec_accepted = g(
            "spec_decode_accepted_tokens", "Draft tokens accepted"
        )
        self.g_spec_accept_rate = g(
            "spec_decode_acceptance_rate",
            "Accepted / proposed draft tokens",
        )
        # KV data plane gauges (the true gauges of the transfer plane;
        # the monotonic byte/frame counters live in _FleetCollector)
        self.g_kv_frames_inflight = g(
            "kv_frames_inflight",
            "KV frames extracted but not yet on the wire (fleet sum)",
        )
        self.g_kv_overlap = g(
            "kv_stream_overlap",
            "Fraction of received KV bytes landed before the final frame",
        )
        # decode-bandwidth plane: fleet-mean modeled HBM bytes
        # per emitted decode token and the decode-MFU estimate
        self.g_decode_hbm_bytes = g(
            "decode_hbm_bytes_per_token",
            "Modeled HBM bytes read per decode token (fleet mean)",
        )
        self.g_mfu_decode = g(
            "mfu_decode_est",
            "Estimated decode MFU from windowed token rate (fleet mean)",
        )
        # meshed decode: modeled tp-axis collective bytes per
        # decode step (perf_model.tp_collective_bytes_per_step; 0 when
        # unmeshed/tp=1)
        self.g_tp_collective_bytes = g(
            "tp_collective_bytes_per_step",
            "Modeled tp-axis collective bytes per decode step (fleet mean)",
        )
        # control-plane health of THIS process's fabric client (degraded-
        # mode data plane): same families every frontend exports for its
        # own client — federation distinguishes the processes by instance
        def _fab_status() -> dict:
            drt = getattr(self.component, "drt", None)
            fab = getattr(drt, "fabric", None)
            try:
                return fab.status() if fab is not None else {}
            except Exception:  # noqa: BLE001 — scrape must never fail
                return {}

        def fread(key: str):
            return lambda: float(_fab_status().get(key, 0) or 0)

        g_conn = Gauge(
            "dyn_fabric_connected",
            "Is the fabric (control plane) reachable from this process "
            "(1 connected, 0 unreachable)",
            registry=self.registry,
        )
        g_conn.set_function(fread("connected"))
        g_degraded = Gauge(
            "dyn_llm_degraded_mode",
            "Serving in degraded mode: control plane unreachable, routing "
            "from last-known tables, publishes buffered (1 yes, 0 no)",
            registry=self.registry,
        )
        g_degraded.set_function(fread("degraded"))
        CallbackCounter(
            self.registry,
            "dyn_llm_degraded_seconds_total",
            "Cumulative seconds this process has served without a "
            "reachable control plane",
            fread("degraded_seconds_total"),
        )
        CallbackCounter(
            self.registry,
            "dyn_fabric_blackouts_total",
            "Times the control plane became unreachable",
            fread("blackouts_total"),
        )
        self.c_hit_events = Counter(
            f"{PREFIX}_kv_hit_rate_events_total",
            "kv-hit-rate events seen",
            registry=self.registry,
        )
        self.g_event_isl = g("kv_hit_isl_blocks", "Last event ISL blocks")
        self.g_event_overlap = g(
            "kv_hit_overlap_blocks", "Last event overlap blocks"
        )
        self.g_cumulative_hit_rate = g(
            "kv_hit_rate_cumulative", "Cumulative router overlap / ISL"
        )
        # KV-hit-rate event plane (reference plane 3): the router's
        # per-decision overlap events aggregated into a fleet hit rate and
        # a running matched-blocks counter (prefill compute saved)
        self.g_kv_hit_rate = g(
            "kv_hit_rate",
            "Router KV hit rate: matched / required prefill blocks",
        )
        self.c_matched_blocks = Counter(
            f"{PREFIX}_kv_matched_blocks_total",
            "Prefill blocks served from a routed worker's cache",
            registry=self.registry,
        )
        # fleet prefix cache: best-anywhere match rate; the
        # gap to kv_hit_rate is the prefill compute peer pulls can close
        self.g_event_fleet = g(
            "kv_hit_fleet_blocks", "Last event fleet-best matched blocks"
        )
        self.g_kv_fleet_hit_rate = g(
            "kv_fleet_hit_rate",
            "Fleet-best KV match rate: best matched / required prefill "
            "blocks held anywhere in the fleet",
        )
        # counter-semantics + histogram + SLO families (scrape-time)
        self.registry.register(_FleetCollector(self))
        self._isl_sum = 0
        self._overlap_sum = 0
        self._fleet_sum = 0
        self._tasks: list[asyncio.Task] = []
        self.last: Optional[ForwardPassMetrics] = None
        # latest per-worker scrape, kept for /debug/goodput's per-worker
        # view (the fleet-merged view comes from self.last.goodput)
        self.last_per_worker: dict[int, ForwardPassMetrics] = {}
        # latest planner-published status (PLANNER_STATUS_KEY), refreshed
        # by the poll loop; renders as dyn_planner_*/dyn_supervisor_*
        self.planner_status: dict = {}
        # latest rollout snapshot (UPGRADE_STATUS_KEY, JSON), refreshed
        # by the poll loop; renders as dyn_fleet_upgrade_*
        self.upgrade_status: dict = {}

    async def start(self) -> int:
        port = await self.server.start()
        # subscribe before returning so no pre-start event is missed
        sub = await self.component.namespace.subscribe_event(
            KV_HIT_RATE_SUBJECT
        )
        loop = asyncio.get_running_loop()
        self._tasks.append(loop.create_task(self._poll_loop()))
        self._tasks.append(loop.create_task(self._hit_rate_loop(sub)))
        return port

    async def close(self) -> None:
        for t in self._tasks:
            t.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await t
        await self.server.close()

    # ---------------------------------------------------------------- slo

    def _on_slo_transition(self, old: str, new: str, status: dict) -> None:
        logger.warning("fleet SLO state: %s -> %s", old, new)
        payload = {"old": old, "new": new, **status}

        async def _publish() -> None:
            with contextlib.suppress(Exception):
                await self.component.namespace.publish_event(
                    dslo.SLO_STATUS_SUBJECT, payload
                )

        with contextlib.suppress(RuntimeError):
            asyncio.get_running_loop().create_task(_publish())

    async def _debug_slo(self) -> tuple[int, bytes, str]:
        cfg = self.slo.config
        if not cfg.enabled:
            return _json(
                {
                    "enabled": False,
                    "hint": "set DYN_SLO_TTFT_MS / DYN_SLO_ITL_MS "
                    "or DYN_SLO_CONFIG",
                }
            )
        return _json(
            {
                "enabled": True,
                "scope": "fleet",
                "status": self.slo.evaluate(),
            }
        )

    async def _debug_goodput(self) -> tuple[int, bytes, str]:
        """Fleet-merged goodput ledger plus the per-worker views it was
        merged from (GoodputStats.summary() both levels)."""
        agg = self.last
        fleet = (
            agg.goodput.summary()
            if agg is not None and agg.goodput is not None
            else None
        )
        workers = {
            f"{wid:x}": m.goodput.summary()
            for wid, m in sorted(self.last_per_worker.items())
            if m.goodput is not None
        }
        return _json({"scope": "fleet", "fleet": fleet, "workers": workers})

    # -------------------------------------------------------------- loops

    async def _poll_loop(self) -> None:
        while True:
            try:
                per_worker = await self.aggregator.collect()
                agg = await self.aggregator.aggregate(per_worker)
                self.last = agg
                self.last_per_worker = per_worker
                for wid, m in per_worker.items():
                    self.health.observe_worker_hists(
                        wid, m.phase_histograms
                    )
                self.health.tick()
                self.g_workers.set(len(per_worker))
                self.g_active_slots.set(agg.worker_stats.request_active_slots)
                self.g_total_slots.set(agg.worker_stats.request_total_slots)
                self.g_waiting.set(agg.worker_stats.num_requests_waiting)
                self.g_kv_active.set(agg.kv_stats.kv_active_blocks)
                self.g_kv_total.set(agg.kv_stats.kv_total_blocks)
                self.g_cache_usage.set(agg.kv_stats.gpu_cache_usage_perc)
                self.g_hit_rate.set(agg.kv_stats.gpu_prefix_cache_hit_rate)
                spec = agg.spec_decode_stats
                if spec is not None:
                    self.g_spec_drafts.set(spec.num_drafts or 0)
                    self.g_spec_draft_tokens.set(spec.num_draft_tokens or 0)
                    self.g_spec_accepted.set(spec.num_accepted_tokens or 0)
                    self.g_spec_accept_rate.set(spec.acceptance_rate)
                xfer = agg.kv_transfer_stats
                if xfer is not None:
                    self.g_kv_frames_inflight.set(xfer.kv_frames_inflight)
                    self.g_kv_overlap.set(xfer.overlap_fraction)
                self.g_decode_hbm_bytes.set(
                    agg.worker_stats.decode_hbm_bytes_per_token
                )
                self.g_mfu_decode.set(agg.worker_stats.mfu_decode_est)
                self.g_tp_collective_bytes.set(
                    agg.worker_stats.tp_collective_bytes_per_step
                )
                # burn-rate windows advance on every poll, with or without
                # fresh phase data (recovery to ok needs empty ticks too)
                self.slo.observe(
                    agg.phase_histograms
                    if agg.phase_histograms is not None
                    else PhaseHistograms()
                )
                # planner status (closed-loop fleet plane): best-effort
                # read of the kv key the planner publishes after every
                # decision — absent key keeps the last-seen view
                with contextlib.suppress(Exception):
                    raw = await self.component.drt.fabric.kv_get(
                        PLANNER_STATUS_KEY
                    )
                    if raw:
                        self.planner_status = mpack.unpackb(raw)
                # rolling-upgrade status (fleet change plane): the
                # coordinator publishes JSON snapshots on every phase
                # transition — absent key keeps the last-seen view
                with contextlib.suppress(Exception):
                    raw = await self.component.drt.fabric.kv_get(
                        UPGRADE_STATUS_KEY
                    )
                    if raw:
                        self.upgrade_status = json.loads(raw.decode())
            except Exception:  # noqa: BLE001 — scrape failures are transient
                logger.exception("metrics poll failed")
            await asyncio.sleep(self.poll_interval)

    async def _hit_rate_loop(self, sub) -> None:
        async for _subject, payload in sub:
            try:
                data = mpack.unpackb(payload)
                isl = int(data.get("isl_blocks", 0))
                overlap = int(data.get("overlap_blocks", 0))
                fleet = int(data.get("fleet_blocks", 0))
            except (TypeError, AttributeError, ValueError):
                continue
            self.c_hit_events.inc()
            self.c_matched_blocks.inc(max(0, overlap))
            self.g_event_isl.set(isl)
            self.g_event_overlap.set(overlap)
            self.g_event_fleet.set(fleet)
            self._isl_sum += isl
            self._overlap_sum += overlap
            self._fleet_sum += fleet
            if self._isl_sum:
                rate = self._overlap_sum / self._isl_sum
                self.g_cumulative_hit_rate.set(rate)
                self.g_kv_hit_rate.set(rate)
                self.g_kv_fleet_hit_rate.set(self._fleet_sum / self._isl_sum)


class MockWorkerMetrics:
    """Synthetic stats publisher (components/metrics/src/bin/mock_worker.rs):
    registers on the endpoint and publishes a slow sine-wave load so the
    metrics plane, the SLO engine, and the planner can run with no engine
    at all. Publishes the FULL modern stats surface: slots/blocks, the
    request-lifeguard counters, spec-decode and KV-transfer counters, and
    phase histograms whose latencies scale with the simulated load (set
    `ttft_ms`/`itl_ms` above the configured SLO to exercise a breach
    engine-free)."""

    def __init__(
        self,
        endpoint: Endpoint,
        instance_id: int,
        period_s: float = 30.0,
        total_slots: int = 16,
        total_blocks: int = 512,
        ttft_ms: float = 120.0,
        itl_ms: float = 12.0,
        load_fn=None,  # () -> load; overrides the sine (planner sims)
        slow_factor: float = 1.0,  # gray-worker knob: all latencies xN
    ) -> None:
        self.publisher = WorkerMetricsPublisher(
            endpoint.component, endpoint.id, instance_id
        )
        self.period_s = period_s
        self.total_slots = total_slots
        self.total_blocks = total_blocks
        self.ttft_ms = ttft_ms
        self.itl_ms = itl_ms
        # externally-driven load for fleet simulations: a value > 1 means
        # OVERLOAD — latencies blow up superlinearly past saturation, the
        # regime the closed-loop planner must scale out of
        self.load_fn = load_fn
        # gray-worker simulation (tail-tolerance plane): every published
        # latency is slow_factor times the fleet-typical value, while
        # slots/blocks/lease stay perfectly healthy — a straggler the
        # health scorer must catch from self-reports alone. Settable live
        # so tests can flap it (gray_flap hysteresis, engine-free).
        self.slow_factor = slow_factor
        self._t = 0.0
        # monotonic counter state (worker lifetime)
        self._deadline_exceeded = 0
        self._watchdog_trips = 0
        self._preemptions_by_class: dict[str, int] = {}
        self._preempted_too_often = 0
        self._shed_brownout = 0
        self.brownout_level = 0  # settable knob (exercise the gauge)
        # integrity plane: rare deterministic corruption/fence events so
        # the new families render engine-free
        self._integrity_failures: dict[str, int] = {}
        self._blocks_quarantined = 0
        self._fenced_rejects: dict[str, int] = {}
        self._spec = SpecDecodeStats(
            num_spec_tokens=4,
            num_drafts=0,
            num_draft_tokens=0,
            num_accepted_tokens=0,
            num_accepted_tokens_per_pos=[0, 0, 0, 0],
        )
        self._xfer = KvTransferStats()
        self.hist = PhaseHistograms()
        # goodput ledger: always-on here regardless of env so
        # the efficiency dashboards render engine-free. Steps ride a
        # simulated clock, so bubbles/occupancy are exact and repeatable.
        self.goodput = GoodputLedger(enabled=True)
        self._sim_t = 0.0

    def snapshot(self) -> ForwardPassMetrics:
        self._t += 1.0
        if self.load_fn is not None:
            raw_load = max(0.0, float(self.load_fn()))
        else:
            phase = (self._t % self.period_s) / self.period_s * 2 * math.pi
            raw_load = (math.sin(phase) + 1) / 2  # 0..1
        load = min(1.0, raw_load)
        overload = max(0.0, raw_load - 1.0)  # queueing regime past 1.0
        active_blocks = int(self.total_blocks * load)
        # a few synthetic requests this tick; latencies scale with load
        # (deterministic — no RNG, so dashboards and tests are repeatable)
        reqs = 1 + int(3 * load)
        for i in range(reqs):
            scale = (0.7 + 0.6 * load + 4.0 * overload + 0.05 * i) * max(
                0.01, self.slow_factor
            )
            self.hist.observe("queue_wait", 2.0 * scale)
            self.hist.observe("prefill", 40.0 * scale)
            self.hist.observe("ttft", self.ttft_ms * scale)
            for _ in range(4):
                self.hist.observe("inter_token", self.itl_ms * scale)
            self.hist.observe(
                "e2e", (self.ttft_ms + 4 * self.itl_ms) * scale
            )
        # spec decode: 4-token drafts at a steady ~75% acceptance
        self._spec.num_drafts += reqs
        self._spec.num_draft_tokens += 4 * reqs
        self._spec.num_accepted_tokens += 3 * reqs
        for pos in range(3):
            self._spec.num_accepted_tokens_per_pos[pos] += reqs
        # KV data plane: frames/bytes move with load, mostly overlapped
        frames = 2 * reqs
        frame_bytes = 8192
        self._xfer.kv_frames_tx += frames
        self._xfer.kv_frames_rx += frames
        self._xfer.kv_wire_bytes_tx += frames * frame_bytes
        self._xfer.kv_wire_bytes_rx += frames * frame_bytes
        self._xfer.kv_bytes_overlapped += (frames - 1) * frame_bytes
        self._xfer.kv_frames_inflight = 1 if load > 0.5 else 0
        # lifeguard counters tick over at peak load
        if load > 0.95:
            self._deadline_exceeded += 1
        if self._t % 300 == 0:
            self._watchdog_trips += 1
        # QoS plane: under high load the class-aware scheduler preempts
        # bulk work (and occasionally standard); the storm guard trips
        # rarely — deterministic, like everything else here
        if load > 0.8:
            self._preemptions_by_class["bulk"] = (
                self._preemptions_by_class.get("bulk", 0) + 2
            )
        if load > 0.97:
            self._preemptions_by_class["standard"] = (
                self._preemptions_by_class.get("standard", 0) + 1
            )
        if self._t % 500 == 0:
            self._preempted_too_often += 1
        if self.brownout_level >= 1 and load > 0.5:
            self._shed_brownout += 1
        # integrity plane: a corrupt tier page every ~200 ticks (every
        # second one tips the block into quarantine at the default
        # fail-twice threshold), a fenced dispatch reject every ~400
        if self._t % 200 == 0:
            self._integrity_failures["tier_disk"] = (
                self._integrity_failures.get("tier_disk", 0) + 1
            )
            if self._t % 400 == 0:
                self._blocks_quarantined += 1
        if self._t % 400 == 100:
            self._fenced_rejects["dispatch"] = (
                self._fenced_rejects.get("dispatch", 0) + 1
            )
        # goodput ledger: one prefill + a decode burst per synthetic
        # request on the simulated clock (1 ms scheduling bubble between
        # dispatches), waste consistent with the other synthetic planes —
        # spec rejects match the 3-of-4 acceptance above, preempt replays
        # match preemptions_by_class, deadline partials match
        # num_deadline_exceeded
        gp = self.goodput
        if self._t == 1.0:
            gp.record_compile("prefill", 6.0)
            gp.record_compile("decode", 11.0)
        lanes = max(1, int(self.total_slots * load))
        t = self._sim_t
        for i in range(reqs):
            scale = (0.7 + 0.6 * load + 4.0 * overload + 0.05 * i) * max(
                0.01, self.slow_factor
            )
            t += 0.001
            dur = 0.040 * scale
            gp.record_step("prefill", dur, prefill_tokens=256, t_start=t)
            t += dur
            for _ in range(4):
                t += 0.001
                dur = self.itl_ms / 1e3 * scale
                gp.record_step(
                    "decode",
                    dur,
                    lanes=lanes,
                    capacity=self.total_slots,
                    t_start=t,
                )
                t += dur
        self._sim_t = t
        gp.record_decode_tokens(4 * reqs)
        gp.record_waste("spec_rejected", reqs)  # 1 of 4 drafts rejected
        if load > 0.8:
            gp.record_waste("preempt_replay", 2 * 128)
        if load > 0.95:
            gp.record_waste("deadline_partial", 32)
        if self._t % 250 == 50:
            gp.record_waste("cancelled_partial", 16)
        if self._t % 1000 == 500:
            gp.record_recompile(
                "decode", "shape_miss", shape=f"lanes={lanes},tokens=0"
            )
        gp.set_perf_gauges(0.05 * load, 4e8 / (1.0 + 3.0 * load))
        return ForwardPassMetrics(
            worker_stats=WorkerStats(
                request_active_slots=int(self.total_slots * load),
                request_total_slots=self.total_slots,
                num_requests_waiting=int(
                    4 * max(0.0, load - 0.75) + 16 * overload
                ),
                num_deadline_exceeded=self._deadline_exceeded,
                num_watchdog_trips=self._watchdog_trips,
                preemptions_by_class=dict(self._preemptions_by_class) or None,
                num_preempted_too_often=self._preempted_too_often,
                num_shed_brownout=self._shed_brownout,
                brownout_level=self.brownout_level,
                integrity_failures_by_path=(
                    dict(self._integrity_failures) or None
                ),
                num_blocks_quarantined=self._blocks_quarantined,
                fenced_rejects_by_plane=dict(self._fenced_rejects) or None,
                # decode-bandwidth gauges: bytes/token shrinks a little as
                # load grows (bigger batches amortize the weight stream),
                # MFU tracks load — deterministic like everything else
                decode_hbm_bytes_per_token=4e8 / (1.0 + 3.0 * load),
                mfu_decode_est=0.05 * load,
            ),
            kv_stats=KvStats(
                kv_active_blocks=active_blocks,
                kv_total_blocks=self.total_blocks,
                gpu_cache_usage_perc=load,
                gpu_prefix_cache_hit_rate=0.5,
            ),
            spec_decode_stats=self._spec,
            kv_transfer_stats=self._xfer,
            phase_histograms=self.hist,
            goodput=self.goodput,
        )

    async def start(self) -> None:
        await self.publisher.start(self.snapshot)

    async def stop(self) -> None:
        await self.publisher.stop()


async def _main() -> None:
    import argparse

    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default="backend")
    p.add_argument("--endpoint", default="generate")
    p.add_argument("--port", type=int, default=9091)
    p.add_argument("--poll-interval", type=float, default=1.0)
    p.add_argument(
        "--mock-worker",
        action="store_true",
        help="also run a synthetic stats publisher against the endpoint",
    )
    args = p.parse_args()

    drt = await DistributedRuntime.from_settings()
    comp = drt.namespace(args.namespace).component(args.component)
    eid = EndpointId(args.namespace, args.component, args.endpoint)
    metrics = MetricsComponent(
        comp, eid, poll_interval=args.poll_interval, port=args.port
    )
    port = await metrics.start()
    logger.info("metrics component scraping %s on :%d", eid, port)
    mock = None
    if args.mock_worker:
        ep = comp.endpoint(args.endpoint)
        mock = MockWorkerMetrics(ep, instance_id=0)
        await mock.start()
    try:
        await drt.token.cancelled()  # exits on fabric loss too
    finally:
        if mock:
            await mock.stop()
        await metrics.close()
        await drt.close()


if __name__ == "__main__":
    asyncio.run(_main())
