"""Tail-tolerance plane: gray-failure detection + latency-outlier
ejection + hedged-dispatch bookkeeping.

The port's own copy of dynamo_tpu/telemetry/health.py; ejections, restores
and probation probes are ``health/*`` decision records
(``telemetry/provenance.py``).

Every failure mode the stack already handles is binary: dead workers
migrate, fenced zombies are rejected, crash-loopers are quarantined. A
GRAY worker — alive, lease-healthy, checksums clean, but 3-10x slow from
thermal throttling, a noisy neighbor, or a degraded ICI link — sails
past all of them and silently drags fleet p99 TTFT/ITL. The canonical
fix (Dean & Barroso, "The Tail at Scale") is the pair implemented here:

  * `HealthScorer` — a per-worker health score maintained from TWO
    sides: consumer-observed latencies (dispatch / first-frame /
    inter-frame, recorded by `RemoteEngine` at the stream edge) and the
    worker's own self-reported phase-histogram DELTAS (the always-on
    `PhaseHistograms` already riding `ForwardPassMetrics`). Each signal
    is normalized against the FLEET MEDIAN of that signal, so the score
    is a dimensionless slowness ratio (1.0 = typical, 5.0 = five times
    slower than the median worker), smoothed by an EWMA. Every worker
    view carries a staleness stamp — like `FleetSampler`, one missed
    scrape AGES the score (decays toward 1.0) rather than lying.

  * Outlier ejection — a worker whose score stays >= `DYN_EJECT_RATIO`
    for `DYN_EJECT_INTERVALS` consecutive score ticks is EJECTED from
    routing (`KvScheduler.schedule`, `Client._eligible`, the standalone
    router). Probation re-entry: an ejected worker still receives a
    trickle of probe traffic (1-in-`DYN_EJECT_PROBE_EVERY` routing
    decisions) and keeps self-reporting, so recovery is observable;
    `DYN_EJECT_RECOVER_INTERVALS` consecutive ticks below
    `DYN_EJECT_RECOVER_RATIO` re-admit it. The enter/exit thresholds
    and interval requirements are a hysteresis band: a gray-FLAPPING
    worker (oscillating slowness) either stays in or stays out — it
    must never flap the route set. A hard floor of `DYN_EJECT_MIN_HEALTHY`
    workers can never be ejected (ejecting the whole fleet is worse
    than tolerating stragglers).

  * `HedgeController` — bookkeeping for hedged dispatch (`DYN_HEDGE=1`,
    off by default): an interactive request whose first token hasn't
    arrived within a dynamic delay (recent first-frame p95, floored at
    `DYN_HEDGE_MIN_MS`) launches ONE hedge on a different worker; the
    first stream to produce a token wins and the loser is cancelled.
    A global budget caps extra dispatches at `DYN_HEDGE_BUDGET`
    (default 5%) of primary dispatches.

Pure stdlib, allocation-light, and engine-free: the scorer runs in
whatever process routes (frontend, standalone router, metrics
component) and never touches the wire itself.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Callable, Optional

from dynamo_tpu_torch.runtime import clock as dclock
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.telemetry import provenance as dprov
from dynamo_tpu_torch.telemetry.histogram import PhaseHistograms

logger = get_logger("dynamo_tpu_torch.telemetry.health")

# ejection/health events ride the namespace event plane on this subject
# (the planner subscribes and converts ejections into capacity-loss
# pressure via Planner.note_capacity_loss, so substitutes spawn)
HEALTH_SUBJECT = "health-status"

HEALTHY = "healthy"
EJECTED = "ejected"

# consumer-observed signal names (RemoteEngine records these); the
# self-reported pair comes from the worker's own phase histograms
SIGNALS = ("dispatch", "first_frame", "inter_frame", "self_ttft", "self_itl")


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_i(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


@dataclass
class HealthConfig:
    """Knobs of the ejection state machine (env-layered defaults)."""

    # a worker this many times slower than the fleet median is an outlier
    eject_ratio: float = field(
        default_factory=lambda: _env_f("DYN_EJECT_RATIO", 3.0)
    )
    # consecutive outlier score ticks before ejection fires
    eject_intervals: int = field(
        default_factory=lambda: _env_i("DYN_EJECT_INTERVALS", 3)
    )
    # re-entry (hysteresis): this many consecutive ticks BELOW the
    # recover ratio; recover < eject so a flapping worker can't oscillate
    # across a single threshold
    recover_ratio: float = field(
        default_factory=lambda: _env_f("DYN_EJECT_RECOVER_RATIO", 1.5)
    )
    recover_intervals: int = field(
        default_factory=lambda: _env_i("DYN_EJECT_RECOVER_INTERVALS", 3)
    )
    # never eject below this many healthy workers
    min_healthy: int = field(
        default_factory=lambda: _env_i("DYN_EJECT_MIN_HEALTHY", 1)
    )
    # probation trickle: 1 in N routing decisions may still land on an
    # ejected worker so consumer-observed recovery stays measurable
    probe_every: int = field(
        default_factory=lambda: _env_i("DYN_EJECT_PROBE_EVERY", 16)
    )
    # suspects (score above this, below eject) are deweighted in the KV
    # scheduler's cost function rather than removed
    deweight_ratio: float = field(
        default_factory=lambda: _env_f("DYN_DEWEIGHT_RATIO", 1.5)
    )
    # EWMA smoothing for the slowness score (per tick)
    alpha: float = field(default_factory=lambda: _env_f("DYN_HEALTH_ALPHA", 0.4))
    # a view older than this ages: its score decays toward 1.0 each tick
    # instead of holding a possibly-stale verdict
    stale_after_s: float = field(
        default_factory=lambda: _env_f("DYN_HEALTH_STALE_S", 10.0)
    )
    # forget a worker entirely after this long without any signal
    forget_after_s: float = field(
        default_factory=lambda: _env_f("DYN_HEALTH_FORGET_S", 120.0)
    )


class _Ewma:
    """Scalar EWMA with sample count (consumer-observed latency signal)."""

    __slots__ = ("value", "n")

    def __init__(self) -> None:
        self.value: Optional[float] = None
        self.n = 0

    def add(self, x: float, alpha: float = 0.3) -> None:
        self.value = x if self.value is None else (
            (1.0 - alpha) * self.value + alpha * x
        )
        self.n += 1


class _WorkerView:
    """Everything the scorer knows about one worker."""

    __slots__ = (
        "signals", "prev_hists", "self_ttft_ms", "self_itl_ms",
        "score", "state", "bad_ticks", "good_ticks", "probe_countdown",
        "updated_t", "eject_cause",
    )

    def __init__(self, now: float) -> None:
        # consumer-observed EWMAs (ms) by signal name
        self.signals: dict[str, _Ewma] = {}
        # previous self-reported histogram snapshot (cumulative) for deltas
        self.prev_hists: Optional[PhaseHistograms] = None
        self.self_ttft_ms: Optional[float] = None
        self.self_itl_ms: Optional[float] = None
        self.score = 1.0
        self.state = HEALTHY
        self.bad_ticks = 0
        self.good_ticks = 0
        self.probe_countdown = 0
        self.updated_t = now
        self.eject_cause = ""

    def observed(self, signal: str) -> Optional[float]:
        if signal == "self_ttft":
            return self.self_ttft_ms
        if signal == "self_itl":
            return self.self_itl_ms
        e = self.signals.get(signal)
        return e.value if e is not None else None


class StreamPace:
    """One stream's token pace, as the health plane scores it (C15; a
    worker's ``pace`` health histogram, which the scorer reads in place of
    its ``inter_token``, and a frontend's ``inter_frame`` signal, the
    scorer's own EWMA). A worker marks each token with the dispatch that
    fetched it (``LLMEngineOutput.fetch``): the tokens of one fetch -- a
    decode horizon's H steps -- reach the stream back to back, so their
    gap is spread over them (each token's share of the fetch's wait)
    instead of one horizon-long gap and H - 1 gaps near zero, whose median
    is the stream consumer's pacing, not the worker's. A delivery marked
    ``cold`` (a graph capture, a kernel load or, on a card, a label's first
    dispatch held it) is not scored. Without
    ``fetch`` (the reference's workers) every token is its own delivery,
    the reference's rule."""

    __slots__ = ("t_last", "fetch", "gap_ms", "n", "cold")

    def __init__(self, now: float, fetch: Optional[int] = None) -> None:
        self.t_last = now
        self.fetch = fetch
        self.gap_ms: Optional[float] = None
        self.n = 0
        self.cold = False

    def token(self, now: float, fetch: Optional[int], cold: bool):
        """A token delivered at ``now`` (s). Returns the delivery it
        closes, as ``flush`` does, or None while the fetch goes on."""
        if fetch is not None and fetch == self.fetch:
            self.n += 1
            return None
        done = self.flush()
        self.gap_ms, self.n, self.cold, self.fetch = (now - self.t_last) * 1e3, 1, cold, fetch
        self.t_last = now
        return done

    def flush(self):
        """The open delivery as (ms per token, tokens, cold), or None."""
        if self.gap_ms is None:
            return None
        done = (self.gap_ms / self.n, self.n, self.cold)
        self.gap_ms = None
        return done


class HealthScorer:
    """Fleet-median-relative slowness scores + the ejection state machine.

    Thread-unsafe by design (lives on one event loop, like the
    scheduler); every recording call is O(1), `tick()` is O(workers).
    """

    def __init__(
        self,
        config: Optional[HealthConfig] = None,
        now_fn: Callable[[], float] = dclock.now,
        on_eject: Optional[Callable[[int, str], None]] = None,
        on_restore: Optional[Callable[[int], None]] = None,
    ) -> None:
        self.config = config or HealthConfig()
        self._now = now_fn
        self.on_eject = on_eject
        self.on_restore = on_restore
        self.workers: dict[int, _WorkerView] = {}
        # monotonic counters for the metrics plane
        self.ejections_total: dict[str, int] = {}
        self.restores_total = 0

    # ------------------------------------------------- consumer recording

    def _view(self, worker_id: int) -> _WorkerView:
        v = self.workers.get(worker_id)
        if v is None:
            v = self.workers[worker_id] = _WorkerView(self._now())
        return v

    def record(self, worker_id: int, signal: str, value_ms: float) -> None:
        """One consumer-observed latency sample (dispatch / first_frame /
        inter_frame). O(1): an EWMA update and a timestamp."""
        v = self._view(worker_id)
        v.signals.setdefault(signal, _Ewma()).add(value_ms)
        v.updated_t = self._now()

    # --------------------------------------------- self-reported recording

    def observe_worker_hists(
        self, worker_id: int, hists: Optional[PhaseHistograms],
        health: Optional[PhaseHistograms] = None,
    ) -> None:
        """Fold one worker's cumulative phase histograms into its view:
        the DELTA since the previous scrape (clamped sub, restart-safe)
        yields interval-true self-reported TTFT/ITL medians. ``health``: a
        port worker's own series for this plane (C15), given by every port
        worker: its ITL is then read from ``pace`` alone, and its
        ``ttft_cold`` is left out of its TTFT."""
        if health is not None:
            hists = hists.copy() if hists is not None else PhaseHistograms()
            hists.merge(health)
        if hists is None:
            return
        v = self._view(worker_id)
        prev = v.prev_hists
        v.prev_hists = hists.copy()
        now = self._now()

        def interval(phase: str):
            cur = hists.get(phase)
            if cur is not None and prev is not None and prev.get(phase) is not None:
                cur = cur.sub(prev.get(phase))
            return cur

        def interval_median(phase: str) -> Optional[float]:
            cur = interval(phase)
            if cur is not None and phase == "ttft":
                # a port worker's first tokens that waited on a graph
                # capture or a kernel load (``ttft_cold``, a subset of
                # ``ttft``) are not its pace (C15)
                cold = interval("ttft_cold")
                if cold is not None:
                    cur = cur.sub(cold)
            if cur is None or cur.count <= 0:
                return None
            return cur.percentile(50)

        ttft = interval_median("ttft")
        # a port worker's token pace by delivery (``pace``, StreamPace), a
        # reference worker's inter-token gaps: never one for the other in
        # an interval (under a horizon the gaps' median is near 0)
        itl = interval_median("pace" if health is not None else "inter_token")
        if ttft is not None:
            v.self_ttft_ms = ttft
            v.updated_t = now
        if itl is not None:
            v.self_itl_ms = itl
            v.updated_t = now

    def forget(self, worker_id: int) -> None:
        """Drop a worker that left discovery (its lease died — the binary
        failure planes own that path)."""
        self.workers.pop(worker_id, None)

    # --------------------------------------------------------------- tick

    def tick(self) -> None:
        """Score interval boundary: recompute fleet-median ratios, advance
        EWMAs, and run the ejection state machine. Call once per scrape
        interval (the capacity poller / metrics poll loop cadence)."""
        cfg = self.config
        now = self._now()
        # forget the long-gone
        for wid in [
            w for w, v in self.workers.items()
            if now - v.updated_t > cfg.forget_after_s
        ]:
            self.workers.pop(wid, None)
        if not self.workers:
            return
        # fleet median per signal, over workers that carry it
        medians: dict[str, float] = {}
        for sig in SIGNALS:
            vals = sorted(
                x for v in self.workers.values()
                if (x := v.observed(sig)) is not None and x > 0
            )
            if vals:
                # lower-middle median: with an even fleet the slower half
                # must not define "typical" (2 workers, one 5x slow —
                # the straggler would otherwise score 1.0 against itself)
                medians[sig] = vals[(len(vals) - 1) // 2]
        for wid, v in self.workers.items():
            stale = now - v.updated_t > cfg.stale_after_s
            if stale:
                # a stale view AGES: decay toward the neutral 1.0 so one
                # missed scrape softens the verdict instead of freezing it
                v.score = 1.0 + (v.score - 1.0) * (1.0 - cfg.alpha)
            else:
                raw = 1.0
                cause = ""
                for sig, med in medians.items():
                    x = v.observed(sig)
                    if x is None or med <= 0:
                        continue
                    r = x / med
                    if r > raw:
                        raw, cause = r, sig
                v.score = (1.0 - cfg.alpha) * v.score + cfg.alpha * raw
                if cause:
                    v.eject_cause = cause
            self._advance_state(wid, v, stale)

    def _advance_state(self, wid: int, v: _WorkerView, stale: bool) -> None:
        cfg = self.config
        if v.state == HEALTHY:
            if not stale and v.score >= cfg.eject_ratio:
                v.bad_ticks += 1
            else:
                v.bad_ticks = 0
            if v.bad_ticks >= cfg.eject_intervals and self._can_eject():
                v.state = EJECTED
                v.good_ticks = 0
                v.probe_countdown = cfg.probe_every
                cause = v.eject_cause or "latency"
                self.ejections_total[cause] = (
                    self.ejections_total.get(cause, 0) + 1
                )
                logger.warning(
                    "worker %x ejected from routing: health score %.2fx "
                    "fleet median (signal=%s)", wid, v.score, cause,
                )
                if dprov.enabled():
                    dprov.record("health", "eject", f"{wid:x}", reason=cause, epoch=f"{wid:x}",
                                 score=round(v.score, 4), bad_ticks=v.bad_ticks)
                if self.on_eject is not None:
                    try:
                        self.on_eject(wid, cause)
                    except Exception:  # noqa: BLE001 — observer must not break scoring
                        logger.exception("on_eject callback failed")
        else:  # EJECTED (probation runs inside: trickle + recovery count)
            if v.score < cfg.recover_ratio:
                v.good_ticks += 1
            elif not stale:
                v.good_ticks = 0
            if v.good_ticks >= cfg.recover_intervals:
                v.state = HEALTHY
                v.bad_ticks = 0
                self.restores_total += 1
                logger.info(
                    "worker %x re-admitted to routing (score %.2f)",
                    wid, v.score,
                )
                if dprov.enabled():
                    dprov.record("health", "restore", f"{wid:x}", reason="recovered",
                                 epoch=f"{wid:x}", score=round(v.score, 4),
                                 good_ticks=v.good_ticks)
                if self.on_restore is not None:
                    try:
                        self.on_restore(wid)
                    except Exception:  # noqa: BLE001
                        logger.exception("on_restore callback failed")

    def _can_eject(self) -> bool:
        healthy = sum(
            1 for v in self.workers.values() if v.state == HEALTHY
        )
        return healthy - 1 >= self.config.min_healthy

    # ------------------------------------------------------------ queries

    def score(self, worker_id: int) -> float:
        v = self.workers.get(worker_id)
        return v.score if v is not None else 1.0

    def scores(self) -> dict[int, float]:
        return {wid: v.score for wid, v in self.workers.items()}

    def ejected(self) -> set[int]:
        return {
            wid for wid, v in self.workers.items() if v.state == EJECTED
        }

    def routing_excluded(self) -> set[int]:
        """The ejection set as routing should see it RIGHT NOW: ejected
        workers, minus any whose probation trickle is due this decision
        (1 in `probe_every` calls re-admits one probe request)."""
        out: set[int] = set()
        for wid, v in self.workers.items():
            if v.state != EJECTED:
                continue
            v.probe_countdown -= 1
            if v.probe_countdown <= 0:
                v.probe_countdown = self.config.probe_every
                if dprov.enabled():
                    # the probation trickle: this decision may land on the
                    # ejected worker again
                    dprov.record("health", "probe", f"{wid:x}", reason="trickle",
                                 epoch=f"{wid:x}", score=round(v.score, 4))
                continue  # probe: let this decision consider the worker
            out.add(wid)
        return out

    def route_set(self, worker_ids: list[int]) -> list[int]:
        """Filter a live worker-id list for routing. Falls back to the
        full list if exclusion would empty it (the min-healthy floor
        guards ejection itself, but the live set may have shrunk since)."""
        if not self.workers:
            return worker_ids
        avoid = self.routing_excluded()
        if not avoid:
            return worker_ids
        kept = [w for w in worker_ids if w not in avoid]
        return kept or worker_ids

    def penalty(self, worker_id: int) -> float:
        """Cost-function deweight for SUSPECT (not yet ejected) workers:
        1.0 for healthy, rising with the slowness score, capped at the
        eject ratio (past which the worker leaves the route set anyway)."""
        v = self.workers.get(worker_id)
        if v is None:
            return 1.0
        cfg = self.config
        if v.score <= cfg.deweight_ratio:
            return 1.0
        return min(v.score, cfg.eject_ratio)

    def status(self) -> dict:
        """Wire/debug form (also the metrics-plane read surface)."""
        return {
            "workers": {
                f"{wid:x}": {
                    "score": round(v.score, 3),
                    "state": v.state,
                    "stale": (
                        self._now() - v.updated_t > self.config.stale_after_s
                    ),
                }
                for wid, v in self.workers.items()
            },
            "ejected": sorted(f"{w:x}" for w in self.ejected()),
            "ejections_total": dict(self.ejections_total),
            "restores_total": self.restores_total,
        }


# ------------------------------------------------------------------ hedge


class HedgeController:
    """Budgeted hedged-dispatch bookkeeping (the policy half lives in
    RemoteEngine). Tracks a ring of recent first-frame latencies for the
    dynamic hedge delay (p95, floored at `DYN_HEDGE_MIN_MS`), enforces
    the global extra-dispatch budget (`DYN_HEDGE_BUDGET`, default 5%),
    and counts outcomes for `dyn_llm_hedges_total{outcome}`."""

    def __init__(
        self,
        budget_fraction: Optional[float] = None,
        min_delay_ms: Optional[float] = None,
        window: int = 256,
    ) -> None:
        self.budget_fraction = (
            budget_fraction
            if budget_fraction is not None
            else _env_f("DYN_HEDGE_BUDGET", 0.05)
        )
        self.min_delay_ms = (
            min_delay_ms
            if min_delay_ms is not None
            else _env_f("DYN_HEDGE_MIN_MS", 50.0)
        )
        self._window = max(16, int(window))
        self._samples: list[float] = []
        self._idx = 0
        self.dispatches = 0
        self.hedges = 0
        self.outcomes: dict[str, int] = {
            "won": 0, "lost": 0, "budget_denied": 0,
        }
        self.wasted_tokens = 0

    # ----------------------------------------------------------- sensing

    def note_dispatch(self) -> None:
        self.dispatches += 1

    def note_first_frame(self, ms: float) -> None:
        if len(self._samples) < self._window:
            self._samples.append(ms)
        else:
            self._samples[self._idx] = ms
            self._idx = (self._idx + 1) % self._window

    def delay_ms(self) -> float:
        """The dynamic hedge trigger: p95 of recent first-frame latencies
        (hedging at the p95 bounds extra dispatches near the budget by
        construction), floored so cold starts don't hedge everything."""
        if not self._samples:
            return self.min_delay_ms
        xs = sorted(self._samples)
        p95 = xs[min(len(xs) - 1, math.ceil(0.95 * len(xs)) - 1)]
        return max(self.min_delay_ms, p95)

    # ------------------------------------------------------------ budget

    def try_acquire(self) -> bool:
        """Permission for ONE hedge dispatch. Counts a denial when the
        global budget (hedges / dispatches <= budget_fraction) is spent;
        a small burst floor lets the very first hedges through before
        the denominator has grown."""
        allowed = max(2.0, self.budget_fraction * self.dispatches)
        if self.hedges + 1 > allowed:
            self.outcomes["budget_denied"] += 1
            return False
        self.hedges += 1
        return True

    def note_outcome(self, outcome: str, wasted_tokens: int = 0) -> None:
        self.outcomes[outcome] = self.outcomes.get(outcome, 0) + 1
        self.wasted_tokens += max(0, int(wasted_tokens))

    def status(self) -> dict:
        return {
            "dispatches": self.dispatches,
            "hedges": self.hedges,
            "outcomes": dict(self.outcomes),
            "wasted_tokens": self.wasted_tokens,
            "delay_ms": round(self.delay_ms(), 3),
        }


def hedge_enabled() -> bool:
    """The one-flag fast-path check (`DYN_HEDGE`, off by default)."""
    return os.environ.get("DYN_HEDGE", "0").strip() not in ("", "0", "off")
