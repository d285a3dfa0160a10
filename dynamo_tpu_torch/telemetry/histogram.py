"""Mergeable fixed-log-bucket phase histograms (the fleet SLO substrate).

The port's own copy of dynamo_tpu/telemetry/histogram.py.

Frontend-local Prometheus histograms (`http/metrics.py`) only see the
requests that one process served; fleet percentiles need per-worker
distributions that can be shipped on `ForwardPassMetrics` and merged by
the aggregator. Because every worker uses the SAME fixed bucket grid,
merging is plain bucket addition — associative and commutative, so the
aggregate is identical no matter how many hops (worker -> aggregator ->
planner) it takes or in what order workers report.

Grid: bucket `i` covers `(BASE_MS * GROWTH^(i-1), BASE_MS * GROWTH^i]`
with GROWTH = 2^(1/4), spanning 0.05 ms to ~3 h in 112 buckets. Quantile
estimates take the geometric midpoint of the selected bucket, so the
relative error is bounded by `sqrt(GROWTH) - 1` (~9%) by construction.

Everything here is pure stdlib and allocation-light: `observe()` is a
bisect + two adds, cheap enough to stay always-on in the engine hot path
(unlike tracing, which is gated behind DYN_TRACE).
"""

from __future__ import annotations

import math
from bisect import bisect_left
from typing import Any, Iterable, Optional

BASE_MS = 0.05
GROWTH = 2.0 ** 0.25
NUM_BUCKETS = 112

# Upper bucket bounds in ms (BOUNDS[i] = BASE_MS * GROWTH**i); the last
# bucket additionally absorbs every overflow observation.
BOUNDS: tuple[float, ...] = tuple(
    BASE_MS * GROWTH ** i for i in range(NUM_BUCKETS)
)

# Bound on the relative error of quantile estimates (geometric midpoint
# of a bucket vs any true value inside it).
QUANTILE_REL_ERROR = math.sqrt(GROWTH) - 1.0

# The phases both engines record (same instrumentation points the
# tracing plane's spans cover, but always-on and distribution-valued).
PHASES = ("queue_wait", "prefill", "ttft", "inter_token", "e2e")


def bucket_index(value_ms: float) -> int:
    """Grid index for one observation (clamped into the last bucket)."""
    if value_ms <= BASE_MS:
        return 0
    return min(NUM_BUCKETS - 1, bisect_left(BOUNDS, value_ms))


class PhaseHistogram:
    """One phase's latency distribution on the shared fixed-log grid."""

    __slots__ = ("counts", "count", "sum_ms")

    def __init__(self) -> None:
        self.counts = [0] * NUM_BUCKETS
        self.count = 0
        self.sum_ms = 0.0

    # ------------------------------------------------------------ record

    def observe(self, value_ms: float) -> None:
        if value_ms < 0:
            value_ms = 0.0
        self.counts[bucket_index(value_ms)] += 1
        self.count += 1
        self.sum_ms += value_ms

    # ------------------------------------------------------------- merge

    def merge(self, other: "PhaseHistogram") -> None:
        """Bucket addition — associative/commutative by construction."""
        oc = other.counts
        c = self.counts
        for i in range(NUM_BUCKETS):
            if oc[i]:
                c[i] += oc[i]
        self.count += other.count
        self.sum_ms += other.sum_ms

    def sub(self, older: "PhaseHistogram") -> "PhaseHistogram":
        """Windowed delta between two cumulative snapshots. Clamped at
        zero per bucket: a worker restart resets its counters, and a
        negative window must read as 'no data', never crash burn math."""
        out = PhaseHistogram()
        oc = older.counts
        c = self.counts
        n = 0
        for i in range(NUM_BUCKETS):
            d = c[i] - oc[i]
            if d > 0:
                out.counts[i] = d
                n += d
        out.count = n
        out.sum_ms = max(0.0, self.sum_ms - older.sum_ms)
        return out

    def copy(self) -> "PhaseHistogram":
        out = PhaseHistogram()
        out.counts = list(self.counts)
        out.count = self.count
        out.sum_ms = self.sum_ms
        return out

    # ------------------------------------------------------------- query

    @property
    def mean_ms(self) -> float:
        return self.sum_ms / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """Estimated p-th percentile in ms (geometric bucket midpoint;
        relative error <= QUANTILE_REL_ERROR). 0.0 when empty."""
        if not self.count:
            return 0.0
        rank = max(1, math.ceil(self.count * min(100.0, max(0.0, p)) / 100.0))
        seen = 0
        for i in range(NUM_BUCKETS):
            seen += self.counts[i]
            if seen >= rank:
                hi = BOUNDS[i]
                if i == 0:
                    return hi / 2.0
                return math.sqrt(BOUNDS[i - 1] * hi)
        return BOUNDS[-1]

    def count_over(self, threshold_ms: float) -> float:
        """Observations above `threshold_ms`. The straddling bucket is
        pro-rated log-uniformly, so the estimate moves smoothly as the
        threshold sweeps through a bucket instead of jumping by its whole
        population."""
        if not self.count or threshold_ms <= 0:
            return float(self.count)
        k = bucket_index(threshold_ms)
        over = float(sum(self.counts[k + 1:]))
        in_bucket = self.counts[k]
        if in_bucket:
            hi = BOUNDS[k]
            lo = BOUNDS[k - 1] if k > 0 else hi / GROWTH
            if threshold_ms >= hi:
                frac = 0.0
            elif threshold_ms <= lo:
                frac = 1.0
            else:
                frac = (math.log(hi) - math.log(threshold_ms)) / (
                    math.log(hi) - math.log(lo)
                )
            over += in_bucket * frac
        return over

    def fraction_over(self, threshold_ms: float) -> float:
        if not self.count:
            return 0.0
        return self.count_over(threshold_ms) / self.count

    def nonzero(self) -> Iterable[tuple[int, int]]:
        for i, c in enumerate(self.counts):
            if c:
                yield i, c

    # -------------------------------------------------------------- wire

    def to_dict(self) -> dict[str, Any]:
        """Sparse wire form (msgpack/JSON-safe: parallel index/count
        lists, no int keys)."""
        idx: list[int] = []
        cnt: list[int] = []
        for i, c in self.nonzero():
            idx.append(i)
            cnt.append(c)
        return {"i": idx, "c": cnt, "n": self.count, "s": round(self.sum_ms, 3)}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "PhaseHistogram":
        out = cls()
        idx = d.get("i") or []
        cnt = d.get("c") or []
        for i, c in zip(idx, cnt):
            i = int(i)
            if 0 <= i < NUM_BUCKETS:
                out.counts[i] += int(c)
        out.count = int(d.get("n") or sum(out.counts))
        out.sum_ms = float(d.get("s") or 0.0)
        # a malformed frame must not desync count from the buckets
        bucket_total = sum(out.counts)
        if out.count != bucket_total:
            out.count = bucket_total
        return out


class PhaseHistograms:
    """Per-phase histogram bundle recorded by an engine (or merged by the
    aggregator). Phases appear lazily on first observation so idle phases
    cost nothing on the wire."""

    __slots__ = ("phases",)

    def __init__(
        self, phases: Optional[dict[str, PhaseHistogram]] = None
    ) -> None:
        self.phases: dict[str, PhaseHistogram] = phases or {}

    def observe(self, phase: str, value_ms: float) -> None:
        h = self.phases.get(phase)
        if h is None:
            h = self.phases[phase] = PhaseHistogram()
        h.observe(value_ms)

    def get(self, phase: str) -> Optional[PhaseHistogram]:
        return self.phases.get(phase)

    def merge(self, other: "PhaseHistograms") -> None:
        for name, h in other.phases.items():
            mine = self.phases.get(name)
            if mine is None:
                self.phases[name] = h.copy()
            else:
                mine.merge(h)

    def copy(self) -> "PhaseHistograms":
        return PhaseHistograms(
            {name: h.copy() for name, h in self.phases.items()}
        )

    def total_count(self) -> int:
        return sum(h.count for h in self.phases.values())

    def to_dict(self) -> dict[str, Any]:
        return {name: h.to_dict() for name, h in self.phases.items()}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "PhaseHistograms":
        out = cls()
        if isinstance(d, dict):
            for name, hd in d.items():
                if isinstance(hd, dict):
                    out.phases[str(name)] = PhaseHistogram.from_dict(hd)
        return out
