"""The goodput ledger and the prebake manifest.

The port's own copy of dynamo_tpu/telemetry/goodput.py (stdlib only), with
the same wire dict, merge and ``DYN_GOODPUT`` switch, so a router or a
metrics component of either package merges a worker of either. Every
engine dispatch (a "device step") is folded into fixed-log-bucket
histograms keyed by its dispatch label, beside lane occupancy, prefill /
decode tokens through the device, the bubble between dispatches, a
**token-waste taxonomy** of counters, the achieved MFU / HBM-bytes-per-
token gauges (``engine/torch_engine/perf_model.py`` over the real batch)
and **recompile forensics**: each label's first-dispatch seconds and a
counter of unexpected recompiles after it.

Waste taxonomy (the ``cause`` label of ``dyn_llm_tokens_wasted_total``):

  * ``spec_rejected``     -- draft tokens the verify pass rejected
  * ``preempt_replay``    -- KV work (prompt + generated) a preemption
                            discarded, recomputed on re-admission
  * ``migration_replay``  -- already-streamed tokens re-prefilled when a
                            migrated request resumes
  * ``deadline_partial``  -- tokens of a request whose deadline expired
                            mid-generation
  * ``cancelled_partial`` -- tokens for a consumer that went away
                            (engine-side hedge losers included)
  * ``hedge_loser``       -- tokens the losing hedge stream emitted
                            (attributed by the frontend, where hedging is)

Recompile causes (``dyn_llm_recompiles_total{label,cause}``):
``shape_miss`` (a label paid a one-off compile after its first dispatch)
and ``prebake_miss`` (the same, on a label the prebake manifest covers:
the kernel cache no longer matches the serve shapes). The reference infers
a recompile from a dispatch far off its label's EMA (``RecompileDetector``,
kept here and held to the reference's); ``TorchEngine`` records one from
the runner's exact signal instead: a dispatch after the label's first
whose ``warm_events`` moved (a CUDA graph capture or a kernel-library
load).

Everything follows the ``telemetry/histogram.py`` contract: fixed grids,
merges by plain addition (associative and commutative), sparse JSON- and
msgpack-safe wire forms, and a ``record_step`` cheap enough to stay on in
the engine's hot path. ``DYN_GOODPUT=0`` turns recording off.

The prebake manifest (``PREBAKE_MANIFEST``, ``load_prebaked_labels``,
``write_prebake_manifest``): ``tools/prebake.py`` drops it into the
kernel-cache directory in the reference's format, so either package's
reader reads either's file.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Optional

from dynamo_tpu_torch.telemetry.histogram import (
    PhaseHistogram,
    PhaseHistograms,
    bucket_index,
)

logger = logging.getLogger("dynamo_tpu_torch.telemetry.goodput")

# Fixed taxonomy — exporters iterate this so dashboards get stable,
# zero-valued series instead of appearing-on-first-waste label churn.
WASTE_CAUSES = (
    "spec_rejected",
    "preempt_replay",
    "migration_replay",
    "deadline_partial",
    "cancelled_partial",
    "hedge_loser",
)

RECOMPILE_CAUSES = ("shape_miss", "prebake_miss")

# Bound on dict-keyed state: dispatch labels are a small closed set, but
# a bug (label built from a shape) must never grow the ledger unbounded.
MAX_LABELS = 32


def enabled_from_env() -> bool:
    return os.environ.get("DYN_GOODPUT", "1") not in ("0", "false", "off")


class GoodputStats:
    """Mergeable goodput snapshot (the wire/aggregate half).

    Merging follows the phase-histogram contract: counters add, bucket
    grids add, compile times take the max (worst worker), and the
    MFU/HBM gauges ship as (sum, n) pairs so fleet averaging is
    associative no matter the merge order.
    """

    __slots__ = (
        "step_hists",
        "steps_total",
        "bubble_s_total",
        "busy_s_total",
        "phase_gap_s_total",
        "mixed_steps",
        "mixed_prefill_tokens",
        "mixed_decode_tokens",
        "lane_steps",
        "lane_capacity_steps",
        "prefill_tokens",
        "decode_tokens",
        "waste_by_cause",
        "recompiles",
        "compile_s_by_label",
        "mfu_sum",
        "hbm_sum",
        "gauge_n",
    )

    def __init__(self) -> None:
        # per-dispatch-label step-duration distributions (ms grid)
        self.step_hists = PhaseHistograms()
        self.steps_total = 0
        # idle gap between the end of one dispatch and the start of the
        # next while work was in flight — the "phase bubble" the unified
        # mixed-step ROADMAP item wants to close
        self.bubble_s_total = 0.0
        # device-attributed dispatch seconds (denominator for the bubble
        # fraction: wall ~ busy + bubble while work is in flight)
        self.busy_s_total = 0.0
        # the subset of bubble time accrued at PHASE TRANSITIONS (a
        # prefill-family dispatch followed by a decode-family one or vice
        # versa). Mixed steps are one phase by construction, so a unified
        # stepper drives this to ~0 while bubble_s_total keeps counting
        # ordinary inter-step host gaps.
        self.phase_gap_s_total = 0.0
        # mixed-step occupancy split: how many device steps carried both
        # phases, and how many prefill tokens / decode lanes rode them
        self.mixed_steps = 0
        self.mixed_prefill_tokens = 0
        self.mixed_decode_tokens = 0
        # occupancy: sum of lanes occupied / lane capacity per decode-
        # family step (occupancy = lane_steps / lane_capacity_steps)
        self.lane_steps = 0
        self.lane_capacity_steps = 0
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.waste_by_cause: dict[str, int] = {}
        # "label|cause" -> count of unexpected post-warmup recompiles
        self.recompiles: dict[str, int] = {}
        # label -> first-dispatch (compile-inclusive) seconds
        self.compile_s_by_label: dict[str, float] = {}
        # achieved-efficiency gauges as associative (sum, n) pairs; a
        # single worker publishes n=1 with its latest values
        self.mfu_sum = 0.0
        self.hbm_sum = 0.0
        self.gauge_n = 0

    # ------------------------------------------------------------- query

    @property
    def occupancy(self) -> float:
        if not self.lane_capacity_steps:
            return 0.0
        return self.lane_steps / self.lane_capacity_steps

    @property
    def phase_bubble_fraction(self) -> float:
        """Share of in-flight wall time lost at phase-transition
        boundaries. The headline number the mixed stepper collapses."""
        total = self.busy_s_total + self.bubble_s_total
        if total <= 0:
            return 0.0
        return self.phase_gap_s_total / total

    @property
    def mfu_achieved(self) -> float:
        return self.mfu_sum / self.gauge_n if self.gauge_n else 0.0

    @property
    def hbm_bytes_per_token(self) -> float:
        return self.hbm_sum / self.gauge_n if self.gauge_n else 0.0

    def wasted_total(self) -> int:
        return sum(self.waste_by_cause.values())

    def recompiles_total(self) -> int:
        return sum(self.recompiles.values())

    def total_events(self) -> int:
        """Nonzero iff this snapshot carries anything worth shipping."""
        return (
            self.steps_total
            + self.wasted_total()
            + self.recompiles_total()
            + len(self.compile_s_by_label)
        )

    # ------------------------------------------------------------- merge

    def merge(self, other: "GoodputStats") -> None:
        self.step_hists.merge(other.step_hists)
        self.steps_total += other.steps_total
        self.bubble_s_total += other.bubble_s_total
        self.busy_s_total += other.busy_s_total
        self.phase_gap_s_total += other.phase_gap_s_total
        self.mixed_steps += other.mixed_steps
        self.mixed_prefill_tokens += other.mixed_prefill_tokens
        self.mixed_decode_tokens += other.mixed_decode_tokens
        self.lane_steps += other.lane_steps
        self.lane_capacity_steps += other.lane_capacity_steps
        self.prefill_tokens += other.prefill_tokens
        self.decode_tokens += other.decode_tokens
        for k, v in other.waste_by_cause.items():
            self.waste_by_cause[k] = self.waste_by_cause.get(k, 0) + v
        for k, v in other.recompiles.items():
            self.recompiles[k] = self.recompiles.get(k, 0) + v
        for k, v in other.compile_s_by_label.items():
            if len(self.compile_s_by_label) < MAX_LABELS or (
                k in self.compile_s_by_label
            ):
                self.compile_s_by_label[k] = max(
                    self.compile_s_by_label.get(k, 0.0), v
                )
        self.mfu_sum += other.mfu_sum
        self.hbm_sum += other.hbm_sum
        self.gauge_n += other.gauge_n

    def copy(self) -> "GoodputStats":
        out = GoodputStats()
        out.merge(self)
        return out

    # -------------------------------------------------------------- wire

    def to_dict(self) -> dict[str, Any]:
        return {
            "sh": self.step_hists.to_dict(),
            "st": self.steps_total,
            "bub": round(self.bubble_s_total, 6),
            "bus": round(self.busy_s_total, 6),
            "pg": round(self.phase_gap_s_total, 6),
            "ms": self.mixed_steps,
            "mpt": self.mixed_prefill_tokens,
            "mdt": self.mixed_decode_tokens,
            "ls": self.lane_steps,
            "lc": self.lane_capacity_steps,
            "pt": self.prefill_tokens,
            "dt": self.decode_tokens,
            "w": dict(self.waste_by_cause),
            "rc": dict(self.recompiles),
            "cs": {k: round(v, 4) for k, v in self.compile_s_by_label.items()},
            "mfu": self.mfu_sum,
            "hbm": self.hbm_sum,
            "n": self.gauge_n,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "GoodputStats":
        out = cls()
        if not isinstance(d, dict):
            return out
        out.step_hists = PhaseHistograms.from_dict(d.get("sh") or {})
        out.steps_total = int(d.get("st") or 0)
        out.bubble_s_total = float(d.get("bub") or 0.0)
        out.busy_s_total = float(d.get("bus") or 0.0)
        out.phase_gap_s_total = float(d.get("pg") or 0.0)
        out.mixed_steps = int(d.get("ms") or 0)
        out.mixed_prefill_tokens = int(d.get("mpt") or 0)
        out.mixed_decode_tokens = int(d.get("mdt") or 0)
        out.lane_steps = int(d.get("ls") or 0)
        out.lane_capacity_steps = int(d.get("lc") or 0)
        out.prefill_tokens = int(d.get("pt") or 0)
        out.decode_tokens = int(d.get("dt") or 0)
        for k, v in (d.get("w") or {}).items():
            out.waste_by_cause[str(k)] = int(v)
        for k, v in (d.get("rc") or {}).items():
            out.recompiles[str(k)] = int(v)
        for k, v in (d.get("cs") or {}).items():
            if len(out.compile_s_by_label) < MAX_LABELS:
                out.compile_s_by_label[str(k)] = float(v)
        out.mfu_sum = float(d.get("mfu") or 0.0)
        out.hbm_sum = float(d.get("hbm") or 0.0)
        out.gauge_n = int(d.get("n") or 0)
        return out

    # ------------------------------------------------------------- debug

    def summary(self) -> dict[str, Any]:
        """Human-oriented JSON for `GET /debug/goodput`."""
        steps: dict[str, Any] = {}
        for label, h in self.step_hists.phases.items():
            steps[label] = {
                "count": h.count,
                "mean_ms": round(h.mean_ms, 3),
                "p50_ms": round(h.percentile(50), 3),
                "p99_ms": round(h.percentile(99), 3),
            }
        return {
            "steps_total": self.steps_total,
            "steps_by_label": steps,
            "occupancy": round(self.occupancy, 4),
            "phase_bubble_s": round(self.bubble_s_total, 4),
            "busy_s": round(self.busy_s_total, 4),
            "phase_gap_s": round(self.phase_gap_s_total, 4),
            "phase_bubble_fraction": round(self.phase_bubble_fraction, 5),
            "mixed_steps": self.mixed_steps,
            "mixed_prefill_tokens": self.mixed_prefill_tokens,
            "mixed_decode_tokens": self.mixed_decode_tokens,
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens": self.decode_tokens,
            "tokens_wasted": {
                c: self.waste_by_cause.get(c, 0) for c in WASTE_CAUSES
            },
            "tokens_wasted_total": self.wasted_total(),
            "recompiles": dict(self.recompiles),
            "compile_s_by_label": {
                k: round(v, 3) for k, v in self.compile_s_by_label.items()
            },
            "mfu_achieved": round(self.mfu_achieved, 5),
            "hbm_bytes_per_token": round(self.hbm_bytes_per_token, 1),
        }


class GoodputLedger(GoodputStats):
    """The recording half, embedded in a live engine.

    Adds the dispatch-edge state (`_last_end` for bubble accounting) and
    the record_* API the engines call. All recorders no-op when
    `DYN_GOODPUT=0`, and the ledger is bounded by construction: fixed
    histogram grids, the closed waste/recompile taxonomies, and a
    MAX_LABELS cap on every label-keyed dict.
    """

    __slots__ = ("enabled", "_last_end", "_last_phase")

    def __init__(self, enabled: Optional[bool] = None) -> None:
        super().__init__()
        self.enabled = enabled_from_env() if enabled is None else enabled
        self._last_end: Optional[float] = None
        self._last_phase: Optional[str] = None

    def record_step(
        self,
        label: str,
        elapsed_s: float,
        *,
        lanes: int = 0,
        capacity: int = 0,
        prefill_tokens: int = 0,
        t_start: Optional[float] = None,
    ) -> None:
        """One device dispatch completed. `t_start` (time.monotonic) feeds
        phase-bubble accounting: the gap since the previous dispatch's end
        is device idle time between phases."""
        if not self.enabled:
            return
        self.steps_total += 1
        self.busy_s_total += elapsed_s
        # inlined step_hists.observe(): every dispatch lands here, and
        # the two method hops + the per-call MAX_LABELS len() probe cost
        # more than the bucket math itself (the cap check only needs to
        # run for a label we haven't seen)
        phases = self.step_hists.phases
        h = phases.get(label)
        if h is None and len(phases) < MAX_LABELS:
            h = phases[label] = PhaseHistogram()
        if h is not None:
            ms = elapsed_s * 1e3 if elapsed_s > 0 else 0.0
            h.counts[bucket_index(ms)] += 1
            h.count += 1
            h.sum_ms += ms
        if capacity > 0:
            self.lane_steps += lanes
            self.lane_capacity_steps += capacity
        if prefill_tokens > 0:
            self.prefill_tokens += prefill_tokens
        # inline fast path of step_phase(): one dict probe per call (the
        # function-call fallback only runs once per distinct label)
        phase = _PHASE_CACHE.get(label)
        if phase is None:
            phase = step_phase(label)
        if phase == "mixed":
            self.mixed_steps += 1
            self.mixed_prefill_tokens += prefill_tokens
            self.mixed_decode_tokens += lanes
        if t_start is not None:
            if self._last_end is not None and t_start > self._last_end:
                gap = t_start - self._last_end
                self.bubble_s_total += gap
                # only a gap at a boundary CROSSING the prefill family is
                # the phase bubble: a pure-prefill program carries no
                # decode lane, so every lane sits serialized behind it.
                # decode->decode, mixed->mixed AND decode<->mixed
                # boundaries are ordinary host bookkeeping — the decode
                # lanes ride inside both step kinds, nothing is waiting
                if (
                    self._last_phase is not None
                    and phase != self._last_phase
                    and "prefill" in (phase, self._last_phase)
                ):
                    self.phase_gap_s_total += gap
            self._last_end = t_start + elapsed_s
            self._last_phase = phase

    def record_decode_tokens(self, n: int = 1) -> None:
        if self.enabled:
            self.decode_tokens += n

    def record_waste(self, cause: str, tokens: int) -> None:
        if not self.enabled or tokens <= 0:
            return
        self.waste_by_cause[cause] = self.waste_by_cause.get(cause, 0) + int(
            tokens
        )

    def record_compile(self, label: str, seconds: float) -> None:
        """A label's first dispatch (includes its one-off costs: a graph
        capture, kernel-library loads)."""
        if not self.enabled:
            return
        if len(self.compile_s_by_label) < MAX_LABELS or (
            label in self.compile_s_by_label
        ):
            self.compile_s_by_label[label] = max(
                self.compile_s_by_label.get(label, 0.0), float(seconds)
            )

    def record_recompile(
        self, label: str, cause: str, shape: Optional[str] = None
    ) -> None:
        """An *unexpected* post-warmup recompile (shape-bucket miss, or
        cache drift on a prebaked label). Always WARNs naming the
        offending shape — a recompile mid-serving is an SLO incident."""
        if not self.enabled:
            return
        key = f"{label}|{cause}"
        if len(self.recompiles) < MAX_LABELS or key in self.recompiles:
            self.recompiles[key] = self.recompiles.get(key, 0) + 1
        logger.warning(
            "unexpected recompile of %s (%s): offending shape %s — "
            "a serve-time graph capture or kernel load stalls every lane; "
            "widen the shape buckets or re-run tools/prebake.py",
            label,
            cause,
            shape or "unknown",
        )

    def set_perf_gauges(self, mfu: float, hbm_bytes_per_token: float) -> None:
        """Latest achieved-efficiency point (real dispatch shapes through
        perf_model). Stored as an n=1 sample so fleet merges average."""
        if not self.enabled:
            return
        self.mfu_sum = float(mfu)
        self.hbm_sum = float(hbm_bytes_per_token)
        self.gauge_n = 1

    def mark_idle(self) -> None:
        """Nothing in flight: the next dispatch's gap is idleness, not a
        phase bubble. Resets the bubble baseline."""
        self._last_end = None
        self._last_phase = None


class RecompileDetector:
    """The reference's warm-label recompile heuristic
    (``DYN_RECOMPILE_MIN_S`` 0.2, ``DYN_RECOMPILE_FACTOR`` 10): after a
    label's first dispatch, one taking ``factor`` x its EMA *and* over an
    absolute floor is a recompile. ``TorchEngine`` reads the runner's
    ``warm_events`` instead (module docstring); the class serves tools
    and engines without that signal.
    """

    def __init__(
        self,
        min_s: Optional[float] = None,
        factor: Optional[float] = None,
    ) -> None:
        self.min_s = (
            float(os.environ.get("DYN_RECOMPILE_MIN_S", "0.2"))
            if min_s is None
            else min_s
        )
        self.factor = (
            float(os.environ.get("DYN_RECOMPILE_FACTOR", "10"))
            if factor is None
            else factor
        )

    def is_recompile(self, elapsed_s: float, ema_s: float) -> bool:
        return elapsed_s >= self.min_s and elapsed_s >= self.factor * ema_s


# label -> phase memo: record_step runs on EVERY dispatch and the label
# set is tiny and closed, so the string work happens once per label
_PHASE_CACHE: dict[str, str] = {}


def step_phase(label: str) -> str:
    """Phase family of a dispatch label for bubble attribution: every
    prefill-shaped program is "prefill", every token-producing one is
    "decode", and a unified step is its own "mixed" phase (it contains
    both, so it never forms a phase boundary with itself)."""
    phase = _PHASE_CACHE.get(label)
    if phase is None:
        base = normalize_label(label)
        if base.startswith("prefill"):
            phase = "prefill"
        elif base in ("decode", "decode_multi", "spec_verify"):
            phase = "decode"
        elif base == "mixed_step":
            phase = "mixed"
        else:
            phase = base
        if len(_PHASE_CACHE) < 4096:  # unbounded labels must not leak
            _PHASE_CACHE[label] = phase
    return phase


PREBAKE_MANIFEST = "prebake_manifest.json"


def normalize_label(label: str) -> str:
    """Map a prebake program label to its dispatch label: prebake bakes
    per-shape programs (``prefill@2048``, ``decode_multi@H4``,
    ``decode_eos``) while the engine dispatches under the base label."""
    base = label.split("@", 1)[0]
    return "decode" if base == "decode_eos" else base


def load_prebaked_labels(cache_dir: Optional[str]) -> frozenset[str]:
    """Dispatch labels covered by an earlier prebake run (read from the
    manifest it dropped in the cache directory); empty when there is
    none."""
    if not cache_dir:
        return frozenset()
    path = os.path.join(cache_dir, PREBAKE_MANIFEST)
    try:
        with open(path) as f:
            doc = json.load(f)
        labels = doc.get("labels") or []
        return frozenset(normalize_label(str(x)) for x in labels)
    except (OSError, ValueError):
        return frozenset()


def write_prebake_manifest(
    cache_dir: Optional[str], programs: list, extra: Optional[dict] = None
) -> Optional[str]:
    """Drop the manifest ``load_prebaked_labels`` reads: the labels, each
    program's (label, seconds) and the time. ``extra`` adds keys of the
    port's own (the kernel libraries, the captured graph keys); the
    reference's reader ignores them. Returns the path, or None when the
    directory is missing or the write fails."""
    if not cache_dir or not os.path.isdir(cache_dir):
        return None
    path = os.path.join(cache_dir, PREBAKE_MANIFEST)
    doc = {
        "labels": sorted({normalize_label(lbl) for lbl, _ in programs}),
        "programs": [[lbl, s] for lbl, s in programs],
        "baked_at": time.time(),
        **(extra or {}),
    }
    try:
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
    except OSError:
        return None
    return path
