"""SLO engine: burn-rate tracking over merged phase histograms, plus the
tail-sampling flight recorder for `DYN_TRACE=auto`.

The port's own copy of dynamo_tpu/telemetry/slo.py.

Three pieces:

  * ``SloConfig`` — per-model latency objectives, from env knobs
    (``DYN_SLO_TTFT_MS`` / ``DYN_SLO_ITL_MS`` / ``DYN_SLO_PERCENTILE``)
    or a small TOML file (``DYN_SLO_CONFIG``) with an optional
    ``[models."name"]`` section per model. Env beats TOML; a model
    section beats the file's defaults.
  * ``SloEngine`` — multi-window burn-rate computation (fast 1 m / slow
    30 m by default) over a stream of cumulative ``PhaseHistograms``
    snapshots, with an ok -> burning -> breached state machine whose
    transitions fire a callback (the ``slo-status`` fabric event). This
    is the signal the planner's SLA mode consumes.
  * ``FlightRecorder`` — with ``DYN_TRACE=auto`` spans are recorded for
    every request, but retention is decided at completion: keep the
    trace only if the request breached its SLO, errored, was migrated /
    deadline-killed, or hits a 1-in-N random sample
    (``DYN_TRACE_SAMPLE``). Retained exemplars land in a disk-budget-
    bounded ring under ``DYN_TRACE_DIR`` and are listed (with their
    breach reason) at ``GET /debug/traces``.

Burn-rate semantics (Google SRE workbook shape, simplified to two
windows): with target percentile P, the error budget is the fraction
``1 - P/100`` of requests allowed over the threshold. The burn rate of a
window is ``observed_bad_fraction / budget`` — 1.0 means the budget is
being consumed exactly as fast as it accrues. A signal is *burning* when
either window's burn is >= 1, and *breached* when the fast window burns
at >= ``breach_factor`` or both windows are >= 1 (sustained violation).
"""

from __future__ import annotations

import os
import random
import threading
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Callable, Optional

from dynamo_tpu_torch.runtime import clock as dclock
from dynamo_tpu_torch.telemetry.histogram import PhaseHistogram, PhaseHistograms

try:
    import tomllib  # Python 3.11+
except ImportError:  # Python 3.10: tomli is the same parser
    import tomli as tomllib  # type: ignore[no-redef]

# Namespace event subject for SLO state transitions (ok/burning/breached).
SLO_STATUS_SUBJECT = "slo-status"

_SEVERITY = {"ok": 0, "burning": 1, "breached": 2}


def _env_float(env, name: str) -> Optional[float]:
    raw = env.get(name)
    if raw is None or str(raw).strip() == "":
        return None
    try:
        return float(raw)
    except ValueError:
        return None


@dataclass
class SloConfig:
    """Latency objectives for one model (or the whole deployment)."""

    ttft_ms: Optional[float] = None
    itl_ms: Optional[float] = None
    percentile: float = 95.0
    fast_window_s: float = 60.0
    slow_window_s: float = 1800.0
    breach_factor: float = 6.0

    @property
    def enabled(self) -> bool:
        return self.ttft_ms is not None or self.itl_ms is not None

    @property
    def budget(self) -> float:
        """Allowed fraction of requests over threshold."""
        return max(1e-6, 1.0 - self.percentile / 100.0)

    def signals(self) -> dict[str, tuple[str, float]]:
        """signal name -> (histogram phase, threshold ms)."""
        out: dict[str, tuple[str, float]] = {}
        if self.ttft_ms is not None:
            out["ttft"] = ("ttft", self.ttft_ms)
        if self.itl_ms is not None:
            out["itl"] = ("inter_token", self.itl_ms)
        return out

    def to_dict(self) -> dict[str, Any]:
        return {
            "ttft_ms": self.ttft_ms,
            "itl_ms": self.itl_ms,
            "percentile": self.percentile,
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "breach_factor": self.breach_factor,
        }

    @classmethod
    def from_env(
        cls, model: Optional[str] = None, env: Optional[dict] = None
    ) -> "SloConfig":
        """Resolve config for `model`: TOML defaults < TOML model section
        < env vars (the operator's explicit knob always wins)."""
        env = env if env is not None else os.environ
        fields: dict[str, Any] = {}
        path = env.get("DYN_SLO_CONFIG")
        if path:
            try:
                with open(path, "rb") as f:
                    doc = tomllib.load(f)
            except (OSError, tomllib.TOMLDecodeError):
                doc = {}
            for k in (
                "ttft_ms", "itl_ms", "percentile",
                "fast_window_s", "slow_window_s", "breach_factor",
            ):
                if k in doc:
                    fields[k] = float(doc[k])
            section = (doc.get("models") or {}).get(model) if model else None
            if isinstance(section, dict):
                for k in (
                    "ttft_ms", "itl_ms", "percentile",
                    "fast_window_s", "slow_window_s", "breach_factor",
                ):
                    if k in section:
                        fields[k] = float(section[k])
        for env_name, k in (
            ("DYN_SLO_TTFT_MS", "ttft_ms"),
            ("DYN_SLO_ITL_MS", "itl_ms"),
            ("DYN_SLO_PERCENTILE", "percentile"),
            ("DYN_SLO_FAST_WINDOW_S", "fast_window_s"),
            ("DYN_SLO_SLOW_WINDOW_S", "slow_window_s"),
            ("DYN_SLO_BREACH_FACTOR", "breach_factor"),
        ):
            v = _env_float(env, env_name)
            if v is not None:
                fields[k] = v
        return cls(**fields)


class SloEngine:
    """Consumes cumulative PhaseHistograms snapshots, maintains windowed
    deltas, and drives the ok -> burning -> breached state machine."""

    def __init__(
        self,
        config: SloConfig,
        model: Optional[str] = None,
        on_transition: Optional[Callable[[str, str, dict], None]] = None,
        now_fn: Callable[[], float] = dclock.now,
    ) -> None:
        self.config = config
        self.model = model
        self.on_transition = on_transition
        self._now = now_fn
        # (t, cumulative snapshot) ring, pruned to the slow window plus
        # one older anchor so window-start baselines stay resolvable
        self._snaps: deque[tuple[float, PhaseHistograms]] = deque()
        self.state = "ok"
        self.transitions = 0
        self.breaches_total = 0
        self.last_status: dict[str, Any] = {"state": "ok", "signals": {}}

    # ------------------------------------------------------------- intake

    def observe(
        self, snapshot: PhaseHistograms, now: Optional[float] = None
    ) -> dict[str, Any]:
        """Record one cumulative snapshot and re-evaluate. Returns the
        status dict (also kept as `last_status`)."""
        t = self._now() if now is None else now
        self._snaps.append((t, snapshot.copy()))
        horizon = t - self.config.slow_window_s
        while len(self._snaps) >= 2 and self._snaps[1][0] <= horizon:
            self._snaps.popleft()
        return self.evaluate(now=t)

    def _window_delta(
        self, phase: str, window_s: float, now: float
    ) -> Optional[PhaseHistogram]:
        if not self._snaps:
            return None
        cur = self._snaps[-1][1].get(phase)
        if cur is None:
            return None
        cutoff = now - window_s
        base: Optional[PhaseHistogram] = None
        for t, snap in self._snaps:
            if t > cutoff:
                break
            base = snap.get(phase) or base
        if base is None:
            # engine younger than the window: everything counts
            return cur.copy()
        return cur.sub(base)

    # ------------------------------------------------------------ evaluate

    def _signal_eval(
        self, phase: str, threshold_ms: float, now: float
    ) -> dict[str, Any]:
        cfg = self.config
        out: dict[str, Any] = {"target_ms": threshold_ms}
        burns: dict[str, float] = {}
        for label, win in (
            ("fast", cfg.fast_window_s), ("slow", cfg.slow_window_s)
        ):
            delta = self._window_delta(phase, win, now)
            n = delta.count if delta is not None else 0
            bad = delta.count_over(threshold_ms) if delta is not None else 0.0
            burn = (bad / n / cfg.budget) if n else 0.0
            burns[label] = burn
            out[f"burn_{label}"] = round(burn, 4)
            out[f"window_{label}_n"] = n
            if delta is not None and n:
                out[f"window_{label}_p{int(cfg.percentile)}_ms"] = round(
                    delta.percentile(cfg.percentile), 3
                )
        fast, slow = burns["fast"], burns["slow"]
        if fast >= cfg.breach_factor or (fast >= 1.0 and slow >= 1.0):
            out["state"] = "breached"
        elif fast >= 1.0 or slow >= 1.0:
            out["state"] = "burning"
        else:
            out["state"] = "ok"
        return out

    def evaluate(self, now: Optional[float] = None) -> dict[str, Any]:
        t = self._now() if now is None else now
        signals = {
            name: self._signal_eval(phase, threshold, t)
            for name, (phase, threshold) in self.config.signals().items()
        }
        worst = "ok"
        for s in signals.values():
            if _SEVERITY[s["state"]] > _SEVERITY[worst]:
                worst = s["state"]
        status: dict[str, Any] = {
            "state": worst,
            "signals": signals,
            "config": self.config.to_dict(),
        }
        if self.model:
            status["model"] = self.model
        if worst != self.state:
            old, self.state = self.state, worst
            self.transitions += 1
            if worst == "breached":
                self.breaches_total += 1
            if self.on_transition is not None:
                try:
                    self.on_transition(old, worst, status)
                except Exception:  # noqa: BLE001 — telemetry must not raise
                    pass
        self.last_status = status
        return status


# ------------------------------------------------- flight recorder (auto)


def sample_n(env: Optional[dict] = None) -> int:
    """DYN_TRACE_SAMPLE: keep 1-in-N unremarkable traces (0 = none)."""
    env = env if env is not None else os.environ
    try:
        return max(0, int(env.get("DYN_TRACE_SAMPLE", "0") or 0))
    except ValueError:
        return 0


def retention_reason(
    cfg: Optional[SloConfig],
    error_code: Optional[str] = None,
    ttft_ms: Optional[float] = None,
    max_itl_ms: Optional[float] = None,
    migrated: bool = False,
    sample: Optional[int] = None,
    rng: Callable[[], float] = random.random,
) -> Optional[str]:
    """Why (if at all) this completed request's trace should be kept.
    Priority: hard failures > migration > SLO breach > random sample."""
    if error_code:
        return f"error:{error_code}"
    if migrated:
        return "migrated"
    if cfg is not None:
        if cfg.ttft_ms is not None and ttft_ms is not None and (
            ttft_ms > cfg.ttft_ms
        ):
            return "slo_ttft"
        if cfg.itl_ms is not None and max_itl_ms is not None and (
            max_itl_ms > cfg.itl_ms
        ):
            return "slo_itl"
    n = sample_n() if sample is None else sample
    if n > 0 and rng() < 1.0 / n:
        return "sampled"
    return None


class FlightRecorder:
    """Disk-budget-bounded ring of retained trace exemplars.

    Writes each kept trace as Chrome trace-event JSON under the trace
    dir (same file shape `DYN_TRACE_DIR` always used) and keeps an
    in-memory index with the breach reason for `GET /debug/traces`.
    When the directory's byte budget is exceeded, the oldest retained
    entries are evicted — a production window always holds the most
    recent evidence."""

    def __init__(
        self,
        out_dir: Optional[str] = None,
        max_bytes: Optional[int] = None,
    ) -> None:
        self.out_dir = out_dir if out_dir is not None else os.environ.get(
            "DYN_TRACE_DIR"
        )
        if max_bytes is None:
            try:
                mb = float(os.environ.get("DYN_TRACE_DIR_MAX_MB", "64") or 64)
            except ValueError:
                mb = 64.0
            max_bytes = int(mb * 1e6)
        self.max_bytes = max(1, max_bytes)
        self._entries: OrderedDict[str, dict[str, Any]] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.retained_total = 0
        self.dropped_total = 0
        self.evicted_total = 0

    def note_dropped(self) -> None:
        self.dropped_total += 1

    def retain(
        self, trace_id: Optional[str], request_id: Optional[str], reason: str
    ) -> Optional[str]:
        """Write the assembled trace to the ring; returns the path (None
        when no trace dir is configured or assembly fails)."""
        if not trace_id:
            return None
        from dynamo_tpu_torch.telemetry import trace as dtrace

        key = str(request_id or trace_id)
        doc = dtrace.chrome_trace(trace_id)
        doc["otherData"]["request_id"] = key
        doc["otherData"]["retention_reason"] = reason
        path = None
        size = 0
        if self.out_dir:
            try:
                import json

                os.makedirs(self.out_dir, exist_ok=True)
                name = f"trace-{key}.json".replace("/", "_").replace("..", "_")
                path = os.path.join(self.out_dir, name)
                with open(path, "w") as f:
                    json.dump(doc, f)
                size = os.path.getsize(path)
            except OSError:
                path = None
                size = 0
        entry = {
            "request_id": key,
            "trace_id": trace_id,
            "reason": reason,
            "path": path,
            "bytes": size,
            "unix_ms": int(dclock.wall() * 1e3),
        }
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.get("bytes", 0)
            self._entries[key] = entry
            self._bytes += size
            self.retained_total += 1
            while self._bytes > self.max_bytes and len(self._entries) > 1:
                _, victim = self._entries.popitem(last=False)
                self._bytes -= victim.get("bytes", 0)
                self.evicted_total += 1
                vp = victim.get("path")
                if vp:
                    try:
                        os.unlink(vp)
                    except OSError:
                        pass
        return path

    def entries(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._entries.values())

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "retained": self.retained_total,
                "dropped": self.dropped_total,
                "evicted": self.evicted_total,
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "dir": self.out_dir,
            }


_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def recorder() -> FlightRecorder:
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
    return _recorder


def reset_recorder(
    out_dir: Optional[str] = None, max_bytes: Optional[int] = None
) -> FlightRecorder:
    """Replace the process recorder (tests, re-configuration)."""
    global _recorder
    with _recorder_lock:
        _recorder = FlightRecorder(out_dir=out_dir, max_bytes=max_bytes)
    return _recorder
