"""SLO-driven brownout controller: a stepped degradation ladder.

The port's own copy of dynamo_tpu/telemetry/brownout.py; each transition is
a ``brownout/level`` decision record (``telemetry/provenance.py``).

Consumes the SLO plane — ``slo-status`` fabric events published by
the metrics component / frontend SLO engines, and (on a worker) the
engine's own local burn rates — and converts sustained burn into explicit,
reversible degradation instead of letting every request degrade equally:

    level 0  ok            — nothing disabled
    level 1  shed_bulk     — bulk-class requests refused at admission
    level 2  spec_off      — speculative decoding paused (frees the verify
                             premium + drafter host time for real tokens)
    level 3  chunk_cap     — prefill-chunk budget per engine step halved
                             (decode lanes get the chip back; TTFT of new
                             prompts is sacrificed for ITL of admitted ones)
    level 4  shed_standard — standard-class requests refused too;
                             interactive-only service

Stepping is dwell-timed in both directions so a flapping burn signal
cannot oscillate the ladder: a ``burning``/``breached`` observation steps
UP one rung at most every ``step_up_s`` (breached skips straight past the
dwell on the first observation), and recovery steps DOWN one rung only
after ``step_down_s`` of continuous ``ok``. Every transition is logged,
counted, surfaced at ``/debug/slo`` and (when wired) published on the
``brownout-status`` event subject.

The controller is policy only — hosts register the mechanism by reading
``actions()`` after each ``observe()`` (the frontend applies shed classes
to its AdmissionController; workers call ``engine.apply_brownout``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Optional

from dynamo_tpu_torch.runtime import clock as dclock
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.telemetry import provenance as dprov

logger = get_logger("dynamo_tpu_torch.brownout")

# Namespace event subject for ladder transitions (next to slo-status).
BROWNOUT_SUBJECT = "brownout-status"

LADDER = ("ok", "shed_bulk", "spec_off", "chunk_cap", "shed_standard")
MAX_LEVEL = len(LADDER) - 1

_SEVERITY = {"ok": 0, "burning": 1, "breached": 2}


def shed_classes_for(level: int) -> frozenset[str]:
    out = set()
    if level >= 1:
        out.add("bulk")
    if level >= 4:
        out.add("standard")
    return frozenset(out)


def chunk_capped(level: int) -> bool:
    """True when the ladder asks engines to halve the shared per-step
    prefill token budget (``qos.effective_chunk_budget`` applies it; the
    engine latches the result once per step boundary)."""
    return level >= LADDER.index("chunk_cap")


@dataclass
class BrownoutConfig:
    enabled: bool = True
    step_up_s: float = 2.0
    step_down_s: float = 6.0
    max_level: int = MAX_LEVEL

    @classmethod
    def from_env(cls, env: Optional[dict] = None) -> "BrownoutConfig":
        env = env if env is not None else os.environ
        def f(name: str, d: float) -> float:
            try:
                return float(env.get(name, d) or d)
            except ValueError:
                return d
        return cls(
            enabled=str(env.get("DYN_BROWNOUT", "1")).lower()
            not in ("0", "false", "no", "off"),
            step_up_s=f("DYN_BROWNOUT_STEP_UP_S", 2.0),
            step_down_s=f("DYN_BROWNOUT_STEP_DOWN_S", 6.0),
            max_level=min(MAX_LEVEL, int(f("DYN_BROWNOUT_MAX_LEVEL", MAX_LEVEL))),
        )


class BrownoutController:
    """ok -> shed_bulk -> spec_off -> chunk_cap -> shed_standard and back.

    ``observe(state)`` with state in {"ok", "burning", "breached"} (the SLO
    engine's vocabulary); returns the (possibly new) level."""

    def __init__(
        self,
        config: Optional[BrownoutConfig] = None,
        on_change: Optional[Callable[[int, int, str], None]] = None,
        now_fn: Callable[[], float] = dclock.now,
        scope: str = "",
    ) -> None:
        self.config = config or BrownoutConfig.from_env()
        self.on_change = on_change
        self._now = now_fn
        self.scope = scope
        self.level = 0
        self.steps_up = 0
        self.steps_down = 0
        self._last_change: Optional[float] = None
        self._ok_since: Optional[float] = None
        self.last_state = "ok"

    # ------------------------------------------------------------- intake

    def observe(self, state: str, now: Optional[float] = None) -> int:
        """Feed one SLO state observation (local tick or slo-status event).
        Hosts feeding several sources should pre-reduce to the WORST
        current state — alternating good/bad observations here would fight
        the dwell timers."""
        if not self.config.enabled:
            return self.level
        t = self._now() if now is None else now
        sev = _SEVERITY.get(state, 0)
        self.last_state = state if state in _SEVERITY else "ok"
        if sev >= 1:
            self._ok_since = None
            dwell_ok = (
                self._last_change is None
                or t - self._last_change >= self.config.step_up_s
                # a fresh breach jumps the dwell: the fast window is already
                # burning at >= breach_factor, waiting is pure SLO damage
                or (sev >= 2 and self.level == 0)
            )
            if self.level < self.config.max_level and dwell_ok:
                self._set(self.level + 1, t)
        else:
            if self._ok_since is None:
                self._ok_since = t
            if (
                self.level > 0
                and t - self._ok_since >= self.config.step_down_s
            ):
                self._set(self.level - 1, t)
                self._ok_since = t  # one rung per step_down_s of clean ok
        return self.level

    def _set(self, level: int, t: float) -> None:
        old, self.level = self.level, level
        self._last_change = t
        if level > old:
            self.steps_up += 1
        else:
            self.steps_down += 1
        logger.warning(
            "brownout%s: level %d (%s) -> %d (%s)",
            f" [{self.scope}]" if self.scope else "",
            old, LADDER[old], level, LADDER[level],
        )
        if dprov.enabled():
            dprov.record("brownout", "level", LADDER[level],
                         reason="step_up" if level > old else "step_down",
                         epoch=self.scope or "frontend", from_level=old, to_level=level,
                         slo_state=self.last_state)
        if self.on_change is not None:
            try:
                self.on_change(old, level, LADDER[level])
            except Exception:  # noqa: BLE001 — policy must not crash hosts
                logger.exception("brownout on_change callback failed")

    # ------------------------------------------------------------ surface

    @property
    def rung(self) -> str:
        return LADDER[self.level]

    @property
    def transitions(self) -> int:
        return self.steps_up + self.steps_down

    def actions(self) -> dict[str, Any]:
        """The mechanism this level asks hosts to apply."""
        return {
            "shed_classes": sorted(shed_classes_for(self.level)),
            "spec_off": self.level >= 2,
            "chunk_cap": chunk_capped(self.level),
        }

    def status(self) -> dict[str, Any]:
        return {
            "enabled": self.config.enabled,
            "level": self.level,
            "rung": self.rung,
            "ladder": list(LADDER),
            "last_state": self.last_state,
            "steps_up": self.steps_up,
            "steps_down": self.steps_down,
            **self.actions(),
        }
