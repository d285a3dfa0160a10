"""Request priority classes: the QoS vocabulary shared by every layer.

The port's own copy of dynamo_tpu/qos.py: the three classes, their
resolution at the edge, the brownout ladder's prefill cap
(``effective_chunk_budget``) and the drain-rate estimator behind a shed's
Retry-After. ``stamp_priority`` records a ``qos/priority`` decision when it
resolves the class itself (``telemetry/provenance.py``).

Three classes, strictly ordered:

  * ``interactive`` — latency-sensitive traffic (chat UIs, agents).
  * ``standard``    — the default for unlabelled traffic.
  * ``bulk``        — batch/offline work (evals, synthetic data).

Resolution precedence (highest wins):

  1. ``x-dyn-priority`` HTTP header
  2. request ``ext.priority`` / ``nvext.priority``
  3. ``DYN_PRIORITY_DEFAULT`` — either a bare class name applied to every
     model, or a ``model=class,...`` list with an optional bare fallback
     entry (e.g. ``DYN_PRIORITY_DEFAULT=evals-8b=bulk,standard``)
  4. ``standard``

The resolved class rides ``Context.metadata["priority"]`` (so it survives
every wire hop the Context header already crosses) and is mirrored into
``PreprocessedRequest.extra["priority"]`` for engines reached without a
Context-bearing transport. The port's engine orders its waiting queue by
it, picks preemption victims by it (the lowest class first), and its
brownout rungs shed by it (``telemetry/brownout.py``).
"""

from __future__ import annotations

import os
from collections import deque
from typing import Any, Callable, Optional

from dynamo_tpu_torch.runtime import clock as dclock

PRIORITY_CLASSES = ("interactive", "standard", "bulk")
DEFAULT_CLASS = "standard"

# lower rank = more important (sort key for queues)
CLASS_RANK = {"interactive": 0, "standard": 1, "bulk": 2}

# accepted spellings -> canonical class (ints mirror CLASS_RANK)
_ALIASES = {
    "interactive": "interactive",
    "high": "interactive",
    "0": "interactive",
    "standard": "standard",
    "normal": "standard",
    "default": "standard",
    "1": "standard",
    "bulk": "bulk",
    "batch": "bulk",
    "low": "bulk",
    "2": "bulk",
}


def normalize_priority(value: Any) -> Optional[str]:
    """Canonical class name for any accepted spelling; None if unknown."""
    if value is None:
        return None
    return _ALIASES.get(str(value).strip().lower())


def default_priority(model: Optional[str] = None, env: Optional[dict] = None) -> str:
    """Per-model default from DYN_PRIORITY_DEFAULT (see module doc)."""
    env = env if env is not None else os.environ
    raw = env.get("DYN_PRIORITY_DEFAULT", "")
    if not raw:
        return DEFAULT_CLASS
    fallback = DEFAULT_CLASS
    for entry in raw.split(","):
        entry = entry.strip()
        if not entry:
            continue
        if "=" in entry:
            m, _, cls = entry.partition("=")
            if model is not None and m.strip() == model:
                return normalize_priority(cls) or DEFAULT_CLASS
        else:
            fallback = normalize_priority(entry) or DEFAULT_CLASS
    return fallback


def resolve_priority(
    header: Any = None,
    ext_value: Any = None,
    model: Optional[str] = None,
    env: Optional[dict] = None,
) -> str:
    """Header beats the request ext block beats the env default."""
    return (
        normalize_priority(header)
        or normalize_priority(ext_value)
        or default_priority(model, env)
    )


def priority_of(ctx: Any = None, request: Any = None) -> str:
    """Read the already-resolved class off a Context / PreprocessedRequest
    (engines call this: resolution happened at the edge)."""
    from dynamo_tpu_torch.pipeline.context import decisions_of

    p = None
    if ctx is not None:
        p = normalize_priority(decisions_of(ctx).priority)
    if p is None and request is not None:
        p = normalize_priority((getattr(request, "extra", None) or {}).get("priority"))
    return p or DEFAULT_CLASS


def priority_source(header: Any = None, ext_value: Any = None) -> str:
    """Which precedence rung resolved the class."""
    if normalize_priority(header) is not None:
        return "header"
    if normalize_priority(ext_value) is not None:
        return "ext"
    return "default"


def rank_of(priority: Optional[str]) -> int:
    return CLASS_RANK.get(priority or DEFAULT_CLASS, CLASS_RANK[DEFAULT_CLASS])


def effective_chunk_budget(base: int, *, chunk_cap: bool, block_size: int) -> int:
    """The per-step prefill token budget after QoS degradation.

    ``base`` is the engine's configured chunk budget (tokens of prefill
    allowed to ride along each device step; 0 = chunking off). The brownout
    ladder's ``chunk_cap`` rung halves it (decode lanes get the chip back at
    the cost of new-prompt TTFT), never below one KV block, so an in-flight
    prefill keeps making progress. The half is rounded down to the KV block
    grid, where the engine's chunks must start: the reference's value
    whenever half the budget is on the grid (the default 2 x 512 at any
    power-of-two block size), a budget on the grid where the reference's
    would not be. Engines latch the result once per step boundary."""
    if not base:
        return 0
    if chunk_cap:
        return max(block_size, (base // 2) // block_size * block_size)
    return base


def stamp_priority(pre: Any, ctx: Any) -> str:
    """Mirror the Context's resolved class onto the wire request (and
    resolve from the request ext stamp / env default when the Context
    carries none). Returns the class."""
    from dynamo_tpu_torch.pipeline.context import decisions_of
    from dynamo_tpu_torch.telemetry import provenance as dprov

    carrier = decisions_of(ctx) if ctx is not None else None
    p = None
    if carrier is not None:
        p = normalize_priority(carrier.priority)
    if p is None:
        ext_value = (pre.extra or {}).get("priority")
        p = resolve_priority(
            ext_value=ext_value,
            model=getattr(pre, "model", None) or None,
        )
        if carrier is not None:
            carrier.priority = p
        if dprov.enabled():
            # resolved here (no edge handler stamped the Context): record
            # the precedence rung that won
            dprov.record("qos", "priority", p, reason=priority_source(ext_value=ext_value), ctx=ctx)
    pre.extra["priority"] = p
    return p


class DrainRateEstimator:
    """Observed completion (queue-drain) rate over a sliding window.

    Feeds a shed's ``Retry-After`` hint: how long the backlog above the
    watermark takes to drain at the rate requests are *actually* finishing.
    ``note()`` on every completion; ``retry_after_s`` falls back to the
    caller's constant when the window holds no signal (cold start, total
    stall)."""

    def __init__(
        self,
        window_s: float = 30.0,
        max_events: int = 512,
        now_fn: Callable[[], float] = dclock.now,
    ) -> None:
        self.window_s = window_s
        self._events: deque[float] = deque(maxlen=max_events)
        self._now = now_fn

    def note(self, now: Optional[float] = None) -> None:
        self._events.append(self._now() if now is None else now)

    def rate(self, now: Optional[float] = None) -> Optional[float]:
        """Completions per second over the window; None = no signal."""
        now = self._now() if now is None else now
        cutoff = now - self.window_s
        while self._events and self._events[0] < cutoff:
            self._events.popleft()
        if len(self._events) < 2:
            return None
        span = now - self._events[0]
        if span <= 0:
            return None
        return len(self._events) / span

    def retry_after_s(
        self,
        excess: int,
        fallback_s: float,
        now: Optional[float] = None,
        lo: float = 0.2,
        hi: float = 60.0,
    ) -> float:
        """Seconds until `excess` requests above the watermark drain."""
        r = self.rate(now)
        if not r:
            return fallback_s
        return min(hi, max(lo, excess / r))
