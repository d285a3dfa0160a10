"""Shared control-plane retry policy: exponential backoff, full jitter,

The port's own copy of dynamo_tpu/runtime/backoff.py.
optional budget.

Before this module every retry loop hand-rolled its own sleep math
(migration replay used ``base * 2^n * (0.5 + random())``, the fabric
failover hunted on a flat 0.25 s, the prefill dequeue retried on a flat
0.5 s). One policy object makes them uniform and testable:

  * **exponential**: attempt n waits up to ``base * factor^(n-1)``,
    capped at ``cap_s``;
  * **full jitter** (AWS-style): the actual delay is uniform in
    ``[0, ceiling]`` — decorrelates a thundering herd better than the
    ``0.5 + rand/2`` half-jitter it replaces;
  * **budget**: an optional wall-clock budget and/or attempt cap after
    which `next_delay()` returns None and the caller gives up.

Deterministic tests inject ``rng`` (any callable returning [0, 1)); the
wall-clock budget reads the process clock (`runtime/clock.py`), so a
simulated fleet exhausts retry budgets in virtual time."""

from __future__ import annotations

import asyncio
import random
from typing import Callable, Optional

from dynamo_tpu_torch.runtime import clock as dclock


class Backoff:
    """Stateful retry pacer. `reset()` on success; `next_delay()` per
    failure (None = budget/attempts exhausted); `sleep()` combines both
    decisions for the common await-and-retry shape."""

    def __init__(
        self,
        base_s: float = 0.05,
        factor: float = 2.0,
        cap_s: float = 2.0,
        budget_s: Optional[float] = None,
        max_attempts: Optional[int] = None,
        rng: Optional[Callable[[], float]] = None,
        clock: Callable[[], float] = dclock.now,
    ) -> None:
        self.base_s = base_s
        self.factor = factor
        self.cap_s = cap_s
        self.budget_s = budget_s
        self.max_attempts = max_attempts
        self._rng = rng if rng is not None else random.random
        self._clock = clock
        self.attempts = 0
        self._t0: Optional[float] = None

    def reset(self) -> None:
        """Call on success: the next failure starts the ladder over."""
        self.attempts = 0
        self._t0 = None

    def ceiling(self, attempt: int) -> float:
        """The pre-jitter ceiling for the given 1-based attempt."""
        return min(self.cap_s, self.base_s * self.factor ** max(0, attempt - 1))

    def next_delay(self) -> Optional[float]:
        """Record one failure; return how long to wait before retrying,
        or None when the budget/attempt cap is exhausted."""
        if self._t0 is None:
            self._t0 = self._clock()
        self.attempts += 1
        if self.max_attempts is not None and self.attempts > self.max_attempts:
            return None
        if (
            self.budget_s is not None
            and self._clock() - self._t0 >= self.budget_s
        ):
            return None
        # full jitter: uniform in [0, ceiling]
        return self.ceiling(self.attempts) * self._rng()

    async def sleep(self) -> bool:
        """Await the next delay; False when the budget is exhausted."""
        delay = self.next_delay()
        if delay is None:
            return False
        if delay > 0:
            await asyncio.sleep(delay)
        return True


def full_jitter_delay(
    attempt: int,
    base_s: float,
    cap_s: float = 2.0,
    factor: float = 2.0,
    rng: Optional[Callable[[], float]] = None,
) -> float:
    """Stateless helper for call sites that track attempts themselves
    (e.g. the migration replay's progress-reset failure counter)."""
    r = rng if rng is not None else random.random
    return min(cap_s, base_s * factor ** max(0, attempt - 1)) * r()
