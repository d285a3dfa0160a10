"""Process-wide swappable clock: the seam deterministic simulation needs.

The port's own copy of dynamo_tpu/runtime/clock.py.

Every timing read in the serving stack historically called
``time.monotonic()`` (elapsed/interval math) or ``time.time()`` (wire
deadlines) directly.  That hard-codes *wall* time into components whose
semantics are purely relative — EWMAs, staleness windows, lease
deadlines, burn-rate windows, retry ladders — which blocks two things:

  * **deterministic simulation** (`dynamo_tpu/testing/sim.py`): running
    the real fleet on a virtual clock requires every component to read
    the SAME simulated instant the event loop schedules against;
  * **fast tests**: aging a health score or expiring a lease should not
    require actually sleeping.

This module provides the one indirection both need:

  * ``now()``   — monotonic seconds (the `time.monotonic` role);
  * ``wall()``  — epoch seconds (the `time.time` role: wire deadlines);
  * ``set_clock(clock)`` / ``reset_clock()`` — swap the process clock
    (the sim harness installs its `SimClock`; tests restore).

Components take the *function* (``now_fn: Callable = clock.now``) so the
swap is visible even through default arguments: ``clock.now`` reads the
module-level ``_clock`` at every call.

Design note: a module-global (rather than a context-var or per-object
injection) is deliberate.  The sim harness owns the whole process while
it runs — mixing simulated and wall time inside one process is exactly
the bug class this module exists to kill.  Per-object ``now_fn``
parameters remain everywhere for tests that want a private clock.
"""

from __future__ import annotations

import time
from typing import Callable, Protocol


class Clock(Protocol):
    """Anything with monotonic `now()` and epoch `wall()` seconds."""

    def now(self) -> float: ...

    def wall(self) -> float: ...


class SystemClock:
    """The default: real wall time."""

    __slots__ = ()

    def now(self) -> float:
        return time.monotonic()

    def wall(self) -> float:
        return time.time()


SYSTEM_CLOCK = SystemClock()

_clock: Clock = SYSTEM_CLOCK


def now() -> float:
    """Monotonic seconds from the installed process clock."""
    return _clock.now()


def wall() -> float:
    """Epoch seconds from the installed process clock (wire deadlines)."""
    return _clock.wall()


def get_clock() -> Clock:
    return _clock


def set_clock(clock: Clock) -> Clock:
    """Install `clock` process-wide; returns the previous clock so
    callers can restore it (the sim harness does this in a finally)."""
    global _clock
    prev = _clock
    _clock = clock
    return prev


def reset_clock() -> None:
    global _clock
    _clock = SYSTEM_CLOCK


def virtual() -> bool:
    """Is a non-system (simulated) clock installed right now?  Hot paths
    that genuinely need wall time (e.g. log timestamps) may consult this;
    serving logic never should."""
    return _clock is not SYSTEM_CLOCK
