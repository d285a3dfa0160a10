"""Reusable fault-injection harness (`DYN_FAULT=` spec).

The port's own copy of dynamo_tpu/testing/faults.py: the same grammar, the
same injector and the same visit counting, so one scripted sequence of
fault-point visits fires identically in both packages. ``corrupt_array``
also takes a CPU tensor (flipped in place through its bytes); it never
touches a CUDA tensor: the callers pass host bytes.

Role-equivalent of the reference's fault-tolerance test hooks
(tests/fault_tolerance/*): a process-wide injector that engines and the
fabric consult at well-defined fault points. Off by default and zero-cost
when off (every hook checks a module-level ``_active`` flag first).

Spec grammar — comma-separated ``key=value`` actions::

    DYN_FAULT="kill_after_tokens=12"        # SIGKILL self after N tokens
    DYN_FAULT="abort_after_tokens=5"        # abort all streams after N tokens
    DYN_FAULT="delay_dispatch=0.05"         # sleep S before each dispatch
    DYN_FAULT="delay_dispatch=0.2,every=4"  # ... but only every 4th dispatch
    DYN_FAULT="slow_decode=5"               # SUSTAINED slowdown: every
                                            # dispatch runs 5x slower (a
                                            # gray worker — throttled, not
                                            # dead)
    DYN_FAULT="slow_decode=5,after=20"      # ... starting at dispatch 20
    DYN_FAULT="slow_decode=5,every=3"       # ... on every 3rd dispatch
    DYN_FAULT="gray_flap=5,period=2"        # OSCILLATING slowness: 5x slow
                                            # for the first half of every
                                            # 2-second cycle, healthy the
                                            # other half
    DYN_FAULT="stall_transfer=1.5"          # sleep S in KV-transfer paths
    DYN_FAULT="drop_fabric_conn=3"          # drop the fabric conn once,
                                            # after N publishes
    DYN_FAULT="corrupt_kv=bits"             # flip one bit in KV payloads
    DYN_FAULT="corrupt_kv=truncate,every=3" # truncate every 3rd payload
    DYN_FAULT="zombie_partition=2"          # swallow lease keepalives for
                                            # S seconds (the worker keeps
                                            # serving while the cluster
                                            # expires its lease — a zombie)
    DYN_FAULT="fabric_blackout=3"           # TOTAL control-plane blackout:
                                            # every fabric op raises
                                            # ConnectionError for S seconds
                                            # (both HA members down)
    DYN_FAULT="fabric_flap=1,every=4"       # flapping control plane: dark
                                            # for S seconds out of every
                                            # N-second cycle

``corrupt_kv`` fires at every KV data-plane store/ship point (disagg
stream frames, peer-pull replies, offload arenas, disk spill pages) —
AFTER the integrity checksum was computed, so verification at land/
promote time must catch it. ``zombie_partition`` simulates a network
partition at the worker: keepalives are silently swallowed (the fabric
never sees them, the worker believes them delivered) for S seconds;
when the window ends the next keepalive reaches the fabric, reports the
lease dead, and the runtime's self-fence hook fires.

``fabric_blackout`` simulates BOTH HA members being unreachable: every
fabric client operation (publishes, kv puts, queue ops, lease
keepalives) raises ``ConnectionError`` while the window is open, and the
in-process fabric's janitor pauses lease expiry (a dead store cannot
expire leases either). The degraded-mode data plane must keep in-flight
streams alive through a blackout shorter than ``DYN_DEGRADED_MAX_S``,
buffer event-plane publishes, and flush them on heal — with ZERO worker
self-fences. ``fabric_flap`` opens the same window periodically (dark
for S seconds at the start of every N-second cycle).

``slow_decode`` is the SUSTAINED gray-worker fault (distinct from the
one-shot ``delay_dispatch``): engines multiply each dispatch's duration
by FACTOR (the mocker scales its simulated step cost; the JaxEngine
sleeps out the difference after the real dispatch), so the worker stays
alive, lease-healthy, and checksum-clean while being FACTOR-times slow —
exactly the failure the tail-tolerance plane (telemetry/health.py) must
catch. ``gray_flap`` oscillates the same slowdown (slow for the first
half of every ``period``-second cycle) — the hysteresis test: the
ejection state machine must not flap the route set in response.

``kill_after_tokens`` is the real-process fault (the worker dies exactly as
a crashed decode worker would, mid-stream); ``abort_after_tokens`` is its
in-process twin for engine-level chaos tests: the engine fails every live
sequence with a structured error and keeps serving, conserving KV blocks.

Tests may also install a programmatic injector (``set_injector``) with a
schedule instead of a static spec, then ``reset()`` afterwards.
"""

from __future__ import annotations

import asyncio
import logging
import os
import signal
from dataclasses import dataclass
from typing import Optional

from dynamo_tpu_torch.runtime import clock as dclock

logger = logging.getLogger("dynamo_tpu_torch.testing.faults")

_active: bool = False
_injector: Optional["FaultInjector"] = None


class FaultSpecError(ValueError):
    """A malformed/unknown ``DYN_FAULT`` action. Raised at PARSE time so a
    typo'd fault spec fails the run loudly instead of silently injecting
    nothing (and the chaos wave "passing" against zero chaos)."""


# the taxonomy: action -> (value parser, value description). `every`,
# `after`, and `period` are modifiers that attach to the preceding action.
_ACTIONS: dict[str, tuple] = {
    "kill_after_tokens": (int, "int (tokens)"),
    "abort_after_tokens": (int, "int (tokens)"),
    "delay_dispatch": (float, "float (seconds)"),
    "every": (int, "int (apply on every Nth visit)"),
    "slow_decode": (float, "float (slowdown factor)"),
    "after": (int, "int (first dispatch affected)"),
    "gray_flap": (float, "float (slowdown factor)"),
    "period": (float, "float (cycle seconds)"),
    "stall_transfer": (float, "float (seconds)"),
    "drop_fabric_conn": (int, "int (publishes before drop)"),
    "corrupt_kv": (str, "bits|truncate"),
    "zombie_partition": (float, "float (seconds)"),
    "fabric_blackout": (float, "float (seconds)"),
    "fabric_flap": (float, "float (dark seconds per cycle)"),
}


def _taxonomy() -> str:
    return ", ".join(sorted(_ACTIONS))


@dataclass
class FaultSpec:
    kill_after_tokens: int = 0  # 0 = off
    abort_after_tokens: int = 0
    delay_dispatch_s: float = 0.0
    every: int = 1  # apply delay_dispatch/corrupt_kv on every Nth visit
    slow_decode_factor: float = 0.0  # 0 = off; sustained per-step slowdown
    after: int = 0  # slow_decode only fires from the Nth dispatch on
    gray_flap_factor: float = 0.0  # 0 = off; oscillating slowdown
    period_s: float = 2.0  # gray_flap cycle length (slow first half)
    stall_transfer_s: float = 0.0
    drop_fabric_conn: int = 0  # drop once, after N publishes (0 = off)
    corrupt_kv: str = ""  # "" = off | "bits" | "truncate"
    zombie_partition_s: float = 0.0  # swallow keepalives for S seconds
    fabric_blackout_s: float = 0.0  # every fabric op fails for S seconds
    fabric_flap_s: float = 0.0  # dark S seconds per `every`-second cycle

    @classmethod
    def parse(cls, spec: str) -> "FaultSpec":
        out = cls()
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            key, sep, val = part.partition("=")
            key = key.strip()
            val = val.strip()
            if key not in _ACTIONS:
                raise FaultSpecError(
                    f"unknown DYN_FAULT action {key!r}; known actions: "
                    f"{_taxonomy()}"
                )
            if not sep or not val:
                raise FaultSpecError(
                    f"DYN_FAULT action {key!r} needs a value "
                    f"({_ACTIONS[key][1]}), got {part!r}"
                )
            caster = _ACTIONS[key][0]
            try:
                caster(val)
            except ValueError:
                raise FaultSpecError(
                    f"DYN_FAULT action {key!r} value {val!r} is not a valid "
                    f"{_ACTIONS[key][1]}; known actions: {_taxonomy()}"
                ) from None
            if key == "kill_after_tokens":
                out.kill_after_tokens = int(val)
            elif key == "abort_after_tokens":
                out.abort_after_tokens = int(val)
            elif key == "delay_dispatch":
                out.delay_dispatch_s = float(val)
            elif key == "every":
                out.every = max(1, int(val))
            elif key == "slow_decode":
                out.slow_decode_factor = float(val)
            elif key == "after":
                out.after = max(0, int(val))
            elif key == "gray_flap":
                out.gray_flap_factor = float(val)
            elif key == "period":
                out.period_s = float(val)
            elif key == "stall_transfer":
                out.stall_transfer_s = float(val)
            elif key == "drop_fabric_conn":
                out.drop_fabric_conn = int(val)
            elif key == "corrupt_kv":
                if val not in ("bits", "truncate"):
                    raise FaultSpecError(
                        f"corrupt_kv mode must be bits|truncate, got {val!r}"
                    )
                out.corrupt_kv = val
            elif key == "zombie_partition":
                out.zombie_partition_s = float(val)
            elif key == "fabric_blackout":
                out.fabric_blackout_s = float(val)
            elif key == "fabric_flap":
                out.fabric_flap_s = float(val)
        return out


class FaultInjector:
    """Counts fault-point visits and decides when each fault fires."""

    def __init__(self, spec: FaultSpec) -> None:
        self.spec = spec
        self.tokens = 0
        self.dispatches = 0
        self.publishes = 0
        self.fabric_dropped = False
        self.kv_payloads = 0  # corrupt_kv fault-point visits
        self._zombie_t0: Optional[float] = None  # partition window start
        self._fabric_t0: Optional[float] = None  # blackout/flap clock start
        self._gray_t0: Optional[float] = None  # gray_flap clock start
        # observability for chaos tests
        self.fired: dict[str, int] = {}

    def _mark(self, name: str) -> None:
        self.fired[name] = self.fired.get(name, 0) + 1

    # ------------------------------------------------------- fault points

    def on_token(self) -> bool:
        """Engines call this per emitted token. Returns True when the
        in-process abort fault should fire (the caller fails its live
        sequences); executes the kill fault directly (never returns)."""
        self.tokens += 1
        k = self.spec.kill_after_tokens
        if k and self.tokens >= k:
            logger.warning("DYN_FAULT kill_after_tokens=%d firing", k)
            self._mark("kill")
            os.kill(os.getpid(), signal.SIGKILL)
        a = self.spec.abort_after_tokens
        if a and self.tokens >= a:
            self.tokens = 0  # re-arm: chaos soaks want repeated crashes
            self._mark("abort")
            return True
        return False

    async def on_dispatch(self) -> None:
        """Engines call this before each device/sim dispatch."""
        self.dispatches += 1
        d = self.spec.delay_dispatch_s
        if d and self.dispatches % self.spec.every == 0:
            self._mark("delay_dispatch")
            await asyncio.sleep(d)

    def dispatch_slow_factor(self) -> float:
        """Gray-worker fault point: engines multiply the CURRENT
        dispatch's duration by the returned factor (1.0 = no fault).
        ``slow_decode=F[,after=N][,every=K]`` is sustained slowness from
        the Nth dispatch, on every Kth; ``gray_flap=F,period=S`` is slow
        for the first half of every S-second cycle. Callers must have
        counted the dispatch via on_dispatch() already."""
        f = self.spec.slow_decode_factor
        if f and f != 1.0:
            if (
                self.dispatches > self.spec.after
                and self.dispatches % self.spec.every == 0
            ):
                self._mark("slow_decode")
                return f
            return 1.0
        g = self.spec.gray_flap_factor
        if g and g != 1.0:
            now = dclock.now()
            if self._gray_t0 is None:
                self._gray_t0 = now
            period = max(1e-3, self.spec.period_s)
            if ((now - self._gray_t0) % period) < period / 2.0:
                self._mark("gray_flap")
                return g
        return 1.0

    async def on_transfer(self) -> None:
        """KV-transfer paths (disagg ship, offload) call this."""
        s = self.spec.stall_transfer_s
        if s:
            self._mark("stall_transfer")
            await asyncio.sleep(s)

    def corrupt_bytes(self, data: bytes) -> Optional[bytes]:
        """KV payload corruption fault point (data-plane ship/store sites
        call this AFTER checksums are computed). Returns the corrupted
        copy when the fault fires, else None (ship the original)."""
        mode = self.spec.corrupt_kv
        if not mode or not data:
            return None
        self.kv_payloads += 1
        if self.kv_payloads % self.spec.every:
            return None
        self._mark("corrupt_kv")
        if mode == "truncate":
            return data[: len(data) // 2]
        # deterministic single-bit flip (position walks with the counter
        # so repeated frames don't all corrupt the same byte)
        b = bytearray(data)
        idx = (self.kv_payloads * 2654435761) % len(b)
        b[idx] ^= 1 << (self.kv_payloads % 8)
        return bytes(b)

    def corrupt_array(self, arr) -> bool:
        """In-place corruption of a stored block (offload arenas): a numpy
        array or a CPU tensor, through its bytes; True when the fault fired.
        A tensor off the CPU is never touched (no visit is counted)."""
        if not self.spec.corrupt_kv:
            return False
        import numpy as np

        if hasattr(arr, "device") and hasattr(arr, "untyped_storage"):
            if arr.device.type != "cpu":
                return False
            arr = arr.reshape(-1).view(_torch_uint8()).numpy()
        flat = arr.reshape(-1).view(np.uint8)
        if flat.size == 0:
            return False
        self.kv_payloads += 1
        if self.kv_payloads % self.spec.every:
            return False
        self._mark("corrupt_kv")
        idx = (self.kv_payloads * 2654435761) % flat.size
        flat[idx] ^= 1 << (self.kv_payloads % 8)
        return True

    def corrupt_file(self, path: str) -> bool:
        """Tear a just-spilled G3 disk page; True when the fault fired."""
        if not self.spec.corrupt_kv:
            return False
        self.kv_payloads += 1
        if self.kv_payloads % self.spec.every:
            return False
        self._mark("corrupt_kv")
        try:
            if self.spec.corrupt_kv == "truncate":
                size = os.path.getsize(path)
                with open(path, "r+b") as f:
                    f.truncate(max(0, size // 2))
            else:
                with open(path, "r+b") as f:
                    f.seek((self.kv_payloads * 2654435761)
                           % max(1, os.path.getsize(path)))
                    byte = f.read(1) or b"\x00"
                    f.seek(-1 if byte else 0, os.SEEK_CUR)
                    f.write(bytes([byte[0] ^ (1 << (self.kv_payloads % 8))]))
        except OSError:
            return False
        return True

    def keepalive_swallowed(self, lease_id: int = 0) -> bool:
        """Lease-keepalive fault point (fabric client). True while the
        zombie-partition window is open: the keepalive must be silently
        dropped — the fabric never refreshes the lease, the worker
        believes it delivered — so the cluster declares the worker dead
        while it keeps serving. After S seconds the partition 'heals':
        keepalives reach the fabric again and report the lease gone,
        firing the runtime's self-fence."""
        s = self.spec.zombie_partition_s
        if not s:
            return False
        if self._zombie_t0 is None:
            self._zombie_t0 = dclock.now()
        if dclock.now() - self._zombie_t0 < s:
            self._mark("zombie_partition")
            return True
        return False

    def fabric_unreachable(self) -> bool:
        """Control-plane blackout fault point: every fabric client op (and
        the in-process janitor's lease expiry — a dead store cannot expire
        leases) consults this. True while the injected blackout/flap
        window is open. ``fabric_blackout=S`` opens one S-second window
        starting at the first visit; ``fabric_flap=S,every=N`` darkens the
        first S seconds of every N-second cycle."""
        b = self.spec.fabric_blackout_s
        f = self.spec.fabric_flap_s
        if not b and not f:
            return False
        now = dclock.now()
        if self._fabric_t0 is None:
            self._fabric_t0 = now
        elapsed = now - self._fabric_t0
        if b:
            if elapsed < b:
                self._mark("fabric_blackout")
                return True
            return False
        period = max(float(self.spec.every), f + 0.5)
        if (elapsed % period) < f:
            self._mark("fabric_flap")
            return True
        return False

    def should_drop_fabric(self) -> bool:
        """Fabric client calls this per publish; True at most once."""
        n = self.spec.drop_fabric_conn
        if not n or self.fabric_dropped:
            return False
        self.publishes += 1
        if self.publishes >= n:
            self.fabric_dropped = True
            self._mark("drop_fabric_conn")
            return True
        return False


def _torch_uint8():
    import torch

    return torch.uint8


# ---------------------------------------------------------------- plumbing


def active() -> bool:
    """Cheap guard for hot paths: is any fault injection configured?"""
    return _active


def get_injector() -> Optional[FaultInjector]:
    """The process injector, creating it from DYN_FAULT on first use."""
    global _injector, _active
    if _injector is None:
        spec = os.environ.get("DYN_FAULT", "").strip()
        if spec:
            _injector = FaultInjector(FaultSpec.parse(spec))
            _active = True
            logger.warning("fault injection armed: DYN_FAULT=%s", spec)
    return _injector


def set_injector(injector: Optional[FaultInjector]) -> None:
    """Install a programmatic injector (tests). None re-arms from env."""
    global _injector, _active
    _injector = injector
    _active = injector is not None


def reset() -> None:
    """Drop any injector; re-read DYN_FAULT on next get_injector()."""
    global _injector, _active
    _injector = None
    _active = bool(os.environ.get("DYN_FAULT", "").strip())


# arm at import time in processes launched with DYN_FAULT set, so engines
# only need the cheap active() check on their hot paths
reset()
