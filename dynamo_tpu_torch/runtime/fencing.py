"""Epoch fencing: reject data-plane traffic from workers the cluster has
declared dead.

The port's own copy of dynamo_tpu/runtime/fencing.py.

Role-equivalent of the reference's etcd lease fencing
(lib/runtime/src/transports/etcd.rs:103-404): membership there is a
lease-bound key, and a partitioned worker's writes are fenced because its
lease revision can no longer win. Our fabric mirrors the lease half; this
module adds the *data-plane* half the reference gets from etcd-guarded
transports:

  * every worker derives a **fencing epoch** from its primary lease
    (`DistributedRuntime.fencing_epoch`) and stamps `(instance_id, epoch)`
    onto dispatch reply frames, KV stream frames, peer adverts, and
    load-metrics publishes;
  * when a lease **expires** (as opposed to a graceful revoke), the fabric
    writes a permanent tombstone under ``fence/{epoch:x}`` — the cluster's
    death certificate;
  * every consumer keeps a `FenceRegistry` (a watch over ``fence/``) and
    rejects stamps whose epoch is tombstoned — so a partitioned zombie
    that keeps decoding for up to a lease-TTL after the cluster moved on
    cannot double-serve: its frames are refused at every landing point,
    and the worker itself self-fences the moment a keepalive fails
    (`DistributedRuntime.on_fence`).

Graceful drain is NOT fencing: a draining worker revokes its lease (or
deletes its keys) deliberately, no tombstone is written, and its in-flight
streams finish normally.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
from typing import Any, Optional

from dynamo_tpu_torch.integrity import COUNTERS

logger = logging.getLogger("dynamo_tpu_torch.runtime.fencing")

FENCE_ROOT = "fence/"


def fence_key(epoch: int) -> str:
    return f"{FENCE_ROOT}{epoch:x}"


def make_stamp(instance_id: int, epoch: int) -> dict[str, int]:
    """The wire stamp carried by every worker-originated frame."""
    return {"iid": int(instance_id), "ep": int(epoch)}


def stamp_epoch(stamp: Any) -> Optional[int]:
    """Extract the epoch from a wire stamp; None when absent/malformed."""
    if isinstance(stamp, dict):
        ep = stamp.get("ep")
        if isinstance(ep, int):
            return ep
    return None


class FenceRegistry:
    """Live set of fenced epochs, maintained from a ``fence/`` watch.

    One per DistributedRuntime (lazily via `drt.fences()`); consumers call
    `check_stamp(stamp, plane)` at every landing point — True means the
    stamp is fenced and the payload must be rejected (counted under
    `dyn_llm_fenced_rejects_total{plane}`)."""

    def __init__(self, fabric: Any) -> None:
        self.fabric = fabric
        self._fenced: set[int] = set()
        self._watch = None
        self._task: Optional[asyncio.Task] = None
        self._started = False

    async def start(self) -> None:
        if self._started:
            return
        self._started = True
        self._watch = await self.fabric.watch_prefix(FENCE_ROOT)
        for ev in self._watch.initial:
            self._apply(ev.key)
        self._task = asyncio.get_running_loop().create_task(self._loop())

    def _apply(self, key: str) -> None:
        with contextlib.suppress(ValueError):
            self._fenced.add(int(key[len(FENCE_ROOT):], 16))

    async def _loop(self) -> None:
        assert self._watch is not None
        with contextlib.suppress(asyncio.CancelledError):
            async for ev in self._watch:
                if ev.type == "put":
                    self._apply(ev.key)
                # tombstones are permanent: deletes are not expected, and
                # un-fencing an epoch would reopen the zombie window

    async def close(self) -> None:
        if self._watch is not None:
            await self._watch.cancel()
        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._task

    # ------------------------------------------------------------ queries

    def is_fenced(self, epoch: Optional[int]) -> bool:
        return epoch is not None and epoch in self._fenced

    def check_stamp(self, stamp: Any, plane: str) -> bool:
        """True when `stamp` names a fenced epoch (reject the payload);
        counts the reject under `plane`. Unstamped payloads pass — the
        stamp is an upgrade, not a gate."""
        ep = stamp_epoch(stamp)
        if ep is None or ep not in self._fenced:
            return False
        COUNTERS.fenced_reject(plane, ep)
        return True

    async def fence(self, epoch: int, reason: bytes = b"fenced") -> None:
        """Write the death certificate for `epoch` (best effort — the
        fabric's janitor writes it authoritatively on lease expiry)."""
        self._fenced.add(epoch)
        with contextlib.suppress(Exception):
            await self.fabric.kv_put(fence_key(epoch), reason)
