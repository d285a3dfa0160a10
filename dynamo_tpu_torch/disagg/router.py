"""The local-or-remote prefill decision: the port's twin of
dynamo_tpu/disagg/router.py.

``prefill_remote(prefill_len, prefix_hit_len)`` is True when the prompt's
non-cached part is longer than ``max_local_prefill_length`` and the prefill
queue holds fewer than ``max_prefill_queue_size`` requests. The queue is
any object with an ``async depth()``; without one the depth stays 0, as
the reference's in-process tests set it. Publishing and watching live
thresholds need the fabric, which the port does not have yet: those two
methods raise.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass
from typing import Any, Optional

logger = logging.getLogger("dynamo_tpu_torch.disagg.router")

_FABRIC = ("needs disaggregation's fabric transport (the config watch, "
           "RemotePrefillClient, PrefillQueue), which the port does not have yet "
           "(ROADMAP.md A10)")


@dataclass
class DisaggConfig:
    # least non-cached prompt tokens for which a remote prefill pays off
    max_local_prefill_length: int = 50
    # back-pressure: at this queue depth or above, prefill locally
    max_prefill_queue_size: int = 2

    @classmethod
    def from_dict(cls, d: dict) -> "DisaggConfig":
        known = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in d.items() if k in known})


class DisaggregatedRouter:
    """Decides local against remote prefill for one decode worker."""

    def __init__(self, config: Optional[DisaggConfig] = None, queue: Optional[Any] = None,
                 namespace: str = "dynamo", component: str = "decode") -> None:
        self.namespace = namespace
        self.component = component
        self.config = config or DisaggConfig()
        self.queue = queue
        self._queue_depth_cache = 0
        self._depth_checked_at = -1.0

    def prefill_remote(self, prefill_len: int, prefix_hit_len: int = 0) -> bool:
        """True: ship the prefill; False: prefill locally."""
        pending = prefill_len - prefix_hit_len
        return (
            pending > self.config.max_local_prefill_length
            and self._queue_depth_cache < self.config.max_prefill_queue_size
        )

    async def refresh_queue_depth(self) -> int:
        if self.queue is not None:
            self._queue_depth_cache = await self.queue.depth()
        self._depth_checked_at = asyncio.get_running_loop().time()
        return self._queue_depth_cache

    async def maybe_refresh(self, max_age: float = 0.25) -> None:
        """Refresh the cached queue depth when it is older than ``max_age``
        s (the engine calls this on every admission). A failed read counts
        the queue as full, so prefills stay local."""
        now = asyncio.get_running_loop().time()
        if now - self._depth_checked_at >= max_age:
            try:
                await self.refresh_queue_depth()
            except Exception as e:  # noqa: BLE001 - the queue's transport
                logger.warning("queue depth refresh failed: %s", e)
                self._queue_depth_cache = self.config.max_prefill_queue_size

    async def publish_config(self, config: DisaggConfig) -> None:
        raise NotImplementedError(f"publish_config {_FABRIC}")

    async def start_watching(self) -> None:
        raise NotImplementedError(f"start_watching {_FABRIC}")

    async def close(self) -> None:
        return None
