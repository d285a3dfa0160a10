"""The local-or-remote prefill decision: the port's twin of
dynamo_tpu/disagg/router.py.

``prefill_remote(prefill_len, prefix_hit_len)`` is True when the prompt's
non-cached part is longer than ``max_local_prefill_length`` and the prefill
queue holds fewer than ``max_prefill_queue_size`` requests. With a
``fabric`` the router reads its namespace's ``PrefillQueue`` (as the
reference's does) and its thresholds are live: ``publish_config`` writes
them under ``disagg_router/{namespace}/{component}`` in the fabric's KV
store, and ``start_watching`` adopts the value there now and every later
put, so operators retune the split without restarting decode workers.
Without a fabric the queue is any object with an ``async depth()`` (the
depth stays 0 without one, as the in-process clients use it), and the two
live-threshold methods raise ValueError.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
from dataclasses import asdict, dataclass
from typing import Any, Optional

logger = logging.getLogger("dynamo_tpu_torch.disagg.router")


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


def _config_key(namespace: str, component: str) -> str:
    return f"disagg_router/{namespace}/{component}"


class DisaggregatedRouter:
    """Decides local against remote prefill for one decode worker."""

    def __init__(self, config: Optional[DisaggConfig] = None, queue: Optional[Any] = None,
                 namespace: str = "dynamo", component: str = "decode", *,
                 fabric: Optional[Any] = None) -> None:
        self._fabric = fabric
        self.namespace = namespace
        self.component = component
        self.config = config or DisaggConfig()
        if queue is None and fabric is not None:
            from dynamo_tpu_torch.disagg.prefill_queue import PrefillQueue

            queue = PrefillQueue(fabric, namespace)
        self.queue = queue
        self._queue_depth_cache = 0
        self._depth_checked_at = -1.0
        self._watch = None
        self._watch_task: Optional[asyncio.Task] = None

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

    # ------------------------------------------------ live thresholds

    def _need_fabric(self, what: str):
        if self._fabric is None:
            raise ValueError(f"{what} needs a fabric: build the router with "
                             "DisaggregatedRouter(..., fabric=<FabricClient>)")
        return self._fabric

    async def publish_config(self, config: DisaggConfig) -> None:
        """Write thresholds to the fabric's KV store (any process may)."""
        fabric = self._need_fabric("publish_config")
        await fabric.kv_put(_config_key(self.namespace, self.component),
                            json.dumps(asdict(config)).encode())

    async def start_watching(self) -> None:
        """Adopt the published thresholds now and on every later change.
        The initial value comes from the watch's own snapshot, not from a
        separate get, so a put landing between the two is never missed."""
        fabric = self._need_fabric("start_watching")
        watch = await fabric.watch_prefix(_config_key(self.namespace, self.component))
        for ev in watch.initial:
            if ev.type == "put" and ev.value:
                self._apply(ev.value)

        async def loop() -> None:
            async for ev in watch:
                if ev.type == "put" and ev.value:
                    self._apply(ev.value)

        self._watch = watch
        self._watch_task = asyncio.get_running_loop().create_task(loop())

    def _apply(self, raw: bytes) -> None:
        try:
            self.config = DisaggConfig.from_dict(json.loads(raw))
            logger.info("disagg thresholds updated: local<=%d, queue<%d",
                        self.config.max_local_prefill_length,
                        self.config.max_prefill_queue_size)
        except (ValueError, TypeError) as e:
            logger.warning("bad disagg config update ignored: %s", e)

    async def close(self) -> None:
        if self._watch_task is not None:
            await self._watch.cancel()
            self._watch_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._watch_task
            self._watch_task = None
