"""Leader/worker rendezvous barrier over the fabric kv.

The port's own copy of dynamo_tpu/runtime/barrier.py.

Role-equivalent of the reference's etcd LeaderBarrier/WorkerBarrier
(lib/runtime/src/utils/leader_worker_barrier.rs:137,230), used for
multi-host engine bring-up: the leader publishes barrier data and waits for N
workers to check in; workers wait for the data and register themselves.
"""

from __future__ import annotations

import asyncio
import json
from typing import Any

from dynamo_tpu_torch.fabric.client import FabricClient

_ROOT = "barriers/"


class BarrierTimeout(TimeoutError):
    pass


class LeaderBarrier:
    def __init__(self, barrier_id: str, num_workers: int, timeout: float = 120.0):
        self.barrier_id = barrier_id
        self.num_workers = num_workers
        self.timeout = timeout

    async def sync(self, fabric: FabricClient, lease_id: int, data: Any) -> None:
        """Publish data, then wait until num_workers have checked in."""
        key = f"{_ROOT}{self.barrier_id}/data"
        await fabric.kv_put(key, json.dumps(data).encode(), lease_id=lease_id)
        prefix = f"{_ROOT}{self.barrier_id}/workers/"
        watch = await fabric.watch_prefix(prefix)
        try:
            seen = {ev.key for ev in watch.initial if ev.type == "put"}
            if len(seen) >= self.num_workers:
                return
            async def collect() -> None:
                async for ev in watch:
                    if ev.type == "put":
                        seen.add(ev.key)
                        if len(seen) >= self.num_workers:
                            return
            try:
                await asyncio.wait_for(collect(), self.timeout)
            except asyncio.TimeoutError:
                raise BarrierTimeout(
                    f"leader barrier {self.barrier_id}: "
                    f"{len(seen)}/{self.num_workers} workers"
                ) from None
        finally:
            await watch.cancel()


class WorkerBarrier:
    def __init__(self, barrier_id: str, worker_id: str, timeout: float = 120.0):
        self.barrier_id = barrier_id
        self.worker_id = worker_id
        self.timeout = timeout

    async def sync(self, fabric: FabricClient, lease_id: int) -> Any:
        """Wait for the leader's data, then check in. Returns the data."""
        key = f"{_ROOT}{self.barrier_id}/data"
        watch = await fabric.watch_prefix(key)
        try:
            data = None
            for ev in watch.initial:
                if ev.type == "put":
                    data = json.loads(ev.value)
            if data is None:
                async def wait_data():
                    async for ev in watch:
                        if ev.type == "put":
                            return json.loads(ev.value)
                try:
                    data = await asyncio.wait_for(wait_data(), self.timeout)
                except asyncio.TimeoutError:
                    raise BarrierTimeout(
                        f"worker barrier {self.barrier_id}: no leader data"
                    ) from None
        finally:
            await watch.cancel()
        await fabric.kv_put(
            f"{_ROOT}{self.barrier_id}/workers/{self.worker_id}",
            b"1",
            lease_id=lease_id,
        )
        return data
