"""The prefill work queue over the fabric: the port's twin of
dynamo_tpu/disagg/prefill_queue.py.

Decode workers enqueue RemotePrefillRequests; any prefill worker dequeues
one. Pull semantics let prefill workers join and leave with no
coordination, and a request that is not acked (its worker died mid
prefill) is redelivered to another worker. Requests travel packed with the
port's msgpack codec (``fabric/mpack.py``), byte-identical to the JAX
package's, so either package's workers serve either's queue.
"""

from __future__ import annotations

from typing import Optional

from dynamo_tpu_torch.disagg.protocols import RemotePrefillRequest
from dynamo_tpu_torch.fabric import mpack
from dynamo_tpu_torch.fabric.client import FabricClient


class PrefillQueue:
    """One namespace's prefill work queue."""

    def __init__(self, fabric: FabricClient, namespace: str) -> None:
        self._fabric = fabric
        self.queue_name = f"{namespace}.prefill_queue"

    async def enqueue(
        self, request: RemotePrefillRequest, timeout: Optional[float] = None
    ) -> int:
        """Enqueue one prefill. ``timeout`` clamps the fabric's failover
        wait to the request's remaining budget; a queue plane that is dark
        raises ConnectionError at once, so the decode worker prefills
        locally instead of waiting on the put."""
        return await self._fabric.queue_put(
            self.queue_name, mpack.packb(request.to_wire()), timeout=timeout
        )

    async def dequeue(
        self, timeout: Optional[float] = None
    ) -> Optional[tuple[int, RemotePrefillRequest]]:
        """(msg_id, request), or None when nothing came within ``timeout``.
        The message stays in flight until ``ack(msg_id)``; without an ack
        the fabric redelivers it to another worker."""
        got = await self._fabric.queue_pop(self.queue_name, timeout=timeout)
        if got is None:
            return None
        msg_id, payload = got
        return msg_id, RemotePrefillRequest.from_wire(mpack.unpackb(payload))

    async def ack(self, msg_id: int) -> bool:
        return await self._fabric.queue_ack(self.queue_name, msg_id)

    async def depth(self) -> int:
        return await self._fabric.queue_depth(self.queue_name)
