"""Namespace -> Component -> Endpoint -> Client hierarchy.

The port's own copy of dynamo_tpu/runtime/component.py, whole; messages are
packed by the port's stdlib codec (``fabric/mpack.py``), byte-identical to
the JAX package's ``msgpack`` frames.

Role-equivalent of the reference's component model
(lib/runtime/src/component.rs:106-602, component/{client,endpoint}.rs):
instances register in the fabric kv under a lease; Clients watch the instance
prefix and route requests over the bus with responses streaming back on the
TCP response plane.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import random
import uuid
from typing import Any, AsyncIterator, Optional

from dynamo_tpu_torch.fabric import mpack
from dynamo_tpu_torch.fabric.client import Watch
from dynamo_tpu_torch.pipeline.annotated import Annotated
from dynamo_tpu_torch.pipeline.context import Context
from dynamo_tpu_torch.pipeline.ingress import Handler, PushEndpointWorker
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.protocols import EndpointId, Instance

logger = logging.getLogger("dynamo_tpu_torch.runtime.component")


class Namespace:
    def __init__(self, drt: DistributedRuntime, name: str) -> None:
        self.drt = drt
        self.name = name

    def component(self, name: str) -> "Component":
        return Component(self, name)

    # --- events plane ({ns}.events.{subject}, reference traits/events.rs) ---

    def event_subject(self, subject: str) -> str:
        return f"{self.name}.events.{subject}"

    async def publish_event(self, subject: str, data: Any) -> int:
        return await self.drt.fabric.publish(
            self.event_subject(subject), mpack.packb(data)
        )

    async def subscribe_event(self, subject: str):
        return await self.drt.fabric.subscribe(self.event_subject(subject))


class Component:
    def __init__(self, namespace: Namespace, name: str) -> None:
        self.namespace = namespace
        self.name = name

    @property
    def drt(self) -> DistributedRuntime:
        return self.namespace.drt

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self, name)

    async def list_instances(self) -> list[Instance]:
        prefix = f"instances/{self.namespace.name}/{self.name}/"
        kvs = await self.drt.fabric.kv_get_prefix(prefix)
        return [Instance.from_bytes(v) for v in kvs.values()]


class Endpoint:
    def __init__(self, component: Component, name: str) -> None:
        self.component = component
        self.name = name
        self.id = EndpointId(
            component.namespace.name, component.name, name
        )

    @property
    def drt(self) -> DistributedRuntime:
        return self.component.drt

    async def serve_endpoint(
        self,
        handler: Handler,
        *,
        lease_id: Optional[int] = None,
        metadata: Optional[dict[str, Any]] = None,
    ) -> "EndpointService":
        """Register this process as a replica of the endpoint and serve
        requests until stopped or the runtime cancels."""
        drt = self.drt
        lid = lease_id if lease_id is not None else drt.primary_lease
        instance = Instance(
            namespace=self.id.namespace,
            component=self.id.component,
            endpoint=self.id.name,
            instance_id=lid,
            transport={"type": "bus+tcp", **(metadata or {})},
        )
        token = drt.child_token()
        worker = PushEndpointWorker(drt.fabric, handler, token)
        await worker.start(
            [
                (self.id.subject, "workers"),
                (self.id.direct_subject(lid), ""),
            ]
        )
        # local short-circuit registry (same-process calls skip the wire)
        drt.local_endpoints[self.id.direct_subject(lid)] = handler
        await drt.fabric.kv_put(
            self.id.instance_key(lid), instance.to_bytes(), lease_id=lid
        )
        logger.info("serving %s as instance %x", self.id, lid)
        return EndpointService(self, instance, worker, token)

    async def client(self) -> "Client":
        client = Client(self)
        await client._start()
        return client


class EndpointService:
    """Handle to a live served endpoint replica."""

    def __init__(
        self,
        endpoint: Endpoint,
        instance: Instance,
        worker: PushEndpointWorker,
        token,
    ) -> None:
        self.endpoint = endpoint
        self.instance = instance
        self.worker = worker
        self.token = token

    @property
    def instance_id(self) -> int:
        return self.instance.instance_id

    async def stop(self, drain: bool = True) -> None:
        drt = self.endpoint.drt
        eid = self.endpoint.id
        drt.local_endpoints.pop(eid.direct_subject(self.instance_id), None)
        with contextlib.suppress(Exception):
            await drt.fabric.kv_delete(eid.instance_key(self.instance_id))
        await self.worker.stop(drain=drain)
        self.token.cancel()

    async def wait(self) -> None:
        """Block until the runtime is cancelled (worker main-loop idiom)."""
        await self.token.cancelled()


class ResponseStream:
    """Async iterator of Annotated response items, with its request Context.

    Closing (or breaking out of iteration and calling .close()) cancels the
    request at the worker via TCP disconnect."""

    def __init__(self, gen: AsyncIterator[Annotated], context: Context, closer=None):
        self._gen = gen
        self.context = context
        self._closer = closer

    def __aiter__(self):
        return self._gen.__aiter__()

    async def close(self) -> None:
        self.context.kill()
        if self._closer is not None:
            self._closer()
        with contextlib.suppress(Exception):
            await self._gen.aclose()  # type: ignore[attr-defined]


class NoInstancesError(RuntimeError):
    pass


class Client:
    """Endpoint client: watches live instances and dispatches requests.

    Role-equivalent of component/client.rs (InstanceSource watch) combined
    with the transmit half of push_router.rs."""

    # Max wait for the worker's first response frame. Workers connect back
    # before doing any engine work, so this bounds only dispatch+connect; a
    # worker that dies (or can't reach us) between bus delivery and call-home
    # would otherwise hang the caller forever.
    HANDSHAKE_TIMEOUT_S = 30.0

    def __init__(self, endpoint: Endpoint) -> None:
        self.endpoint = endpoint
        self.instances: dict[int, Instance] = {}
        self._watch: Optional[Watch] = None
        self._watch_task: Optional[asyncio.Task] = None
        self._rr_counter = 0
        self._change = asyncio.Event()

    @property
    def drt(self) -> DistributedRuntime:
        return self.endpoint.drt

    async def _start(self) -> None:
        prefix = self.endpoint.id.instance_prefix
        self._watch = await self.drt.fabric.watch_prefix(prefix)
        for ev in self._watch.initial:
            self._apply(ev.type, ev.key, ev.value)
        self._watch_task = asyncio.get_running_loop().create_task(
            self._watch_loop()
        )

    def _apply(self, typ: str, key: str, value: bytes) -> None:
        if typ == "put":
            inst = Instance.from_bytes(value)
            self.instances[inst.instance_id] = inst
        else:
            with contextlib.suppress(ValueError):
                iid = int(key.rsplit(":", 1)[1], 16)
                self.instances.pop(iid, None)
        self._change.set()
        self._change = asyncio.Event()

    async def _watch_loop(self) -> None:
        assert self._watch is not None
        with contextlib.suppress(asyncio.CancelledError):
            async for ev in self._watch:
                self._apply(ev.type, ev.key, ev.value)

    async def close(self) -> None:
        if self._watch is not None:
            await self._watch.cancel()
        if self._watch_task is not None:
            self._watch_task.cancel()

    # ----------------------------------------------------------- selection

    def instance_ids(self) -> list[int]:
        return sorted(self.instances.keys())

    async def wait_instances_changed(self, timeout: float) -> None:
        """Block until the live-instance set changes (the watch applies an
        add or a remove), or timeout. Migration uses this to pause replays
        while a mass worker restart repopulates discovery, instead of
        burning its retry budget against stale instances."""
        change = self._change
        with contextlib.suppress(asyncio.TimeoutError):
            await asyncio.wait_for(change.wait(), timeout)

    async def wait_for_instances(self, timeout: float = 30.0) -> list[int]:
        deadline = asyncio.get_running_loop().time() + timeout
        while not self.instances:
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                raise NoInstancesError(
                    f"no instances of {self.endpoint.id} after {timeout}s"
                )
            change = self._change
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(change.wait(), remaining)
        return self.instance_ids()

    # ------------------------------------------------------------ dispatch

    def _eligible(self, exclude: Optional[set[int]]) -> list[int]:
        """Live instances minus an exclusion set (workers a migrating
        request just watched die). If exclusion would empty the pool, fall
        back to the full list — a restarted worker may be healthy again.
        (The reference also excludes latency-ejected workers; health
        scoring is not ported yet.)"""
        ids = self.instance_ids()
        if exclude:
            kept = [i for i in ids if i not in exclude]
            if kept:
                return kept
        return ids

    async def random(
        self,
        request: Any,
        context: Optional[Context] = None,
        exclude: Optional[set[int]] = None,
    ):
        ids = self._eligible(exclude)
        if not ids:
            raise NoInstancesError(str(self.endpoint.id))
        return await self.direct(request, random.choice(ids), context)

    async def round_robin(
        self,
        request: Any,
        context: Optional[Context] = None,
        exclude: Optional[set[int]] = None,
    ):
        ids = self._eligible(exclude)
        if not ids:
            raise NoInstancesError(str(self.endpoint.id))
        iid = ids[self._rr_counter % len(ids)]
        self._rr_counter += 1
        return await self.direct(request, iid, context)

    async def direct(
        self, request: Any, instance_id: int, context: Optional[Context] = None
    ) -> ResponseStream:
        ctx = context or Context()
        # record the serving worker so stream-break handling (in-flight
        # migration) knows which instance to exclude on replay
        ctx.metadata["worker_instance_id"] = instance_id
        subject = self.endpoint.id.direct_subject(instance_id)
        local = self.drt.local_endpoints.get(subject)
        if local is not None and not self.drt.fabric.is_remote:
            return self._call_local(local, request, ctx)
        return await self._call_remote(subject, request, ctx)

    def _call_local(
        self, handler: Handler, request: Any, ctx: Context
    ) -> ResponseStream:
        async def gen() -> AsyncIterator[Annotated]:
            agen = handler(request, ctx)
            try:
                async for item in agen:
                    if ctx.is_killed():
                        break
                    yield item if isinstance(item, Annotated) else Annotated.from_data(item)
            except Exception as e:  # noqa: BLE001 — surfaces as error element
                logger.exception("local handler error")
                yield Annotated.from_error(f"{type(e).__name__}: {e}")
            finally:
                with contextlib.suppress(Exception):
                    await agen.aclose()

        return ResponseStream(gen(), ctx)

    async def _call_remote(
        self, subject: str, request: Any, ctx: Context
    ) -> ResponseStream:
        drt = self.drt
        await drt.tcp_server.ensure_started()
        resp_subject = uuid.uuid4().hex
        receiver = drt.tcp_server.register_stream(resp_subject)
        header = {
            "ctx": ctx.to_header(),
            "resp_addr": drt.tcp_server.addr,
            "resp_subject": resp_subject,
        }
        body = mpack.packb([header, mpack.packb(request)])
        # clamp any fabric failover-gate wait to the request's remaining
        # deadline: a request with 2 s of budget must not park on the full
        # 15 s DYN_FABRIC_FAILOVER_S gate just to dispatch
        delivered = await drt.fabric.publish(
            subject, body, timeout=ctx.remaining_s()
        )
        if delivered == 0:
            receiver.close()
            raise NoInstancesError(f"no subscriber on {subject}")

        handshake_timeout = self.HANDSHAKE_TIMEOUT_S

        async def gen() -> AsyncIterator[Annotated]:
            first = True
            try:
                it = receiver.__aiter__()
                while True:
                    try:
                        if first:
                            frame_header, payload = await asyncio.wait_for(
                                it.__anext__(), handshake_timeout
                            )
                            first = False
                        else:
                            frame_header, payload = await it.__anext__()
                    except StopAsyncIteration:
                        return
                    except asyncio.TimeoutError:
                        yield Annotated.from_error(
                            f"no response from worker within {handshake_timeout}s"
                        )
                        return
                    t = frame_header.get("t")
                    if t == "err":
                        yield Annotated.from_error(payload.decode())
                        return
                    yield Annotated.from_wire(mpack.unpackb(payload))
            finally:
                receiver.close()

        return ResponseStream(gen(), ctx, closer=receiver.close)
