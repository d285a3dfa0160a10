"""Ingress: host an async-generator handler as a discoverable endpoint worker.

The port's own copy of dynamo_tpu/pipeline/ingress.py.

Role-equivalent of the reference's PushEndpoint / Ingress / PushWorkHandler
(lib/runtime/src/pipeline/network/ingress/push_endpoint.rs:111,
push_handler.rs) and of the Python bindings' `endpoint.serve_endpoint(fn)`.

Flow per request: fabric bus delivers msgpack [header, payload]; we decode the
Context from the header, call the handler (an async generator), connect a
StreamSender back to the caller's TCP response server, and stream each yielded
item as an Annotated wire dict. The caller closing the connection (it went
away, also before the first item) or a broken pipe kills the request context
so the engine stops generating. The reference sees only the broken pipe, at
its next send, so a request abandoned before its first item ran on to it.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
from typing import Any, AsyncIterator, Callable

from dynamo_tpu_torch.fabric import mpack
from dynamo_tpu_torch.fabric.client import FabricClient, Subscription
from dynamo_tpu_torch.pipeline.annotated import Annotated
from dynamo_tpu_torch.pipeline.context import Context
from dynamo_tpu_torch.pipeline.tcp import StreamSender
from dynamo_tpu_torch.runtime.cancellation import CancellationToken

logger = logging.getLogger("dynamo_tpu_torch.pipeline.ingress")

# handler(request, context) -> async iterator of response items
Handler = Callable[[Any, Context], AsyncIterator[Any]]


def to_wire_item(item: Any) -> dict:
    return item.to_wire() if isinstance(item, Annotated) else {"data": item}


class PushEndpointWorker:
    """Subscribes to an endpoint's bus subjects and serves requests."""

    def __init__(
        self,
        fabric: FabricClient,
        handler: Handler,
        token: CancellationToken,
    ) -> None:
        self.fabric = fabric
        self.handler = handler
        self.token = token
        self._subs: list[Subscription] = []
        self._tasks: set[asyncio.Task] = set()
        self._loops: list[asyncio.Task] = []
        self.inflight = 0

    async def start(self, subjects_groups: list[tuple[str, str]]) -> None:
        loop = asyncio.get_running_loop()
        for subject, group in subjects_groups:
            sub = await self.fabric.subscribe(subject, group)
            self._subs.append(sub)
            self._loops.append(loop.create_task(self._consume(sub)))
        self.token.on_cancel(lambda: loop.create_task(self.stop()))

    async def _consume(self, sub: Subscription) -> None:
        with contextlib.suppress(asyncio.CancelledError):
            async for _subject, payload in sub:
                if self.token.is_cancelled():
                    return
                task = asyncio.get_running_loop().create_task(
                    self._handle_one(payload)
                )
                self._tasks.add(task)
                task.add_done_callback(self._tasks.discard)

    async def _handle_one(self, raw: bytes) -> None:
        self.inflight += 1
        try:
            header, req_payload = mpack.unpackb(raw)
            ctx = Context.from_header(header.get("ctx", {}))
            request = mpack.unpackb(req_payload)
            sender = await StreamSender.connect(
                header["resp_addr"], header["resp_subject"]
            )
        except Exception:
            logger.exception("failed to accept request")
            self.inflight -= 1
            return
        # a caller that goes away kills the context at once, also while the
        # handler has not produced its first item (a remote prefill in flight)
        gone = asyncio.ensure_future(sender.peer_closed())
        gone.add_done_callback(lambda f: f.cancelled() or ctx.kill())
        try:
            gen = self.handler(request, ctx)
            try:
                async for item in gen:
                    if ctx.is_killed():
                        break
                    try:
                        await sender.send_data(
                            mpack.packb(to_wire_item(item))
                        )
                    except (ConnectionError, BrokenPipeError):
                        ctx.kill()
                        break
            finally:
                with contextlib.suppress(Exception):
                    await gen.aclose()
        except Exception as e:  # handler error -> error frame to caller
            logger.exception("handler error for request %s", ctx.id)
            with contextlib.suppress(Exception):
                await sender.send_error(f"{type(e).__name__}: {e}")
        finally:
            gone.cancel()
            await sender.finish()
            self.inflight -= 1

    async def stop(self, drain: bool = True) -> None:
        for sub in self._subs:
            await sub.unsubscribe()
        for t in self._loops:
            t.cancel()
        if drain and self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)
        else:
            for t in list(self._tasks):
                t.cancel()
