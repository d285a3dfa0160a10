"""PushRouter: client-side instance selection policy over a Client.

The port's own copy of dynamo_tpu/pipeline/router.py: random, round_robin,
direct, and kv, which delegates the choice to a ``WorkerSelector`` (the
KV-aware router's ``kv_router.KvPushRouter``) and releases the request's
predicted load when its stream ends. Left out: the route span of the
reference's tracing (ROADMAP.md A12).

Role-equivalent of lib/runtime/src/pipeline/network/egress/push_router.rs
(RouterMode {Random, RoundRobin, Direct, KV} :74, constructors :113-177).
"""

from __future__ import annotations

import enum
from typing import TYPE_CHECKING, Any, Optional, Protocol

from dynamo_tpu_torch.pipeline.context import Context

if TYPE_CHECKING:
    from dynamo_tpu_torch.runtime.component import Client, ResponseStream


class RouterMode(enum.Enum):
    RANDOM = "random"
    ROUND_ROBIN = "round_robin"
    DIRECT = "direct"
    KV = "kv"


class WorkerSelector(Protocol):
    """KV-aware selection hook (reference kv_router.rs:54 WorkerSelector)."""

    async def select_worker(self, token_ids: list[int], context: Context) -> tuple[int, float]:
        """Returns (instance_id, overlap_blocks_estimate)."""
        ...


class PushRouter:
    def __init__(
        self,
        client: Client,
        mode: RouterMode = RouterMode.ROUND_ROBIN,
        selector: Optional[WorkerSelector] = None,
    ) -> None:
        if mode is RouterMode.KV and selector is None:
            raise ValueError("KV router mode requires a WorkerSelector")
        self.client = client
        self.mode = mode
        self.selector = selector

    async def generate(
        self,
        request: Any,
        context: Optional[Context] = None,
        instance_id: Optional[int] = None,
        exclude: Optional[set[int]] = None,
    ) -> ResponseStream:
        ctx = context or Context()
        if instance_id is not None or self.mode is RouterMode.DIRECT:
            if instance_id is None:
                raise ValueError("direct mode requires instance_id")
            return await self.client.direct(request, instance_id, ctx)
        if self.mode is RouterMode.RANDOM:
            return await self.client.random(request, ctx, exclude=exclude)
        if self.mode is RouterMode.ROUND_ROBIN:
            return await self.client.round_robin(request, ctx, exclude=exclude)
        # KV mode: requests expose token_ids for prefix matching
        token_ids = request.get("token_ids", []) if isinstance(request, dict) else []
        worker_id, overlap = await self.selector.select_worker(token_ids, ctx)
        if exclude and worker_id in exclude:
            # the KV-preferred worker just failed this request: any other
            # live instance beats replaying into the same failure
            others = [i for i in self.client.instance_ids() if i not in exclude]
            if others:
                worker_id, overlap = others[0], 0.0
        ctx.metadata["kv_overlap_blocks"] = overlap
        on_complete = getattr(self.selector, "on_request_complete", None)
        try:
            stream = await self.client.direct(request, worker_id, ctx)
        except BaseException:
            # the selection recorded predicted load for this request:
            # release it, or the failed worker looks loaded for good
            if on_complete is not None:
                on_complete(ctx)
            raise
        if on_complete is not None:
            stream = _CompletionHookStream(stream, ctx, on_complete)
        return stream


class _CompletionHookStream:
    """Wraps a ResponseStream; fires once when it ends (frees the KV
    router's predicted-load entry for the request)."""

    def __init__(self, inner, context: Context, on_complete) -> None:
        self._inner = inner
        self.context = context
        self._on_complete = on_complete
        self._fired = False

    def _fire(self) -> None:
        if not self._fired:
            self._fired = True
            self._on_complete(self.context)

    def __aiter__(self):
        inner_it = self._inner.__aiter__()

        async def gen():
            try:
                async for item in inner_it:
                    yield item
            finally:
                self._fire()

        return gen()

    async def close(self) -> None:
        self._fire()
        await self._inner.close()
