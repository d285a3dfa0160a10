"""PushRouter: client-side instance selection policy over a Client.

The port's own copy of dynamo_tpu/pipeline/router.py, with random,
round_robin and direct. ``RouterMode.KV`` is named so a frontend's
``--router-mode kv`` parses, but the KV-aware router (``kv_router/``) is not
ported yet: asking for it raises NotImplementedError, and no request is
routed in another mode instead.

Role-equivalent of lib/runtime/src/pipeline/network/egress/push_router.rs
(RouterMode {Random, RoundRobin, Direct, KV} :74, constructors :113-177).
"""

from __future__ import annotations

import enum
from typing import TYPE_CHECKING, Any, Optional

from dynamo_tpu_torch.pipeline.context import Context

if TYPE_CHECKING:
    from dynamo_tpu_torch.runtime.component import Client, ResponseStream

KV_ROUTER_MISSING = (
    "router mode 'kv' needs the KV-aware router (kv_router/, the workers' KV "
    "event and metrics publishers), which the port does not have yet: "
    "ROADMAP.md Queue A item 10, 'The KV-aware router and the serve graphs'. "
    "Use --router-mode round_robin or random."
)


class RouterMode(enum.Enum):
    RANDOM = "random"
    ROUND_ROBIN = "round_robin"
    DIRECT = "direct"
    KV = "kv"


class PushRouter:
    def __init__(self, client: Client, mode: RouterMode = RouterMode.ROUND_ROBIN) -> None:
        if mode is RouterMode.KV:
            raise NotImplementedError(KV_ROUTER_MISSING)
        self.client = client
        self.mode = mode

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
        return await self.client.round_robin(request, ctx, exclude=exclude)
