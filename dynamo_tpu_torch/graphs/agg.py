"""Aggregated serving graph: OpenAI frontend + N identical workers.

Launch:  python -m dynamo_tpu_torch.serve dynamo_tpu_torch.graphs.agg

The port's own copy of dynamo_tpu/graphs/agg.py. The frontend routes with
``DYN_ROUTER_MODE`` (round_robin, random or kv) and serves on
``DYN_HTTP_HOST`` / ``DYN_HTTP_PORT`` and prints its ``{"exit_stats": ...}``
line (``run.frontend_stats``: migrations per model) when it stops; the
workers' engine is ``DYN_GRAPH_ENGINE``'s (``graphs/common.py``).

Mirrors the reference's examples/llm/graphs/agg.py (Frontend -> Processor
-> Worker chain; our frontend folds the processor role in, as the
reference's Rust frontend does)."""

from __future__ import annotations

import json
import os

from dynamo_tpu_torch.sdk import depends, service


@service(name="Worker", replicas=2)
class Worker:
    async def serve(self, runtime) -> None:
        from dynamo_tpu_torch.entrypoint.inputs import EngineConfig, run_endpoint
        from dynamo_tpu_torch.graphs.common import build_engine_from_env

        engine, mdc = await build_engine_from_env()
        config = EngineConfig.static_(engine, mdc)
        try:
            await run_endpoint(
                runtime, config,
                os.environ.get("DYN_ENDPOINT", "dynamo.backend.generate"),
            )
        finally:
            close = getattr(engine, "close", None)
            if close is not None:
                await close()


@service(name="Frontend")
class Frontend:
    workers = depends(Worker)

    async def serve(self, runtime) -> None:
        from dynamo_tpu_torch.entrypoint.inputs import EngineConfig, run_http
        from dynamo_tpu_torch.pipeline.router import RouterMode

        config = EngineConfig.dynamic(
            RouterMode(os.environ.get("DYN_ROUTER_MODE", "round_robin"))
        )
        service = await run_http(
            config,
            host=os.environ.get("DYN_HTTP_HOST", "0.0.0.0"),
            port=int(os.environ.get("DYN_HTTP_PORT", "8080")),
            drt=runtime,
        )
        # serve until the supervisor stops us OR the runtime cancels
        # (fabric loss kills the primary lease -> keepalive cancels the
        # token; exiting lets the supervisor restart us against the
        # recovered fabric with fresh discovery state)
        try:
            await runtime.token.cancelled()
        finally:
            await service.close()
            await service.watcher.stop()
            # the frontend's own record, last: migrations per model, frames
            # refused from fenced workers, its KV routers' decisions
            from dynamo_tpu_torch.run import frontend_stats

            print(json.dumps({"exit_stats": frontend_stats(service)}), flush=True)
