"""Hello-world graph: the smallest possible serve deployment.

The port's own copy of dynamo_tpu/graphs/hello_world.py. One echo worker,
one OpenAI frontend — the reference's
examples/hello_world (its minimal @service pipeline) for this SDK:

    python -m dynamo_tpu_torch.serve dynamo_tpu_torch.graphs.hello_world
    curl localhost:8080/v1/chat/completions -d '{
        "model": "echo", "stream": true,
        "messages": [{"role": "user", "content": "w1 w2 w3"}]}'

(The demo vocabulary is w0..w60 — the echo engine streams your tokens
back, anything else decodes as <unk>.)

The worker serves the token-echo engine (no model weights, no torch), so
this graph boots in seconds and exercises the full control plane:
fabric, discovery, the push router, SSE streaming, and supervised
process lifecycle.
"""

from __future__ import annotations

import os

from dynamo_tpu_torch.sdk import depends, service


@service(name="Worker", replicas=1)
class Worker:
    async def serve(self, runtime) -> None:
        from dynamo_tpu_torch.engine.echo import EchoEngineCore
        from dynamo_tpu_torch.entrypoint.inputs import EngineConfig, run_endpoint
        from dynamo_tpu_torch.graphs.common import word_level_mdc

        config = EngineConfig.static_(EchoEngineCore(), word_level_mdc("echo"))
        await run_endpoint(
            runtime, config,
            os.environ.get("DYN_ENDPOINT", "dynamo.backend.generate"),
        )


@service(name="Frontend")
class Frontend:
    workers = depends(Worker)

    async def serve(self, runtime) -> None:
        from dynamo_tpu_torch.entrypoint.inputs import EngineConfig, run_http

        service = await run_http(
            EngineConfig.dynamic(),
            host=os.environ.get("DYN_HTTP_HOST", "0.0.0.0"),
            port=int(os.environ.get("DYN_HTTP_PORT", "8080")),
            drt=runtime,
        )
        try:
            await runtime.token.cancelled()
        finally:
            await service.close()
            await service.watcher.stop()
