"""Input modes of the port's CLI: http server, interactive text, jsonl batch.

The port's own copy of dynamo_tpu/entrypoint/inputs.py for a static local
engine (``EngineConfig.static_``, ``run_http``, ``run_text``,
``run_batch``). The reference's dynamic mode (workers found through
discovery) and ``dyn://`` endpoints wait for the port's distributed
runtime.
"""

from __future__ import annotations

import asyncio
import json
import logging
import signal
import sys
import time
from dataclasses import dataclass
from typing import Any, Optional

from dynamo_tpu_torch.http.service import HttpService, ModelExecution, ModelManager
from dynamo_tpu_torch.model_card import ModelDeploymentCard
from dynamo_tpu_torch.protocols.common import Context
from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest, ChatMessage

logger = logging.getLogger("dynamo_tpu_torch.entrypoint")


@dataclass
class EngineConfig:
    """A local engine (anything with ``generate(request, context)``) and
    the model card its frontend serves it under."""

    engine: Any
    mdc: ModelDeploymentCard
    request_template: Optional[Any] = None  # request_template.RequestTemplate

    @classmethod
    def static_(cls, engine: Any, mdc: ModelDeploymentCard) -> "EngineConfig":
        return cls(engine=engine, mdc=mdc)

    def execution(self) -> ModelExecution:
        return ModelExecution(self.mdc, self.engine.generate,
                              clear_fn=_local_clear_fn(self.engine))


def _local_clear_fn(engine: Any) -> Optional[Any]:
    """A local engine's ``clear_kv_blocks()`` (one dict) as the
    ``ModelExecution.clear_fn`` contract (a list of per-worker dicts), as
    dynamo_tpu/entrypoint/inputs.py:129-139; None when the engine has
    none."""
    inner = getattr(engine, "clear_kv_blocks", None)
    if inner is None:
        return None

    async def clear_fn() -> list[dict]:
        return [{"instance": "local", **await inner()}]

    return clear_fn


async def run_input(
    in_opt: str, config: EngineConfig, http_port: int = 8080, http_host: str = "0.0.0.0"
) -> None:
    """Dispatch on the input flavor."""
    if in_opt == "http":
        await serve_http_forever(config, http_host, http_port)
    elif in_opt in ("text", "stdin"):
        await run_text(config)
    elif in_opt.startswith("batch:"):
        await run_batch(config, in_opt[len("batch:"):])
    else:
        raise ValueError(f"unknown input {in_opt!r} (http, text or batch:FILE)")


# ------------------------------------------------------------------ http


async def run_http(config: EngineConfig, host: str = "0.0.0.0", port: int = 8080) -> HttpService:
    manager = ModelManager()
    manager.add_model(config.mdc.name, config.execution())
    service = HttpService(manager, host=host, port=port, template=config.request_template)
    await service.start()
    return service


async def serve_http_forever(config: EngineConfig, host: str, port: int) -> None:
    """Serve until SIGINT / SIGTERM, then close the server (the caller
    owns the engine)."""
    service = await run_http(config, host, port)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    print(f"serving {config.mdc.name!r} on http://{host}:{service.port}", flush=True)
    try:
        await stop.wait()
    finally:
        await service.close()


# ------------------------------------------------------------------ text


async def run_text(config: EngineConfig, prompt_once: Optional[str] = None) -> None:
    """Interactive chat REPL on stdin/stdout."""
    execution, model_name = config.execution(), config.mdc.name
    messages: list[ChatMessage] = []
    loop = asyncio.get_running_loop()

    async def one_turn(user_text: str) -> None:
        messages.append(ChatMessage(role="user", content=user_text))
        req = ChatCompletionRequest(model=model_name, messages=messages, stream=True)
        reply_parts: list[str] = []
        async for item in execution.chat_stream(req, Context()):
            if item.is_error():
                print(f"\n[error] {item.error_message()}", flush=True)
                return
            if item.data:
                for choice in item.data.get("choices", []):
                    delta = choice.get("delta", {}).get("content")
                    if delta:
                        reply_parts.append(delta)
                        print(delta, end="", flush=True)
        print()
        messages.append(ChatMessage(role="assistant", content="".join(reply_parts)))

    if prompt_once is not None:
        await one_turn(prompt_once)
        return
    print(f"chatting with {model_name} — ctrl-d to exit", flush=True)
    while True:
        line = await loop.run_in_executor(None, sys.stdin.readline)
        if not line:
            return
        line = line.strip()
        if line:
            await one_turn(line)


# ----------------------------------------------------------------- batch


async def run_batch(
    config: EngineConfig,
    path: str,
    output_path: Optional[str] = None,
    concurrency: int = 8,
) -> dict[str, Any]:
    """JSONL batch eval with TTFT/ITL stats: one chat request per line
    (``text`` or ``prompt``, optional ``max_tokens``); results go to
    ``output_path`` (default ``<path>.out.jsonl``), one JSON line each."""
    execution, model_name = config.execution(), config.mdc.name
    with open(path) as f:
        requests = [json.loads(line) for line in f if line.strip()]
    sem = asyncio.Semaphore(concurrency)
    results: list[dict[str, Any]] = [None] * len(requests)  # type: ignore[list-item]

    async def run_one(i: int, spec: dict[str, Any]) -> None:
        async with sem:
            prompt = spec.get("text") or spec.get("prompt") or ""
            req = ChatCompletionRequest(
                model=model_name,
                messages=[ChatMessage(role="user", content=prompt)],
                stream=True,
                max_tokens=spec.get("max_tokens"),
            )
            start = time.monotonic()
            first: Optional[float] = None
            last = start
            parts: list[str] = []
            itls: list[float] = []
            async for item in execution.chat_stream(req, Context()):
                if item.data:
                    for choice in item.data.get("choices", []):
                        delta = choice.get("delta", {}).get("content")
                        if delta:
                            now = time.monotonic()
                            if first is None:
                                first = now
                            else:
                                itls.append(now - last)
                            last = now
                            parts.append(delta)
            results[i] = {
                "text": "".join(parts),
                "ttft_ms": (first - start) * 1e3 if first else None,
                "itl_ms_mean": (sum(itls) / len(itls) * 1e3) if itls else None,
                "elapsed_ms": (time.monotonic() - start) * 1e3,
            }

    await asyncio.gather(*(run_one(i, s) for i, s in enumerate(requests)))
    ttfts = [r["ttft_ms"] for r in results if r and r["ttft_ms"] is not None]
    summary = {
        "num_requests": len(requests),
        "ttft_ms_mean": sum(ttfts) / len(ttfts) if ttfts else None,
        "results": results,
    }
    out_path = output_path or (path + ".out.jsonl")
    with open(out_path, "w") as f:
        for r in results:
            f.write(json.dumps(r) + "\n")
    logger.info(
        "batch done: %d requests, mean TTFT %.1f ms",
        len(requests),
        summary["ttft_ms_mean"] or -1,
    )
    return summary
