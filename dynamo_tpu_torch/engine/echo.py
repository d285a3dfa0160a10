"""Echo engines: deterministic fake engines for tests and pipeline bring-up.

The port's own copy of dynamo_tpu/engine/echo.py (the JAX CLI's
``out=echo_core`` / ``out=echo_full``), with its ``decode`` span and its
``on_token`` fault point (``DYN_FAULT=kill_after_tokens`` kills the worker
mid-stream): a model-free worker for the distributed runtime's tests and
the fault-tolerance twins.

Role-equivalent of lib/llm/src/engines.rs:66-128 (EchoEngineCore /
EchoEngineFull, ~100 tok/s paced by DYN_TOKEN_ECHO_DELAY_MS): echo_core
replays the prompt's token ids one by one; echo_full emits pre-detokenized
text (exercising the engines-that-detokenize path).
"""

from __future__ import annotations

import asyncio
import os
from typing import AsyncIterator, Optional

from dynamo_tpu_torch.pipeline.context import Context
from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
)
from dynamo_tpu_torch.telemetry import trace as dtrace
from dynamo_tpu_torch.testing import faults


def _delay_s() -> float:
    return float(os.environ.get("DYN_TOKEN_ECHO_DELAY_MS", "10")) / 1000.0


class EchoEngineCore:
    """Echoes prompt token ids back as generation output."""

    trace_proc: Optional[str] = None  # set by the worker host (run_endpoint)

    async def generate(
        self, request: PreprocessedRequest, context: Context
    ) -> AsyncIterator[LLMEngineOutput]:
        delay = _delay_s()
        # migration replay: the tail past resume_prompt_len was already
        # streamed by a previous worker — echo the ORIGINAL prompt and
        # resume the cycle where the dead worker stopped, so the stitched
        # stream is token-identical to an unfaulted run
        prompt = list(request.token_ids)
        count = 0
        resume = int(request.extra.get("resume_prompt_len") or 0)
        if 0 < resume < len(prompt):
            count = len(prompt) - resume
            prompt = prompt[:resume]
        limit = request.stop.max_tokens or len(prompt)
        with dtrace.span(
            "decode", ctx=context, proc=self.trace_proc,
            resumed_at=count or None,
        ) as sp:
            for tok in prompt[count:]:
                if faults.active():
                    # DYN_FAULT kill_after_tokens: the worker process dies
                    # exactly as a crashed decode worker would, mid-stream
                    inj = faults.get_injector()
                    if inj is not None:
                        inj.on_token()
                if context.is_stopped() or count >= limit:
                    break
                if context.expired():
                    context.kill()
                    sp.event("deadline_exceeded", phase="decode")
                    yield LLMEngineOutput.final_error(
                        context.id, "decode",
                        "deadline exceeded mid-generation",
                        "deadline_exceeded",
                    )
                    return
                await asyncio.sleep(delay)
                yield LLMEngineOutput(token_ids=[tok])
                count += 1
            sp.set(tokens=count)
        reason = (
            FinishReason.CANCELLED
            if context.is_killed()
            else (FinishReason.LENGTH if count >= limit else FinishReason.STOP)
        )
        yield LLMEngineOutput.final(reason)


class EchoEngineFull:
    """Echoes the prompt text back word by word (pre-detokenized path)."""

    def __init__(self, text_source_key: str = "echo_text") -> None:
        self.text_source_key = text_source_key

    async def generate(
        self, request: PreprocessedRequest, context: Context
    ) -> AsyncIterator[LLMEngineOutput]:
        delay = _delay_s()
        text = request.extra.get(self.text_source_key, "")
        words = text.split(" ") if text else [str(t) for t in request.token_ids]
        limit = request.stop.max_tokens or len(words)
        count = 0
        for i, w in enumerate(words):
            if context.is_stopped() or count >= limit:
                break
            await asyncio.sleep(delay)
            yield LLMEngineOutput(text=(w if i == 0 else " " + w))
            count += 1
        reason = (
            FinishReason.CANCELLED
            if context.is_killed()
            else (FinishReason.LENGTH if count >= limit else FinishReason.STOP)
        )
        yield LLMEngineOutput.final(reason)
