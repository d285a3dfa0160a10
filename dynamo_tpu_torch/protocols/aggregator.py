"""Stream -> unary aggregation: folds a stream of chunks into one response.

The port's own copy of dynamo_tpu/protocols/aggregator.py
(``ChatDeltaAggregator``, ``CompletionAggregator``): used when the client
asked for a non-streaming response but the engine always streams. The port
folds the chunks in their dict form (what the stream carries), where the
reference re-validates each one into a pydantic model first.
"""

from __future__ import annotations

from typing import Optional

from dynamo_tpu_torch.protocols.openai import (
    ChatChoice,
    ChatCompletionResponse,
    ChatMessage,
    CompletionChoice,
    CompletionResponse,
)


class ChatDeltaAggregator:
    def __init__(self) -> None:
        self.id: str = ""
        self.model: str = ""
        self.created: int = 0
        self.usage: Optional[dict] = None
        self._choices: dict[int, dict] = {}

    def add(self, chunk: dict) -> None:
        self.id = chunk.get("id") or self.id
        self.model = chunk.get("model") or self.model
        self.created = chunk.get("created") or self.created
        if chunk.get("usage"):
            self.usage = chunk["usage"]
        for c in chunk.get("choices", []):
            slot = self._choices.setdefault(
                c.get("index", 0),
                {
                    "role": None, "content": [], "finish_reason": None,
                    "tool_calls": [], "logprobs": [],
                },
            )
            delta = c.get("delta") or {}
            if delta.get("role"):
                slot["role"] = delta["role"]
            if delta.get("content"):
                slot["content"].append(delta["content"])
            if delta.get("tool_calls"):
                slot["tool_calls"].extend(delta["tool_calls"])
            lp = c.get("logprobs")
            if lp and lp.get("content"):
                slot["logprobs"].extend(lp["content"])
            if c.get("finish_reason"):
                slot["finish_reason"] = c["finish_reason"]

    def finish(self) -> ChatCompletionResponse:
        choices = [
            ChatChoice(
                index=i,
                message=ChatMessage(
                    role=slot["role"] or "assistant",
                    content="".join(slot["content"]),
                    tool_calls=slot["tool_calls"] or None,
                ),
                finish_reason=slot["finish_reason"],
                logprobs={"content": slot["logprobs"]}
                if slot["logprobs"]
                else None,
            )
            for i, slot in sorted(self._choices.items())
        ]
        kwargs = dict(id=self.id, model=self.model, choices=choices, usage=self.usage)
        if self.created:
            kwargs["created"] = self.created
        return ChatCompletionResponse(**kwargs)


class CompletionAggregator:
    def __init__(self) -> None:
        self.id = ""
        self.model = ""
        self.usage: Optional[dict] = None
        self._choices: dict[int, dict] = {}

    def add(self, chunk: dict) -> None:
        self.id = chunk.get("id") or self.id
        self.model = chunk.get("model") or self.model
        if chunk.get("usage"):
            self.usage = chunk["usage"]
        for c in chunk.get("choices", []):
            slot = self._choices.setdefault(
                c.get("index", 0), {"text": [], "finish_reason": None, "logprobs": None}
            )
            if c.get("text"):
                slot["text"].append(c["text"])
            if c.get("logprobs"):
                lp = slot["logprobs"] or {
                    "tokens": [], "token_logprobs": [],
                    "top_logprobs": [], "text_offset": [],
                }
                for key in (
                    "tokens", "token_logprobs", "top_logprobs", "text_offset"
                ):
                    lp[key].extend(c["logprobs"].get(key, []))
                slot["logprobs"] = lp
            if c.get("finish_reason"):
                slot["finish_reason"] = c["finish_reason"]

    def finish(self) -> CompletionResponse:
        return CompletionResponse(
            id=self.id,
            model=self.model,
            choices=[
                CompletionChoice(
                    index=i,
                    text="".join(slot["text"]),
                    finish_reason=slot["finish_reason"],
                    logprobs=slot["logprobs"],
                )
                for i, slot in sorted(self._choices.items())
            ],
            usage=self.usage,
        )
