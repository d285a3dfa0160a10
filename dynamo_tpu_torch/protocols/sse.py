"""Server-sent-events codec.

The port's own copy of dynamo_tpu/protocols/sse.py (the port imports nothing of the JAX
package).

Role-equivalent of lib/llm/src/protocols/codec.rs (SseLineCodec :53) — both
directions: encoding Annotated/model chunks as SSE for HTTP responses, and
parsing SSE streams (used by clients and tests).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Optional

DONE_SENTINEL = "[DONE]"


@dataclass
class SseEvent:
    data: Optional[str] = None
    event: Optional[str] = None
    comments: list[str] = field(default_factory=list)
    id: Optional[str] = None

    def encode(self) -> str:
        lines: list[str] = []
        for c in self.comments:
            lines.append(f": {c}")
        if self.event is not None:
            lines.append(f"event: {self.event}")
        if self.id is not None:
            lines.append(f"id: {self.id}")
        if self.data is not None:
            for chunk in self.data.split("\n"):
                lines.append(f"data: {chunk}")
        return "\n".join(lines) + "\n\n"

    def is_done(self) -> bool:
        return self.data is not None and self.data.strip() == DONE_SENTINEL

    def json(self) -> Any:
        return json.loads(self.data) if self.data else None


def encode_json_event(obj: Any, event: Optional[str] = None) -> str:
    return SseEvent(data=json.dumps(obj, separators=(",", ":")), event=event).encode()


def encode_done() -> str:
    return SseEvent(data=DONE_SENTINEL).encode()


class SseParser:
    """Incremental SSE parser: feed text chunks, yields complete SseEvents."""

    def __init__(self) -> None:
        self._buffer = ""

    def feed(self, text: str) -> list[SseEvent]:
        self._buffer += text
        events: list[SseEvent] = []
        while "\n\n" in self._buffer:
            raw, self._buffer = self._buffer.split("\n\n", 1)
            ev = self._parse_block(raw)
            if ev is not None:
                events.append(ev)
        return events

    @staticmethod
    def _parse_block(block: str) -> Optional[SseEvent]:
        ev = SseEvent()
        data_lines: list[str] = []
        seen = False
        for line in block.split("\n"):
            if not line.strip():
                continue
            seen = True
            if line.startswith(":"):
                ev.comments.append(line[1:].strip())
            elif line.startswith("event:"):
                ev.event = line[len("event:") :].strip()
            elif line.startswith("id:"):
                ev.id = line[len("id:") :].strip()
            elif line.startswith("data:"):
                data_lines.append(line[len("data:") :].lstrip())
        if not seen:
            return None
        if data_lines:
            ev.data = "\n".join(data_lines)
        return ev


async def parse_sse_stream(
    chunks: AsyncIterator[bytes],
) -> AsyncIterator[SseEvent]:
    parser = SseParser()
    async for chunk in chunks:
        for ev in parser.feed(chunk.decode("utf-8", errors="replace")):
            yield ev
