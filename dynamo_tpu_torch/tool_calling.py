"""Tool-call output parsing: generated text -> OpenAI `tool_calls`.

The port's own copy of dynamo_tpu/tool_calling.py.

Role-equivalent of lib/llm/src/preprocessor/tools.rs:371 (the reference's
tool-call parser registry): models emit tool invocations in model-family-
specific wire formats inside ordinary generated text; the serving layer
must recognize and lift them into structured `tool_calls` so clients get
the OpenAI contract. Supported formats (auto-detected by default):

  * hermes     — `<tool_call>{"name": ..., "arguments": {...}}</tool_call>`
                 (Qwen/Nous-Hermes family)
  * llama3     — raw JSON object(s): `{"name": ..., "parameters": {...}}`
                 (Llama-3.x JSON tool calling)
  * mistral    — `[TOOL_CALLS] [{"name": ..., "arguments": {...}}, ...]`

Parsing is end-of-stream: the HTTP layer buffers a choice's text when the
request declares `tools`, then either lifts the parse into `tool_calls`
deltas (finish_reason "tool_calls") or releases the text untouched.
"""

from __future__ import annotations

import json
import re
import uuid
from dataclasses import dataclass
from typing import Any, Optional


@dataclass
class ParsedToolCall:
    name: str
    arguments: dict[str, Any]

    def to_openai(self, index: int = 0) -> dict[str, Any]:
        return {
            "index": index,
            "id": f"call_{uuid.uuid4().hex[:24]}",
            "type": "function",
            "function": {
                "name": self.name,
                "arguments": json.dumps(self.arguments),
            },
        }


_HERMES_RE = re.compile(r"<tool_call>\s*(\{.*?\})\s*</tool_call>", re.DOTALL)
_MISTRAL_RE = re.compile(r"\[TOOL_CALLS\]\s*(\[.*\]|\{.*\})", re.DOTALL)


def _coerce(obj: Any) -> Optional[ParsedToolCall]:
    if not isinstance(obj, dict) or "name" not in obj:
        return None
    args = obj.get("arguments", obj.get("parameters", {}))
    if isinstance(args, str):
        try:
            args = json.loads(args)
        except json.JSONDecodeError:
            args = {"__raw": args}
    if not isinstance(args, dict):
        return None
    return ParsedToolCall(name=str(obj["name"]), arguments=args)


def _parse_hermes(text: str) -> Optional[list[ParsedToolCall]]:
    calls = []
    for m in _HERMES_RE.finditer(text):
        try:
            c = _coerce(json.loads(m.group(1)))
        except json.JSONDecodeError:
            return None
        if c is None:
            return None
        calls.append(c)
    return calls or None


def _parse_mistral(text: str) -> Optional[list[ParsedToolCall]]:
    m = _MISTRAL_RE.search(text)
    if not m:
        return None
    try:
        data = json.loads(m.group(1))
    except json.JSONDecodeError:
        return None
    items = data if isinstance(data, list) else [data]
    calls = [_coerce(x) for x in items]
    if not calls or any(c is None for c in calls):
        return None
    return calls  # type: ignore[return-value]


def _parse_llama3_json(text: str) -> Optional[list[ParsedToolCall]]:
    """Bare JSON tool calls: the whole (stripped) output is one JSON object
    or array with name+parameters — the llama3.1 JSON tool format. Also
    accepts the `<|python_tag|>` prefix some templates emit."""
    s = text.strip()
    if s.startswith("<|python_tag|>"):
        s = s[len("<|python_tag|>"):].strip()
    if not (s.startswith("{") or s.startswith("[")):
        return None
    # a semicolon-separated run of objects is emitted by some templates
    candidates = [s]
    if s.startswith("{") and "};" in s:
        candidates = [p if p.endswith("}") else p + "}" for p in s.split("};")]
    calls: list[ParsedToolCall] = []
    for cand in candidates:
        try:
            data = json.loads(cand)
        except json.JSONDecodeError:
            return None
        items = data if isinstance(data, list) else [data]
        for x in items:
            c = _coerce(x)
            if c is None:
                return None
            calls.append(c)
    return calls or None


_PARSERS = {
    "hermes": _parse_hermes,
    "mistral": _parse_mistral,
    "llama3_json": _parse_llama3_json,
}


def parse_tool_calls(
    text: str, parser: str = "auto"
) -> Optional[list[ParsedToolCall]]:
    """Parse generated text into tool calls, or None if it isn't one.
    `parser` selects a specific format; "auto" tries each in order."""
    if parser != "auto":
        fn = _PARSERS.get(parser)
        if fn is None:
            raise ValueError(f"unknown tool parser {parser!r}")
        return fn(text)
    for fn in (_parse_hermes, _parse_mistral, _parse_llama3_json):
        calls = fn(text)
        if calls:
            return calls
    return None
