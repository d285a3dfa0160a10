"""OpenAI-compatible API types (chat completions, completions) plus the
`ext` extension block.

The port's own copy of dynamo_tpu/protocols/openai.py, with dataclasses and
explicit validation in place of pydantic (which the card's machine lacks):
the same field names, defaults, bounds and the ``nvext`` alias. A body that
breaks a rule raises ``RequestValidationError`` (a ValueError), which the
HTTP layer answers with 400 ``invalid_request_error`` as the reference does
for a pydantic ValidationError. Responses are dataclasses whose
``to_dict()`` drops None fields, as ``model_dump(exclude_none=True)`` does.
Fields a body adds beyond these are ignored, as the reference's
``extra="allow"`` models keep but never read them (a chat message keeps
its extras: templates may read them). Embeddings are not ported.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field, fields
from typing import Any, Optional, Union


class RequestValidationError(ValueError):
    """A request body that breaks the schema (HTTP 400)."""


# ------------------------------------------------------------ validation


def _fail(where: str, what: str) -> None:
    raise RequestValidationError(f"{where}: {what}")


def _opt_float(d: dict, key: str, *, ge=None, gt=None, le=None) -> Optional[float]:
    v = d.get(key)
    if v is None:
        return None
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        _fail(key, "must be a number")
    v = float(v)
    if ge is not None and not v >= ge:
        _fail(key, f"must be >= {ge}")
    if gt is not None and not v > gt:
        _fail(key, f"must be > {gt}")
    if le is not None and not v <= le:
        _fail(key, f"must be <= {le}")
    return v


def _as_int(key: str, v: Any) -> int:
    if isinstance(v, bool):
        _fail(key, "must be an integer")
    if isinstance(v, float) and v.is_integer():
        return int(v)
    if not isinstance(v, int):
        _fail(key, "must be an integer")
    return v


def _opt_int(d: dict, key: str, *, ge=None, le=None, default=None) -> Optional[int]:
    v = d.get(key, default)
    if v is None:
        return None
    v = _as_int(key, v)
    if ge is not None and v < ge:
        _fail(key, f"must be >= {ge}")
    if le is not None and v > le:
        _fail(key, f"must be <= {le}")
    return v


def _bool(d: dict, key: str, default: bool = False) -> bool:
    v = d.get(key, default)
    if isinstance(v, bool):
        return v
    if isinstance(v, int) and v in (0, 1):
        return bool(v)
    _fail(key, "must be a boolean")
    return False


def _opt_str(d: dict, key: str) -> Optional[str]:
    v = d.get(key)
    if v is not None and not isinstance(v, str):
        _fail(key, "must be a string")
    return v


def _opt_dict(d: dict, key: str) -> Optional[dict]:
    v = d.get(key)
    if v is not None and not isinstance(v, dict):
        _fail(key, "must be an object")
    return v


def _opt_list_of_dicts(d: dict, key: str) -> Optional[list]:
    v = d.get(key)
    if v is None:
        return None
    if not isinstance(v, list) or not all(isinstance(x, dict) for x in v):
        _fail(key, "must be a list of objects")
    return v


def _dump(v: Any) -> Any:
    if isinstance(v, _Dumpable):
        return v.to_dict()
    if isinstance(v, list):
        return [_dump(x) for x in v]
    return v


class _Dumpable:
    """``to_dict()``: the fields that are not None, extras after the
    declared ones, nested dataclasses dumped the same way; plain dict values
    are kept whole (pydantic's ``model_dump(exclude_none=True)``)."""

    def to_dict(self) -> dict[str, Any]:
        out = {f.name: getattr(self, f.name) for f in fields(self) if f.name != "extra"}
        out.update(getattr(self, "extra", None) or {})
        return {k: _dump(v) for k, v in out.items() if v is not None}


# --------------------------------------------------------------- requests


@dataclass
class Ext:
    """Extension block: out-of-band annotations + sampling overrides."""

    annotations: list[str] = field(default_factory=list)
    ignore_eos: bool = False
    greedy: bool = False
    timeout_ms: Optional[float] = None
    ttft_timeout_ms: Optional[float] = None
    priority: Optional[Union[str, int]] = None

    @classmethod
    def from_dict(cls, d: Any) -> "Ext":
        if not isinstance(d, dict):
            _fail("ext", "must be an object")
        ann = d.get("annotations", [])
        if not isinstance(ann, list) or not all(isinstance(a, str) for a in ann):
            _fail("ext.annotations", "must be a list of strings")
        prio = d.get("priority")
        if prio is not None and (isinstance(prio, bool) or not isinstance(prio, (str, int))):
            _fail("ext.priority", "must be a string or an integer")
        return cls(
            annotations=list(ann),
            ignore_eos=_bool(d, "ignore_eos"),
            greedy=_bool(d, "greedy"),
            timeout_ms=_opt_float(d, "timeout_ms", gt=0),
            ttft_timeout_ms=_opt_float(d, "ttft_timeout_ms", gt=0),
            priority=prio,
        )


_MESSAGE_FIELDS = ("role", "content", "name", "tool_calls", "tool_call_id")


@dataclass
class ChatMessage(_Dumpable):
    role: str
    content: Optional[Union[str, list[dict[str, Any]]]] = None
    name: Optional[str] = None
    tool_calls: Optional[list[dict[str, Any]]] = None
    tool_call_id: Optional[str] = None
    extra: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Any) -> "ChatMessage":
        if not isinstance(d, dict):
            _fail("messages", "each message must be an object")
        role = d.get("role")
        if not isinstance(role, str):
            _fail("messages.role", "is required and must be a string")
        content = d.get("content")
        if content is not None and not isinstance(content, str):
            if not isinstance(content, list) or not all(isinstance(p, dict) for p in content):
                _fail("messages.content", "must be a string or a list of parts")
        return cls(
            role=role,
            content=content,
            name=_opt_str(d, "name"),
            tool_calls=_opt_list_of_dicts(d, "tool_calls"),
            tool_call_id=_opt_str(d, "tool_call_id"),
            extra={k: v for k, v in d.items() if k not in _MESSAGE_FIELDS},
        )

    def text_content(self) -> str:
        if isinstance(self.content, str):
            return self.content
        if isinstance(self.content, list):
            return "".join(
                part.get("text", "")
                for part in self.content
                if part.get("type") == "text"
            )
        return ""


@dataclass
class _CommonSampling:
    model: str
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    repetition_penalty: Optional[float] = None
    min_tokens: Optional[int] = None
    seed: Optional[int] = None
    n: int = 1
    stream: bool = False
    stream_options: Optional[dict[str, Any]] = None
    stop: Optional[Union[str, list[str]]] = None
    logprobs: Optional[Union[bool, int]] = None
    top_logprobs: Optional[int] = None
    user: Optional[str] = None
    ext: Optional[Ext] = None

    @staticmethod
    def _common(d: Any) -> dict[str, Any]:
        if not isinstance(d, dict):
            _fail("body", "must be a JSON object")
        if "nvext" in d and "ext" not in d:
            d = dict(d)
            d["ext"] = d.pop("nvext")
        model = d.get("model")
        if not isinstance(model, str):
            _fail("model", "is required and must be a string")
        stop = d.get("stop")
        if stop is not None and not isinstance(stop, str):
            if not isinstance(stop, list) or not all(isinstance(s, str) for s in stop):
                _fail("stop", "must be a string or a list of strings")
        lp = d.get("logprobs")
        if lp is not None and not isinstance(lp, bool):
            lp = _as_int("logprobs", lp)
        ext = d.get("ext")
        return dict(
            model=model,
            temperature=_opt_float(d, "temperature", ge=0.0, le=2.0),
            top_p=_opt_float(d, "top_p", gt=0.0, le=1.0),
            top_k=_opt_int(d, "top_k", ge=0),
            frequency_penalty=_opt_float(d, "frequency_penalty", ge=-2.0, le=2.0),
            presence_penalty=_opt_float(d, "presence_penalty", ge=-2.0, le=2.0),
            repetition_penalty=_opt_float(d, "repetition_penalty", gt=0.0, le=2.0),
            min_tokens=_opt_int(d, "min_tokens", ge=0),
            seed=_opt_int(d, "seed"),
            n=_opt_int(d, "n", ge=1, le=16, default=1),
            stream=_bool(d, "stream"),
            stream_options=_opt_dict(d, "stream_options"),
            stop=stop,
            logprobs=lp,
            top_logprobs=_opt_int(d, "top_logprobs", ge=0, le=20),
            user=_opt_str(d, "user"),
            ext=None if ext is None else Ext.from_dict(ext),
        )

    def stop_list(self) -> list[str]:
        if self.stop is None:
            return []
        return [self.stop] if isinstance(self.stop, str) else list(self.stop)


@dataclass
class ChatCompletionRequest(_CommonSampling):
    messages: list[ChatMessage] = field(default_factory=list)
    max_tokens: Optional[int] = None
    max_completion_tokens: Optional[int] = None
    tools: Optional[list[dict[str, Any]]] = None
    tool_choice: Optional[Union[str, dict[str, Any]]] = None
    response_format: Optional[dict[str, Any]] = None

    @classmethod
    def from_dict(cls, d: Any) -> "ChatCompletionRequest":
        common = cls._common(d)
        msgs = d.get("messages")
        if not isinstance(msgs, list):
            _fail("messages", "is required and must be a list")
        choice = d.get("tool_choice")
        if choice is not None and not isinstance(choice, (str, dict)):
            _fail("tool_choice", "must be a string or an object")
        return cls(
            **common,
            messages=[ChatMessage.from_dict(m) for m in msgs],
            max_tokens=_opt_int(d, "max_tokens", ge=1),
            max_completion_tokens=_opt_int(d, "max_completion_tokens", ge=1),
            tools=_opt_list_of_dicts(d, "tools"),
            tool_choice=choice,
            response_format=_opt_dict(d, "response_format"),
        )

    def output_limit(self) -> Optional[int]:
        return self.max_completion_tokens or self.max_tokens


def _is_int(x: Any) -> bool:
    return isinstance(x, int) and not isinstance(x, bool)


@dataclass
class CompletionRequest(_CommonSampling):
    prompt: Union[str, list[str], list[int], list[list[int]]] = ""
    max_tokens: Optional[int] = 16
    echo: bool = False

    @classmethod
    def from_dict(cls, d: Any) -> "CompletionRequest":
        common = cls._common(d)
        if "prompt" not in d:
            _fail("prompt", "is required")
        p = d["prompt"]
        ok = isinstance(p, str) or (
            isinstance(p, list) and (
                all(isinstance(x, str) for x in p)
                or all(_is_int(x) for x in p)
                or all(isinstance(x, list) and all(_is_int(t) for t in x) for x in p)
            )
        )
        if not ok:
            _fail("prompt", "must be a string, a list of strings, or token ids")
        return cls(
            **common,
            prompt=p,
            max_tokens=_opt_int(d, "max_tokens", ge=1, default=16),
            echo=_bool(d, "echo"),
        )

    def output_limit(self) -> Optional[int]:
        return self.max_tokens


@dataclass
class EmbeddingRequest:
    """``POST /v1/embeddings`` (the reference's ``EmbeddingRequest``): a
    string, a list of strings, token ids, or a list of token-id lists."""

    model: str
    input: Union[str, list[str], list[int], list[list[int]]]
    encoding_format: str = "float"

    @classmethod
    def from_dict(cls, d: Any) -> "EmbeddingRequest":
        if not isinstance(d, dict):
            _fail("body", "must be a JSON object")
        model = d.get("model")
        if not isinstance(model, str):
            _fail("model", "is required and must be a string")
        if "input" not in d:
            _fail("input", "is required")
        x = d["input"]
        ok = isinstance(x, str) or (
            isinstance(x, list) and (
                all(isinstance(i, str) for i in x)
                or all(_is_int(i) for i in x)
                or all(isinstance(i, list) and all(_is_int(t) for t in i) for i in x)
            )
        )
        if not ok:
            _fail("input", "must be a string, a list of strings, or token ids")
        fmt = d.get("encoding_format", "float")
        if not isinstance(fmt, str):
            _fail("encoding_format", "must be a string")
        return cls(model=model, input=x, encoding_format=fmt)


# -------------------------------------------------------------- responses


def _now() -> int:
    return int(time.time())


def gen_request_id(prefix: str = "chatcmpl") -> str:
    return f"{prefix}-{uuid.uuid4().hex}"


@dataclass
class ChoiceDelta(_Dumpable):
    role: Optional[str] = None
    content: Optional[str] = None
    tool_calls: Optional[list[dict[str, Any]]] = None


@dataclass
class StreamChoice(_Dumpable):
    index: int = 0
    delta: ChoiceDelta = field(default_factory=ChoiceDelta)
    finish_reason: Optional[str] = None
    logprobs: Optional[dict[str, Any]] = None


@dataclass
class ChatCompletionChunk(_Dumpable):
    id: str
    object: str = "chat.completion.chunk"
    created: int = field(default_factory=_now)
    model: str = ""
    choices: list[StreamChoice] = field(default_factory=list)
    usage: Optional[dict[str, Any]] = None


@dataclass
class ChatChoice(_Dumpable):
    index: int = 0
    message: ChatMessage = field(default_factory=lambda: ChatMessage(role="assistant"))
    finish_reason: Optional[str] = None
    logprobs: Optional[dict[str, Any]] = None


@dataclass
class ChatCompletionResponse(_Dumpable):
    id: str
    object: str = "chat.completion"
    created: int = field(default_factory=_now)
    model: str = ""
    choices: list[ChatChoice] = field(default_factory=list)
    usage: Optional[dict[str, Any]] = None


@dataclass
class CompletionChoice(_Dumpable):
    index: int = 0
    text: str = ""
    finish_reason: Optional[str] = None
    logprobs: Optional[dict[str, Any]] = None


@dataclass
class CompletionResponse(_Dumpable):
    id: str
    object: str = "text_completion"
    created: int = field(default_factory=_now)
    model: str = ""
    choices: list[CompletionChoice] = field(default_factory=list)
    usage: Optional[dict[str, Any]] = None


@dataclass
class ModelInfo(_Dumpable):
    id: str
    object: str = "model"
    created: int = field(default_factory=_now)
    owned_by: str = "dynamo_tpu"


@dataclass
class ModelList(_Dumpable):
    object: str = "list"
    data: list[ModelInfo] = field(default_factory=list)


def usage_dict(prompt_tokens: int, completion_tokens: int) -> dict[str, int]:
    return {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion_tokens,
        "total_tokens": prompt_tokens + completion_tokens,
    }
