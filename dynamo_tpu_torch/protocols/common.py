"""Engine-side request/response types of the port.

Own copy of dynamo_tpu/protocols/common.py (the port imports nothing of the
JAX package): PreprocessedRequest in (token ids plus sampling and stop
options), LLMEngineOutput frames out, with the same to_dict / from_dict so
the wire shapes match. ``Context`` (``pipeline/context.py``: request id,
metadata, deadlines, stop / kill cancellation, children and its wire form)
is re-exported here, where the engine, the HTTP frontend and the disagg
modules import it from.
"""

from __future__ import annotations

import enum
from dataclasses import asdict, dataclass, field
from typing import Any, Optional

from dynamo_tpu_torch.pipeline.context import Context  # noqa: F401 (re-exported)


class FinishReason(str, enum.Enum):
    STOP = "stop"
    LENGTH = "length"
    EOS = "eos"
    STOP_SEQUENCE = "stop_sequence"
    CANCELLED = "cancelled"
    ERROR = "error"

    def as_openai(self) -> str:
        if self in (FinishReason.EOS, FinishReason.STOP_SEQUENCE):
            return "stop"
        if self is FinishReason.LENGTH:
            return "length"
        return self.value


@dataclass
class SamplingOptions:
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    repetition_penalty: Optional[float] = None
    seed: Optional[int] = None
    n: int = 1
    greedy: bool = False
    # logprob surface (openai `logprobs`/`top_logprobs`)
    logprobs: bool = False
    top_logprobs: int = 0

    def to_dict(self) -> dict[str, Any]:
        return {k: v for k, v in asdict(self).items() if v is not None}

    @classmethod
    def from_dict(cls, d: Optional[dict[str, Any]]) -> "SamplingOptions":
        if not d:
            return cls()
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass
class StopConditions:
    max_tokens: Optional[int] = None
    stop: list[str] = field(default_factory=list)  # visible stop strings
    stop_token_ids_hidden: list[int] = field(default_factory=list)
    min_tokens: Optional[int] = None
    ignore_eos: bool = False

    def to_dict(self) -> dict[str, Any]:
        return {k: v for k, v in asdict(self).items() if v not in (None, [])}

    @classmethod
    def from_dict(cls, d: Optional[dict[str, Any]]) -> "StopConditions":
        if not d:
            return cls()
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass
class PreprocessedRequest:
    """The tokenized request handed to routers and engines."""

    token_ids: list[int]
    model: str = ""
    sampling: SamplingOptions = field(default_factory=SamplingOptions)
    stop: StopConditions = field(default_factory=StopConditions)
    eos_token_ids: list[int] = field(default_factory=list)
    annotations: list[str] = field(default_factory=list)  # requested annotations
    # router hints
    estimated_prefix_hit_blocks: int = 0
    extra: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return {
            "token_ids": self.token_ids,
            "model": self.model,
            "sampling": self.sampling.to_dict(),
            "stop": self.stop.to_dict(),
            "eos_token_ids": self.eos_token_ids,
            "annotations": self.annotations,
            "estimated_prefix_hit_blocks": self.estimated_prefix_hit_blocks,
            "extra": self.extra,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "PreprocessedRequest":
        return cls(
            token_ids=list(d.get("token_ids", [])),
            model=d.get("model", ""),
            sampling=SamplingOptions.from_dict(d.get("sampling")),
            stop=StopConditions.from_dict(d.get("stop")),
            eos_token_ids=list(d.get("eos_token_ids", [])),
            annotations=list(d.get("annotations", [])),
            estimated_prefix_hit_blocks=d.get("estimated_prefix_hit_blocks", 0),
            extra=d.get("extra", {}) or {},
        )


@dataclass
class LLMEngineOutput:
    """One streamed engine step result (a delta, token-space)."""

    token_ids: list[int] = field(default_factory=list)
    text: Optional[str] = None  # engines that detokenize themselves
    cum_log_probs: Optional[float] = None
    finish_reason: Optional[FinishReason] = None
    index: int = 0  # choice index for n>1
    # per-token logprob of each id in token_ids (when requested)
    log_probs: Optional[list[float]] = None
    # per-token top-K alternatives: [[(token_id, logprob), ...], ...]
    top_logprobs: Optional[list[list[list[float]]]] = None
    # structured failure payload on ERROR finals: {"request_id", "phase",
    # "cause", "code"} — reaches the SSE stream as a typed error event
    error: Optional[dict[str, Any]] = None
    # completed telemetry spans riding the FINAL frame back to the caller
    # (worker -> frontend trace assembly; stripped before the HTTP layer)
    trace: Optional[list] = None
    # worker-side decision records riding the FINAL frame next to `trace`
    # (worker -> frontend provenance assembly; same lifecycle)
    decisions: Optional[list] = None

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {"token_ids": self.token_ids, "index": self.index}
        if self.text is not None:
            out["text"] = self.text
        if self.cum_log_probs is not None:
            out["cum_log_probs"] = self.cum_log_probs
        if self.finish_reason is not None:
            out["finish_reason"] = self.finish_reason.value
        if self.log_probs is not None:
            out["log_probs"] = self.log_probs
        if self.top_logprobs is not None:
            out["top_logprobs"] = self.top_logprobs
        if self.error is not None:
            out["error"] = self.error
        if self.trace is not None:
            out["trace"] = self.trace
        if self.decisions is not None:
            out["decisions"] = self.decisions
        return out

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "LLMEngineOutput":
        fr = d.get("finish_reason")
        return cls(
            token_ids=list(d.get("token_ids", [])),
            text=d.get("text"),
            cum_log_probs=d.get("cum_log_probs"),
            finish_reason=FinishReason(fr) if fr else None,
            index=d.get("index", 0),
            log_probs=d.get("log_probs"),
            top_logprobs=d.get("top_logprobs"),
            error=d.get("error"),
            trace=d.get("trace"),
            decisions=d.get("decisions"),
        )

    @classmethod
    def final(cls, reason: FinishReason) -> "LLMEngineOutput":
        return cls(finish_reason=reason)

    @classmethod
    def final_error(
        cls,
        request_id: str,
        phase: str,
        cause: str,
        code: str = "internal_error",
    ) -> "LLMEngineOutput":
        """An ERROR final carrying a structured, per-sequence failure
        payload (request id, pipeline phase, cause, machine-readable code)
        instead of a bare finish reason."""
        return cls(
            finish_reason=FinishReason.ERROR,
            error={
                "request_id": request_id,
                "phase": phase,
                "cause": cause,
                "code": code,
            },
        )
