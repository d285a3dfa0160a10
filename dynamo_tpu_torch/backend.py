"""Backend: incremental detokenization + stop-condition handling on the
engine's token-delta stream.

The port's own copy of dynamo_tpu/backend.py (``SequenceDecoder``,
``Backend``): engines emit token ids; this turns them into text deltas,
detects visible stop strings across chunk boundaries (holding back --
"jailing" -- text that might be the prefix of a stop sequence until it is
disambiguated), recognizes hidden eos tokens, and enforces max_tokens.
``detokenize`` is the plain async form of the reference's
``DetokenizeOperator`` pipeline node.
"""

from __future__ import annotations

import asyncio
import contextlib
from dataclasses import dataclass
from typing import AsyncIterator, Callable, Optional

from dynamo_tpu_torch.protocols.common import (
    Context,
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
    StopConditions,
)
from dynamo_tpu_torch.telemetry import trace as dtrace
from dynamo_tpu_torch.tokenizer import TokenizerWrapper

# engine_fn(PreprocessedRequest, Context) -> AsyncIterator[LLMEngineOutput]
EngineFn = Callable[[PreprocessedRequest, Context], AsyncIterator[LLMEngineOutput]]


@dataclass
class StepResult:
    text: str = ""
    finish_reason: Optional[FinishReason] = None
    tokens_emitted: int = 0
    # OpenAI chat logprobs content entries for tokens emitted this step
    # ({"token", "logprob", "bytes", "top_logprobs"}), when requested
    logprobs: Optional[list[dict]] = None
    # structured failure payload riding an ERROR final (LLMEngineOutput.error)
    error: Optional[dict] = None


class SequenceDecoder:
    """Per-request decoder state (one choice index)."""

    def __init__(
        self,
        tokenizer: TokenizerWrapper,
        stop: StopConditions,
        eos_token_ids: list[int],
    ) -> None:
        self._tokenizer = tokenizer
        self._stream = tokenizer.decode_stream()
        self._stop = stop
        self._eos = set(eos_token_ids) | set(stop.stop_token_ids_hidden)
        self._stop_seqs = list(stop.stop)
        self._max_hold = max((len(s) for s in self._stop_seqs), default=0)
        self._jail = ""  # held-back text possibly prefixing a stop sequence
        self._emitted_tokens = 0
        self.finished: Optional[FinishReason] = None

    def _scan_stop(self, text: str) -> tuple[str, bool]:
        """Returns (releasable_text, hit). Keeps a possible stop-seq prefix
        jailed in self._jail."""
        if not self._stop_seqs:
            return text, False
        buf = self._jail + text
        for seq in self._stop_seqs:
            idx = buf.find(seq)
            if idx != -1:
                self._jail = ""
                return buf[:idx], True  # visible text before the stop string
        # keep the longest tail that could still grow into a stop sequence
        hold = 0
        for seq in self._stop_seqs:
            for k in range(min(len(seq) - 1, len(buf)), 0, -1):
                if buf.endswith(seq[:k]):
                    hold = max(hold, k)
                    break
        if hold:
            self._jail = buf[-hold:]
            return buf[:-hold], False
        self._jail = ""
        return buf, False

    def step(self, output: LLMEngineOutput) -> StepResult:
        """Fold one engine delta; returns text to emit + finish state."""
        if self.finished is not None:
            return StepResult(finish_reason=self.finished)
        result = StepResult()
        if output.text is not None:
            # engine already detokenized (e.g. echo_full)
            pieces = output.text
            released, hit = self._scan_stop(pieces)
            result.text += released
            self._emitted_tokens += max(len(output.token_ids), 1)
            result.tokens_emitted += max(len(output.token_ids), 1)
            if hit:
                self.finished = FinishReason.STOP_SEQUENCE
        else:
            for j, tok in enumerate(output.token_ids):
                if not self._stop.ignore_eos and tok in self._eos:
                    self.finished = FinishReason.EOS
                    break
                piece = self._stream.step(tok)
                self._emitted_tokens += 1
                result.tokens_emitted += 1
                if output.log_probs is not None and j < len(output.log_probs):
                    entry = self._logprob_entry(
                        tok,
                        piece,
                        output.log_probs[j],
                        output.top_logprobs[j]
                        if output.top_logprobs and j < len(output.top_logprobs)
                        else None,
                    )
                    result.logprobs = (result.logprobs or []) + [entry]
                if piece:
                    released, hit = self._scan_stop(piece)
                    result.text += released
                    if hit:
                        self.finished = FinishReason.STOP_SEQUENCE
                        break
                if (
                    self._stop.max_tokens is not None
                    and self._emitted_tokens >= self._stop.max_tokens
                ):
                    self.finished = FinishReason.LENGTH
                    break
        if self.finished is None and output.finish_reason is not None:
            self.finished = output.finish_reason
        result.finish_reason = self.finished
        if output.error is not None:
            result.error = output.error
        return result

    def _logprob_entry(
        self,
        token_id: int,
        piece: str,
        logprob: float,
        top: Optional[list],
    ) -> dict:
        """One OpenAI chat-logprobs content entry (openai.rs logprobs
        surface). `piece` may be '' when the byte-level stream is holding
        back an incomplete codepoint — fall back to a solo decode."""
        text = piece or self._decode_one(token_id)
        entry: dict = {
            "token": text,
            "logprob": float(logprob),
            "bytes": list(text.encode("utf-8")),
        }
        if top:
            entry["top_logprobs"] = [
                {
                    "token": self._decode_one(int(tid)),
                    "logprob": float(lp),
                    "bytes": list(self._decode_one(int(tid)).encode("utf-8")),
                }
                for tid, lp in top
            ]
        return entry

    def _decode_one(self, token_id: int) -> str:
        try:
            return self._tokenizer.decode([token_id], skip_special_tokens=False)
        except Exception:  # noqa: BLE001 — display-only fallback
            return f"<{token_id}>"

    @property
    def emitted_tokens(self) -> int:
        return self._emitted_tokens


class Backend:
    """Factory wiring SequenceDecoders per request/choice."""

    def __init__(self, tokenizer: TokenizerWrapper) -> None:
        self.tokenizer = tokenizer

    def decoder(
        self, stop: StopConditions, eos_token_ids: list[int]
    ) -> SequenceDecoder:
        return SequenceDecoder(self.tokenizer, stop, eos_token_ids)


async def detokenize(
    backend: Backend, engine_fn: EngineFn, request: PreprocessedRequest, ctx: Context
) -> AsyncIterator[StepResult]:
    """Fold each engine delta of one request through a SequenceDecoder and
    yield the StepResults, up to and including the first with a finish
    reason; the engine stream is closed right after (not at GC), so the
    engine frees the sequence at once."""
    decoder = backend.decoder(request.stop, request.eos_token_ids)
    agen = engine_fn(request, ctx)
    try:
        async for out in agen:
            step = decoder.step(out)
            if (step.finish_reason is FinishReason.LENGTH and out.finish_reason is None
                    and dtrace.enabled()):
                # max_tokens counted here, one frame before the engine's own
                # LENGTH final: with tracing on, drain briefly toward that
                # final so the worker's spans (they ride it) are consumed
                # (backend.py:203-215). Bounded; no change with DYN_TRACE=0.
                await _drain_for_final(agen)
            yield step
            if step.finish_reason is not None:
                return
    finally:
        with contextlib.suppress(Exception):
            await agen.aclose()


async def _drain_for_final(agen, frames: int = 4, timeout_s: float = 0.25) -> None:
    with contextlib.suppress(StopAsyncIteration, asyncio.TimeoutError, Exception):
        for _ in range(frames):
            out = await asyncio.wait_for(agen.__anext__(), timeout_s)
            if out.finish_reason is not None:
                return
