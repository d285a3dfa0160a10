"""OpenAI -> token-space preprocessor and token-space -> OpenAI delta
generation.

The port's own copy of dynamo_tpu/preprocessor.py (``OpenAIPreprocessor``,
``ChatDeltaGenerator``, ``CompletionDeltaGenerator``): chat template +
tokenize -> PreprocessedRequest, and the OpenAI chunks built from the
detokenized engine deltas, with the same annotation events
("formatted_prompt", "token_ids"), and the tool-call chunks of a request
that declares tools (``tool_calls_chunk``, the ``tool_calls`` finish).
Multimodal content parts: ``image_url`` / ``video_url`` parts are lifted
out of the template (the text renders alone) into ``extra["mm_images"]`` /
``extra["mm_videos"]``, which ``multimodal/worker.MultimodalEngine`` turns
into vision embeddings over placeholder tokens.
"""

from __future__ import annotations

import time
from typing import Optional, Union

from dynamo_tpu_torch.model_card import ModelDeploymentCard
from dynamo_tpu_torch.pipeline.annotated import Annotated
from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.protocols.openai import (
    ChatCompletionChunk,
    ChatCompletionRequest,
    ChoiceDelta,
    CompletionChoice,
    CompletionRequest,
    CompletionResponse,
    StreamChoice,
    gen_request_id,
    usage_dict,
)

ANNOTATION_FORMATTED_PROMPT = "formatted_prompt"
ANNOTATION_TOKEN_IDS = "token_ids"


class OpenAIPreprocessor:
    def __init__(self, mdc: ModelDeploymentCard) -> None:
        self.mdc = mdc
        self.tokenizer = mdc.load_tokenizer()
        self.template = mdc.load_chat_template()

    # -------------------------------------------------------- forward

    def preprocess_chat(
        self, request: ChatCompletionRequest
    ) -> tuple[PreprocessedRequest, str]:
        messages = []
        image_urls: list[str] = []
        video_urls: list[str] = []
        for m in request.messages:
            d = m.to_dict()
            if isinstance(d.get("content"), list):
                for part in d["content"]:
                    if isinstance(part, dict) and part.get("type") in ("image_url", "video_url"):
                        url = part.get(part["type"])
                        if isinstance(url, dict):
                            url = url.get("url")
                        if url:
                            (video_urls if part["type"] == "video_url" else image_urls).append(url)
                d["content"] = m.text_content()
            messages.append(d)
        prompt = self.template.render(
            messages,
            add_generation_prompt=True,
            tools=request.tools,
        )
        enc = self.tokenizer.encode(prompt)
        pre = self._build(request, enc.ids, request.output_limit())
        if image_urls:
            pre.extra["mm_images"] = image_urls
        if video_urls:
            pre.extra["mm_videos"] = video_urls
        return pre, prompt

    def preprocess_completion(
        self, request: CompletionRequest
    ) -> tuple[PreprocessedRequest, str]:
        prompt = request.prompt
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], int):
            token_ids = list(prompt)
            text = ""
        else:
            if isinstance(prompt, list):
                prompt = prompt[0] if prompt else ""
            text = str(prompt)
            token_ids = self.tokenizer.encode(text).ids
        return self._build(request, token_ids, request.output_limit()), text

    def _build(
        self,
        request: Union[ChatCompletionRequest, CompletionRequest],
        token_ids: list[int],
        max_tokens: Optional[int],
    ) -> PreprocessedRequest:
        ext = request.ext
        # logprobs: chat uses (logprobs: bool, top_logprobs: int); legacy
        # completions uses (logprobs: int = top-N). Normalize both.
        lp = request.logprobs
        want_logprobs = lp is not None and lp is not False
        if request.top_logprobs is not None:
            num_top = request.top_logprobs
        elif isinstance(lp, int) and not isinstance(lp, bool):
            num_top = lp
        else:
            num_top = 0
        sampling = SamplingOptions(
            temperature=request.temperature,
            top_p=request.top_p,
            top_k=request.top_k,
            frequency_penalty=request.frequency_penalty,
            presence_penalty=request.presence_penalty,
            repetition_penalty=request.repetition_penalty,
            seed=request.seed,
            n=request.n,
            greedy=bool(ext and ext.greedy),
            logprobs=want_logprobs,
            top_logprobs=num_top,
        )
        budget = self.mdc.context_length - len(token_ids)
        if max_tokens is None:
            max_tokens = max(1, budget)
        stop = StopConditions(
            max_tokens=max_tokens,
            stop=request.stop_list(),
            min_tokens=request.min_tokens,
            ignore_eos=bool(ext and ext.ignore_eos),
        )
        pre = PreprocessedRequest(
            token_ids=token_ids,
            model=request.model,
            sampling=sampling,
            stop=stop,
            eos_token_ids=self.tokenizer.eos_token_ids,
            annotations=list(ext.annotations) if ext else [],
        )
        if ext is not None and ext.priority is not None:
            # the raw ext stamp; the HTTP edge resolves the class (header >
            # ext > DYN_PRIORITY_DEFAULT) through qos.stamp_priority
            pre.extra["priority"] = ext.priority
        return pre

    def requested_annotations(
        self, preprocessed: PreprocessedRequest, prompt: str
    ) -> list[Annotated]:
        out: list[Annotated] = []
        if ANNOTATION_FORMATTED_PROMPT in preprocessed.annotations:
            out.append(Annotated.from_annotation(ANNOTATION_FORMATTED_PROMPT, prompt))
        if ANNOTATION_TOKEN_IDS in preprocessed.annotations:
            out.append(
                Annotated.from_annotation(ANNOTATION_TOKEN_IDS, preprocessed.token_ids)
            )
        return out


class ChatDeltaGenerator:
    """Folds detokenized engine deltas into OpenAI chat.completion.chunk's."""

    def __init__(self, model: str, request_id: Optional[str] = None) -> None:
        self.id = request_id or gen_request_id("chatcmpl")
        self.model = model
        self.created = int(time.time())

    def _chunk(self, choices: list[StreamChoice], usage: Optional[dict] = None) -> ChatCompletionChunk:
        return ChatCompletionChunk(
            id=self.id, model=self.model, created=self.created, choices=choices, usage=usage,
        )

    def role_chunk(self, index: int = 0) -> ChatCompletionChunk:
        return self._chunk([StreamChoice(index=index, delta=ChoiceDelta(role="assistant"))])

    def text_chunk(
        self,
        text: str,
        index: int = 0,
        logprobs: Optional[list[dict]] = None,
    ) -> ChatCompletionChunk:
        return self._chunk([
            StreamChoice(
                index=index,
                delta=ChoiceDelta(content=text),
                logprobs={"content": logprobs} if logprobs else None,
            )
        ])

    def tool_calls_chunk(self, calls: list[dict], index: int = 0) -> ChatCompletionChunk:
        """Structured tool-call deltas lifted from generated text
        (tool_calling.parse_tool_calls)."""
        return self._chunk([StreamChoice(index=index, delta=ChoiceDelta(tool_calls=calls))])

    def finish_chunk(self, reason: FinishReason, index: int = 0,
                     literal: Optional[str] = None) -> ChatCompletionChunk:
        """``literal`` overrides the finish reason's OpenAI string
        (``"tool_calls"``)."""
        return self._chunk([
            StreamChoice(index=index, delta=ChoiceDelta(),
                         finish_reason=literal or reason.as_openai())
        ])

    def usage_chunk(self, prompt_tokens: int, completion_tokens: int) -> ChatCompletionChunk:
        return self._chunk([], usage=usage_dict(prompt_tokens, completion_tokens))


class CompletionDeltaGenerator:
    """Streamed `text_completion` chunks (OpenAI completions API)."""

    def __init__(self, model: str, request_id: Optional[str] = None) -> None:
        self.id = request_id or gen_request_id("cmpl")
        self.model = model
        self.created = int(time.time())
        # running character offset per choice index — the legacy logprobs
        # contract is four PARALLEL arrays, so text_offset must track
        # tokens 1:1 across streamed chunks
        self._char_off: dict[int, int] = {}

    def _chunk(self, choices: list[CompletionChoice], usage: Optional[dict] = None) -> CompletionResponse:
        return CompletionResponse(
            id=self.id, model=self.model, created=self.created, choices=choices, usage=usage,
        )

    def usage_chunk(self, prompt_tokens: int, completion_tokens: int) -> CompletionResponse:
        return self._chunk([], usage=usage_dict(prompt_tokens, completion_tokens))

    def note_echo(self, prompt: str, index: int = 0) -> None:
        """echo=true prepends the prompt to the returned text; legacy
        text_offset indexes into the FULL text, so offsets start after it."""
        self._char_off[index] = self._char_off.get(index, 0) + len(prompt)

    def text_chunk(
        self,
        text: str,
        index: int = 0,
        logprobs: Optional[list[dict]] = None,
    ) -> CompletionResponse:
        lp = None
        if logprobs:
            # legacy completions logprobs shape
            offsets = []
            off = self._char_off.get(index, 0)
            for e in logprobs:
                offsets.append(off)
                off += len(e["token"])
            self._char_off[index] = off
            lp = {
                "tokens": [e["token"] for e in logprobs],
                "token_logprobs": [e["logprob"] for e in logprobs],
                "top_logprobs": [
                    {
                        t["token"]: t["logprob"]
                        for t in e.get("top_logprobs", [])
                    }
                    for e in logprobs
                ],
                "text_offset": offsets,
            }
        return self._chunk([CompletionChoice(index=index, text=text, logprobs=lp)])

    def finish_chunk(self, reason: FinishReason, index: int = 0) -> CompletionResponse:
        return self._chunk([
            CompletionChoice(index=index, text="", finish_reason=reason.as_openai())
        ])
