"""OpenAI-compatible HTTP service on an asyncio HTTP/1.1 server.

The port's own copy of dynamo_tpu/http/service.py (``ModelExecution``,
``chat_stream``, ``completion_stream``, ``ModelManager``, ``HttpService``)
on ``asyncio.start_server`` in place of aiohttp, which the card's machine
lacks. Routes: ``POST /v1/chat/completions`` and ``POST /v1/completions``
(SSE when ``stream`` is set, else one JSON body folded from the same
stream; ``n`` >= 1 choices merged into one stream), ``GET /v1/models`` and
``POST /v1/responses`` (unary: the body as a chat request, the answer
reshaped into a Response object), ``GET /v1/models``, ``GET /health`` and
``GET /live``, the Prometheus text at ``GET /metrics`` (``http/metrics.py``),
``GET /debug/slo``, ``POST /v1/embeddings`` (each input's pooled vector from
the model's ``embed_fn``, 501 without one, and ``usage``),
``GET /debug/profile?seconds=N[&dir=PATH]`` (a ``torch.profiler`` window,
``telemetry/profile.py``: 200, 409 while a window is open, 400 on a bad
``seconds``, 501 where no engine runs), and the admin route
``POST /clear_kv_blocks`` (every model's ``clear_fn``: its engine's
reusable KV state dropped, the reference's per-worker-group answer); any
other route gets 404 with the reference's error payload. A malformed body
gets 400 ``invalid_request_error``, an unknown model 404
``not_found_error``, and image or video parts to a model whose card does
not say ``supports_images`` (a ``MultimodalEngine`` deployment's does) 501
``not_implemented``. A chat request that declares ``tools`` has
them rendered by its template, and a choice whose text parses as tool calls
(``tool_calling.parse_tool_calls``: Hermes, Mistral or Llama-3 JSON) is
answered with ``tool_calls`` deltas and the ``tool_calls`` finish.

The server speaks enough HTTP/1.1 for OpenAI clients: a request line and
headers, ``Content-Length`` bodies (with ``Expect: 100-continue``),
keep-alive, and SSE responses written chunk by chunk as the engine streams.
While a request is served, the connection is watched: a client that closes
it (EOF on the reader, or a write that fails) kills the request's
``Context``, and the engine frees its lane at its next step.

The edge resolves each request's QoS class (the ``x-dyn-priority`` header,
then ``ext.priority``, then ``DYN_PRIORITY_DEFAULT``: ``qos.py``) onto its
Context and arms its deadlines (``ext.timeout_ms`` / ``ext.ttft_timeout_ms``,
else ``DYN_DEFAULT_DEADLINE_MS`` for the whole request): an engine sheds an
expired request with the typed ``deadline_exceeded`` error, a 504 when not
streamed and an SSE ``event: error`` when streamed.

Tracing (``DYN_TRACE=1``, ``telemetry/trace.py``): each completion runs
under an ``http_request`` root span that honours an inbound W3C
``traceparent`` (else mints a trace id) and is echoed as ``x-dyn-trace-id``;
the per-phase breakdown rides ``usage.timing`` on the final SSE usage chunk
and on unary responses; ``DYN_TRACE_DIR`` gets one Chrome trace file per
request; ``GET /debug/traces/{request_id}`` (a request id or a trace id)
serves the assembled cross-process trace as Chrome trace-event JSON, waiting
up to ``DYN_TRACE_ASSEMBLE_MS`` (250) for spans still on their way, and
answers 404 "tracing is disabled" when off.

Admission (``AdmissionController``, service.py:171-385): each model's
inflight requests are bounded by a watermark, the fleet's request slots
(a capacity function: the static engine's ``max_batch``, or discovery's
``WorkerCapacityPoller``) times ``DYN_ADMISSION_QUEUE_FACTOR`` (2.0),
capped by ``DYN_ADMISSION_MAX_INFLIGHT``; each class sheds at its fraction
of it (``DYN_ADMISSION_CLASS_FRACTIONS``: bulk 0.5, standard 0.8,
interactive 1.0), a known-cold bulk prefix (the KV router's fleet-matched
fraction, an EWMA per prefix signature) at ``DYN_COLD_PREFIX_FRACTION`` of
that, and the brownout ladder sheds whole classes. A shed is answered 429
``overloaded`` before the prompt is tokenized, with a ``Retry-After`` from
the measured drain rate (``DYN_ADMISSION_RETRY_AFTER_S`` without one).

The SLO plane (``telemetry/slo.py``): with ``DYN_SLO_TTFT_MS`` /
``DYN_SLO_ITL_MS`` (or ``DYN_SLO_CONFIG``) set, a loop every
``DYN_SLO_TICK_S`` evaluates each model's burn rates over this frontend's
phase histograms, publishes state transitions through ``slo_publisher``
(the ``slo-status`` event) and steps the brownout ladder with the worse of
its own state and the fleet's (``note_remote_slo``); ladder transitions
publish through ``brownout_publisher``. ``GET /debug/slo`` shows both. With
``DYN_TRACE=auto`` every request is traced and its completion keeps the
trace only when it errored, breached its SLO, migrated or was sampled
(``retention_reason``; the flight recorder, ``DYN_TRACE_DIR``), listed at
``GET /debug/traces``.

Tokenizing, templating and detokenizing run on the event loop, per request,
as in the reference; the engine keeps its device calls on its own thread.
Left out: ``/debug/goodput``, ``/debug/decisions``, ``/debug/fleet`` and
the admission's provenance records (A12).
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import json
import logging
import math
import os
import re
import time
import urllib.parse
import uuid
from typing import Any, AsyncIterator, Callable, Optional

from dynamo_tpu_torch import qos
from dynamo_tpu_torch.backend import Backend, EngineFn, detokenize
from dynamo_tpu_torch.http.metrics import ServiceMetrics, TokenTimer
from dynamo_tpu_torch.model_card import ModelDeploymentCard
from dynamo_tpu_torch.pipeline.annotated import Annotated
from dynamo_tpu_torch.preprocessor import (
    ChatDeltaGenerator,
    CompletionDeltaGenerator,
    OpenAIPreprocessor,
)
from dynamo_tpu_torch.protocols.aggregator import ChatDeltaAggregator, CompletionAggregator
from dynamo_tpu_torch.protocols.common import Context, FinishReason, PreprocessedRequest
from dynamo_tpu_torch.protocols.openai import (
    ChatCompletionRequest,
    CompletionRequest,
    EmbeddingRequest,
    ModelInfo,
    ModelList,
)
from dynamo_tpu_torch.protocols.sse import encode_done, encode_json_event
from dynamo_tpu_torch.runtime.prom import CONTENT_TYPE_LATEST
from dynamo_tpu_torch.telemetry import brownout as dbrownout
from dynamo_tpu_torch.telemetry import profile as dprofile
from dynamo_tpu_torch.telemetry import slo as dslo
from dynamo_tpu_torch.telemetry import trace as dtrace
from dynamo_tpu_torch.tool_calling import parse_tool_calls

logger = logging.getLogger("dynamo_tpu_torch.http")

# client-supplied x-request-id: sanitized to a safe charset and bounded so
# it can serve as the Context id and a log field
_RID_BAD = re.compile(r"[^A-Za-z0-9._:-]")
_RID_MAX = 128

MAX_BODY_BYTES = 64 * 1024 * 1024  # the reference's client_max_size
MAX_HEADER_BYTES = 64 * 1024
_REASONS = {
    100: "Continue", 200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 411: "Length Required", 413: "Payload Too Large",
    429: "Too Many Requests", 431: "Request Header Fields Too Large",
    500: "Internal Server Error", 501: "Not Implemented", 503: "Service Unavailable",
    504: "Gateway Timeout",
}


def client_request_id(headers: dict[str, str]) -> Optional[str]:
    rid = headers.get("x-request-id")
    if not rid:
        return None
    rid = _RID_BAD.sub("-", rid.strip())[:_RID_MAX]
    return rid or None


class EngineStreamError(Exception):
    """A structured engine failure (LLMEngineOutput.error) surfacing
    through the per-model chain; rendered as a typed SSE ``event: error``
    (streaming) or a mapped status code (unary)."""

    def __init__(self, payload: dict) -> None:
        super().__init__(payload.get("cause") or "engine error")
        self.payload = payload


# machine-readable error code -> HTTP status for unary responses
_CODE_STATUS = {
    "deadline_exceeded": 504,
    "worker_unavailable": 503,
    "overloaded": 429,
    "brownout_shed": 429,
    "preempted_too_often": 503,
    "prompt_too_long": 400,
}


def _error_payload(message: Optional[str]) -> dict:
    """Decode a stream error message: structured JSON payloads (request_id,
    phase, cause, code) pass through; anything else wraps as internal."""
    if message:
        try:
            d = json.loads(message)
            if isinstance(d, dict) and ("code" in d or "cause" in d):
                return d
        except (ValueError, TypeError):
            pass
    return {"cause": message or "engine error", "code": "internal_error"}


def _usage_timing_block(ctx: Context) -> dict:
    """The ``usage.timing`` payload of a finished request: the trace's
    per-phase breakdown ({} with tracing off)."""
    if dtrace.enabled():
        return dtrace.breakdown(dtrace.ctx_trace_id(ctx)) or {}
    return {}


def _parse_class_fractions(raw: Optional[str]) -> dict[str, float]:
    """DYN_ADMISSION_CLASS_FRACTIONS: ``class=frac,...``, the fraction of
    the model watermark at which that class starts shedding. The defaults
    give bulk half the queue, standard 80%, interactive the whole."""
    out = {"bulk": 0.5, "standard": 0.8, "interactive": 1.0}
    for entry in (raw or "").split(","):
        entry = entry.strip()
        if not entry or "=" not in entry:
            continue
        cls, _, frac = entry.partition("=")
        cls = qos.normalize_priority(cls)
        if cls is None:
            continue
        try:
            out[cls] = max(0.0, min(1.0, float(frac)))
        except ValueError:
            continue
    return out


def _prefix_sig(text: str) -> Optional[int]:
    """A cheap request-prefix signature for admission heat: a hash of the
    leading characters (the system prompt and template region, the likely
    fleet-shared prefix). Process-local (str hashing is salted); the heat
    it keys is learned from the router's match, so it only needs to be
    stable within this frontend."""
    if not text:
        return None
    return hash(text[:256])


def _chat_prefix_sig(chat_req) -> Optional[int]:
    try:
        m = chat_req.messages[0]
        c = m.content
        if not isinstance(c, str):
            c = json.dumps(c, sort_keys=True, default=str)
        return _prefix_sig(f"{m.role}:{c}")
    except Exception:  # noqa: BLE001 — heat is advisory
        return None


def _completion_prefix_sig(comp_req) -> Optional[int]:
    try:
        p = comp_req.prompt
        if isinstance(p, list):
            p = ",".join(str(t) for t in p[:64])
        return _prefix_sig(str(p))
    except Exception:  # noqa: BLE001 — heat is advisory
        return None


class AdmissionController:
    """Frontend admission control and load shedding (service.py:171-385).
    Per-model inflight is bounded by a watermark from the fleet's request
    slots (a capacity fn) times DYN_ADMISSION_QUEUE_FACTOR, capped by the
    static DYN_ADMISSION_MAX_INFLIGHT. Each class sheds at its own fraction
    of the watermark, a known-cold bulk prefix earlier, and the brownout
    ladder can force whole classes shed whatever the load. The 429's
    Retry-After comes from the measured drain rate: how long the backlog
    above this class's threshold takes to clear (DYN_ADMISSION_RETRY_AFTER_S
    until there is a drain signal)."""

    def __init__(
        self,
        metrics: Optional[ServiceMetrics] = None,
        max_inflight: Optional[int] = None,
        queue_factor: Optional[float] = None,
    ) -> None:
        env = os.environ
        self.metrics = metrics
        if max_inflight is None:
            max_inflight = int(env.get("DYN_ADMISSION_MAX_INFLIGHT", "0")) or None
        self.max_inflight = max_inflight
        self.queue_factor = (queue_factor if queue_factor is not None
                             else float(env.get("DYN_ADMISSION_QUEUE_FACTOR", "2.0")))
        self.retry_after_s = float(env.get("DYN_ADMISSION_RETRY_AFTER_S", "1"))
        self.class_fractions = _parse_class_fractions(env.get("DYN_ADMISSION_CLASS_FRACTIONS"))
        # classes force-shed by the brownout ladder (the service's hook)
        self.brownout_shed: frozenset[str] = frozenset()
        self.drain = qos.DrainRateEstimator()
        self._inflight: dict[str, int] = {}
        # model -> zero-arg fn giving the fleet's total request slots
        # (None = unknown), installed by the static or discovery wiring
        self._capacity_fns: dict[str, Callable[[], Optional[int]]] = {}
        self.shed_total = 0
        self.shed_by_class: dict[str, int] = {}
        # fleet prefix heat: EWMA of the router's fleet-matched fraction per
        # (model, prefix signature), LRU-capped; a known-cold bulk prefix
        # sheds at a reduced watermark, a first-seen one never does
        self.heat_max = max(1, int(env.get("DYN_ADMISSION_HEAT_MAX", "4096") or 4096))
        self.cold_prefix_fraction = float(env.get("DYN_COLD_PREFIX_FRACTION", "0.6"))
        self.cold_prefix_heat = float(env.get("DYN_COLD_PREFIX_HEAT", "0.25"))
        self._prefix_heat: collections.OrderedDict = collections.OrderedDict()

    def set_capacity_fn(self, model: str, fn: Callable[[], Optional[int]]) -> None:
        self._capacity_fns[model] = fn

    def remove_capacity_fn(self, model: str) -> None:
        self._capacity_fns.pop(model, None)

    def watermark(self, model: str) -> Optional[int]:
        slots: Optional[int] = None
        fn = self._capacity_fns.get(model)
        if fn is not None:
            try:
                slots = fn()
            except Exception:  # noqa: BLE001 — stale capacity is tolerable
                slots = None
        if slots:
            wm = max(1, int(math.ceil(slots * self.queue_factor)))
            if self.max_inflight:
                wm = min(wm, self.max_inflight)
            return wm
        return self.max_inflight

    def class_watermark(self, model: str, priority: str) -> Optional[int]:
        """The inflight count at which ``priority``-class requests shed."""
        wm = self.watermark(model)
        if wm is None:
            return None
        return max(1, int(math.ceil(wm * self.class_fractions.get(priority, 1.0))))

    def _shed_one(self, model: str, priority: str, reason: str, excess: int) -> float:
        self.shed_total += 1
        self.shed_by_class[priority] = self.shed_by_class.get(priority, 0) + 1
        if self.metrics is not None:
            self.metrics.requests_shed.labels(model).inc()
            self.metrics.class_shed.labels(model, priority, reason).inc()
        return self.drain.retry_after_s(max(1, excess), self.retry_after_s)

    def note_prefix_heat(self, model: str, prefix_sig: Optional[int], frac: float) -> None:
        """Learn the router's fleet-matched fraction for this request's
        prefix signature (EWMA, LRU-capped table)."""
        if prefix_sig is None:
            return
        key = (model, prefix_sig)
        prev = self._prefix_heat.pop(key, None)
        self._prefix_heat[key] = float(frac) if prev is None else 0.5 * prev + 0.5 * float(frac)
        while len(self._prefix_heat) > self.heat_max:
            self._prefix_heat.popitem(last=False)

    def prefix_heat(self, model: str, prefix_sig: Optional[int]) -> Optional[float]:
        if prefix_sig is None:
            return None
        return self._prefix_heat.get((model, prefix_sig))

    def try_acquire(self, model: str, priority: str = qos.DEFAULT_CLASS,
                    prefix_sig: Optional[int] = None,
                    request_id: Optional[str] = None) -> Optional[float]:
        """None = admitted (the caller must release()); else shed, and the
        value is the Retry-After hint in seconds."""
        priority = qos.normalize_priority(priority) or qos.DEFAULT_CLASS
        if priority in self.brownout_shed:
            return self._shed_one(model, priority, "brownout", 1)
        wm = self.class_watermark(model, priority)
        cur = self._inflight.get(model, 0)
        if wm is not None and priority == "bulk":
            heat = self.prefix_heat(model, prefix_sig)
            if heat is not None and heat < self.cold_prefix_heat:
                # a known-cold bulk prefix reuses no fleet KV: under
                # pressure it costs the full prefill that hot traffic skips
                cold_wm = max(1, int(math.ceil(wm * self.cold_prefix_fraction)))
                if cur >= cold_wm:
                    return self._shed_one(model, priority, "cold_prefix", cur - cold_wm + 1)
        if wm is not None and cur >= wm:
            return self._shed_one(model, priority, "watermark", cur - wm + 1)
        self._inflight[model] = cur + 1
        return None

    def release(self, model: str) -> None:
        self._inflight[model] = max(0, self._inflight.get(model, 1) - 1)
        # a completion is one queue slot drained: feeds the Retry-After hint
        self.drain.note()

    def inflight(self, model: Optional[str] = None) -> int:
        if model is not None:
            return self._inflight.get(model, 0)
        return sum(self._inflight.values())


def _error_body(payload: dict) -> dict:
    return {
        "error": {
            "message": payload.get("cause") or payload.get("message") or "engine error",
            "type": payload.get("code", "internal_error"),
            **{k: v for k, v in payload.items() if k in ("request_id", "phase")},
        }
    }


class ModelExecution:
    """Per-model chain: preprocess -> engine -> detokenize -> OpenAI chunks."""

    def __init__(self, mdc: ModelDeploymentCard, engine_fn: EngineFn,
                 clear_fn: Optional[Callable] = None,
                 embed_fn: Optional[Callable] = None) -> None:
        self.mdc = mdc
        self.engine_fn = engine_fn
        # async (token_ids) -> pooled embedding vector, where the engine
        # has one (POST /v1/embeddings)
        self.embed_fn = embed_fn
        # async () -> [per-worker dict]: drops the workers' reusable KV
        self.clear_fn = clear_fn
        self.preprocessor = OpenAIPreprocessor(mdc)
        self.backend = Backend(self.preprocessor.tokenizer)

    @property
    def supports_images(self) -> bool:
        """Whether the backing worker takes image / video parts: a
        ``MultimodalEngine`` deployment says so on its model card, which
        rides discovery, so a remote frontend sees it too."""
        return bool(self.mdc.extra.get("supports_images"))

    @staticmethod
    def _fanout(pre: PreprocessedRequest) -> list[PreprocessedRequest]:
        """n>1: n independent engine requests, one per choice index. A
        seeded request derives seed+i per choice so choices differ but the
        whole response stays reproducible."""
        n = max(1, pre.sampling.n or 1)
        if n == 1:
            return [pre]
        out = []
        for i in range(n):
            s = dataclasses.replace(pre.sampling, n=1)
            if s.seed is not None:
                s = dataclasses.replace(s, seed=s.seed + i)
            out.append(dataclasses.replace(pre, sampling=s))
        return out

    async def _merged_choices(
        self,
        choices: list[PreprocessedRequest],
        ctx: Context,
        timer: Optional[TokenTimer],
        emit_chunk: Callable,
        emit_finish: Callable,
        counters: dict,
    ) -> AsyncIterator[Any]:
        """Run every choice's engine stream concurrently; yield OpenAI
        chunks in arrival order (choice index rides inside each chunk)."""
        queue: asyncio.Queue = asyncio.Queue()

        async def run_choice(i: int, pre_i: PreprocessedRequest) -> None:
            finish: Optional[FinishReason] = None
            # a child context per choice: the engine kills its context when
            # the stream is torn down, and a child confines that kill to
            # this choice (a kill of the parent still reaches every choice)
            agen = detokenize(self.backend, self.engine_fn, pre_i, ctx.child())
            try:
                async for step in agen:
                    counters["completion"] += step.tokens_emitted
                    if step.text or step.logprobs:
                        if timer:
                            timer.on_token(max(step.tokens_emitted, 1))
                        for chunk in emit_chunk(step, i):
                            queue.put_nowait(("chunk", chunk))
                    if step.finish_reason is not None:
                        if step.finish_reason is FinishReason.ERROR:
                            raise EngineStreamError(
                                step.error or {"cause": "engine error", "code": "internal_error"}
                            )
                        finish = step.finish_reason
                        break
                if not ctx.is_killed():
                    for chunk in emit_finish(finish or FinishReason.STOP, i):
                        queue.put_nowait(("chunk", chunk))
            except Exception as e:  # noqa: BLE001 — surface as SSE error
                queue.put_nowait(("error", e))
            finally:
                with contextlib.suppress(Exception):
                    await agen.aclose()
                queue.put_nowait(("done", i))

        loop = asyncio.get_running_loop()
        tasks = [loop.create_task(run_choice(i, p)) for i, p in enumerate(choices)]
        done = 0
        try:
            while done < len(tasks):
                kind, payload = await queue.get()
                if kind == "done":
                    done += 1
                elif kind == "error":
                    raise payload
                else:
                    yield payload
        finally:
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

    async def _stream(self, pre, gen, ctx, timer, emit_chunk, emit_finish,
                      include_usage) -> AsyncIterator[Annotated]:
        counters = {"completion": 0}
        try:
            async for chunk in self._merged_choices(
                self._fanout(pre), ctx, timer, emit_chunk, emit_finish, counters
            ):
                yield Annotated.from_data(chunk.to_dict())
        except EngineStreamError as e:
            yield Annotated.from_error(json.dumps(e.payload))
            return
        except Exception as e:  # noqa: BLE001
            logger.exception("engine stream failed")
            yield Annotated.from_error(f"engine error: {e}")
            return
        if ctx.is_killed():
            return
        if include_usage:
            chunk = gen.usage_chunk(len(pre.token_ids), counters["completion"]).to_dict()
            # the final SSE chunk carries the per-request phase breakdown
            # (the workers' spans arrived on their final frames)
            tb = _usage_timing_block(ctx)
            if tb and chunk.get("usage") is not None:
                chunk["usage"]["timing"] = tb
            yield Annotated.from_data(chunk)

    async def chat_stream(self, request: ChatCompletionRequest, ctx: Context,
                          timer: Optional[TokenTimer] = None) -> AsyncIterator[Annotated]:
        pre, prompt = self.preprocessor.preprocess_chat(request)
        pre.extra["echo_text"] = prompt  # feeds the echo_full test engine
        qos.stamp_priority(pre, ctx)  # the QoS class onto every wire hop
        for ann in self.preprocessor.requested_annotations(pre, prompt):
            yield ann
        gen = ChatDeltaGenerator(request.model)
        for i in range(max(1, pre.sampling.n or 1)):
            yield Annotated.from_data(gen.role_chunk(i).to_dict())
        # tool calling: a request that declares tools has each choice's text
        # buffered and parsed at its end; parsed calls become tool_calls
        # deltas and the "tool_calls" finish, anything else is released as
        # ordinary text (service.py:555-585)
        buffer_tools = bool(request.tools)
        buffers: dict[int, list] = {}

        def emit_chat(step, i):
            if buffer_tools:
                slot = buffers.setdefault(i, [[], []])
                if step.text:
                    slot[0].append(step.text)
                if step.logprobs:
                    slot[1].extend(step.logprobs)
                return []
            return [gen.text_chunk(step.text, index=i, logprobs=step.logprobs)]

        def finish_chat(reason, i):
            if not buffer_tools:
                return [gen.finish_chunk(reason, index=i)]
            texts, lps = buffers.get(i, [[], []])
            text = "".join(texts)
            calls = parse_tool_calls(text) if text else None
            if calls:
                return [gen.tool_calls_chunk([c.to_openai(j) for j, c in enumerate(calls)], index=i),
                        gen.finish_chunk(reason, index=i, literal="tool_calls")]
            out = []
            if text or lps:
                out.append(gen.text_chunk(text, index=i, logprobs=lps or None))
            out.append(gen.finish_chunk(reason, index=i))
            return out

        async for item in self._stream(
            pre, gen, ctx, timer, emit_chat, finish_chat,
            bool(request.stream_options and request.stream_options.get("include_usage")),
        ):
            yield item

    async def completion_stream(self, request: CompletionRequest, ctx: Context,
                                timer: Optional[TokenTimer] = None) -> AsyncIterator[Annotated]:
        pre, prompt = self.preprocessor.preprocess_completion(request)
        pre.extra["echo_text"] = prompt
        qos.stamp_priority(pre, ctx)
        gen = CompletionDeltaGenerator(request.model)
        if request.echo and prompt:
            for i in range(max(1, pre.sampling.n or 1)):
                gen.note_echo(prompt, index=i)
                yield Annotated.from_data(gen.text_chunk(prompt, index=i).to_dict())
        async for item in self._stream(
            pre, gen, ctx, timer,
            lambda step, i: [gen.text_chunk(step.text, index=i, logprobs=step.logprobs)],
            lambda reason, i: [gen.finish_chunk(reason, index=i)],
            bool(request.stream_options and request.stream_options.get("include_usage")),
        ):
            yield item


class ModelManager:
    """Registry of live models, each held by one or more refs (a discovered
    model by every worker's registration key; a local one by "local")."""

    def __init__(self) -> None:
        self._models: dict[str, dict[str, Any]] = {}

    def add_model(self, name: str, execution: ModelExecution, ref: str = "local") -> None:
        entry = self._models.get(name)
        if entry is None:
            self._models[name] = {"execution": execution, "refs": {ref}}
            logger.info("model added: %s", name)
        else:
            entry["refs"].add(ref)

    def remove_ref(self, name: str, ref: str) -> bool:
        """Drop one ref; the model goes with its last. True when it went."""
        entry = self._models.get(name)
        if entry is None:
            return False
        entry["refs"].discard(ref)
        if not entry["refs"]:
            del self._models[name]
            logger.info("model removed: %s", name)
            return True
        return False

    def get(self, name: str) -> Optional[ModelExecution]:
        entry = self._models.get(name)
        return entry["execution"] if entry else None

    def list_models(self) -> list[str]:
        return sorted(self._models)


# ------------------------------------------------------------------ HTTP


class _BadRequest(Exception):
    def __init__(self, status: int, message: str) -> None:
        super().__init__(message)
        self.status = status


class _ClientGone(Exception):
    """The peer closed the connection or a write to it failed."""


@dataclasses.dataclass
class _Request:
    method: str
    path: str
    version: str
    headers: dict[str, str]
    body: bytes = b""
    query: dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def keep_alive(self) -> bool:
        conn = self.headers.get("connection", "").lower()
        if self.version == "HTTP/1.0":
            return conn == "keep-alive"
        return conn != "close"


class _Connection:
    """One client socket: buffered reads, response writes, EOF watch."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        self.reader, self.writer = reader, writer
        self.buf = bytearray()
        self.eof = False
        self.head_sent = False  # the current response's status line is out

    async def _fill(self) -> None:
        try:
            data = await self.reader.read(65536)
        except ConnectionError:  # a reset is the peer going away too
            data = b""
        if not data:
            self.eof = True
        self.buf += data

    async def read_request(self) -> Optional[_Request]:
        while b"\r\n\r\n" not in self.buf:
            if len(self.buf) > MAX_HEADER_BYTES:
                raise _BadRequest(431, "request headers too large")
            if self.eof:
                if self.buf.strip():
                    raise _BadRequest(400, "incomplete request head")
                return None
            await self._fill()
        end = self.buf.index(b"\r\n\r\n")
        head = bytes(self.buf[:end]).decode("latin-1")
        del self.buf[:end + 4]
        lines = head.split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
            raise _BadRequest(400, f"bad request line {lines[0]!r}")
        method, target, version = parts
        headers: dict[str, str] = {}
        for line in lines[1:]:
            name, sep, value = line.partition(":")
            if not sep or not name.strip():
                raise _BadRequest(400, f"bad header line {line!r}")
            headers[name.strip().lower()] = value.strip()
        path, _, qs = target.partition("?")
        req = _Request(method.upper(), path, version, headers,
                       query=dict(urllib.parse.parse_qsl(qs)))
        if "chunked" in headers.get("transfer-encoding", "").lower():
            raise _BadRequest(411, "chunked request bodies are not supported; send Content-Length")
        try:
            length = int(headers.get("content-length", "0"))
        except ValueError:
            raise _BadRequest(400, "bad Content-Length") from None
        if length < 0:
            raise _BadRequest(400, "bad Content-Length")
        if length > MAX_BODY_BYTES:
            raise _BadRequest(413, f"request body over {MAX_BODY_BYTES} bytes")
        if length and headers.get("expect", "").lower() == "100-continue":
            await self.send_raw(b"HTTP/1.1 100 Continue\r\n\r\n")
        while len(self.buf) < length:
            if self.eof:
                raise _BadRequest(400, "request body shorter than Content-Length")
            await self._fill()
        req.body = bytes(self.buf[:length])
        del self.buf[:length]
        return req

    async def watch_eof(self) -> None:
        """Read ahead until the peer closes (bytes of a pipelined next
        request stay buffered, up to one request's worth; past that the
        watch leaves disconnects to the writes)."""
        while not self.eof and len(self.buf) <= MAX_HEADER_BYTES + MAX_BODY_BYTES:
            await self._fill()
        if not self.eof:
            await asyncio.get_running_loop().create_future()

    async def send_raw(self, data: bytes) -> None:
        if self.writer.is_closing():
            raise _ClientGone()
        try:
            self.writer.write(data)
            await self.writer.drain()
        except (ConnectionError, OSError) as e:
            raise _ClientGone() from e

    async def send_head(self, status: int, headers: dict[str, str]) -> None:
        self.head_sent = True
        lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}"]
        lines += [f"{k}: {v}" for k, v in headers.items()]
        await self.send_raw(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))

    async def send_json(self, status: int, body: Any, headers: Optional[dict] = None,
                        keep_alive: bool = True) -> None:
        data = json.dumps(body).encode("utf-8")
        await self.send_head(status, {
            "Content-Type": "application/json; charset=utf-8",
            "Content-Length": str(len(data)),
            "Connection": "keep-alive" if keep_alive else "close",
            **(headers or {}),
        })
        await self.send_raw(data)

    async def send_text(self, status: int, data: bytes, content_type: str,
                        keep_alive: bool = True) -> None:
        await self.send_head(status, {
            "Content-Type": content_type,
            "Content-Length": str(len(data)),
            "Connection": "keep-alive" if keep_alive else "close",
        })
        await self.send_raw(data)

    async def send_chunk(self, text: str) -> None:
        data = text.encode("utf-8")
        if data:
            await self.send_raw(b"%x\r\n%s\r\n" % (len(data), data))

    async def end_chunks(self) -> None:
        await self.send_raw(b"0\r\n\r\n")


class _Reply(Exception):
    """A complete JSON reply decided before any byte was sent."""

    def __init__(self, status: int, message: str, typ: str = "invalid_request_error",
                 headers: Optional[dict[str, str]] = None) -> None:
        super().__init__(message)
        self.status, self.body = status, {"error": {"message": message, "type": typ}}
        self.headers = headers or {}


class HttpService:
    def __init__(
        self,
        manager: Optional[ModelManager] = None,
        host: str = "0.0.0.0",
        port: int = 8080,
        template: Optional[Any] = None,  # request_template.RequestTemplate
        metrics: Optional[ServiceMetrics] = None,
        admission: Optional[AdmissionController] = None,
    ) -> None:
        self.manager = manager or ModelManager()
        self.host = host
        self.port = port
        self.template = template
        self.metrics = metrics or ServiceMetrics()
        # integrity / fence counters (process-wide): a frontend's share is
        # chiefly dispatch-plane fenced rejects from zombie workers
        from dynamo_tpu_torch.integrity import COUNTERS

        self.metrics.attach_integrity(COUNTERS)
        self.admission = admission or AdmissionController(self.metrics)
        self._server: Optional[asyncio.base_events.Server] = None
        self._conns: set[asyncio.Task] = set()
        self._inflight = 0  # requests being answered
        self._draining = False
        # a dynamic frontend's discovery.ModelWatcher (entrypoint.run_http)
        self.watcher: Optional[Any] = None
        self._routes = {
            ("POST", "/v1/chat/completions"): self._chat,
            ("POST", "/v1/completions"): self._completions,
            ("POST", "/v1/responses"): self._responses,
            ("GET", "/v1/models"): self._models,
            ("GET", "/health"): self._health,
            ("GET", "/live"): self._health,
            ("GET", "/metrics"): self._metrics,
            ("POST", "/v1/embeddings"): self._embeddings,
            ("GET", "/debug/slo"): self._debug_slo,
            ("GET", "/debug/profile"): self._debug_profile,
            ("GET", "/debug/traces"): self._debug_traces_list,
            ("POST", "/clear_kv_blocks"): self._clear_kv_blocks,
        }
        # the SLO plane: an engine per model fed from this frontend's own
        # phase observations; transitions go to slo_publisher (the
        # `slo-status` event, wired by run_http; None = logged only)
        self._slo_engines: dict[str, dslo.SloEngine] = {}
        self._slo_task: Optional[asyncio.Task] = None
        self._slo_tick_s = float(os.environ.get("DYN_SLO_TICK_S", "1.0"))
        self.slo_publisher: Optional[Callable[[dict], None]] = None
        # the brownout ladder, fed by this frontend's SLO state and the
        # fleet's (note_remote_slo); rungs 1 and 4 force-shed whole classes
        # at the AdmissionController; transitions go to brownout_publisher
        self.brownout = dbrownout.BrownoutController(scope="frontend",
                                                     on_change=self._on_brownout_change)
        self.brownout_publisher: Optional[Callable[[dict], None]] = None
        self._local_slo_state = "ok"
        self._remote_slo_state = "ok"
        self.metrics.attach_brownout(self.brownout)
        # auxiliary background tasks (event subscriptions) cancelled on close
        self._aux_tasks: list[asyncio.Task] = []

    # ---------------------------------------------------------- lifecycle

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._serve_conn, self.host, self.port)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        # the loop also ticks the brownout ladder without a local objective:
        # fleet slo-status events fire on transitions only, and the ladder
        # steps on observations (the reference runs it only with an SLO, so
        # its ladder never steps back down after a remote ok; ROADMAP C11)
        if (dslo.SloConfig.from_env().enabled or self.brownout.config.enabled) \
                and self._slo_task is None:
            self._slo_task = asyncio.get_running_loop().create_task(self._slo_loop())
        logger.info("openai http service on %s:%d", self.host, self.port)

    def add_background_task(self, task: asyncio.Task) -> None:
        """Track an auxiliary task (an event subscription loop) for close()."""
        self._aux_tasks.append(task)

    async def close(self) -> None:
        for t in ([self._slo_task] if self._slo_task is not None else []) + self._aux_tasks:
            t.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await t
        self._slo_task = None
        self._aux_tasks.clear()
        if self._server is not None:
            self._server.close()
            for t in list(self._conns):
                t.cancel()
            await asyncio.gather(*self._conns, return_exceptions=True)
            await self._server.wait_closed()
            self._server = None

    async def drain(self, timeout_s: float = 10.0) -> None:
        """Graceful drain (SIGTERM): stop listening, answer new requests on
        open connections 503, wait (bounded) for the requests in flight to
        finish, then close."""
        self._draining = True
        if self._server is not None:
            self._server.close()  # stops listening; open connections stay
        deadline = time.monotonic() + timeout_s
        while self._inflight and time.monotonic() < deadline:
            await asyncio.sleep(0.05)
        if self._inflight:
            logger.warning("drain timeout (%.1fs): %d request(s) still in flight",
                           timeout_s, self._inflight)
        await self.close()

    # -------------------------------------------------------- connections

    async def _serve_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        conn = _Connection(reader, writer)
        try:
            while True:
                try:
                    req = await conn.read_request()
                except _BadRequest as e:
                    await conn.send_json(e.status, {"error": {"message": str(e), "type": "invalid_request_error"}},
                                         keep_alive=False)
                    return
                if req is None:
                    return
                if not await self._dispatch(conn, req) or not req.keep_alive:
                    return
        except _ClientGone:
            pass
        except Exception:  # noqa: BLE001 — one bad connection must not stop the server
            logger.exception("http connection failed")
        finally:
            self._conns.discard(task)
            writer.close()
            with contextlib.suppress(Exception):
                await writer.wait_closed()

    async def _dispatch(self, conn: _Connection, req: _Request) -> bool:
        """Serve one request; False when the connection must close."""
        handler = self._routes.get((req.method, req.path))
        if handler is None and req.method == "GET" and req.path.startswith("/debug/traces/"):
            handler = self._debug_trace
        if handler is None:
            if any(path == req.path for _, path in self._routes):
                await conn.send_json(405, {"error": {"message": f"method {req.method} not allowed",
                                                     "type": "invalid_request_error"}}, keep_alive=req.keep_alive)
            else:
                await conn.send_json(404, {"error": {"message": f"no route {req.method} {req.path}",
                                                     "type": "not_found_error"}}, keep_alive=req.keep_alive)
            return True
        if self._draining and req.method == "POST":
            await conn.send_json(503, {"error": {"message": "server is draining", "type": "unavailable"}},
                                 keep_alive=False, headers={"Retry-After": "2"})
            return False
        rid = client_request_id(req.headers)
        ctx = Context(id=rid) if rid else Context()
        conn.head_sent = False
        work = asyncio.ensure_future(handler(conn, req, ctx))
        watch = asyncio.ensure_future(conn.watch_eof())
        self._inflight += 1
        try:
            await asyncio.wait({work, watch}, return_when=asyncio.FIRST_COMPLETED)
            if not work.done():
                # the client went away: kill generation (the engine frees
                # the lane), then let the handler unwind
                ctx.kill()
                work.cancel()
                await asyncio.gather(work, return_exceptions=True)
                return False
            try:
                work.result()
            except _ClientGone:
                ctx.kill()
                return False
            except Exception:  # noqa: BLE001 — a failed request must not stop the server
                logger.exception("request %s failed", ctx.id)
                ctx.kill()
                if not conn.head_sent:
                    await conn.send_json(500, {"error": {"message": "internal server error",
                                                         "type": "internal_error"}}, keep_alive=False)
                return False
            return not conn.eof
        finally:
            self._inflight -= 1
            watch.cancel()
            await asyncio.gather(watch, return_exceptions=True)

    # ------------------------------------------------------------ helpers

    @staticmethod
    def _resp_headers(ctx: Context) -> dict[str, str]:
        h = {"x-request-id": ctx.id}
        tid = dtrace.ctx_trace_id(ctx)
        if tid:
            h["x-dyn-trace-id"] = tid
        return h

    @staticmethod
    def _trace_root(req: _Request, ctx: Context, endpoint: str):
        """Open the request's trace root, honouring an inbound W3C
        ``traceparent`` (a fresh trace id otherwise)."""
        if not dtrace.enabled():
            return dtrace.NULL_CM
        tid = sid = None
        tp = req.headers.get("traceparent")
        if tp:
            tid, sid = dtrace.parse_traceparent(tp)
        return dtrace.root_span(
            "http_request", ctx, trace_id=tid, parent_id=sid,
            proc="frontend", endpoint=endpoint, request_id=ctx.id,
        )

    # ---------------------------------------------------------------- slo

    def _slo_engine(self, model: str) -> dslo.SloEngine:
        eng = self._slo_engines.get(model)
        if eng is None:
            def on_transition(old: str, new: str, status: dict) -> None:
                logger.warning("SLO state for %s: %s -> %s", model, old, new)
                if self.slo_publisher is not None:
                    self.slo_publisher({"old": old, "new": new, **status})

            eng = self._slo_engines[model] = dslo.SloEngine(
                dslo.SloConfig.from_env(model), model=model, on_transition=on_transition)
        return eng

    def _slo_observe_all(self) -> dict[str, dict]:
        out = {model: self._slo_engine(model).observe(self.metrics.phase_hist_for(model))
               for model in self.manager.list_models()}
        worst = "ok"
        for status in out.values():
            st = status.get("state", "ok")
            if dslo._SEVERITY.get(st, 0) > dslo._SEVERITY.get(worst, 0):
                worst = st
        self._local_slo_state = worst
        return out

    async def _slo_loop(self) -> None:
        local = dslo.SloConfig.from_env().enabled
        while True:
            try:
                if local:
                    self._slo_observe_all()
                self._observe_brownout()
            except Exception:  # noqa: BLE001 — telemetry must not crash the server
                logger.exception("slo evaluation failed")
            await asyncio.sleep(self._slo_tick_s)

    def note_remote_slo(self, state: Optional[str]) -> None:
        """Feed a fleet ``slo-status`` transition into the brownout ladder.
        Events fire on transitions only, so the last remote state holds
        until the next event flips it back."""
        if state in dslo._SEVERITY:
            self._remote_slo_state = state
            self._observe_brownout()

    def _observe_brownout(self) -> None:
        """Step the ladder with the worse of the local and remote states."""
        local, remote = self._local_slo_state, self._remote_slo_state
        self.brownout.observe(
            local if dslo._SEVERITY.get(local, 0) >= dslo._SEVERITY.get(remote, 0) else remote)

    def _on_brownout_change(self, old: int, new: int, rung: str) -> None:
        self.admission.brownout_shed = dbrownout.shed_classes_for(new)
        if self.brownout_publisher is not None:
            self.brownout_publisher({"scope": "frontend", "old_level": old, "level": new,
                                     "rung": rung, **self.brownout.actions()})

    # ---------------------------------------------------------- completion

    @staticmethod
    def _trace_migrated(trace_id: Optional[str]) -> bool:
        """Did a span of this trace record a migration event?"""
        if not trace_id:
            return False
        return any(ev.get("name") == "migration"
                   for sp in dtrace.spans_for_trace(trace_id) for ev in sp.events)

    def _finish_trace(self, ctx: Context, model: str = "",
                      timer: Optional[TokenTimer] = None) -> None:
        """Request-completion hook (service.py:992-1023). DYN_TRACE=1: the
        assembled trace goes to DYN_TRACE_DIR when it is set. DYN_TRACE=auto:
        the flight recorder keeps it only when the request breached its SLO,
        errored or hit its deadline, migrated, or hit the 1-in-N sample
        (DYN_TRACE_SAMPLE)."""
        if not dtrace.enabled():
            return
        tid = dtrace.ctx_trace_id(ctx)
        if not tid:
            return
        if not dtrace.auto():
            dtrace.maybe_write_trace(tid, ctx.id)
            return
        reason = dslo.retention_reason(
            dslo.SloConfig.from_env(model) if model else None,
            error_code=ctx.metadata.get("error_code"),
            ttft_ms=getattr(timer, "ttft_ms", None),
            max_itl_ms=getattr(timer, "max_itl_ms", None),
            migrated=self._trace_migrated(tid),
        )
        rec = dslo.recorder()
        if reason is not None:
            rec.retain(tid, ctx.id, reason)
        else:
            rec.note_dropped()

    @staticmethod
    def _resolve_priority(req: _Request, api_req: Any, ctx: Context) -> str:
        """The QoS class at the edge: ``x-dyn-priority``, then
        ``ext.priority``, then ``DYN_PRIORITY_DEFAULT``."""
        ext = api_req.ext
        return qos.resolve_priority(
            req.headers.get("x-dyn-priority"), ext.priority if ext else None, api_req.model)

    def _admit(self, req: _Request, api_req: Any, ctx: Context, sig: Optional[int]) -> str:
        """Resolve the class and take an admission slot, or raise the 429
        (service.py:_shed, :1049-1056) before the prompt is tokenized."""
        prio = self._resolve_priority(req, api_req, ctx)
        retry_after = self.admission.try_acquire(api_req.model, prio, prefix_sig=sig,
                                                 request_id=ctx.id)
        if retry_after is not None:
            raise _Reply(429, "server overloaded: admission watermark reached, retry later",
                         "overloaded",
                         {"Retry-After": str(max(1, int(math.ceil(retry_after))))})
        ctx.decisions().priority = prio
        return prio

    def _release(self, model: str, ctx: Context, sig: Optional[int],
                 timer: Optional[TokenTimer]) -> None:
        frac = ctx.decisions().kv_fleet_frac
        if frac is not None:
            self.admission.note_prefix_heat(model, sig, frac)
        self.admission.release(model)
        self._finish_trace(ctx, model=model, timer=timer)

    @staticmethod
    def _arm_deadline(ctx: Context, api_req: Any) -> None:
        """Arm the request / TTFT budgets from the ext block, falling back
        to DYN_DEFAULT_DEADLINE_MS for the overall deadline
        (dynamo_tpu/http/service.py:1064-1074)."""
        ext = api_req.ext
        timeout_ms = ext.timeout_ms if ext else None
        ttft_ms = ext.ttft_timeout_ms if ext else None
        if timeout_ms is None:
            default = os.environ.get("DYN_DEFAULT_DEADLINE_MS")
            if default:
                timeout_ms = float(default)
        ctx.set_deadline_ms(timeout_ms, ttft_ms)

    def _parse(self, req: _Request, cls, apply_template: Optional[Callable]):
        try:
            body = json.loads(req.body)
            if self.template is not None and isinstance(body, dict):
                body = apply_template(body)
            api_req = cls.from_dict(body)
        except ValueError as e:  # JSONDecodeError and RequestValidationError
            raise _Reply(400, f"invalid request: {e}") from None
        execution = self.manager.get(api_req.model)
        if execution is None:
            raise _Reply(404, f"model {api_req.model!r} not found", "not_found_error")
        return api_req, execution

    async def _reply(self, conn: _Connection, req: _Request, ctx: Context, fn) -> None:
        try:
            await fn()
        except _Reply as r:
            await conn.send_json(r.status, r.body, {**self._resp_headers(ctx), **r.headers},
                                 req.keep_alive)

    def _note_error(self, model: str, ctx: Context, err: dict) -> None:
        # DYN_TRACE=auto retention: an errored request keeps its trace
        ctx.metadata["error_code"] = err.get("code", "internal_error")
        if err.get("code") == "deadline_exceeded" and model:
            self.metrics.deadline_exceeded.labels(model).inc()

    async def _stream_sse(self, conn: _Connection, req: _Request, ctx: Context,
                          stream: AsyncIterator[Annotated], model: str = "") -> None:
        await conn.send_head(200, {
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "Connection": "keep-alive" if req.keep_alive else "close",
            "Transfer-Encoding": "chunked",
            **self._resp_headers(ctx),
        })
        try:
            async for item in stream:
                if item.is_error():
                    err = _error_payload(item.error_message())
                    err.setdefault("request_id", ctx.id)
                    self._note_error(model, ctx, err)
                    await conn.send_chunk(encode_json_event(_error_body(err), event="error"))
                    break
                if item.event is not None:
                    await conn.send_chunk(encode_json_event(item.annotation_value(), event=item.event))
                elif item.data is not None:
                    await conn.send_chunk(encode_json_event(item.data))
            await conn.send_chunk(encode_done())
            await conn.end_chunks()
        finally:
            with contextlib.suppress(Exception):
                await stream.aclose()

    async def _fold(self, conn: _Connection, req: _Request, ctx: Context,
                    stream: AsyncIterator[Annotated], agg, model: str = "") -> Optional[dict]:
        """Fold a stream into one response dict; an engine error is sent as
        its mapped status and gives None."""
        try:
            async for item in stream:
                if item.is_error():
                    payload = _error_payload(item.error_message())
                    payload.setdefault("request_id", ctx.id)
                    self._note_error(model, ctx, payload)
                    status = _CODE_STATUS.get(payload.get("code", "internal_error"), 500)
                    headers = self._resp_headers(ctx)
                    if status == 429:
                        headers["Retry-After"] = "1"
                    await conn.send_json(status, _error_body(payload), headers, req.keep_alive)
                    return None
                if item.data is not None:
                    agg.add(item.data)
        finally:
            with contextlib.suppress(Exception):
                await stream.aclose()
        return agg.finish().to_dict()

    async def _unary(self, conn: _Connection, req: _Request, ctx: Context,
                     stream: AsyncIterator[Annotated], agg, model: str = "") -> None:
        d = await self._fold(conn, req, ctx, stream, agg, model)
        if d is None:
            return
        tb = _usage_timing_block(ctx)
        if tb:
            usage = d.get("usage") or {}
            usage["timing"] = tb
            d["usage"] = usage
        await conn.send_json(200, d, self._resp_headers(ctx), req.keep_alive)

    # ------------------------------------------------------------ handlers

    async def _chat(self, conn: _Connection, req: _Request, ctx: Context) -> None:
        async def run():
            chat_req, execution = self._parse(
                req, ChatCompletionRequest, self.template and self.template.apply_chat)
            if not execution.supports_images and any(
                    isinstance(m.content, list) and any(
                        p.get("type") in ("image_url", "video_url") for p in m.content)
                    for m in chat_req.messages):
                # fail loudly instead of answering text-only (the
                # preprocessor lifts media parts out of the template)
                raise _Reply(501, "this model does not accept image input", "not_implemented")
            sig = _chat_prefix_sig(chat_req)
            prio = self._admit(req, chat_req, ctx, sig)
            timer = TokenTimer(self.metrics, chat_req.model)
            try:
                self._arm_deadline(ctx, chat_req)
                with self.metrics.track(chat_req.model, "chat_completions"), \
                        self._trace_root(req, ctx, "chat_completions") as root:
                    root.set(model=chat_req.model, stream=bool(chat_req.stream), priority=prio)
                    stream = execution.chat_stream(chat_req, ctx, timer)
                    try:
                        # render and tokenize before any byte goes out, so a
                        # template's raise_exception is a 400 (the reference
                        # lets it escape as a 500 or a cut stream)
                        first = await anext(stream, None)
                    except ValueError as e:
                        await stream.aclose()
                        raise _Reply(400, f"invalid request: {e}") from None
                    stream = _prepend(first, stream)
                    if chat_req.stream:
                        await self._stream_sse(conn, req, ctx, stream, chat_req.model)
                    else:
                        await self._unary(conn, req, ctx, stream, ChatDeltaAggregator(),
                                          chat_req.model)
            finally:
                self._release(chat_req.model, ctx, sig, timer)
        await self._reply(conn, req, ctx, run)

    async def _completions(self, conn: _Connection, req: _Request, ctx: Context) -> None:
        async def run():
            comp_req, execution = self._parse(
                req, CompletionRequest, self.template and self.template.apply_completion)
            sig = _completion_prefix_sig(comp_req)
            self._admit(req, comp_req, ctx, sig)
            timer = TokenTimer(self.metrics, comp_req.model)
            try:
                self._arm_deadline(ctx, comp_req)
                with self.metrics.track(comp_req.model, "completions"), \
                        self._trace_root(req, ctx, "completions") as root:
                    root.set(model=comp_req.model, stream=bool(comp_req.stream))
                    stream = execution.completion_stream(comp_req, ctx, timer)
                    if comp_req.stream:
                        await self._stream_sse(conn, req, ctx, stream, comp_req.model)
                    else:
                        await self._unary(conn, req, ctx, stream, CompletionAggregator(),
                                          comp_req.model)
            finally:
                self._release(comp_req.model, ctx, sig, timer)
        await self._reply(conn, req, ctx, run)

    async def _responses(self, conn: _Connection, req: _Request, ctx: Context) -> None:
        """The OpenAI Responses API, unary (service.py:1318-1430): a text
        ``input`` becomes a chat request run through the chat chain, and
        the aggregate is reshaped into a Response object. Items input,
        ``tools``, ``tool_choice`` and ``previous_response_id`` get 501."""
        async def run():
            try:
                body = json.loads(req.body)
            except ValueError as e:
                raise _Reply(400, f"invalid request: {e}") from None
            if not isinstance(body, dict):
                raise _Reply(400, "request body must be a JSON object")
            if self.template is not None:
                body = self.template.apply_responses(body)
            inp = body.get("input")
            if not isinstance(inp, str):
                raise _Reply(501, "only text input is supported", "not_implemented")
            for fld in ("tools", "tool_choice", "previous_response_id"):
                if body.get(fld):
                    raise _Reply(501, f"`{fld}` is not supported", "not_implemented")
            chat_body: dict[str, Any] = {"model": body.get("model", ""),
                                         "messages": [{"role": "user", "content": inp}],
                                         "stream": False}
            for src, dst in (("temperature", "temperature"), ("top_p", "top_p"),
                             ("max_output_tokens", "max_completion_tokens")):
                if body.get(src) is not None:
                    chat_body[dst] = body[src]
            if body.get("top_logprobs") is not None:
                chat_body["logprobs"] = True
                chat_body["top_logprobs"] = min(int(body["top_logprobs"]), 20)
            try:
                chat_req = ChatCompletionRequest.from_dict(chat_body)
            except ValueError as e:
                raise _Reply(400, f"invalid request: {e}") from None
            execution = self.manager.get(chat_req.model)
            if execution is None:
                raise _Reply(404, f"model {chat_req.model!r} not found", "not_found_error")
            sig = _chat_prefix_sig(chat_req)
            self._admit(req, chat_req, ctx, sig)
            timer = TokenTimer(self.metrics, chat_req.model)
            try:
                self._arm_deadline(ctx, chat_req)
                with self.metrics.track(chat_req.model, "responses"), \
                        self._trace_root(req, ctx, "responses"):
                    d = await self._fold(conn, req, ctx, execution.chat_stream(chat_req, ctx, timer),
                                         ChatDeltaAggregator(), chat_req.model)
            finally:
                self._release(chat_req.model, ctx, sig, timer)
            if d is None:
                return
            choices = d.get("choices") or []
            content = (choices[0].get("message") or {}).get("content") or "" if choices else ""
            await conn.send_json(200, {
                "id": f"resp_{uuid.uuid4().hex}",
                "object": "response",
                "created_at": int(time.time()),
                "model": chat_req.model,
                "status": "completed",
                "output": [{
                    "type": "message",
                    "id": f"msg_{uuid.uuid4().hex}",
                    "role": "assistant",
                    "status": "completed",
                    "content": [{"type": "output_text", "text": content, "annotations": []}],
                }],
            }, self._resp_headers(ctx), req.keep_alive)
        await self._reply(conn, req, ctx, run)

    async def _models(self, conn: _Connection, req: _Request, ctx: Context) -> None:
        listing = ModelList(data=[ModelInfo(id=name) for name in self.manager.list_models()])
        await conn.send_json(200, listing.to_dict(), keep_alive=req.keep_alive)

    async def _health(self, conn: _Connection, req: _Request, ctx: Context) -> None:
        await conn.send_json(200, {"status": "healthy", "models": self.manager.list_models()},
                             keep_alive=req.keep_alive)

    async def _metrics(self, conn: _Connection, req: _Request, ctx: Context) -> None:
        await conn.send_text(200, self.metrics.render(), CONTENT_TYPE_LATEST,
                             keep_alive=req.keep_alive)

    async def _embeddings(self, conn: _Connection, req: _Request, ctx: Context) -> None:
        """OpenAI embeddings (service.py:1265-1316): each input tokenized
        (token ids as they are), pooled by the model's ``embed_fn``, and
        the prompt tokens counted in ``usage``."""
        async def run():
            try:
                emb_req = EmbeddingRequest.from_dict(json.loads(req.body))
            except ValueError as e:
                raise _Reply(400, f"invalid request: {e}") from None
            execution = self.manager.get(emb_req.model)
            if execution is None:
                raise _Reply(404, f"model {emb_req.model!r} not found", "not_found_error")
            if execution.embed_fn is None:
                raise _Reply(501, "this model does not serve embeddings", "not_implemented")
            inputs = emb_req.input
            if isinstance(inputs, str):
                inputs = [inputs]
            elif inputs and isinstance(inputs[0], int):
                inputs = [inputs]
            tokenizer = execution.preprocessor.tokenizer
            data, prompt_tokens = [], 0
            with self.metrics.track(emb_req.model, "embeddings"):
                for i, item in enumerate(inputs):
                    ids = list(item) if isinstance(item, list) else tokenizer.encode(str(item)).ids
                    prompt_tokens += len(ids)
                    vec = await execution.embed_fn(ids)
                    data.append({"object": "embedding", "index": i,
                                 "embedding": [float(x) for x in vec]})
            await conn.send_json(200, {
                "object": "list", "data": data, "model": emb_req.model,
                "usage": {"prompt_tokens": prompt_tokens, "total_tokens": prompt_tokens},
            }, self._resp_headers(ctx), req.keep_alive)
        await self._reply(conn, req, ctx, run)

    async def _debug_profile(self, conn: _Connection, req: _Request, ctx: Context) -> None:
        """Open a device profile window (service.py:1678-1692):
        ``?seconds=N[&dir=PATH]``; it closes itself and its trace lands
        under ``DYN_PROFILE_DIR``."""
        try:
            seconds = float(req.query.get("seconds", "5"))
        except ValueError:
            await conn.send_json(400, {"error": {"message": "seconds must be a number",
                                                 "type": "invalid_request_error"}},
                                 keep_alive=req.keep_alive)
            return
        info = dprofile.start(seconds, req.query.get("dir") or None)
        status = 200
        if "error" in info:
            status = 409 if "already" in info["error"] else 501
        await conn.send_json(status, info, keep_alive=req.keep_alive)

    async def _debug_slo(self, conn: _Connection, req: _Request, ctx: Context) -> None:
        """The frontend's SLO status: per-model burn rates, window
        percentiles and the ok / burning / breached state, evaluated on
        demand, beside the brownout ladder's status."""
        if not dslo.SloConfig.from_env().enabled:
            body = {"enabled": False,
                    "hint": "set DYN_SLO_TTFT_MS / DYN_SLO_ITL_MS or DYN_SLO_CONFIG",
                    # brownout can still step off remote slo-status events
                    "brownout": self.brownout.status()}
        else:
            body = {"enabled": True, "scope": "frontend", "models": self._slo_observe_all(),
                    "brownout": self.brownout.status()}
        await conn.send_json(200, body, keep_alive=req.keep_alive)

    async def _debug_traces_list(self, conn: _Connection, req: _Request, ctx: Context) -> None:
        """The retained trace exemplars (DYN_TRACE=auto's flight recorder)
        with their retention reasons, newest last."""
        if not dtrace.enabled():
            await conn.send_json(404, {"error": {"message": "tracing is disabled (set DYN_TRACE=1 or auto)",
                                                 "type": "not_found_error"}},
                                 keep_alive=req.keep_alive)
            return
        rec = dslo.recorder()
        await conn.send_json(200, {"mode": "auto" if dtrace.auto() else "always",
                                   "stats": rec.stats(), "traces": rec.entries()},
                             keep_alive=req.keep_alive)

    @staticmethod
    async def _wait_assembled(probe: Callable[[], Any]) -> Any:
        """Wait-bounded assembly (``DYN_TRACE_ASSEMBLE_MS``, 250 ms): spans
        that arrive only through the ``trace-export`` fallback race the
        watcher's ingest, so ``probe`` is polled until it yields something
        or the budget lapses."""
        try:
            budget_ms = float(os.environ.get("DYN_TRACE_ASSEMBLE_MS", "250") or 250)
        except ValueError:
            budget_ms = 250.0
        deadline = time.monotonic() + max(0.0, budget_ms) / 1e3
        out = probe()
        while not out and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
            out = probe()
        return out

    async def _debug_trace(self, conn: _Connection, req: _Request, ctx: Context) -> None:
        """One request's assembled cross-process trace as Chrome
        trace-event JSON (Perfetto, chrome://tracing); the path takes the
        request id (x-request-id / Context id) or a raw trace id."""
        if not dtrace.enabled():
            await conn.send_json(404, {"error": {"message": "tracing is disabled (set DYN_TRACE=1)",
                                                 "type": "not_found_error"}},
                                 keep_alive=req.keep_alive)
            return
        rid = req.path[len("/debug/traces/"):]
        spans = await self._wait_assembled(
            lambda: dtrace.spans_for_trace(dtrace.trace_for_request(rid) or rid))
        tid = dtrace.trace_for_request(rid) or rid
        if not spans:
            if dtrace.trace_for_request(rid) is None:
                await conn.send_json(404, {"error": {"message": f"no trace for request {rid!r}",
                                                     "type": "not_found_error"}},
                                     keep_alive=req.keep_alive)
                return
            # the request is known (its root opened here) but its spans did
            # not land within the budget: partial, not 404
            await conn.send_json(200, {"traceEvents": [], "displayTimeUnit": "ms",
                                       "otherData": {"trace_id": tid, "request_id": rid,
                                                     "partial": True}},
                                 keep_alive=req.keep_alive)
            return
        doc = dtrace.chrome_trace(tid)
        doc["otherData"]["request_id"] = rid
        doc["otherData"]["breakdown"] = dtrace.breakdown(tid)
        doc["otherData"]["partial"] = False
        await conn.send_json(200, doc, keep_alive=req.keep_alive)

    async def _clear_kv_blocks(self, conn: _Connection, req: _Request, ctx: Context) -> None:
        """Drop every worker group's reusable KV state (the reference's
        service.py:1431-1460): per model, cleared with its workers' answers,
        or failed (no ``clear_fn``, or it raised)."""
        models = self.manager.list_models()
        if not models:
            await conn.send_json(200, {"message": "No active worker groups found"},
                                 keep_alive=req.keep_alive)
            return
        cleared, failed = [], []
        for name in models:
            execution = self.manager.get(name)
            if execution is None or execution.clear_fn is None:
                failed.append({"name": name,
                               "status": "worker group doesn't support clear_kv_blocks"})
                continue
            try:
                results = await execution.clear_fn()
                cleared.append({"name": name, "status": "cleared", "workers": results})
            except Exception as e:  # noqa: BLE001 - reported per group
                failed.append({"name": name, "status": "error", "error": str(e)})
        await conn.send_json(200, {"cleared_worker_groups": cleared,
                                   "failed_worker_groups": failed}, keep_alive=req.keep_alive)


async def _prepend(first: Optional[Annotated], rest: AsyncIterator[Annotated]) -> AsyncIterator[Annotated]:
    try:
        if first is not None:
            yield first
            async for item in rest:
                yield item
    finally:
        with contextlib.suppress(Exception):
            await rest.aclose()
