"""OpenAI-compatible HTTP service on an asyncio HTTP/1.1 server.

The port's own copy of dynamo_tpu/http/service.py (``ModelExecution``,
``chat_stream``, ``completion_stream``, ``ModelManager``, ``HttpService``)
on ``asyncio.start_server`` in place of aiohttp, which the card's machine
lacks. Routes: ``POST /v1/chat/completions`` and ``POST /v1/completions``
(SSE when ``stream`` is set, else one JSON body folded from the same
stream; ``n`` >= 1 choices merged into one stream), ``GET /v1/models`` and
``GET /health``, and the admin route ``POST /clear_kv_blocks`` (every
model's ``clear_fn``: its engine's reusable KV state dropped, the
reference's per-worker-group answer); any other route gets 404 with the reference's error
payload. A malformed body gets 400 ``invalid_request_error``, an unknown
model 404 ``not_found_error``, image parts and tools 501
``not_implemented``.

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

Tokenizing, templating and detokenizing run on the event loop, per request,
as in the reference; the engine keeps its device calls on its own thread.
Not ported: Prometheus ``/metrics``, admission and brownout, SLO tracking,
tracing, embeddings, ``/v1/responses`` and tool calling.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import json
import logging
import os
import re
import time
from typing import Any, AsyncIterator, Callable, Optional

from dynamo_tpu_torch import qos
from dynamo_tpu_torch.backend import Backend, EngineFn, detokenize
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
    ModelInfo,
    ModelList,
)
from dynamo_tpu_torch.protocols.sse import encode_done, encode_json_event

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
                 clear_fn: Optional[Callable] = None) -> None:
        self.mdc = mdc
        self.engine_fn = engine_fn
        # async () -> [per-worker dict]: drops the workers' reusable KV
        self.clear_fn = clear_fn
        self.preprocessor = OpenAIPreprocessor(mdc)
        self.backend = Backend(self.preprocessor.tokenizer)

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

    async def _stream(self, pre, gen, ctx, emit_chunk, emit_finish, include_usage) -> AsyncIterator[Annotated]:
        counters = {"completion": 0}
        try:
            async for chunk in self._merged_choices(
                self._fanout(pre), ctx, emit_chunk, emit_finish, counters
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
            yield Annotated.from_data(
                gen.usage_chunk(len(pre.token_ids), counters["completion"]).to_dict()
            )

    async def chat_stream(self, request: ChatCompletionRequest, ctx: Context) -> AsyncIterator[Annotated]:
        pre, prompt = self.preprocessor.preprocess_chat(request)
        qos.stamp_priority(pre, ctx)  # the QoS class onto every wire hop
        for ann in self.preprocessor.requested_annotations(pre, prompt):
            yield ann
        gen = ChatDeltaGenerator(request.model)
        for i in range(max(1, pre.sampling.n or 1)):
            yield Annotated.from_data(gen.role_chunk(i).to_dict())
        async for item in self._stream(
            pre, gen, ctx,
            lambda step, i: [gen.text_chunk(step.text, index=i, logprobs=step.logprobs)],
            lambda reason, i: [gen.finish_chunk(reason, index=i)],
            bool(request.stream_options and request.stream_options.get("include_usage")),
        ):
            yield item

    async def completion_stream(self, request: CompletionRequest, ctx: Context) -> AsyncIterator[Annotated]:
        pre, prompt = self.preprocessor.preprocess_completion(request)
        qos.stamp_priority(pre, ctx)
        gen = CompletionDeltaGenerator(request.model)
        if request.echo and prompt:
            for i in range(max(1, pre.sampling.n or 1)):
                gen.note_echo(prompt, index=i)
                yield Annotated.from_data(gen.text_chunk(prompt, index=i).to_dict())
        async for item in self._stream(
            pre, gen, ctx,
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
        req = _Request(method.upper(), target.split("?", 1)[0], version, headers)
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

    async def send_chunk(self, text: str) -> None:
        data = text.encode("utf-8")
        if data:
            await self.send_raw(b"%x\r\n%s\r\n" % (len(data), data))

    async def end_chunks(self) -> None:
        await self.send_raw(b"0\r\n\r\n")


class _Reply(Exception):
    """A complete JSON reply decided before any byte was sent."""

    def __init__(self, status: int, message: str, typ: str = "invalid_request_error") -> None:
        super().__init__(message)
        self.status, self.body = status, {"error": {"message": message, "type": typ}}


class HttpService:
    def __init__(
        self,
        manager: Optional[ModelManager] = None,
        host: str = "0.0.0.0",
        port: int = 8080,
        template: Optional[Any] = None,  # request_template.RequestTemplate
    ) -> None:
        self.manager = manager or ModelManager()
        self.host = host
        self.port = port
        self.template = template
        self._server: Optional[asyncio.base_events.Server] = None
        self._conns: set[asyncio.Task] = set()
        self._inflight = 0  # requests being answered
        self._draining = False
        # a dynamic frontend's discovery.ModelWatcher (entrypoint.run_http)
        self.watcher: Optional[Any] = None
        self._routes = {
            ("POST", "/v1/chat/completions"): self._chat,
            ("POST", "/v1/completions"): self._completions,
            ("GET", "/v1/models"): self._models,
            ("GET", "/health"): self._health,
            ("POST", "/clear_kv_blocks"): self._clear_kv_blocks,
        }

    # ---------------------------------------------------------- lifecycle

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._serve_conn, self.host, self.port)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        logger.info("openai http service on %s:%d", self.host, self.port)

    async def close(self) -> None:
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
        return {"x-request-id": ctx.id}

    @staticmethod
    def _resolve_priority(req: _Request, api_req: Any, ctx: Context) -> None:
        """The QoS class at the edge: ``x-dyn-priority``, then
        ``ext.priority``, then ``DYN_PRIORITY_DEFAULT``, onto the Context."""
        ext = api_req.ext
        ctx.decisions().priority = qos.resolve_priority(
            req.headers.get("x-dyn-priority"), ext.priority if ext else None, api_req.model)

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
            await conn.send_json(r.status, r.body, self._resp_headers(ctx), req.keep_alive)

    async def _stream_sse(self, conn: _Connection, req: _Request, ctx: Context,
                          stream: AsyncIterator[Annotated]) -> None:
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

    async def _unary(self, conn: _Connection, req: _Request, ctx: Context,
                     stream: AsyncIterator[Annotated], agg) -> None:
        try:
            async for item in stream:
                if item.is_error():
                    payload = _error_payload(item.error_message())
                    payload.setdefault("request_id", ctx.id)
                    status = _CODE_STATUS.get(payload.get("code", "internal_error"), 500)
                    await conn.send_json(status, _error_body(payload), self._resp_headers(ctx), req.keep_alive)
                    return
                if item.data is not None:
                    agg.add(item.data)
        finally:
            with contextlib.suppress(Exception):
                await stream.aclose()
        await conn.send_json(200, agg.finish().to_dict(), self._resp_headers(ctx), req.keep_alive)

    # ------------------------------------------------------------ handlers

    async def _chat(self, conn: _Connection, req: _Request, ctx: Context) -> None:
        async def run():
            chat_req, execution = self._parse(
                req, ChatCompletionRequest, self.template and self.template.apply_chat)
            if any(isinstance(m.content, list) and any(
                    p.get("type") in ("image_url", "video_url") for p in m.content)
                    for m in chat_req.messages):
                raise _Reply(501, "this model does not accept image input", "not_implemented")
            if chat_req.tools:
                raise _Reply(501, "tool calling is not supported", "not_implemented")
            self._resolve_priority(req, chat_req, ctx)
            self._arm_deadline(ctx, chat_req)
            stream = execution.chat_stream(chat_req, ctx)
            try:
                # render and tokenize before any byte goes out, so a
                # template's raise_exception is a 400 (the reference lets
                # it escape as a 500 or a cut stream)
                first = await anext(stream, None)
            except ValueError as e:
                await stream.aclose()
                raise _Reply(400, f"invalid request: {e}") from None
            stream = _prepend(first, stream)
            if chat_req.stream:
                await self._stream_sse(conn, req, ctx, stream)
            else:
                await self._unary(conn, req, ctx, stream, ChatDeltaAggregator())
        await self._reply(conn, req, ctx, run)

    async def _completions(self, conn: _Connection, req: _Request, ctx: Context) -> None:
        async def run():
            comp_req, execution = self._parse(
                req, CompletionRequest, self.template and self.template.apply_completion)
            self._resolve_priority(req, comp_req, ctx)
            self._arm_deadline(ctx, comp_req)
            stream = execution.completion_stream(comp_req, ctx)
            if comp_req.stream:
                await self._stream_sse(conn, req, ctx, stream)
            else:
                await self._unary(conn, req, ctx, stream, CompletionAggregator())
        await self._reply(conn, req, ctx, run)

    async def _models(self, conn: _Connection, req: _Request, ctx: Context) -> None:
        listing = ModelList(data=[ModelInfo(id=name) for name in self.manager.list_models()])
        await conn.send_json(200, listing.to_dict(), keep_alive=req.keep_alive)

    async def _health(self, conn: _Connection, req: _Request, ctx: Context) -> None:
        await conn.send_json(200, {"status": "healthy", "models": self.manager.list_models()},
                             keep_alive=req.keep_alive)

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
