"""Remote prefill over the fabric: the port's twin of
dynamo_tpu/disagg/transfer.py.

  * ``RemotePrefillClient``, the decode worker's side: it subscribes a
    private reply subject, enqueues each prefill on the namespace's
    ``PrefillQueue``, lands every streamed KV frame before it reads the
    next message, and resolves the final response to the waiting request;
  * ``PrefillWorkerService``, the prefill worker's side: it pulls requests
    from the queue, runs the engine's ``prefill_only`` (or, for a streamed
    request, ``prefill_only_stream``, whose frames go out behind a bounded
    window while later chunks compute), publishes the final response after
    the last frame and acks the request. A request its worker never acks
    (the worker died) is redelivered to another; streamed frames are
    idempotent, so a re-served stream overwrites the same blocks.

The payload is dense ``[L, Hkv, n, bs, D]`` blocks on the host, so a prefill
engine and a decode engine of different tensor-parallel sizes need no
layout kernel: each decode rank slices its own heads out of the payload
(the role of the reference's comment here and of upstream's
``block_copy.cu``; the runner's ``inject_blocks*``).

Every message is packed with the port's msgpack codec (``fabric/mpack.py``,
byte-identical to the ``msgpack`` package), so the JAX package's workers and
the port's serve each other's queue. A final response whose packed size
would exceed the fabric's frame limit (``fabric/wire.MAX_FRAME``) is
answered with an error instead (``code="too_large"``), and a frame that
would is not sent: the decode worker then prefills locally at once, where
the oversized frame would break the worker's fabric connection and leave
the request to be redelivered again and again.

Tracing (``telemetry/trace.py``): the worker serves each request under a
``prefill_serve`` span parented from the request's ``extra["trace"]`` (the
decode engine's ``remote_prefill`` span), each published frame under a
``kv_frame_tx`` wire span, and ships its spans on the final response's
``trace``, which the client ingests. The ``corrupt_kv`` fault point
(``testing/faults.py``) corrupts each frame's payload and the final
response's after they were checksummed, so the decode side's verification
must refuse them.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import os
import uuid
from collections import deque
from dataclasses import dataclass
from typing import Any, Awaitable, Callable, Optional

from dynamo_tpu_torch import integrity
from dynamo_tpu_torch.disagg.prefill_queue import PrefillQueue
from dynamo_tpu_torch.disagg.protocols import (
    KvStreamFrame,
    PrefillStreamCancelled,
    RemotePrefillRequest,
    RemotePrefillResponse,
)
from dynamo_tpu_torch.fabric import mpack, wire
from dynamo_tpu_torch.fabric.client import FabricClient
from dynamo_tpu_torch.runtime import clock as dclock
from dynamo_tpu_torch.runtime.backoff import Backoff
from dynamo_tpu_torch.telemetry import trace as dtrace
from dynamo_tpu_torch.testing import faults

logger = logging.getLogger("dynamo_tpu_torch.disagg.transfer")

# room left under the fabric's frame limit for the publish op's own fields
_FRAME_SLACK = 64 * 1024


def _cancel_subject(namespace: str) -> str:
    return f"{namespace}.prefill_cancel"


def frame_window_from_env() -> int:
    """Frames in flight per stream (``DYN_KV_FRAME_WINDOW``, default 4): the
    prefill worker computes at most this many frames ahead of the wire, so
    a slow fabric holds back the chunks instead of buffering the whole
    prompt's KV in host memory."""
    try:
        return max(1, int(os.environ.get("DYN_KV_FRAME_WINDOW", "4") or 4))
    except ValueError:
        return 4


@dataclass
class TransferStats:
    """One side's KV data-plane counters (monotonic unless noted)."""

    frames_tx: int = 0
    frames_rx: int = 0
    bytes_tx: int = 0
    bytes_rx: int = 0
    frames_inflight: int = 0  # gauge: frames encoded, not yet published
    dropped_expired: int = 0  # queued requests dropped past their deadline
    streams_cancelled: int = 0  # streams ended by the requester's cancel
    too_large: int = 0  # frames or responses over the fabric's frame limit


def _fits(data: bytes) -> bool:
    return len(data) <= wire.MAX_FRAME - _FRAME_SLACK


def _corrupted(wire_d: dict) -> dict:
    """The ``corrupt_kv`` fault point: a frame's or final response's
    payload K bytes flipped or truncated after checksumming (the decode
    side's verify must catch it); the dict unchanged when the fault is off
    or does not fire."""
    if faults.active() and wire_d.get("payload"):
        inj = faults.get_injector()
        if inj is not None:
            bad = inj.corrupt_bytes(wire_d["payload"]["k"])
            if bad is not None:
                wire_d["payload"]["k"] = bad
    return wire_d


class RemotePrefillClient:
    """The decode worker's ``remote_prefill_client`` over the fabric."""

    def __init__(
        self,
        fabric: FabricClient,
        namespace: str,
        block_size: int = 16,
        timeout: float = 120.0,
        fences: Optional[Any] = None,  # runtime.fencing.FenceRegistry
    ) -> None:
        self._fabric = fabric
        self.namespace = namespace
        self.block_size = block_size
        self.timeout = timeout
        self.fences = fences
        self.queue = PrefillQueue(fabric, namespace)
        self.reply_subject = f"{namespace}.prefill_reply.{uuid.uuid4().hex[:12]}"
        self._pending: dict[str, asyncio.Future] = {}
        # request id -> frame handler of a streamed prefill in flight
        self._frame_handlers: dict[str, Callable[[KvStreamFrame], Awaitable[None]]] = {}
        self._sub = None
        self._pump_task: Optional[asyncio.Task] = None
        self.stats = TransferStats()

    async def start(self) -> None:
        self._sub = await self._fabric.subscribe(self.reply_subject)
        self._pump_task = asyncio.get_running_loop().create_task(self._pump())

    def _fenced(self, stamp) -> bool:
        return self.fences is not None and self.fences.check_stamp(stamp, "kv_stream")

    async def _land_frame(self, frame: KvStreamFrame) -> None:
        self.stats.frames_rx += 1
        self.stats.bytes_rx += frame.payload.wire_nbytes
        if self._fenced(frame.stamp):
            # a fenced (zombie) worker's frame: dropped, and the hole it
            # leaves makes the engine's coverage check prefill locally
            return
        try:
            # verified at landing, so a corrupt frame never reaches the
            # inject; the coverage check then recomputes locally
            frame.payload.verify()
        except integrity.IntegrityError as e:
            integrity.COUNTERS.integrity_failure("disagg_frame", str(e))
            return
        handler = self._frame_handlers.get(frame.request_id)
        if handler is not None:
            await handler(frame)

    def _check_final(self, resp: RemotePrefillResponse) -> None:
        """Refuse a final response from a fenced epoch, or one whose payload
        fails its checksums: the payload is dropped and an error set, so
        the engine prefills locally instead of decoding over it."""
        if self._fenced(resp.stamp):
            resp.payload, resp.error, resp.code = None, "prefill worker epoch is fenced", "fenced"
        elif resp.payload is not None:
            try:
                resp.payload.verify()
            except integrity.IntegrityError as e:
                integrity.COUNTERS.integrity_failure("disagg_final", str(e))
                resp.payload, resp.error, resp.code = None, str(e), "integrity"
        if resp.trace:
            # the prefill worker's spans ride the final response: into this
            # process's ring, and onward on the decode stream's final frame
            dtrace.ingest(resp.trace)
            resp.trace = None
        if resp.payload is not None:
            self.stats.bytes_rx += resp.payload.wire_nbytes

    async def _pump(self) -> None:
        assert self._sub is not None
        async for _subject, payload in self._sub:
            try:
                d = mpack.unpackb(payload)
                if isinstance(d, dict) and d.get("kind") == "frame":
                    # landed BEFORE the next message is read: the fabric
                    # delivers in publish order, so every frame sent before
                    # the final response has landed when it resolves
                    await self._land_frame(KvStreamFrame.from_wire(d))
                    continue
                resp = RemotePrefillResponse.from_wire(d)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 - malformed wire data
                logger.warning("bad prefill response dropped: %s", e)
                continue
            self._check_final(resp)
            fut = self._pending.pop(resp.request_id, None)
            if fut is not None and not fut.done():
                fut.set_result(resp)

    async def close(self) -> None:
        if self._sub is not None:
            await self._sub.unsubscribe()
        if self._pump_task is not None:
            self._pump_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._pump_task
        for fut in self._pending.values():
            if not fut.done():
                fut.cancel()
        self._pending.clear()
        self._frame_handlers.clear()

    async def _send_cancel(self, request_id: str) -> None:
        """Best effort: prefill workers drop or abort the request, so they
        stop computing and shipping KV that nobody will read."""
        with contextlib.suppress(Exception):
            await self._fabric.publish(_cancel_subject(self.namespace),
                                       mpack.packb({"request_id": request_id}))

    async def prefill(
        self,
        token_ids: list[int],
        *,
        temperature: float = 0.0,
        top_p: float = 1.0,
        top_k: int = 0,
        cached_blocks: int = 0,
        rep_pen: float = 1.0,
        key_data=None,
        eos_ids=None,
        eos_suppress: bool = False,
        stream: bool = False,
        on_frame: Optional[Callable[[KvStreamFrame], Awaitable[None]]] = None,
        deadline: Optional[float] = None,
        ctx: Any = None,
        extra: Optional[dict[str, Any]] = None,
    ) -> RemotePrefillResponse:
        """Enqueue one remote prefill and await its final response.

        With ``stream`` and ``on_frame`` each KV frame goes to ``on_frame``
        as it arrives, in order, before the final response resolves. The
        wait is bounded by the request's ``deadline`` (absolute epoch
        seconds) as well as this client's timeout, and a killed ``ctx``
        ends the stream on both sides (``PrefillStreamCancelled``)."""
        rid = uuid.uuid4().hex
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        streamed = bool(stream and on_frame is not None)
        if streamed:
            self._frame_handlers[rid] = on_frame
        req = RemotePrefillRequest(
            request_id=rid, token_ids=list(token_ids), reply_subject=self.reply_subject,
            temperature=temperature, top_p=top_p, top_k=top_k, cached_blocks=cached_blocks,
            block_size=self.block_size, rep_pen=rep_pen,
            key_data=[int(x) for x in key_data] if key_data is not None else None,
            eos_ids=[int(x) for x in eos_ids] if eos_ids is not None else None,
            eos_suppress=bool(eos_suppress), stream=streamed,
            deadline=float(deadline) if deadline is not None else None, extra=extra or {},
        )
        # the request's own budget wins over the flat timeout: a request
        # with 3 s left must not wait 120 s on the queue
        timeout = self.timeout
        if deadline is not None:
            timeout = max(0.05, min(timeout, deadline - dclock.wall()))
        try:
            # the enqueue is bounded by the same budget: a dark queue plane
            # raises at once (or at the deadline, mid-failover), and the
            # engine prefills locally
            await self.queue.enqueue(req, timeout=timeout)
            if ctx is None:
                return await asyncio.wait_for(fut, timeout=timeout)
            # watch the requester while waiting, so a killed sequence ends
            # the stream instead of waiting out the timeout
            end = dclock.now() + timeout
            while True:
                if ctx.is_killed() or ctx.is_stopped():
                    await self._send_cancel(rid)
                    self.stats.streams_cancelled += 1
                    raise PrefillStreamCancelled(rid)
                remaining = end - dclock.now()
                if remaining <= 0:
                    raise asyncio.TimeoutError(f"remote prefill {rid} timed out")
                try:
                    return await asyncio.wait_for(asyncio.shield(fut),
                                                  timeout=min(0.1, remaining))
                except asyncio.TimeoutError:
                    continue
        except BaseException:
            self._pending.pop(rid, None)
            raise
        finally:
            self._frame_handlers.pop(rid, None)


class PrefillWorkerService:
    """The prefill worker's loop: dequeue, prefill, reply, ack.

    ``engine`` is anything with ``async prefill_only(req)`` and, for
    streamed requests, ``async prefill_only_stream(req, emit, cancelled)``
    (``TorchEngine`` has both). A request left unacked by a dead worker is
    redelivered by the queue."""

    def __init__(
        self,
        fabric: FabricClient,
        namespace: str,
        engine: Any,
        max_inflight: int = 2,
        frame_window: Optional[int] = None,
        stamp: Optional[dict] = None,  # runtime.fencing.make_stamp(...)
    ) -> None:
        self._fabric = fabric
        self.namespace = namespace
        self.queue = PrefillQueue(fabric, namespace)
        self.engine = engine
        self.frame_window = frame_window or frame_window_from_env()
        self.stamp = stamp
        self._sem = asyncio.Semaphore(max_inflight)
        self._task: Optional[asyncio.Task] = None
        self._inflight: set[asyncio.Task] = set()
        self._stopped = asyncio.Event()
        self.served = 0
        self.stats = TransferStats()
        # the requesters' cancels; memory bounded: the oldest ids age out
        self._cancelled: set[str] = set()
        self._cancel_order: deque[str] = deque()
        self._cancel_sub = None
        self._cancel_task: Optional[asyncio.Task] = None

    async def start(self) -> None:
        self._cancel_sub = await self._fabric.subscribe(_cancel_subject(self.namespace))
        loop = asyncio.get_running_loop()
        self._cancel_task = loop.create_task(self._cancel_pump())
        self._task = loop.create_task(self._loop())

    async def _cancel_pump(self) -> None:
        assert self._cancel_sub is not None
        async for _subject, payload in self._cancel_sub:
            try:
                rid = mpack.unpackb(payload)["request_id"]
            except Exception:  # noqa: BLE001 - a malformed cancel
                continue
            self._cancelled.add(rid)
            self._cancel_order.append(rid)
            while len(self._cancel_order) > 1024:
                self._cancelled.discard(self._cancel_order.popleft())

    async def _loop(self) -> None:
        # repeated dequeue failures back off with full jitter; a success
        # resets the ladder
        backoff = Backoff(base_s=0.2, cap_s=5.0)
        while not self._stopped.is_set():
            await self._sem.acquire()
            try:
                got = await self.queue.dequeue(timeout=0.2)
                backoff.reset()
            except asyncio.CancelledError:
                self._sem.release()
                raise
            except Exception as e:  # noqa: BLE001 - a transient fabric error
                # a dead loop would silently stop the prefill fleet: log,
                # back off, keep serving
                logger.warning("prefill dequeue failed (%s); retrying", e)
                self._sem.release()
                await backoff.sleep()
                continue
            if got is None:
                self._sem.release()
                continue
            msg_id, req = got
            logger.info("prefill worker pid %d took %s: %d tokens%s", os.getpid(),
                        req.request_id, len(req.token_ids), " (streamed)" if req.stream else "")
            t = asyncio.get_running_loop().create_task(self._serve_one(msg_id, req))
            self._inflight.add(t)
            t.add_done_callback(self._inflight.discard)

    # ------------------------------------------------------------ serving

    def _is_cancelled(self, req: RemotePrefillRequest) -> bool:
        return req.request_id in self._cancelled or (
            req.deadline is not None and dclock.wall() > req.deadline)

    def _bump_engine_stat(self, attr: str, delta: int) -> None:
        """Mirror a counter onto the engine's stats, which its load metrics
        publish."""
        stats = getattr(self.engine, "stats", None)
        if stats is not None and hasattr(stats, attr):
            setattr(stats, attr, getattr(stats, attr) + delta)

    def _make_emit(self, req: RemotePrefillRequest) -> tuple[Callable, Callable]:
        """(emit, drain) for one stream. ``emit`` publishes a frame in the
        background, at most ``frame_window`` frames unpublished (a slow
        wire holds back the chunks); ``drain`` awaits every publish, so the
        final response goes out after the last frame."""
        sem = asyncio.Semaphore(self.frame_window)
        tasks: list[asyncio.Task] = []

        async def emit(frame: KvStreamFrame) -> None:
            await sem.acquire()
            self.stats.frames_inflight += 1
            self._bump_engine_stat("kv_frames_inflight", 1)
            if self.stamp is not None:
                frame.stamp = self.stamp
            data = mpack.packb(_corrupted(frame.to_wire()))

            async def publish() -> None:
                try:
                    if not _fits(data):
                        # never sent: the hole makes the requester prefill
                        # locally (its coverage check)
                        self.stats.too_large += 1
                        logger.warning("frame %d of %s is %d bytes, over the fabric's limit; "
                                       "not sent", frame.seq, req.request_id, len(data))
                        return
                    # the task inherits the serving span's context, so the
                    # frame's wire time lands on the prefill worker's track
                    with dtrace.wire_span("kv_frame_tx", seq=frame.seq,
                                          nbytes=frame.payload.wire_nbytes):
                        await self._fabric.publish(req.reply_subject, data)
                    self.stats.frames_tx += 1
                    self.stats.bytes_tx += frame.payload.wire_nbytes
                finally:
                    self.stats.frames_inflight -= 1
                    self._bump_engine_stat("kv_frames_inflight", -1)
                    sem.release()

            tasks.append(asyncio.get_running_loop().create_task(publish()))

        async def drain() -> None:
            if tasks:
                await asyncio.gather(*tasks, return_exceptions=True)

        return emit, drain

    async def _run_prefill(self, req: RemotePrefillRequest) -> Optional[RemotePrefillResponse]:
        """Serve one request; None when the requester's cancel ended the
        stream (nothing to publish)."""
        if req.deadline is not None and dclock.wall() > req.deadline:
            # expired in the queue: no compute for KV nobody will read
            self.stats.dropped_expired += 1
            self._bump_engine_stat("prefill_dropped_expired", 1)
            return RemotePrefillResponse(request_id=req.request_id, first_token=-1,
                                         error="deadline expired in prefill queue",
                                         code="deadline_exceeded")
        if req.request_id in self._cancelled:
            self.stats.streams_cancelled += 1
            return RemotePrefillResponse(request_id=req.request_id, first_token=-1,
                                         error="cancelled by requester", code="cancelled")
        streaming = bool(req.stream) and hasattr(self.engine, "prefill_only_stream")
        try:
            if streaming:
                emit, drain = self._make_emit(req)
                try:
                    resp = await self.engine.prefill_only_stream(
                        req, emit, cancelled=lambda: self._is_cancelled(req))
                finally:
                    await drain()  # the final response after every frame
                if resp is None:
                    self.stats.streams_cancelled += 1
                return resp
            return await self.engine.prefill_only(req)
        except Exception as e:  # noqa: BLE001 - the error crosses the wire
            logger.exception("remote prefill %s failed", req.request_id)
            return RemotePrefillResponse(request_id=req.request_id, first_token=-1, error=str(e))

    async def _serve_one(self, msg_id: int, req: RemotePrefillRequest) -> None:
        try:
            # trace context rides RemotePrefillRequest.extra["trace"]; the
            # serving span closes before the final response is published,
            # so the shipped export holds it
            tc = (req.extra or {}).get("trace")
            with dtrace.span_from_wire(
                "prefill_serve", tc, proc=getattr(self.engine, "trace_proc", None),
                request_id=req.request_id, tokens=len(req.token_ids), stream=bool(req.stream),
            ) as psp:
                resp = await self._run_prefill(req)
                if resp is not None and resp.code:
                    psp.set(code=resp.code)
            if resp is not None:
                if dtrace.enabled() and isinstance(tc, dict) and tc.get("tid"):
                    resp.trace = dtrace.export_for_trace(tc["tid"], include_remote=False)
                if self.stamp is not None:
                    resp.stamp = self.stamp
                data = mpack.packb(_corrupted(resp.to_wire()))
                if not _fits(data):
                    self.stats.too_large += 1
                    logger.warning("the response to %s is %d bytes, over the fabric's limit; "
                                   "answering an error", req.request_id, len(data))
                    resp = RemotePrefillResponse(
                        request_id=req.request_id, first_token=-1, code="too_large",
                        error=f"payload of {len(data)} bytes exceeds the fabric's frame limit",
                        stamp=self.stamp)
                    data = mpack.packb(resp.to_wire())
                elif resp.payload is not None:
                    self.stats.bytes_tx += resp.payload.wire_nbytes
                await self._fabric.publish(req.reply_subject, data)
            await self.queue.ack(msg_id)
            self.served += 1
        finally:
            self._sem.release()

    async def close(self) -> None:
        self._stopped.set()
        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._task
        if self._cancel_sub is not None:
            await self._cancel_sub.unsubscribe()
        if self._cancel_task is not None:
            self._cancel_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._cancel_task
        for t in list(self._inflight):
            t.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await t
