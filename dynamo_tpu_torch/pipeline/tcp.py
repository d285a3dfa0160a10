"""TCP response plane: direct worker->caller streaming of response frames.

The port's own copy of dynamo_tpu/pipeline/tcp.py.

Role-equivalent of the reference's TcpStreamServer / CallHomeHandshake /
TwoPartCodec (lib/runtime/src/pipeline/network/tcp/server.rs:74,
codec/two_part.rs:23): the request travels over the fabric bus, but response
chunks stream straight back over a dedicated TCP connection from the worker to
the caller's per-process stream server — no broker hop on the hot token path.

Frame = length-prefixed msgpack [header: dict, payload: bytes] (wire.py).
Header "t" field: "hello" (handshake w/ stream subject), "data", "err", "end".
Caller-side cancellation: dropping the receiver closes the connection; the
sending worker observes the broken pipe and kills the request context.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
from typing import Optional

from dynamo_tpu_torch.fabric import wire

logger = logging.getLogger("dynamo_tpu_torch.pipeline.tcp")


class StreamReceiver:
    """Async iterator over response frames for one registered stream subject."""

    def __init__(self, server: "TcpResponseServer", subject: str) -> None:
        self._server = server
        self.subject = subject
        self._queue: "asyncio.Queue[Optional[tuple[dict, bytes]]]" = asyncio.Queue()
        self._writer: Optional[asyncio.StreamWriter] = None
        self._closed = False

    def _feed(self, item: Optional[tuple[dict, bytes]]) -> None:
        if not self._closed:
            self._queue.put_nowait(item)

    def __aiter__(self) -> "StreamReceiver":
        return self

    async def __anext__(self) -> tuple[dict, bytes]:
        if self._closed:
            raise StopAsyncIteration
        item = await self._queue.get()
        if item is None:
            self._closed = True
            self._server._unregister(self.subject)
            raise StopAsyncIteration
        return item

    def close(self) -> None:
        """Abandon the stream: closes the TCP connection, signalling the
        sender to cancel (reference: SSE disconnect monitor -> ctx.kill())."""
        self._closed = True
        self._server._unregister(self.subject)
        if self._writer is not None:
            with contextlib.suppress(Exception):
                self._writer.close()
        self._queue.put_nowait(None)


class TcpResponseServer:
    """Lazy per-process TCP server multiplexing inbound response streams."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self.host = host
        self.port = port
        self._server: Optional[asyncio.base_events.Server] = None
        self._streams: dict[str, StreamReceiver] = {}
        self._started = asyncio.Lock()

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    async def ensure_started(self) -> None:
        async with self._started:
            if self._server is not None:
                return
            self._server = await asyncio.start_server(
                self._handle, self.host, self.port
            )
            self.port = self._server.sockets[0].getsockname()[1]
            logger.debug("tcp response server on %s", self.addr)

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        for r in list(self._streams.values()):
            r._feed(None)
        self._streams.clear()

    def register_stream(self, subject: str) -> StreamReceiver:
        receiver = StreamReceiver(self, subject)
        self._streams[subject] = receiver
        return receiver

    def _unregister(self, subject: str) -> None:
        self._streams.pop(subject, None)

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        receiver: Optional[StreamReceiver] = None
        try:
            header, _ = await wire.read_frame(reader)
            if header.get("t") != "hello":
                logger.warning("bad handshake on response plane: %r", header)
                return
            subject = header.get("subject", "")
            receiver = self._streams.get(subject)
            if receiver is None:
                logger.warning("no registered stream for subject %s", subject)
                return
            receiver._writer = writer
            while True:
                frame_header, payload = await wire.read_frame(reader)
                t = frame_header.get("t")
                if t == "end":
                    receiver._feed(None)
                    receiver = None
                    return
                receiver._feed((frame_header, payload))
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        finally:
            if receiver is not None:
                # connection dropped before "end": surface as an error frame
                receiver._feed(({"t": "err"}, b"response stream disconnected"))
                receiver._feed(None)
            with contextlib.suppress(Exception):
                writer.close()
                await writer.wait_closed()


class StreamSender:
    """Worker-side: connects back to the caller and streams response frames."""

    def __init__(self, writer: asyncio.StreamWriter, reader: asyncio.StreamReader):
        self._writer = writer
        self._reader = reader
        self.broken = False

    @classmethod
    async def connect(cls, addr: str, subject: str) -> "StreamSender":
        host, _, port = addr.rpartition(":")
        reader, writer = await asyncio.open_connection(host, int(port))
        sender = cls(writer, reader)
        await sender._send({"t": "hello", "subject": subject}, b"")
        return sender

    async def _send(self, header: dict, payload: bytes) -> None:
        try:
            self._writer.write(wire.pack([header, payload]))
            await self._writer.drain()
        except (ConnectionResetError, BrokenPipeError, ConnectionAbortedError):
            self.broken = True
            raise

    async def send_data(self, payload: bytes) -> None:
        await self._send({"t": "data"}, payload)

    async def send_error(self, message: str) -> None:
        await self._send({"t": "err"}, message.encode())

    async def finish(self) -> None:
        with contextlib.suppress(Exception):
            await self._send({"t": "end"}, b"")
        await self.close()

    async def close(self) -> None:
        with contextlib.suppress(Exception):
            self._writer.close()
            await self._writer.wait_closed()
