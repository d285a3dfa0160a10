"""Per-process system status server: /health, /live, /metrics.

The port's own copy of dynamo_tpu/runtime/http_server.py on
``asyncio.start_server`` and the port's stdlib registry (``runtime/prom.py``)
in place of aiohttp and ``prometheus_client``, which the card's machine
lacks. Role-equivalent of lib/runtime/src/http_server.rs (:90-91 health and
metrics routes), off by default as in the reference
(``DYN_RUNTIME_HTTP_ENABLED``, config.rs:87): every worker or router process
can expose liveness for supervisors and process-level Prometheus metrics
(uptime, its health checks' status, and whatever families its host
registers) apart from the LLM frontend.

The server answers ``GET`` requests of HTTP/1.1 clients (one request per
connection, ``Connection: close``) on its routes and those a host adds
(``add_route``); any other method or path gets 404.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import time
from typing import Awaitable, Callable, Optional

from dynamo_tpu_torch.runtime.prom import (
    CONTENT_TYPE_LATEST,
    CollectorRegistry,
    Gauge,
    generate_latest,
)

logger = logging.getLogger("dynamo_tpu_torch.runtime.http_server")

HealthCheck = Callable[[], Awaitable[bool]]

_REASONS = {200: "OK", 404: "Not Found", 503: "Service Unavailable"}
MAX_HEADER_BYTES = 64 * 1024


class SystemStatusServer:
    """Health / liveness and a Prometheus endpoint for one process."""

    def __init__(self, port: int = 0, host: str = "0.0.0.0",
                 registry: Optional[CollectorRegistry] = None) -> None:
        self.host = host
        self.port = port
        self.registry = registry or CollectorRegistry()
        self._start_time = time.monotonic()
        self._checks: dict[str, HealthCheck] = {}
        self._uptime = Gauge("dyn_runtime_uptime_seconds", "Process uptime",
                             registry=self.registry)
        self._health_gauge = Gauge("dyn_runtime_health", "1 if all health checks pass",
                                   registry=self.registry)
        self._routes = {
            "/health": self._health,
            "/live": self._live,
            "/metrics": self._metrics,
        }
        self._server: Optional[asyncio.base_events.Server] = None

    def add_health_check(self, name: str, check: HealthCheck) -> None:
        self._checks[name] = check

    def add_route(self, path: str, handler: Callable[[], Awaitable[tuple[int, bytes, str]]]) -> None:
        """An extra ``GET`` route (http_server.py:67-70; the metrics
        component's ``/debug/slo`` and ``/debug/goodput``): ``handler``
        returns (status, body, content type)."""
        self._routes[path] = handler

    async def start(self) -> int:
        self._server = await asyncio.start_server(self._serve, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("system status server on :%d", self.port)
        return self.port

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _serve(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
            parts = head[:MAX_HEADER_BYTES].split(b"\r\n", 1)[0].decode("latin-1").split(" ")
            method = parts[0].upper() if parts else ""
            path = parts[1].split("?", 1)[0] if len(parts) > 1 else ""
            handler = self._routes.get(path) if method == "GET" else None
            if handler is None:
                status, body, ctype = 404, b'{"error": "not found"}', "application/json"
            else:
                status, body, ctype = await handler()
            writer.write((f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}\r\n"
                          f"Content-Type: {ctype}\r\nContent-Length: {len(body)}\r\n"
                          "Connection: close\r\n\r\n").encode("latin-1") + body)
            await writer.drain()
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError, ConnectionError):
            pass
        except Exception:  # noqa: BLE001 — one bad request must not stop the server
            logger.exception("status request failed")
        finally:
            writer.close()
            with contextlib.suppress(Exception):
                await writer.wait_closed()

    # ------------------------------------------------------------ handlers

    async def _run_checks(self) -> dict[str, bool]:
        out = {}
        for name, check in self._checks.items():
            try:
                out[name] = bool(await check())
            except Exception:  # noqa: BLE001 — a failing check is "false"
                out[name] = False
        return out

    async def _health(self) -> tuple[int, bytes, str]:
        checks = await self._run_checks()
        healthy = all(checks.values())
        self._health_gauge.set(1.0 if healthy else 0.0)
        body = {"status": "healthy" if healthy else "unhealthy",
                "uptime_s": round(time.monotonic() - self._start_time, 3), "checks": checks}
        return 200 if healthy else 503, json.dumps(body).encode(), "application/json"

    async def _live(self) -> tuple[int, bytes, str]:
        return 200, b'{"status": "live"}', "application/json"

    async def _metrics(self) -> tuple[int, bytes, str]:
        self._uptime.set(time.monotonic() - self._start_time)
        return 200, generate_latest(self.registry), CONTENT_TYPE_LATEST
