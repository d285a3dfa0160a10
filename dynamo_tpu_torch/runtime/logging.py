"""Structured logging: pretty console or JSONL, env-controlled.

The port's own copy of dynamo_tpu/runtime/logging.py.

Role-equivalent of the reference runtime's tracing-subscriber setup
(lib/runtime/src/logging.rs): `DYN_LOG` filter syntax ("info",
"debug,dynamo_tpu_torch.router=trace"), `DYN_LOGGING_JSONL=1` for machine-readable
JSON lines with span-style extra fields.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Callable, Optional

_INITIALIZED = False

# Optional provider of ambient structured fields (trace_id/request_id):
# registered by the telemetry layer so every with_fields line joins logs
# to traces without call sites threading ids through (telemetry/trace.py
# current_fields). Kept as a late-bound hook — logging must stay importable
# before/without telemetry.
_context_fields_fn: Optional[Callable[[], dict]] = None


def set_context_fields_provider(fn: Optional[Callable[[], dict]]) -> None:
    global _context_fields_fn
    _context_fields_fn = fn

_LEVELS = {
    "trace": 5,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}

logging.addLevelName(5, "TRACE")


class JsonlFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out: dict[str, Any] = {
            "time": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.gmtime(record.created)
            )
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
        }
        fields = getattr(record, "fields", None)
        if fields:
            out.update(fields)
        if record.exc_info and record.exc_info[0] is not None:
            out["exception"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


class PrettyFormatter(logging.Formatter):
    # the full date and milliseconds (``2026-01-31 12:00:00,123``), where
    # the reference prints the time of day: tooling reads event times from
    # the port's process logs at ms resolution
    def __init__(self) -> None:
        super().__init__(fmt="%(asctime)s %(levelname)-5s %(name)s: %(message)s")

    def format(self, record: logging.LogRecord) -> str:
        base = super().format(record)
        fields = getattr(record, "fields", None)
        if fields:
            kv = " ".join(f"{k}={v}" for k, v in fields.items())
            base = f"{base} [{kv}]"
        return base


def _parse_filter(spec: str) -> tuple[int, dict[str, int]]:
    """Parse "info,dynamo_tpu_torch.router=trace" into (default, per-target)."""
    default = logging.INFO
    targets: dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            name, lvl = part.split("=", 1)
            targets[name.strip()] = _LEVELS.get(lvl.strip().lower(), logging.INFO)
        else:
            default = _LEVELS.get(part.lower(), logging.INFO)
    return default, targets


def init(
    level: Optional[str] = None,
    jsonl: Optional[bool] = None,
    force: bool = False,
) -> None:
    """Idempotent global logging init honoring DYN_LOG / DYN_LOGGING_JSONL.

    A repeat call is a no-op UNLESS `force=True` — the explicit re-init
    path for processes that need to tighten/retarget logging after an
    early import already initialized it (serve.py children, tests).
    Without `force`, explicit `level=`/`jsonl=` args on a repeat call are
    rejected loudly instead of silently ignored."""
    global _INITIALIZED
    if _INITIALIZED and not force:
        if level is not None or jsonl is not None:
            logging.getLogger(__name__).warning(
                "logging.init(level=%r, jsonl=%r) ignored: already "
                "initialized (pass force=True to re-init)",
                level, jsonl,
            )
        return
    _INITIALIZED = True
    spec = level if level is not None else os.environ.get("DYN_LOG", "info")
    use_jsonl = (
        jsonl
        if jsonl is not None
        else os.environ.get("DYN_LOGGING_JSONL", "0") in ("1", "true")
    )
    default, targets = _parse_filter(spec)
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(JsonlFormatter() if use_jsonl else PrettyFormatter())
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(default)
    for name, lvl in targets.items():
        logging.getLogger(name).setLevel(lvl)


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)


def with_fields(logger: logging.Logger, level: int, msg: str, **fields: Any) -> None:
    """Log with structured span-style fields (rendered in both formats).
    Ambient trace identity (trace_id/request_id from the registered
    provider) is merged in automatically so logs and traces join."""
    if _context_fields_fn is not None:
        try:
            ambient = _context_fields_fn()
        except Exception:  # noqa: BLE001 — logging must never throw
            ambient = None
        if ambient:
            fields = {**ambient, **fields}
    logger.log(level, msg, extra={"fields": fields})
