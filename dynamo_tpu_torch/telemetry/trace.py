"""Lightweight distributed tracing: spans in a bounded per-process ring.

The port's own copy of dynamo_tpu/telemetry/trace.py. An exported span is
the same dict the JAX package exports (same keys, 32-hex trace ids and
16-hex span ids), so spans of either package ingest into the other.

Design constraints:

  * near-zero cost when disabled — ``span()`` returns a shared singleton
    no-op context manager; no object is allocated, no clock is read;
  * trace context rides the existing wire hops inside ``Context.metadata``
    (serialized by ``Context.to_header``), so no transport changes;
  * timestamps: ``time.monotonic_ns()`` for intra-process ordering and
    durations (never goes backwards), plus one ``time.time_ns()`` anchor
    per span so spans from different processes land on a common timeline
    when assembled (same-host or NTP-synced fleet — the same contract the
    deadline plane already relies on);
  * completed spans land in a ``deque(maxlen=...)`` ring — tracing a
    24/7 server is memory-bounded by construction.

W3C interop: HTTP ingress honors/mints ``traceparent``; trace ids are
32-hex, span ids 16-hex, so exported traces splice into external tooling.

``DYN_TRACE`` takes ``0`` (off, the default), ``1`` (every request's
spans retained) and ``auto`` (spans recorded for every request, retention
decided at completion by the SLO plane's ``retention_reason`` and kept in
its flight recorder, ``telemetry/slo.py``). Every ``with_fields`` log line
(``runtime/logging.py``) carries the ambient trace and request ids.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
import uuid
from collections import OrderedDict, deque
from typing import Any, Iterator, Optional

# Trace context key inside Context.metadata (rides Context.to_header).
CTX_KEY = "trace"

# Namespace event subject for the metrics-plane span shipping fallback:
# workers publish completed request spans here when the response stream
# was torn down before its final frame could carry them (frontend-side
# stop sequences, client disconnects, kills).
EXPORT_SUBJECT = "trace-export"

_TRUTHY = ("1", "true", "on", "yes")

# DYN_TRACE modes: "0" off, truthy = always-retain, "auto" = record spans
# for every request but decide RETENTION at completion (the flight-
# recorder tail-sampling mode, telemetry/slo.py).
_mode: str = os.environ.get("DYN_TRACE", "0").strip().lower()
_auto: bool = _mode == "auto"
_enabled: bool = _auto or _mode in _TRUTHY

# current span (for nesting) and current logical process label (lets one OS
# process host several logical roles in tests and colocated deployments
# while keeping distinct trace tracks)
_current_span: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "dyn_trace_current", default=None
)
_proc_label: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "dyn_trace_proc", default=None
)


def enabled() -> bool:
    return _enabled


def auto() -> bool:
    """True when retention is decided per request (DYN_TRACE=auto)."""
    return _auto


def set_enabled(on: bool) -> None:
    """Flip tracing at runtime (tests, benchmarks). Clears auto mode:
    set_enabled(True) is the always-retain mode."""
    global _enabled, _auto
    _enabled = bool(on)
    _auto = False


def set_mode(mode: str) -> None:
    """Set the DYN_TRACE mode by name: '0' / '1' / 'auto'."""
    global _enabled, _auto
    m = (mode or "0").strip().lower()
    _auto = m == "auto"
    _enabled = _auto or m in _TRUTHY


def _new_trace_id() -> str:
    return uuid.uuid4().hex  # 32 hex chars (W3C trace-id width)


def _new_span_id() -> str:
    return uuid.uuid4().hex[:16]  # 16 hex chars (W3C span-id width)


class Span:
    """One timed phase of one request in one process."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "proc", "pid",
        "start_ns", "end_ns", "start_unix_ns", "attrs", "events", "remote",
    )

    def __init__(
        self,
        name: str,
        trace_id: str,
        parent_id: Optional[str],
        proc: str,
        attrs: Optional[dict[str, Any]] = None,
    ) -> None:
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.proc = proc
        self.pid = os.getpid()
        self.start_ns = time.monotonic_ns()
        self.start_unix_ns = time.time_ns()
        self.end_ns: Optional[int] = None
        self.attrs: dict[str, Any] = attrs or {}
        self.events: list[dict[str, Any]] = []
        self.remote = False  # True for spans ingested from another process

    # ------------------------------------------------------------- surface

    def set(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    def event(self, name: str, **attrs: Any) -> None:
        """Point-in-time marker inside this span (deadline expiry, watchdog
        trip, migration, frame landing, ...)."""
        ev: dict[str, Any] = {"name": name, "ns": time.monotonic_ns()}
        if attrs:
            ev["attrs"] = attrs
        self.events.append(ev)

    def end(self) -> None:
        if self.end_ns is None:
            self.end_ns = time.monotonic_ns()

    @property
    def dur_ns(self) -> int:
        end = self.end_ns if self.end_ns is not None else time.monotonic_ns()
        return max(0, end - self.start_ns)

    @property
    def dur_ms(self) -> float:
        return self.dur_ns / 1e6

    # ---------------------------------------------------------------- wire

    def to_dict(self) -> dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "proc": self.proc,
            "pid": self.pid,
            "start_ns": self.start_ns,
            "start_unix_ns": self.start_unix_ns,
            "dur_ns": self.dur_ns,
            "attrs": self.attrs,
            "events": self.events,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Span":
        s = cls.__new__(cls)
        s.trace_id = d.get("trace_id", "")
        s.span_id = d.get("span_id", "")
        s.parent_id = d.get("parent_id")
        s.name = d.get("name", "span")
        s.proc = d.get("proc", "?")
        s.pid = int(d.get("pid", 0))
        s.start_ns = int(d.get("start_ns", 0))
        s.start_unix_ns = int(d.get("start_unix_ns", 0))
        s.end_ns = s.start_ns + int(d.get("dur_ns", 0))
        s.attrs = d.get("attrs") or {}
        s.events = d.get("events") or []
        s.remote = True
        return s


class _NullSpan:
    """Shared do-nothing span: the disabled fast path and the no-active-
    trace path both hand this out, so call sites never branch."""

    __slots__ = ()
    trace_id = ""
    span_id = ""
    parent_id = None
    name = ""
    dur_ns = 0
    dur_ms = 0.0

    def set(self, **attrs: Any) -> None:
        pass

    def event(self, name: str, **attrs: Any) -> None:
        pass

    def end(self) -> None:
        pass


NULL_SPAN = _NullSpan()


class _NullCM:
    """Reusable no-op context manager (no per-call allocation)."""

    __slots__ = ()

    def __enter__(self) -> _NullSpan:
        return NULL_SPAN

    def __exit__(self, *exc: Any) -> bool:
        return False


NULL_CM = _NullCM()


class _SpanCM:
    """Context manager recording one live span; restores the previous
    current-span on exit and files the finished span into the ring.

    Context-variable resets are best-effort: a span opened inside an async
    generator may be closed from a different task's context (aclose during
    stream teardown), where ``Token.reset`` raises — tracing must absorb
    that, never the request path."""

    __slots__ = ("_span", "_token", "_proc_token", "_ctx", "_restore")

    def __init__(self, sp: Span, ctx: Any, restore: Any) -> None:
        self._span = sp
        self._ctx = ctx
        self._restore = restore
        self._token: Optional[contextvars.Token] = None
        self._proc_token: Optional[contextvars.Token] = None

    def __enter__(self) -> Span:
        self._token = _current_span.set(self._span)
        # children opened under this span (same process) inherit its track
        self._proc_token = _proc_label.set(self._span.proc)
        return self._span

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        sp = self._span
        if exc is not None and exc_type is not GeneratorExit:
            sp.set(error=f"{getattr(exc_type, '__name__', exc_type)}: {exc}")
        sp.end()
        for var, token in (
            (_current_span, self._token),
            (_proc_label, self._proc_token),
        ):
            if token is not None:
                with contextlib.suppress(ValueError):
                    var.reset(token)
        # restore the ctx's wire trace-parent if we rewired it (attach=True)
        if self._ctx is not None:
            md = getattr(self._ctx, "metadata", None)
            if isinstance(md, dict):
                if self._restore is not None:
                    md[CTX_KEY] = self._restore
                else:
                    md.pop(CTX_KEY, None)
        tracer()._record(sp)
        return False


class Tracer:
    """Per-process span sink: bounded ring of finished spans plus a small
    request-id -> trace-id index for `/debug/traces/{request_id}`."""

    def __init__(
        self, proc: Optional[str] = None, ring: Optional[int] = None
    ) -> None:
        if ring is None:
            try:
                ring = int(os.environ.get("DYN_TRACE_RING", "4096") or 4096)
            except ValueError:
                ring = 4096
        self.proc = proc or os.environ.get(
            "DYN_TRACE_PROC", f"proc-{os.getpid()}"
        )
        self._ring: deque[Span] = deque(maxlen=max(16, ring))
        self._requests: OrderedDict[str, str] = OrderedDict()
        # counter-track samples: (name, proc, unix_ns, value), bounded the
        # same way the span ring is
        self._counters: deque[tuple[str, str, int, float]] = deque(
            maxlen=max(16, ring)
        )
        self._lock = threading.Lock()

    # ------------------------------------------------------------- record

    def _record(self, sp: Span) -> None:
        with self._lock:
            self._ring.append(sp)

    def record_counter(self, name: str, value: float) -> None:
        with self._lock:
            self._counters.append(
                (
                    name,
                    _proc_label.get() or self.proc,
                    time.time_ns(),
                    float(value),
                )
            )

    def counters_between(
        self, start_ns: int, end_ns: int
    ) -> list[tuple[str, str, int, float]]:
        with self._lock:
            return [
                c for c in self._counters if start_ns <= c[2] <= end_ns
            ]

    def ingest(self, span_dicts: list[dict[str, Any]]) -> int:
        """File spans shipped from another process (deduped by span_id)."""
        if not span_dicts:
            return 0
        with self._lock:
            seen = {s.span_id for s in self._ring}
            n = 0
            for d in span_dicts:
                try:
                    sp = Span.from_dict(d)
                except Exception:  # noqa: BLE001 — malformed wire span
                    continue
                if sp.span_id and sp.span_id not in seen:
                    seen.add(sp.span_id)
                    self._ring.append(sp)
                    n += 1
            return n

    def remember_request(self, request_id: str, trace_id: str) -> None:
        with self._lock:
            self._requests[request_id] = trace_id
            self._requests.move_to_end(request_id)
            while len(self._requests) > 1024:
                self._requests.popitem(last=False)

    # -------------------------------------------------------------- query

    def trace_for_request(self, request_id: str) -> Optional[str]:
        with self._lock:
            return self._requests.get(request_id)

    def spans_for_trace(
        self, trace_id: str, include_remote: bool = True
    ) -> list[Span]:
        with self._lock:
            return [
                s
                for s in self._ring
                if s.trace_id == trace_id and (include_remote or not s.remote)
            ]

    def ring_len(self) -> int:
        with self._lock:
            return len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._requests.clear()


_tracer: Optional[Tracer] = None
_tracer_lock = threading.Lock()


def tracer() -> Tracer:
    global _tracer
    if _tracer is None:
        with _tracer_lock:
            if _tracer is None:
                _tracer = Tracer()
    return _tracer


def reset(proc: Optional[str] = None, ring: Optional[int] = None) -> Tracer:
    """Replace the process tracer (tests)."""
    global _tracer
    with _tracer_lock:
        _tracer = Tracer(proc=proc, ring=ring)
    return _tracer


@contextlib.contextmanager
def process_scope(label: Optional[str]) -> Iterator[None]:
    """Scoped logical-process label: spans opened inside use `label` as
    their process track. Lets one OS process host several roles (worker
    handlers set this per served endpoint; tests get distinct tracks for
    free). `None` is a no-op scope."""
    if label is None:
        yield
        return
    token = _proc_label.set(label)
    try:
        yield
    finally:
        with contextlib.suppress(ValueError):
            _proc_label.reset(token)


# -------------------------------------------------------- context plumbing


def current_fields() -> dict[str, Any]:
    """The ambient trace / request identity for log-line injection
    (runtime/logging.py)."""
    sp = _current_span.get()
    if sp is None:
        return {}
    out: dict[str, Any] = {"trace_id": sp.trace_id}
    rid = sp.attrs.get("request_id")
    if rid:
        out["request_id"] = rid
    return out


def ctx_trace(ctx: Any) -> tuple[Optional[str], Optional[str]]:
    """(trace_id, parent_span_id) carried by a pipeline Context."""
    if ctx is None:
        return None, None
    md = getattr(ctx, "metadata", None)
    if not md:
        return None, None
    tc = md.get(CTX_KEY)
    if not isinstance(tc, dict):
        return None, None
    return tc.get("tid"), tc.get("sid")


def ctx_trace_id(ctx: Any) -> Optional[str]:
    return ctx_trace(ctx)[0]


def inject(ctx: Any, sp: Span) -> None:
    """Make `sp` the wire parent for everything dispatched under `ctx`."""
    ctx.metadata[CTX_KEY] = {"tid": sp.trace_id, "sid": sp.span_id}


# ----------------------------------------------------------- span creation


def span(
    name: str,
    ctx: Any = None,
    parent: Optional[Span] = None,
    proc: Optional[str] = None,
    attach: bool = False,
    **attrs: Any,
):
    """Open a phase span. Parent resolution order: explicit `parent`, the
    trace context riding `ctx`, then the task-local current span. With no
    affiliation the call is a no-op (phase spans never start traces —
    use `root_span` at the ingress edge).

    `attach=True` additionally rewires ctx's wire trace-parent to this
    span for its duration, so downstream hops parent under it."""
    if not _enabled:
        return NULL_CM
    trace_id: Optional[str] = None
    parent_id: Optional[str] = None
    if parent is not None and not isinstance(parent, _NullSpan):
        trace_id, parent_id = parent.trace_id, parent.span_id
    if trace_id is None:
        trace_id, parent_id = ctx_trace(ctx)
    if trace_id is None:
        cur = _current_span.get()
        if cur is not None:
            trace_id, parent_id = cur.trace_id, cur.span_id
    if trace_id is None:
        return NULL_CM
    sp = Span(
        name,
        trace_id,
        parent_id,
        proc or _proc_label.get() or tracer().proc,
        attrs or None,
    )
    restore: Any = None
    if attach and ctx is not None:
        restore = ctx.metadata.get(CTX_KEY)
        inject(ctx, sp)
    return _SpanCM(sp, ctx if attach else None, restore)


def root_span(
    name: str,
    ctx: Any,
    trace_id: Optional[str] = None,
    parent_id: Optional[str] = None,
    proc: Optional[str] = None,
    **attrs: Any,
):
    """Open the trace root at an ingress edge, minting a trace id (or
    honoring an inbound `traceparent`), and install the trace context on
    `ctx` so every downstream hop joins the same trace."""
    if not _enabled:
        return NULL_CM
    inherited_tid, inherited_sid = ctx_trace(ctx)
    tid = trace_id or inherited_tid or _new_trace_id()
    pid = parent_id if parent_id is not None else inherited_sid
    sp = Span(
        name, tid, pid, proc or _proc_label.get() or tracer().proc, attrs or None
    )
    inject(ctx, sp)
    rid = attrs.get("request_id") or getattr(ctx, "id", None)
    if rid:
        sp.attrs.setdefault("request_id", rid)
        tracer().remember_request(str(rid), tid)
    return _SpanCM(sp, None, None)


def begin(
    name: str,
    ctx: Any = None,
    parent: Optional[Span] = None,
    proc: Optional[str] = None,
    **attrs: Any,
) -> Optional[Span]:
    """Manually-managed span for phases that start and end in different
    tasks (engine queue wait, batch loops). Deliberately does NOT fall
    back to the task-local current span — engine-loop tasks inherit a
    stale context from whoever first created them. Pair with `finish`."""
    if not _enabled:
        return None
    trace_id: Optional[str] = None
    parent_id: Optional[str] = None
    if parent is not None and not isinstance(parent, _NullSpan):
        trace_id, parent_id = parent.trace_id, parent.span_id
    if trace_id is None:
        trace_id, parent_id = ctx_trace(ctx)
    if trace_id is None:
        return None
    return Span(
        name, trace_id, parent_id, proc or tracer().proc, attrs or None
    )


def finish(sp: Optional[Span], **attrs: Any) -> None:
    """End and record a `begin` span (no-op for None / null spans)."""
    if sp is None or isinstance(sp, _NullSpan):
        return
    if attrs:
        sp.set(**attrs)
    sp.end()
    tracer()._record(sp)


def span_from_wire(
    name: str, tc: Any, proc: Optional[str] = None, **attrs: Any
):
    """Open a span parented from a raw wire trace-context dict
    ({"tid", "sid"} — e.g. RemotePrefillRequest.extra["trace"]) for hops
    that carry no pipeline Context."""
    if not _enabled or not isinstance(tc, dict) or not tc.get("tid"):
        return NULL_CM
    sp = Span(
        name,
        tc["tid"],
        tc.get("sid"),
        proc or _proc_label.get() or tracer().proc,
        attrs or None,
    )
    return _SpanCM(sp, None, None)


def wire_span(name: str, **attrs: Any):
    """Span for transport work (fabric publishes, frame lands): recorded
    only when a trace is already active on this task, so background
    traffic outside any request costs nothing and pollutes nothing."""
    if not _enabled:
        return NULL_CM
    cur = _current_span.get()
    if cur is None:
        return NULL_CM
    sp = Span(
        name,
        cur.trace_id,
        cur.span_id,
        _proc_label.get() or tracer().proc,
        attrs or None,
    )
    return _SpanCM(sp, None, None)


def event(name: str, **attrs: Any) -> None:
    """Attach a point event to the current span (no-op when none)."""
    if not _enabled:
        return
    cur = _current_span.get()
    if cur is not None:
        cur.event(name, **attrs)


def counter(name: str, value: float) -> None:
    """Record a counter-track sample (Perfetto "ph":"C") on the trace
    timeline next to the spans. No-op when tracing is disabled."""
    if not _enabled:
        return
    tracer().record_counter(name, value)


# -------------------------------------------------------------- W3C interop


def parse_traceparent(header: str) -> tuple[Optional[str], Optional[str]]:
    """'00-<32 hex>-<16 hex>-<flags>' -> (trace_id, span_id)."""
    try:
        parts = header.strip().lower().split("-")
        if len(parts) < 4:
            return None, None
        _, tid, sid = parts[0], parts[1], parts[2]
        int(tid, 16), int(sid, 16)
        if len(tid) != 32 or len(sid) != 16 or set(tid) == {"0"}:
            return None, None
        return tid, sid
    except (ValueError, AttributeError):
        return None, None


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


# ------------------------------------------------------- assembly / export


def spans_for_trace(trace_id: str, include_remote: bool = True) -> list[Span]:
    return tracer().spans_for_trace(trace_id, include_remote)


def trace_for_request(request_id: str) -> Optional[str]:
    return tracer().trace_for_request(request_id)


def export_for_trace(
    trace_id: Optional[str], include_remote: bool = True
) -> list[dict[str, Any]]:
    """Wire form of a trace's spans (what workers ship back on the final
    response frame)."""
    if not trace_id:
        return []
    return [s.to_dict() for s in spans_for_trace(trace_id, include_remote)]


def ingest(span_dicts: list[dict[str, Any]]) -> int:
    return tracer().ingest(span_dicts)


def _proc_pid(label: str) -> int:
    """Stable small synthetic pid for a logical-process track."""
    return (hash(label) & 0x7FFF) or 1


def chrome_trace(trace_id: str) -> dict[str, Any]:
    """Assemble one trace as Chrome trace-event / Perfetto JSON."""
    spans = sorted(spans_for_trace(trace_id), key=lambda s: s.start_unix_ns)
    events: list[dict[str, Any]] = []
    seen_procs: dict[str, int] = {}
    for s in spans:
        pid = seen_procs.get(s.proc)
        if pid is None:
            pid = _proc_pid(s.proc)
            seen_procs[s.proc] = pid
            events.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": 0,
                    "args": {"name": s.proc},
                }
            )
        ts_us = s.start_unix_ns / 1e3
        tid = (int(s.trace_id[:8], 16) & 0x7FFF) if s.trace_id else 1
        events.append(
            {
                "name": s.name,
                "cat": "span",
                "ph": "X",
                "pid": pid,
                "tid": tid,
                "ts": ts_us,
                "dur": max(s.dur_ns / 1e3, 0.001),
                "args": {
                    **s.attrs,
                    "span_id": s.span_id,
                    "parent_id": s.parent_id,
                },
            }
        )
        for ev in s.events:
            events.append(
                {
                    "name": ev["name"],
                    "cat": "event",
                    "ph": "i",
                    "s": "p",
                    "pid": pid,
                    "tid": tid,
                    # events carry process-monotonic ns; place them at the
                    # span anchor plus the monotonic offset into the span
                    "ts": (s.start_unix_ns + (ev["ns"] - s.start_ns)) / 1e3,
                    "args": ev.get("attrs") or {},
                }
            )
    if spans:
        # counter-track samples ("ph":"C") that fall inside the trace window
        lo = min(s.start_unix_ns for s in spans)
        hi = max(s.start_unix_ns + s.dur_ns for s in spans)
        for name, proc, ts_ns, value in tracer().counters_between(lo, hi):
            pid = seen_procs.get(proc)
            if pid is None:
                pid = _proc_pid(proc)
                seen_procs[proc] = pid
                events.append(
                    {
                        "name": "process_name",
                        "ph": "M",
                        "pid": pid,
                        "tid": 0,
                        "args": {"name": proc},
                    }
                )
            events.append(
                {
                    "name": name,
                    "cat": "counter",
                    "ph": "C",
                    "pid": pid,
                    "tid": 0,
                    "ts": ts_ns / 1e3,
                    "args": {"value": value},
                }
            )
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"trace_id": trace_id},
    }


def breakdown(trace_id: Optional[str]) -> dict[str, Any]:
    """Per-phase timing summary: {phase: {"ms", "count"}} + total span."""
    if not trace_id:
        return {}
    spans = spans_for_trace(trace_id)
    if not spans:
        return {}
    phases: dict[str, dict[str, Any]] = {}
    for s in spans:
        slot = phases.setdefault(s.name, {"ms": 0.0, "count": 0})
        slot["ms"] = round(slot["ms"] + s.dur_ms, 3)
        slot["count"] += 1
    start = min(s.start_unix_ns for s in spans)
    end = max(s.start_unix_ns + s.dur_ns for s in spans)
    return {
        "trace_id": trace_id,
        "total_ms": round((end - start) / 1e6, 3),
        "spans": len(spans),
        "phases": phases,
    }


# Join logs to traces: every with_fields log line picks up the ambient
# trace_id / request_id of the task that emitted it ({} when no span).
from dynamo_tpu_torch.runtime import logging as _dlog  # noqa: E402

_dlog.set_context_fields_provider(current_fields)


def maybe_write_trace(
    trace_id: Optional[str], request_id: Optional[str] = None
) -> Optional[str]:
    """Write the assembled Chrome trace to DYN_TRACE_DIR (one file per
    request). Returns the path, or None when the knob is unset."""
    out_dir = os.environ.get("DYN_TRACE_DIR")
    if not out_dir or not trace_id:
        return None
    try:
        os.makedirs(out_dir, exist_ok=True)
        name = f"trace-{request_id or trace_id}.json"
        # request ids are sanitized at ingress, but never trust a path
        name = name.replace("/", "_").replace("..", "_")
        path = os.path.join(out_dir, name)
        with open(path, "w") as f:
            json.dump(chrome_trace(trace_id), f)
        return path
    except OSError:
        return None
