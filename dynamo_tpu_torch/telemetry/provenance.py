"""Decision provenance: a bounded, always-on ledger of why each
control-plane actor chose what it chose.

The port's own copy of dynamo_tpu/telemetry/provenance.py (stdlib only),
with the same closed taxonomy, ring, ``DYN_DECISIONS`` modes, wire dicts
and digest, so a record written by a process of either package is read by
the other's frontend and ``tools/explain.py``:

  * every actor (router, admission, QoS, engine, hedger, health,
    brownout, planner, upgrade) emits a typed ``DecisionRecord`` naming
    the chosen outcome, the alternatives it scored, and a reason slug
    from a **closed taxonomy** (``record`` raises on anything else);
  * records land in a per-process ring (``DYN_DECISIONS_RING``, 4096);
    evictions are counted;
  * ``DYN_DECISIONS=0`` turns ``record()`` into one module-global check;
  * ``DYN_DECISIONS=auto`` keeps a request's records only when the
    completed request breached its SLO, errored, migrated or was sampled
    (``telemetry/slo.retention_reason``, the trace plane's verdict);
  * request-scoped records ride back to the frontend on the final
    response frame (``LLMEngineOutput.decisions``) or the ``trace-export``
    event, are deduplicated on ingest, and assemble into one
    cross-process timeline at ``GET /debug/decisions/{request_id}``;
  * fleet-scoped records (no request id; keyed by an epoch label) feed
    ``GET /debug/fleet``;
  * ``digest()`` hashes only deterministic fields (never clocks or ids),
    so the same seeded scenario gives the same digest.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from collections import OrderedDict, deque
from typing import Any, Optional

# ---------------------------------------------------------------- taxonomy

# Closed actor -> kinds taxonomy. record() rejects anything else: the whole
# value of a "why ledger" is that every consumer (explain.py, grafana, the
# sim digest, SURVEY mappings) can enumerate the vocabulary.
TAXONOMY: dict[str, tuple[str, ...]] = {
    # KV-aware worker selection: per-candidate overlap/load/health scores,
    # plus the cross-worker prefix pull plan and its outcome.
    "router": ("route", "prefix_pull"),
    # watermark math / class fractions / cold-prefix heat at the front door
    "admission": ("admit", "shed"),
    # which QoS class the request resolved to, and from which source
    "qos": ("priority",),
    # engine-side preemption victim choice and re-admission backoff
    "engine": ("preempt", "readmit"),
    # cross-worker request lifecycle owned by RemoteEngine
    "remote": ("hedge", "migrate"),
    # health scorer ejection / probation / re-entry ticks
    "health": ("eject", "probe", "restore"),
    # brownout ladder rung transitions
    "brownout": ("level",),
    # planner decide / arbitrate / freeze steps
    "planner": ("scale", "freeze"),
    # fleet upgrade coordinator phase edges
    "upgrade": ("phase",),
}

_TRUTHY = ("1", "true", "on", "yes")

# DYN_DECISIONS modes: "0" off, "auto" = record everything but decide
# request-record RETENTION at completion (flight-recorder mode), anything
# truthy or unset = always-retain. The ledger is always-on by default —
# explaining yesterday's refused request must not require a restart.
_mode: str = os.environ.get("DYN_DECISIONS", "1").strip().lower() or "1"
_auto: bool = _mode == "auto"
_enabled: bool = _auto or _mode in _TRUTHY


def enabled() -> bool:
    return _enabled


def auto() -> bool:
    """True when request-record retention is decided per request."""
    return _auto


def set_enabled(on: bool) -> None:
    """Flip the ledger at runtime (tests, benchmarks). Clears auto mode."""
    global _enabled, _auto
    _enabled = bool(on)
    _auto = False


def set_mode(mode: str) -> None:
    """Set the DYN_DECISIONS mode by name: '0'/'1'/'auto'."""
    global _enabled, _auto
    m = (mode or "0").strip().lower()
    _auto = m == "auto"
    _enabled = _auto or m in _TRUTHY


def usage_enabled(env: Optional[dict] = None) -> bool:
    """DYN_DECISIONS_USAGE=1: inline the decision timeline into the
    SSE/unary ``usage.timing`` payload (opt-in; responses get bigger)."""
    env = env if env is not None else os.environ
    return str(env.get("DYN_DECISIONS_USAGE", "0")).strip().lower() in _TRUTHY


class DecisionRecord:
    """One control-plane choice: who decided what, over which alternatives,
    and why. Request-scoped records carry request_id/trace_id; fleet-scoped
    records carry an epoch label (model name, component, fence id...)."""

    __slots__ = (
        "rec_id", "actor", "kind", "chosen", "alternatives", "reason",
        "request_id", "trace_id", "epoch", "proc", "pid",
        "t_ns", "unix_ns", "attrs", "remote",
    )

    def __init__(
        self,
        actor: str,
        kind: str,
        chosen: Any,
        alternatives: Optional[list[dict[str, Any]]],
        reason: str,
        request_id: Optional[str],
        trace_id: Optional[str],
        epoch: Optional[str],
        proc: str,
        attrs: Optional[dict[str, Any]] = None,
    ) -> None:
        self.rec_id = uuid.uuid4().hex[:16]
        self.actor = actor
        self.kind = kind
        self.chosen = chosen
        self.alternatives = alternatives or []
        self.reason = reason
        self.request_id = request_id
        self.trace_id = trace_id
        self.epoch = epoch
        self.proc = proc
        self.pid = os.getpid()
        self.t_ns = time.monotonic_ns()
        self.unix_ns = time.time_ns()
        self.attrs = attrs or {}
        self.remote = False  # True for records ingested from another process

    # ---------------------------------------------------------------- wire

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "rec_id": self.rec_id,
            "actor": self.actor,
            "kind": self.kind,
            "chosen": self.chosen,
            "reason": self.reason,
            "proc": self.proc,
            "pid": self.pid,
            "t_ns": self.t_ns,
            "unix_ns": self.unix_ns,
        }
        if self.alternatives:
            d["alternatives"] = self.alternatives
        if self.request_id is not None:
            d["request_id"] = self.request_id
        if self.trace_id is not None:
            d["trace_id"] = self.trace_id
        if self.epoch is not None:
            d["epoch"] = self.epoch
        if self.attrs:
            d["attrs"] = self.attrs
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "DecisionRecord":
        r = cls.__new__(cls)
        r.rec_id = d.get("rec_id", "")
        r.actor = d.get("actor", "?")
        r.kind = d.get("kind", "?")
        r.chosen = d.get("chosen")
        r.alternatives = d.get("alternatives") or []
        r.reason = d.get("reason", "")
        r.request_id = d.get("request_id")
        r.trace_id = d.get("trace_id")
        r.epoch = d.get("epoch")
        r.proc = d.get("proc", "?")
        r.pid = int(d.get("pid", 0))
        r.t_ns = int(d.get("t_ns", 0))
        r.unix_ns = int(d.get("unix_ns", 0))
        r.attrs = d.get("attrs") or {}
        r.remote = True
        return r

    def stable_key(self) -> str:
        """Deterministic identity line: every timestamp/uuid excluded, so
        same-seed sim runs hash bit-identically (see ``digest``)."""
        alts = json.dumps(self.alternatives, sort_keys=True, default=str)
        attrs = json.dumps(self.attrs, sort_keys=True, default=str)
        return "|".join(
            (
                self.actor,
                self.kind,
                str(self.chosen),
                self.reason,
                self.request_id or "",
                self.epoch or "",
                alts,
                attrs,
            )
        )


class Ledger:
    """Per-process decision sink: bounded ring + per-(actor,kind) counters
    for the metrics plane. Evictions (ring wrap) are counted, mirroring
    the flight-recorder's dropped accounting."""

    def __init__(
        self, proc: Optional[str] = None, ring: Optional[int] = None
    ) -> None:
        if ring is None:
            try:
                ring = int(os.environ.get("DYN_DECISIONS_RING", "4096") or 4096)
            except ValueError:
                ring = 4096
        self.proc = proc or os.environ.get(
            "DYN_TRACE_PROC", f"proc-{os.getpid()}"
        )
        self._ring: deque[DecisionRecord] = deque(maxlen=max(16, ring))
        # retention verdicts for completed requests in auto mode
        self._retained: OrderedDict[str, str] = OrderedDict()
        self._counts: dict[tuple[str, str], int] = {}
        self._lock = threading.Lock()
        self.dropped_total = 0      # ring evictions
        self.discarded_total = 0    # auto-mode retention discards

    # ------------------------------------------------------------- record

    def _record(self, rec: DecisionRecord) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped_total += 1
            self._ring.append(rec)
            key = (rec.actor, rec.kind)
            self._counts[key] = self._counts.get(key, 0) + 1

    def ingest(self, rec_dicts: list[dict[str, Any]]) -> int:
        """File records shipped from another process (deduped by rec_id).
        Ingest is idempotent and order-insensitive, which is what makes
        merge associative: A+(B+C) == (A+B)+C record-set-wise."""
        if not rec_dicts:
            return 0
        with self._lock:
            seen = {r.rec_id for r in self._ring}
            n = 0
            for d in rec_dicts:
                try:
                    rec = DecisionRecord.from_dict(d)
                except Exception:  # noqa: BLE001 — malformed wire record
                    continue
                if rec.rec_id and rec.rec_id not in seen:
                    seen.add(rec.rec_id)
                    if len(self._ring) == self._ring.maxlen:
                        self.dropped_total += 1
                    self._ring.append(rec)
                    n += 1
            return n

    # -------------------------------------------------- retention (auto)

    def keep_request(self, request_id: str, reason: str) -> None:
        """Auto mode: tag a completed request's records as retained."""
        with self._lock:
            self._retained[str(request_id)] = reason
            self._retained.move_to_end(str(request_id))
            while len(self._retained) > 1024:
                self._retained.popitem(last=False)

    def discard_request(self, request_id: str) -> int:
        """Auto mode: drop an unremarkable completed request's records."""
        rid = str(request_id)
        with self._lock:
            kept = [r for r in self._ring if r.request_id != rid]
            n = len(self._ring) - len(kept)
            if n:
                self._ring.clear()
                self._ring.extend(kept)
                self.discarded_total += n
            return n

    def retention_of(self, request_id: str) -> Optional[str]:
        with self._lock:
            return self._retained.get(str(request_id))

    # -------------------------------------------------------------- query

    def records_for_request(self, request_id: str) -> list[DecisionRecord]:
        rid = str(request_id)
        with self._lock:
            return [r for r in self._ring if r.request_id == rid]

    def fleet_records(
        self, actor: Optional[str] = None, limit: int = 256
    ) -> list[DecisionRecord]:
        """Most-recent-last fleet-scoped records (no request affiliation)."""
        with self._lock:
            out = [
                r
                for r in self._ring
                if r.request_id is None
                and (actor is None or r.actor == actor)
            ]
        return out[-limit:]

    def counts(self) -> dict[tuple[str, str], int]:
        with self._lock:
            return dict(self._counts)

    def ring_len(self) -> int:
        with self._lock:
            return len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._retained.clear()
            self._counts.clear()


_ledger: Optional[Ledger] = None
_ledger_lock = threading.Lock()


def ledger() -> Ledger:
    global _ledger
    if _ledger is None:
        with _ledger_lock:
            if _ledger is None:
                _ledger = Ledger()
    return _ledger


def reset(proc: Optional[str] = None, ring: Optional[int] = None) -> Ledger:
    """Replace the process ledger (tests, sim runs)."""
    global _ledger
    with _ledger_lock:
        _ledger = Ledger(proc=proc, ring=ring)
    return _ledger


# ------------------------------------------------------------------ record


def record(
    actor: str,
    kind: str,
    chosen: Any = None,
    *,
    reason: str = "",
    alternatives: Optional[list[dict[str, Any]]] = None,
    ctx: Any = None,
    request_id: Optional[str] = None,
    trace_id: Optional[str] = None,
    epoch: Optional[str] = None,
    proc: Optional[str] = None,
    **attrs: Any,
) -> Optional[DecisionRecord]:
    """Append one decision to the ring. The disabled path is one global
    check — call sites never branch. ``ctx`` (a pipeline Context) supplies
    request_id and the riding trace id when given explicitly.

    Raises ValueError for actors/kinds outside TAXONOMY: every emitter is
    in-repo, and an open vocabulary would quietly rot the digest, the
    metrics labels, and explain.py's rendering.
    """
    if not _enabled:
        return None
    kinds = TAXONOMY.get(actor)
    if kinds is None or kind not in kinds:
        raise ValueError(f"unknown decision {actor}/{kind} (closed taxonomy)")
    if ctx is not None:
        if request_id is None:
            request_id = getattr(ctx, "id", None)
        if trace_id is None:
            md = getattr(ctx, "metadata", None)
            if isinstance(md, dict):
                tc = md.get("trace")
                if isinstance(tc, dict):
                    trace_id = tc.get("tid")
    rec = DecisionRecord(
        actor,
        kind,
        chosen,
        alternatives,
        reason,
        str(request_id) if request_id is not None else None,
        trace_id,
        epoch,
        proc or ledger().proc,
        attrs or None,
    )
    ledger()._record(rec)
    return rec


def maybe_retain(request_id: Optional[str], reason: Optional[str]) -> None:
    """Flight-recorder retention hook (auto mode only): the frontend calls
    this at request completion with ``dslo.retention_reason``'s verdict.
    None discards the request's records; a slug keeps and tags them."""
    if not _auto or not request_id:
        return
    led = ledger()
    if reason is None:
        led.discard_request(request_id)
    else:
        led.keep_request(request_id, reason)


# --------------------------------------------------------- assembly / wire


def records_for_request(request_id: str) -> list[DecisionRecord]:
    return ledger().records_for_request(request_id)


def export_for_request(request_id: Optional[str]) -> list[dict[str, Any]]:
    """Wire form of a request's records (what workers ship back on the
    final response frame / trace-export fallback)."""
    if not request_id:
        return []
    return [r.to_dict() for r in records_for_request(request_id)]


def ingest(rec_dicts: list[dict[str, Any]]) -> int:
    return ledger().ingest(rec_dicts)


def timeline(request_id: str) -> list[dict[str, Any]]:
    """Cross-process causal timeline: records sorted by unix anchor (the
    common clock across processes; same contract the trace plane and the
    deadline plane already rely on), with monotonic ns as the intra-
    process tiebreak."""
    recs = sorted(
        records_for_request(request_id), key=lambda r: (r.unix_ns, r.t_ns)
    )
    return [r.to_dict() for r in recs]


def digest(records: Optional[list[DecisionRecord]] = None) -> str:
    """Order-sensitive sha256 over the deterministic fields of `records`
    (default: the whole ring). Same seed + same code ⇒ same digest: this
    is the sim's bit-identical replayable decision evidence."""
    import hashlib

    if records is None:
        led = ledger()
        with led._lock:
            records = list(led._ring)
    h = hashlib.sha256()
    for r in records:
        h.update(r.stable_key().encode())
        h.update(b"\n")
    return h.hexdigest()


def stable_lines(records: Optional[list[DecisionRecord]] = None) -> list[str]:
    """The exact lines `digest` hashes — when two runs' digests diverge,
    diffing these lines names the first decision that went differently."""
    if records is None:
        led = ledger()
        with led._lock:
            records = list(led._ring)
    return [r.stable_key() for r in records]


def counts() -> dict[tuple[str, str], int]:
    """(actor, kind) -> decisions recorded (for dyn_llm_decisions_total)."""
    return ledger().counts()


def dropped_total() -> int:
    """Ring evictions (for dyn_llm_decision_ring_dropped_total)."""
    return ledger().dropped_total


def fleet_summary(limit: int = 64) -> dict[str, Any]:
    """Recent fleet-scoped decisions grouped by actor, for /debug/fleet."""
    led = ledger()
    out: dict[str, Any] = {}
    for rec in led.fleet_records(limit=limit * 4):
        out.setdefault(rec.actor, []).append(rec.to_dict())
    for actor in out:
        out[actor] = out[actor][-limit:]
    return out
