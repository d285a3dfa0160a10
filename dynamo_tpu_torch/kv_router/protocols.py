"""Wire types for KV events and worker load metrics.

The port's own copy of dynamo_tpu/kv_router/protocols.py, with the same
dicts on the wire. ``ForwardPassMetrics.phase_histograms`` is typed
(``telemetry/histogram.PhaseHistograms``) and so is ``goodput``
(``telemetry/goodput.GoodputStats``); each travels as the reference's wire
dict, so a router of either package reads a worker of either.

Role-equivalent of lib/llm/src/kv_router/protocols.rs: KvCacheEvent
{Stored, Removed, Cleared} (:142-183) and ForwardPassMetrics
{WorkerStats, KvStats, SpecDecodeStats} (:43-104).

One deliberate simplification vs the reference: it carries two hashes per
block (``tokens_hash`` keying the radix tree, ``block_hash`` as the engine's
opaque id) because its engines assign ids the router cannot recompute. This
engine's block ids ARE the content-derived chain hashes (``tokens.py``), so
a single hash serves both roles; ``tokens_hash`` is kept as an optional
override for foreign engines.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from dynamo_tpu_torch.telemetry.goodput import GoodputStats
from dynamo_tpu_torch.telemetry.histogram import PhaseHistograms


@dataclass
class KvCacheStoredBlock:
    block_hash: int  # chained (prefix-unique) hash = engine block id
    tokens_hash: Optional[int] = None  # foreign-engine override for tree edges

    @property
    def edge_hash(self) -> int:
        return self.tokens_hash if self.tokens_hash is not None else self.block_hash

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {"block_hash": self.block_hash}
        if self.tokens_hash is not None:
            d["tokens_hash"] = self.tokens_hash
        return d


@dataclass
class KvCacheEvent:
    """One cache mutation. Exactly one of stored/removed/cleared is set."""

    event_id: int = 0
    # stored: parent_hash + ordered new blocks extending that parent
    parent_hash: Optional[int] = None
    stored: Optional[list[KvCacheStoredBlock]] = None
    # removed: block hashes no longer cached on the worker
    removed: Optional[list[int]] = None
    cleared: bool = False

    @classmethod
    def stored_event(
        cls, event_id: int, parent_hash: Optional[int], blocks: list[KvCacheStoredBlock]
    ) -> "KvCacheEvent":
        return cls(event_id=event_id, parent_hash=parent_hash, stored=blocks)

    @classmethod
    def removed_event(cls, event_id: int, block_hashes: list[int]) -> "KvCacheEvent":
        return cls(event_id=event_id, removed=block_hashes)

    @classmethod
    def cleared_event(cls, event_id: int) -> "KvCacheEvent":
        return cls(event_id=event_id, cleared=True)

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {"event_id": self.event_id}
        if self.stored is not None:
            d["parent_hash"] = self.parent_hash
            d["stored"] = [b.to_dict() for b in self.stored]
        elif self.removed is not None:
            d["removed"] = self.removed
        else:
            d["cleared"] = True
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "KvCacheEvent":
        if "stored" in d:
            return cls(
                event_id=d.get("event_id", 0),
                parent_hash=d.get("parent_hash"),
                stored=[KvCacheStoredBlock(b["block_hash"], b.get("tokens_hash"))
                        for b in d["stored"]],
            )
        if "removed" in d:
            return cls(event_id=d.get("event_id", 0), removed=list(d["removed"]))
        return cls(event_id=d.get("event_id", 0), cleared=True)


@dataclass
class RouterEvent:
    """A KvCacheEvent attributed to the worker instance that emitted it
    (reference indexer.rs:138)."""

    worker_id: int
    event: KvCacheEvent

    def to_dict(self) -> dict[str, Any]:
        return {"worker_id": self.worker_id, "event": self.event.to_dict()}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "RouterEvent":
        return cls(d["worker_id"], KvCacheEvent.from_dict(d["event"]))


# --------------------------------------------------------------- load metrics

# outcome keys of the pulled-block counts (block_manager/peer.py): the
# wire-name contract of WorkerStats.kv_pulled_blocks_by_outcome, here where
# the frontend and the router read it without the block manager (and torch)
PULL_OUTCOMES = (
    "pulled",
    "fallback_miss",
    "fallback_timeout",
    "fallback_integrity",
    "fallback_fenced",
    "fallback_error",
)


@dataclass
class WorkerStats:
    """Field names and order are the reference's (its wire dict is
    ``__dict__``); the port's engine fills the ones it keeps."""

    request_active_slots: int = 0
    request_total_slots: int = 0
    num_requests_waiting: int = 0
    data_parallel_rank: Optional[int] = None
    # lifeguard counters (monotonic): deadline / TTFT expiries the engine
    # enforced, stuck-dispatch watchdog trips
    num_deadline_exceeded: int = 0
    num_watchdog_trips: int = 0
    # QoS: per-class preemptions, storm-guard kills, brownout sheds (all
    # monotonic) and the live brownout rung (gauge)
    preemptions_by_class: Optional[dict[str, int]] = None
    num_preempted_too_often: int = 0
    num_shed_brownout: int = 0
    brownout_level: int = 0
    # integrity: checksum failures per data-plane path, quarantined blocks,
    # fencing-stamp rejects per plane (monotonic)
    integrity_failures_by_path: Optional[dict[str, int]] = None
    num_blocks_quarantined: int = 0
    fenced_rejects_by_plane: Optional[dict[str, int]] = None
    # decode-bandwidth gauges: modeled HBM bytes per emitted token and the
    # windowed decode-MFU estimate
    decode_hbm_bytes_per_token: float = 0.0
    mfu_decode_est: float = 0.0
    # meshed decode (gauge): modeled tp-axis collective bytes per step
    tp_collective_bytes_per_step: float = 0.0
    # fleet prefix cache: prefix blocks pulled from peers, by outcome
    kv_pulled_blocks_by_outcome: Optional[dict[str, int]] = None


@dataclass
class KvStats:
    kv_active_blocks: int = 0
    kv_total_blocks: int = 1
    gpu_cache_usage_perc: float = 0.0
    gpu_prefix_cache_hit_rate: float = 0.0


@dataclass
class SpecDecodeStats:
    """Speculative-decoding counters (reference protocols.rs:43-104 wire
    shape); all monotonic over the worker's lifetime."""

    num_spec_tokens: Optional[int] = None  # configured draft window (k)
    num_drafts: Optional[int] = None
    num_draft_tokens: Optional[int] = None
    num_accepted_tokens: Optional[int] = None
    num_accepted_tokens_per_pos: Optional[list[int]] = None

    @property
    def acceptance_rate(self) -> float:
        """Accepted / proposed draft tokens (0.0 when nothing drafted)."""
        if not self.num_draft_tokens:
            return 0.0
        return (self.num_accepted_tokens or 0) / self.num_draft_tokens

    def merge(self, other: "SpecDecodeStats") -> None:
        """Accumulate another worker's counters (aggregator support)."""
        self.num_drafts = (self.num_drafts or 0) + (other.num_drafts or 0)
        self.num_draft_tokens = (self.num_draft_tokens or 0) + (other.num_draft_tokens or 0)
        self.num_accepted_tokens = (self.num_accepted_tokens or 0) + (
            other.num_accepted_tokens or 0
        )
        if self.num_spec_tokens is None:
            self.num_spec_tokens = other.num_spec_tokens
        if other.num_accepted_tokens_per_pos:
            mine = list(self.num_accepted_tokens_per_pos or [])
            theirs = other.num_accepted_tokens_per_pos
            out = [0] * max(len(mine), len(theirs))
            for i, v in enumerate(mine):
                out[i] += v
            for i, v in enumerate(theirs):
                out[i] += v
            self.num_accepted_tokens_per_pos = out


@dataclass
class KvTransferStats:
    """KV data-plane counters: bytes and frames crossing the wire per
    worker, the live frame window and the bytes landed before a remote
    prefill's final frame. Monotonic except ``kv_frames_inflight``."""

    kv_frames_tx: int = 0
    kv_frames_rx: int = 0
    kv_wire_bytes_tx: int = 0
    kv_wire_bytes_rx: int = 0
    kv_bytes_overlapped: int = 0
    kv_frames_inflight: int = 0
    prefill_dropped_expired: int = 0

    @property
    def overlap_fraction(self) -> float:
        """Received wire bytes landed before the final frame / total."""
        return self.kv_bytes_overlapped / max(1, self.kv_wire_bytes_rx)

    def merge(self, other: "KvTransferStats") -> None:
        self.kv_frames_tx += other.kv_frames_tx
        self.kv_frames_rx += other.kv_frames_rx
        self.kv_wire_bytes_tx += other.kv_wire_bytes_tx
        self.kv_wire_bytes_rx += other.kv_wire_bytes_rx
        self.kv_bytes_overlapped += other.kv_bytes_overlapped
        self.kv_frames_inflight += other.kv_frames_inflight
        self.prefill_dropped_expired += other.prefill_dropped_expired


@dataclass
class ForwardPassMetrics:
    worker_stats: WorkerStats = field(default_factory=WorkerStats)
    kv_stats: KvStats = field(default_factory=KvStats)
    spec_decode_stats: Optional[SpecDecodeStats] = None
    kv_transfer_stats: Optional[KvTransferStats] = None
    # per-phase latency distributions on the shared fixed-log bucket grid
    # (telemetry/histogram.py): merged across the fleet by bucket addition
    phase_histograms: Optional[PhaseHistograms] = None
    # a port worker's own series for the health plane (C15; ``pace`` and
    # ``ttft_cold``, telemetry/health.py), on the same grid
    health_histograms: Optional[PhaseHistograms] = None
    # the goodput ledger (telemetry/goodput.py): step histograms by
    # dispatch label, occupancy, bubbles, waste, compile forensics
    goodput: Optional[GoodputStats] = None

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "worker_stats": self.worker_stats.__dict__,
            "kv_stats": self.kv_stats.__dict__,
        }
        if self.spec_decode_stats is not None:
            d["spec_decode_stats"] = self.spec_decode_stats.__dict__
        if self.kv_transfer_stats is not None:
            d["kv_transfer_stats"] = self.kv_transfer_stats.__dict__
        if self.phase_histograms is not None:
            d["phase_histograms"] = self.phase_histograms.to_dict()
        if self.health_histograms is not None:
            d["health_histograms"] = self.health_histograms.to_dict()
        if self.goodput is not None:
            d["goodput"] = self.goodput.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ForwardPassMetrics":
        spec = d.get("spec_decode_stats")
        xfer = d.get("kv_transfer_stats")
        return cls(
            worker_stats=WorkerStats(**d.get("worker_stats", {})),
            kv_stats=KvStats(**d.get("kv_stats", {})),
            spec_decode_stats=SpecDecodeStats(**spec) if spec else None,
            kv_transfer_stats=KvTransferStats(**xfer) if xfer else None,
            phase_histograms=PhaseHistograms.from_dict(ph) if (ph := d.get("phase_histograms")) else None,
            health_histograms=(PhaseHistograms.from_dict(d["health_histograms"])
                               if "health_histograms" in d else None),
            goodput=GoodputStats.from_dict(d["goodput"]) if d.get("goodput") else None,
        )


@dataclass
class KVHitRateEvent:
    """Routing-quality event published on ``kv-hit-rate``
    (reference scheduler.rs:37)."""

    worker_id: int
    isl_blocks: int
    overlap_blocks: int
    # best overlap any live worker held for this request
    fleet_blocks: int = 0

    def to_dict(self) -> dict[str, Any]:
        return self.__dict__
