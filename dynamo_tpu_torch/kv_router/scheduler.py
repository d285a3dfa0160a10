"""Worker selection: overlap-vs-load cost with softmax sampling.

The port's own copy of dynamo_tpu/kv_router/scheduler.py. Left out: the
prefix-pull plan (``prefix_pull``, ``prefix_pull_min_blocks``,
``_plan_pull``, a result's ``pull_plan``), which needs the peer tier
(ROADMAP.md A7); the ranking of pull sources is
``indexer.rank_pull_sources``. Also the health scorer's hook (the route set
and the ``health_factors`` deweighting, A10 part 2) and the decision
provenance records (A12). Seeded, it picks what the reference picks: both
draw from Python's ``random``.

Role-equivalent of lib/llm/src/kv_router/scheduler.rs (:100-446): per worker
logit = overlap_score_weight * prefill_blocks + potential_active_blocks
(lower is better), logits normalized by the max, then softmax-sampled at
``router_temperature`` (0 => argmin with random tie-break, scheduler.rs:276).
"""

from __future__ import annotations

import logging
import math
import os
import random
from dataclasses import dataclass, field
from typing import Callable, Optional, Protocol

from dynamo_tpu_torch.kv_router.indexer import OverlapScores
from dynamo_tpu_torch.kv_router.protocols import KVHitRateEvent
from dynamo_tpu_torch.kv_router.sequence import ActiveSequencesMultiWorker
from dynamo_tpu_torch.tokens import compute_seq_hash_chain

logger = logging.getLogger("dynamo_tpu_torch.kv_router.scheduler")


@dataclass
class KvRouterConfig:
    """Defaults mirror reference kv_router.rs:78-85."""

    overlap_score_weight: float = 1.0
    router_temperature: float = 0.5
    use_kv_events: bool = True
    ttl_secs: float = 120.0  # ApproxKvIndexer TTL when use_kv_events=False
    # sliding window of the radix tree's frequency plane (recent_uses):
    # per-block fleet access counts; 0 turns the tracking off
    frequency_horizon_s: float = field(
        default_factory=lambda: float(os.environ.get("DYN_PREFIX_FREQ_HORIZON_S", "600"))
    )


@dataclass
class SchedulingRequest:
    isl_tokens: int
    overlap: OverlapScores
    # worker_id -> blocks the worker would hold if this request landed there
    potential_blocks: dict[int, int] = field(default_factory=dict)


@dataclass
class WorkerSelectionResult:
    worker_id: int
    required_blocks: int
    overlap_blocks: int
    # best (capped) overlap held anywhere in the fleet for this request
    fleet_blocks: int = 0


class NoEndpointsError(RuntimeError):
    pass


class WorkerSelector(Protocol):
    """Pluggable selection policy (reference kv_router.rs:54)."""

    def select_worker(
        self, worker_ids: list[int], request: SchedulingRequest, block_size: int
    ) -> WorkerSelectionResult:
        ...


def softmax_sample(
    logits: dict[int, float], temperature: float, rng: Optional[random.Random] = None
) -> int:
    """Sample a worker id; LOWER logit = better (scheduler.rs:276-340)."""
    if not logits:
        raise NoEndpointsError("empty logits for softmax sampling")
    rng = rng or random
    if temperature == 0.0:
        lo = min(logits.values())
        ties = [k for k, v in logits.items() if v == lo]
        return rng.choice(ties)

    keys = list(logits.keys())
    values = list(logits.values())
    lo, hi = min(values), max(values)
    if lo == hi:
        return rng.choice(keys)
    scaled = [-(v / (hi - lo)) / temperature for v in values]
    m = max(scaled)
    exps = [math.exp(v - m) for v in scaled]
    total = sum(exps)
    sample = rng.random() * total
    acc = 0.0
    for k, e in zip(keys, exps):
        acc += e
        if sample <= acc:
            return k
    return keys[-1]


class DefaultWorkerSelector:
    """The reference's default cost function (scheduler.rs:346-436)."""

    def __init__(
        self, config: Optional[KvRouterConfig] = None, rng: Optional[random.Random] = None
    ) -> None:
        self.config = config or KvRouterConfig()
        self.rng = rng

    def select_worker(
        self, worker_ids: list[int], request: SchedulingRequest, block_size: int
    ) -> WorkerSelectionResult:
        if not worker_ids:
            raise NoEndpointsError("no workers to select from")
        # empty prompts are legal: zero prefill cost, routed on load alone
        request_blocks = -(-max(0, request.isl_tokens) // block_size)
        logits: dict[int, float] = {}
        max_logit = -math.inf
        for worker_id in worker_ids:
            cached = float(request.overlap.scores.get(worker_id, 0))
            prefill_blocks = request_blocks - cached
            potential = float(request.potential_blocks.get(worker_id, 0))
            logit = self.config.overlap_score_weight * prefill_blocks + potential
            logits[worker_id] = logit
            max_logit = max(max_logit, logit)
            logger.debug("worker %d: logit %.3f = %.1f * %.1f + %.1f (cached %d)", worker_id,
                         logit, self.config.overlap_score_weight, prefill_blocks, potential,
                         int(cached))

        if max_logit > 0:
            logits = {k: v / max_logit for k, v in logits.items()}

        best = softmax_sample(logits, self.config.router_temperature, self.rng)
        return WorkerSelectionResult(
            worker_id=best,
            required_blocks=request_blocks,
            overlap_blocks=request.overlap.scores.get(best, 0),
        )


class KvScheduler:
    """Combines the live worker set and the predicted load into a selection,
    and reports KV-hit-rate events (reference scheduler.rs:100-250)."""

    def __init__(
        self,
        block_size: int,
        selector: Optional[WorkerSelector] = None,
        on_hit_rate_event: Optional[Callable[[KVHitRateEvent], None]] = None,
        config: Optional[KvRouterConfig] = None,
    ) -> None:
        self.block_size = block_size
        self.selector = selector or DefaultWorkerSelector()
        self.config = config or getattr(self.selector, "config", None) or KvRouterConfig()
        self.sequences = ActiveSequencesMultiWorker(block_size, [])
        self.on_hit_rate_event = on_hit_rate_event
        # per-decision accounting: how many of the request's blocks the
        # chosen worker (and the fleet's best holder) already held
        self.hit_stats: dict[str, int] = {
            "decisions": 0,
            "isl_blocks": 0,
            "matched_blocks": 0,
            "fleet_blocks": 0,
        }

    def update_workers(self, worker_ids: list[int]) -> None:
        self.sequences.update_workers(worker_ids)

    def schedule(
        self,
        token_ids: list[int],
        overlap: OverlapScores,
        request_id: Optional[str] = None,
        chain: Optional[list[int]] = None,
    ) -> WorkerSelectionResult:
        """``chain``: the request's block-hash chain, when the caller has
        it (the router built it for the indexer query)."""
        if chain is None:
            chain = compute_seq_hash_chain(token_ids, self.block_size)
        partial = 1 if len(token_ids) % self.block_size else 0
        worker_ids = list(self.sequences.workers.keys())
        request = SchedulingRequest(
            isl_tokens=len(token_ids),
            overlap=overlap,
            potential_blocks=self.sequences.potential_blocks_chain(chain, partial),
        )
        result = self.selector.select_worker(worker_ids, request, self.block_size)
        result.fleet_blocks = min(result.required_blocks, max(overlap.scores.values(), default=0))
        self.sequences.add_request_chain(result.worker_id, chain, partial, request_id)
        self.hit_stats["decisions"] += 1
        self.hit_stats["isl_blocks"] += result.required_blocks
        self.hit_stats["matched_blocks"] += result.overlap_blocks
        self.hit_stats["fleet_blocks"] += result.fleet_blocks
        if self.on_hit_rate_event is not None:
            self.on_hit_rate_event(KVHitRateEvent(
                worker_id=result.worker_id,
                isl_blocks=result.required_blocks,
                overlap_blocks=result.overlap_blocks,
                fleet_blocks=result.fleet_blocks,
            ))
        return result

    def free(self, request_id: str) -> None:
        self.sequences.free(request_id)
