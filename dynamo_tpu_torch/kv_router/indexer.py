"""Global prefix index over worker KV caches.

The port's own copy of dynamo_tpu/kv_router/indexer.py, and the prefix-pull
source ranking of the reference's ``KvScheduler._plan_pull``
(``rank_pull_sources``): a pure function of the tree's overlap scores, which
the scheduler's ``_plan_pull`` ranks its sources by.

Role-equivalent of lib/llm/src/kv_router/indexer.rs (RadixTree :187-430,
KvIndexer :518-690) and approx.rs (ApproxKvIndexer :166): a radix/prefix
tree whose edges are block hashes and whose nodes record which workers hold
that block. ``find_matches`` walks a request's hash chain and scores
per-worker prefix overlap. The tree is single-writer: the reference isolates
it behind an mpsc channel on one thread; here the asyncio event loop
provides the same serialization, so apply/find are plain methods.
"""

from __future__ import annotations

import collections
import logging
from dataclasses import dataclass, field
from typing import Callable, Deque, Iterable, Optional

from dynamo_tpu_torch.kv_router.protocols import KvCacheEvent, KvCacheStoredBlock, RouterEvent
from dynamo_tpu_torch.runtime import clock as dclock
from dynamo_tpu_torch.tokens import compute_seq_hash_chain

logger = logging.getLogger("dynamo_tpu_torch.kv_router.indexer")


@dataclass
class OverlapScores:
    """Per-worker count of consecutive matched blocks from the root
    (reference indexer.rs:410)."""

    scores: dict[int, int] = field(default_factory=dict)
    # sum of recent accesses along the matched path (only when the tree
    # tracks frequency): a hotness signal
    frequencies: list[int] = field(default_factory=list)

    def update(self, workers: set[int]) -> None:
        for w in workers:
            self.scores[w] = self.scores.get(w, 0) + 1


class _Node:
    __slots__ = ("children", "workers", "recent_uses", "parent", "edge")

    def __init__(self) -> None:
        self.children: dict[int, _Node] = {}
        self.workers: set[int] = set()
        self.recent_uses: Deque[float] = collections.deque()
        # back-link for detaching emptied nodes (a long-running router sees
        # unbounded distinct block hashes)
        self.parent: Optional["_Node"] = None
        self.edge: int = 0

    def detach(self) -> None:
        """Unlink from the parent if this node is empty (no workers)."""
        p = self.parent
        if p is not None and p.children.get(self.edge) is self:
            del p.children[self.edge]
        self.parent = None


def _drop_worker(node: _Node, worker_id: int) -> None:
    node.workers.discard(worker_id)
    if not node.workers:
        # no worker holds this block => none holds any child
        node.children.clear()
        node.detach()


class RadixTree:
    """Prefix tree over block hashes with a per-worker jump table.

    The jump table (worker_id -> block_hash -> node) lets Stored events
    attach below any existing block in O(1) without replaying the prefix
    (reference indexer.rs:196-203).
    """

    def __init__(
        self,
        expiration_duration: Optional[float] = None,
        now_fn: Callable[[], float] = dclock.now,
    ) -> None:
        self.root = _Node()
        self.lookup: dict[int, dict[int, _Node]] = {}
        self.expiration_duration = expiration_duration
        self._now = now_fn

    def find_matches(self, sequence: list[int], early_exit: bool = False) -> OverlapScores:
        scores = OverlapScores()
        current = self.root
        now = self._now()
        for block_hash in sequence:
            nxt = current.children.get(block_hash)
            if nxt is None:
                break
            scores.update(nxt.workers)
            if self.expiration_duration is not None:
                horizon = now - self.expiration_duration
                while nxt.recent_uses and nxt.recent_uses[0] < horizon:
                    nxt.recent_uses.popleft()
                scores.frequencies.append(len(nxt.recent_uses))
                nxt.recent_uses.append(now)
            if early_exit and len(nxt.workers) == 1:
                break
            current = nxt
        return scores

    def apply_event(self, event: RouterEvent) -> None:
        worker_id, ev = event.worker_id, event.event
        worker_lookup = self.lookup.setdefault(worker_id, {})

        if ev.stored is not None:
            if ev.parent_hash is None:
                current: Optional[_Node] = self.root
            else:
                current = worker_lookup.get(ev.parent_hash)
            if current is None:
                logger.warning("worker %d event %d: parent block %s unknown; dropping store",
                               worker_id, ev.event_id, ev.parent_hash)
                return
            for blk in ev.stored:
                node = current.children.get(blk.edge_hash)
                if node is None:
                    # re-link an existing worker block if the engine
                    # re-stored it under a new parent, else create fresh
                    node = worker_lookup.get(blk.block_hash) or _Node()
                    if node.parent is not None and node.parent is not current:
                        node.detach()
                    current.children[blk.edge_hash] = node
                    node.parent = current
                    node.edge = blk.edge_hash
                node.workers.add(worker_id)
                worker_lookup[blk.block_hash] = node
                current = node
        elif ev.removed is not None:
            for block_hash in ev.removed:
                node = worker_lookup.pop(block_hash, None)
                if node is None:
                    logger.debug("worker %d event %d: remove of unknown block %d",
                                 worker_id, ev.event_id, block_hash)
                    continue
                _drop_worker(node, worker_id)
        else:  # cleared
            self.clear_all_blocks(worker_id)

    def remove_worker(self, worker_id: int) -> None:
        for node in (self.lookup.pop(worker_id, None) or {}).values():
            _drop_worker(node, worker_id)

    def clear_all_blocks(self, worker_id: int) -> None:
        blocks = self.lookup.get(worker_id)
        if blocks:
            for node in blocks.values():
                _drop_worker(node, worker_id)
            blocks.clear()

    # -- introspection --

    def worker_block_count(self, worker_id: int) -> int:
        return len(self.lookup.get(worker_id, {}))

    def workers(self) -> list[int]:
        return list(self.lookup.keys())


class _ChainQuery:
    """Shared tokens->chain query surface of every indexer flavor (the
    chain computation must stay identical across them)."""

    _block_size: int

    @property
    def block_size(self) -> int:
        return self._block_size

    def find_matches(self, sequence: list[int]) -> OverlapScores:
        raise NotImplementedError

    def find_matches_for_request(self, token_ids: list[int]) -> OverlapScores:
        return self.find_matches(compute_seq_hash_chain(token_ids, self._block_size))


class KvIndexer(_ChainQuery):
    """Event-driven indexer: feed RouterEvents, query overlap by tokens
    (reference KvIndexer, indexer.rs:518, minus its channel plumbing)."""

    def __init__(
        self,
        block_size: int,
        expiration_duration: Optional[float] = None,
        now_fn: Callable[[], float] = dclock.now,
    ) -> None:
        self._block_size = block_size
        self.tree = RadixTree(expiration_duration, now_fn=now_fn)

    def apply_event(self, event: RouterEvent) -> None:
        self.tree.apply_event(event)

    def find_matches(self, sequence: list[int]) -> OverlapScores:
        return self.tree.find_matches(sequence)

    def remove_worker(self, worker_id: int) -> None:
        self.tree.remove_worker(worker_id)

    def block_counts(self) -> dict[int, int]:
        """Blocks indexed per worker."""
        return {w: self.tree.worker_block_count(w) for w in self.tree.workers()}


class ShardedKvIndexer(_ChainQuery):
    """Worker-partitioned indexer (reference indexer.rs:696): each shard
    owns a disjoint subset of workers with its own RadixTree and jump
    table. A worker's removal walks only its shard; ``find_matches`` fans
    out to every shard and merges (the worker sets are disjoint, so the
    scores merge as a dict union)."""

    def __init__(
        self,
        block_size: int,
        num_shards: int = 8,
        expiration_duration: Optional[float] = None,
        now_fn: Callable[[], float] = dclock.now,
    ) -> None:
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self._block_size = block_size
        self.shards = [KvIndexer(block_size, expiration_duration, now_fn=now_fn)
                       for _ in range(num_shards)]

    def _shard(self, worker_id: int) -> KvIndexer:
        return self.shards[worker_id % len(self.shards)]

    def apply_event(self, event: RouterEvent) -> None:
        self._shard(event.worker_id).apply_event(event)

    def find_matches(self, sequence: list[int]) -> OverlapScores:
        merged = OverlapScores()
        for shard in self.shards:
            sc = shard.find_matches(sequence)
            merged.scores.update(sc.scores)  # worker sets are disjoint
            # every shard holding the prefix saw every query, so each
            # holder's per-depth count already is the single-tree count:
            # merge with max (a sum would scale with the holding shards)
            for i, f in enumerate(sc.frequencies):
                if i < len(merged.frequencies):
                    merged.frequencies[i] = max(merged.frequencies[i], f)
                else:
                    merged.frequencies.append(f)
        return merged

    def remove_worker(self, worker_id: int) -> None:
        self._shard(worker_id).remove_worker(worker_id)

    def block_counts(self) -> dict[int, int]:
        out: dict[int, int] = {}
        for shard in self.shards:
            out.update(shard.block_counts())
        return out


class ApproxKvIndexer(_ChainQuery):
    """TTL-based indexer needing NO worker events (reference approx.rs:166).

    On each routing decision the caller reports which worker got the
    request; the indexer assumes that worker now caches the prompt's blocks
    for ``ttl`` seconds (refreshed on re-use)."""

    def __init__(
        self,
        block_size: int,
        ttl: float = 120.0,
        now_fn: Callable[[], float] = dclock.now,
    ) -> None:
        self._block_size = block_size
        self.ttl = ttl
        self.tree = RadixTree(now_fn=now_fn)
        self._now = now_fn
        # (worker_id, block_hash) -> expiry; purged lazily
        self._expiries: dict[tuple[int, int], float] = {}

    def _purge(self) -> None:
        now = self._now()
        expired = [k for k, t in self._expiries.items() if t <= now]
        removed_by_worker: dict[int, list[int]] = {}
        for worker_id, block_hash in expired:
            del self._expiries[(worker_id, block_hash)]
            removed_by_worker.setdefault(worker_id, []).append(block_hash)
        for worker_id, hashes in removed_by_worker.items():
            self.tree.apply_event(RouterEvent(worker_id, KvCacheEvent.removed_event(0, hashes)))

    def find_matches(self, sequence: list[int]) -> OverlapScores:
        self._purge()
        return self.tree.find_matches(sequence)

    def process_routing_decision_for_request(self, token_ids: list[int], worker_id: int) -> None:
        chain = compute_seq_hash_chain(token_ids, self._block_size)
        expiry = self._now() + self.ttl
        blocks = [KvCacheStoredBlock(h) for h in chain]
        self.tree.apply_event(RouterEvent(worker_id, KvCacheEvent.stored_event(0, None, blocks)))
        for h in chain:
            self._expiries[(worker_id, h)] = expiry

    def remove_worker(self, worker_id: int) -> None:
        self.tree.remove_worker(worker_id)
        for key in [k for k in self._expiries if k[0] == worker_id]:
            del self._expiries[key]

    def block_counts(self) -> dict[int, int]:
        self._purge()
        return {w: self.tree.worker_block_count(w) for w in self.tree.workers()}


def rank_pull_sources(
    overlap: OverlapScores,
    routed: int,
    required_blocks: int,
    routed_blocks: int,
    live: Iterable[int],
    suspects: Iterable[int] = (),
) -> list[int]:
    """The workers a routed request could pull its missing prefix from, best
    first, as the reference's ``KvScheduler._plan_pull`` ranks them
    (scheduler.py:403-412): each holder of more (capped) blocks than the
    routed worker's ``routed_blocks``, a live healthy holder before a
    suspect before a dead one, then more blocks first, then the lower id."""
    live, suspects = set(live), set(suspects)
    candidates = [w for w, s in overlap.scores.items()
                  if w != routed and min(s, required_blocks) > routed_blocks]
    candidates.sort(key=lambda w: (
        2 if w not in live else (1 if w in suspects else 0),
        -min(overlap.scores[w], required_blocks),
        w,
    ))
    return candidates
