"""Predicted per-worker load from the router's own routing decisions.

The port's own copy of dynamo_tpu/kv_router/sequence.py.

Role-equivalent of lib/llm/src/kv_router/sequence.rs (ActiveSequences :74,
ActiveSequencesMultiWorker :265): the router tracks which block hashes each
worker is actively computing on, so it can estimate what a worker's block
usage WOULD be if a new request landed there — without waiting a metrics
round-trip. Blocks are refcounted by hash so shared prefixes across requests
count once; the trailing partial block of each request is always unique.

The reference runs one OS thread per worker with channel RPC; on asyncio a
plain dict per worker gives identical semantics.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Optional

from dynamo_tpu_torch.tokens import compute_seq_hash_chain


@dataclass
class _ActiveRequest:
    block_hashes: list[int]
    partial_blocks: int  # trailing not-yet-full blocks (unique to request)
    created: float = field(default_factory=time.monotonic)


class ActiveSequences:
    """Active block accounting for ONE worker."""

    def __init__(self, block_size: int) -> None:
        self.block_size = block_size
        self.requests: dict[str, _ActiveRequest] = {}
        self._block_refs: dict[int, int] = {}
        self._unique_blocks = 0  # partial blocks, never shared

    # -- queries --

    @property
    def active_blocks(self) -> int:
        return len(self._block_refs) + self._unique_blocks

    def new_blocks(self, block_hashes: list[int], partial: int = 0) -> int:
        """How many blocks this request would ADD to the worker."""
        return self.new_blocks_set(set(block_hashes), partial)

    def new_blocks_set(self, uniq: set[int], partial: int = 0) -> int:
        """Same, for a pre-deduplicated hash set — the multi-worker path
        dedupes once instead of per worker (64 workers would otherwise
        build 64 identical sets per scheduling decision)."""
        return (
            sum(1 for h in uniq if h not in self._block_refs) + partial
        )

    def potential_blocks(self, block_hashes: list[int], partial: int = 0) -> int:
        return self.active_blocks + self.new_blocks(block_hashes, partial)

    # -- mutations --

    def add_request(
        self,
        request_id: str,
        block_hashes: list[int],
        partial_blocks: int = 1,
    ) -> int:
        self.requests[request_id] = _ActiveRequest(
            list(block_hashes), partial_blocks
        )
        for h in block_hashes:
            self._block_refs[h] = self._block_refs.get(h, 0) + 1
        self._unique_blocks += partial_blocks
        return self.active_blocks

    def push(self, request_id: str, new_block_hashes: list[int]) -> int:
        """Decode progressed: newly completed blocks replace partial ones."""
        req = self.requests.get(request_id)
        if req is None:
            return self.active_blocks
        for h in new_block_hashes:
            req.block_hashes.append(h)
            self._block_refs[h] = self._block_refs.get(h, 0) + 1
        return self.active_blocks

    def free(self, request_id: str) -> int:
        req = self.requests.pop(request_id, None)
        if req is None:
            return self.active_blocks
        for h in req.block_hashes:
            n = self._block_refs.get(h, 0) - 1
            if n <= 0:
                self._block_refs.pop(h, None)
            else:
                self._block_refs[h] = n
        self._unique_blocks -= req.partial_blocks
        return self.active_blocks


class ActiveSequencesMultiWorker:
    """The router-side view across ALL workers (sequence.rs:265)."""

    def __init__(self, block_size: int, worker_ids: list[int]) -> None:
        self.block_size = block_size
        self.workers: dict[int, ActiveSequences] = {
            w: ActiveSequences(block_size) for w in worker_ids
        }
        self._request_worker: dict[str, int] = {}

    def update_workers(self, new_worker_ids: list[int]) -> None:
        """Reconcile with discovery: keep known workers, add new, drop dead."""
        for w in new_worker_ids:
            if w not in self.workers:
                self.workers[w] = ActiveSequences(self.block_size)
        dead = set(self.workers) - set(new_worker_ids)
        for w in dead:
            del self.workers[w]
            for rid, owner in list(self._request_worker.items()):
                if owner == w:
                    del self._request_worker[rid]

    def _hashes(self, token_ids: list[int]) -> tuple[list[int], int]:
        chain = compute_seq_hash_chain(token_ids, self.block_size)
        partial = 1 if len(token_ids) % self.block_size else 0
        return chain, partial

    def potential_blocks(self, token_ids: list[int]) -> dict[int, int]:
        chain, partial = self._hashes(token_ids)
        return self.potential_blocks_chain(chain, partial)

    def potential_blocks_chain(
        self, chain: list[int], partial: int
    ) -> dict[int, int]:
        """Per-worker potential from a precomputed hash chain — the
        scheduler computes the chain once per decision and threads it
        through here and add_request_chain (it used to be recomputed
        three times per routed request)."""
        uniq = set(chain)
        return {
            w: seqs.active_blocks + seqs.new_blocks_set(uniq, partial)
            for w, seqs in self.workers.items()
        }

    def active_blocks(self) -> dict[int, int]:
        return {w: seqs.active_blocks for w, seqs in self.workers.items()}

    def add_request(
        self,
        worker_id: int,
        token_ids: list[int],
        request_id: Optional[str] = None,
    ) -> str:
        chain, partial = self._hashes(token_ids)
        return self.add_request_chain(worker_id, chain, partial, request_id)

    def add_request_chain(
        self,
        worker_id: int,
        chain: list[int],
        partial: int,
        request_id: Optional[str] = None,
    ) -> str:
        request_id = request_id or uuid.uuid4().hex
        seqs = self.workers.get(worker_id)
        if seqs is not None:
            seqs.add_request(request_id, chain, max(partial, 1))
            self._request_worker[request_id] = worker_id
        return request_id

    def free(self, request_id: str) -> None:
        worker_id = self._request_worker.pop(request_id, None)
        if worker_id is not None and worker_id in self.workers:
            self.workers[worker_id].free(request_id)
