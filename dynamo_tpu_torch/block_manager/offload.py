"""Bounded queue for mid-generation KV block offload.

The port's own copy of dynamo_tpu/block_manager/offload.py. A block is
queued the moment it is KV-complete, mid-generation, rather than when its
sequence finishes:

- the engine's ``_emit_stored`` enqueues every newly KV-complete block (a
  decode boundary, a prefill's end);
- the engine loop drains a few validated candidates per iteration
  (``offload_per_step``), so the copies stay off the decode latency path.

Preemption and completion do NOT ride this queue: their device blocks are
about to be recycled, so the engine hands the blocks to an offload task of
their own (``TorchEngine._offload_task``).

Entries name live scheduler sequences, so validity is checked again at pop
time: the sequence may have finished, been preempted, or the hash may have
landed through another sequence (dedupe).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, NamedTuple


class _Entry(NamedTuple):
    seq: Any  # engine _Sequence (scheduler-owned)
    seq_hash: int
    position: int  # index into the block hash chain / block_ids


@dataclass
class OffloadQueueStats:
    enqueued: int = 0
    offloaded: int = 0
    dropped_full: int = 0
    dropped_stale: int = 0
    dropped_dup: int = 0
    # candidates dropped because their sequence was cancelled/killed —
    # kept separate from staleness so chaos-soak accounting can tell
    # teardown churn from ordinary scheduling races
    dropped_cancelled: int = 0


class OffloadQueue:
    """FIFO of (sequence, block-position) offload candidates.

    Bounded: when full, new candidates are dropped — the completion-time
    offload still catches their blocks when the sequence finishes, so a
    drop costs reuse opportunity, never correctness.
    """

    def __init__(self, max_pending: int = 256) -> None:
        self._fifo: deque[_Entry] = deque()
        self._pending: set[int] = set()  # hashes queued (dedupe)
        self.max_pending = max_pending
        self.stats = OffloadQueueStats()

    def __len__(self) -> int:
        return len(self._fifo)

    def enqueue(self, seq: Any, entries: list[tuple[int, int]]) -> int:
        """Queue (seq_hash, position) pairs; returns #accepted."""
        accepted = 0
        for seq_hash, position in entries:
            if seq_hash in self._pending:
                self.stats.dropped_dup += 1
                continue
            if len(self._fifo) >= self.max_pending:
                self.stats.dropped_full += 1
                continue
            self._fifo.append(_Entry(seq, seq_hash, position))
            self._pending.add(seq_hash)
            accepted += 1
            self.stats.enqueued += 1
        return accepted

    def pop_valid(
        self, limit: int, manager: Any
    ) -> list[tuple[Any, int, int]]:
        """Pop up to `limit` still-valid candidates.

        Valid = the sequence is still scheduled (holds a slot, not mid
        remote-prefill), its hash chain still carries `seq_hash` at
        `position`, the device block at that position is still owned, and
        the hash hasn't landed in the manager meanwhile. Stale entries are
        discarded (their blocks either already offloaded via the
        completion path or were recycled).
        """
        out: list[tuple[Any, int, int]] = []
        while self._fifo and len(out) < limit:
            e = self._fifo.popleft()
            self._pending.discard(e.seq_hash)
            seq = e.seq
            if e.seq_hash in manager:
                self.stats.dropped_dup += 1
                continue
            chain = getattr(seq, "hash_seq", None)
            if (
                seq.slot is None
                or getattr(seq, "pending_remote", False)
                or chain is None
                or e.position >= len(chain.blocks)
                or chain.blocks[e.position].block_hash != e.seq_hash
                or e.position >= len(seq.block_ids)
            ):
                self.stats.dropped_stale += 1
                continue
            out.append((seq, e.seq_hash, seq.block_ids[e.position]))
        return out

    def forget_seq(self, seq: Any, cancelled: bool = False) -> int:
        """Drop queued candidates for a sequence whose device blocks are
        being recycled (free/preempt/cancel paths), so their hashes can
        re-enqueue through another live holder. One pass: drops are
        counted while filtering, and the rebuilt deque is only swapped in
        when something was actually dropped. `cancelled` attributes the
        drops to requester cancellation rather than staleness."""
        kept: deque[_Entry] = deque()
        dropped = 0
        for e in self._fifo:
            if e.seq is seq:
                self._pending.discard(e.seq_hash)
                dropped += 1
            else:
                kept.append(e)
        if dropped:
            self._fifo = kept
            if cancelled:
                self.stats.dropped_cancelled += dropped
            else:
                self.stats.dropped_stale += dropped
        return dropped
