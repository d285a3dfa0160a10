"""Block lifecycle state machine and metadata.

The port's own copy of dynamo_tpu/block_manager/block.py: a ``Block`` moves
RESET -> PARTIAL (tokens appended) -> COMPLETE (a full page) -> REGISTERED
(its sequence hash published, its content immutable and shareable).
Illegal transitions raise ``InvalidTransition``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional


class BlockState(str, enum.Enum):
    RESET = "reset"
    PARTIAL = "partial"
    COMPLETE = "complete"
    REGISTERED = "registered"


class InvalidTransition(RuntimeError):
    pass


@dataclass
class Block:
    """One logical KV block in some tier."""

    page_size: int
    state: BlockState = BlockState.RESET
    tokens: list[int] = field(default_factory=list)
    seq_hash: Optional[int] = None  # set at registration
    parent_hash: Optional[int] = None
    tier: int = 1  # 1=device, 2=host, 3=disk
    index: int = -1  # arena slot / file id within the tier
    ref_count: int = 0
    priority: int = 0  # offload priority (lower = keep longer)

    def append_tokens(self, toks: list[int]) -> None:
        if self.state in (BlockState.COMPLETE, BlockState.REGISTERED):
            raise InvalidTransition(f"append in state {self.state}")
        if len(self.tokens) + len(toks) > self.page_size:
            raise InvalidTransition(
                f"{len(self.tokens)}+{len(toks)} tokens exceed page "
                f"{self.page_size}"
            )
        self.tokens.extend(toks)
        self.state = (
            BlockState.COMPLETE
            if len(self.tokens) == self.page_size
            else BlockState.PARTIAL
        )

    def register(self, seq_hash: int, parent_hash: Optional[int]) -> None:
        if self.state is not BlockState.COMPLETE:
            raise InvalidTransition(f"register in state {self.state}")
        self.seq_hash = seq_hash
        self.parent_hash = parent_hash
        self.state = BlockState.REGISTERED

    def reset(self) -> None:
        if self.ref_count > 0:
            raise InvalidTransition(f"reset with {self.ref_count} refs held")
        self.tokens = []
        self.seq_hash = None
        self.parent_hash = None
        self.state = BlockState.RESET

    def acquire(self) -> "Block":
        self.ref_count += 1
        return self

    def release(self) -> None:
        if self.ref_count <= 0:
            raise InvalidTransition("release without acquire")
        self.ref_count -= 1
