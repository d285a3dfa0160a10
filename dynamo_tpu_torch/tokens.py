"""Token sequences and the KV-block hash chain.

The port's own copy of dynamo_tpu/tokens.py: a token sequence is cut into
fixed-size blocks, and each complete block gets a chained hash
``h_i = H(h_{i-1}, tokens_i, salt)``. The block hashes are the currency
that the KV events, the KV-aware router and the tiered block manager share:
an equal prefix of the hash chain is a reusable KV prefix. Routers across
the fleet key on these numbers, so they are bit-identical to the JAX
package's (64 bits of BLAKE2b over the parent hash, the salt and the tokens
as little-endian u32 words). Both functions run the C code of ``native/``
when its library loads, and the pure-Python path otherwise: the same
digests.
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass, field
from typing import Iterable, Optional

from dynamo_tpu_torch import native

DEFAULT_BLOCK_SIZE = 16


def compute_block_hash(parent_hash: int, tokens: list[int], salt: int = 0) -> int:
    got = native.block_hash(parent_hash, tokens, salt)
    if got is not None:
        return got
    return _py_block_hash(parent_hash, tokens, salt)


def _py_block_hash(parent_hash: int, tokens: list[int], salt: int = 0) -> int:
    h = hashlib.blake2b(digest_size=8)
    h.update(struct.pack("<QQ", parent_hash & 0xFFFFFFFFFFFFFFFF, salt))
    h.update(struct.pack(f"<{len(tokens)}I", *tokens))
    return struct.unpack("<Q", h.digest())[0]


def compute_seq_hash_chain(
    tokens: list[int], block_size: int = DEFAULT_BLOCK_SIZE, salt: int = 0
) -> list[int]:
    """Hashes of every COMPLETE block of the sequence (a partial tail has
    none); the C chain (native/) when it is loaded."""
    got = native.hash_chain(tokens, block_size, salt)
    if got is not None:
        return got
    return _py_seq_hash_chain(tokens, block_size, salt)


def _py_seq_hash_chain(
    tokens: list[int], block_size: int = DEFAULT_BLOCK_SIZE, salt: int = 0
) -> list[int]:
    hashes: list[int] = []
    parent = 0
    for start in range(0, len(tokens) - len(tokens) % block_size, block_size):
        parent = _py_block_hash(parent, tokens[start:start + block_size], salt)
        hashes.append(parent)
    return hashes


@dataclass
class TokenBlock:
    """A complete, hashed block of tokens."""

    tokens: list[int]
    block_hash: int
    parent_hash: int
    position: int  # block index within the sequence


@dataclass
class PartialTokenBlock:
    tokens: list[int] = field(default_factory=list)

    def remaining(self, block_size: int) -> int:
        return block_size - len(self.tokens)


class TokenBlockSequence:
    """Incremental block and hash bookkeeping for a growing token
    sequence."""

    def __init__(
        self,
        tokens: Optional[Iterable[int]] = None,
        block_size: int = DEFAULT_BLOCK_SIZE,
        salt: int = 0,
    ) -> None:
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.block_size = block_size
        self.salt = salt
        self.blocks: list[TokenBlock] = []
        self.partial = PartialTokenBlock()
        if tokens:
            self.extend(list(tokens))

    def __len__(self) -> int:
        return len(self.blocks) * self.block_size + len(self.partial.tokens)

    @property
    def tokens(self) -> list[int]:
        out: list[int] = []
        for b in self.blocks:
            out.extend(b.tokens)
        out.extend(self.partial.tokens)
        return out

    def block_hashes(self) -> list[int]:
        return [b.block_hash for b in self.blocks]

    def last_hash(self) -> int:
        return self.blocks[-1].block_hash if self.blocks else 0

    def append(self, token: int) -> Optional[TokenBlock]:
        """Append one token; returns the block it completed, if any."""
        self.partial.tokens.append(token)
        if len(self.partial.tokens) == self.block_size:
            parent = self.last_hash()
            blk = TokenBlock(
                tokens=self.partial.tokens,
                block_hash=compute_block_hash(parent, self.partial.tokens, self.salt),
                parent_hash=parent,
                position=len(self.blocks),
            )
            self.blocks.append(blk)
            self.partial = PartialTokenBlock()
            return blk
        return None

    def extend(self, tokens: list[int]) -> list[TokenBlock]:
        """Append many tokens; returns every block they completed."""
        new_blocks: list[TokenBlock] = []
        for t in tokens:
            blk = self.append(t)
            if blk is not None:
                new_blocks.append(blk)
        return new_blocks

    def truncate(self, num_tokens: int) -> None:
        if num_tokens >= len(self):
            return
        toks = self.tokens[:num_tokens]
        self.blocks = []
        self.partial = PartialTokenBlock()
        self.extend(toks)
