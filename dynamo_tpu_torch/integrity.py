"""Content checksums over KV payload bytes (the port's copy of
dynamo_tpu/integrity.py:31-100).

Every ``disagg.protocols.KvBlockPayload`` carries a self-describing header
(``sum_algo``, ``k_sum``, ``v_sum``) computed here when it is encoded and
verified when it lands, so a flipped bit or a truncated frame raises
``IntegrityError`` instead of decoding into the KV cache.

``checksum()`` is xxh3-64 when the ``xxhash`` wheel is importable, else
BLAKE2b with an 8-byte digest from the standard library; the algorithm tag
travels with the payload, so a receiver verifies what it can compute and
accepts unverified what it cannot. The same bytes under the same tag give
the same number as the JAX package's, so payloads cross between the two.
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import Optional

logger = logging.getLogger("dynamo_tpu_torch.integrity")

try:  # GB/s-class non-cryptographic hash when the wheel is around
    import xxhash as _xxhash

    ALGO = "xxh3"
except ImportError:
    _xxhash = None
    ALGO = "b2b8"


class IntegrityError(Exception):
    """A KV payload failed its content checksum. Callers drop the data and
    recompute it."""

    def __init__(self, message: str, path: str = "") -> None:
        super().__init__(message)
        self.path = path


def enabled() -> bool:
    """``DYN_KV_CHECKSUM=0`` turns off computing checksums on the sending
    side (receivers verify whatever arrives tagged)."""
    return os.environ.get("DYN_KV_CHECKSUM", "1") not in ("0", "false", "no")


def _blake2b8(chunks) -> int:
    h = hashlib.blake2b(digest_size=8)
    for c in chunks:
        h.update(c)
    return int.from_bytes(h.digest(), "big")


def _xxh3(chunks) -> int:
    h = _xxhash.xxh3_64()
    for c in chunks:
        h.update(c)
    return h.intdigest()


def checksum(*chunks: bytes) -> int:
    """64-bit checksum over the concatenation of ``chunks`` (memoryviews
    are read in place)."""
    return _xxh3(chunks) if _xxhash is not None else _blake2b8(chunks)


def checksum_with(algo: str, *chunks: bytes) -> Optional[int]:
    """The checksum under the tag ``algo``; None when this build cannot
    compute it (the payload is then accepted unverified)."""
    if algo == "b2b8":
        return _blake2b8(chunks)
    if algo == "xxh3" and _xxhash is not None:
        return _xxh3(chunks)
    return None


class IntegrityCounters:
    """Process-wide integrity and fence counters, all monotonic (the JAX
    package's ``IntegrityCounters``): verification failures per path
    (``tier_host``, ``tier_disk``, ``warm_restore``), hashes quarantined, and
    frames refused per plane because their worker's epoch is fenced
    (``runtime/fencing.py``)."""

    def __init__(self) -> None:
        self.failures: dict[str, int] = {}
        self.blocks_quarantined = 0
        self.fenced_rejects: dict[str, int] = {}

    def integrity_failure(self, path: str, detail: str = "") -> None:
        self.failures[path] = self.failures.get(path, 0) + 1
        logger.warning("KV integrity failure on %s%s", path, f": {detail}" if detail else "")

    def quarantine(self, n: int = 1) -> None:
        self.blocks_quarantined += n

    def fenced_reject(self, plane: str, epoch: int = 0) -> None:
        """A frame stamped with a fenced epoch was refused on ``plane``."""
        self.fenced_rejects[plane] = self.fenced_rejects.get(plane, 0) + 1

    def snapshot(self) -> dict:
        return {"integrity_failures_by_path": dict(self.failures),
                "blocks_quarantined": self.blocks_quarantined,
                "fenced_rejects_by_plane": dict(self.fenced_rejects)}

    def reset(self) -> None:
        self.failures.clear()
        self.blocks_quarantined = 0
        self.fenced_rejects.clear()


COUNTERS = IntegrityCounters()
