"""Framed msgpack wire protocol shared by the fabric server and client.

The port's own copy of dynamo_tpu/fabric/wire.py: the same frames, byte
for byte, packed by the port's stdlib codec (``fabric/mpack.py``) in place
of the ``msgpack`` package.

Frame = 1-byte protocol version || 4-byte big-endian length || msgpack body.
Request  body: [req_id, op, kwargs]
Response body: [req_id, "ok", result] | [req_id, "err", message]
Push     body: [0, "push", stream_id, payload]   (watch events / sub messages)

Version negotiation (rolling-upgrade skew tolerance): each build supports
the inclusive range [WIRE_MIN, WIRE_MAX]. A client's first request on a
fresh connection is a `hello` op carrying its range, always packed at
WIRE_MIN so any server in the range can parse it; the server pins the
connection to the highest common version and replies with it. A peer too
old to know `hello` answers with an unknown-op error — the client then
pins WIRE_MIN (the legacy protocol) and proceeds. Only a genuinely
disjoint range fails, LOUDLY, with a structured `WireVersionError` naming
both ranges — never by mis-parsing the other side's framing into garbage
lengths and codec noise.

Compatibility contract (tested in tests/test_torch_fabric.py):
readers MUST ignore unknown trailing fields in request/response/push
bodies, so a newer peer can append fields without breaking an older one.
"""

from __future__ import annotations

import asyncio
import struct
from typing import Any

from dynamo_tpu_torch.fabric import mpack

# Inclusive supported-version range for this build. v1 was the unversioned
# 4-byte-length framing; v2 added the leading version byte (hard reject on
# mismatch); v3 added hello-negotiation + the ignore-unknown-trailing-
# fields contract. The frame LAYOUT is identical for v2 and v3 — the
# version byte records which behavioral contract the sender follows.
WIRE_MIN = 2
WIRE_MAX = 3

# Default version for un-negotiated frames (hello itself, standby probes,
# replication subscribe): the FLOOR, so any supported peer can parse them.
WIRE_VERSION = WIRE_MIN

MAX_FRAME = 512 * 1024 * 1024  # object store payloads (model cards) can be big
_LEN = struct.Struct(">I")


class WireVersionError(ConnectionError):
    """Peer speaks a fabric wire protocol outside our supported range.

    Subclasses ConnectionError so transport plumbing treats it as a dead
    connection, but carries the structured versions so operators see a
    friendly upgrade-skew message rather than a framing parse error."""

    def __init__(self, got: int, want: Any = None) -> None:
        self.got = got
        self.want = want if want is not None else (WIRE_MIN, WIRE_MAX)
        super().__init__(
            f"fabric wire protocol mismatch: peer speaks v{got}, this "
            f"build supports v{WIRE_MIN}..v{WIRE_MAX} — the skew exceeds "
            f"one negotiable range; upgrade/downgrade the lagging side "
            f"before rolling the rest of the fleet"
        )


def negotiate(peer_min: int, peer_max: int) -> int:
    """Highest version common to this build and the peer's [min, max].

    Raises WireVersionError when the ranges are disjoint."""
    common = min(WIRE_MAX, int(peer_max))
    if common < max(WIRE_MIN, int(peer_min)):
        raise WireVersionError(int(peer_max))
    return common


def pack(msg: Any, version: int = WIRE_VERSION) -> bytes:
    body = mpack.packb(msg)
    return bytes([version]) + _LEN.pack(len(body)) + body


async def read_frame(reader: asyncio.StreamReader) -> Any:
    header = await reader.readexactly(5)
    version = header[0]
    if not WIRE_MIN <= version <= WIRE_MAX:
        raise WireVersionError(version)
    (length,) = _LEN.unpack(header[1:])
    if length > MAX_FRAME:
        raise ValueError(f"frame too large: {length}")
    body = await reader.readexactly(length)
    return mpack.unpackb(body)
