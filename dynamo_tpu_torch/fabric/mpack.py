"""A stdlib msgpack codec for the fabric's wire and the request plane.

The JAX package packs every fabric frame and request-plane message with the
``msgpack`` package (``packb(obj, use_bin_type=True)`` /
``unpackb(b, raw=False)``); the card's machine has no ``msgpack``, so the
port carries this codec instead. It gives the same bytes as
``msgpack.packb(obj, use_bin_type=True)`` for the types the fabric sends --
None, bool, int (fixint to uint64 / int64), float (always float64, 0xcb),
str, bytes (bytearray and memoryview pack as bin too), list and tuple
(arrays), dict -- and decodes as ``msgpack.unpackb(b, raw=False)``: arrays
come back as lists, only str / bytes map keys are taken (msgpack 1.x's
``strict_map_key``). Any other type raises TypeError, an int outside int64 /
uint64 OverflowError (as msgpack does), and truncated, trailing or unknown
bytes ValueError; a partial value is never returned.
"""

from __future__ import annotations

import struct
from typing import Any

__all__ = ["packb", "unpackb"]

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_f = struct.Struct(">f")
_d = struct.Struct(">d")
_F64 = struct.Struct(">Bd")  # 0xcb and the float64


def _pack_int(o: int, out: bytearray) -> None:
    if o >= 0:
        if o < 0x80:
            out.append(o)
        elif o < 0x100:
            out += b"\xcc" + _B.pack(o)
        elif o < 0x10000:
            out += b"\xcd" + _H.pack(o)
        elif o < 0x100000000:
            out += b"\xce" + _I.pack(o)
        elif o < 0x10000000000000000:
            out += b"\xcf" + _Q.pack(o)
        else:
            raise OverflowError("Integer value out of range")
    elif o >= -32:
        out.append(o & 0xFF)
    elif o >= -0x80:
        out += b"\xd0" + _b.pack(o)
    elif o >= -0x8000:
        out += b"\xd1" + _h.pack(o)
    elif o >= -0x80000000:
        out += b"\xd2" + _i.pack(o)
    elif o >= -0x8000000000000000:
        out += b"\xd3" + _q.pack(o)
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix: int, fix_max: int, codes: bytes, out: bytearray, what: str) -> None:
    """The header of a str / array / map of ``n`` items (``codes``: the 8-,
    16- and 32-bit forms, the 8-bit one only for str)."""
    if n < fix_max:
        out.append(fix | n)
    elif codes[0] and n < 0x100:
        out.append(codes[0])
        out.append(n)
    elif n < 0x10000:
        out.append(codes[1])
        out += _H.pack(n)
    elif n < 0x100000000:
        out.append(codes[2])
        out += _I.pack(n)
    else:
        raise ValueError(f"{what} is too large")


def _pack_bin(data: bytes, out: bytearray) -> None:
    n = len(data)
    if n < 0x100:
        out.append(0xC4)
        out.append(n)
    elif n < 0x10000:
        out.append(0xC5)
        out += _H.pack(n)
    elif n < 0x100000000:
        out.append(0xC6)
        out += _I.pack(n)
    else:
        raise ValueError("bytes object is too large")
    out += data


def _pack(o: Any, out: bytearray, depth: int) -> None:
    if depth < 0:
        raise ValueError("recursion limit exceeded")
    # msgpack's own order of checks (subclasses of int, float, bytes, str,
    # dict, list and tuple pack as their base type; True is not an int)
    if o is None:
        out.append(0xC0)
    elif o is True:
        out.append(0xC3)
    elif o is False:
        out.append(0xC2)
    elif isinstance(o, int):
        _pack_int(o, out)
    elif isinstance(o, float):
        out += _F64.pack(0xCB, o)
    elif isinstance(o, (bytes, bytearray)):
        _pack_bin(o, out)
    elif isinstance(o, str):
        data = o.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, b"\xd9\xda\xdb", out, "unicode string")
        out += data
    elif isinstance(o, dict):
        _pack_len(len(o), 0x80, 16, b"\x00\xde\xdf", out, "dict")
        for k, v in o.items():
            _pack(k, out, depth - 1)
            _pack(v, out, depth - 1)
    elif isinstance(o, (list, tuple)):
        _pack_len(len(o), 0x90, 16, b"\x00\xdc\xdd", out, "list")
        for v in o:
            _pack(v, out, depth - 1)
    elif isinstance(o, memoryview):
        _pack_bin(o.tobytes(), out)
    else:
        raise TypeError(f"can not serialize {type(o).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)``."""
    out = bytearray()
    _pack(obj, out, 511)
    return bytes(out)


_INCOMPLETE = "Unpack failed: incomplete input"
# fixed-size forms: type byte -> (struct, size)
_FIXED = {0xCA: _f, 0xCB: _d, 0xCC: _B, 0xCD: _H, 0xCE: _I, 0xCF: _Q,
          0xD0: _b, 0xD1: _h, 0xD2: _i, 0xD3: _q}
# sized forms: type byte -> (length struct, kind)
_SIZED = {0xC4: (_B, "bin"), 0xC5: (_H, "bin"), 0xC6: (_I, "bin"),
          0xD9: (_B, "str"), 0xDA: (_H, "str"), 0xDB: (_I, "str"),
          0xDC: (_H, "array"), 0xDD: (_I, "array"), 0xDE: (_H, "map"), 0xDF: (_I, "map")}


def _unpack(buf: bytes, pos: int, end: int, depth: int) -> tuple[Any, int]:
    """The object at ``pos`` and the position after it."""
    if depth < 0:
        raise ValueError("recursion limit exceeded")
    if pos >= end:
        raise ValueError(_INCOMPLETE)
    c = buf[pos]
    pos += 1
    if c < 0x80:
        return c, pos
    if c >= 0xE0:
        return c - 0x100, pos
    if c < 0xC0:
        if c >= 0xA0:
            kind, n = "str", c & 0x1F
        else:
            kind, n = ("map" if c < 0x90 else "array"), c & 0x0F
    elif c == 0xC0:
        return None, pos
    elif c == 0xC2:
        return False, pos
    elif c == 0xC3:
        return True, pos
    elif c in _FIXED:
        st = _FIXED[c]
        if pos + st.size > end:
            raise ValueError(_INCOMPLETE)
        return st.unpack_from(buf, pos)[0], pos + st.size
    elif c in _SIZED:
        st, kind = _SIZED[c]
        if pos + st.size > end:
            raise ValueError(_INCOMPLETE)
        n = st.unpack_from(buf, pos)[0]
        pos += st.size
    else:
        # 0xc1 is never used; 0xc7-0xc9 and 0xd4-0xd8 are ext types, which
        # the fabric never sends
        raise ValueError(f"Unpack failed: unsupported type byte 0x{c:02x}")
    if kind == "str" or kind == "bin":
        if pos + n > end:
            raise ValueError(_INCOMPLETE)
        data = buf[pos:pos + n]
        return (data.decode("utf-8") if kind == "str" else bytes(data)), pos + n
    if kind == "array":
        out = []
        for _ in range(n):
            v, pos = _unpack(buf, pos, end, depth - 1)
            out.append(v)
        return out, pos
    d: dict = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos, end, depth - 1)
        if type(k) is not str and type(k) is not bytes:
            raise ValueError(f"{type(k).__name__} is not allowed for map key when strict_map_key=True")
        d[k], pos = _unpack(buf, pos, end, depth - 1)
    return d, pos


def unpackb(data: Any) -> Any:
    """``msgpack.unpackb(data, raw=False)``: one whole object, else
    ValueError."""
    if isinstance(data, memoryview):
        data = data.tobytes()
    elif not isinstance(data, (bytes, bytearray)):
        raise TypeError(f"a bytes-like object is required, not {type(data).__name__!r}")
    obj, pos = _unpack(data, 0, len(data), 511)
    if pos != len(data):
        raise ValueError("Unpack failed: extra data after the object")
    return obj
