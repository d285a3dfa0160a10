"""Wire types of remote prefill and the KV block payload codec: the port's
twin of dynamo_tpu/disagg/protocols.py (and of ``to_wire_array`` /
``from_wire_array`` and ``PrefillStreamCancelled``,
dynamo_tpu/disagg/transfer.py:74-106).

Two payload encodings share one self-describing container:

  * ``raw``: the logical dtype's bytes, bit exact. bfloat16 travels as
    uint16 words;
  * ``int8``: int8 mantissas and one f32 absmax scale per (layer, head,
    block), half the bytes of bf16 (``DYN_KV_WIRE=int8``).

``to_wire()`` gives the same dict, byte for byte, as the JAX package's for
the same arrays, checksums included under the same algorithm tag, so a
payload encoded by one package decodes in the other.

The card's machine has no ``ml_dtypes``, so nothing here needs it: on the
host a bfloat16 array is its uint16 words (numpy), and the conversions to
and from f32 go through torch's bfloat16 (round to nearest even, as
ml_dtypes rounds). Every array argument and result of this module is numpy,
bfloat16 as uint16 words, its logical dtype named beside it.
"""

from __future__ import annotations

import os
from dataclasses import asdict, dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from dynamo_tpu_torch import integrity

# dtype tag -> numpy wire dtype. bfloat16 travels as uint16.
_WIRE_DTYPES = {
    "bfloat16": np.uint16,
    "float32": np.float32,
    "float16": np.float16,
    "int8": np.int8,
}

_TORCH_DTYPES = {
    torch.bfloat16: "bfloat16",
    torch.float32: "float32",
    torch.float16: "float16",
    torch.int8: "int8",
}


class PrefillStreamCancelled(Exception):
    """The requesting sequence was killed while its remote prefill was in
    flight: the engine tears the sequence down instead of falling back to
    a local prefill."""


def wire_codec_from_env() -> str:
    """KV wire codec knob: DYN_KV_WIRE=bf16|int8 (default bf16 = raw)."""
    v = os.environ.get("DYN_KV_WIRE", "bf16").strip().lower()
    return "int8" if v == "int8" else "raw"


def dtype_name(t: torch.dtype) -> str:
    """The wire tag of a torch dtype ("bfloat16", "float32", ...)."""
    return _TORCH_DTYPES[t]


def to_wire_array(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a host numpy array of its wire dtype (bfloat16
    as uint16 words, a reinterpretation, not a conversion)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def from_wire_array(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A host tensor of the logical ``dtype`` over a wire array's bytes
    (uint16 words re-viewed as bfloat16, no copy)."""
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr, _WIRE_DTYPES[dtype]))


def _to_f32(x: np.ndarray, dtype: str) -> np.ndarray:
    if dtype == "bfloat16":
        return (np.ascontiguousarray(x, np.uint16).astype(np.uint32) << 16).view(np.float32)
    return np.ascontiguousarray(x, np.float32)


def _from_f32(x: np.ndarray, dtype: str) -> np.ndarray:
    if dtype == "bfloat16":
        return to_wire_array(torch.from_numpy(x).to(torch.bfloat16))
    return x.astype(_WIRE_DTYPES[dtype])


def kv_quantize_int8(x: np.ndarray, dtype: Optional[str] = None) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 quantization over the trailing (tokens, head_dim)
    axes: one f32 absmax scale per (..., block) slice, a per-(layer, head,
    block) scale in the [L, H, n, bs, D] layout. ``dtype`` names x's
    logical dtype (default its numpy dtype; uint16 words need
    "bfloat16")."""
    xf = _to_f32(x, dtype or x.dtype.name)
    amax = np.max(np.abs(xf), axis=(-2, -1), keepdims=True)
    scale = (amax / 127.0).astype(np.float32)
    inv = np.where(scale > 0, 1.0 / np.maximum(scale, 1e-30), 0.0)
    q = np.clip(np.rint(xf * inv), -127, 127).astype(np.int8)
    return q, np.squeeze(scale, axis=(-2, -1))


def kv_dequantize_int8(q: np.ndarray, scales: np.ndarray, dtype: str) -> np.ndarray:
    """kv_quantize_int8 undone, into the wire form of the logical
    ``dtype``."""
    xf = q.astype(np.float32) * scales[..., None, None]
    return _from_f32(xf, dtype)


@dataclass
class KvBlockPayload:
    """Dense KV blocks of one sequence: k / v of shape [L, Hkv, n, bs, D].

    ``codec`` is "raw" (the logical dtype's bytes) or "int8"
    (``k_scales`` / ``v_scales`` carry f32 scales of shape ``shape[:-2]``).
    The integrity header (``sum_algo``, ``k_sum``, ``v_sum``: checksums over
    payload and scale bytes) is stamped when the payload is made and
    verified by ``decode`` / ``quantized_arrays``; an untagged payload is
    accepted unverified."""

    shape: tuple[int, ...]
    dtype: str  # logical dtype name ("bfloat16", ...)
    k_bytes: bytes
    v_bytes: bytes
    codec: str = "raw"
    k_scales: bytes = b""
    v_scales: bytes = b""
    sum_algo: str = ""
    k_sum: int = 0
    v_sum: int = 0

    # ------------------------------------------------------------- encode

    def _stamp_sums(self) -> "KvBlockPayload":
        if integrity.enabled():
            self.sum_algo = integrity.ALGO
            self.k_sum = integrity.checksum(self.k_bytes, self.k_scales)
            self.v_sum = integrity.checksum(self.v_bytes, self.v_scales)
        return self

    @classmethod
    def encode(cls, k: np.ndarray, v: np.ndarray, codec: str = "raw",
               dtype: Optional[str] = None) -> "KvBlockPayload":
        """Encode arrays of the logical ``dtype`` (default their numpy
        dtype's name; bfloat16 arrays are uint16 words and need
        ``dtype="bfloat16"``)."""
        dtype = dtype or k.dtype.name
        if codec == "int8" and dtype != "int8":
            kq, ks = kv_quantize_int8(k, dtype)
            vq, vs = kv_quantize_int8(v, dtype)
            return cls(shape=tuple(k.shape), dtype=dtype, k_bytes=kq.tobytes(),
                       v_bytes=vq.tobytes(), codec="int8", k_scales=ks.tobytes(),
                       v_scales=vs.tobytes())._stamp_sums()
        wire = _WIRE_DTYPES[dtype]
        return cls(shape=tuple(k.shape), dtype=dtype,
                   k_bytes=np.ascontiguousarray(k, wire).tobytes(),
                   v_bytes=np.ascontiguousarray(v, wire).tobytes())._stamp_sums()

    @classmethod
    def from_arrays(cls, k: np.ndarray, v: np.ndarray, dtype: str) -> "KvBlockPayload":
        """Raw-path constructor over arrays already in their WIRE dtype
        (no checksum, as the reference's)."""
        return cls(shape=tuple(k.shape), dtype=dtype, k_bytes=k.tobytes(), v_bytes=v.tobytes())

    @classmethod
    def from_quantized(cls, kq: np.ndarray, ks: np.ndarray, vq: np.ndarray, vs: np.ndarray,
                       dtype: str = "bfloat16") -> "KvBlockPayload":
        """An int8-resident cache's mantissas [L, H, n, bs, D] and scales
        [L, H, n], shipped verbatim (no dequantize / requantize)."""
        return cls(
            shape=tuple(kq.shape), dtype=dtype,
            k_bytes=np.ascontiguousarray(kq, np.int8).tobytes(),
            v_bytes=np.ascontiguousarray(vq, np.int8).tobytes(),
            codec="int8",
            k_scales=np.ascontiguousarray(ks, np.float32).tobytes(),
            v_scales=np.ascontiguousarray(vs, np.float32).tobytes(),
        )._stamp_sums()

    def quantized_arrays(self, verify: bool = True) -> tuple[np.ndarray, ...]:
        """(kq, ks, vq, vs) views of an int8 payload, verified first: the
        verbatim landing path of an int8-resident receiver."""
        if self.codec != "int8":
            raise ValueError(f"quantized_arrays needs an int8 payload, not {self.codec!r}")
        if verify:
            self.verify()
        sshape = tuple(self.shape[:-2])
        return (
            np.frombuffer(self.k_bytes, np.int8).reshape(self.shape),
            np.frombuffer(self.k_scales, np.float32).reshape(sshape),
            np.frombuffer(self.v_bytes, np.int8).reshape(self.shape),
            np.frombuffer(self.v_scales, np.float32).reshape(sshape),
        )

    # ------------------------------------------------------------- decode

    def verify(self) -> None:
        """Raise ``integrity.IntegrityError`` when the bytes do not match
        the stamped checksums (a truncated payload fails too). Untagged
        payloads and unknown algorithms pass unverified."""
        if not self.sum_algo:
            return
        ks = integrity.checksum_with(self.sum_algo, self.k_bytes, self.k_scales)
        if ks is None:
            return
        vs = integrity.checksum_with(self.sum_algo, self.v_bytes, self.v_scales)
        if ks != self.k_sum or vs != self.v_sum:
            raise integrity.IntegrityError(
                f"KV payload failed {self.sum_algo} checksum "
                f"(k {'ok' if ks == self.k_sum else 'BAD'}, "
                f"v {'ok' if vs == self.v_sum else 'BAD'}, "
                f"{self.wire_nbytes} wire bytes)"
            )

    def decode(self, verify: bool = True) -> tuple[np.ndarray, np.ndarray]:
        """The arrays in the logical dtype's wire form (bfloat16 as uint16
        words), dequantized if int8; verified first."""
        if verify:
            self.verify()
        if self.codec == "int8":
            kq, ks, vq, vs = self.quantized_arrays(verify=False)
            return kv_dequantize_int8(kq, ks, self.dtype), kv_dequantize_int8(vq, vs, self.dtype)
        return self.to_arrays()

    def to_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """Raw-path WIRE-dtype views (raw codec only)."""
        wire = _WIRE_DTYPES[self.dtype]
        k = np.frombuffer(self.k_bytes, dtype=wire).reshape(self.shape)
        v = np.frombuffer(self.v_bytes, dtype=wire).reshape(self.shape)
        return k, v

    @property
    def wire_nbytes(self) -> int:
        """KV payload bytes crossing the wire."""
        return len(self.k_bytes) + len(self.v_bytes) + len(self.k_scales) + len(self.v_scales)

    @property
    def num_blocks(self) -> int:
        return int(self.shape[2]) if len(self.shape) >= 3 else 0

    def to_wire(self) -> dict[str, Any]:
        d = {"shape": list(self.shape), "dtype": self.dtype, "k": self.k_bytes, "v": self.v_bytes}
        if self.codec != "raw":
            d["codec"] = self.codec
            d["ks"] = self.k_scales
            d["vs"] = self.v_scales
        if self.sum_algo:
            d["alg"] = self.sum_algo
            d["ksm"] = self.k_sum
            d["vsm"] = self.v_sum
        return d

    @classmethod
    def from_wire(cls, d: dict[str, Any]) -> "KvBlockPayload":
        return cls(
            shape=tuple(d["shape"]), dtype=d["dtype"], k_bytes=d["k"], v_bytes=d["v"],
            codec=d.get("codec", "raw"), k_scales=d.get("ks", b""), v_scales=d.get("vs", b""),
            sum_algo=d.get("alg", ""), k_sum=d.get("ksm", 0), v_sum=d.get("vsm", 0),
        )


@dataclass
class KvStreamFrame:
    """One slice of a streaming remote prefill: the blocks one prefill chunk
    completed, shipped while later chunks compute. Keyed by (request_id,
    first_block) and idempotent: a redelivered frame overwrites the same
    blocks with the same content."""

    request_id: str
    seq: int  # frame ordinal within the stream (0-based)
    first_block: int  # sequence-block index of payload block 0
    payload: KvBlockPayload
    stamp: Optional[dict] = None  # epoch-fencing stamp {"iid", "ep"}

    def to_wire(self) -> dict[str, Any]:
        d = {"kind": "frame", "request_id": self.request_id, "seq": self.seq,
             "first_block": self.first_block, "payload": self.payload.to_wire()}
        if self.stamp:
            d["stamp"] = self.stamp
        return d

    @classmethod
    def from_wire(cls, d: dict[str, Any]) -> "KvStreamFrame":
        return cls(request_id=d["request_id"], seq=int(d.get("seq", 0)),
                   first_block=int(d.get("first_block", 0)),
                   payload=KvBlockPayload.from_wire(d["payload"]), stamp=d.get("stamp"))


@dataclass
class RemotePrefillRequest:
    """Sent by a decode worker; served by any prefill worker."""

    request_id: str
    token_ids: list[int]
    reply_subject: str
    # sampling for the first token (prefill samples it, decode continues)
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    # leading blocks already cached on the decode worker: not shipped back
    cached_blocks: int = 0
    block_size: int = 16
    # the requester's first-token identity: its key row, repetition
    # penalty and min_tokens EOS mask
    rep_pen: float = 1.0
    key_data: Optional[list[int]] = None  # [2] (stream, counter)
    eos_ids: Optional[list[int]] = None
    eos_suppress: bool = False
    stream: bool = False  # ship frames per prefill chunk
    deadline: Optional[float] = None  # absolute, epoch seconds
    extra: dict[str, Any] = field(default_factory=dict)

    def to_wire(self) -> dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_wire(cls, d: dict[str, Any]) -> "RemotePrefillRequest":
        known = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass
class RemotePrefillResponse:
    """The prefill worker's answer. On the streaming path it is the FINAL
    frame: ``payload`` carries only the blocks not yet streamed (at least
    the partial tail block) and ``streamed_blocks`` how many the stream
    shipped."""

    request_id: str
    first_token: int
    payload: Optional[KvBlockPayload] = None  # blocks [first_block, ...)
    first_block: int = 0
    error: Optional[str] = None
    code: Optional[str] = None  # "deadline_exceeded", "cancelled", ...
    streamed_blocks: int = 0
    first_logprob: Optional[float] = None
    first_top: Optional[list] = None  # [[token_id, logprob], ...]
    trace: Optional[list] = None
    stamp: Optional[dict] = None

    def to_wire(self) -> dict[str, Any]:
        return {
            "request_id": self.request_id,
            "first_token": self.first_token,
            "payload": self.payload.to_wire() if self.payload else None,
            "first_block": self.first_block,
            "error": self.error,
            "code": self.code,
            "streamed_blocks": self.streamed_blocks,
            "first_logprob": self.first_logprob,
            "first_top": self.first_top,
            "trace": self.trace,
            "stamp": self.stamp,
        }

    @classmethod
    def from_wire(cls, d: dict[str, Any]) -> "RemotePrefillResponse":
        p = d.get("payload")
        return cls(
            request_id=d["request_id"], first_token=d["first_token"],
            payload=KvBlockPayload.from_wire(p) if p else None,
            first_block=d.get("first_block", 0), error=d.get("error"), code=d.get("code"),
            streamed_blocks=d.get("streamed_blocks", 0), first_logprob=d.get("first_logprob"),
            first_top=d.get("first_top"), trace=d.get("trace"), stamp=d.get("stamp"),
        )
