"""SentencePiece tokenizer: native .model reader + encoder/decoder.

The port's own copy of dynamo_tpu/sp_tokenizer.py (the port imports nothing of the JAX
package).

Role-equivalent of lib/llm/src/tokenizers/sp.rs (the reference wraps the
SentencePiece C++ library; this image has neither it nor protobuf, so the
.model file — a serialized ModelProto — is parsed directly off the
protobuf wire format, and encoding is implemented for both model types:

  * UNIGRAM — Viterbi segmentation maximizing the summed piece
    log-probabilities (the algorithm SentencePiece itself uses at
    inference);
  * BPE — iterative best-scored adjacent merges from characters, which is
    SentencePiece's BPE encode (scores are merge priorities).

Whitespace handling follows NormalizerSpec: escape_whitespaces maps
' ' -> '▁' (U+2581), add_dummy_prefix prepends one. Characters with no
piece coverage fall back to byte pieces ('<0xNN>') when the vocab has
them, else the unk id. The resulting SentencePieceTokenizer duck-types
the surface TokenizerWrapper needs (encode/decode/token_to_id/
get_vocab_size), so `TokenizerWrapper.from_model_dir` serves model dirs
that ship only tokenizer.model.
"""

from __future__ import annotations

import os
import unicodedata
from dataclasses import dataclass, field
from typing import Optional, Sequence

SPACE_PIECE = "▁"  # ▁

# SentencePiece ModelProto piece types
_NORMAL, _UNKNOWN, _CONTROL, _USER_DEFINED, _UNUSED, _BYTE = 1, 2, 3, 4, 5, 6


# ------------------------------------------------------- protobuf wire


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = buf[i]
        val |= (b & 0x7F) << shift
        i += 1
        if not b & 0x80:
            return val, i
        shift += 7


def _fields(buf: bytes):
    """Iterate (field_number, wire_type, value) over one message."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        fno, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            val, i = _read_varint(buf, i)
        elif wt == 1:  # 64-bit
            val, i = buf[i:i + 8], i + 8
        elif wt == 2:  # length-delimited
            ln, i = _read_varint(buf, i)
            val, i = buf[i:i + ln], i + ln
        elif wt == 5:  # 32-bit
            val, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield fno, wt, val


@dataclass
class SpPiece:
    piece: str
    score: float
    type: int = _NORMAL


@dataclass
class SpModel:
    pieces: list[SpPiece] = field(default_factory=list)
    model_type: int = 1  # TrainerSpec.model_type: 1=unigram, 2=bpe
    normalizer_name: str = "nmt_nfkc"
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2


def parse_model_proto(data: bytes) -> SpModel:
    """ModelProto wire layout (sentencepiece_model.proto): field 1 =
    repeated SentencePiece{piece:1, score:2, type:3}, field 2 =
    TrainerSpec{model_type:3, unk_id:40, bos_id:41, eos_id:42},
    field 4 = NormalizerSpec{add_dummy_prefix:3,
    remove_extra_whitespaces:4, escape_whitespaces:5}."""
    import struct

    m = SpModel()
    for fno, wt, val in _fields(data):
        if fno == 1 and wt == 2:  # SentencePiece
            piece, score, ptype = "", 0.0, _NORMAL
            for pf, pwt, pval in _fields(val):
                if pf == 1:
                    piece = pval.decode("utf-8", errors="replace")
                elif pf == 2 and pwt == 5:
                    score = struct.unpack("<f", pval)[0]
                elif pf == 3 and pwt == 0:
                    ptype = pval
            m.pieces.append(SpPiece(piece, score, ptype))
        elif fno == 2 and wt == 2:  # TrainerSpec
            for tf, twt, tval in _fields(val):
                if twt != 0:
                    continue
                # negative int32 ids (-1 = disabled, e.g. T5's bos_id) are
                # encoded as 64-bit two's-complement varints
                if tval >= 1 << 63:
                    tval -= 1 << 64
                if tf == 3:
                    m.model_type = tval
                elif tf == 40:
                    m.unk_id = tval
                elif tf == 41:
                    m.bos_id = tval
                elif tf == 42:
                    m.eos_id = tval
        elif fno == 4 and wt == 2:  # NormalizerSpec
            for nf, nwt, nval in _fields(val):
                if nf == 1 and nwt == 2:
                    m.normalizer_name = nval.decode(
                        "utf-8", errors="replace"
                    )
                if nwt != 0:
                    continue
                if nf == 3:
                    m.add_dummy_prefix = bool(nval)
                elif nf == 4:
                    m.remove_extra_whitespaces = bool(nval)
                elif nf == 5:
                    m.escape_whitespaces = bool(nval)
    return m


# ----------------------------------------------------------- tokenizer


@dataclass
class SpEncoding:
    ids: list[int]
    tokens: list[str]


class SentencePieceTokenizer:
    """Encoder/decoder over a parsed SpModel; HfTokenizer-duck-typed."""

    def __init__(self, model: SpModel) -> None:
        self.model = model
        self._piece_to_id: dict[str, int] = {}
        self._byte_ids: dict[int, int] = {}
        self._special: set[int] = set()
        self._max_piece_chars = 1
        for i, p in enumerate(model.pieces):
            self._piece_to_id.setdefault(p.piece, i)
            if p.type == _BYTE and len(p.piece) == 6:  # '<0xNN>'
                try:
                    self._byte_ids[int(p.piece[3:5], 16)] = i
                except ValueError:
                    pass
            if p.type in (_CONTROL, _UNKNOWN):
                self._special.add(i)
            if p.type in (_NORMAL, _USER_DEFINED):
                self._max_piece_chars = max(
                    self._max_piece_chars, len(p.piece)
                )
        # unk/byte fallback score: below any real piece (pure function of
        # the model — computed once, not per encode on the request path)
        self._fallback_score = min(
            (p.score for p in model.pieces if p.type == _NORMAL),
            default=0.0,
        ) - 10.0

    @classmethod
    def from_file(cls, path: str) -> "SentencePieceTokenizer":
        with open(path, "rb") as f:
            return cls(parse_model_proto(f.read()))

    # -------------------------------------------------------- normalize

    def _normalize(self, text: str) -> str:
        # honor NormalizerSpec.name: "identity" (llama-family) means no
        # unicode rewriting at all; nfkc-family normalizers apply NFKC,
        # and the nmt variants additionally fold control whitespace
        # (\t \n \r) to plain space before the escape step
        name = self.model.normalizer_name
        if name != "identity":
            if name.startswith("nmt"):
                text = text.translate(
                    {0x9: " ", 0xA: " ", 0xD: " "}
                )
            if "nfkc" in name or name == "":
                text = unicodedata.normalize("NFKC", text)
        if self.model.remove_extra_whitespaces:
            # collapse runs of spaces and trim ends, as SP's normalizer does
            text = " ".join(s for s in text.split(" ") if s)
        if self.model.add_dummy_prefix and text:
            text = " " + text
        if self.model.escape_whitespaces:
            text = text.replace(" ", SPACE_PIECE)
        return text

    # ----------------------------------------------------------- encode

    def encode(self, text: str, add_special_tokens: bool = True) -> SpEncoding:
        norm = self._normalize(text)
        if not norm:
            ids: list[int] = []
        elif self.model.model_type == 2:
            ids = self._encode_bpe(norm)
        else:
            ids = self._encode_unigram(norm)
        if add_special_tokens and self.model.bos_id >= 0:
            ids = [self.model.bos_id] + ids
        return SpEncoding(
            ids=ids,
            tokens=[self.model.pieces[i].piece for i in ids],
        )

    def _segment_fallback(self, ch: str) -> list[int]:
        """A character no piece covers: byte pieces, else unk."""
        out = []
        for b in ch.encode("utf-8"):
            bid = self._byte_ids.get(b)
            if bid is None:
                return [self.model.unk_id]
            out.append(bid)
        return out

    def _encode_unigram(self, s: str) -> list[int]:
        """Viterbi: best[i] = max-score segmentation of s[:i]."""
        n = len(s)
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: list[Optional[tuple[int, list[int]]]] = [None] * (n + 1)
        best[0] = 0.0
        fallback_score = self._fallback_score
        for i in range(n):
            if best[i] == NEG:
                continue
            hi = min(n, i + self._max_piece_chars)
            for j in range(i + 1, hi + 1):
                pid = self._piece_to_id.get(s[i:j])
                if pid is None:
                    continue
                p = self.model.pieces[pid]
                if p.type in (_CONTROL, _UNKNOWN, _UNUSED, _BYTE):
                    continue
                sc = best[i] + p.score
                if sc > best[j]:
                    best[j] = sc
                    back[j] = (i, [pid])
            # single-char fallback edge
            j = i + 1
            sc = best[i] + fallback_score
            if sc > best[j]:
                best[j] = sc
                back[j] = (i, self._segment_fallback(s[i]))
        ids: list[int] = []
        j = n
        while j > 0:
            i, pids = back[j]  # type: ignore[misc]
            ids[:0] = pids
            j = i
        return ids

    def _encode_bpe(self, s: str) -> list[int]:
        """SentencePiece BPE: start from characters, repeatedly merge the
        adjacent pair whose concatenation is the best-scored piece.

        Heap-based merge queue (seed all pairs once, after a merge only
        its two new neighbor pairs are re-evaluated) — O(n log n), not the
        naive full rescan per merge, since this runs per request on the
        preprocessing hot path."""
        import heapq

        n = len(s)
        if n == 0:
            return []
        parts: list[Optional[str]] = list(s)
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))

        def pair_entry(i: int):
            j = nxt[i]
            if j >= n or parts[i] is None or parts[j] is None:
                return None
            pid = self._piece_to_id.get(parts[i] + parts[j])
            if pid is None:
                return None
            # (neg score, position) — ties resolve leftmost like SP
            return (-self.model.pieces[pid].score, i, parts[i], parts[j])

        heap = [e for i in range(n) if (e := pair_entry(i)) is not None]
        heapq.heapify(heap)
        while heap:
            _, i, left, right = heapq.heappop(heap)
            j = nxt[i] if i < n else n
            # stale entry: one side already merged away
            if j >= n or parts[i] != left or parts[j] != right:
                continue
            parts[i] = left + right
            parts[j] = None
            nxt[i] = nxt[j]
            if nxt[j] < n:
                prev[nxt[j]] = i
            for k in (prev[i], i):
                if 0 <= k < n and (e := pair_entry(k)) is not None:
                    heapq.heappush(heap, e)
        ids: list[int] = []
        i = 0
        while 0 <= i < n:
            part = parts[i]
            if part is not None:
                pid = self._piece_to_id.get(part)
                if pid is not None and self.model.pieces[pid].type not in (
                    _CONTROL, _UNKNOWN, _UNUSED, _BYTE,
                ):
                    ids.append(pid)
                else:
                    for ch in part:
                        cid = self._piece_to_id.get(ch)
                        if cid is not None:
                            ids.append(cid)
                        else:
                            ids.extend(self._segment_fallback(ch))
            i = nxt[i]
        return ids

    # ----------------------------------------------------------- decode

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        out: list[str] = []
        byte_buf = bytearray()

        def flush_bytes():
            if byte_buf:
                out.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            if i < 0 or i >= len(self.model.pieces):
                continue
            p = self.model.pieces[i]
            if p.type == _BYTE:
                try:
                    byte_buf.append(int(p.piece[3:5], 16))
                    continue
                except ValueError:
                    pass
            flush_bytes()
            if skip_special_tokens and i in self._special:
                continue
            out.append(p.piece)
        flush_bytes()
        text = "".join(out).replace(SPACE_PIECE, " ")
        if self.model.add_dummy_prefix and text.startswith(" "):
            text = text[1:]
        return text

    # ---------------------------------------------- HfTokenizer surface

    def token_to_id(self, token: str) -> Optional[int]:
        return self._piece_to_id.get(token)

    def get_vocab_size(self) -> int:
        return len(self.model.pieces)

    def to_str(self) -> str:
        raise NotImplementedError(
            "SentencePiece models serialize as .model protobufs, not "
            "tokenizer.json — ship the original file"
        )


def serialize_model_proto(model: SpModel) -> bytes:
    """SpModel -> ModelProto wire bytes (inverse of parse_model_proto).

    Used when a tokenizer is constructed from somewhere other than a
    .model file (e.g. GGUF tokenizer.ggml metadata) but still needs the
    canonical byte form — model cards publish exactly these bytes."""
    import struct

    def varint(n: int) -> bytes:
        out = b""
        while True:
            b = n & 0x7F
            n >>= 7
            out += bytes([b | (0x80 if n else 0)])
            if not n:
                return out

    def ld(fno: int, payload: bytes) -> bytes:
        return varint((fno << 3) | 2) + varint(len(payload)) + payload

    def vi(fno: int, val: int) -> bytes:
        if val < 0:
            val += 1 << 64  # two's-complement (disabled ids are -1)
        return varint(fno << 3) + varint(val)

    def f32(fno: int, val: float) -> bytes:
        return varint((fno << 3) | 5) + struct.pack("<f", val)

    blob = b"".join(
        ld(1, ld(1, p.piece.encode()) + f32(2, p.score) + vi(3, p.type))
        for p in model.pieces
    )
    trainer = (
        vi(3, model.model_type) + vi(40, model.unk_id)
        + vi(41, model.bos_id) + vi(42, model.eos_id)
    )
    norm = ld(1, model.normalizer_name.encode()) + vi(
        3, int(model.add_dummy_prefix)
    ) + vi(4, int(model.remove_extra_whitespaces)) + vi(
        5, int(model.escape_whitespaces)
    )
    return blob + ld(2, trainer) + ld(4, norm)


def sp_model_path(model_dir: str) -> Optional[str]:
    for name in ("tokenizer.model", "spiece.model", "sentencepiece.model"):
        p = os.path.join(model_dir, name)
        if os.path.exists(p):
            return p
    return None
