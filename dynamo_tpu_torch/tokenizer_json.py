"""A stdlib reader of HF ``tokenizer.json`` files that encodes and decodes
as the HF ``tokenizers`` library does.

The reference (dynamo_tpu/tokenizer.py) loads ``tokenizer.json`` through
HF ``tokenizers``, which the card's machine does not have. This module
runs the same pipeline in Python:

  1. added tokens are split out of the raw text (the ones with
     ``normalized: false``), honouring ``single_word``, ``lstrip`` and
     ``rstrip``; the rest of the text is normalized and the
     ``normalized: true`` added tokens are split out of it;
  2. the pre-tokenizer cuts each remaining piece into words;
  3. the model maps each word to ids (BPE by merge rank with a heap, with
     ``byte_fallback``, ``ignore_merges``, ``continuing_subword_prefix`` /
     ``end_of_word_suffix``, ``fuse_unk`` and a per-word cache; or
     WordLevel);
  4. the post-processor adds the template's special tokens.

Decoding maps ids to token strings (unknown ids are skipped, special ones
too under ``skip_special_tokens``) and runs the decoder chain over all of
them. Components covered:

  normalizers     Sequence, Prepend, Replace, NFC, NFKC, NFD, NFKD
  pre-tokenizers  Sequence, Split, ByteLevel, Metaspace, Whitespace,
                  WhitespaceSplit, Digits
  models          BPE, WordLevel
  post-processors TemplateProcessing, ByteLevel, Sequence
  decoders        ByteLevel, Metaspace, ByteFallback, Fuse, Strip, Replace,
                  Sequence

A component of another type raises ``ValueError`` at load, naming it.

Regex patterns are Oniguruma syntax in the file. Python's ``re`` lacks
``\\p{..}`` classes and has another ``\\s`` / ``\\w``, so ``onig_to_re``
rewrites those escapes into explicit classes built from ``unicodedata``
(Python's Unicode tables: a code point they leave unassigned, which the
Rust crate's newer tables may assign, can split differently).
"""

from __future__ import annotations

import functools
import heapq
import json
import re
import sys
import unicodedata
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

# ---------------------------------------------------------------- unicode

# the White_Space property (Rust's char::is_whitespace, Oniguruma's \s)
WHITESPACE = (
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005"
    "\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000"
)
_WS = frozenset(WHITESPACE)


def _esc(cp: int) -> str:
    return f"\\U{cp:08x}"


@functools.cache
def _category_ranges() -> dict[str, list[tuple[int, int]]]:
    """General category (two letters) -> sorted code point ranges."""
    out: dict[str, list[tuple[int, int]]] = {}
    cat = unicodedata.category
    prev, start = None, 0
    for cp in range(sys.maxunicode + 2):
        c = cat(chr(cp)) if cp <= sys.maxunicode else None
        if c != prev:
            if prev is not None:
                out.setdefault(prev, []).append((start, cp - 1))
            prev, start = c, cp
    return out


@functools.cache
def class_body(names: tuple[str, ...]) -> str:
    """The inside of a regex character class holding every code point whose
    general category starts with one of ``names`` ("L", "Nd", ...)."""
    ranges = sorted(
        r for cat, rs in _category_ranges().items()
        if any(cat.startswith(n) for n in names) for r in rs
    )
    if not ranges:
        raise ValueError(f"unknown Unicode category {names}")
    return "".join(_esc(a) if a == b else f"{_esc(a)}-{_esc(b)}" for a, b in ranges)


_WS_BODY = "".join(_esc(ord(c)) for c in WHITESPACE)
# Oniguruma's Unicode \w: Letter | Mark | Number | Connector_Punctuation
_ONIG_WORD = ("L", "M", "N", "Pc")


def onig_to_re(pattern: str) -> str:
    """Rewrite an Oniguruma pattern for Python's ``re``: ``\\p{X}`` /
    ``\\P{X}``, ``\\s`` / ``\\S`` and ``\\w`` / ``\\W`` become explicit
    classes; everything else passes through (Python 3.11+ also takes
    possessive quantifiers and atomic groups). Raises for what it cannot
    rewrite (a negated class escape inside a class, nested classes)."""
    out: list[str] = []
    i, n = 0, len(pattern)
    in_class = False
    while i < n:
        c = pattern[i]
        if c == "\\" and i + 1 < n:
            e = pattern[i + 1]
            if e in "pP" and i + 2 < n and pattern[i + 2] == "{":
                j = pattern.index("}", i + 3)
                name = pattern[i + 3:j]
                neg = e == "P"
                if name.startswith("^"):
                    neg, name = not neg, name[1:]
                body = class_body((name,))
                i = j + 1
            elif e in "sS":
                body, neg = _WS_BODY, e == "S"
                i += 2
            elif e in "wW":
                body, neg = class_body(_ONIG_WORD), e == "W"
                i += 2
            else:
                out.append(pattern[i:i + 2])
                i += 2
                continue
            if in_class:
                if neg:
                    raise ValueError(f"cannot rewrite a negated class escape inside [...] in {pattern!r}")
                out.append(body)
            else:
                out.append(f"[{'^' if neg else ''}{body}]")
            continue
        if c == "[":
            if in_class:
                raise ValueError(f"nested character classes are not supported: {pattern!r}")
            in_class = True
            out.append(c)
            i += 1
            # a leading ^ and a literal ] right after [ or [^ belong to the class
            if i < n and pattern[i] == "^":
                out.append("^")
                i += 1
            if i < n and pattern[i] == "]":
                out.append("\\]")
                i += 1
            continue
        if c == "]" and in_class:
            in_class = False
        out.append(c)
        i += 1
    return "".join(out)


def _compile(pattern: dict) -> "re.Pattern[str]":
    """A ``{"String": s}`` (literal) or ``{"Regex": r}`` (Oniguruma) pattern."""
    if "String" in pattern:
        return re.compile(re.escape(pattern["String"]))
    if "Regex" in pattern:
        return re.compile(onig_to_re(pattern["Regex"]))
    raise ValueError(f"unknown pattern {pattern!r}")


# ------------------------------------------------------------- splitting

# (start, end, is_match) spans covering a piece, as the Rust Pattern's
# find_matches returns them
Spans = list[tuple[int, int, bool]]


def _regex_spans(rx: "re.Pattern[str]", s: str) -> Spans:
    spans: Spans = []
    prev = 0
    for m in rx.finditer(s):
        a, b = m.span()
        if prev != a:
            spans.append((prev, a, False))
        spans.append((a, b, True))
        prev = b
    if prev != len(s):
        spans.append((prev, len(s), False))
    return spans


def _char_spans(pred: Callable[[str], bool], s: str) -> Spans:
    """Each char for which ``pred`` holds is a match of its own."""
    spans: Spans = []
    last = 0
    for i, ch in enumerate(s):
        if pred(ch):
            if last < i:
                spans.append((last, i, False))
            spans.append((i, i + 1, True))
            last = i + 1
    if last < len(s):
        spans.append((last, len(s), False))
    return spans


def _apply_behavior(spans: Spans, behavior: str) -> list[tuple[int, int]]:
    """The kept (start, end) ranges of a split (SplitDelimiterBehavior)."""
    b = behavior.lower()
    if b == "removed":
        return [(a, e) for a, e, m in spans if not m]
    if b == "isolated":
        return [(a, e) for a, e, _ in spans]
    out: list[list[int]] = []
    prev_match = False
    if b == "mergedwithprevious" or b == "merged_with_previous":
        for a, e, m in spans:
            if m and not prev_match and out:
                out[-1][1] = e
            else:
                out.append([a, e])
            prev_match = m
        return [(a, e) for a, e in out]
    if b == "mergedwithnext" or b == "merged_with_next":
        for a, e, m in reversed(spans):
            if m and not prev_match and out:
                out[-1][0] = a
            else:
                out.append([a, e])
            prev_match = m
        return [(a, e) for a, e in reversed(out)]
    if b == "contiguous":
        for a, e, m in spans:
            if m == prev_match and out:
                out[-1][1] = e
            else:
                out.append([a, e])
            prev_match = m
        return [(a, e) for a, e in out]
    raise ValueError(f"unknown split behavior {behavior!r}")


# a piece of text and whether it starts at offset 0 of the original input
Piece = tuple[str, bool]


def _split(piece: Piece, spans: Spans, behavior: str) -> list[Piece]:
    s, at0 = piece
    return [(s[a:e], at0 and a == 0) for a, e in _apply_behavior(spans, behavior) if e > a]


# ------------------------------------------------------------ normalizers


def _normalizer(d: Optional[dict]) -> Callable[[str], str]:
    if d is None:
        return lambda s: s
    t = d.get("type")
    if t == "Sequence":
        steps = [_normalizer(x) for x in d["normalizers"]]

        def seq(s: str) -> str:
            for f in steps:
                s = f(s)
            return s
        return seq
    if t in ("NFC", "NFKC", "NFD", "NFKD"):
        return functools.partial(hf_normalize, t)
    if t == "Prepend":
        pre = d["prepend"]
        return lambda s: pre + s if s else s
    if t == "Replace":
        rx, content = _compile(d["pattern"]), d["content"]
        return lambda s: rx.sub(lambda _m: content, s)
    raise ValueError(f"tokenizer.json: unsupported normalizer type {t!r}")


# Code points that Python's Unicode tables (15.0.0 on Python 3.12) map under
# a form and HF tokenizers' tables (0.22.2) leave as they are, as inclusive
# ranges; `python3 -m tests.test_torch_unicode_forms` sweeps every code
# point against `tokenizers` and prints this table. NFC has none.
HF_KEEPS = {
    "NFKC": ((0x32FF, 0x32FF), (0xA7F2, 0xA7F4), (0xAB69, 0xAB69), (0x10781, 0x10785),
             (0x10787, 0x107B0), (0x107B2, 0x107BA), (0x1E030, 0x1E06D), (0x1F16C, 0x1F16C),
             (0x1FBF0, 0x1FBF9)),
    "NFD": ((0x11938, 0x11938),),
    "NFKD": ((0x32FF, 0x32FF), (0xA7F2, 0xA7F4), (0xAB69, 0xAB69), (0x10781, 0x10785),
             (0x10787, 0x107B0), (0x107B2, 0x107BA), (0x11938, 0x11938), (0x1E030, 0x1E06D),
             (0x1F16C, 0x1F16C), (0x1FBF0, 0x1FBF9)),
}
_KEEP_RE = {
    form: re.compile("([" + "".join(f"{re.escape(chr(a))}-{re.escape(chr(b))}" for a, b in rs) + "])")
    for form, rs in HF_KEEPS.items()
}


def hf_normalize(form: str, s: str) -> str:
    """``unicodedata.normalize(form, s)`` with HF's tables: a code point of
    ``HF_KEEPS[form]`` stays as it is. HF's tables leave each such code
    point a starter that decomposes to nothing and composes with nothing,
    so the text on either side of it is normalized on its own."""
    keep = _KEEP_RE.get(form)
    if keep is None or not keep.search(s):
        return unicodedata.normalize(form, s)
    parts = keep.split(s)  # text, kept code point, text, ...
    return "".join(p if i % 2 else unicodedata.normalize(form, p) for i, p in enumerate(parts))


# --------------------------------------------------------- pre-tokenizers


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's byte -> printable character map (ByteLevel)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


BYTE_CHAR = bytes_to_unicode()
CHAR_BYTE = {c: b for b, c in BYTE_CHAR.items()}

GPT2_PATTERN = (
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
)
# the Rust regex crate's \w (Whitespace pre-tokenizer): Alphabetic, marks,
# decimal digits, connector punctuation and Join_Control. Alphabetic is the
# letters, Nl and Other_Alphabetic, which is marks but for the circled,
# squared and negative squared Latin letters (category So) added here.
_RUST_WORD = ("L", "M", "Nd", "Nl", "Pc")
_RUST_WORD_EXTRA = "".join(
    f"{_esc(a)}-{_esc(b)}" for a, b in
    ((0x200C, 0x200D), (0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169), (0x1F170, 0x1F189)))


def _byte_level_map(s: str) -> str:
    return "".join(BYTE_CHAR[b] for b in s.encode("utf-8"))


def _pre_tokenizer(d: Optional[dict]) -> Callable[[list[Piece]], list[Piece]]:
    if d is None:
        return lambda pieces: [p for p in pieces if p[0]]
    t = d.get("type")

    def per_piece(f: Callable[[Piece], list[Piece]]):
        # an empty piece stays empty: nothing is prepended to it
        return lambda pieces: [q for p in pieces if p[0] for q in f(p)]

    if t == "Sequence":
        steps = [_pre_tokenizer(x) for x in d["pretokenizers"]]

        def seq(pieces: list[Piece]) -> list[Piece]:
            for f in steps:
                pieces = f(pieces)
            return pieces
        return seq
    if t == "Split":
        rx, behavior, invert = _compile(d["pattern"]), d["behavior"], d.get("invert", False)

        def split(p: Piece) -> list[Piece]:
            spans = _regex_spans(rx, p[0])
            if invert:
                spans = [(a, e, not m) for a, e, m in spans]
            return _split(p, spans, behavior)
        return per_piece(split)
    if t == "ByteLevel":
        prefix, use_regex = d.get("add_prefix_space", True), d.get("use_regex", True)
        rx = re.compile(onig_to_re(GPT2_PATTERN))

        def byte_level(p: Piece) -> list[Piece]:
            s, at0 = p
            if prefix and not s.startswith(" "):
                s = " " + s
            parts = _split((s, at0), _regex_spans(rx, s), "isolated") if use_regex else [(s, at0)]
            return [(_byte_level_map(q), a) for q, a in parts]
        return per_piece(byte_level)
    if t == "Metaspace":
        rep = d.get("replacement", "▁")
        scheme = d.get("prepend_scheme")
        if scheme is None:  # files written before prepend_scheme existed
            scheme = "always" if d.get("add_prefix_space", True) else "never"
        do_split = d.get("split", True)

        def metaspace(p: Piece) -> list[Piece]:
            s, at0 = p
            s = s.replace(" ", rep)
            if not s.startswith(rep) and (scheme == "always" or (scheme == "first" and at0)):
                s = rep + s
            if not do_split:
                return [(s, at0)]
            return _split((s, at0), _char_spans(lambda ch: ch == rep, s), "merged_with_next")
        return per_piece(metaspace)
    if t == "Whitespace":
        word = class_body(_RUST_WORD) + _RUST_WORD_EXTRA
        rx = re.compile(f"[{word}]+|[^{word}{_WS_BODY}]+")
        return per_piece(lambda p: _split(
            p, [(a, e, not m) for a, e, m in _regex_spans(rx, p[0])], "removed"))
    if t == "WhitespaceSplit":
        return per_piece(lambda p: _split(p, _char_spans(_WS.__contains__, p[0]), "removed"))
    if t == "Digits":
        behavior = "isolated" if d.get("individual_digits", False) else "contiguous"

        def numeric(ch: str) -> bool:
            return unicodedata.category(ch) in ("Nd", "Nl", "No")
        return per_piece(lambda p: _split(p, _char_spans(numeric, p[0]), behavior))
    raise ValueError(f"tokenizer.json: unsupported pre_tokenizer type {t!r}")


# ----------------------------------------------------------------- models


class BPEModel:
    """Byte-pair encoding by merge rank (the ``tokenizers`` BPE model)."""

    CACHE_WORDS = 10000

    def __init__(self, d: dict) -> None:
        if d.get("dropout") not in (None, 0, 0.0):
            raise ValueError("tokenizer.json: BPE dropout is not supported")
        self.vocab: dict[str, int] = dict(d["vocab"])
        self.unk = d.get("unk_token")
        self.prefix = d.get("continuing_subword_prefix") or ""
        self.suffix = d.get("end_of_word_suffix") or ""
        self.fuse_unk = bool(d.get("fuse_unk", False))
        self.byte_fallback = bool(d.get("byte_fallback", False))
        self.ignore_merges = bool(d.get("ignore_merges", False))
        # (left id, right id) -> (rank, merged id)
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, m in enumerate(d.get("merges", [])):
            if isinstance(m, str):
                parts = m.split(" ")
                if len(parts) != 2:
                    raise ValueError(f"tokenizer.json: bad merge {m!r}")
                a, b = parts
            else:
                a, b = m
            merged = a + b[len(self.prefix):]
            try:
                self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[merged])
            except KeyError as e:
                raise ValueError(f"tokenizer.json: merge {a!r} {b!r} names a token not in the vocab: {e}") from None
        self._cache: dict[str, list[int]] = {}

    def tokenize(self, word: str) -> list[int]:
        if not word:
            return []
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        hit = self._cache.get(word)
        if hit is None:
            hit = self._merge_word(word)
            if len(self._cache) < self.CACHE_WORDS:
                self._cache[word] = hit
        return hit

    def _unk_id(self) -> int:
        try:
            return self.vocab[self.unk]
        except KeyError:
            raise ValueError(f"tokenizer.json: unk_token {self.unk!r} is not in the vocab") from None

    def _merge_word(self, w: str) -> list[int]:
        syms: list[int] = []
        unk_pending = False
        last = len(w) - 1
        for i, ch in enumerate(w):
            s = (self.prefix if i else "") + ch + (self.suffix if i == last else "")
            tid = self.vocab.get(s)
            if tid is not None:
                if unk_pending:
                    syms.append(self._unk_id())
                    unk_pending = False
                syms.append(tid)
                continue
            if self.byte_fallback:
                ids = [self.vocab.get(f"<0x{b:02X}>") for b in s.encode("utf-8")]
                if all(x is not None for x in ids):
                    syms.extend(ids)  # type: ignore[arg-type]
                    continue
            if self.unk is not None:
                if unk_pending and not self.fuse_unk:
                    syms.append(self._unk_id())
                unk_pending = True
        if unk_pending:
            syms.append(self._unk_id())
        return self._merge_all(syms)

    def _merge_all(self, syms: list[int]) -> list[int]:
        n = len(syms)
        if n < 2:
            return syms
        nxt = list(range(1, n + 1))
        prv = list(range(-1, n - 1))
        alive = [True] * n
        merges = self.merges
        heap = []
        for i in range(n - 1):
            m = merges.get((syms[i], syms[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _rank, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] >= n:
                continue
            right = nxt[pos]
            m = merges.get((syms[pos], syms[right]))
            if m is None or m[1] != new_id:
                continue  # an expired entry
            syms[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] < n:
                prv[nxt[pos]] = pos
            p = prv[pos]
            if p >= 0:
                m = merges.get((syms[p], new_id))
                if m is not None:
                    heapq.heappush(heap, (m[0], p, m[1]))
            if nxt[pos] < n:
                m = merges.get((new_id, syms[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [s for s, a in zip(syms, alive) if a]


class WordLevelModel:
    def __init__(self, d: dict) -> None:
        self.vocab: dict[str, int] = dict(d["vocab"])
        self.unk = d.get("unk_token")

    def tokenize(self, word: str) -> list[int]:
        tid = self.vocab.get(word)
        if tid is None:
            if self.unk is None or self.unk not in self.vocab:
                raise ValueError(f"WordLevel: {word!r} is not in the vocab and there is no unk_token")
            tid = self.vocab[self.unk]
        return [tid]


def _model(d: dict):
    t = d.get("type")
    if t is None and "merges" in d:
        t = "BPE"  # the type field is optional for BPE in older files
    if t == "BPE":
        return BPEModel(d)
    if t == "WordLevel":
        return WordLevelModel(d)
    raise ValueError(f"tokenizer.json: unsupported model type {t!r}")


# -------------------------------------------------------- post-processors


# (id, token string) pairs, the string as the Encoding shows it
Tokens = list[tuple[int, str]]


def _post_processor(d: Optional[dict]) -> Callable[[Tokens, bool], Tokens]:
    if d is None:
        return lambda toks, add: toks
    t = d.get("type")
    if t == "ByteLevel":  # changes offsets only
        return lambda toks, add: toks
    if t == "Sequence":
        steps = [_post_processor(x) for x in d["processors"]]

        def seq(toks: Tokens, add: bool) -> Tokens:
            for f in steps:
                toks = f(toks, add)
            return toks
        return seq
    if t == "TemplateProcessing":
        specials = d.get("special_tokens", {})
        template: list[Optional[Tokens]] = []
        for item in d["single"]:
            if "SpecialToken" in item:
                sp = specials[item["SpecialToken"]["id"]]
                template.append(list(zip(sp["ids"], sp["tokens"])))
            elif "Sequence" in item:
                template.append(None)
            else:
                raise ValueError(f"tokenizer.json: bad template piece {item!r}")

        def templ(toks: Tokens, add: bool) -> Tokens:
            if not add:
                return toks
            return [x for part in template for x in (toks if part is None else part)]
        return templ
    raise ValueError(f"tokenizer.json: unsupported post_processor type {t!r}")


# --------------------------------------------------------------- decoders


def _flush_bytes(buf: bytearray, out: list[str]) -> None:
    if buf:
        try:
            out.append(buf.decode("utf-8"))
        except UnicodeDecodeError:
            out.extend("�" for _ in buf)
        buf.clear()


def _decoder(d: Optional[dict]) -> Optional[Callable[[list[str]], list[str]]]:
    """A decode_chain: token strings in, strings out (joined at the end)."""
    if d is None:
        return None
    t = d.get("type")
    if t == "Sequence":
        steps = [_decoder(x) for x in d["decoders"]]

        def seq(tokens: list[str]) -> list[str]:
            for f in steps:
                tokens = f(tokens)
            return tokens
        return seq
    if t == "ByteLevel":
        def byte_level(tokens: list[str]) -> list[str]:
            buf = bytearray()
            for tok in tokens:
                bs = [CHAR_BYTE.get(c) for c in tok]
                buf.extend(tok.encode("utf-8") if None in bs else bytes(bs))
            return [buf.decode("utf-8", errors="replace")]
        return byte_level
    if t == "Metaspace":
        rep = d.get("replacement", "▁")
        scheme = d.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if d.get("add_prefix_space", True) else "never"

        def metaspace(tokens: list[str]) -> list[str]:
            # every replacement char of the first token is dropped, as the
            # Rust decoder does, unless the scheme is "never"
            return [
                tok.replace(rep, "" if i == 0 and scheme != "never" else " ")
                for i, tok in enumerate(tokens)
            ]
        return metaspace
    if t == "ByteFallback":
        def byte_fallback(tokens: list[str]) -> list[str]:
            out: list[str] = []
            buf = bytearray()
            for tok in tokens:
                if len(tok) == 6 and tok.startswith("<0x") and tok.endswith(">"):
                    try:
                        buf.append(int(tok[3:5], 16))
                        continue
                    except ValueError:
                        pass
                _flush_bytes(buf, out)
                out.append(tok)
            _flush_bytes(buf, out)
            return out
        return byte_fallback
    if t == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if t == "Strip":
        content, start, stop = d["content"], d.get("start", 0), d.get("stop", 0)

        def strip(tokens: list[str]) -> list[str]:
            out = []
            for tok in tokens:
                a = 0
                while a < min(start, len(tok)) and tok[a] == content:
                    a += 1
                b = len(tok)
                while len(tok) - b < stop and b > a and tok[b - 1] == content:
                    b -= 1
                out.append(tok[a:b])
            return out
        return strip
    if t == "Replace":
        rx, content = _compile(d["pattern"]), d["content"]
        return lambda tokens: [rx.sub(lambda _m: content, tok) for tok in tokens]
    raise ValueError(f"tokenizer.json: unsupported decoder type {t!r}")


# -------------------------------------------------------------- tokenizer


@dataclass
class JsonEncoding:
    ids: list[int]
    tokens: list[str]


@dataclass(frozen=True)
class AddedToken:
    id: int
    content: str
    single_word: bool = False
    lstrip: bool = False
    rstrip: bool = False
    normalized: bool = True
    special: bool = False


def _find_added(text: str, rx: Optional["re.Pattern[str]"], by_content: dict[str, AddedToken]
                ) -> list[tuple[str, Optional[int]]]:
    """Split ``text`` around added-token matches (leftmost-longest), with
    single_word / lstrip / rstrip, as ``AddedVocabulary::find_matches``."""
    if rx is None or not text:
        return [(text, None)]
    out: list[tuple[str, Optional[int]]] = []
    last = 0
    for m in rx.finditer(text):
        start, stop = m.span()
        tok = by_content[m.group(0)]
        if tok.single_word:
            before = start > 0 and text[start - 1].isalnum()
            after = stop < len(text) and text[stop].isalnum()
            if before or after:
                continue
        if tok.lstrip:
            s = start
            while s > 0 and text[s - 1] in _WS:
                s -= 1
            start = max(s, last)
        if tok.rstrip:
            while stop < len(text) and text[stop] in _WS:
                stop += 1
        if last < start:
            out.append((text[last:start], None))
        out.append((text[start:stop], tok.id))
        last = stop
    if last != len(text):
        out.append((text[last:], None))
    return out


def _alternation(contents: Sequence[str]) -> Optional["re.Pattern[str]"]:
    if not contents:
        return None
    ordered = sorted(set(contents), key=len, reverse=True)  # longest first
    return re.compile("|".join(re.escape(c) for c in ordered))


class JsonTokenizer:
    """Encode / decode with a parsed ``tokenizer.json`` (see the module
    docstring). The surface is the one TokenizerWrapper needs: ``encode``,
    ``decode``, ``token_to_id``, ``get_vocab_size``, ``to_str``."""

    def __init__(self, data: str) -> None:
        self._json = data
        d = json.loads(data)
        if d.get("truncation") or d.get("padding"):
            raise ValueError("tokenizer.json: truncation / padding are not supported")
        self.model = _model(d["model"])
        self.normalize = _normalizer(d.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(d.get("pre_tokenizer"))
        self.post_process = _post_processor(d.get("post_processor"))
        self.decode_chain = _decoder(d.get("decoder"))
        self.added = [
            AddedToken(
                id=int(t["id"]), content=t["content"],
                single_word=bool(t.get("single_word", False)),
                lstrip=bool(t.get("lstrip", False)), rstrip=bool(t.get("rstrip", False)),
                normalized=bool(t.get("normalized", not t.get("special", False))),
                special=bool(t.get("special", False)),
            )
            for t in d.get("added_tokens", [])
        ]
        self._added_by_id = {t.id: t for t in self.added}
        self._added_by_content = {t.content: t for t in self.added}
        self._special = {t.content for t in self.added if t.special}
        raw = [t for t in self.added if not t.normalized]
        norm = [t for t in self.added if t.normalized]
        self._raw_rx = _alternation([t.content for t in raw])
        self._raw_by = {t.content: t for t in raw}
        # normalized added tokens are matched in their normalized form
        self._norm_by = {self.normalize(t.content): t for t in norm}
        self._norm_rx = _alternation(list(self._norm_by))
        self._id_to_token = {i: s for s, i in self.model.vocab.items()}
        for t in self.added:
            self._id_to_token[t.id] = t.content

    @classmethod
    def from_file(cls, path: str) -> "JsonTokenizer":
        with open(path, encoding="utf-8") as f:
            return cls(f.read())

    # ------------------------------------------------------------ encode

    def encode(self, text: str, add_special_tokens: bool = True) -> JsonEncoding:
        # an added token shows the text it matched (with any whitespace
        # its lstrip / rstrip took), as the library's Encoding does
        toks: Tokens = []
        offset = 0
        for seg, tid in _find_added(text, self._raw_rx, self._raw_by):
            seg_at0 = offset == 0
            offset += len(seg)
            if tid is not None:
                toks.append((tid, seg))
                continue
            first = True
            for part, ptid in _find_added(self.normalize(seg), self._norm_rx, self._norm_by):
                at0 = seg_at0 and first
                first = False
                if ptid is not None:
                    toks.append((ptid, part))
                    continue
                for word, _ in self.pre_tokenize([(part, at0)]):
                    toks.extend((i, self._id_to_token[i]) for i in self.model.tokenize(word))
        toks = self.post_process(toks, add_special_tokens)
        return JsonEncoding(ids=[i for i, _ in toks], tokens=[t for _, t in toks])

    # ------------------------------------------------------------ decode

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        tokens = []
        for i in ids:
            tok = self._id_to_token.get(int(i))
            if tok is None or (skip_special_tokens and tok in self._special):
                continue
            tokens.append(tok)
        if self.decode_chain is None:
            return " ".join(tokens)
        return "".join(self.decode_chain(tokens))

    # ---------------------------------------------------------- vocab

    def token_to_id(self, token: str) -> Optional[int]:
        t = self._added_by_content.get(token)
        if t is not None:
            return t.id
        return self.model.vocab.get(token)

    def get_vocab_size(self) -> int:
        return len(self._id_to_token)

    def to_str(self) -> str:
        return self._json
