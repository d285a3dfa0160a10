"""GGUF model file reader (pure numpy + mmap) and its mapping onto the
port's Llama parameters.

The port's own copy of dynamo_tpu/gguf.py (the role of the reference's
lib/llm/src/gguf/, so that ``--model-path model.gguf`` serves end to end):

  * the full metadata section (every GGUF value type, nested arrays too);
  * the tensor directory (name, shape, dtype, offset) with lazy mmap views;
  * F32 / F16 natively and BF16 widened to f32 (exactly; the port does not
    depend on ``ml_dtypes``); Q4_0 / Q4_1 / Q5_0 / Q5_1 / Q8_0 and the
    K-quants Q4_K / Q5_K / Q6_K (what published GGUFs such as Q4_K_M hold)
    by vectorized numpy dequantization, the reference's own functions;
  * ``config_from_gguf`` mapping the ``llama.*`` metadata onto the port's
    ``LlamaConfig``, ``tokenizer_from_gguf`` the embedded SentencePiece
    vocabulary onto the port's ``sp_tokenizer`` / ``TokenizerWrapper``, and
    ``params_from_gguf`` the ggml tensor names (token_embd, blk.N.*,
    output, ...) onto the port's parameter dict, transposed to [in, out].

``params_from_gguf`` does the reference's numpy arithmetic (the Gemma
``1 + w`` norms in the tensor's own dtype), then widens to f32 and rounds to
the target dtype with torch (round to nearest even, as ``ml_dtypes`` does),
so a file's bf16 weights equal the reference's bit for bit. This module
imports torch only inside ``params_from_gguf``.

Spec: https://github.com/ggml-org/ggml/blob/master/docs/gguf.md (public).
"""

from __future__ import annotations

import mmap
import struct
from dataclasses import dataclass
from typing import Any, BinaryIO, Optional

import numpy as np

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian

# metadata value types
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32 = 0, 1, 2, 3, 4, 5
_T_F32, _T_BOOL, _T_STRING, _T_ARRAY, _T_U64, _T_I64, _T_F64 = (
    6, 7, 8, 9, 10, 11, 12,
)

_SCALAR_FMT = {
    _T_U8: "<B", _T_I8: "<b", _T_U16: "<H", _T_I16: "<h",
    _T_U32: "<I", _T_I32: "<i", _T_F32: "<f", _T_U64: "<Q",
    _T_I64: "<q", _T_F64: "<d",
}

# ggml tensor dtypes (subset)
GGML_F32, GGML_F16, GGML_BF16 = 0, 1, 30
GGML_Q4_0, GGML_Q4_1, GGML_Q5_0, GGML_Q5_1, GGML_Q8_0 = 2, 3, 6, 7, 8
GGML_Q4_K, GGML_Q5_K, GGML_Q6_K = 12, 13, 14
_GGML_NAMES = {GGML_F32: "F32", GGML_F16: "F16", GGML_BF16: "BF16",
               GGML_Q4_0: "Q4_0", GGML_Q4_1: "Q4_1", GGML_Q5_0: "Q5_0",
               GGML_Q5_1: "Q5_1", GGML_Q8_0: "Q8_0", GGML_Q4_K: "Q4_K",
               GGML_Q5_K: "Q5_K", GGML_Q6_K: "Q6_K"}

QK_K = 256  # K-quant super-block size

# bytes per block, elements per block — for tensor size validation
GGML_BLOCK = {
    GGML_Q4_0: (18, 32), GGML_Q4_1: (20, 32), GGML_Q5_0: (22, 32),
    GGML_Q5_1: (24, 32), GGML_Q8_0: (34, 32),
    GGML_Q4_K: (144, QK_K), GGML_Q5_K: (176, QK_K), GGML_Q6_K: (210, QK_K),
}


@dataclass
class GgufTensor:
    name: str
    shape: tuple[int, ...]  # logical (numpy, row-major) shape
    ggml_type: int
    offset: int  # relative to the data section

    @property
    def type_name(self) -> str:
        return _GGML_NAMES.get(self.ggml_type, f"unknown({self.ggml_type})")


def _read(f: BinaryIO, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))[0]


def _read_string(f: BinaryIO) -> str:
    n = _read(f, "<Q")
    return f.read(n).decode("utf-8", errors="replace")


def _read_value(f: BinaryIO, vtype: int) -> Any:
    if vtype == _T_STRING:
        return _read_string(f)
    if vtype == _T_BOOL:
        return bool(_read(f, "<B"))
    if vtype == _T_ARRAY:
        etype = _read(f, "<I")
        n = _read(f, "<Q")
        return [_read_value(f, etype) for _ in range(n)]
    fmt = _SCALAR_FMT.get(vtype)
    if fmt is None:
        raise ValueError(f"unknown gguf value type {vtype}")
    return _read(f, fmt)


class GgufFile:
    """Parsed GGUF container with lazy tensor access."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.metadata: dict[str, Any] = {}
        self.tensors: dict[str, GgufTensor] = {}
        with open(path, "rb") as f:
            magic = _read(f, "<I")
            if magic != GGUF_MAGIC:
                raise ValueError(f"{path}: not a GGUF file (magic {magic:#x})")
            self.version = _read(f, "<I")
            if self.version < 2:
                raise ValueError(f"gguf v{self.version} unsupported (need >=2)")
            n_tensors = _read(f, "<Q")
            n_kv = _read(f, "<Q")
            for _ in range(n_kv):
                key = _read_string(f)
                vtype = _read(f, "<I")
                self.metadata[key] = _read_value(f, vtype)
            for _ in range(n_tensors):
                name = _read_string(f)
                ndim = _read(f, "<I")
                dims = [
                    _read(f, "<Q") for _ in range(ndim)
                ]  # ggml order: fastest-varying first
                ggml_type = _read(f, "<I")
                offset = _read(f, "<Q")
                self.tensors[name] = GgufTensor(
                    name=name,
                    shape=tuple(reversed(dims)),  # numpy row-major
                    ggml_type=ggml_type,
                    offset=offset,
                )
            align = int(self.metadata.get("general.alignment", 32))
            pos = f.tell()
            self.data_offset = (pos + align - 1) // align * align
        self._mm: Optional[mmap.mmap] = None
        self._file: Optional[BinaryIO] = None

    # ---------------------------------------------------------- tensors

    def _map(self) -> mmap.mmap:
        if self._mm is None:
            self._file = open(self.path, "rb")
            self._mm = mmap.mmap(
                self._file.fileno(), 0, access=mmap.ACCESS_READ
            )
        return self._mm

    def tensor(self, name: str) -> np.ndarray:
        """Materialize one tensor as numpy (dequantized if needed; BF16
        widened to f32, exactly)."""
        t = self.tensors[name]
        mm = self._map()
        start = self.data_offset + t.offset
        numel = int(np.prod(t.shape))
        if t.ggml_type == GGML_F32:
            raw = np.frombuffer(mm, np.float32, numel, start)
            return raw.reshape(t.shape)
        if t.ggml_type == GGML_F16:
            raw = np.frombuffer(mm, np.float16, numel, start)
            return raw.reshape(t.shape)
        if t.ggml_type == GGML_BF16:
            raw = np.frombuffer(mm, np.uint16, numel, start)
            return (raw.astype(np.uint32) << 16).view(np.float32).reshape(t.shape)
        deq = _DEQUANT.get(t.ggml_type)
        if deq is not None:
            _, elems = GGML_BLOCK[t.ggml_type]
            # ggml blocks never span rows: the fastest-varying dim must be
            # block-aligned, not just the total element count.
            if t.shape and t.shape[-1] % elems:
                raise ValueError(
                    f"tensor {name}: row length {t.shape[-1]} not divisible "
                    f"by {t.type_name} block size {elems}"
                )
            vals = deq(mm, numel // elems, start)
            return vals.reshape(t.shape).astype(np.float32, copy=False)
        raise NotImplementedError(
            f"tensor {name}: ggml type {t.type_name} not supported"
        )

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        if self._file is not None:
            self._file.close()
            self._file = None


# ---------------------------------------------------- block dequantization
#
# Vectorized numpy ports of the ggml block formats (spec: ggml quants.c,
# reference reader: lib/llm/src/gguf/).  Every function takes the mmap, a
# block count, and a byte offset and returns float32 [n_blocks, elems].

def _deq_q4_0(mm, n, start):
    rec = np.dtype([("d", "<f2"), ("qs", "u1", (16,))])
    raw = np.frombuffer(mm, rec, n, start)
    d = raw["d"].astype(np.float32)[:, None]
    lo = (raw["qs"] & 0x0F).astype(np.int8) - 8
    hi = (raw["qs"] >> 4).astype(np.int8) - 8
    return d * np.concatenate([lo, hi], axis=1).astype(np.float32)


def _deq_q4_1(mm, n, start):
    rec = np.dtype([("d", "<f2"), ("m", "<f2"), ("qs", "u1", (16,))])
    raw = np.frombuffer(mm, rec, n, start)
    d = raw["d"].astype(np.float32)[:, None]
    m = raw["m"].astype(np.float32)[:, None]
    q = np.concatenate([raw["qs"] & 0x0F, raw["qs"] >> 4], axis=1)
    return d * q.astype(np.float32) + m


def _deq_q5_0(mm, n, start):
    rec = np.dtype([("d", "<f2"), ("qh", "<u4"), ("qs", "u1", (16,))])
    raw = np.frombuffer(mm, rec, n, start)
    d = raw["d"].astype(np.float32)[:, None]
    j = np.arange(16)
    xh0 = ((raw["qh"][:, None] >> j) << 4) & 0x10
    xh1 = (raw["qh"][:, None] >> (j + 12)) & 0x10
    lo = ((raw["qs"] & 0x0F) | xh0).astype(np.int16) - 16
    hi = ((raw["qs"] >> 4) | xh1).astype(np.int16) - 16
    return d * np.concatenate([lo, hi], axis=1).astype(np.float32)


def _deq_q5_1(mm, n, start):
    rec = np.dtype(
        [("d", "<f2"), ("m", "<f2"), ("qh", "<u4"), ("qs", "u1", (16,))]
    )
    raw = np.frombuffer(mm, rec, n, start)
    d = raw["d"].astype(np.float32)[:, None]
    m = raw["m"].astype(np.float32)[:, None]
    j = np.arange(16)
    xh0 = ((raw["qh"][:, None] >> j) << 4) & 0x10
    xh1 = (raw["qh"][:, None] >> (j + 12)) & 0x10
    lo = (raw["qs"] & 0x0F) | xh0
    hi = (raw["qs"] >> 4) | xh1
    return d * np.concatenate([lo, hi], axis=1).astype(np.float32) + m


def _deq_q8_0(mm, n, start):
    rec = np.dtype([("d", "<f2"), ("q", "i1", (32,))])
    raw = np.frombuffer(mm, rec, n, start)
    return raw["q"].astype(np.float32) * raw["d"].astype(np.float32)[:, None]


def _unpack_scale_min_k4(s):
    """6-bit packed (scale, min) pairs for 8 sub-blocks; s is [n, 12] u8."""
    sc = np.empty(s.shape[:-1] + (8,), np.uint8)
    mn = np.empty_like(sc)
    sc[:, :4] = s[:, :4] & 63
    mn[:, :4] = s[:, 4:8] & 63
    sc[:, 4:] = (s[:, 8:12] & 0x0F) | ((s[:, 0:4] >> 6) << 4)
    mn[:, 4:] = (s[:, 8:12] >> 4) | ((s[:, 4:8] >> 6) << 4)
    return sc.astype(np.float32), mn.astype(np.float32)


def _deq_q4_k(mm, n, start):
    rec = np.dtype([("d", "<f2"), ("dmin", "<f2"),
                    ("scales", "u1", (12,)), ("qs", "u1", (128,))])
    raw = np.frombuffer(mm, rec, n, start)
    d = raw["d"].astype(np.float32)
    dmin = raw["dmin"].astype(np.float32)
    sc, mn = _unpack_scale_min_k4(raw["scales"])
    qs = raw["qs"].reshape(n, 4, 32)
    # chunk j yields sub-blocks 2j (low nibbles) then 2j+1 (high nibbles)
    q = np.stack([qs & 0x0F, qs >> 4], axis=2).reshape(n, 8, 32)
    vals = (d[:, None, None] * sc[:, :, None] * q.astype(np.float32)
            - dmin[:, None, None] * mn[:, :, None])
    return vals.reshape(n, QK_K)


def _deq_q5_k(mm, n, start):
    rec = np.dtype([("d", "<f2"), ("dmin", "<f2"), ("scales", "u1", (12,)),
                    ("qh", "u1", (32,)), ("qs", "u1", (128,))])
    raw = np.frombuffer(mm, rec, n, start)
    d = raw["d"].astype(np.float32)
    dmin = raw["dmin"].astype(np.float32)
    sc, mn = _unpack_scale_min_k4(raw["scales"])
    qs = raw["qs"].reshape(n, 4, 32)
    qh = raw["qh"][:, None, :]
    jj = np.arange(4)[None, :, None]
    # 5th bit of sub-block 2j lives at qh bit 2j, of 2j+1 at bit 2j+1
    lo = (qs & 0x0F) + (((qh >> (2 * jj)) & 1) << 4)
    hi = (qs >> 4) + (((qh >> (2 * jj + 1)) & 1) << 4)
    q = np.stack([lo, hi], axis=2).reshape(n, 8, 32)
    vals = (d[:, None, None] * sc[:, :, None] * q.astype(np.float32)
            - dmin[:, None, None] * mn[:, :, None])
    return vals.reshape(n, QK_K)


def _deq_q6_k(mm, n, start):
    rec = np.dtype([("ql", "u1", (128,)), ("qh", "u1", (64,)),
                    ("scales", "i1", (16,)), ("d", "<f2")])
    raw = np.frombuffer(mm, rec, n, start)
    d = raw["d"].astype(np.float32)
    ql = raw["ql"].reshape(n, 2, 2, 32)   # [n, half, lo32/hi32-bytes, 32]
    qh = raw["qh"].reshape(n, 2, 32)
    sc = raw["scales"].reshape(n, 2, 8).astype(np.float32)
    ql_a, ql_b = ql[:, :, 0], ql[:, :, 1]
    q = np.stack([
        (ql_a & 0x0F) | (((qh >> 0) & 3) << 4),
        (ql_b & 0x0F) | (((qh >> 2) & 3) << 4),
        (ql_a >> 4) | (((qh >> 4) & 3) << 4),
        (ql_b >> 4) | (((qh >> 6) & 3) << 4),
    ], axis=2).astype(np.int16) - 32        # [n, 2, 4, 32]
    # output y[l + 32k] scales with scales[l//16 + 2k] within each half
    sidx = (np.arange(32) // 16)[None, :] + 2 * np.arange(4)[:, None]
    vals = d[:, None, None, None] * sc[:, :, sidx] * q.astype(np.float32)
    return vals.reshape(n, QK_K)


_DEQUANT = {
    GGML_Q4_0: _deq_q4_0, GGML_Q4_1: _deq_q4_1, GGML_Q5_0: _deq_q5_0,
    GGML_Q5_1: _deq_q5_1, GGML_Q8_0: _deq_q8_0, GGML_Q4_K: _deq_q4_k,
    GGML_Q5_K: _deq_q5_k, GGML_Q6_K: _deq_q6_k,
}


# ------------------------------------------------------- embedded tokenizer


def tokenizer_from_gguf(g: GgufFile):
    """TokenizerWrapper from the file's own tokenizer.ggml.* metadata.

    Real published GGUFs embed their tokenizer (reference:
    lib/llm/src/gguf/gguf_tokenizer.rs convert_gguf_to_hf_tokenizer); the
    llama-family model ("llama"/"replit": SentencePiece pieces + scores)
    maps 1:1 onto our native SP engine — GGUF token_type uses the same
    enum as SentencePiece piece types (1 normal, 2 unknown, 3 control,
    6 byte). Returns None when the metadata carries no tokenizer; raises
    for tokenizer models we don't support (gpt2 byte-BPE needs merges —
    ship a tokenizer.json next to the file for those)."""
    md = g.metadata
    tokens = md.get("tokenizer.ggml.tokens")
    if not tokens:
        return None
    model_name = md.get("tokenizer.ggml.model", "llama")
    if model_name not in ("llama", "replit"):
        raise NotImplementedError(
            f"GGUF tokenizer model {model_name!r} unsupported — place a "
            "tokenizer.json next to the .gguf file"
        )
    from dynamo_tpu_torch.sp_tokenizer import (
        SpModel,
        SpPiece,
        serialize_model_proto,
    )
    from dynamo_tpu_torch.tokenizer import TokenizerWrapper

    scores = md.get("tokenizer.ggml.scores") or [0.0] * len(tokens)
    types = md.get("tokenizer.ggml.token_type") or [1] * len(tokens)
    if len(scores) != len(tokens) or len(types) != len(tokens):
        # zip() would silently truncate the vocab; corrupt files must fail
        raise ValueError(
            f"corrupt GGUF tokenizer metadata: {len(tokens)} tokens vs "
            f"{len(scores)} scores / {len(types)} token types"
        )
    model = SpModel(
        pieces=[
            SpPiece(t, float(s), int(ty))
            for t, s, ty in zip(tokens, scores, types)
        ],
        model_type=1,  # SP scores -> unigram Viterbi (llama.cpp SPM)
        # llama-family SPM semantics: identity normalizer, whitespace kept
        # verbatim (newlines ride byte-fallback pieces — folding them to
        # spaces would tokenize differently than llama.cpp does)
        normalizer_name="identity",
        remove_extra_whitespaces=False,
        unk_id=int(md.get("tokenizer.ggml.unknown_token_id", 0)),
        bos_id=int(md.get("tokenizer.ggml.bos_token_id", 1)),
        eos_id=int(md.get("tokenizer.ggml.eos_token_id", 2)),
        add_dummy_prefix=bool(md.get("tokenizer.ggml.add_space_prefix", True)),
    )
    # round-trip through the canonical byte form so the tokenizer a worker
    # serves is BY CONSTRUCTION the one the model card publishes
    return TokenizerWrapper.from_sp_bytes(serialize_model_proto(model))


# --------------------------------------------------------------- mapping


def config_from_gguf(g: GgufFile):
    """llama.* metadata -> the port's LlamaConfig."""
    from dynamo_tpu_torch.models.llama import LlamaConfig

    md = g.metadata
    arch = md.get("general.architecture", "llama")

    def key(suffix, default=None):
        return md.get(f"{arch}.{suffix}", default)

    n_heads = int(key("attention.head_count", 32))
    hidden = int(key("embedding_length", 4096))
    n_vocab = md.get(f"{arch}.vocab_size") or (
        len(md.get("tokenizer.ggml.tokens", [])) or 32000
    )
    if arch.startswith("gemma") and arch not in ("gemma", "gemma2", "gemma3"):
        # gemma3n etc.: architectures we haven't mapped — refuse rather
        # than load as a silently-wrong plain llama
        raise NotImplementedError(
            f"GGUF architecture {arch!r} not supported"
        )
    gemma_like = arch.startswith("gemma")
    num_layers = int(key("block_count", 32))
    sliding = key("attention.sliding_window")
    layer_pattern = None
    if arch == "gemma2" and sliding:
        layer_pattern = tuple(i % 2 == 0 for i in range(num_layers))
    elif arch == "gemma3" and sliding:
        layer_pattern = tuple((i + 1) % 6 != 0 for i in range(num_layers))
    return LlamaConfig(
        attn_bias=arch.startswith("qwen2"),
        mlp_act="gelu_tanh" if gemma_like else "silu",
        embed_scale=gemma_like,
        norm_plus_one=gemma_like,
        tie_word_embeddings=gemma_like,
        vocab_size=int(n_vocab),
        hidden_size=hidden,
        intermediate_size=int(key("feed_forward_length", 4 * hidden)),
        num_layers=num_layers,
        num_heads=n_heads,
        num_kv_heads=int(key("attention.head_count_kv", n_heads)),
        head_dim=int(key("attention.key_length", hidden // n_heads)),
        rope_theta=float(key("rope.freq_base", 10000.0)),
        rms_eps=float(key("attention.layer_norm_rms_epsilon", 1e-5)),
        max_position_embeddings=int(key("context_length", 8192)),
        sliding_window=int(sliding) if sliding else None,
        layer_pattern=layer_pattern,
        attn_logit_softcap=(
            float(key("attn_logit_softcapping", 50.0))
            if arch == "gemma2" else None
        ),
        final_logit_softcap=(
            float(key("final_logit_softcapping", 30.0))
            if arch == "gemma2" else None
        ),
        query_pre_attn_scalar=(
            float(key("attention.query_pre_attn_scalar"))
            if key("attention.query_pre_attn_scalar") else None
        ),
        sandwich_norms=arch in ("gemma2", "gemma3"),
        qk_norm=arch == "gemma3",
        rope_local_theta=(
            float(key("rope.local_freq_base", 10000.0))
            if arch == "gemma3" else None
        ),
    )


# ggml name -> (our key, needs_transpose). Projection matrices are stored
# [out, in] in ggml; our einsums are x @ W with W [in, out].
_LAYER_MAP = {
    "attn_norm.weight": ("attn_norm", False),
    "attn_q.weight": ("wq", True),
    "attn_k.weight": ("wk", True),
    "attn_v.weight": ("wv", True),
    "attn_output.weight": ("wo", True),
    "ffn_norm.weight": ("mlp_norm", False),
    "ffn_gate.weight": ("wg", True),
    "ffn_up.weight": ("wu", True),
    "ffn_down.weight": ("wd", True),
}

# gemma2/3 extras (absent in llama-family files; loaded when present)
_OPTIONAL_LAYER_MAP = {
    "post_attention_norm.weight": ("post_attn_norm", False),
    "post_ffw_norm.weight": ("post_mlp_norm", False),
    "attn_q_norm.weight": ("q_norm", False),
    "attn_k_norm.weight": ("k_norm", False),
}


def params_from_gguf(g: GgufFile, cfg=None, dtype=None, device="cpu"):
    """The port's Llama parameter dict from a GGUF file: (cfg, params),
    weights ``[in, out]`` in ``dtype`` (default bf16) on ``device``."""
    import torch

    cfg = cfg or config_from_gguf(g)
    dtype = dtype or torch.bfloat16

    def get(name, transpose=False, plus_one=False):
        a = g.tensor(name)
        if transpose:
            a = a.T
        if plus_one and cfg.norm_plus_one:  # gemma (1+w) RMSNorm weights
            a = a + 1
        # a copy: a tensor must not hold the file's mmap open
        f32 = torch.from_numpy(np.array(a, np.float32))
        return f32.to(dtype).to(device)

    params: dict[str, Any] = {
        "embed": get("token_embd.weight"),
        "final_norm": get("output_norm.weight", plus_one=True),
        "layers": [],
    }
    if "output.weight" in g.tensors:
        params["lm_head"] = get("output.weight", transpose=True)
    for i in range(cfg.num_layers):
        layer = {}
        for suffix, (ours, tr) in _LAYER_MAP.items():
            layer[ours] = get(
                f"blk.{i}.{suffix}", transpose=tr,
                plus_one=ours in ("attn_norm", "mlp_norm"),
            )
        for suffix, (ours, tr) in _OPTIONAL_LAYER_MAP.items():
            if f"blk.{i}.{suffix}" in g.tensors:
                layer[ours] = get(
                    f"blk.{i}.{suffix}", transpose=tr, plus_one=True
                )
        # qwen2-family q/k/v biases, when the file ships them
        for suffix, ours in (
            ("attn_q.bias", "bq"), ("attn_k.bias", "bk"),
            ("attn_v.bias", "bv"),
        ):
            if f"blk.{i}.{suffix}" in g.tensors:
                layer[ours] = get(f"blk.{i}.{suffix}")
        params["layers"].append(layer)
    return cfg, params
