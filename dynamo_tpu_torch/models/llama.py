"""Llama-family model (Llama 2/3, Mistral-style windows, Qwen2 biases,
Gemma-style norms and soft-caps) as plain functions over a parameter dict and
a paged KV cache, in PyTorch.

Counterpart of dynamo_tpu/models/llama.py: ``LlamaConfig`` is the port's own
copy of the JAX package's config (with ``from_hf_dict``), and the forward
pass follows the JAX functions op for op (``_embed``, ``_rope_pair`` /
``_layer_freqs``, ``_attn_prefill``, ``_attn_decode``, ``_mlp``, ``_logits``,
``prefill`` (``_embed`` then ``_prefill_from_embeds``), the multimodal
``prefill_mm``, the cacheless ``embed_pooled``, ``prefill_chunk``,
``prefill_packed``, ``decode``, ``decode_verify``, and the fused decode heads
``_use_fused_decode`` / ``_fused_qkv_dispatch`` / ``_fused_out_dispatch``).
Parameters are a dict with the JAX layout --
weights ``[in, out]``, ``layers`` a list of per-layer dicts -- so a JAX
parameter tree converts leaf by leaf (engine/torch_engine/weights.py).

The cache is head-major ``[L, Hkv, num_blocks, block_size, D]``, or the
int8-resident ``{"q": int8 pages, "s": f32 [L, Hkv, num_blocks] scales}``
container of ops/kv_quant.py (each layer gets ``cache_layer``'s views of
it; the ops dispatch on its form). Unlike the JAX functions, which return
updated caches, the forward functions write the new K/V into the caches
they are given, IN PLACE, and return only the logits. Weights may be
int8-quantized (``{"q", "s"}`` leaves, ops/linear.py): the dense products
and the fused heads take either form. Attention and the fused decode heads run the hand-written CUDA
kernels for CUDA tensors and the plain versions for CPU tensors
(ops/attention.py, ops/linear.py). An MoE layer (a ``router`` beside
stacked expert weights ``wg`` / ``wu`` [E, D, F], ``wd`` [E, F, D]; the
Mixtral family, models/mixtral.py) routes its FFN through ops/moe.py: the
dropless grouped FFN by default, the GShard capacity path with
``moe_impl="gshard"``.

Tensor parallelism (dynamo_tpu/models/llama.py:397-520 under a mesh): every
entry point takes an optional ``group`` (parallel/mesh.TPGroup, the rank
grid; the model reads its ``tp`` line as the group, and its ``ep`` and
``sp`` lines where named below). Its parameters are then the rank's Megatron slice
(parallel/sharding.py) and its caches hold the rank's Hkv / tp kv heads;
each rank computes its Hq / tp query heads. The row-parallel products
(``wo``, ``wd``) are summed over the group in f32 right after the product,
before the int8 scale and the cast, where GSPMD puts the reference's
all-reduce (dynamo_tpu/ops/linear.py:65-70); the vocab-split logits are
all-gathered before sampling. Fused decode under a group runs the meshed
heads of ops/collective.py, and with ``collective_overlap`` the ring tail,
gated as the reference gates them (``_use_fused_decode`` /
``_use_overlap_tail``). On a grid with an ``ep`` axis an MoE layer takes
the expert-parallel forms (``_mlp``, the reference's dispatch rule), and
``prefill_context_parallel`` (:760 upstream) runs a prompt's chunks over
the ``sp`` axis with ring attention.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.ops.attention import (
    causal_prefill_attention,
    chunked_prefill_attention,
    packed_prefill_attention,
    paged_decode_attention,
    paged_verify_attention,
    write_chunk_kv,
    write_decode_kv,
    write_prefill_kv,
)
from dynamo_tpu_torch.ops.basics import rms_norm, rope_freqs, swiglu
from dynamo_tpu_torch.ops.collective import (
    fused_attn_out_residual_meshed,
    fused_qkv_rope_meshed,
    fused_tail_overlap,
)
from dynamo_tpu_torch.ops.kv_quant import KVCache, cache_layer
from dynamo_tpu_torch.ops.layers import attn_out, qkv_head
from dynamo_tpu_torch.ops.linear import (
    _finish,
    _mm_f32,
    _parts,
    fused_attn_out_residual,
    fused_qkv_rope,
    linear,
)
from dynamo_tpu_torch.ops.moe import moe_ffn, moe_ffn_dropless, moe_ffn_ep_a2a, moe_ffn_shard_map


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    max_position_embeddings: int = 8192
    tie_word_embeddings: bool = False
    rope_scaling: Optional[dict] = None
    # Qwen2-family: bias on the q/k/v projections (o/mlp stay bias-free)
    attn_bias: bool = False
    # Fused decode step (DYN_FUSED_DECODE): norm+QKV+RoPE in one kernel and
    # attn-out+O-proj+residual in another, on every decode and verify step,
    # for layers without qk-norm or a sandwich post-attention norm (those
    # keep the unfused head). The kernels keep the unfused op sequence.
    fused_decode: bool = False
    # DYN_COLLECTIVE_OVERLAP: under tensor parallelism, the fused decode
    # step's post-attention tail runs as the ring decomposition of
    # ops/collective.fused_tail_overlap (inert without a group)
    collective_overlap: bool = False
    # Gemma-family: GeGLU FFN instead of SwiGLU ("gelu_tanh"), embeddings
    # scaled by sqrt(hidden) at lookup, and (1+w) RMSNorm weights — the
    # +1 is folded into the stored weights at load time, so the forward
    # pass stays identical
    mlp_act: str = "silu"
    embed_scale: bool = False
    norm_plus_one: bool = False
    # Sliding-window attention (Mistral / Gemma2 / Gemma3 local layers):
    # token i attends to (i-window, i]. None = full attention. The paged
    # cache still stores every position (the mask, not a rolling buffer,
    # enforces the window), so prefix-cache hashes stay exact.
    sliding_window: Optional[int] = None
    # Per-layer pattern: tuple[bool] (True = sliding) of len num_layers.
    # None with sliding_window set = every layer slides (Mistral).
    layer_pattern: Optional[tuple] = None
    # Gemma2: logit soft-caps (cap*tanh(x/cap)) on attention scores and
    # final logits; custom attention scale via query_pre_attn_scalar.
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    query_pre_attn_scalar: Optional[float] = None
    # Gemma2/3: sandwich norms — post-attention and post-feedforward
    # RMSNorms applied to each sublayer's OUTPUT before the residual add
    # (the pre-norms are the standard attn_norm/mlp_norm slots).
    sandwich_norms: bool = False
    # Gemma3: per-head RMSNorm on q and k after projection, before RoPE.
    qk_norm: bool = False
    # Gemma3: local (sliding) layers use their own rope theta (10k) with
    # no scaling; global layers use rope_theta (1M) + rope_scaling.
    rope_local_theta: Optional[float] = None
    # MoE (Mixtral-style): num_experts == 0 means dense SwiGLU FFN
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_capacity_factor: float = 1.25
    # None -> the dropless grouped FFN (one card or a pure-TP group);
    # "gshard" -> force the capacity-bucketed einsum dispatch
    moe_impl: Optional[str] = None

    @classmethod
    def from_hf_dict(cls, d: dict[str, Any]) -> "LlamaConfig":
        num_heads = d.get("num_attention_heads", 32)
        hidden = d.get("hidden_size", 4096)
        # Qwen2/Qwen2.5 are llama-shaped with q/k/v bias; HF marks them by
        # model_type (qwen2) / architectures (Qwen2ForCausalLM)
        is_qwen2 = d.get("model_type", "").startswith("qwen2") or any(
            a.startswith("Qwen2") for a in d.get("architectures") or []
        )
        # Gemma (v1): GeGLU + scaled embeddings + (1+w) norms + tied head.
        # Gemma2 adds soft-caps + alternating local/global attention +
        # sandwich norms; Gemma3 swaps soft-caps for qk-norm, runs 5
        # local : 1 global with a separate local rope theta.
        mt = d.get("model_type", "")
        archs = d.get("architectures") or []
        is_gemma2 = mt == "gemma2" or any(a.startswith("Gemma2") for a in archs)
        is_gemma3 = mt in ("gemma3", "gemma3_text") or any(
            a.startswith("Gemma3") for a in archs
        )
        is_gemma = mt == "gemma" or any(a.startswith("GemmaFor") for a in archs)
        gemma_like = is_gemma or is_gemma2 or is_gemma3
        num_layers = d.get("num_hidden_layers", 32)
        # Sliding window (Mistral/Qwen2 full-depth; Gemma2/3 patterned).
        # Qwen2-family configs ship a numeric sliding_window with
        # use_sliding_window=false — window disabled, full attention is
        # exact over the whole declared context (ADVICE r4 #1).
        sliding = d.get("sliding_window")
        if not d.get("use_sliding_window", True):
            sliding = None
        layer_pattern = None
        if d.get("layer_types"):
            # HF's explicit per-layer list ("sliding_attention"/"full_…")
            layer_pattern = tuple(
                t == "sliding_attention" for t in d["layer_types"]
            )
        elif is_gemma2 and sliding:
            layer_pattern = tuple(i % 2 == 0 for i in range(num_layers))
        elif is_gemma3 and sliding:
            pat = d.get("sliding_window_pattern", 6)
            layer_pattern = tuple(
                (i + 1) % pat != 0 for i in range(num_layers)
            )
        if layer_pattern is not None and not any(layer_pattern):
            sliding, layer_pattern = None, None
        return cls(
            attn_bias=is_qwen2,
            mlp_act="gelu_tanh" if gemma_like else "silu",
            embed_scale=gemma_like,
            norm_plus_one=gemma_like,
            vocab_size=d.get("vocab_size", 32000),
            hidden_size=hidden,
            intermediate_size=d.get("intermediate_size", 4 * hidden),
            num_layers=num_layers,
            num_heads=num_heads,
            num_kv_heads=d.get("num_key_value_heads", num_heads),
            head_dim=d.get("head_dim", hidden // num_heads),
            rope_theta=d.get("rope_theta", 10000.0),
            rms_eps=d.get("rms_norm_eps", 1e-5),
            max_position_embeddings=d.get("max_position_embeddings", 8192),
            tie_word_embeddings=d.get("tie_word_embeddings", gemma_like),
            rope_scaling=d.get("rope_scaling"),
            num_experts=d.get("num_local_experts", 0),
            num_experts_per_tok=d.get("num_experts_per_tok", 2),
            sliding_window=sliding,
            layer_pattern=layer_pattern,
            attn_logit_softcap=d.get("attn_logit_softcapping")
            if is_gemma2
            else None,
            final_logit_softcap=d.get("final_logit_softcapping")
            if is_gemma2
            else None,
            query_pre_attn_scalar=d.get("query_pre_attn_scalar")
            if (is_gemma2 or is_gemma3)
            else None,
            sandwich_norms=is_gemma2 or is_gemma3,
            qk_norm=is_gemma3,
            rope_local_theta=d.get("rope_local_base_freq", 10000.0)
            if is_gemma3
            else None,
        )

    def layer_window(self, i: int) -> Optional[int]:
        """This layer's sliding window, or None for full attention."""
        if self.sliding_window is None:
            return None
        if self.layer_pattern is None:
            return self.sliding_window  # Mistral: every layer slides
        return self.sliding_window if self.layer_pattern[i] else None

    @property
    def attn_scale(self) -> Optional[float]:
        """Custom attention score scale (Gemma2/3), or None for 1/sqrt(D)."""
        if self.query_pre_attn_scalar is None:
            return None
        return self.query_pre_attn_scalar ** -0.5

    @classmethod
    def from_model_dir(cls, model_dir: str) -> "LlamaConfig":
        with open(os.path.join(model_dir, "config.json")) as f:
            return cls.from_hf_dict(json.load(f))

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        """DeepSeek-R1-Distill-Llama-8B / Llama-3.1-8B shapes."""
        return cls(
            vocab_size=128256,
            hidden_size=4096,
            intermediate_size=14336,
            num_layers=32,
            num_heads=32,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=500000.0,
        )

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "LlamaConfig":
        """CPU-test config (mirrors the reference's mocker: all logic, no scale)."""
        return cls(
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            rope_theta=10000.0,
            max_position_embeddings=512,
        )

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


def param_count(config: LlamaConfig) -> int:
    c = config
    ffn = 3 * c.hidden_size * c.intermediate_size
    if c.num_experts:
        # MoE: E expert FFNs + the router table
        ffn = c.num_experts * ffn + c.hidden_size * c.num_experts
    per_layer = (
        c.hidden_size * (c.q_dim + 2 * c.kv_dim)
        + c.q_dim * c.hidden_size
        + ffn
        + 2 * c.hidden_size
        + ((c.q_dim + 2 * c.kv_dim) if c.attn_bias else 0)
    )
    total = c.num_layers * per_layer + 2 * c.vocab_size * c.hidden_size
    return total


# ----------------------------------------------------------------- forward


def _embed(params, cfg, tokens):
    """Token embedding lookup; Gemma scales by sqrt(hidden) here."""
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.hidden_size), dtype=torch.float32).to(x.dtype)
    return x


def _rope_pair(cfg, device):
    """(global_freqs, local_freqs): Gemma3 runs its sliding layers on a
    separate unscaled theta; everyone else shares one table."""
    g = rope_freqs(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling, device=device)
    if cfg.rope_local_theta is None:
        return g, g
    return g, rope_freqs(cfg.head_dim, cfg.rope_local_theta, None, device=device)


def _layer_freqs(cfg, li, pair):
    """This layer's rope table: local freqs on sliding layers (Gemma3)."""
    return pair[1] if cfg.layer_window(li) is not None else pair[0]


def rank_config(cfg: LlamaConfig, group) -> LlamaConfig:
    """The config of one rank's slice: its Hq / tp query and Hkv / tp kv
    heads (everything else is the model's). The config itself without a
    group."""
    if group is None:
        return cfg
    tp = group.world_size
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                               num_kv_heads=cfg.num_kv_heads // tp)


def _row_linear(h, w, group):
    """A row-parallel product (``wo``, ``wd``): the rank's f32 partial,
    summed over the group in f32, then the int8 scale and the cast, where
    GSPMD puts the reference's all-reduce. Plain ``linear`` without a
    group."""
    if group is None:
        return linear(h, w)
    m, sc = _parts(w)
    acc = group.all_reduce(_mm_f32(h, m.to(h.dtype)))
    return _finish(acc, sc, None, h.dtype)


def _attn_out(attn, x, layer, cfg, group):
    """ops/layers.attn_out with the row-parallel o-projection under a
    group (``cfg`` is the rank's)."""
    if group is None:
        return attn_out(attn, x, layer, cfg)
    out = _row_linear(attn.reshape(x.shape[0], cfg.q_dim), layer["wo"], group)
    if "post_attn_norm" in layer:
        out = rms_norm(out, layer["post_attn_norm"], cfg.rms_eps)
    return x + out


def _attn_prefill(x, layer, cfg, inv_freqs, positions, valid_len, k_cache_l, v_cache_l, block_table, li=0, group=None):
    q, k, v = qkv_head(x, layer, cfg, inv_freqs, positions)
    write_prefill_kv(k_cache_l, v_cache_l, k, v, block_table)
    attn = causal_prefill_attention(
        q, k, v, valid_len, window=cfg.layer_window(li), scale=cfg.attn_scale,
        logit_softcap=cfg.attn_logit_softcap,
    )
    return _attn_out(attn, x, layer, cfg, group)


def _use_fused_decode(cfg, layer, group=None) -> bool:
    """Fused decode applies when enabled and for layers the fused heads
    cover exactly: no per-head qk-norm, no sandwich post-attention norm;
    under a group also only when the heads split evenly (``cfg`` is the
    model's)."""
    if not cfg.fused_decode or "q_norm" in layer or "post_attn_norm" in layer:
        return False
    if group is None:
        return True
    tp = group.world_size
    return cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp == 0


def _use_overlap_tail(cfg, layer, group=None) -> bool:
    """The ring tail replaces both the fused o-proj and the dense MLP, so it
    needs a group, the fused heads, a plain dense FFN (no MoE router, no
    post-MLP sandwich norm) and hidden / FFN widths that split into ring
    chunks. Unlike the reference (tp > 1), a one-rank group qualifies: its
    ring has zero hops."""
    if not (
        cfg.collective_overlap
        and group is not None
        and _use_fused_decode(cfg, layer, group)
        and "router" not in layer
        and "post_mlp_norm" not in layer
    ):
        return False
    tp = group.world_size
    return cfg.hidden_size % tp == 0 and cfg.intermediate_size % tp == 0


def _fused_qkv_dispatch(x, layer, cfg, inv_freqs, positions, group=None):
    """The fused norm+QKV+RoPE head, on the rank's head slice under a
    group (``cfg`` is the rank's). cos / sin are computed exactly as
    apply_rope's angle formula; the rotation runs inside the fused head."""
    angles = positions[..., None].float() * inv_freqs
    kw = dict(
        eps=cfg.rms_eps, head_dim=cfg.head_dim,
        bq=layer.get("bq"), bk=layer.get("bk"), bv=layer.get("bv"),
    )
    args = (x, layer["attn_norm"], layer["wq"], layer["wk"], layer["wv"],
            torch.cos(angles), torch.sin(angles))
    if group is not None:
        tp = group.world_size
        return fused_qkv_rope_meshed(group, *args, num_heads=cfg.num_heads * tp,
                                     num_kv_heads=cfg.num_kv_heads * tp, **kw)
    return fused_qkv_rope(*args, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads, **kw)


def _fused_out_dispatch(attn_flat, layer, x, group=None):
    """The fused o-proj + residual head (under a group: the rank's f32
    partial, summed, then scale, cast and residual)."""
    if group is not None:
        return fused_attn_out_residual_meshed(group, attn_flat, layer["wo"], x)
    return fused_attn_out_residual(attn_flat, layer["wo"], x)


def _attn_decode(x, layer, cfg, inv_freqs, positions, context_lens, k_cache_l, v_cache_l,
                 block_tables, slot_indices, li=0, group=None, fused=False, overlap_tail=False):
    """One layer's decode attention (``cfg`` is the rank's), through the
    fused heads when ``fused``. With ``overlap_tail`` the layer's whole
    post-attention tail (o-proj, residual, MLP) runs as the ring
    decomposition and the returned x is already post-MLP."""
    if fused:
        q, k, v = _fused_qkv_dispatch(x, layer, cfg, inv_freqs, positions, group)
    else:
        q, k, v = qkv_head(x, layer, cfg, inv_freqs, positions)
    write_decode_kv(k_cache_l, v_cache_l, k, v, slot_indices)
    attn = paged_decode_attention(
        q, k_cache_l, v_cache_l, block_tables, context_lens,
        window=cfg.layer_window(li), scale=cfg.attn_scale,
        logit_softcap=cfg.attn_logit_softcap,
    )
    if not fused:
        return _attn_out(attn, x, layer, cfg, group)
    attn_flat = attn.reshape(x.shape[0], cfg.q_dim)
    if overlap_tail:
        return fused_tail_overlap(
            group, attn_flat, layer["wo"], x, layer["mlp_norm"],
            layer["wg"], layer["wu"], layer["wd"], eps=cfg.rms_eps, mlp_act=cfg.mlp_act,
        )
    return _fused_out_dispatch(attn_flat, layer, x, group)


def _ep_size(group) -> int:
    """The size of the group's ep axis (1 without a group or an ep axis)."""
    ep = getattr(group, "ep", None)
    return ep.world_size if ep is not None else 1


def _mlp(x, layer, cfg, group=None):
    h = rms_norm(x, layer["mlp_norm"], cfg.rms_eps)
    if "router" in layer:
        # the reference's dispatch rule (models/llama.py:527-567): with the
        # experts split over an ep axis, the all-to-all form for batches of
        # at least 4 tokens per ep rank that split evenly, else the psum
        # form; on one card or a pure-TP group the dropless grouped FFN, or
        # the GShard capacity path on request (under a group each rank's
        # experts are its FFN slice and the f32 partials are summed before
        # the cast)
        args = (h, layer["router"], layer["wg"], layer["wu"], layer["wd"])
        k = cfg.num_experts_per_tok
        ep = _ep_size(group)
        if ep > 1:
            T = x.shape[0]
            if T % ep == 0 and T >= 4 * ep:
                y = moe_ffn_ep_a2a(group, *args, top_k=k,
                                   capacity_factor=cfg.moe_capacity_factor)
            else:
                y = moe_ffn_shard_map(group, *args, top_k=k)
        elif cfg.moe_impl == "gshard":
            y = moe_ffn(*args, top_k=k, capacity_factor=cfg.moe_capacity_factor, group=group)
        else:
            y = moe_ffn_dropless(*args, top_k=k, group=group)
        return x + y
    gate = linear(h, layer["wg"])
    up = linear(h, layer["wu"])
    if cfg.mlp_act == "gelu_tanh":  # Gemma GeGLU
        act = F.gelu(gate.float(), approximate="tanh").to(gate.dtype) * up
    else:
        act = swiglu(gate, up)
    y = _row_linear(act, layer["wd"], group)
    if "post_mlp_norm" in layer:  # Gemma2/3 sandwich norm
        y = rms_norm(y, layer["post_mlp_norm"], cfg.rms_eps)
    return x + y


def _logits(x, params, cfg, group=None):
    h = rms_norm(x, params["final_norm"], cfg.rms_eps)
    w = params.get("lm_head")
    if w is None:
        out = torch.matmul(h, params["embed"].T.to(h.dtype)).float()
    else:
        out = linear(h, w).float()
        if group is not None:  # the rank's vocab block -> every rank's
            out = group.all_gather(out, dim=-1)
    if cfg.final_logit_softcap is not None:  # Gemma2
        cap = cfg.final_logit_softcap
        out = cap * torch.tanh(out / cap)
    return out


def prefill(
    params: dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [P] int64, padded to a multiple of block_size
    valid_len: int,  # true prompt length
    k_cache: KVCache,  # [L, Hkv, num_blocks, block_size, D] (or int8), written in place
    v_cache: KVCache,
    block_table: torch.Tensor,  # [P // block_size] block ids
    group=None,  # a TPGroup: params / caches are this rank's slices
) -> torch.Tensor:
    """Process a prompt; writes its K/V into the caches and returns the last
    valid token's logits [V] (f32)."""
    x = _embed(params, cfg, tokens)
    return _prefill_from_embeds(params, cfg, x, valid_len, k_cache, v_cache, block_table, group)


def prefill_mm(
    params: dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [P] int64, image placeholders already expanded
    valid_len: int,
    k_cache: KVCache,
    v_cache: KVCache,
    block_table: torch.Tensor,
    mm_embeds: torch.Tensor,  # [M, hidden] the vision projector's output (f32)
    mm_start: int,  # the embeds overwrite rows [mm_start, mm_start + M)
    group=None,
) -> torch.Tensor:
    """Multimodal prefill (dynamo_tpu/models/llama.py:593-621): the token
    embeddings with the vision tower's patch embeddings, cast to the
    embedding dtype, spliced over the expanded placeholder span, then the
    same stack as ``prefill``. The start is clamped so the span fits, as
    the reference's ``dynamic_update_slice`` clamps it."""
    x = _embed(params, cfg, tokens)
    M = mm_embeds.shape[0]
    start = min(max(int(mm_start), 0), x.shape[0] - M)
    x[start:start + M] = mm_embeds.to(device=x.device, dtype=x.dtype)
    return _prefill_from_embeds(params, cfg, x, valid_len, k_cache, v_cache, block_table, group)


def _prefill_from_embeds(params, cfg, x, valid_len, k_cache, v_cache, block_table, group=None):
    """The stack over embedded rows x [P, hidden] (llama.py:623-645): each
    layer writes its K/V into the paged caches and attends causally over
    the prompt; returns the last valid row's logits [V] (f32)."""
    lc = rank_config(cfg, group)
    freqs = _rope_pair(cfg, x.device)
    positions = torch.arange(x.shape[0], device=x.device)
    for i, layer in enumerate(params["layers"]):
        x = _attn_prefill(
            x, layer, lc, _layer_freqs(cfg, i, freqs), positions, valid_len,
            cache_layer(k_cache, i), cache_layer(v_cache, i), block_table, li=i, group=group,
        )
        x = _mlp(x, layer, cfg, group)
    return _logits(x[valid_len - 1][None, :], params, cfg, group)[0]


def embed_pooled(
    params: dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [P] int64, padded
    valid_len: int,
    group=None,
) -> torch.Tensor:
    """Pooled sequence embedding (dynamo_tpu/models/llama.py:821-845): a
    cacheless causal forward, the final norm, and the mean of the valid
    rows in f32. The valid rows are selected, not masked by a product: the
    prefill kernel leaves a bucket's padding rows unspecified, and a NaN
    there times 0 would still be NaN (the reference multiplies)."""
    lc = rank_config(cfg, group)
    freqs = _rope_pair(cfg, tokens.device)
    positions = torch.arange(tokens.shape[0], device=tokens.device)
    x = _embed(params, cfg, tokens)
    for i, layer in enumerate(params["layers"]):
        q, k, v = qkv_head(x, layer, lc, _layer_freqs(cfg, i, freqs), positions)
        attn = causal_prefill_attention(
            q, k, v, valid_len, window=cfg.layer_window(i), scale=cfg.attn_scale,
            logit_softcap=cfg.attn_logit_softcap,
        )
        x = _attn_out(attn, x, layer, lc, group)
        x = _mlp(x, layer, cfg, group)
    h = rms_norm(x[:valid_len], params["final_norm"], cfg.rms_eps).float()
    return h.sum(dim=0) / max(valid_len, 1)


def prefill_chunk(
    params: dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [C] int64 -- one chunk, padded to the chunk size
    chunk_start: int,  # position of tokens[0], a multiple of block_size
    valid_len: int,  # TOTAL prompt length
    k_cache: KVCache,  # [L, Hkv, num_blocks, block_size, D] (or int8), written in place
    v_cache: KVCache,
    block_table: torch.Tensor,  # [max_nb] block ids of the whole prompt
    group=None,  # a TPGroup: params / caches are this rank's slices
) -> torch.Tensor:
    """One chunk of a chunked prefill (dynamo_tpu/models/llama.py:670):
    each layer writes the chunk's K/V into the paged cache, then the chunk
    attends over everything written so far. Chunks run in order. Returns
    the logits [V] (f32) of the prompt's last valid token in this chunk,
    which mean something only on the final chunk."""
    lc = rank_config(cfg, group)
    C = tokens.shape[0]
    freqs = _rope_pair(cfg, tokens.device)
    positions = chunk_start + torch.arange(C, device=tokens.device)
    x = _embed(params, cfg, tokens)
    for i, layer in enumerate(params["layers"]):
        q, k, v = qkv_head(x, layer, lc, _layer_freqs(cfg, i, freqs), positions)
        kl, vl = cache_layer(k_cache, i), cache_layer(v_cache, i)
        write_chunk_kv(kl, vl, k, v, block_table, chunk_start)
        attn = chunked_prefill_attention(
            q, kl, vl, block_table, chunk_start,
            window=cfg.layer_window(i), scale=cfg.attn_scale,
            logit_softcap=cfg.attn_logit_softcap,
        )
        x = _attn_out(attn, x, layer, lc, group)
        x = _mlp(x, layer, cfg, group)
    idx = min(max(valid_len - 1 - chunk_start, 0), C - 1)
    return _logits(x[idx][None, :], params, cfg, group)[0]


def prefill_packed(
    params: dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [P] int64 -- several prompts back to back
    positions: torch.Tensor,  # [P] int64, restarting at 0 per segment
    segment_ids: torch.Tensor,  # [P] int; -1 marks padding
    slot_indices: torch.Tensor,  # [P] int64 flat cache slot of each token
    k_cache: KVCache,  # [L, Hkv, num_blocks, block_size, D] (or int8), written in place
    v_cache: KVCache,
    last_idx: torch.Tensor,  # [N] int64 index of each prompt's last token
    group=None,  # a TPGroup: params / caches are this rank's slices
) -> torch.Tensor:
    """N short prompts packed into one [P] pass
    (dynamo_tpu/models/llama.py:715). Per-token flat slots route each
    segment's K/V into its own blocks (``write_decode_kv`` over P tokens;
    padding goes to the null slot 0) and attention is causal within a
    segment. Returns logits [N, V] (f32), one row per segment's last token;
    rows of unused ``last_idx`` entries read token 0 and are ignored."""
    lc = rank_config(cfg, group)
    freqs = _rope_pair(cfg, tokens.device)
    x = _embed(params, cfg, tokens)
    for i, layer in enumerate(params["layers"]):
        q, k, v = qkv_head(x, layer, lc, _layer_freqs(cfg, i, freqs), positions)
        write_decode_kv(cache_layer(k_cache, i), cache_layer(v_cache, i), k, v, slot_indices)
        attn = packed_prefill_attention(
            q, k, v, segment_ids, window=cfg.layer_window(i), scale=cfg.attn_scale,
            logit_softcap=cfg.attn_logit_softcap,
        )
        x = _attn_out(attn, x, layer, lc, group)
        x = _mlp(x, layer, cfg, group)
    return _logits(x[last_idx], params, cfg, group)


def decode(
    params: dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B] int64
    positions: torch.Tensor,  # [B] int64 (0-indexed position of this token)
    k_cache: KVCache,  # [L, Hkv, num_blocks, block_size, D] (or int8), written in place
    v_cache: KVCache,
    block_tables: torch.Tensor,  # [B, max_blocks] int32
    slot_indices: torch.Tensor,  # [B] flat cache slots for the new token
    group=None,  # a TPGroup: params / caches are this rank's slices
) -> torch.Tensor:
    """One decode step for a batch; writes the new K/V into the caches and
    returns logits [B, V] (f32). Under a group with ``fused_decode`` each
    layer runs the meshed fused heads, and with ``collective_overlap`` the
    ring tail in place of the o-proj and the MLP."""
    lc = rank_config(cfg, group)
    freqs = _rope_pair(cfg, tokens.device)
    context_lens = (positions + 1).to(torch.int32)
    x = _embed(params, cfg, tokens)
    for i, layer in enumerate(params["layers"]):
        fused = _use_fused_decode(cfg, layer, group)
        overlap = _use_overlap_tail(cfg, layer, group)
        x = _attn_decode(
            x, layer, lc, _layer_freqs(cfg, i, freqs), positions, context_lens,
            cache_layer(k_cache, i), cache_layer(v_cache, i), block_tables, slot_indices,
            li=i, group=group, fused=fused, overlap_tail=overlap,
        )
        if not overlap:
            x = _mlp(x, layer, cfg, group)
    return _logits(x, params, cfg, group)


def decode_verify(
    params: dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, S] int64 -- last accepted token + draft window
    positions: torch.Tensor,  # [B, S] int64 true positions, consecutive per lane
    k_cache: KVCache,  # [L, Hkv, num_blocks, block_size, D] (or int8), written in place
    v_cache: KVCache,
    block_tables: torch.Tensor,  # [B, max_blocks] int32
    slot_indices: torch.Tensor,  # [B, S] flat cache slots (0 = null sink)
    group=None,  # a TPGroup: params / caches are this rank's slices
) -> torch.Tensor:
    """Draft-verify forward for speculative decoding: ONE weight pass scores
    S positions per lane. Each lane's S tokens write their K/V into their
    slots first, then attend causally over the lane's paged context (the
    drafts see each other through the cache). Returns logits [B, S, V]
    (f32). Under a group (the reference's verify under its mesh,
    models/llama.py:849) each rank runs the verify attention on its Hq / tp
    query and Hkv / tp kv heads, the fused heads on its slice when enabled
    (the o-proj as its f32 partial), and the partials are summed."""
    lc = rank_config(cfg, group)
    freqs = _rope_pair(cfg, tokens.device)
    B, S = tokens.shape
    pos_flat = positions.reshape(-1)
    slots_flat = slot_indices.reshape(-1)
    positions_i32 = positions.to(torch.int32)
    x = _embed(params, cfg, tokens.reshape(-1))  # [B*S, hidden]
    for i, layer in enumerate(params["layers"]):
        fused = _use_fused_decode(cfg, layer, group)
        lf = _layer_freqs(cfg, i, freqs)
        if fused:
            # the fused heads are row-count generic: the window's flat [B*S]
            # rows ride the same heads decode uses
            q, k, v = _fused_qkv_dispatch(x, layer, lc, lf, pos_flat, group)
        else:
            q, k, v = qkv_head(x, layer, lc, lf, pos_flat)
        kl, vl = cache_layer(k_cache, i), cache_layer(v_cache, i)
        write_decode_kv(kl, vl, k, v, slots_flat)
        attn = paged_verify_attention(
            q.reshape(B, S, lc.num_heads, lc.head_dim), kl, vl,
            block_tables, positions_i32,
            window=cfg.layer_window(i), scale=cfg.attn_scale,
            logit_softcap=cfg.attn_logit_softcap,
        )
        if fused:
            x = _fused_out_dispatch(attn.reshape(B * S, lc.q_dim), layer, x, group)
        else:
            x = _attn_out(attn.reshape(B * S, lc.num_heads, lc.head_dim), x, layer, lc, group)
        x = _mlp(x, layer, cfg, group)
    return _logits(x, params, cfg, group).reshape(B, S, -1)


def prefill_context_parallel(
    params: dict,
    cfg: LlamaConfig,
    group,  # the rank's TPGroup, with an sp axis (and optionally tp)
    tokens: torch.Tensor,  # [P] int64, P divisible by sp (padded with 0s)
    valid_len: int,
    *,
    k_cache: Optional[KVCache] = None,  # [L, Hkv / tp, nb, bs, D]: paginate per layer
    v_cache: Optional[KVCache] = None,
    block_table: Optional[torch.Tensor] = None,  # [P // bs] block ids
):
    """Long-context prefill with the sequence cut over the grid's ``sp``
    axis (reference models/llama.py:760): every rank of an sp line runs its
    chunk of C = P / sp tokens through every layer -- its projections, the
    MLP (and the row-parallel sums over tp) on its C rows alone, attention
    as ring attention (parallel/ring_attention.py) on its tp heads.

    With a cache: each layer's K/V chunks are all-gathered over sp and
    written into the rank's cache (replicated over sp) inside the layer
    loop, so the transient is one layer's [P, Hkv / tp, D]. Returns the
    logits [V] (f32) of the last valid token. Without a cache: returns
    (logits, k_new, v_new), the K/V of every layer [L, P, Hkv / tp, D], for
    shipping to a decode worker."""
    from dynamo_tpu_torch.parallel.ring_attention import ring_attention_body

    sp = group.sp
    paginate = k_cache is not None
    P = tokens.shape[0]
    if P % sp.world_size:
        raise ValueError(f"a prompt of {P} does not split into sp={sp.world_size}")
    C = P // sp.world_size
    lo = sp.rank * C
    lc = rank_config(cfg, group)
    freqs = _rope_pair(cfg, tokens.device)
    positions = lo + torch.arange(C, device=tokens.device)
    x = _embed(params, cfg, tokens[lo:lo + C])
    k_all, v_all = [], []
    for i, layer in enumerate(params["layers"]):
        q, k, v = qkv_head(x, layer, lc, _layer_freqs(cfg, i, freqs), positions)
        # sliding layers ride the same ring: hops wholly outside the window
        # skip their update
        attn = ring_attention_body(
            sp, q, k, v, valid_len, window=cfg.layer_window(i), scale=cfg.attn_scale,
            logit_softcap=cfg.attn_logit_softcap,
        )
        x = _attn_out(attn, x, layer, lc, group)
        x = _mlp(x, layer, cfg, group)
        k_full, v_full = sp.all_gather(k, dim=0), sp.all_gather(v, dim=0)
        if paginate:
            write_prefill_kv(cache_layer(k_cache, i), cache_layer(v_cache, i), k_full, v_full,
                             block_table)
        else:
            k_all.append(k_full)
            v_all.append(v_full)
    # the last valid row lives on one rank of the line: the others add zeros
    owner, row = divmod(valid_len - 1, C)
    last = x[row][None, :] if sp.rank == owner else torch.zeros_like(x[:1])
    last = sp.all_reduce(last.float()).to(x.dtype) if sp.world_size > 1 else last
    logits = _logits(last, params, cfg, group)[0]
    if paginate:
        return logits
    return logits, torch.stack(k_all), torch.stack(v_all)
