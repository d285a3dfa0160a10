"""Every hand-written CUDA kernel of the port, with its launch count.

Each wrapper adds one to its ``.launches`` where it launches its kernel and
nowhere else, so a caller can set the counts to 0, drive a path and read
which kernels it went through.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.ops.cuda_attention import (
    attention_shape_problems,
    flash_prefill_attention_cuda,
    paged_decode_attention_cuda,
    paged_decode_attention_int8_cuda,
    paged_verify_attention_cuda,
    paged_verify_attention_int8_cuda,
)
from dynamo_tpu_torch.ops.cuda_linear import (
    fused_attn_out_partial_cuda,
    fused_attn_out_partial_int8_cuda,
    fused_attn_out_residual_cuda,
    fused_attn_out_residual_int8_cuda,
    fused_qkv_rope_cuda,
    fused_qkv_rope_int8_cuda,
    out_proj_shape_problems,
    qkv_shape_problems,
)
from dynamo_tpu_torch.ops.cuda_moe import grouped_ffn_shape_problems, grouped_swiglu_ffn_cuda

# name -> wrapper; the names are the csrc/ sources' stems. The int8 modes
# are second entry points of the same sources; they count under their own
# names (the stem + "_int8"), so a run shows which mode it went through.
# #5's partial_out mode (the tensor-parallel o-projection) counts as
# "fused_attn_out_partial" and "fused_attn_out_partial_int8", entry points
# of #5's source. The grouped SwiGLU FFN (the MoE layer's expert products;
# no TPU kernel upstream) counts one per call, which is its two launches.
KERNELS = {
    "paged_decode_attention": paged_decode_attention_cuda,
    "flash_prefill_attention": flash_prefill_attention_cuda,
    "paged_verify_attention": paged_verify_attention_cuda,
    "fused_qkv_rope": fused_qkv_rope_cuda,
    "fused_attn_out_residual": fused_attn_out_residual_cuda,
    "paged_decode_attention_int8": paged_decode_attention_int8_cuda,
    "paged_verify_attention_int8": paged_verify_attention_int8_cuda,
    "fused_qkv_rope_int8": fused_qkv_rope_int8_cuda,
    "fused_attn_out_residual_int8": fused_attn_out_residual_int8_cuda,
    "fused_attn_out_partial": fused_attn_out_partial_cuda,
    "fused_attn_out_partial_int8": fused_attn_out_partial_int8_cuda,
    "grouped_swiglu_ffn": grouped_swiglu_ffn_cuda,
}


def _source(name: str) -> tuple[str, str]:
    stem = name.removesuffix("_int8")
    entry = f"{stem}_{'int8' if stem != name else 'bf16'}"
    return ("fused_attn_out_residual" if stem == "fused_attn_out_partial" else stem), entry


# name -> (csrc source stem, C entry point) of each counted kernel
SOURCES = {name: _source(name) for name in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def card_shape_problems(cfg, fused_decode: bool = False, tp: int = 1,
                        dtype=torch.bfloat16) -> list[str]:
    """Why the card's kernels would refuse a model config's shapes at its
    first request (empty: every kernel on its path takes them). The fused
    heads count only with ``fused_decode`` and for models whose layers they
    serve (no qk-norm, no sandwich norms). The int8 modes of #1, #2, #4 and
    #5 take exactly the shapes their bf16 modes take (int8 page rows and
    weight rows of D or N bytes stay whole 16-byte pieces at every head dim
    and width allowed here), so the int8 deployment adds no refusal. Under
    tensor parallelism of ``tp`` ranks each rank's kernels see its own head
    slice (Hq / tp, Hkv / tp heads), and #5's partial_out mode the rank's
    [Hq * D / tp, hidden] o-projection and its hidden / tp column chunks.
    An MoE model's grouped FFN kernel takes bf16 experts whose hidden size
    and per-rank FFN width (intermediate_size / tp: each rank holds every
    expert's FFN slice) lie on its tile grid; the experts are never int8."""
    hq, hkv = cfg.num_heads // tp, cfg.num_kv_heads // tp
    out = attention_shape_problems(hq, hkv, cfg.head_dim)
    if fused_decode and not (cfg.qk_norm or cfg.sandwich_norms):
        out += [f"fused QKV head: {p}" for p in qkv_shape_problems(
            cfg.hidden_size, hq, hkv, cfg.head_dim)]
        out += [f"fused o-proj head: {p}" for p in out_proj_shape_problems(
            hq * cfg.head_dim, cfg.hidden_size // tp)]
    if cfg.num_experts:
        out += [f"grouped MoE FFN: {p}" for p in grouped_ffn_shape_problems(
            cfg.hidden_size, cfg.intermediate_size // tp, dtype)]
    return out
