"""Every hand-written CUDA kernel of the port, with its launch count.

Each wrapper adds one to its ``.launches`` where it launches its kernel and
nowhere else, so a caller can set the counts to 0, drive a path and read
which kernels it went through.
"""

from __future__ import annotations

from dynamo_tpu_torch.ops.cuda_attention import (
    attention_shape_problems,
    flash_prefill_attention_cuda,
    paged_decode_attention_cuda,
    paged_decode_attention_int8_cuda,
    paged_verify_attention_cuda,
    paged_verify_attention_int8_cuda,
)
from dynamo_tpu_torch.ops.cuda_linear import (
    fused_attn_out_residual_cuda,
    fused_attn_out_residual_int8_cuda,
    fused_qkv_rope_cuda,
    fused_qkv_rope_int8_cuda,
    out_proj_shape_problems,
    qkv_shape_problems,
)

# name -> wrapper; the names are the csrc/ sources' stems. The int8 modes
# are second entry points of the same sources; they count under their own
# names (the stem + "_int8"), so a run shows which mode it went through.
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
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def card_shape_problems(cfg, fused_decode: bool = False) -> list[str]:
    """Why the card's kernels would refuse a model config's shapes at its
    first request (empty: every kernel on its path takes them). The fused
    heads count only with ``fused_decode`` and for models whose layers they
    serve (no qk-norm, no sandwich norms). The int8 modes of #1, #2, #4 and
    #5 take exactly the shapes their bf16 modes take (int8 page rows and
    weight rows of D or N bytes stay whole 16-byte pieces at every head dim
    and width allowed here), so the int8 deployment adds no refusal."""
    out = attention_shape_problems(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    if fused_decode and not (cfg.qk_norm or cfg.sandwich_norms):
        out += [f"fused QKV head: {p}" for p in qkv_shape_problems(
            cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)]
        out += [f"fused o-proj head: {p}" for p in out_proj_shape_problems(
            cfg.num_heads * cfg.head_dim, cfg.hidden_size)]
    return out
