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
    paged_verify_attention_cuda,
)
from dynamo_tpu_torch.ops.cuda_linear import (
    fused_attn_out_residual_cuda,
    fused_qkv_rope_cuda,
    out_proj_shape_problems,
    qkv_shape_problems,
)

# name -> wrapper; the names are the csrc/ sources' stems
KERNELS = {
    "paged_decode_attention": paged_decode_attention_cuda,
    "flash_prefill_attention": flash_prefill_attention_cuda,
    "paged_verify_attention": paged_verify_attention_cuda,
    "fused_qkv_rope": fused_qkv_rope_cuda,
    "fused_attn_out_residual": fused_attn_out_residual_cuda,
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
    serve (no qk-norm, no sandwich norms)."""
    out = attention_shape_problems(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    if fused_decode and not (cfg.qk_norm or cfg.sandwich_norms):
        out += [f"fused QKV head: {p}" for p in qkv_shape_problems(
            cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)]
        out += [f"fused o-proj head: {p}" for p in out_proj_shape_problems(
            cfg.num_heads * cfg.head_dim, cfg.hidden_size)]
    return out
