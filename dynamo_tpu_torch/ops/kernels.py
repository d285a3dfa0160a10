"""Every hand-written CUDA kernel of the port, with its launch count.

Each wrapper adds one to its ``.launches`` where it launches its kernel and
nowhere else, so a caller can set the counts to 0, drive a path and read
which kernels it went through.
"""

from __future__ import annotations

from dynamo_tpu_torch.ops.cuda_attention import (
    flash_prefill_attention_cuda,
    paged_decode_attention_cuda,
    paged_verify_attention_cuda,
)
from dynamo_tpu_torch.ops.cuda_linear import (
    fused_attn_out_residual_cuda,
    fused_qkv_rope_cuda,
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
