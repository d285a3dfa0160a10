"""Mixtral family (Mixtral-8x7B and tiny MoE test configs).

Counterpart of dynamo_tpu/models/mixtral.py: a Mixtral-style model is a
``LlamaConfig`` with ``num_experts`` > 0. The attention stack, the paged
cache and the engine are the dense family's (models/llama.py); each layer's
FFN routes through ops/moe.py. An HF ``config.json`` with
``num_local_experts`` reads into the same config (``from_hf_dict``), and
engine/torch_engine/weights.py loads ``block_sparse_moe`` checkpoints.
"""

from __future__ import annotations

from dynamo_tpu_torch.models.llama import (  # noqa: F401 -- re-exported surface
    LlamaConfig,
    decode,
    prefill,
)

MixtralConfig = LlamaConfig  # one family; num_experts > 0 is MoE


def mixtral_8x7b() -> LlamaConfig:
    """Mixtral-8x7B-v0.1 shapes (HF mistralai/Mixtral-8x7B)."""
    return LlamaConfig(
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=1e6,
        max_position_embeddings=32768,
        num_experts=8,
        num_experts_per_tok=2,
    )


def tiny_moe(vocab_size: int = 256, num_experts: int = 4) -> LlamaConfig:
    """CPU-test MoE config (all logic, no scale)."""
    return LlamaConfig(
        vocab_size=vocab_size,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        rope_theta=10000.0,
        max_position_embeddings=512,
        num_experts=num_experts,
        num_experts_per_tok=2,
    )
