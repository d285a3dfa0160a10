"""Engine factory: model config (or HF model dir) -> TorchEngine.

Counterpart of dynamo_tpu/engine/jax_engine/factory.py (``build_jax_engine``
:26-209, ``default_num_blocks`` :411, ``kv_dtype_from_env``,
``fused_decode_from_env`` and ``spec_decode_settings`` :271-320, the
``DYN_JAX_QUANTIZE_INT8`` read at :80-82) for one device, with the JAX
factory's default admission path: chunked, packed and mixed-step prefill.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Union

import torch

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.engine.torch_engine.engine import (
    TorchEngine,
    TorchEngineConfig,
    check_chunk_budget,
)
from dynamo_tpu_torch.engine.torch_engine.model_runner import TorchModelRunner
from dynamo_tpu_torch.engine.torch_engine.weights import load_or_init_params
from dynamo_tpu_torch.models.llama import LlamaConfig, param_count
from dynamo_tpu_torch.ops.kernels import card_shape_problems

# assumed device memory when the device cannot be asked (the CPU)
_DEFAULT_BUDGET_BYTES = 16 * 2**30


def device_memory_bytes(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return _DEFAULT_BUDGET_BYTES


def default_num_blocks(
    config: LlamaConfig,
    max_len: int,
    max_batch: int,
    *,
    block_size: int = 16,
    budget_bytes: int = _DEFAULT_BUDGET_BYTES,
    dtype_bytes: int = 2,
    utilization: float = 0.85,
    quantized: bool = False,
    kv_dtype: str = "bf16",
) -> int:
    """Blocks for every batch lane at full context plus slack, capped so
    weights + KV fit the device memory budget (the JAX sizing rule,
    factory.py:411-450): int8 weights count the dense parameters at 1 byte,
    an int8 KV cache 1 byte per value plus a 4-byte scale per (layer, kv
    head, block) of each of K and V."""
    per_seq = (max_len + block_size - 1) // block_size
    want = max_batch * per_seq + 64
    weight_bytes = param_count(config) * (1 if quantized else dtype_bytes)
    int8_kv = kv_dtype == "int8"
    block_bytes = 2 * (
        config.num_layers * block_size * config.num_kv_heads * config.head_dim
        * (1 if int8_kv else dtype_bytes)
        + (4 * config.num_layers * config.num_kv_heads if int8_kv else 0)
    )
    budget = int(budget_bytes * utilization) - weight_bytes
    return min(want, max(16, budget // block_bytes))


def quantize_from_env() -> bool:
    """DYN_JAX_QUANTIZE_INT8=1: int8 weight-only quantization of the dense
    projections, read under the JAX factory's name so that one deployment's
    environment means the same on both packages. Off by default."""
    return os.environ.get("DYN_JAX_QUANTIZE_INT8", "0") in ("1", "true")


def kv_dtype_from_env() -> str:
    """DYN_KV_DTYPE=int8|bf16 (default bf16): the paged KV cache's form,
    int8-resident (mantissas + per-(layer, head, block) f32 scales) or
    bf16, read as the JAX factory reads it."""
    v = os.environ.get("DYN_KV_DTYPE", "bf16").strip().lower()
    return "int8" if v == "int8" else "bf16"


def fused_decode_from_env() -> bool:
    """DYN_FUSED_DECODE=1: run every decode and verify step's norm+QKV+RoPE
    and o-proj+residual through the fused kernels. Off by default, as in
    the JAX package."""
    return os.environ.get("DYN_FUSED_DECODE", "0") in ("1", "true", "yes")


def spec_decode_settings() -> dict:
    """Self-drafting speculative decoding knobs (TorchEngineConfig fields):

      DYN_SPEC_K           draft tokens per lane per dispatch (0 = off, the
                           default)
      DYN_SPEC_DRAFTER     "ngram" (prompt lookup; the only kind)
      DYN_SPEC_NGRAM_MIN / DYN_SPEC_NGRAM_MAX   lookup n-gram bounds
      DYN_SPEC_COVERAGE    least fraction of lanes with a draft
    """
    env = os.environ.get
    return {
        "spec_k": max(0, int(env("DYN_SPEC_K", "0") or 0)),
        "spec_drafter": env("DYN_SPEC_DRAFTER", "ngram"),
        "spec_ngram_min": max(1, int(env("DYN_SPEC_NGRAM_MIN", "2") or 2)),
        "spec_ngram_max": max(1, int(env("DYN_SPEC_NGRAM_MAX", "4") or 4)),
        "spec_min_coverage": float(env("DYN_SPEC_COVERAGE", "0.5") or 0.5),
    }


def _resolve_config(config) -> tuple[LlamaConfig, Optional[str]]:
    if isinstance(config, LlamaConfig):
        return config, None
    if isinstance(config, dict):
        return LlamaConfig.from_hf_dict(config), None
    if isinstance(config, (str, os.PathLike)):
        path = os.fspath(config)
        try:
            return LlamaConfig.from_model_dir(path), path
        except (OSError, json.JSONDecodeError) as e:
            raise ValueError(
                f"cannot read the model config of checkpoint directory {path}: {e}"
            ) from e
    if config is None:
        return LlamaConfig.llama3_8b(), None
    raise TypeError(f"config must be a LlamaConfig, an HF config dict or a model dir, not {type(config)}")


def build_torch_engine(
    config: Union[LlamaConfig, dict, str, None] = None,
    *,
    device="cuda",
    kv_block_size: int = 16,
    max_batch: int = 8,
    num_blocks: Optional[int] = None,
    max_model_len: Optional[int] = None,
    seed: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    fused_decode: Optional[bool] = None,
    spec_k: Optional[int] = None,
    spec_min_coverage: Optional[float] = None,
    params: Optional[dict] = None,
    prefill_chunk_tokens: int = 512,
    quantize: Optional[bool] = None,
    kv_dtype: Optional[str] = None,
) -> TorchEngine:
    """Build the serving engine on ``device`` (the card unless the caller
    asks for the CPU; raises when a card is asked for and absent).

    ``config`` is a LlamaConfig, an HF ``config.json`` dict, or a model
    directory holding one (default: Llama-3.1-8B shapes; a directory whose
    config cannot be read raises). Weights are ``params`` when given (a
    parameter dict on ``device``, e.g. another engine's, shared rather than
    copied), else the directory's ``*.safetensors`` checkpoint in ``dtype``
    (``load_hf_safetensors``), else seeded random (``init_params``). The
    KV pool is sized like the JAX factory's: every lane at full context
    plus 64 blocks, capped by the device memory left after the weights.

    ``prefill_chunk_tokens`` (default 512, as the JAX runner's) is the
    chunked prefill's chunk and the packed prefill's token buffer; 0 turns
    chunking off, so every prompt is prefilled on its own. The mixed step
    and its per-step budget come from ``DYN_MIXED_STEP`` (on unless "0")
    and ``DYN_CHUNK_BUDGET`` (0: two chunks); a budget that is not a
    multiple of ``kv_block_size`` raises ValueError here.

    ``fused_decode``, ``spec_k`` and ``spec_min_coverage`` default to what
    ``DYN_FUSED_DECODE`` and ``DYN_SPEC_*`` say (fused and spec off when
    unset); the drafter's kind and n-gram bounds come from the
    environment.

    The int8 deployment: ``quantize`` (default ``DYN_JAX_QUANTIZE_INT8``)
    quantizes the dense projections to int8 weight-only (made or loaded in
    ``dtype``, then quantized; ``params`` given are used as they are), and
    ``kv_dtype`` (default ``DYN_KV_DTYPE``, "bf16" or "int8") makes the KV
    cache int8-resident; the KV pool is then sized with both at 1 byte.
    Unlike the JAX factory, ``kv_block_size`` is not raised to 32 under an
    int8 cache: that retune serves Mosaic's (32, 128) int8 tile, a TPU
    limit, and the Hopper kernels take block 16. The KV scale is one per
    block, so the quantized numbers depend on the block size: compare the
    two packages at equal block sizes.

    On the card, a config whose shapes a kernel of its path would refuse
    raises ValueError here, before any request (and before the card is
    looked for), naming each refusal; nothing falls back to a plain
    version."""
    cfg, model_dir = _resolve_config(config)
    # DYN_CHUNK_BUDGET / DYN_MIXED_STEP, checked before any weight is made
    chunking = TorchEngineConfig(block_size=kv_block_size)
    check_chunk_budget(chunking.chunk_budget, kv_block_size)
    if fused_decode is None:
        fused_decode = fused_decode_from_env()
    if quantize is None:
        quantize = quantize_from_env()
    if kv_dtype is None:
        kv_dtype = kv_dtype_from_env()
    if torch.device(device).type == "cuda":
        problems = card_shape_problems(cfg, fused_decode)
        if problems:
            raise ValueError(
                "the card's kernels do not take this model's shapes: " + "; ".join(problems)
            )
    dev = resolve_device(device)
    max_len = min(max_model_len or cfg.max_position_embeddings, cfg.max_position_embeddings)
    if num_blocks is None:
        num_blocks = default_num_blocks(
            cfg, max_len, max_batch, block_size=kv_block_size,
            budget_bytes=device_memory_bytes(dev),
            dtype_bytes=torch.empty((), dtype=dtype).element_size(),
            quantized=quantize, kv_dtype=kv_dtype,
        )
    spec = spec_decode_settings()
    if spec_k is not None:
        spec["spec_k"] = spec_k
    if spec_min_coverage is not None:
        spec["spec_min_coverage"] = spec_min_coverage
    if params is None:
        params = load_or_init_params(model_dir, cfg, seed=seed, device=dev, dtype=dtype,
                                     quantize=quantize)
    runner = TorchModelRunner(
        cfg, params, num_blocks=num_blocks, block_size=kv_block_size,
        max_batch=max_batch, max_model_len=max_len, device=dev, rng_seed=seed,
        fused_decode=fused_decode, prefill_chunk_tokens=prefill_chunk_tokens,
        kv_dtype=kv_dtype,
    )
    return TorchEngine(
        runner,
        TorchEngineConfig(
            max_batch=max_batch, block_size=kv_block_size, num_blocks=num_blocks,
            max_model_len=max_len, rng_seed=seed, chunk_budget=chunking.chunk_budget,
            mixed_step=chunking.mixed_step, **spec,
        ),
    )
