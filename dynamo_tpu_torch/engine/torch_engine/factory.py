"""Engine factory: model config (or HF model dir) -> TorchEngine.

Counterpart of dynamo_tpu/engine/jax_engine/factory.py (``build_jax_engine``
:26-209, ``default_num_blocks`` :411, ``kv_dtype_from_env``,
``fused_decode_from_env``, ``collective_overlap_from_env`` and
``spec_decode_settings`` :271-320, the ``DYN_JAX_QUANTIZE_INT8`` read at
:80-82), with the JAX factory's default admission path: chunked, packed and
mixed-step prefill.

Tensor parallelism (``tensor_parallel_size``, the reference's mesh and
Megatron sharding, :113-163): this process becomes rank 0, the leader, and
spawns the other ranks as follower processes (``torch.multiprocessing``,
spawn, rendezvous on a free local port); each rank builds its own slice of
the same seeded or loaded parameters and its own KV pool, and the leader's
engine drives every rank through parallel/multihost.SpmdModelRunner.
Closing the engine stops the followers.
"""

from __future__ import annotations

import json
import logging
import os
import sys
from typing import Optional, Union

import torch
import torch.multiprocessing as mp

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
from dynamo_tpu_torch.parallel.launch import free_port, init_method
from dynamo_tpu_torch.parallel.mesh import TPGroup, rank_devices
from dynamo_tpu_torch.parallel.multihost import (
    LeaderLostError,
    SpmdModelRunner,
    SpmdStepChannel,
    follower_loop,
)
from dynamo_tpu_torch.parallel.sharding import check_shardable, shard_leaf

logger = logging.getLogger("dynamo_tpu_torch.factory")

# assumed device memory when the device cannot be asked (the CPU)
_DEFAULT_BUDGET_BYTES = 16 * 2**30
# a tensor-parallel group's rendezvous and each of its collectives give up
# after this long (a follower's wait for the leader's next step has its own,
# TPGroup's idle_timeout_s)
TP_TIMEOUT_S = 600.0


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
    tp: int = 1,
) -> int:
    """Blocks for every batch lane at full context plus slack, capped so
    weights + KV fit the device memory budget (the JAX sizing rule,
    factory.py:411-450): int8 weights count the dense parameters at 1 byte,
    an int8 KV cache 1 byte per value plus a 4-byte scale per (layer, kv
    head, block) of each of K and V; under tensor parallelism of ``tp``
    ranks, per rank: the weights divided by tp, the rank's Hkv / tp heads
    per block (ranks sharing a card must pass ``num_blocks`` themselves)."""
    per_seq = (max_len + block_size - 1) // block_size
    want = max_batch * per_seq + 64
    weight_bytes = param_count(config) * (1 if quantized else dtype_bytes) // tp
    int8_kv = kv_dtype == "int8"
    heads = config.num_kv_heads // tp
    block_bytes = 2 * (
        config.num_layers * block_size * heads * config.head_dim
        * (1 if int8_kv else dtype_bytes)
        + (4 * config.num_layers * heads if int8_kv else 0)
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


def collective_overlap_from_env() -> bool:
    """DYN_COLLECTIVE_OVERLAP=1: under tensor parallelism with fused decode,
    run each decode step's post-attention tail as the ring decomposition
    (ops/collective.fused_tail_overlap), read under the JAX factory's name.
    Off by default; inert without a TP group."""
    return os.environ.get("DYN_COLLECTIVE_OVERLAP", "0") in ("1", "true", "yes")


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


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def _rank_runner(group, spec: dict) -> TorchModelRunner:
    """One rank's runner: its slice of the parameters (cut from ``params``
    when given, else made or loaded layer by layer, each layer cut as soon
    as it exists, so the rest is freed before the KV pool is sized) and its
    KV pool of Hkv / tp heads."""
    cfg = spec["cfg"]
    rank, tp = group.rank, group.world_size
    dev = group.device

    def shard(name, w):
        return shard_leaf(name, w, rank, tp)

    if spec["params"] is not None:
        full = spec["params"]
        params = {k: _to(shard(k, v), dev) for k, v in full.items() if k != "layers"}
        params["layers"] = [{k: _to(shard(k, v), dev) for k, v in layer.items()}
                            for layer in full["layers"]]
    else:
        params = load_or_init_params(spec["model_dir"], cfg, seed=spec["seed"], device=dev,
                                     dtype=spec["dtype"], quantize=spec["quantize"], shard=shard)
    return TorchModelRunner(cfg, params, device=dev, group=group, **spec["runner"])


def _follower_main(rank: int, world: int, method: str, backend: str, devices,
                   spec: dict) -> None:
    """A follower rank's process: join the group, build the rank's runner,
    replay the leader's calls until it stops (or is lost)."""
    group = TPGroup(rank, world, init_method=method, backend=backend, devices=devices,
                    timeout_s=TP_TIMEOUT_S)
    try:
        follower_loop(_rank_runner(group, spec), SpmdStepChannel(group))
    except LeaderLostError as e:
        # the group is broken: leave at once, without its teardown (which
        # would wait for the lost leader)
        print(f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)
        os._exit(3)
    group.close()


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
    tensor_parallel_size: int = 1,
    tp_backend: Optional[str] = None,
    tp_devices=None,
    collective_overlap: Optional[bool] = None,
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

    Tensor parallelism: ``tensor_parallel_size`` N > 1 (or a
    ``tp_backend`` given with N = 1: a one-rank group) serves the model
    across N rank processes, this one the leader (see the module
    docstring). ``tp_devices`` places the ranks (default: ``cuda:r`` for
    rank r, or every rank on the CPU when ``device`` is the CPU; a list,
    e.g. ``["cuda:0", "cuda:0"]``, puts two ranks on one card) and
    ``tp_backend`` is the collectives' backend (default NCCL on cards,
    gloo on the CPU); each collective and the rendezvous time out after
    ``TP_TIMEOUT_S``. Each rank keeps the Megatron slice of the weights and a KV
    pool of Hkv / N heads (sized per rank; ranks sharing a card need
    ``num_blocks``). ``params`` given must then lie on the CPU: each rank
    copies its slice to its device. ``collective_overlap`` (default
    ``DYN_COLLECTIVE_OVERLAP``) runs the fused decode step's tail as the
    ring decomposition. Spec decode under tensor parallelism is not ported
    yet: ``spec_k`` > 0 with a group raises ValueError.

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
    if collective_overlap is None:
        collective_overlap = collective_overlap_from_env()
    spec = spec_decode_settings()
    if spec_k is not None:
        spec["spec_k"] = spec_k
    if spec_min_coverage is not None:
        spec["spec_min_coverage"] = spec_min_coverage
    tp = tensor_parallel_size
    grouped = tp > 1 or tp_backend is not None
    if grouped:
        if spec["spec_k"] > 0:
            raise ValueError(
                f"spec decode (spec_k={spec['spec_k']}) under tensor parallelism "
                f"(tensor_parallel_size={tp}) is not ported yet"
            )
        check_shardable(cfg, tp)
        if tp_devices is None and torch.device(device).type == "cpu":
            tp_devices = "cpu"
        devs = rank_devices(tp, tp_devices)
        on_card = devs[0].type == "cuda"
        if tp_backend is None:
            tp_backend = "nccl" if on_card else "gloo"
        if params is not None and params["embed"].device.type != "cpu":
            raise ValueError("params given to a tensor-parallel engine must lie on the CPU")
    else:
        on_card = torch.device(device).type == "cuda"
    if on_card:
        problems = card_shape_problems(cfg, fused_decode, tp)
        if problems:
            raise ValueError(
                "the card's kernels do not take this model's shapes: " + "; ".join(problems)
            )
    dev = resolve_device(devs[0] if grouped else device)
    max_len = min(max_model_len or cfg.max_position_embeddings, cfg.max_position_embeddings)
    if num_blocks is None:
        num_blocks = default_num_blocks(
            cfg, max_len, max_batch, block_size=kv_block_size,
            budget_bytes=device_memory_bytes(dev),
            dtype_bytes=torch.empty((), dtype=dtype).element_size(),
            quantized=quantize, kv_dtype=kv_dtype, tp=tp,
        )
    runner_kw = dict(
        num_blocks=num_blocks, block_size=kv_block_size, max_batch=max_batch,
        max_model_len=max_len, rng_seed=seed, fused_decode=fused_decode,
        prefill_chunk_tokens=prefill_chunk_tokens, kv_dtype=kv_dtype,
    )
    if grouped:
        runner = _build_tp_runner(
            tp, tp_backend, tp_devices, on_card,
            dict(cfg=cfg, params=params, model_dir=model_dir, seed=seed, dtype=dtype,
                 quantize=quantize,
                 runner=dict(runner_kw, collective_overlap=collective_overlap)),
        )
    else:
        if params is None:
            params = load_or_init_params(model_dir, cfg, seed=seed, device=dev, dtype=dtype,
                                         quantize=quantize)
        runner = TorchModelRunner(cfg, params, device=dev, **runner_kw)
    return TorchEngine(
        runner,
        TorchEngineConfig(
            max_batch=max_batch, block_size=kv_block_size, num_blocks=num_blocks,
            max_model_len=max_len, rng_seed=seed, chunk_budget=chunking.chunk_budget,
            mixed_step=chunking.mixed_step, **spec,
        ),
    )


def _build_tp_runner(tp, backend, devices, on_card, spec) -> SpmdModelRunner:
    """The leader's side of a tensor-parallel engine: every kernel library
    built first (one nvcc per source, here, so N ranks do not build N
    times), the followers spawned, this process joined as rank 0, its
    runner wrapped to replay on them."""
    if on_card:
        from dynamo_tpu_torch.ops import _build

        _build.build_all()
    ctx = mp.get_context("spawn")
    method = init_method(free_port())
    procs = [
        ctx.Process(target=_follower_main, daemon=True,
                    args=(r, tp, method, backend, devices, spec))
        for r in range(1, tp)
    ]
    for p in procs:
        p.start()
    group = None
    try:
        group = TPGroup(0, tp, init_method=method, backend=backend, devices=devices,
                        timeout_s=TP_TIMEOUT_S)
        runner = _rank_runner(group, spec)
    except BaseException:
        for p in procs:
            p.kill()
        if group is not None:
            group.close()
        raise
    return SpmdModelRunner(runner, SpmdStepChannel(group), procs)
