"""Engine factory: model config (or HF model dir) -> TorchEngine.

Counterpart of dynamo_tpu/engine/jax_engine/factory.py (``build_jax_engine``
:26-209, ``default_num_blocks`` :411, ``kv_dtype_from_env``,
``fused_decode_from_env``, ``collective_overlap_from_env`` and
``spec_decode_settings`` :271-320, ``default_lazy_horizon`` /
``default_decode_horizon`` :323-344, the ``DYN_JAX_QUANTIZE_INT8`` read at
:80-82, the ``DYN_HBM_GB`` budget of ``hbm_budget_bytes`` :393-407), with
the JAX factory's default admission path: chunked, packed and mixed-step
prefill, and its default decode horizon on the accelerator.

The parallel configurations (the reference's mesh and sharding, :26-163):
``tensor_parallel_size``, ``data_parallel_size``, ``context_parallel_size``
and ``expert_parallel_size`` make a rank grid dp x sp x ep x tp
(parallel/mesh.py). On one node this process becomes rank 0, the leader,
and spawns the other ranks as follower processes (``torch.multiprocessing``,
spawn, rendezvous on a free local port); each rank builds its own slice of
the same seeded or loaded parameters and its own KV pool, and the leader's
engine drives every rank through parallel/multihost.SpmdModelRunner.
Closing the engine stops the followers. With ``multinode`` (num_nodes > 1)
each node is one rank process: the nodes meet through the fabric barrier
(or a static ``leader_addr``, parallel/multinode.py), the leader gets the
engine, and every other node a ``FollowerHandle`` to serve.

The tiered block manager (``_maybe_block_manager``, the JAX factory's
:212-270): ``DYN_KV_HOST_OFFLOAD_GB`` > 0 gives the engine a host tier of
that many GiB in whole blocks of its own KV block size (pinned on a card),
``DYN_KV_DISK_DIR`` a disk tier capped at ``DYN_KV_DISK_GB`` (0: no cap);
``DYN_KV_WIRE=int8`` stores the tiers quantized, and an int8-resident cache
forces int8 tiers (its pages move verbatim). Unset, there is none.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import os
import sys
from typing import Optional, Union

import torch
import torch.multiprocessing as mp

from dynamo_tpu_torch.block_manager import LayoutConfig, TieredBlockManager
from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.disagg.protocols import dtype_name, wire_codec_from_env
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
from dynamo_tpu_torch.parallel.mesh import TPGroup, grid_shape, rank_devices
from dynamo_tpu_torch.parallel.multihost import (
    FollowerHandle,
    LeaderLostError,
    SpmdModelRunner,
    SpmdStepChannel,
    follower_loop,
)
from dynamo_tpu_torch.parallel.multinode import (
    MultiNodeConfig,
    rendezvous_and_initialize,
    static_init_method,
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
    """The memory budget one engine sizes its KV pool from: ``DYN_HBM_GB``
    GiB when set (the JAX factory's ``hbm_budget_bytes``, :393-407; e.g.
    several engines sharing one card), else the card's total memory (16 GiB
    assumed for the CPU)."""
    override = os.environ.get("DYN_HBM_GB")
    if override:
        return int(float(override) * 2**30)
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
    reserve_bytes: int = 0,
    ep: int = 1,
) -> int:
    """Blocks for every batch lane at full context plus slack, capped so
    weights + KV fit the device memory budget (the JAX sizing rule,
    factory.py:411-450): int8 weights count the dense parameters at 1 byte
    (an MoE model's experts, never quantized, at ``dtype_bytes`` whatever
    ``quantized`` says, :427-437), an int8 KV cache 1 byte per value plus a
    4-byte scale per (layer, kv head, block) of each of K and V; under
    tensor parallelism of ``tp`` ranks, per rank: the weights divided by
    tp (an MoE model's experts by ep x tp over an ``ep`` axis), the rank's
    Hkv / tp heads per block (ranks sharing a card must pass ``num_blocks``
    themselves). ``reserve_bytes`` more are kept out of the
    budget (the factory's room for the captured graphs' pool; 0 is the JAX
    rule)."""
    per_seq = (max_len + block_size - 1) // block_size
    want = max_batch * per_seq + 64
    dense_params = param_count(dataclasses.replace(config, num_experts=0))
    expert_params = param_count(config) - dense_params
    weight_bytes = (dense_params * (1 if quantized else dtype_bytes)
                    + expert_params * dtype_bytes // ep) // tp
    int8_kv = kv_dtype == "int8"
    heads = config.num_kv_heads // tp
    block_bytes = 2 * (
        config.num_layers * block_size * heads * config.head_dim
        * (1 if int8_kv else dtype_bytes)
        + (4 * config.num_layers * heads if int8_kv else 0)
    )
    budget = int(budget_bytes * utilization) - weight_bytes - reserve_bytes
    return min(want, max(16, budget // block_bytes))


def graph_pool_bytes(config: LlamaConfig, max_batch: int, spec_k: int = 0) -> int:
    """Room for the captured step graphs' shared memory pool: twice the
    transient activations of the widest captured pass (the verify pass's
    max_batch x (spec_k + 1) rows, else the decode step's max_batch), each
    row's layer temporaries counted in f32 -- the QKV and attention rows,
    the residual stream, the FFN's gate / up / product (an MoE layer's
    routed rows k times over, its act scratch and sorted copies) -- plus its
    f32 logits and the sampler's copies of them. An estimate from the
    shapes (the graphs share one pool, whose captures reuse each other's
    freed transients); chip_smoke's serve_horizon and serve_moe log what the
    graphs hold on the card."""
    c = config
    rows = max_batch * (spec_k + 1)
    ffn = c.intermediate_size * 3
    if c.num_experts:
        ffn = c.num_experts_per_tok * (ffn + 2 * c.hidden_size)
    per_row = 4 * (c.q_dim + 2 * c.kv_dim + 4 * c.hidden_size + ffn + 4 * c.vocab_size)
    return 2 * rows * per_row


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


def default_lazy_horizon() -> bool:
    """DYN_LAZY_HORIZON=1: single-step until the horizon's graphs are
    captured (on the engine's device thread, between dispatches). Off by
    default, as in the JAX package."""
    return os.environ.get("DYN_LAZY_HORIZON", "0") in ("1", "true", "yes")


def default_decode_horizon(device) -> int:
    """DYN_DECODE_HORIZON when set, else 4 on a card and 1 on the CPU: the
    JAX package's 4 on its accelerator, 1 elsewhere, mapped onto the
    port's accelerator (so CPU tests single-step unless they ask)."""
    override = os.environ.get("DYN_DECODE_HORIZON")
    if override:
        return max(1, int(override))
    return 4 if torch.device(device).type == "cuda" else 1


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


def _maybe_block_manager(cfg: LlamaConfig, runner: TorchModelRunner) -> Optional[TieredBlockManager]:
    """The host (and disk) tiers the environment asks for, sized in whole
    blocks of the runner's KV block; None when ``DYN_KV_HOST_OFFLOAD_GB``
    is unset or 0."""
    gb = float(os.environ.get("DYN_KV_HOST_OFFLOAD_GB", "0") or 0)
    if gb <= 0:
        return None
    layout = LayoutConfig(num_layers=cfg.num_layers, page_size=runner.block_size,
                          num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                          dtype=dtype_name(runner.kv_logical_dtype))
    codec = "int8" if runner.kv_quantized else wire_codec_from_env()
    block_nbytes = layout.block_nbytes
    if codec == "int8":
        block_nbytes //= layout.itemsize  # int8 mantissas
    host_blocks = max(1, int(gb * 2**30 // block_nbytes))
    disk_dir = os.environ.get("DYN_KV_DISK_DIR") or None
    disk_blocks = 0
    if disk_dir:
        disk_blocks = int(float(os.environ.get("DYN_KV_DISK_GB", "0") or 0) * 2**30 // block_nbytes)
    logger.info("KV offload tiers: host %d blocks (%.2f GiB, codec %s)%s", host_blocks, gb, codec,
                f", disk at {disk_dir} ({disk_blocks or 'unbounded'} blocks)" if disk_dir else "")
    return TieredBlockManager(layout, host_blocks=host_blocks, disk_dir=disk_dir,
                              disk_blocks=disk_blocks, wire_codec=codec,
                              pin_memory=runner.device.type == "cuda")


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
    ep_rank, ep = group.ep.rank, group.ep.world_size
    dev = group.device

    def shard(name, w):
        return shard_leaf(name, w, rank, tp, ep_rank, ep)

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
    """A follower rank's process: join the grid, build the rank's runner,
    replay the leader's calls until it stops (or is lost)."""
    group = TPGroup(rank, world, init_method=method, backend=backend, devices=devices,
                    timeout_s=TP_TIMEOUT_S, idle_timeout_s=spec["idle_timeout_s"],
                    axes=spec["axes"])
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
    tp_idle_timeout_s: float = 86400.0,
    decode_horizon: Optional[int] = None,
    lazy_horizon: Optional[bool] = None,
    cuda_graphs: Optional[bool] = None,
    expert_parallel_size: int = 1,
    data_parallel_size: int = 1,
    context_parallel_size: int = 1,
    multinode: Optional[MultiNodeConfig] = None,
    fabric=None,
    lease_id: int = 0,
) -> Union[TorchEngine, FollowerHandle]:
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
    ring decomposition. A follower gives its leader up after
    ``tp_idle_timeout_s`` without a broadcast; an idle leader sends
    keep-alives four times as often. Spec decode runs under a group too:
    the leader drafts, every rank verifies on its heads.

    The rank grid (the reference's mesh axes, :33-47): with
    ``data_parallel_size`` (dp), ``context_parallel_size`` (sp) and
    ``expert_parallel_size`` (ep) the ranks form a dp x sp x ep x tp grid
    (tp innermost), placed by ``tp_devices`` as above (one entry per rank).
    Over dp the parameters and the cache are replicated (the reference's
    mesh plumbing: serving data parallelism is replicas behind the router);
    over sp a prompt whose bucket is at least the runner's ``cp_min_tokens``
    (512, as the reference runner's) is prefilled context parallel (ring
    attention), the cache replicated; over ep an MoE model's experts are
    split in equal blocks (the all-to-all dispatch for prefill-sized
    batches, the psum form for decode-sized ones), everything else
    replicated. A grid needs ``num_experts`` divisible by ep.

    Multi-node (``multinode``, a ``MultiNodeConfig`` with num_nodes > 1,
    ``DYN_NUM_NODES`` / ``DYN_NODE_RANK`` / ``DYN_LEADER_ADDR``): each node is
    one rank process, node_rank its global rank, and the grid's sizes must
    multiply to num_nodes. The nodes meet through ``fabric``'s barrier
    under ``lease_id`` (the leader's lease must live as long as its engine:
    the followers follow it), or at ``leader_addr`` without a fabric. With a
    fabric this call blocks on the fabric's event loop, so call it from
    another thread (``loop.run_in_executor``). The rank sits on ``device``
    (or ``tp_devices[node_rank]``). The leader (node 0) gets its engine;
    every other node gets a ``parallel.multihost.FollowerHandle``, whose
    ``serve()`` / ``serve_async()`` replays the leader's step channel until
    the leader's engine closes.

    The decode horizon: ``decode_horizon`` (default
    ``default_decode_horizon``: ``DYN_DECODE_HORIZON``, else 4 on a card
    and 1 on the CPU) decode steps chained per dispatch, and
    ``lazy_horizon`` (default ``DYN_LAZY_HORIZON``). ``cuda_graphs``
    (default: on for a card without a group) runs the decode step, the
    horizon and the verify pass as CUDA graphs; False runs them eagerly
    (a group always does; True with a group raises ValueError). With graphs
    the KV pool leaves ``graph_pool_bytes`` of the budget to their pool.

    MoE (a config with ``num_experts``, the Mixtral family): the dropless
    grouped FFN on one card or under tensor parallelism, where each rank
    holds every expert's FFN slice; over an ep axis the expert-parallel
    forms (above).

    On the card, a config whose shapes a kernel of its path would refuse
    raises ValueError here, before any request (and before the card is
    looked for), naming each refusal; nothing falls back to a plain
    version. Every kernel library is built here, before the first request,
    so no dispatch waits for nvcc under the watchdog's budget.

    The tiered block manager comes from ``DYN_KV_HOST_OFFLOAD_GB`` and the
    other knobs of the module docstring; under a tensor-parallel group the
    tiers hold dense pages (every kv head), which the leader gathers from
    and scatters to the ranks."""
    cfg, model_dir = _resolve_config(config)
    tp, ep = tensor_parallel_size, expert_parallel_size
    axes = {"dp": data_parallel_size, "sp": context_parallel_size, "ep": ep, "tp": tp}
    world = data_parallel_size * context_parallel_size * ep * tp
    grid_shape(world, axes)  # raises on a size below 1
    multi = multinode is not None and multinode.num_nodes > 1
    if multi and world != multinode.num_nodes:
        raise ValueError(f"a grid of {world} ranks ({axes}) over {multinode.num_nodes} nodes: "
                         "each node is one rank")
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
    grouped = world > 1 or tp_backend is not None or multi
    if grouped:
        check_shardable(cfg, tp, ep)
        if multi:  # this node's rank alone lives here
            here = (tp_devices[multinode.node_rank] if isinstance(tp_devices, (list, tuple))
                    else tp_devices or device)
            devs = tp_devices = [resolve_device(here)] * world
        else:
            if tp_devices is None and torch.device(device).type == "cpu":
                tp_devices = "cpu"
            devs = rank_devices(world, tp_devices)
        on_card = devs[0].type == "cuda"
        if tp_backend is None:
            tp_backend = "nccl" if on_card else "gloo"
        if params is not None and params["embed"].device.type != "cpu":
            raise ValueError("params given to a parallel engine must lie on the CPU")
    else:
        on_card = torch.device(device).type == "cuda"
    if on_card:
        problems = card_shape_problems(cfg, fused_decode, tp, dtype)
        if problems:
            raise ValueError(
                "the card's kernels do not take this model's shapes: " + "; ".join(problems)
            )
    dev = resolve_device(devs[0] if grouped else device)
    if decode_horizon is None:
        decode_horizon = default_decode_horizon(dev)
    if lazy_horizon is None:
        lazy_horizon = default_lazy_horizon()
    max_len = min(max_model_len or cfg.max_position_embeddings, cfg.max_position_embeddings)
    if num_blocks is None:
        graphed = on_card and not grouped if cuda_graphs is None else cuda_graphs
        num_blocks = default_num_blocks(
            cfg, max_len, max_batch, block_size=kv_block_size,
            budget_bytes=device_memory_bytes(dev),
            dtype_bytes=torch.empty((), dtype=dtype).element_size(),
            quantized=quantize, kv_dtype=kv_dtype, tp=tp, ep=ep,
            reserve_bytes=graph_pool_bytes(cfg, max_batch, spec["spec_k"]) if graphed else 0,
        )
    runner_kw = dict(
        num_blocks=num_blocks, block_size=kv_block_size, max_batch=max_batch,
        max_model_len=max_len, rng_seed=seed, fused_decode=fused_decode,
        prefill_chunk_tokens=prefill_chunk_tokens, kv_dtype=kv_dtype,
    )
    if grouped:
        if cuda_graphs:
            raise ValueError("CUDA graphs are not captured under a tensor-parallel group")
        rank_spec = dict(cfg=cfg, params=params, model_dir=model_dir, seed=seed, dtype=dtype,
                         quantize=quantize, idle_timeout_s=tp_idle_timeout_s, axes=axes,
                         runner=dict(runner_kw, collective_overlap=collective_overlap))
        if multi:
            runner = _join_nodes(world, multinode, fabric, lease_id, tp_backend, tp_devices,
                                 on_card, rank_spec)
            if isinstance(runner, FollowerHandle):
                return runner
        else:
            runner = _build_tp_runner(world, tp_backend, tp_devices, on_card, rank_spec)
    else:
        if params is None:
            params = load_or_init_params(model_dir, cfg, seed=seed, device=dev, dtype=dtype,
                                         quantize=quantize)
        if on_card:
            from dynamo_tpu_torch.ops import _build

            _build.build_all()
        runner = TorchModelRunner(cfg, params, device=dev, cuda_graphs=cuda_graphs, **runner_kw)
    return TorchEngine(
        runner,
        TorchEngineConfig(
            max_batch=max_batch, block_size=kv_block_size, num_blocks=num_blocks,
            max_model_len=max_len, rng_seed=seed, chunk_budget=chunking.chunk_budget,
            mixed_step=chunking.mixed_step, decode_horizon=decode_horizon,
            lazy_horizon=lazy_horizon, **spec,
        ),
        block_manager=_maybe_block_manager(cfg, runner),
    )


def _rendezvous(cfg: MultiNodeConfig, fabric, lease_id: int) -> str:
    """The grid's init address: ``leader_addr`` without a fabric, else the
    fabric barrier's, run on the fabric's event loop from this thread."""
    if fabric is None:
        return static_init_method(cfg)
    coro = rendezvous_and_initialize(cfg, fabric, lease_id)
    loop = fabric.loop
    try:
        running = asyncio.get_running_loop()
    except RuntimeError:
        running = None
    if running is not None and (loop is None or running is loop):
        coro.close()
        raise RuntimeError("build_torch_engine blocks on the fabric's rendezvous: call it off "
                           "the fabric's event loop (e.g. loop.run_in_executor)")
    if loop is None:  # an in-process fabric: no loop of its own
        return asyncio.run(coro)
    return asyncio.run_coroutine_threadsafe(coro, loop).result()


def _join_nodes(world, multinode, fabric, lease_id, backend, devices, on_card, spec):
    """This node's side of a multi-node engine: meet the other nodes, join
    the grid as rank ``node_rank``, build the rank's runner (the kernel
    libraries first); the leader's runner wrapped to replay on the others,
    any other node's handed back as a FollowerHandle."""
    method = _rendezvous(multinode, fabric, lease_id)
    logger.info("multi-node bring-up: node %d/%d at %s", multinode.node_rank,
                multinode.num_nodes, method)
    if on_card:
        from dynamo_tpu_torch.ops import _build

        _build.build_all()
    group = TPGroup(multinode.node_rank, world, init_method=method, backend=backend,
                    devices=devices, timeout_s=TP_TIMEOUT_S,
                    idle_timeout_s=spec["idle_timeout_s"], axes=spec["axes"])
    try:
        runner = _rank_runner(group, spec)
    except BaseException:
        group.close()
        raise
    channel = SpmdStepChannel(group)
    if not multinode.is_leader:
        return FollowerHandle(runner, channel, fabric=fabric)
    return SpmdModelRunner(runner, channel)


def _build_tp_runner(world, backend, devices, on_card, spec) -> SpmdModelRunner:
    """The leader's side of a parallel engine on one node: every kernel
    library built first (one nvcc per source, here, so N ranks do not build
    N times), the followers spawned, this process joined as rank 0, its
    runner wrapped to replay on them."""
    tp = world
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
                        timeout_s=TP_TIMEOUT_S, idle_timeout_s=spec["idle_timeout_s"],
                        axes=spec["axes"])
        runner = _rank_runner(group, spec)
    except BaseException:
        for p in procs:
            p.kill()
        if group is not None:
            group.close()
        raise
    return SpmdModelRunner(runner, SpmdStepChannel(group), procs)
