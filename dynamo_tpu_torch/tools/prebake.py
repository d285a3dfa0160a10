"""Prebake: build the kernel libraries and drive the serve-shape dispatches
before any traffic arrives.

The port's own twin of tools/prebake_cache.py. In place of the reference's
persistent XLA cache, the port's first-use cost is ``nvcc``: each CUDA
library takes seconds to minutes to build. This tool builds every library
into the kernel-cache directory (``DYN_KERNEL_CACHE_DIR``, else
``build/kernels``; runtime/config.py), where every later process on the
machine finds it already built, then drives the runner's dispatches with
null inputs at the serve shapes -- prefill per bucket, packed, chunked and
the mixed steps, decode (plain and EOS-masked), the decode horizon, and
spec verify with ``--spec-k`` -- so every kernel is launched once and, on a
card, the decode graphs are captured. It writes the reference's manifest
(telemetry/goodput.py) into the cache directory, with the libraries (built
or found, and the seconds) and the graph keys captured.

CUDA graphs do not persist across processes: a serving process captures
its own on its first dispatch at each shape. What a prebake buys is that no
serving process waits for ``nvcc``.

    DYN_KERNEL_CACHE_DIR=/srv/dynamo/kernels \\
        python -m dynamo_tpu_torch.tools.prebake --model-path /models/llama3-8b \\
        --max-batch 8 --decode-horizon 4

``--tiny`` prebakes the tiny test model on the CPU (``--device cpu``): no
kernel is built there, and the manifest says so. ``DYN_KV_DTYPE``,
``DYN_FUSED_DECODE`` and ``DYN_JAX_QUANTIZE_INT8`` are read as the factory
reads them.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def _build_engine(args):
    import dataclasses

    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.models.llama import LlamaConfig

    if args.tiny:
        # the serve graphs' tiny model (graphs/common.py): a head_dim the
        # card's kernels take
        config = dataclasses.replace(LlamaConfig.tiny(vocab_size=64), head_dim=64)
        max_len = args.context_length or 512
    else:
        config = args.model_path
        max_len = args.context_length
    return build_torch_engine(
        config, device=args.device, kv_block_size=args.kv_block_size,
        max_batch=args.max_batch, num_blocks=args.num_blocks, max_model_len=max_len,
        decode_horizon=args.decode_horizon, spec_k=args.spec_k,
        tensor_parallel_size=args.tp,
    )


def _build_kernels(device: str) -> dict:
    """Every CUDA library in the cache directory: {"dir", "nvcc_runs",
    "libraries": {name: {"cache_hit", "seconds"}}}; nothing on the CPU."""
    import torch

    from dynamo_tpu_torch.ops import _build
    from dynamo_tpu_torch.runtime.config import kernel_cache_dir

    if torch.device(device).type != "cuda":
        return {"dir": kernel_cache_dir(), "built": False,
                "reason": "no kernel is built for the CPU (its ops are the plain versions)"}
    runs = _build.nvcc_runs
    t0 = time.perf_counter()
    info = _build.build_all()
    libs = {name: {"cache_hit": rec["seconds"] == 0.0 and not rec["ptxas"],
                   "seconds": round(rec["seconds"], 3)}
            for name, rec in info.items() if name in _build.SOURCES}
    for name in _build.SOURCES:
        _build.load(name)  # the process's first use: loaded here, not under traffic
    return {"dir": kernel_cache_dir(), "built": True, "nvcc_runs": _build.nvcc_runs - runs,
            "seconds": round(time.perf_counter() - t0, 3), "libraries": libs}


def prebake(args) -> dict:
    import torch

    from dynamo_tpu_torch.ops.sampling import MAX_EOS_IDS
    from dynamo_tpu_torch.runtime.config import kernel_cache_dir
    from dynamo_tpu_torch.telemetry.goodput import write_prebake_manifest

    cache_dir = kernel_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    kernels = _build_kernels(args.device)
    engine = _build_engine(args)
    runner = engine.runner
    bs = runner.block_size
    B = runner.max_batch
    baked: list[tuple[str, float]] = []

    def bake(label, fn):
        t0 = time.perf_counter()
        fn()
        if runner.device.type == "cuda":
            torch.cuda.synchronize(runner.device)
        baked.append((label, round(time.perf_counter() - t0, 3)))
        print(f"  baked {label}: {baked[-1][1]}s", flush=True)

    def key():
        return runner._next_key_data()

    no_eos = np.full(MAX_EOS_IDS, -1, np.int64)
    # one scratch table per lane, block 0 the null block
    nb_seq = runner.max_blocks_per_seq
    tables = np.zeros((B, nb_seq), np.int32)
    tables[:, 0] = 1
    for bucket in runner.prefill_buckets:
        ids = list(range(1, bucket // bs + 1))
        bake(f"prefill@{bucket}",
             lambda b=bucket, i=ids: runner.prefill([1] * (b - 1), i, 0.0, 1.0, 0))
    C = runner.prefill_chunk_tokens
    if C:
        pack = runner.pack_prefill([([1, 2, 3], [1], 0.0, 1.0, 0, 1.0, key(), no_eos, False)])
        bake("prefill_packed", lambda: runner.prefill_packed_arrays(**pack))
        bake("prefill_chunk", lambda: runner.prefill_chunk(
            [1] * min(C, bs), 0, bs + 1, [1, 2], 0.0, 1.0, 0))
        # one mixed step per chunk-slot count, up to the engine's
        K = engine._mixed_max_slots if engine._mixed_enabled else 0
        chunk = ([1] * min(C, bs), 0, bs + 1, [1, 2], 0.0, 1.0, 0, 1.0, None, no_eos, False)
        for k in range(1, K + 1):
            bake(f"mixed_step@c{k}", lambda n=k: runner.mixed_step(
                [chunk] * n, np.zeros(B, np.int64), np.zeros(B, np.int64), tables,
                np.zeros(B, np.int64), runner._next_decode_keys(B), np.zeros(B, np.float32),
                np.ones(B, np.float32), np.zeros(B, np.int64),
                eos_ids=np.full((B, MAX_EOS_IDS), -1, np.int64),
                eos_suppress=np.zeros(B, bool)))
    zeros_i = np.zeros(B, np.int64)
    zeros_f = np.zeros(B, np.float32)
    ones_f = np.ones(B, np.float32)
    bake("decode", lambda: runner.decode(zeros_i, zeros_i, tables, zeros_i, zeros_f, ones_f,
                                         zeros_i))
    bake("decode_eos", lambda: runner.decode(
        zeros_i, zeros_i, tables, zeros_i, zeros_f, ones_f, zeros_i,
        eos_mask=(np.full((B, MAX_EOS_IDS), -1, np.int64), np.zeros(B, bool))))
    H = engine.config.decode_horizon
    if H > 1:
        bake(f"decode_multi@H{H}", lambda: runner.decode_multi(
            H, zeros_i, zeros_i, tables, zeros_f, ones_f, zeros_i,
            runner._next_decode_keys(B), np.zeros(B, bool), np.ones(B, np.int64), zeros_i,
            np.full((B, MAX_EOS_IDS), -1, np.int64)))
    k = engine.config.spec_k
    if k > 0:
        bake(f"spec_verify@k{k}", lambda: runner.spec_verify(
            k, 0, zeros_i, np.full((B, k), -1, np.int64), zeros_i, zeros_i, tables,
            zeros_f, ones_f, zeros_i, runner._next_decode_keys(B), np.zeros(B, bool),
            np.ones(B, np.int64), zeros_i, np.full((B, MAX_EOS_IDS), -1, np.int64)))
    graphs = sorted(runner.graph_stats())
    width = max(len(lbl) for lbl, _ in baked)
    print(f"\n  {'program':<{width}}  seconds")
    for lbl, secs in sorted(baked, key=lambda p: -p[1]):
        print(f"  {lbl:<{width}}  {secs:7.3f}")
    print(f"  {'TOTAL':<{width}}  {sum(t for _, t in baked):7.3f}")
    manifest = write_prebake_manifest(cache_dir, baked, {"kernels": kernels, "graphs": graphs})
    if manifest:
        print(f"  manifest: {manifest}")
    import asyncio

    asyncio.run(engine.close())
    return {
        "cache_dir": cache_dir,
        "kernels": kernels,
        "graphs": graphs,
        "programs": baked,
        "manifest": manifest,
        "total_s": round(sum(t for _, t in baked), 3),
    }


def main(argv=None) -> dict:
    from dynamo_tpu_torch.engine.torch_engine.factory import spec_decode_settings

    ap = argparse.ArgumentParser(
        description="build the CUDA kernel libraries into DYN_KERNEL_CACHE_DIR and drive the "
                    "serve-shape dispatches once, ahead of serving")
    ap.add_argument("--model-path", default=None,
                    help="HF model dir, .gguf file or a repo id in the local HF cache")
    ap.add_argument("--tiny", action="store_true", help="prebake the tiny test model instead")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--kv-block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=None)
    ap.add_argument("--context-length", type=int, default=None)
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel ranks (no graphs)")
    ap.add_argument("--decode-horizon", type=int, default=None)
    ap.add_argument("--spec-k", type=int, default=spec_decode_settings()["spec_k"])
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not args.tiny and not args.model_path:
        ap.error("--model-path or --tiny required")
    if args.tiny and args.num_blocks is None:
        args.num_blocks = 128
    t0 = time.perf_counter()
    doc = prebake(args)
    doc["wall_s"] = round(time.perf_counter() - t0, 3)
    print(json.dumps(doc))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
    return doc


if __name__ == "__main__":
    main()
