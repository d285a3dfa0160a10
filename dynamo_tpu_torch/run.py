"""`python -m dynamo_tpu_torch.run` — the port's serving CLI.

The port's own copy of dynamo_tpu/run.py for its one engine:

    python -m dynamo_tpu_torch.run in=http out=torch --model-path <HF dir> \\
        [--model-name NAME] [--http-host 0.0.0.0] [--http-port 8080] \\
        [--kv-block-size 16] [--context-length N] [--num-blocks N] \\
        [--max-batch 8] [--request-template FILE] [--device cuda|cpu] \\
        [--tensor-parallel-size N]

in  = http | text | batch:FILE.jsonl
out = torch  (TorchEngine from build_torch_engine(<dir>); a directory with
      config.json and no *.safetensors serves seeded random weights)

The engine runs on the card; ``--device cpu`` runs it on the CPU, and only
when asked for: without a card and without that flag the command raises.
``--tensor-parallel-size N`` (the reference's flag, dynamo_tpu/run.py:55)
serves the model across N rank processes, rank r on ``cuda:r`` over NCCL
(on the CPU over gloo); ``DYN_FUSED_DECODE`` / ``DYN_COLLECTIVE_OVERLAP``
pick the fused heads and the ring tail as in the reference.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import sys
from typing import Optional


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="dynamo_tpu_torch.run", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("inout", nargs="*", help="in=... out=...")
    parser.add_argument("--model-path", default=None)
    parser.add_argument("--model-name", default=None)
    parser.add_argument("--http-port", type=int, default=8080)
    parser.add_argument("--http-host", default="0.0.0.0")
    parser.add_argument("--kv-block-size", type=int, default=16)
    parser.add_argument("--context-length", type=int, default=None)
    parser.add_argument(
        "--num-blocks", type=int, default=None,
        help="KV cache blocks (default: sized to the device memory)",
    )
    parser.add_argument("--max-batch", type=int, default=8)
    parser.add_argument(
        "--request-template", default=None,
        help="JSON file with default model/temperature/max_completion_tokens "
        "applied to requests that omit them",
    )
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument(
        "--tensor-parallel-size", type=int, default=1,
        help="rank processes to shard the model across (rank r on cuda:r)",
    )
    args = parser.parse_args(argv)
    args.in_opt = "http"
    args.out_opt = "torch"
    for tok in args.inout:
        if tok.startswith("in="):
            args.in_opt = tok[3:]
        elif tok.startswith("out="):
            args.out_opt = tok[4:]
        elif args.model_path is None:
            args.model_path = tok
    return args


def build_config(args: argparse.Namespace):
    """The engine and model card ``out=torch`` serves."""
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.entrypoint.inputs import EngineConfig
    from dynamo_tpu_torch.model_card import ModelDeploymentCard

    if args.out_opt != "torch":
        raise SystemExit(f"unknown out={args.out_opt} (the port serves out=torch)")
    if not args.model_path:
        raise SystemExit("out=torch requires a --model-path (HF dir)")
    engine = build_torch_engine(
        args.model_path,
        device=args.device,
        kv_block_size=args.kv_block_size,
        max_batch=args.max_batch,
        num_blocks=args.num_blocks,
        max_model_len=args.context_length,
        tensor_parallel_size=args.tensor_parallel_size,
    )
    mdc = ModelDeploymentCard.from_model_dir(
        args.model_path,
        args.model_name or args.model_path,
        kv_block_size=args.kv_block_size,
        context_length=engine.config.max_model_len,
    )
    config = EngineConfig.static_(engine, mdc)
    if args.request_template:
        from dynamo_tpu_torch.request_template import RequestTemplate

        config.request_template = RequestTemplate.load(args.request_template)
    return config


def exit_stats(engine) -> dict:
    """What the engine did in this process: each kernel's launches, tokens
    generated, and lanes / KV blocks still held (0 / all free when every
    request was finished or cancelled)."""
    from dynamo_tpu_torch.ops import kernels
    from dynamo_tpu_torch.parallel.multihost import SpmdModelRunner

    ranks = {}
    if isinstance(engine.runner, SpmdModelRunner):  # every rank's, in rank order
        ranks["rank_kernel_launches"] = [r["launches"] for r in engine.runner.rank_stats()]
    return {
        **ranks,
        "kernel_launches": kernels.launch_counts(),
        "generated_tokens": engine.stats.generated_tokens,
        "busy_lanes": sum(s is not None for s in engine.slots),
        "free_blocks": engine.allocator.free_count,
        "num_blocks": engine.config.num_blocks,
    }


async def amain(args: argparse.Namespace) -> None:
    from dynamo_tpu_torch.entrypoint.inputs import run_input

    config = build_config(args)
    try:
        await run_input(args.in_opt, config, args.http_port, args.http_host)
    finally:
        print(json.dumps({"exit_stats": exit_stats(config.engine)}), flush=True)
        await config.engine.close()


def main(argv: Optional[list[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    args = parse_args(argv)
    try:
        asyncio.run(amain(args))
    except KeyboardInterrupt:
        print("\ninterrupted", file=sys.stderr)


if __name__ == "__main__":
    main()
