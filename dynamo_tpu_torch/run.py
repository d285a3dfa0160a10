"""`python -m dynamo_tpu_torch.run` — the port's serving CLI.

The port's own copy of dynamo_tpu/run.py:

    python -m dynamo_tpu_torch.run in=http out=torch --model-path <HF dir> \\
        [--model-name NAME] [--http-host 0.0.0.0] [--http-port 8080] \\
        [--kv-block-size 16] [--context-length N] [--num-blocks N] \\
        [--max-batch 8] [--request-template FILE] [--device cuda|cpu] \\
        [--tensor-parallel-size N] [--router-mode round_robin|random|kv] \\
        [--kv-overlap-score-weight 1.0] [--router-temperature 0.5] \\
        [--no-kv-events] [--endpoint ns.comp.ep]

in  = http | text | batch:FILE.jsonl | dyn://ns.comp.ep (serve the engine as
      a worker of that endpoint; ``in=dyn`` alone serves ``--endpoint``)
out = torch  (TorchEngine from build_torch_engine(<path>); --model-path is a
      directory (config.json and *.safetensors; with no *.safetensors it
      serves seeded random weights), a .gguf file (its weights, config and,
      unless a tokenizer sits beside it, its embedded tokenizer and chat
      template), or a repo id already in the local HF cache
      (DYN_MODEL_CACHE, $HF_HOME/hub, ~/.cache/huggingface/hub; hub.py))
    | dyn  (route to the workers discovery finds, with --router-mode; ``kv``
      sends each request to the worker whose KV cache holds most of its
      prompt, weighed against its load: cost = weight x blocks to prefill +
      predicted blocks held, softmax-sampled at --router-temperature (0 =
      the cheapest); ``--no-kv-events`` indexes the router's own decisions
      for 120 s instead of the workers' KV events)

A distributed deployment (the fabric at ``DYN_FABRIC_ADDR``, which both
roles require: without it a worker would register where no frontend sees it,
so the command refuses to start):

    python -m dynamo_tpu_torch.fabric.server --port 6650 &
    DYN_FABRIC_ADDR=127.0.0.1:6650 python -m dynamo_tpu_torch.run \\
        in=dyn://dynamo.backend.generate out=torch --model-path <dir> --num-blocks N &
    DYN_FABRIC_ADDR=127.0.0.1:6650 python -m dynamo_tpu_torch.run in=http out=dyn \\
        --router-mode kv

A worker publishes its KV events and load metrics for the KV-aware router
(``python -m dynamo_tpu_torch.router`` serves one on its own). The graph
``python -m dynamo_tpu_torch.serve dynamo_tpu_torch.graphs.agg`` starts the
fabric, the workers and the frontend under one supervisor.

The engine is built before the runtime connects and takes its lease, so a
long build cannot starve the lease's keepalive. A worker drains on SIGTERM
(leaves discovery, finishes its requests, checkpoints the tiers under
``DYN_WARM_RESTART_DIR``) and prints its stats (``{"worker_stats": ...}``)
on SIGUSR1; every serving process prints ``{"exit_stats": ...}`` last.

The engine runs on the card; ``--device cpu`` runs it on the CPU, and only
when asked for: without a card and without that flag the command raises.
``--tensor-parallel-size N`` (the reference's flag, dynamo_tpu/run.py:55)
serves the model across N rank processes, rank r on ``cuda:r`` over NCCL
(on the CPU over gloo); ``DYN_FUSED_DECODE`` / ``DYN_COLLECTIVE_OVERLAP``
pick the fused heads and the ring tail as in the reference.

KV offload tiers come from the environment (``DYN_KV_HOST_OFFLOAD_GB``,
``DYN_KV_DISK_DIR``, ``DYN_KV_DISK_GB``, ``DYN_KV_WIRE``: the factory's
module docstring). With ``DYN_WARM_RESTART_DIR`` set, the tiers are
restored from that directory's checkpoint before serving and checkpointed
there again on a clean shutdown (SIGINT / SIGTERM, the end of a batch or
of stdin).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import signal
import sys
from typing import Optional

from dynamo_tpu_torch.pipeline.router import RouterMode


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
    parser.add_argument(
        "--router-mode", choices=[m.value for m in RouterMode if m is not RouterMode.DIRECT],
        default="round_robin",
        help="out=dyn: how requests pick a worker",
    )
    parser.add_argument(
        "--kv-overlap-score-weight", type=float, default=1.0,
        help="KV router: weight on prefill (non-cached) blocks in the cost",
    )
    parser.add_argument(
        "--router-temperature", type=float, default=0.5,
        help="KV router: softmax sampling temperature (0 = argmin)",
    )
    parser.add_argument(
        "--no-kv-events", action="store_true",
        help="KV router: index its own routing decisions (ApproxKvIndexer) instead of events",
    )
    parser.add_argument(
        "--endpoint", default="dynamo.backend.generate",
        help="the endpoint a worker serves when given in=dyn alone",
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
    if args.in_opt == "dyn":
        args.in_opt = "dyn://" + args.endpoint
    elif "." in args.in_opt and not args.in_opt.startswith(("dyn://", "batch:")):
        args.in_opt = "dyn://" + args.in_opt  # ns.comp.ep
    return args


def uses_runtime(args: argparse.Namespace) -> bool:
    """A dyn:// worker and an out=dyn frontend live in a distributed runtime."""
    return args.out_opt == "dyn" or args.in_opt.startswith("dyn://")


def require_fabric(args: argparse.Namespace) -> None:
    """A dyn:// worker or an out=dyn frontend exists to reach other
    processes, so it refuses to start on a process-local fabric."""
    from dynamo_tpu_torch.runtime.config import RuntimeConfig

    if uses_runtime(args) and not RuntimeConfig.from_settings().fabric_addr:
        raise SystemExit(
            f"in={args.in_opt} out={args.out_opt} needs the fabric: set DYN_FABRIC_ADDR=host:port "
            "(python -m dynamo_tpu_torch.fabric.server --port P)"
        )


def build_config(args: argparse.Namespace):
    """The engine and model card ``out=torch`` serves, or the dynamic config of
    ``out=dyn``."""
    from dynamo_tpu_torch.entrypoint.inputs import EngineConfig
    from dynamo_tpu_torch.model_card import ModelDeploymentCard

    if args.out_opt == "dyn":
        if args.in_opt.startswith("dyn://"):
            raise SystemExit("in=dyn:// serves an engine: give it out=torch")
        from dynamo_tpu_torch.kv_router.scheduler import KvRouterConfig

        config = EngineConfig.dynamic(
            RouterMode(args.router_mode),
            kv_router_config=KvRouterConfig(
                overlap_score_weight=args.kv_overlap_score_weight,
                router_temperature=args.router_temperature,
                use_kv_events=not args.no_kv_events,
            ),
        )
        _add_template(config, args)
        return config
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine

    if args.out_opt != "torch":
        raise SystemExit(f"unknown out={args.out_opt} (torch or dyn)")
    from dynamo_tpu_torch.hub import resolve_model

    if not args.model_path:
        raise SystemExit("out=torch requires a --model-path (HF dir, .gguf file or cached repo id)")
    path = resolve_model(args.model_path)
    engine = build_torch_engine(
        path,
        device=args.device,
        kv_block_size=args.kv_block_size,
        max_batch=args.max_batch,
        num_blocks=args.num_blocks,
        max_model_len=args.context_length,
        tensor_parallel_size=args.tensor_parallel_size,
    )
    mdc = ModelDeploymentCard.from_model_path(
        path,
        args.model_name or args.model_path,
        kv_block_size=args.kv_block_size,
        context_length=engine.config.max_model_len,
    )
    config = EngineConfig.static_(engine, mdc)
    _add_template(config, args)
    return config


def _add_template(config, args: argparse.Namespace) -> None:
    if args.request_template:
        from dynamo_tpu_torch.request_template import RequestTemplate

        config.request_template = RequestTemplate.load(args.request_template)


def exit_stats(engine) -> dict:
    """What the engine did in this process: each kernel's launches, tokens
    generated, lanes / KV blocks still held (0 / all free when every
    request was finished or cancelled), the tiers' traffic, the requests
    shed on their deadline, its latest admissions (request id, prompt
    tokens, prefix blocks found in the tiers) and the process's integrity
    counters (checksum failures, quarantined blocks, fenced frames), the
    brownout rung and sheds, the step counts, the phase histograms' counts
    and the injected faults that fired (``DYN_FAULT``), by name."""
    from dynamo_tpu_torch.integrity import COUNTERS
    from dynamo_tpu_torch.ops import kernels
    from dynamo_tpu_torch.parallel.multihost import SpmdModelRunner
    from dynamo_tpu_torch.testing import faults

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
        **{k: getattr(engine.stats, k) for k in (
            "kv_offloaded_blocks", "kv_offload_errors", "kv_onboarded_blocks",
            "kv_onboard_errors", "deadline_exceeded", "shed_brownout", "brownout_level",
            "decode_steps", "verify_steps", "chunk_steps", "graph_replays")},
        # the always-on phase histograms' counts (streams, gaps) by phase
        "phase_counts": {k: h.count for k, h in engine.stats.phase_histograms.phases.items()},
        "phase_p50_ms": {k: h.percentile(50) for k, h in engine.stats.phase_histograms.phases.items()},
        # the health plane's own series (C15): [count, median ms] by name
        "health_series": {k: [h.count, h.percentile(50)]
                          for k, h in engine.stats.health_histograms.phases.items()},
        "admissions": list(engine.admissions),
        "integrity": COUNTERS.snapshot(),
        "faults_fired": dict(faults.get_injector().fired) if faults.active() else {},
    }


async def amain(args: argparse.Namespace) -> None:
    from dynamo_tpu_torch.entrypoint.inputs import run_input

    log = logging.getLogger("dynamo_tpu_torch.run")
    require_fabric(args)
    # the engine first: its build (seconds to minutes) must not run while a
    # lease's keepalive waits on this loop
    config = build_config(args)
    engine = config.engine
    torch_engine = engine is not None and hasattr(engine, "restore_tiers")
    if torch_engine:
        restored = engine.restore_tiers()
        if restored is not None:
            log.info("warm restart: %s", restored)
    drt = None
    if uses_runtime(args):
        from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

        drt = await DistributedRuntime.from_settings()
        if args.in_opt.startswith("dyn://"):
            _worker_signals(drt, engine if torch_engine else None)
    served = None
    try:
        served = await run_input(args.in_opt, config, args.http_port, args.http_host, drt=drt)
    finally:
        if torch_engine:
            print(json.dumps({"exit_stats": exit_stats(engine)}), flush=True)
            if drt is None:  # a worker's drain checkpointed them
                engine.checkpoint_tiers()
            await engine.close()
        elif drt is not None and not args.in_opt.startswith("dyn://"):
            print(json.dumps({"exit_stats": frontend_stats(served)}), flush=True)
        if drt is not None:
            await drt.close()


def frontend_stats(service) -> dict:
    """What a dynamic frontend did: in-flight migrations per model, frames
    refused from fenced workers and, in KV mode, its routers' decisions."""
    from dynamo_tpu_torch.integrity import COUNTERS

    watcher = getattr(service, "watcher", None)
    out = {"migrations": dict(watcher.migrations) if watcher is not None else {},
           "fenced_rejects": dict(COUNTERS.fenced_rejects)}
    if watcher is not None and watcher.kv_routers:
        # KV mode: each endpoint's routing decisions and the blocks its index
        # still holds per worker
        out["kv_routers"] = {ep: {**r.scheduler.hit_stats, "events": r.events_applied,
                                  "index_blocks": {f"{w:x}": n for w, n in
                                                   r.indexer.block_counts().items()}}
                             for ep, r in watcher.kv_routers.items()}
    return out


def _worker_signals(drt, engine) -> None:
    """SIGTERM / SIGINT: drain (leave discovery, finish the requests in
    flight, checkpoint the tiers), then shut down. SIGUSR1: print the
    engine's stats line."""
    loop = asyncio.get_running_loop()
    timeout = float(os.environ.get("DYN_DRAIN_TIMEOUT_S", "10"))

    async def drain_then_stop() -> None:
        await drt.drain(timeout + 5.0)
        drt.shutdown()

    tasks = []  # the loop holds tasks weakly
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, lambda: tasks.append(loop.create_task(drain_then_stop())))
    if engine is not None:
        loop.add_signal_handler(signal.SIGUSR1, lambda: print(
            json.dumps({"worker_stats": exit_stats(engine)}), flush=True))


def main(argv: Optional[list[str]] = None) -> None:
    # DYN_LOG filters, DYN_LOGGING_JSONL=1 for JSON lines (runtime/logging.py)
    from dynamo_tpu_torch.runtime import logging as dlog

    dlog.init(force=True)
    args = parse_args(argv)
    try:
        asyncio.run(amain(args))
    except KeyboardInterrupt:
        print("\ninterrupted", file=sys.stderr)


if __name__ == "__main__":
    main()
