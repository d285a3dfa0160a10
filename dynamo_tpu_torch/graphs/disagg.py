"""Disaggregated serving graph: frontend + decode workers + prefill fleet.

Launch:  python -m dynamo_tpu_torch.serve dynamo_tpu_torch.graphs.disagg

The port's own copy of dynamo_tpu/graphs/disagg.py (the reference's
examples/llm/graphs/disagg.py): decode workers ship prompts longer than
``DYN_MAX_LOCAL_PREFILL`` (8) tokens to the fabric's prefill queue while it
holds fewer than ``DYN_MAX_PREFILL_QUEUE`` (100) requests; prefill workers
dequeue them, compute the KV and stream the blocks back; a decode worker
waits ``DYN_PREFILL_TIMEOUT_S`` (30) s for a remote prefill before it
prefills locally, and a request unacked by a dead prefill worker is
redelivered to another. The thresholds are live (``disagg/router.py``).
Engines come from ``graphs/common.build_engine_from_env``;
``DYN_GRAPH_ENGINE`` defaults to ``tiny-torch`` (every process the same
seeded weights) on ``DYN_DEVICE`` (default ``cuda``; ``cpu`` for the CPU),
or ``torch`` with ``DYN_MODEL_PATH``.

A prefill worker prints ``{"prefill_worker": {"pid": ...}}`` once it pulls
from the queue. Each worker prints one JSON line of its disaggregation
counters on SIGUSR1 (``{"disagg_stats": ...}``) and at exit
(``{"disagg_exit_stats": ...}``), with its role and pid: the engine's kernel
launches, its captured graphs' replays, and the KV data plane's frames and
bytes (``TransferStats``); on a decode worker also its remote prefills and
local fallbacks. ``DYN_HBM_GB`` sizes each engine's KV pool from that many
GiB instead of the whole card, as in the JAX factory, so the workers share
one card.
"""

from __future__ import annotations

import json
import os
import signal
import sys

from dynamo_tpu_torch.sdk import depends, service


def _ns() -> str:
    return os.environ.get("DYN_NAMESPACE", "dynamo")


async def _build_engine():
    os.environ.setdefault("DYN_GRAPH_ENGINE", "tiny-torch")
    from dynamo_tpu_torch.graphs.common import build_engine_from_env

    return await build_engine_from_env()


def _stats(role: str, engine, transfer) -> dict:
    from dataclasses import asdict

    from dynamo_tpu_torch.run import exit_stats

    s = engine.stats
    graphs = getattr(engine.runner, "graph_stats", dict)()
    return {
        "role": role, "pid": os.getpid(), **exit_stats(engine),
        "transfer": asdict(transfer.stats),
        # each captured graph's replays and the launches one replay makes
        "graphs": {k: {"replays": g["replays"], "launches": g["launches"]}
                   for k, g in graphs.items()},
        **{k: getattr(s, k) for k in (
            "remote_prefills", "remote_fallbacks", "prefills_served", "kv_frames_tx",
            "kv_frames_rx", "kv_wire_bytes_tx", "kv_wire_bytes_rx", "kv_bytes_overlapped",
            "prefill_dropped_expired")},
    }


def _emit(obj: dict) -> None:
    """One JSON line in one write: the graph's workers share their
    supervisor's output, and a line written in pieces could be split by
    another worker's."""
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def _print_stats_on_sigusr1(role: str, engine, transfer) -> None:
    import asyncio

    asyncio.get_running_loop().add_signal_handler(signal.SIGUSR1, lambda: _emit(
        {"disagg_stats": _stats(role, engine, transfer)}))


@service(name="PrefillWorker", replicas=1)
class PrefillWorker:
    async def serve(self, runtime) -> None:
        from dynamo_tpu_torch.disagg.transfer import PrefillWorkerService
        from dynamo_tpu_torch.runtime.fencing import make_stamp

        engine, _mdc = await _build_engine()
        # the prefill worker's own track on an assembled trace
        engine.trace_proc = f"PrefillWorker:{runtime.primary_lease & 0xFFFFFF:x}"
        svc = PrefillWorkerService(
            runtime.fabric, _ns(), engine,
            stamp=make_stamp(runtime.primary_lease, runtime.fencing_epoch),
        )
        await svc.start()
        _print_stats_on_sigusr1("prefill", engine, svc)
        _emit({"prefill_worker": {"pid": os.getpid(), "namespace": _ns()}})
        try:
            await runtime.token.cancelled()  # exits on fabric loss too
        finally:
            await svc.close()
            _emit({"disagg_exit_stats": _stats("prefill", engine, svc)})
            await engine.close()


@service(name="DecodeWorker", replicas=1)
class DecodeWorker:
    prefill = depends(PrefillWorker)

    async def serve(self, runtime) -> None:
        from dynamo_tpu_torch.disagg.router import DisaggConfig, DisaggregatedRouter
        from dynamo_tpu_torch.disagg.transfer import RemotePrefillClient
        from dynamo_tpu_torch.entrypoint.inputs import EngineConfig, run_endpoint

        engine, mdc = await _build_engine()
        client = RemotePrefillClient(
            runtime.fabric, _ns(),
            block_size=engine.config.block_size,
            timeout=float(os.environ.get("DYN_PREFILL_TIMEOUT_S", "30")),
            fences=await runtime.fences(),
        )
        await client.start()
        router = DisaggregatedRouter(
            DisaggConfig(
                max_local_prefill_length=int(os.environ.get("DYN_MAX_LOCAL_PREFILL", "8")),
                max_prefill_queue_size=int(os.environ.get("DYN_MAX_PREFILL_QUEUE", "100")),
            ),
            namespace=_ns(), fabric=runtime.fabric,
        )
        await router.start_watching()
        engine.disagg_router = router
        engine.remote_prefill_client = client
        _print_stats_on_sigusr1("decode", engine, client)
        config = EngineConfig.static_(engine, mdc)
        try:
            await run_endpoint(
                runtime, config, os.environ.get("DYN_ENDPOINT", "dynamo.backend.generate"))
        finally:
            await router.close()
            await client.close()
            _emit({"disagg_exit_stats": _stats("decode", engine, client)})
            await engine.close()


@service(name="Frontend")
class Frontend:
    decode = depends(DecodeWorker)

    async def serve(self, runtime) -> None:
        from dynamo_tpu_torch.entrypoint.inputs import EngineConfig, run_http
        from dynamo_tpu_torch.pipeline.router import RouterMode

        config = EngineConfig.dynamic(
            RouterMode(os.environ.get("DYN_ROUTER_MODE", "round_robin"))
        )
        service = await run_http(
            config,
            host=os.environ.get("DYN_HTTP_HOST", "0.0.0.0"),
            port=int(os.environ.get("DYN_HTTP_PORT", "8080")),
            drt=runtime,
        )
        try:
            await runtime.token.cancelled()  # exits on fabric loss too
        finally:
            await service.close()
            await service.watcher.stop()
