"""Multimodal serving graph: frontend + encode worker + LLM worker.

Launch:  python -m dynamo_tpu_torch.serve dynamo_tpu_torch.graphs.multimodal

The port's own copy of dynamo_tpu/graphs/multimodal.py (the reference's
examples/multimodal agg topology, Frontend -> Processor -> [EncodeWorker,
Worker]): an encode worker owns the vision tower; the LLM worker (a
``TorchEngine`` from ``graphs/common.build_engine_from_env``, so
``DYN_GRAPH_ENGINE`` / ``DYN_MODEL_PATH`` / ``DYN_DEVICE`` as in the other
graphs; ``tiny-torch`` by default) wrapped in a ``MultimodalEngine`` asks
for embeddings over the fabric wire (a same-process deployment builds the
``MultimodalEngine`` over the ``EncodeWorker`` itself: the device path).

The tower: ``DYN_MM_VIT=clip-l-336`` is CLIP ViT-L/14-336's shape (LLaVA-1.5:
336 px, patch 14, 576 patches, hidden 1024, 24 layers, 16 heads), else the
reference's small default; ``DYN_MM_OUT_DIM`` (default 64, the tiny model's
hidden) must equal the language model's hidden size. Its weights are random
from seed 7, on ``DYN_DEVICE`` (default the card). The worker's
placeholder is ``DYN_MM_PLACEHOLDER`` (0), its span ``DYN_MM_PATCHES``
(default the tower's patch count) and a clip's frames
``DYN_MM_VIDEO_FRAMES`` (8). Every torch import happens off the event
loops, which keep the fabric leases alive.
"""

from __future__ import annotations

import asyncio
import json
import os

from dynamo_tpu_torch.sdk import depends, service

# CLIP ViT-L/14 at 336 px, LLaVA-1.5's tower
CLIP_L_336 = dict(image_size=336, patch_size=14, hidden_size=1024, num_layers=24,
                  num_heads=16, mlp_ratio=4)


def _encode_endpoint() -> str:
    return os.environ.get("DYN_ENCODE_ENDPOINT", "dynamo.encoder.encode")


def vit_shape() -> dict:
    """The tower's ``ViTConfig`` fields from the environment (plain ints:
    reading them needs no torch)."""
    shape = dict(CLIP_L_336) if os.environ.get("DYN_MM_VIT") == "clip-l-336" else {}
    shape["out_dim"] = int(os.environ.get("DYN_MM_OUT_DIM", "64"))
    return shape


def _num_patches(shape: dict) -> int:
    return (shape.get("image_size", 64) // shape.get("patch_size", 16)) ** 2


@service(name="EncodeWorker", replicas=1)
class EncodeWorkerService:
    async def serve(self, runtime) -> None:
        def build():
            # torch, the parameters and the card take seconds: off the loop
            import torch

            from dynamo_tpu_torch.multimodal.encode_worker import EncodeWorker
            from dynamo_tpu_torch.multimodal.vision import ViTConfig, init_vit_params

            cfg = ViTConfig(**vit_shape())
            params = init_vit_params(cfg, torch.Generator().manual_seed(7),
                                     device=os.environ.get("DYN_DEVICE", "cuda"))
            return EncodeWorker(params, cfg)

        worker = await asyncio.get_running_loop().run_in_executor(None, build)
        svc = await worker.serve(runtime, _encode_endpoint())
        try:
            await svc.wait()
        finally:
            await svc.stop(drain=False)


@service(name="Worker", replicas=1)
class Worker:
    encoder = depends(EncodeWorkerService)

    async def serve(self, runtime) -> None:
        from dynamo_tpu_torch.entrypoint.inputs import EngineConfig, run_endpoint
        from dynamo_tpu_torch.graphs.common import build_engine_from_env
        from dynamo_tpu_torch.multimodal.encode_worker import EncodeClient
        from dynamo_tpu_torch.multimodal.worker import MultimodalEngine

        os.environ.setdefault("DYN_GRAPH_ENGINE", "tiny-torch")
        engine, mdc = await build_engine_from_env()
        client = EncodeClient(runtime, _encode_endpoint())
        mm_engine = MultimodalEngine(
            engine, client,
            placeholder_id=int(os.environ.get("DYN_MM_PLACEHOLDER", "0")),
            num_patches=int(os.environ.get("DYN_MM_PATCHES", str(_num_patches(vit_shape())))),
            # a clip's span is frames * patches placeholder positions; it
            # must leave the prompt room inside the engine's max_model_len
            video_frames=int(os.environ.get("DYN_MM_VIDEO_FRAMES", "8")),
        )
        try:
            await run_endpoint(runtime, EngineConfig.static_(mm_engine, mdc),
                               os.environ.get("DYN_ENDPOINT", "dynamo.backend.generate"))
        finally:
            await client.close()
            close = getattr(engine, "close", None)
            if close is not None:
                await close()


@service(name="Frontend")
class Frontend:
    workers = depends(Worker)

    async def serve(self, runtime) -> None:
        from dynamo_tpu_torch.entrypoint.inputs import EngineConfig, run_http

        service = await run_http(
            EngineConfig.dynamic(),
            host=os.environ.get("DYN_HTTP_HOST", "0.0.0.0"),
            port=int(os.environ.get("DYN_HTTP_PORT", "8080")),
            drt=runtime,
        )
        try:
            await runtime.token.cancelled()  # exits on fabric loss too
        finally:
            await service.close()
            await service.watcher.stop()
            from dynamo_tpu_torch.run import frontend_stats

            print(json.dumps({"exit_stats": frontend_stats(service)}), flush=True)
