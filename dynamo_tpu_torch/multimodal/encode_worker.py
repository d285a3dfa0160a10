"""Encode worker: the vision tower as a service of its own.

The port's own copy of dynamo_tpu/multimodal/encode_worker.py (the role of
the reference's examples/multimodal encode worker): a worker owns the tower,
and a prefill engine gets embeddings for an image source over one of two
data planes:

- WIRE (across processes): the embeddings ride the fabric as a wire-coded
  array (f32 bytes, or bf16 as uint16 words: the reference's frame, so
  either package's client reads either's worker), the analogue of the
  reference's NIXL write into the prefill worker's buffer;
- DEVICE (same process): the tower's output stays a device tensor and is
  moved to the engine's device (``transfer_embeds_device``), no host hop,
  as in disagg/colocated.py.

This module imports no torch at import time (a frontend or a prefill-side
client imports it for ``EncodeClient``): the worker's methods import it
when they run.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, AsyncIterator, Optional

import numpy as np

from dynamo_tpu_torch.multimodal.processor import load_image_array, preprocess_pixels
from dynamo_tpu_torch.pipeline.context import Context
from dynamo_tpu_torch.runtime.logging import get_logger

if TYPE_CHECKING:
    from dynamo_tpu_torch.multimodal.vision import ViTConfig

logger = get_logger("dynamo_tpu_torch.multimodal.encode")

_IMAGE_CACHE_MAX = 8


class EncodeWorker:
    """Owns the tower's parameters (on their device); serves ``encode``
    over the fabric and a same-process device path."""

    def __init__(self, params: dict, cfg: "ViTConfig") -> None:
        self.params = params
        self.cfg = cfg
        # a small decoded-pixel cache shared by the image and video paths
        # (the reference's CACHE_SIZE_MAXIMUM url cache)
        self._cache: dict[str, np.ndarray] = {}

    # ------------------------------------------------------------ compute

    def _cached(self, key: str, build) -> np.ndarray:
        cached = self._cache.get(key)
        if cached is not None:
            return cached
        px = build()
        if len(self._cache) >= _IMAGE_CACHE_MAX:
            self._cache.pop(next(iter(self._cache)))
        self._cache[key] = px
        return px

    def _pixels(self, image_url: str) -> np.ndarray:
        return self._cached(
            image_url,
            lambda: preprocess_pixels(load_image_array(image_url), self.cfg.image_size),
        )

    def _encode(self, px: np.ndarray):
        import torch

        from dynamo_tpu_torch.multimodal.vision import encode_pixels

        dev = self.params["patch_proj"].device
        return encode_pixels(self.params, self.cfg, torch.from_numpy(px).to(dev))

    def encode_device(self, image_url: str):
        """Device path: [num_patches, out_dim] f32 on the tower's device."""
        return self._encode(self._pixels(image_url)[None])[0]

    def encode_numpy(self, image_url: str) -> np.ndarray:
        return self.encode_device(image_url).cpu().numpy()

    def encode_video_device(self, video_url: str, num_frames: int = 8):
        """Video path: ``num_frames`` uniformly sampled frames batch through
        the same tower, one spliceable [num_frames * num_patches, out_dim]
        span."""
        from dynamo_tpu_torch.multimodal.processor import load_video_frames, preprocess_video
        from dynamo_tpu_torch.multimodal.vision import flatten_frame_embeddings

        px = self._cached(
            f"{video_url}#t={num_frames}",
            lambda: preprocess_video(load_video_frames(video_url, num_frames),
                                     self.cfg.image_size),
        )
        return flatten_frame_embeddings(self._encode(px))

    def encode_video_numpy(self, video_url: str, num_frames: int = 8) -> np.ndarray:
        return self.encode_video_device(video_url, num_frames).cpu().numpy()

    # ------------------------------------------------------------- serve

    async def handler(self, request: dict, ctx: Context) -> AsyncIterator[dict]:
        """Fabric endpoint handler: {image_url} or {video_url[, num_frames]}
        -> wire-coded embeddings, or {"error": ...}."""
        try:
            if request.get("video_url"):
                emb = self.encode_video_numpy(
                    request["video_url"], int(request.get("num_frames", 8)))
            else:
                emb = self.encode_numpy(request["image_url"])
            wire = np.ascontiguousarray(emb)
            yield {
                "shape": list(emb.shape),
                "dtype": str(emb.dtype),
                "data": wire.tobytes(),
                "wire_dtype": str(wire.dtype),
            }
        except Exception as e:  # noqa: BLE001 — surface to the caller
            logger.exception("encode failed")
            yield {"error": f"{type(e).__name__}: {e}"}

    async def serve(self, drt: Any, endpoint_str: str) -> Any:
        from dynamo_tpu_torch.runtime.protocols import EndpointId

        eid = EndpointId.parse(endpoint_str, drt.config.namespace)
        endpoint = drt.namespace(eid.namespace).component(eid.component).endpoint(eid.name)
        return await endpoint.serve_endpoint(self.handler)


def decode_embeddings(resp: dict) -> np.ndarray:
    """Inverse of ``EncodeWorker.handler``'s wire coding: host f32 (a bf16
    frame's uint16 words widened exactly)."""
    if resp.get("error"):
        raise RuntimeError(f"encode worker error: {resp['error']}")
    wire = np.frombuffer(resp["data"], dtype=np.dtype(resp["wire_dtype"])).reshape(resp["shape"])
    if resp["dtype"] == "bfloat16":
        return (wire.astype(np.uint32) << 16).view(np.float32)
    return wire.astype(resp["dtype"], copy=False)


class EncodeClient:
    """Prefill-side client of a remote encode worker (the wire path)."""

    def __init__(self, drt: Any, endpoint_str: str) -> None:
        from dynamo_tpu_torch.runtime.protocols import EndpointId

        eid = EndpointId.parse(endpoint_str, drt.config.namespace)
        self._endpoint = drt.namespace(eid.namespace).component(eid.component).endpoint(eid.name)
        self._client: Optional[Any] = None

    async def encode(self, image_url: str) -> np.ndarray:
        return await self._request({"image_url": image_url})

    async def encode_video(self, video_url: str, num_frames: int = 8) -> np.ndarray:
        return await self._request({"video_url": video_url, "num_frames": num_frames})

    async def _request(self, payload: dict) -> np.ndarray:
        if self._client is None:
            self._client = await self._endpoint.client()
            await self._client.wait_for_instances()
        stream = await self._client.round_robin(payload)
        try:
            async for item in stream:
                if item.is_error():
                    raise RuntimeError(item.error_message())
                if item.data is not None:
                    return decode_embeddings(dict(item.data))
        finally:
            await stream.close()
        raise RuntimeError("encode worker returned no data")

    async def close(self) -> None:
        if self._client is not None:
            await self._client.close()
            self._client = None


def transfer_embeds_device(embeds: Any, dest_runner: Any) -> Any:
    """The same-process handoff: the tower's output tensor moved to the
    destination runner's device (a no-op when they share it). Under a
    tensor-parallel group the leader's runner takes it, and the step
    channel hands every rank the same rows."""
    return embeds.to(dest_runner.device)
