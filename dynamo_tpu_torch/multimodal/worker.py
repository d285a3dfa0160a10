"""Multimodal serving wrapper: image / video URLs -> vision embeddings ->
engine.

The port's own copy of dynamo_tpu/multimodal/worker.py (the role of the
reference's multimodal prefill / decode worker pair): the language engine
stays as it is; this wrapper resolves the sources the preprocessor lifted
into ``extra["mm_images"]`` / ``extra["mm_videos"]``, gets their embeddings
from the encode worker (the device path when it lives in this process, the
wire path when it is remote), prepends the placeholder tokens, and hands
the request to the inner ``TorchEngine``, whose ``prefill_mm`` splices the
embeddings.
"""

from __future__ import annotations

import dataclasses
from typing import Any, AsyncIterator, Optional


from dynamo_tpu_torch.multimodal.encode_worker import (
    EncodeClient,
    EncodeWorker,
    transfer_embeds_device,
)
from dynamo_tpu_torch.pipeline.context import Context
from dynamo_tpu_torch.protocols.common import FinishReason, LLMEngineOutput, PreprocessedRequest
from dynamo_tpu_torch.runtime.logging import get_logger

logger = get_logger("dynamo_tpu_torch.multimodal.worker")


class MultimodalEngine:
    """An engine decorator adding image and video understanding to a
    TorchEngine.

    encoder: an ``EncodeWorker`` (same process: the embeddings stay on the
    device -- the colocated path) or an ``EncodeClient`` (a remote encode
    worker: the embeddings ride the fabric wire). The media's placeholder
    tokens are prepended ([img] * N + prompt), the single-image convention
    of LLaVA-style models whose template puts <image> first."""

    def __init__(
        self,
        inner: Any,
        encoder: Any,  # EncodeWorker | EncodeClient
        placeholder_id: int = 0,
        num_patches: Optional[int] = None,
        video_frames: int = 8,
    ) -> None:
        self.inner = inner
        self.encoder = encoder
        self.placeholder_id = placeholder_id
        if num_patches is None:
            cfg = getattr(encoder, "cfg", None)
            num_patches = cfg.num_patches if cfg is not None else 16
        self.num_patches = num_patches
        # a clip samples this many frames; its span is video_frames *
        # num_patches placeholder positions
        self.video_frames = video_frames

    # tells the serving layer that media parts are welcome (501 otherwise)
    supports_images = True

    def __getattr__(self, name: str) -> Any:  # stats / close / embed / ... delegate
        return getattr(self.inner, name)

    # The KV-event hooks must reach the INNER engine: run_endpoint assigns
    # `engine.on_blocks_stored = publisher...` on whatever it is handed, and
    # a plain setattr here would shadow the wrapper while the inner engine
    # (which fires the events) kept None, unplugging prefix routing.
    @property
    def on_blocks_stored(self):
        return self.inner.on_blocks_stored

    @on_blocks_stored.setter
    def on_blocks_stored(self, fn) -> None:
        self.inner.on_blocks_stored = fn

    @property
    def on_blocks_removed(self):
        return self.inner.on_blocks_removed

    @on_blocks_removed.setter
    def on_blocks_removed(self, fn) -> None:
        self.inner.on_blocks_removed = fn

    @property
    def on_cache_cleared(self):
        return self.inner.on_cache_cleared

    @on_cache_cleared.setter
    def on_cache_cleared(self, fn) -> None:
        self.inner.on_cache_cleared = fn

    def _land_device(self, emb: Any) -> Any:
        """Colocated path: the tower's tensor moved to the engine's device."""
        runner = getattr(self.inner, "runner", None)
        return transfer_embeds_device(emb, runner) if runner is not None else emb.cpu().numpy()

    async def _resolve_embeds(self, image_url: str) -> Any:
        if isinstance(self.encoder, EncodeWorker):
            return self._land_device(self.encoder.encode_device(image_url))
        if isinstance(self.encoder, EncodeClient):
            return await self.encoder.encode(image_url)
        raise TypeError(f"unsupported encoder {type(self.encoder)!r}")

    async def _resolve_video_embeds(self, video_url: str) -> Any:
        if isinstance(self.encoder, EncodeWorker):
            return self._land_device(self.encoder.encode_video_device(video_url, self.video_frames))
        if isinstance(self.encoder, EncodeClient):
            return await self.encoder.encode_video(video_url, self.video_frames)
        raise TypeError(f"unsupported encoder {type(self.encoder)!r}")

    async def generate(
        self, request: PreprocessedRequest, context: Context
    ) -> AsyncIterator[LLMEngineOutput]:
        urls = request.extra.get("mm_images")
        vids = request.extra.get("mm_videos")
        if urls or vids:
            n_sources = len(urls or []) + len(vids or [])
            if n_sources > 1:
                logger.warning(
                    "mixed-media request: serving the %s, dropping %d other source(s) "
                    "(one medium a request, as the reference)",
                    "video" if vids else "image", n_sources - 1,
                )
            span = self.video_frames * self.num_patches if vids else self.num_patches
            # fail before the encode when the spliced sequence cannot fit
            # (the span is prepended after the preprocessor's budgeting)
            max_len = getattr(getattr(self.inner, "config", None), "max_model_len", None)
            if max_len is not None and span + len(request.token_ids) >= max_len:
                logger.error(
                    "media span (%d) + prompt (%d) exceeds max_model_len (%d); reduce "
                    "video_frames or shorten the prompt", span, len(request.token_ids), max_len,
                )
                yield LLMEngineOutput.final(FinishReason.ERROR)
                return
            try:
                if vids:
                    embeds = await self._resolve_video_embeds(vids[0])
                else:
                    embeds = await self._resolve_embeds(urls[0])
            except Exception:  # noqa: BLE001
                logger.exception("media encode failed")
                yield LLMEngineOutput.final(FinishReason.ERROR)
                return
            ids = [self.placeholder_id] * span + list(request.token_ids)
            extra = dict(request.extra)
            extra.pop("mm_images", None)
            extra.pop("mm_videos", None)
            extra["mm"] = {"embeds": embeds, "start": 0}
            request = dataclasses.replace(request, token_ids=ids, extra=extra)
        async for out in self.inner.generate(request, context):
            yield out



