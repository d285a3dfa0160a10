"""Multimodal serving: vision encode -> embedding handoff -> prefill ->
decode.

The port's own copy of dynamo_tpu/multimodal/ (the role of the reference's
examples/multimodal stack):

- the vision tower is a PyTorch ViT (``vision.py``) whose patchify is one
  product;
- the embedding handoff rides either the same-process device path (the
  tower's tensor moved to the engine's device) or the fabric wire
  (``encode_worker.py``);
- the prompt splice happens inside the prefill: placeholder rows are
  overwritten with the vision embeddings after the token lookup
  (``models/llama.prefill_mm``), one prompt on its own.

The package exports the reference's names. They load on first use, so
importing ``processor`` or ``encode_worker`` (a frontend's modules) does
not import torch.
"""

import importlib

_EXPORTS = {
    "IMAGE_PLACEHOLDER": "processor",
    "VIDEO_PLACEHOLDER": "processor",
    "expand_image_prompt": "processor",
    "expand_video_prompt": "processor",
    "load_image_array": "processor",
    "load_video_frames": "processor",
    "preprocess_pixels": "processor",
    "preprocess_video": "processor",
    "sample_frames": "processor",
    "ViTConfig": "vision",
    "encode_frames": "vision",
    "encode_pixels": "vision",
    "init_vit_params": "vision",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
