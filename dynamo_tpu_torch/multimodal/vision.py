"""Vision tower + multimodal projector, in PyTorch.

The port's own copy of dynamo_tpu/multimodal/vision.py (``ViTConfig``,
``init_vit_params``, ``encode_pixels``, ``encode_frames``,
``flatten_frame_embeddings``), the role of the reference encode worker's
LLaVA vision tower + projector:

- patchify is one [B*N, p*p*3] @ [p*p*3, hidden] product, not a conv;
- the encoder is a pre-RMSNorm transformer over a static [B, N, hidden]
  grid with full (non-causal) attention and a GELU (tanh) MLP;
- a two-layer GELU projector maps hidden -> the language model's hidden,
  so the output splices straight into its embedding stream
  (``models/llama.prefill_mm``).

Upstream the tower is XLA einsums with no Pallas kernel, so it ports as
torch ops (no kernel is owed). Parameters and activations stay f32, as the
reference's are. A JAX tree of ``init_vit_params`` carries across leaf by
leaf with ``engine/torch_engine/weights.params_from_jax``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.ops.basics import rms_norm


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 64
    patch_size: int = 16
    hidden_size: int = 128
    num_layers: int = 2
    num_heads: int = 4
    mlp_ratio: int = 4
    out_dim: int = 128  # = the language model's hidden_size
    eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * 3


def init_vit_params(cfg: ViTConfig, generator: torch.Generator,
                    device="cpu") -> dict:
    """Seeded random parameters (normal x 0.02, unit norms; the reference's
    tree and scales) drawn from ``generator`` on the CPU, then moved to
    ``device``."""
    s = 0.02

    def normal(*shape):
        return (torch.randn(shape, generator=generator, dtype=torch.float32) * s).to(device)

    def ones(n):
        return torch.ones(n, dtype=torch.float32, device=device)

    H = cfg.hidden_size
    params = {
        "patch_proj": normal(cfg.patch_dim, H),
        "pos_embed": normal(cfg.num_patches, H),
        "final_norm": ones(H),
        # two-layer GELU projector, like LLaVA's mm_projector
        "proj_w1": normal(H, cfg.out_dim),
        "proj_w2": normal(cfg.out_dim, cfg.out_dim),
        "layers": [],
    }
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "ln1": ones(H),
            "ln2": ones(H),
            "qkv": normal(H, 3 * H),
            "attn_out": normal(H, H),
            "mlp_in": normal(H, cfg.mlp_ratio * H),
            "mlp_out": normal(cfg.mlp_ratio * H, H),
        })
    return params


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _block(x: torch.Tensor, layer: dict, cfg: ViTConfig) -> torch.Tensor:
    """One pre-norm encoder block; full (non-causal) attention over patches."""
    B, N, H = x.shape
    h = rms_norm(x, layer["ln1"], cfg.eps)
    q, k, v = (h @ layer["qkv"]).split(H, dim=-1)
    Dh = H // cfg.num_heads
    q = q.reshape(B, N, cfg.num_heads, Dh)
    k = k.reshape(B, N, cfg.num_heads, Dh)
    v = v.reshape(B, N, cfg.num_heads, Dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(float(Dh))
    attn = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, N, H)
    x = x + o @ layer["attn_out"]
    h = rms_norm(x, layer["ln2"], cfg.eps)
    return x + _gelu(h @ layer["mlp_in"]) @ layer["mlp_out"]


@torch.inference_mode()
def encode_pixels(params: dict, cfg: ViTConfig, pixels: torch.Tensor) -> torch.Tensor:
    """Vision tower + projector: pixels [B, S, S, 3] f32 -> [B, num_patches,
    out_dim] rows in the LANGUAGE model's hidden space, ready to overwrite
    the image-placeholder positions."""
    B = pixels.shape[0]
    p = cfg.patch_size
    g = cfg.image_size // p
    # [B, g, p, g, p, 3] -> [B, g*g, p*p*3]: one reshape, one product
    patches = pixels.reshape(B, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
    patches = patches.reshape(B, g * g, cfg.patch_dim)
    x = patches @ params["patch_proj"] + params["pos_embed"][None]
    for layer in params["layers"]:
        x = _block(x, layer, cfg)
    x = rms_norm(x, params["final_norm"], cfg.eps)
    return _gelu(x @ params["proj_w1"]) @ params["proj_w2"]


def flatten_frame_embeddings(emb: torch.Tensor) -> torch.Tensor:
    """[T, P, D] -> [T * P, D]: per-frame patch embeddings concatenated in
    temporal order -- the layout ``expand_video_prompt`` sizes the
    placeholder span for."""
    return emb.reshape(emb.shape[0] * emb.shape[1], emb.shape[2])


def encode_frames(params: dict, cfg: ViTConfig, frames: torch.Tensor) -> torch.Tensor:
    """Video clip [T, S, S, 3] -> one spliceable span [T * num_patches,
    out_dim]: the frames batch through the same tower as images, one
    dispatch."""
    return flatten_frame_embeddings(encode_pixels(params, cfg, frames))


def param_device(params: dict) -> Optional[torch.device]:
    """The device the tower's parameters live on."""
    return params["patch_proj"].device
