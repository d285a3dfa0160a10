"""Model parameters for the port: an HF safetensors checkpoint, seeded
random init on the device, and conversion of a JAX parameter tree.

Counterpart of dynamo_tpu/engine/jax_engine/weights.py
(``load_or_init_params``, ``load_hf_safetensors``) and of ``init_params``
in dynamo_tpu/models/llama.py:262-334. All produce the JAX layout: a dict
with ``embed`` [V, hidden], ``layers`` (a list of dicts with ``[in, out]``
weights), ``final_norm`` and, unless the embeddings are tied, ``lm_head``
[hidden, V]. With ``quantize`` the dense projections (and lm_head) become
int8 ``{"q", "s"}`` leaves (ops/linear.quantize_int8), as the reference's
``maybe_quantize`` makes them; embeddings, norms and biases stay in
``dtype``. A ``shard`` function (name, leaf) -> leaf, e.g. a
tensor-parallel rank's ``parallel/sharding.shard_leaf``, is applied to each
layer's leaves as soon as the layer exists, and to the top-level ones, so
the rank keeps only its slice.
"""

from __future__ import annotations

import glob
import logging
import math
import os
from typing import Any, Callable, Optional

import numpy as np
import torch

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.engine.torch_engine.safetensors_reader import read_safetensors, to_torch
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.ops.linear import maybe_quantize

logger = logging.getLogger("dynamo_tpu_torch.weights")

Shard = Optional[Callable[[str, Any], Any]]


def _cut(leaves: dict, shard: Shard) -> dict:
    """``shard`` over a dict's leaves (``layers``, cut already, kept)."""
    if shard is None:
        return leaves
    return {k: v if k == "layers" else shard(k, v) for k, v in leaves.items()}


def load_or_init_params(
    model_dir: Optional[str],
    cfg: LlamaConfig,
    *,
    seed: int = 0,
    device="cuda",
    dtype: torch.dtype = torch.bfloat16,
    quantize: bool = False,
    shard: Shard = None,
) -> dict:
    """The checkpoint in ``model_dir`` when it holds ``*.safetensors``,
    else seeded random weights (as the JAX loader does, with a warning when
    a directory was given); int8 dense projections with ``quantize``."""
    if model_dir:
        if glob.glob(os.path.join(model_dir, "*.safetensors")):
            return load_hf_safetensors(model_dir, cfg, device=device, dtype=dtype,
                                       quantize=quantize, shard=shard)
        logger.warning("%s has no *.safetensors; falling back to random init", model_dir)
    return init_params(cfg, seed=seed, device=device, dtype=dtype, quantize=quantize,
                       shard=shard)


def load_hf_safetensors(
    model_dir: str,
    cfg: LlamaConfig,
    *,
    device="cuda",
    dtype: torch.dtype = torch.bfloat16,
    quantize: bool = False,
    shard: Shard = None,
) -> dict:
    """Map an HF Llama-family checkpoint (every ``*.safetensors`` file of
    the directory, as the reference globs a sharded one) onto the port's
    parameters, with the JAX loader's names and arithmetic: each tensor is
    converted to ``dtype``; HF's ``[out, in]`` projections become ``[in,
    out]``, transposed on the device after the upload; Gemma's ``(1 + w)``
    norms get their +1 folded in ``dtype``; Gemma2/3's
    ``post_attention_layernorm`` is the sandwich post-attention norm and
    ``pre_feedforward_layernorm`` the MLP's pre-norm; Gemma3's q/k norms
    and Qwen2's q/k/v biases load when the config has them. Without
    ``lm_head.weight`` an untied config falls back to the embeddings at
    logits time. Tensors stream from memory-mapped files one at a time.
    With ``quantize`` each projection is quantized to int8 after its
    transpose, in ``dtype``, as the JAX loader's ``lin`` does."""
    if cfg.num_experts:
        raise NotImplementedError("MoE parameters are not ported yet")
    dev = resolve_device(device)
    tensors: dict[str, Any] = {}
    for path in sorted(glob.glob(os.path.join(model_dir, "*.safetensors"))):
        tensors.update(read_safetensors(path))

    def get(name: str) -> torch.Tensor:
        return to_torch(tensors.pop(name), dev).to(dtype)

    def norm(name: str) -> torch.Tensor:
        w = get(name)
        return w + 1 if cfg.norm_plus_one else w

    def lin(name: str):
        return maybe_quantize(get(name).t().contiguous(), quantize)

    layers = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        layer = {
            "attn_norm": norm(p + "input_layernorm.weight"),
            "wq": lin(p + "self_attn.q_proj.weight"),
            "wk": lin(p + "self_attn.k_proj.weight"),
            "wv": lin(p + "self_attn.v_proj.weight"),
            "wo": lin(p + "self_attn.o_proj.weight"),
        }
        if cfg.sandwich_norms:
            layer.update(
                post_attn_norm=norm(p + "post_attention_layernorm.weight"),
                mlp_norm=norm(p + "pre_feedforward_layernorm.weight"),
                post_mlp_norm=norm(p + "post_feedforward_layernorm.weight"),
            )
        else:
            layer["mlp_norm"] = norm(p + "post_attention_layernorm.weight")
        if cfg.qk_norm:
            layer.update(
                q_norm=norm(p + "self_attn.q_norm.weight"),
                k_norm=norm(p + "self_attn.k_norm.weight"),
            )
        if cfg.attn_bias:
            layer.update(
                bq=get(p + "self_attn.q_proj.bias"),
                bk=get(p + "self_attn.k_proj.bias"),
                bv=get(p + "self_attn.v_proj.bias"),
            )
        layer.update(
            wg=lin(p + "mlp.gate_proj.weight"),
            wu=lin(p + "mlp.up_proj.weight"),
            wd=lin(p + "mlp.down_proj.weight"),
        )
        layers.append(_cut(layer, shard))
    params = {
        "embed": get("model.embed_tokens.weight"),
        "layers": layers,
        "final_norm": norm("model.norm.weight"),
    }
    if not cfg.tie_word_embeddings and "lm_head.weight" in tensors:
        params["lm_head"] = lin("lm_head.weight")
    params = _cut(params, shard)
    logger.info("loaded %s (%d tensors unused)", model_dir, len(tensors))
    return params


def init_params(
    cfg: LlamaConfig,
    seed: int = 0,
    device="cuda",
    dtype: torch.dtype = torch.bfloat16,
    quantize: bool = False,
    shard: Shard = None,
) -> dict:
    """Random parameters with the JAX init's scales: dense weights
    N(0, 1/fan_in), embeddings N(0, 0.02^2), norm weights 1, biases 0. Drawn
    on the device from a ``torch.Generator`` seeded with ``seed`` (so the
    values differ from the JAX init's threefry draws). Never zeros: zero
    weights make attention uniform and would hide a wrong kernel. With
    ``quantize`` every dense weight is drawn in ``dtype`` and then
    quantized to int8 (the reference's ``dense``)."""
    if cfg.num_experts:
        raise NotImplementedError("MoE parameters are not ported yet")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return maybe_quantize(w.div_(math.sqrt(fan_in)).to(dtype), quantize)

    def ones(n):
        return torch.ones(n, device=dev, dtype=dtype)

    c = cfg
    layers = []
    for _ in range(c.num_layers):
        layer = {
            "attn_norm": ones(c.hidden_size),
            "wq": dense((c.hidden_size, c.q_dim), c.hidden_size),
            "wk": dense((c.hidden_size, c.kv_dim), c.hidden_size),
            "wv": dense((c.hidden_size, c.kv_dim), c.hidden_size),
            "wo": dense((c.q_dim, c.hidden_size), c.q_dim),
            "mlp_norm": ones(c.hidden_size),
        }
        if c.attn_bias:
            layer.update(
                bq=torch.zeros(c.q_dim, device=dev, dtype=dtype),
                bk=torch.zeros(c.kv_dim, device=dev, dtype=dtype),
                bv=torch.zeros(c.kv_dim, device=dev, dtype=dtype),
            )
        if c.sandwich_norms:
            layer.update(
                post_attn_norm=ones(c.hidden_size),
                post_mlp_norm=ones(c.hidden_size),
            )
        if c.qk_norm:
            layer.update(q_norm=ones(c.head_dim), k_norm=ones(c.head_dim))
        layer.update(
            wg=dense((c.hidden_size, c.intermediate_size), c.hidden_size),
            wu=dense((c.hidden_size, c.intermediate_size), c.hidden_size),
            wd=dense((c.intermediate_size, c.hidden_size), c.intermediate_size),
        )
        layers.append(_cut(layer, shard))
    embed = torch.randn(
        (c.vocab_size, c.hidden_size), generator=gen, device=dev, dtype=torch.float32
    )
    params = {
        "embed": embed.mul_(0.02).to(dtype),
        "layers": layers,
        "final_norm": ones(c.hidden_size),
    }
    if not c.tie_word_embeddings:
        params["lm_head"] = dense((c.hidden_size, c.vocab_size), c.hidden_size)
    return _cut(params, shard)


def _to_torch(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: same bits as torch's
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(tree: Any, device="cuda") -> Any:
    """Convert a JAX parameter tree whose leaves are numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``) into the port's parameters, bit
    for bit. bf16 leaves travel through a uint16 view; int8-quantized
    weights (``{"q": int8, "s": bf16}``) keep their form, leaf by leaf. The
    layout is the same on both sides ([in, out] weights), so nothing is
    transposed."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, dev) for v in tree]
    return _to_torch(tree, dev)
