"""Megatron-style tensor-parallel sharding of the llama family's
parameters, with the experts split over ``ep``.

Counterpart of dynamo_tpu/parallel/sharding.py:63-122. The JAX package
places the whole parameter tree on a mesh with NamedShardings and lets
GSPMD insert the collectives; here each rank keeps only its own slice, as
plain tensors, and the model code (models/llama.py, ops/collective.py)
issues the collectives itself. The layout is the reference's
(sharding.py:6-17):

  wq / wk / wv  [E, heads * D]  -> columns split (column parallel)
  wo            [heads * D, E]  -> rows split (row parallel, sum after)
  wg / wu       [E, F]          -> column parallel
  wd            [F, E]          -> row parallel
  lm_head       [E, V]          -> vocab split; the logits all-gathered
  MoE wg / wu   [n_exp, E, F]   -> experts split over ep, each expert's
                                   FFN columns over tp
  MoE wd        [n_exp, F, E]   -> experts split over ep, each expert's
                                   FFN rows over tp (the combine's f32
                                   partials are summed, ops/moe.py)
  MoE router    [E, n_exp]      -> replicated
  embed, norms                  -> replicated
  Qwen2 bq / bk / bv            -> split with their columns
  kv cache      [L, Hkv, N, Bs, D] -> kv heads split (each rank's runner
                                   allocates Hkv / tp heads), replicated over
                                   dp, sp and ep

int8 weights (``{"q": int8 [in, out], "s": bf16 [out]}``) keep their
per-output-channel scales beside their mantissas: a column split cuts both,
a row split cuts the mantissas and keeps every scale (``_shard_linear``,
:52-60). The experts are placed as the reference places them (:101-109,
``P("ep", None, "tp")``): the rank at ep coordinate e holds experts
[e * n_exp / ep, (e + 1) * n_exp / ep), each cut on its FFN width by the tp
coordinate; with ep = 1 each rank holds every expert's FFN slice. Everything
else is replicated over dp, sp and ep. Rank r's slice is block r of tp
equal blocks.
"""

from __future__ import annotations

from typing import Any

import torch

COLUMN = ("wq", "wk", "wv", "wg", "wu", "lm_head")
ROW = ("wo", "wd")
BIAS = ("bq", "bk", "bv")
# an MoE layer's expert stacks (bf16, never int8): the dim its FFN width is on
EXPERTS = {"wg": 2, "wu": 2, "wd": 1}


def check_shardable(cfg, tp: int, ep: int = 1) -> None:
    """Raise ValueError when ``cfg``'s shapes do not split into ``tp``
    equal slices, or its experts into ``ep`` (the reference checks the kv
    heads and the experts, :72-81; the port also needs whole query heads,
    FFN and vocab blocks, since each rank holds plain tensors rather than
    padded shards; an MoE model's experts split on the same
    intermediate_size)."""
    if cfg.num_experts and cfg.num_experts % ep:
        raise ValueError(f"num_experts={cfg.num_experts} not divisible by ep={ep}")
    for what, n in (
        ("num_kv_heads", cfg.num_kv_heads),
        ("num_heads", cfg.num_heads),
        ("intermediate_size", cfg.intermediate_size),
        ("vocab_size", cfg.vocab_size),
    ):
        if n % tp:
            raise ValueError(f"{what}={n} not divisible by tp={tp}")


def _block(t: torch.Tensor, dim: int, rank: int, tp: int) -> torch.Tensor:
    """Block ``rank`` of ``tp`` along ``dim``, in storage of its own (the
    full tensor can be freed)."""
    n = t.shape[dim] // tp
    return t.narrow(dim, rank * n, n).clone(memory_format=torch.contiguous_format)


def shard_leaf(name: str, w: Any, rank: int, tp: int, ep_rank: int = 0, ep: int = 1) -> Any:
    """The slice of the parameter leaf called ``name`` (a layer key, or
    ``embed`` / ``final_norm`` / ``lm_head``) held at tp coordinate
    ``rank`` of ``tp`` and ep coordinate ``ep_rank`` of ``ep``."""
    if name in EXPERTS and isinstance(w, torch.Tensor) and w.dim() == 3:  # an MoE [E, in, out] stack
        if ep > 1:
            w = _block(w, 0, ep_rank, ep)
        return w if tp == 1 else _block(w, EXPERTS[name], rank, tp)
    if tp == 1:
        return w
    if name in COLUMN:
        if isinstance(w, dict):
            return {"q": _block(w["q"], 1, rank, tp), "s": _block(w["s"], 0, rank, tp)}
        return _block(w, 1, rank, tp)
    if name in ROW:
        if isinstance(w, dict):
            return {"q": _block(w["q"], 0, rank, tp), "s": w["s"]}
        return _block(w, 0, rank, tp)
    if name in BIAS:
        return _block(w, 0, rank, tp)
    return w  # embed, norms, the MoE router: replicated


def shard_llama(group, cfg, params: dict) -> dict:
    """The rank's own slice of a full parameter dict (``group`` is the
    rank's TPGroup: its tp coordinate and size, and its ep coordinate and
    size on a grid with an ep axis). Raises when the shapes do not split
    evenly."""
    rank, tp = group.rank, group.world_size
    ep_axis = getattr(group, "ep", None)
    ep_rank, ep = (ep_axis.rank, ep_axis.world_size) if ep_axis is not None else (0, 1)
    check_shardable(cfg, tp, ep)

    def leaf(k, v):
        return shard_leaf(k, v, rank, tp, ep_rank, ep)

    out = {k: leaf(k, v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: leaf(k, v) for k, v in layer.items()} for layer in params["layers"]]
    return out
