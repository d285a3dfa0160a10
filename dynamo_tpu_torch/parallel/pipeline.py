"""Pipeline parallelism: the llama forward cut into stages of layers over
the grid's ``pp`` axis, the activation handed from stage to stage.

Counterpart of dynamo_tpu/parallel/pipeline.py. Upstream the stacked
layers are sharded over a ``pp`` mesh axis and one SPMD program scans each
stage's layers, handing activations on with ``lax.ppermute`` inside a
fill / drain microbatch rotation; it holds no Pallas kernel, so it ports as
torch ops. Here each rank of a ``pp`` line holds its stage's slice of the
stacked layers and of the paged cache ([L / pp, Hkv, nb, bs, D]) as plain
tensors, runs its layers one after another, and hands the activation on
with ``AxisGroup.ppermute``. As upstream, it is a library: no factory knob
builds a pipelined engine.

Scope, as upstream: the dense llama / Qwen2 family with SwiGLU and
unscaled embeddings, bf16 / f32 or int8 weight-only (each {"q", "s"} leaf
stacks per key), Qwen2 attention biases; MoE layers are refused at stack
time (expert parallelism serves them), and Gemma's GeGLU, embedding scale,
sandwich norms and sliding windows are refused by ``_check_pp_supported``.

What differs from the JAX functions, and why: which stage computes at a
tick is known on the host here, so a stage with nothing in hand skips its
layers where the reference computes them and discards the result with
``where``; the microbatch a stage holds is host-known too, so no index
metadata rides the handoff. The results are the same.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.ops.attention import NEG_INF, write_decode_kv, write_prefill_kv
from dynamo_tpu_torch.ops.basics import rms_norm, rope_freqs, swiglu
from dynamo_tpu_torch.ops.layers import attn_out, qkv_head
from dynamo_tpu_torch.ops.linear import linear


def stack_layer_params(params: dict) -> dict:
    """[{wq, wk, ...}] x L -> {"wq": [L, ...], ...} (reference :44); an int8
    {"q", "s"} weight stacks per key. Raises NotImplementedError for MoE
    layers."""
    layers = params["layers"]
    if "router" in layers[0]:
        raise NotImplementedError(
            "pipeline parallelism over MoE layers is not supported: use expert "
            "parallelism (ep) for Mixtral-family models"
        )

    def stack_leaf(key):
        vals = [lyr[key] for lyr in layers]
        if isinstance(vals[0], dict):
            return {k2: torch.stack([v[k2] for v in vals]) for k2 in vals[0]}
        return torch.stack(vals)

    out = {"embed": params["embed"], "layers": {k: stack_leaf(k) for k in layers[0]},
           "final_norm": params["final_norm"]}
    if "lm_head" in params:
        out["lm_head"] = params["lm_head"]
    return out


def shard_stacked_pp(group, stacked: dict) -> dict:
    """The stage's own slice of stacked params (reference :73): layers
    [s * L / pp, (s + 1) * L / pp) at pp coordinate s, everything else
    whole. The stage's paged caches are [L / pp, Hkv, nb, bs, D] to match
    (the reference shards the cache's layer axis over pp the same way)."""
    pp = group.pp

    def cut(v):
        if isinstance(v, dict):
            return {k: cut(x) for k, x in v.items()}
        n = v.shape[0] // pp.world_size
        return v[pp.rank * n:(pp.rank + 1) * n].clone()

    some = next(iter(stacked["layers"].values()))
    L = (some["q"] if isinstance(some, dict) else some).shape[0]
    if L % pp.world_size:
        raise ValueError(f"{L} layers do not split into pp={pp.world_size} stages")
    out = dict(stacked)
    out["layers"] = {k: cut(v) for k, v in stacked["layers"].items()}
    return out


def _check_pp_supported(cfg) -> None:
    """The pipelined forward implements the llama / Qwen2 dense path only
    (reference :101); refuse the family features it would skip."""
    if cfg.mlp_act != "silu" or cfg.embed_scale:
        raise NotImplementedError(
            "pipeline parallelism supports the SwiGLU / unscaled-embedding families only "
            "(llama / qwen2 / mixtral-dense); gemma's GeGLU and embedding scaling are not "
            "plumbed through the pp stages"
        )
    if getattr(cfg, "sandwich_norms", False):
        raise NotImplementedError(
            "pipeline parallelism does not implement the post-MLP sandwich norm"
        )
    if any(cfg.layer_window(i) for i in range(cfg.num_layers)):
        raise NotImplementedError(
            "pipeline parallelism implements full attention only; a sliding-window config "
            "would attend past its window"
        )


def _layer(layers: dict, i: int) -> dict:
    return {k: ({k2: x[i] for k2, x in v.items()} if isinstance(v, dict) else v[i])
            for k, v in layers.items()}


def _run_stage(cfg, layers, x, positions, attend, write_kv, k_cache, v_cache):
    """This stage's layers in order (reference ``_scan_layers`` :129): the
    serial path's projection head and output projection, the attention
    ``attend(q, kc, vc, k, v)`` after ``write_kv(kc, vc, k, v)`` into the
    layer's cache (in place), then the SwiGLU MLP."""
    inv_freqs = rope_freqs(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling, device=x.device)
    n = k_cache.shape[0]
    for i in range(n):
        lyr = _layer(layers, i)
        kc, vc = k_cache[i], v_cache[i]
        q, k, v = qkv_head(x, lyr, cfg, inv_freqs, positions)
        write_kv(kc, vc, k, v)
        x = attn_out(attend(q, kc, vc, k, v), x, lyr, cfg)
        h2 = rms_norm(x, lyr["mlp_norm"], cfg.rms_eps)
        x = x + linear(swiglu(linear(h2, lyr["wg"]), linear(h2, lyr["wu"])), lyr["wd"])
    return x


def _lm_head(params):
    w = params.get("lm_head")
    return params["embed"].T if w is None else w


def prefill_pp(
    params: dict,  # the stage's slice of stacked params (shard_stacked_pp)
    cfg,
    group,  # the rank's TPGroup, with a pp axis
    tokens: torch.Tensor,  # [Pl] int64, padded to whole blocks
    valid_len: int,
    k_cache: torch.Tensor,  # [L / pp, Hkv, nb, bs, D], this stage's layers, written in place
    v_cache: torch.Tensor,
    block_table: torch.Tensor,  # [Pl // bs] block ids
) -> torch.Tensor:
    """One prompt through the pipeline (reference :156): the activation
    visits stages 0..pp-1 in turn, one tick each, every stage writing its
    own layers' pages; after pp hand-offs it is back on stage 0, which
    computes the last valid token's logits, and a sum over pp (zeros
    elsewhere) gives them to every stage. Returns logits [V] (f32)."""
    _check_pp_supported(cfg)
    pp = group.pp
    Pl = tokens.shape[0]
    dev = tokens.device
    positions = torch.arange(Pl, device=dev)
    mask = (positions[None, :] <= positions[:, None]) & (positions[None, :] < valid_len)

    def attend(q, kc, vc, k, v):  # in-buffer causal attention over the prompt's K/V
        Hq, D = q.shape[1], q.shape[2]
        Hkv = k.shape[1]
        scale = 1.0 / torch.sqrt(torch.tensor(D, dtype=torch.float32))
        qr = q.reshape(Pl, Hkv, Hq // Hkv, D)
        scores = torch.einsum("qhgd,khd->hgqk", qr.float(), k.float()) * scale
        scores = torch.where(mask[None, None], scores, torch.tensor(NEG_INF, device=dev))
        w = torch.softmax(scores, dim=-1)
        out = torch.einsum("hgqk,khd->qhgd", w, v.float())
        return out.reshape(Pl, Hq, D).to(q.dtype)

    def write_kv(kc, vc, k, v):
        write_prefill_kv(kc, vc, k, v, block_table)

    embed = params["embed"]
    x = embed[tokens].to(embed.dtype)
    for t in range(pp.world_size):
        if pp.rank == t:  # one microbatch: stage s works at tick s
            x = _run_stage(cfg, params["layers"], x, positions, attend, write_kv, k_cache,
                           v_cache)
        x = pp.ppermute(x, 1)
    h = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = linear(h[valid_len - 1].float()[None, :], _lm_head(params))[0].float()
    if pp.rank != 0:
        logits = torch.zeros_like(logits)
    return pp.all_reduce(logits)


def decode_pp(
    params: dict,
    cfg,
    group,
    tokens: torch.Tensor,  # [B] int64
    positions: torch.Tensor,  # [B] int64
    k_cache: torch.Tensor,  # [L / pp, Hkv, nb, bs, D], written in place
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_blocks]
    slot_indices: torch.Tensor,  # [B]
) -> torch.Tensor:
    """Batched decode through the pipeline with the GPipe fill / drain
    rotation (reference :249): B divides into pp microbatches of B / pp
    lanes; microbatch m enters stage 0 at tick m and leaves stage pp-1 at
    tick m + pp - 1, so M + pp - 1 = 2 pp - 1 ticks run, every stage busy
    once the pipe is full. The last stage writes each finished
    microbatch's logits; a sum over pp gives them to every stage. Returns
    logits [B, V] (f32)."""
    _check_pp_supported(cfg)
    pp = group.pp
    n = pp.world_size
    B = tokens.shape[0]
    if B % n:
        raise ValueError(f"decode batch {B} must divide by pp={n}")
    Mb = B // n
    dev = tokens.device
    embed = params["embed"]
    lm_head = _lm_head(params)
    buf = torch.zeros(Mb, embed.shape[1], dtype=embed.dtype, device=dev)
    out = torch.zeros(B, cfg.vocab_size, dtype=torch.float32, device=dev)
    for t in range(2 * n - 1):
        if pp.rank == 0 and t < n:  # stage 0 takes the next microbatch in
            buf = embed[tokens[t * Mb:(t + 1) * Mb]].to(embed.dtype)
        m = t - pp.rank  # the microbatch this stage holds at this tick
        if 0 <= m < n:
            lanes = slice(m * Mb, (m + 1) * Mb)
            bt, pos1, slots = block_tables[lanes], positions[lanes] + 1, slot_indices[lanes]

            def attend(q, kc, vc, k, v, bt=bt, pos1=pos1):
                Hq, D = q.shape[1], q.shape[2]
                Hkv, _, bs, _ = kc.shape
                S = bt.shape[1] * bs
                scale = 1.0 / torch.sqrt(torch.tensor(D, dtype=torch.float32))
                kw = kc[:, bt.long()].reshape(Hkv, Mb, S, D)
                vw = vc[:, bt.long()].reshape(Hkv, Mb, S, D)
                qr = q.reshape(Mb, Hkv, Hq // Hkv, D)
                scores = torch.einsum("bhgd,hbsd->bhgs", qr.float(), kw.float()) * scale
                valid = (torch.arange(S, device=dev)[None, :] < pos1[:, None])[:, None, None, :]
                scores = torch.where(valid, scores, torch.tensor(NEG_INF, device=dev))
                w = torch.softmax(scores, dim=-1)
                o = torch.einsum("bhgs,hbsd->bhgd", w, vw.float())
                return o.reshape(Mb, Hq, D).to(q.dtype)

            def write_kv(kc, vc, k, v, slots=slots):
                write_decode_kv(kc, vc, k, v, slots)

            buf = _run_stage(cfg, params["layers"], buf, positions[lanes], attend, write_kv,
                             k_cache, v_cache)
            if pp.rank == n - 1:  # the last stage emits its finished microbatch
                h = rms_norm(buf, params["final_norm"], cfg.rms_eps)
                out[lanes] = linear(h.float(), lm_head).float()
        buf = pp.ppermute(buf, 1)
    return pp.all_reduce(out)
