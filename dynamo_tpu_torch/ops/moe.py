"""Mixture-of-Experts: the top-k router and the experts' FFN dispatch.

Counterpart of dynamo_tpu/ops/moe.py, on one card, under a tensor-parallel
group, and with the experts split over the grid's ``ep`` axis:

  * ``moe_ffn_dropless`` (the default): assignments sorted by expert, the
    three grouped products of ``_grouped_ffn``, a weighted combine. Exact
    Mixtral serving semantics: no capacity, no dropped token;
  * ``moe_ffn`` (``moe_impl == "gshard"``): GShard dispatch / combine
    einsums over a capacity-bucketed [T, E, C] routing tensor, the token
    axis chunked, weights renormalized over the assignments that survive
    capacity.

Routing: top-k of the f32 router logits, ties to the lower expert index (as
``lax.top_k``), softmax over the chosen k.

What differs from the JAX functions, and why:

  * the groups are counted and the rows ordered on the device without a
    sort and without ``torch.bincount`` (which reads its output size back
    to the host on a card): a one-hot sum gives the group sizes, and a
    running count within each expert gives every assignment its place,
    which is the stable argsort's order. Nothing of a dropless layer reads
    the card back, so the decode graphs capture it;
  * ``_grouped_ffn`` runs the hand-written CUDA kernel for CUDA tensors
    (ops/cuda_moe.py; only the routed experts' weights are read) and
    ``grouped_ffn_plain``, a loop over the experts' host-known row slices,
    for CPU tensors; nothing falls back from one to the other;
  * each token's k contributions are summed in f32 in a fixed order (its
    first choice, then its second, ...) from a gather, not a scatter-add,
    so a graphed replay is bitwise its eager call. For k = 2 that is the
    reference's sum exactly (0 + a + b = a + b in any order);
  * under a tensor-parallel group each rank holds every expert's FFN slice
    (wg / wu columns, wd rows) and returns the f32 sum of the ranks'
    combined partials, which the dense MLP's row-parallel all-reduce takes
    (models/llama.py ``_mlp``).

  * the expert-parallel forms take the rank's TPGroup (parallel/mesh.py),
    whose ``ep`` line holds the experts in equal blocks (each rank's wg /
    wu / wd its block of n_exp / ep experts, each cut on F by ``tp``):
    ``moe_ffn_shard_map`` (decode-sized batches) routes every token on every
    rank, keeps only the assignments to its own experts and sums the ranks'
    f32 outputs over ``tp`` then ``ep``; ``moe_ffn_ep_a2a`` (prefill-sized
    batches) cuts the replicated tokens into ``ep`` blocks, routes its own,
    ships them to their experts' ranks with ``all_to_all``, runs the grouped
    FFN (the CUDA kernel on the card), sums its ``tp`` partials, ships the
    results back, combines at the source and all-gathers the ``ep`` blocks
    back into the replicated stream the rest of the layer reads (upstream the
    output stays ep-sharded and GSPMD gathers it where it is read). The ep
    sum runs in f32 before the cast, where the reference casts first.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.ops.basics import swiglu
from dynamo_tpu_torch.ops.cuda_moe import grouped_swiglu_ffn_cuda


def default_capacity(T: int, E: int, top_k: int, factor: float) -> int:
    """Expert capacity: dropless (capacity = T) for decode-sized batches,
    where routing collisions are routine; a large T keeps the
    capacity-factor bucket (the reference's rule, moe.py:47)."""
    if T <= 64:
        return T
    return max(int(factor * T * top_k / E), top_k)


def router_topk(logits: torch.Tensor, top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k expert ids [T, k] (int64) and their renormalized softmax
    weights [T, k] (f32) from [T, E] f32 logits, ranked as ``lax.top_k``
    ranks them: by the floats' total order (-0.0 below +0.0), equal logits
    the lower expert index first. Each logit's rank is the count of larger
    logits plus equal ones at lower indices (an [T, E, E] comparison of the
    order-preserving integer keys, no sort and no host read)."""
    T, E = logits.shape
    bits = logits.float().contiguous().view(torch.int32)
    keys = bits ^ ((bits >> 31) & 0x7FFFFFFF)  # the total order of the floats, as integers
    a, b = keys[:, :, None], keys[:, None, :]  # [T, i, j]
    lower = torch.ones(E, E, dtype=torch.bool, device=logits.device).tril(-1)  # j < i
    rank = ((b > a) | ((b == a) & lower)).sum(-1)  # [T, E], a permutation of 0..E-1
    order = torch.empty_like(rank).scatter_(
        1, rank, torch.arange(E, device=logits.device).expand(T, E))
    idx = order[:, :top_k]
    weights = torch.softmax(logits.gather(1, idx), dim=-1)
    return idx, weights


def make_dispatch(
    idx: torch.Tensor,  # [T, k] expert ids
    weights: torch.Tensor,  # [T, k] f32
    num_experts: int,
    capacity: int,
    mask: Optional[torch.Tensor] = None,  # [T, k] bool: valid assignments
) -> tuple[torch.Tensor, torch.Tensor]:
    """GShard dispatch [T, E, C] (token t occupies slot c of expert e) and
    combine [T, E, C] (the same positions carrying the routing weight), both
    f32. Slots go in order of arrival (t-major, then k); assignments past
    capacity are dropped; masked-out ones neither dispatch nor take a slot."""
    T, k = idx.shape
    onehot = F.one_hot(idx.long(), num_experts).to(torch.int32)  # [T, k, E]
    if mask is not None:
        onehot = onehot * mask[..., None].to(torch.int32)
    flat = onehot.reshape(T * k, num_experts)
    pos = (torch.cumsum(flat, dim=0) - flat).reshape(T, k, num_experts)
    in_cap = pos < capacity
    slot = pos.clamp(0, capacity - 1)
    disp = F.one_hot(slot.long(), capacity).float() * (onehot * in_cap)[..., None]
    combine = disp * weights.float()[:, :, None, None]
    return disp.sum(1), combine.sum(1)


def _expert_ffn(xe: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    """Per-expert SwiGLU FFN on dispatched tokens xe [E, C, D]."""
    gate = torch.einsum("ecd,edf->ecf", xe, wg)
    up = torch.einsum("ecd,edf->ecf", xe, wu)
    return torch.einsum("ecf,efd->ecd", swiglu(gate, up), wd)


def _router(x: torch.Tensor, router_w: torch.Tensor, top_k: int):
    logits = torch.matmul(x.float(), router_w.float())  # [T, E] f32
    return router_topk(logits, top_k)


def moe_ffn(
    x: torch.Tensor,  # [T, D]
    router_w: torch.Tensor,  # [D, E]
    wg: torch.Tensor,  # [E, D, F]
    wu: torch.Tensor,
    wd: torch.Tensor,  # [E, F, D]
    top_k: int,
    capacity_factor: float = 1.25,
    capacity: Optional[int] = None,
    token_chunk: int = 512,
    group=None,
) -> torch.Tensor:
    """GShard-dispatch MoE FFN (reference moe.py:180). The token axis runs
    in ``token_chunk``-sized chunks (the last one zero-padded, as the
    reference pads before its vmap: padding rows come after the real ones,
    so they take no slot a real token would have had), so the dispatch
    tensors stay O(chunk^2). Weights renormalize over the weight mass that
    survived capacity. Under a group (each rank's wg / wu / wd the FFN
    slice) the f32 output is summed over the ranks before the cast."""
    T, D = x.shape
    if capacity is None and token_chunk and T > token_chunk:
        pad = (-T) % token_chunk
        xp = torch.cat([x, x.new_zeros(pad, D)]) if pad else x
        parts = [moe_ffn(c, router_w, wg, wu, wd, top_k, capacity_factor=capacity_factor,
                         token_chunk=0, group=group)
                 for c in xp.split(token_chunk)]
        return torch.cat(parts)[:T]
    E = router_w.shape[-1]
    idx, weights = _router(x, router_w, top_k)
    if capacity is None:
        capacity = default_capacity(T, E, top_k, capacity_factor)
    disp, combine = make_dispatch(idx, weights, E, capacity)
    xe = torch.einsum("td,tec->ecd", x.float(), disp)
    ye = _expert_ffn(xe.to(x.dtype), wg, wu, wd)  # [E, C, D]
    y = torch.einsum("ecd,tec->td", ye.float(), combine)
    if group is not None:
        y = group.all_reduce(y)
    kept = combine.sum(dim=(1, 2))  # [T]; 1 when nothing dropped
    y = y / kept.clamp_min(1e-9)[:, None]
    return y.to(x.dtype)


def expert_order(e_flat: torch.Tensor, n_groups: int):
    """The stable argsort of assignments by expert, on the device: (order
    [R]: the assignment at each sorted row; pos [R]: the sorted row of each
    assignment; offsets [n_groups + 1] int32: expert e owns sorted rows
    [offsets[e], offsets[e + 1])). A one-hot sum counts the groups and a
    running count within each expert places each assignment after the
    earlier ones of its expert."""
    R = e_flat.shape[0]
    dev = e_flat.device
    onehot = (e_flat[:, None] == torch.arange(n_groups, device=dev)).to(torch.int32)  # [R, E]
    counts = onehot.sum(0)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).to(torch.int32)
    before = (torch.cumsum(onehot, 0) - onehot).gather(1, e_flat[:, None])[:, 0]
    pos = offsets.long()[e_flat] + before
    order = torch.empty_like(pos).scatter_(0, pos, torch.arange(R, device=dev))
    return order, pos, offsets


def grouped_ffn_plain(
    xs: torch.Tensor,  # [R, D] rows sorted by expert
    offsets: torch.Tensor,  # [E + 1] int32
    wg: torch.Tensor,  # [E, D, F]
    wu: torch.Tensor,
    wd: torch.Tensor,  # [E, F, D]
) -> torch.Tensor:
    """Plain version of the grouped SwiGLU FFN (the CPU path and the card
    kernel's oracle): a loop over the experts' row slices, read on the
    host, each product in the input dtype (``lax.ragged_dot``'s output
    dtype), SwiGLU on them. Rows past ``offsets[E]`` are zeros, as
    ``ragged_dot`` leaves them."""
    bounds = offsets.tolist()
    out = torch.zeros(xs.shape[0], wd.shape[-1], dtype=xs.dtype, device=xs.device)
    for e in range(wg.shape[0]):
        lo, hi = bounds[e], bounds[e + 1]
        if lo == hi:
            continue
        h = xs[lo:hi]
        gate = torch.matmul(h, wg[e])
        up = torch.matmul(h, wu[e])
        out[lo:hi] = torch.matmul(swiglu(gate, up), wd[e])
    return out


def _grouped_ffn(xs, offsets, wg, wu, wd) -> torch.Tensor:
    """The grouped SwiGLU FFN: the CUDA kernel for CUDA tensors (it raises
    on what it does not take), the plain version for CPU tensors."""
    if xs.is_cuda:
        return grouped_swiglu_ffn_cuda(xs, offsets, wg, wu, wd)
    return grouped_ffn_plain(xs, offsets, wg, wu, wd)


def _sorted_dispatch_combine(
    x: torch.Tensor,  # [T, D]
    idx: torch.Tensor,  # [T, k] expert ids in [0, n_groups)
    weights: torch.Tensor,  # [T, k] f32
    n_groups: int,
    wg: torch.Tensor,  # [n_groups, D, F]
    wu: torch.Tensor,
    wd: torch.Tensor,
) -> torch.Tensor:
    """Sort assignments by expert, run the grouped FFN, combine: returns f32
    [T, D], each token's k weighted contributions summed in order j = 0..k-1."""
    T, D = x.shape
    k = idx.shape[1]
    order, pos, offsets = expert_order(idx.reshape(-1), n_groups)
    xs = x.index_select(0, order // k)  # [T*k, D], the source token of each sorted row
    ys = _grouped_ffn(xs, offsets, wg, wu, wd)  # [T*k, D]
    contrib = ys.index_select(0, pos).reshape(T, k, D).float() * weights.float()[..., None]
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y


def moe_ffn_dropless(
    x: torch.Tensor,  # [T, D]
    router_w: torch.Tensor,  # [D, E]
    wg: torch.Tensor,  # [E, D, F]
    wu: torch.Tensor,
    wd: torch.Tensor,  # [E, F, D]
    top_k: int,
    group=None,
) -> torch.Tensor:
    """Dropless MoE FFN (reference moe.py:156): route, sort by expert,
    grouped FFN, combine in f32, cast to x's dtype. Under a group (each
    rank's wg / wu / wd the FFN slice, the router whole) the ranks' f32
    partials are summed before the cast."""
    idx, weights = _router(x, router_w, top_k)
    y = _sorted_dispatch_combine(x, idx, weights, router_w.shape[-1], wg, wu, wd)
    if group is not None:
        y = group.all_reduce(y)
    return y.to(x.dtype)


def moe_ffn_shard_map(
    group,  # the rank's TPGroup; its ep line holds the experts
    x: torch.Tensor,  # [T, D] replicated over the grid's ep line
    router_w: torch.Tensor,  # [D, E] replicated
    wg: torch.Tensor,  # [E / ep, D, F / tp] the rank's experts
    wu: torch.Tensor,
    wd: torch.Tensor,  # [E / ep, F / tp, D]
    top_k: int,
) -> torch.Tensor:
    """Expert-parallel dropless MoE FFN with every token on every rank
    (reference moe.py:235): each rank routes all T tokens (the router is
    replicated, so every rank picks the same experts), computes only its
    own experts' assignments (the others weighted 0), and the f32 outputs
    are summed over ``tp`` (each expert's FFN slice) and then over ``ep``.
    One sum of [T, D] in place of two all-to-alls: the form for decode-sized
    batches."""
    ep = group.ep
    E = router_w.shape[-1]
    if E % ep.world_size:
        raise ValueError(f"{E} experts do not split into ep={ep.world_size}")
    e_loc = wg.shape[0]
    lo = ep.rank * e_loc
    idx, weights = _router(x, router_w, top_k)
    # the other ranks' assignments ride local expert 0's rows, weighted 0
    local = (idx >= lo) & (idx < lo + e_loc)
    y = _sorted_dispatch_combine(x, torch.where(local, idx - lo, 0),
                                 torch.where(local, weights, 0.0), e_loc, wg, wu, wd)
    y = group.tp.all_reduce(y)
    return ep.all_reduce(y).to(x.dtype)


def moe_ffn_ep_a2a(
    group,  # the rank's TPGroup; its ep line holds the experts
    x: torch.Tensor,  # [T, D] replicated over the ep line, T % ep == 0
    router_w: torch.Tensor,  # [D, E]
    wg: torch.Tensor,  # [E / ep, D, F / tp]
    wu: torch.Tensor,
    wd: torch.Tensor,  # [E / ep, F / tp, D]
    top_k: int,
    capacity_factor: Optional[float] = None,
) -> torch.Tensor:
    """Token-sharded expert-parallel MoE FFN (reference moe.py:304): this
    rank takes block ``ep.rank`` of the T / ep tokens, routes them, buckets
    each assignment into a [ep, cap, D] send buffer by its expert's rank (in
    order of arrival), ships the buffers, the local expert ids and the valid
    flags with three ``all_to_all``s, runs the grouped FFN over the rows it
    received (sorted by local expert; invalid rows are zeros on expert 0),
    sums the ``tp`` partials, ships the results back with one more
    ``all_to_all``, and combines each token's kept assignments in f32,
    renormalized over the weight that survived capacity. ``cap`` is
    T_loc * k when ``capacity_factor`` is None (dropless), else
    max(int(factor * T_loc * k / ep), k), assignments past it dropped.
    Returns [T, D], the ep blocks all-gathered back into the replicated
    stream."""
    ep = group.ep
    n = ep.world_size
    E = router_w.shape[-1]
    T, D = x.shape
    if E % n or T % n:
        raise ValueError(f"{E} experts and {T} tokens must both split into ep={n}")
    e_loc = E // n
    T_loc = T // n
    xl = x[ep.rank * T_loc:(ep.rank + 1) * T_loc]
    dev = x.device
    idx, weights = _router(xl, router_w, top_k)  # [T_loc, k]
    A = T_loc * top_k
    dest = (idx // e_loc).reshape(A)
    le = (idx % e_loc).reshape(A)
    w_f = weights.reshape(A)
    rows = torch.arange(A, device=dev) // top_k
    onehot = F.one_hot(dest, n).to(torch.int64)  # [A, ep]
    pos = (torch.cumsum(onehot, 0) - onehot).gather(1, dest[:, None])[:, 0]
    if capacity_factor is None:
        cap = T_loc * top_k  # dropless
    else:
        cap = max(int(capacity_factor * T_loc * top_k / n), top_k)
    in_cap = pos < cap
    slot = torch.where(in_cap, pos, cap)  # overflow -> the spill row
    send_x = x.new_zeros(n, cap + 1, D)
    send_x[dest, slot] = xl[rows]
    send_le = torch.zeros(n, cap + 1, dtype=torch.int64, device=dev)
    send_le[dest, slot] = le
    send_ok = torch.zeros(n, cap + 1, dtype=torch.bool, device=dev)
    send_ok[dest, slot] = in_cap
    R = n * cap
    recv_x = ep.all_to_all(send_x[:, :cap].reshape(R, D))
    recv_le = ep.all_to_all(send_le[:, :cap].reshape(R))
    recv_ok = ep.all_to_all(send_ok[:, :cap].reshape(R))
    rle = torch.where(recv_ok, recv_le, 0)
    rx = torch.where(recv_ok[:, None], recv_x, 0)
    order, pos_sorted, offsets = expert_order(rle, e_loc)
    ys = _grouped_ffn(rx.index_select(0, order).contiguous(), offsets, wg, wu, wd)
    if group.tp.world_size > 1:  # each expert's wd rows are split over tp
        ys = group.tp.all_reduce(ys.float()).to(x.dtype)
    ys = ys.index_select(0, pos_sorted)  # back in received order
    back = ep.all_to_all(ys).reshape(n, cap, D)
    back = torch.cat([back, back.new_zeros(n, 1, D)], dim=1)  # the spill row reads zeros
    contrib = back[dest, slot].float()  # [A, D]
    w_kept = torch.where(in_cap, w_f, 0.0)
    y = torch.zeros(T_loc, D, dtype=torch.float32, device=dev)
    y.index_add_(0, rows, contrib * w_kept[:, None])
    kept = torch.zeros(T_loc, dtype=torch.float32, device=dev).index_add_(0, rows, w_kept)
    y = (y / kept.clamp_min(1e-9)[:, None]).to(x.dtype)
    return ep.all_gather(y, dim=0)
