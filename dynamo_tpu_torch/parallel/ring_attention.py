"""Ring attention: causal prefill attention with the sequence cut over the
grid's ``sp`` axis (context parallelism).

Counterpart of dynamo_tpu/parallel/ring_attention.py. Each rank of an
``sp`` line holds one chunk of C = P / sp queries and the keys / values of
the same positions; the K/V chunks travel around the line by ``ppermute``
while every rank folds each visiting chunk into its queries' f32 online
softmax, so after sp - 1 hops every query has seen every key and the result
is exact. Upstream this is XLA einsums and ``lax.ppermute`` under
shard_map, with no Pallas kernel, so it ports as torch ops on every device
(no kernel is owed).

What differs from the JAX functions, and why:

  * the hop-level skip (a chunk wholly in the future, or wholly left of the
    sliding window) is decided on the host, since both chunk indices are
    host ints here: a skipped hop runs no update at all, where the
    reference's ``lax.cond`` picks the identity branch;
  * the K/V chunks rotate sp - 1 times, not sp: the reference's last
    rotate only keeps its loop uniform and its result is never read;
  * ``ring_prefill_attention`` takes full replicated [P, H, D] arrays on
    every rank and returns the full result, all-gathered, where the
    reference takes and returns global arrays sharded over ``sp`` (and
    ``head_axis``): the port's ranks hold plain tensors, so the rank's
    chunk and heads are cut here and the pieces gathered back.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _flash_update(q, k, v, m, l, acc, qpos, kpos, valid_len: int, scale: float,
                  window: Optional[int] = None, softcap: Optional[float] = None):
    """One online-softmax accumulation of the query chunk against one K/V
    chunk (reference :38): f32 scores, the Gemma-2 soft-cap before the
    mask, the causal / valid-length / sliding-window mask, then the
    running max, normalizer and accumulator updated.

    q: [C, Hkv, G, D]; k / v: [C, Hkv, D]; m / l: [C, Hkv, G, 1]; acc like q.
    """
    s = torch.einsum("qhgd,khd->hgqk", q.float(), k.float()) * scale  # [Hkv, G, Cq, Ck]
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < valid_len)
    if window is not None:  # i sees (i - window, i]
        mask &= qpos[:, None] - kpos[None, :] < window
    s = torch.where(mask[None, None], s, torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    m_t = m.permute(1, 2, 0, 3)
    l_t = l.permute(1, 2, 0, 3)
    m_new = torch.maximum(m_t, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m_t - m_new)
    p = torch.exp(s - m_new)
    l_new = l_t * alpha + p.sum(dim=-1, keepdim=True)
    upd = torch.einsum("hgqk,khd->hgqd", p, v.float())
    acc_new = acc.permute(1, 2, 0, 3) * alpha + upd
    return m_new.permute(2, 0, 1, 3), l_new.permute(2, 0, 1, 3), acc_new.permute(2, 0, 1, 3)


def ring_attention_body(
    axis,  # the rank's AxisGroup over sp (parallel/mesh.py)
    q: torch.Tensor,  # [C, Hq, D] this rank's query chunk
    k: torch.Tensor,  # [C, Hkv, D] this rank's key chunk
    v: torch.Tensor,  # [C, Hkv, D]
    valid_len: int,  # the whole sequence's true length
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """The per-rank ring (reference :72): the rank at coordinate ``my`` of
    the line holds positions [my * C, (my + 1) * C); after i hops it holds
    the K/V chunk of coordinate (my - i) % sp. A chunk wholly in the future
    or wholly left of the window is skipped; rows past ``valid_len`` come
    back as zeros. Returns [C, Hq, D] in q's dtype."""
    C, Hq, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    sp, my = axis.world_size, axis.rank
    sc = float(scale) if scale is not None else 1.0 / float(D) ** 0.5
    dev = q.device
    qpos = my * C + torch.arange(C, device=dev)
    qr = q.reshape(C, Hkv, G, D)
    m = torch.full((C, Hkv, G, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(C, Hkv, G, 1, dtype=torch.float32, device=dev)
    acc = torch.zeros(C, Hkv, G, D, dtype=torch.float32, device=dev)
    k_cur, v_cur = k, v
    for i in range(sp):
        src = (my - i) % sp
        needed = src <= my
        if window is not None:  # its newest key within the window of our oldest query
            needed = needed and src * C + C - 1 >= my * C - (window - 1)
        if needed:
            kpos = src * C + torch.arange(C, device=dev)
            m, l, acc = _flash_update(qr, k_cur, v_cur, m, l, acc, qpos, kpos, valid_len, sc,
                                      window=window, softcap=logit_softcap)
        if i < sp - 1:
            k_cur = axis.ppermute(k_cur, 1)
            v_cur = axis.ppermute(v_cur, 1)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / safe_l).reshape(C, Hq, D)
    out = torch.where((qpos < valid_len)[:, None, None], out, torch.zeros_like(out))
    return out.to(q.dtype)


def ring_prefill_attention(
    group,  # the rank's TPGroup (parallel/mesh.py)
    q: torch.Tensor,  # [P, Hq, D] the whole sequence (P divisible by sp)
    k: torch.Tensor,  # [P, Hkv, D]
    v: torch.Tensor,
    valid_len: int,
    *,
    axis_name: str = "sp",
    head_axis: Optional[str] = None,  # "tp" when the heads are split over tp
    window: Optional[int] = None,
    scale: Optional[float] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Causal self-attention with the sequence cut over ``axis_name``
    (reference :135): this rank's chunk (and, with ``head_axis``, its heads)
    of the replicated inputs rides ``ring_attention_body``, and the pieces
    are all-gathered back. Returns [P, Hq, D] on every rank."""
    axis = group.axis(axis_name)
    sp = axis.world_size
    P = q.shape[0]
    if P % sp:
        raise ValueError(f"sequence of {P} does not split into {axis_name}={sp}")
    C = P // sp
    rows = slice(axis.rank * C, (axis.rank + 1) * C)
    heads = group.axis(head_axis) if head_axis is not None else None

    def cut(t):
        t = t[rows]
        if heads is not None:
            n = t.shape[1] // heads.world_size
            t = t[:, heads.rank * n:(heads.rank + 1) * n]
        return t.contiguous()

    out = ring_attention_body(axis, cut(q), cut(k), cut(v), valid_len, window=window,
                              scale=scale, logit_softcap=logit_softcap)
    if heads is not None:
        out = heads.all_gather(out, dim=1)
    return axis.all_gather(out, dim=0)
