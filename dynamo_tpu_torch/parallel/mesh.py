"""The rank grid: one process per rank over torch.distributed.

Counterpart of dynamo_tpu/parallel/mesh.py:21-43 (``build_mesh``). The JAX
package runs its parallel paths as one controller over a mesh of devices
whose axes are ``dp x pp x sp x ep x tp`` (GSPMD and shard_map); PyTorch's
idiom is one process per rank, so a ``TPGroup`` is this process's place in
a grid of ranks with the reference's axes, in its order (tp innermost): its
global rank, its coordinate on each axis, its device, the default
``torch.distributed`` process group of the whole grid, and one process
group per line of every axis whose size is neither 1 nor the whole grid
(``new_group``; an axis that spans the grid uses the default group). The
sizes must multiply to the rank count (the reference's size check, held
exactly since a rank holds one device). ``axis(name)`` gives this rank's
line on an axis as an ``AxisGroup`` with the collectives the parallel paths
need: ``all_reduce`` (sum), ``all_gather`` (tiled on a dim), ``broadcast``,
the ring ``ppermute`` and the tiled ``all_to_all``. The group itself reads
as its ``tp`` line (``rank``, ``world_size``, ``all_reduce``, ...), which is
what the sharded model uses; ``gather`` and ``scatter`` move KV blocks'
heads to and from the leader (global rank 0) over the whole grid, and
``gather_objects`` collects one object from every rank. A grid of ``tp``
alone is the tensor-parallel group of earlier slices.

The backend and the devices are the caller's explicit choice. By default
rank r sits on ``cuda:r`` over NCCL, and a group larger than the card
count raises, as ``build_mesh`` does. ``devices="cpu"`` puts every rank on
the CPU (gloo); a list places each rank on its own entry, e.g. two ranks on
``["cuda:0", "cuda:0"]`` over gloo, which checks correctness on one card
(NCCL refuses two ranks on one device) and says nothing of collective speed.
Nothing picks a backend because another one failed.

gloo does not take CUDA tensors for every op: with torch 2.11.0+cu128 on
an H100 its all_reduce, broadcast, all_gather and all_to_all_single take
them (gloo copies through host memory itself), but send / recv of a CUDA tensor
aborts the process (``gloo::IoException``: writev "Bad address"). So when
the caller chose gloo with CUDA devices, the ring hop (``ppermute``)
stages its tensor through host memory here, explicitly, and counts it
(``staged_ops``, ``staged_bytes``); ``gather`` and ``scatter`` run on the
host for gloo in every case (a card's tensor staged and counted the same
way). NCCL and CPU tensors are never staged.
``seconds`` sums the host time spent inside every collective (gloo's own
host copies and this staging included).

Besides the data group, the ranks share a control group (gloo, CPU tensors)
for the leader's step broadcasts (parallel/multihost.py). A follower waits
there between steps, so its timeout (``idle_timeout_s``) bounds the gap
between two broadcasts; an idle leader keeps the gap shorter with
keep-alive broadcasts, and a leader that dies closes its connections,
which a waiting follower sees at once. The data group's ``timeout_s`` bounds every
collective of a step, so a rank never wedges inside one.

A single card without a group (no ``TPGroup``) is the single-device path,
unchanged.
"""

from __future__ import annotations

import time
from datetime import timedelta
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

Devices = Union[None, str, Sequence[str]]


class ScatterSpec(NamedTuple):
    """The shape and dtype of the part a rank receives from a scatter."""

    shape: tuple
    dtype: torch.dtype


def rank_devices(world_size: int, devices: Devices = None) -> list[torch.device]:
    """Each rank's device: ``cuda:r`` by default (raises when the group is
    larger than the card count), every rank on the CPU for ``"cpu"``, else
    the caller's list, one entry per rank."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world_size > have:
            raise ValueError(
                f"tp={world_size} needs {world_size} CUDA devices, have {have}; "
                "pass devices= to place the ranks yourself"
            )
        return [torch.device("cuda", r) for r in range(world_size)]
    if isinstance(devices, str):
        return [torch.device(devices)] * world_size
    devs = [torch.device(d) for d in devices]
    if len(devs) != world_size:
        raise ValueError(f"{len(devs)} devices given for {world_size} ranks")
    return devs


AXES = ("dp", "pp", "sp", "ep", "tp")


def grid_shape(world_size: int, axes=None) -> tuple[int, ...]:
    """The grid's sizes in ``AXES`` order from ``axes`` (a dict of axis ->
    size, missing axes 1; None: every rank on ``tp``). Raises ValueError
    unless they multiply to ``world_size`` (``build_mesh``'s size check,
    dynamo_tpu/parallel/mesh.py:30-36, held exactly: a rank process holds
    one device)."""
    sizes = dict(axes or {"tp": world_size})
    unknown = set(sizes) - set(AXES)
    if unknown:
        raise ValueError(f"unknown grid axes {sorted(unknown)}; the axes are {AXES}")
    shape = tuple(int(sizes.get(a, 1)) for a in AXES)
    if min(shape) < 1 or int(np.prod(shape)) != world_size:
        desc = " ".join(f"{a}={n}" for a, n in zip(AXES, shape))
        raise ValueError(f"mesh {desc} needs {int(np.prod(shape))} ranks, have {world_size}")
    return shape


class AxisGroup:
    """One axis of the grid as this rank sees it: ``rank`` is this rank's
    coordinate on the axis, ``world_size`` the axis size, ``members`` the
    global ranks of its line in axis order, and ``pg`` the line's process
    group (None: the default group, when the axis spans the world). Its
    collectives run over the line only, under the grid's staging rule and
    counters (see the module docstring). A one-rank axis returns its input."""

    def __init__(self, grid: "TPGroup", members: list[int], pg) -> None:
        self.grid = grid
        self.members = members
        self.world_size = len(members)
        self.rank = members.index(grid.global_rank)
        self.pg = pg

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of the line's ``t`` (same shape and dtype on each)."""
        if self.world_size == 1:
            return t
        g = self.grid
        t0 = time.perf_counter()
        t = t.contiguous()
        dist.all_reduce(t, group=self.pg)
        g.seconds += time.perf_counter() - t0
        return t

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The line's ``t`` concatenated along ``dim`` in axis order (the
        tiled all-gather)."""
        if self.world_size == 1:
            return t
        g = self.grid
        t0 = time.perf_counter()
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world_size)]
        dist.all_gather(parts, t, group=self.pg)
        out = torch.cat(parts, dim=dim)
        g.seconds += time.perf_counter() - t0
        return out

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """The ``t`` of the rank at coordinate ``src`` on every rank of the
        line (returned)."""
        if self.world_size == 1:
            return t
        g = self.grid
        t0 = time.perf_counter()
        t = t.contiguous()
        dist.broadcast(t, self.members[src], group=self.pg)
        g.seconds += time.perf_counter() - t0
        return t

    def ppermute(self, t: torch.Tensor, shift: int) -> torch.Tensor:
        """One ring hop along the axis: this rank sends ``t`` to coordinate
        ``(rank + shift) % n`` and returns what ``(rank - shift) % n`` sent
        (``jax.lax.ppermute`` over the ring ``[(j, (j + shift) % n)]``)."""
        n = self.world_size
        if n == 1:
            return t
        g = self.grid
        t0 = time.perf_counter()
        h = g._stage(t.contiguous())
        out = torch.empty_like(h)
        ops = [
            dist.P2POp(dist.isend, h, self.members[(self.rank + shift) % n], group=self.pg),
            dist.P2POp(dist.irecv, out, self.members[(self.rank - shift) % n], group=self.pg),
        ]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if g.staged:
            out = out.to(g.device)
        g.seconds += time.perf_counter() - t0
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """The tiled all-to-all on dim 0 (``lax.all_to_all(split_axis=0,
        concat_axis=0, tiled=True)``): ``t`` [n * c, ...] is cut into n
        equal blocks, block j goes to coordinate j, and block i of the
        result is what coordinate i sent here. Not staged: gloo's
        ``all_to_all_single`` takes CUDA tensors (it copies through host
        memory itself), as two gloo ranks on one H100 showed with torch
        2.11.0+cu128."""
        n = self.world_size
        if n == 1:
            return t
        if t.shape[0] % n:
            raise ValueError(f"dim 0 of {tuple(t.shape)} does not split into {n} blocks")
        g = self.grid
        t0 = time.perf_counter()
        h = t.contiguous()
        flat = h.dtype == torch.bool
        if flat:  # no bool all-to-all
            h = h.to(torch.uint8)
        out = torch.empty_like(h)
        dist.all_to_all_single(out, h, group=self.pg)
        if flat:
            out = out.bool()
        g.seconds += time.perf_counter() - t0
        return out


class TPGroup:
    """This process's rank in a grid of ranks (see the module docstring).
    Every rank constructs one with the same ``init_method``
    (``tcp://<host>:<port>``), backend, devices and ``axes``; the
    constructor returns once all ``world_size`` ranks have joined and every
    axis line has its process group.

    ``global_rank`` / ``global_size`` are the rank's place in the whole
    grid, ``coords`` its coordinate on each axis, and ``axis(name)`` (or
    ``.tp``, ``.sp``, ``.ep``, ``.dp``, ``.pp``) the AxisGroup of its line.
    ``rank`` and ``world_size`` are the ``tp`` axis's, and ``all_reduce``,
    ``all_gather``, ``ppermute`` and ``broadcast`` run over the ``tp`` line:
    that is what the sharded model reads of a group. On a grid with tp
    alone they are the whole world's."""

    def __init__(
        self,
        rank: int,
        world_size: int,
        *,
        init_method: str,
        backend: str = "nccl",
        devices: Devices = None,
        timeout_s: float = 600.0,
        idle_timeout_s: float = 86400.0,
        axes=None,
    ) -> None:
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside a group of {world_size}")
        shape = grid_shape(world_size, axes)
        self.global_rank = rank
        self.global_size = world_size
        self.axes = dict(zip(AXES, shape))
        self.coords = dict(zip(AXES, (int(c) for c in np.unravel_index(rank, shape))))
        self.backend = backend
        self.device = rank_devices(world_size, devices)[rank]
        if self.device.type == "cuda":
            if self.device.index is None:
                self.device = torch.device("cuda", 0)
            torch.cuda.set_device(self.device)
        elif backend == "nccl":
            raise ValueError("NCCL takes CUDA devices only; use backend='gloo' on the CPU")
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world_size,
            timeout=timedelta(seconds=timeout_s),
        )
        self.idle_timeout_s = idle_timeout_s
        self.control = dist.new_group(backend="gloo", timeout=timedelta(seconds=idle_timeout_s))
        # gloo with CUDA tensors: send / recv go through host memory here
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.staged_ops = 0
        self.staged_bytes = 0
        self.seconds = 0.0
        self._open = True
        # one process group per line of every axis that is neither 1 nor
        # the whole world; every rank creates every line's, in one order
        grid = np.arange(world_size).reshape(shape)
        self._axes: dict[str, AxisGroup] = {}
        for i, name in enumerate(AXES):
            lines = np.moveaxis(grid, i, -1).reshape(-1, shape[i])
            mine = next(line for line in lines if rank in line).tolist()
            pg = None
            if 1 < shape[i] < world_size:
                for line in lines:
                    g = dist.new_group(line.tolist(), backend=backend,
                                       timeout=timedelta(seconds=timeout_s))
                    if rank in line:
                        pg = g
            self._axes[name] = AxisGroup(self, mine, pg)
        self.tp = self._axes["tp"]
        self.rank = self.tp.rank
        self.world_size = self.tp.world_size

    def axis(self, name: str) -> AxisGroup:
        """The AxisGroup of this rank's line on axis ``name``."""
        return self._axes[name]

    @property
    def sp(self) -> AxisGroup:
        return self._axes["sp"]

    @property
    def ep(self) -> AxisGroup:
        return self._axes["ep"]

    @property
    def dp(self) -> AxisGroup:
        return self._axes["dp"]

    @property
    def pp(self) -> AxisGroup:
        return self._axes["pp"]

    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where gloo's point-to-point ops take it: on the host (and
        counted) when this gloo rank sits on a card, else itself."""
        if not self.staged:
            return t
        self.staged_ops += 1
        self.staged_bytes += t.numel() * t.element_size()
        return t.cpu()

    # ------------------------------------------------------ collectives

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of the ``tp`` line's ``t`` (same shape and dtype on each)."""
        return self.tp.all_reduce(t)

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The ``tp`` line's ``t`` concatenated along ``dim`` in rank order
        (the tiled all-gather)."""
        return self.tp.all_gather(t, dim)

    def broadcast(self, t: torch.Tensor, src: int = 0, *, control: bool = False) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank (returned): over the ``tp``
        line, or with ``control`` from global rank ``src`` over the whole
        world's control group (CPU tensors only)."""
        if not control:
            return self.tp.broadcast(t, src)
        t = t.contiguous()
        dist.broadcast(t, src, group=self.control)
        return t

    def ppermute(self, t: torch.Tensor, shift: int) -> torch.Tensor:
        """One ring hop along the ``tp`` line (``AxisGroup.ppermute``). One
        rank: ``t`` itself."""
        return self.tp.ppermute(t, shift)

    def _comm(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where this group's collectives take it: on the host for
        gloo (counted as staged when this rank sits on a card), on the
        rank's device for NCCL."""
        if self.backend == "gloo":
            if t.device.type != "cpu":
                self.staged_ops += 1
                self.staged_bytes += t.numel() * t.element_size()
            return t.cpu()
        return t.to(self.device)

    def gather(self, t: torch.Tensor, dim: int, dst: int = 0) -> Optional[torch.Tensor]:
        """The ``tp`` line of rank ``dst``: its ranks' ``t`` (the same shape
        and dtype on each) concatenated along ``dim`` in ``tp`` order, on
        global rank ``dst`` (the leader, 0), which returns it on the host for
        gloo and on its device for NCCL; every other rank returns None.
        Every rank of the world takes part (ranks off ``dst``'s line hold
        replicas of some line's heads, which are dropped). One rank: ``t``
        itself."""
        if self.global_size == 1:
            return t
        t0 = time.perf_counter()
        h = self._comm(t.contiguous())
        parts = ([torch.empty_like(h) for _ in range(self.global_size)]
                 if self.global_rank == dst else None)
        dist.gather(h, parts, dst=dst)
        self.seconds += time.perf_counter() - t0
        if parts is None:
            return None
        line = self._line_of(dst)
        return torch.cat([parts[r] for r in line], dim=dim)

    def scatter(self, t: Optional[torch.Tensor], dim: int, part: Optional["ScatterSpec"] = None,
                src: int = 0) -> torch.Tensor:
        """Global rank ``src``'s ``t`` cut into ``tp`` equal parts along
        ``dim``; every rank gets the part of its ``tp`` coordinate, on its
        device (ranks that differ only off the ``tp`` axis get the same
        part: the replicated axes). The other ranks pass ``part``, the shape
        and dtype of the part they receive. One rank: ``t`` itself."""
        if self.global_size == 1:
            return t.to(self.device)
        t0 = time.perf_counter()
        if self.global_rank == src:
            tp = self.world_size
            if t.shape[dim] % tp:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split into "
                                 f"{tp} parts")
            chunks = [self._comm(p.contiguous()) for p in t.chunk(tp, dim)]
            parts = [chunks[r % tp] for r in range(self.global_size)]  # tp is innermost
            out = torch.empty_like(chunks[0])
        else:
            parts = None
            out = self._comm(torch.empty(part.shape, dtype=part.dtype))
        dist.scatter(out, parts, src=src)
        self.seconds += time.perf_counter() - t0
        return out.to(self.device)

    def _line_of(self, rank: int) -> list[int]:
        """The global ranks of ``rank``'s ``tp`` line, in ``tp`` order (tp
        is the innermost axis, so they are consecutive)."""
        tp = self.world_size
        base = rank - rank % tp
        return list(range(base, base + tp))

    def gather_objects(self, obj) -> list:
        """Every rank's picklable ``obj``, in global rank order, over the
        control group."""
        out: list = [None] * self.global_size
        dist.all_gather_object(out, obj, group=self.control)
        return out

    def stats(self) -> dict:
        return {"staged_ops": self.staged_ops, "staged_bytes": self.staged_bytes,
                "collective_s": self.seconds}

    def close(self) -> None:
        """Leave the group (every rank calls it once at the end)."""
        if self._open:
            self._open = False
            self.control = None  # the last reference: its connections close
            dist.destroy_process_group()

    def __repr__(self) -> str:
        grid = " ".join(f"{a}={n}" for a, n in self.axes.items() if n > 1) or "tp=1"
        return (f"TPGroup(global_rank={self.global_rank}, {grid}, "
                f"backend={self.backend!r}, device={self.device})")

