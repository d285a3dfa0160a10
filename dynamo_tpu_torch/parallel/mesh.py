"""The tensor-parallel group: one process per rank over torch.distributed.

Counterpart of dynamo_tpu/parallel/mesh.py:21-43 for the one axis the
port serves, ``tp``. The JAX package runs tensor parallelism as one
controller over a mesh of devices (GSPMD); PyTorch's idiom is one process
per rank, so a ``TPGroup`` is this process's place in a group of ``tp``
ranks: its rank, the world size, its device and a ``torch.distributed``
process group, with the four collectives the sharded model needs
(``all_reduce`` (sum), ``all_gather`` (tiled on a dim), ``broadcast`` and
the ring ``ppermute``).

The backend and the devices are the caller's explicit choice. By default
rank r sits on ``cuda:r`` over NCCL, and a group larger than the card
count raises, as ``build_mesh`` does. ``devices="cpu"`` puts every rank on
the CPU (gloo); a list places each rank on its own entry, e.g. two ranks on
``["cuda:0", "cuda:0"]`` over gloo, which checks correctness on one card
(NCCL refuses two ranks on one device) and says nothing of collective speed.
Nothing picks a backend because another one failed.

gloo does not take CUDA tensors for every op: with torch 2.11.0+cu128 on
an H100 its all_reduce, broadcast and all_gather take them
(gloo copies through host memory itself), but send / recv of a CUDA tensor
aborts the process (``gloo::IoException``: writev "Bad address"). So when
the caller chose gloo with CUDA devices, the ring hop (``ppermute``) stages
its tensor through host memory here, explicitly, and counts it
(``staged_ops``, ``staged_bytes``); NCCL and CPU tensors are never staged.
``seconds`` sums the host time spent inside every collective (gloo's own
host copies and this staging included).

Besides the data group, the ranks share a control group (gloo, CPU tensors)
for the leader's step broadcasts (parallel/multihost.py). A follower waits
there between steps, so its timeout is how long a leader may stay idle
(``idle_timeout_s``); a leader that dies closes its connections, which a
waiting follower sees at once. The data group's ``timeout_s`` bounds every
collective of a step, so a rank never wedges inside one.

A single card without a group (``tp = 1`` and no ``TPGroup``) is the
single-device path, unchanged.
"""

from __future__ import annotations

import time
from datetime import timedelta
from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

Devices = Union[None, str, Sequence[str]]


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


class TPGroup:
    """This process's rank in a tensor-parallel group (see the module
    docstring). Every rank constructs one with the same ``init_method``
    (``tcp://127.0.0.1:<port>``), backend and devices; the constructor
    returns once all ``world_size`` ranks have joined."""

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
    ) -> None:
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside a group of {world_size}")
        self.rank = rank
        self.world_size = world_size
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
        self.control = dist.new_group(backend="gloo", timeout=timedelta(seconds=idle_timeout_s))
        # gloo with CUDA tensors: send / recv go through host memory here
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.staged_ops = 0
        self.staged_bytes = 0
        self.seconds = 0.0
        self._open = True

    # ------------------------------------------------------ collectives

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t`` (same shape and dtype on each)."""
        t0 = time.perf_counter()
        t = t.contiguous()
        dist.all_reduce(t)
        self.seconds += time.perf_counter() - t0
        return t

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order (the
        tiled all-gather)."""
        t0 = time.perf_counter()
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world_size)]
        dist.all_gather(parts, t)
        out = torch.cat(parts, dim=dim)
        self.seconds += time.perf_counter() - t0
        return out

    def broadcast(self, t: torch.Tensor, src: int = 0, *, control: bool = False) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank (returned). ``control`` uses
        the control group (CPU tensors only)."""
        t0 = time.perf_counter()
        t = t.contiguous()
        dist.broadcast(t, src, group=self.control if control else None)
        if not control:
            self.seconds += time.perf_counter() - t0
        return t

    def ppermute(self, t: torch.Tensor, shift: int) -> torch.Tensor:
        """One ring hop: this rank sends ``t`` to rank ``(rank + shift) % tp``
        and returns what rank ``(rank - shift) % tp`` sent (``jax.lax.ppermute``
        over the ring ``[(j, (j + shift) % tp)]``). One rank: ``t`` itself."""
        n = self.world_size
        if n == 1:
            return t
        t0 = time.perf_counter()
        h = t.contiguous()
        if self.staged:  # gloo's send / recv take host tensors only
            self.staged_ops += 1
            self.staged_bytes += h.numel() * h.element_size()
            h = h.cpu()
        out = torch.empty_like(h)
        ops = [
            dist.P2POp(dist.isend, h, (self.rank + shift) % n),
            dist.P2POp(dist.irecv, out, (self.rank - shift) % n),
        ]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if self.staged:
            out = out.to(self.device)
        self.seconds += time.perf_counter() - t0
        return out

    def gather_objects(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order, over the control
        group."""
        out: list = [None] * self.world_size
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
        return (f"TPGroup(rank={self.rank}, world_size={self.world_size}, "
                f"backend={self.backend!r}, device={self.device})")

