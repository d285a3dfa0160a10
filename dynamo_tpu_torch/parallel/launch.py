"""Rank processes on one node: a free rendezvous port, and running a
function on every rank of a fresh group.

The factory spawns a tensor-parallel engine's followers itself
(engine/torch_engine/factory.py); ``run_ranks`` spawns every rank of a
group to run one function and returns what each returned, e.g. to run the
sharded ops on the CPU over gloo beside their one-device counterparts.
Processes start with the ``spawn`` method (no state of this process is
inherited) and rendezvous over ``tcp://127.0.0.1:<free port>``.
"""

from __future__ import annotations

import queue as queue_mod
import socket
import traceback
from typing import Any, Callable, Sequence

import torch
import torch.multiprocessing as mp


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def init_method(port: int) -> str:
    return f"tcp://127.0.0.1:{port}"


def to_host(obj: Any) -> Any:
    """Tensors (in tuples, lists, dicts) as numpy arrays; bf16 as f32."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(o) for o in obj)
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    return obj


def call_with_group(group, fn: Callable, *args, **kwargs):
    """``fn(*args, group=group, **kwargs)``: for functions that take the
    group as a keyword (the model's entry points)."""
    return fn(*args, group=group, **kwargs)


def call_each(group, calls: Sequence[tuple]) -> list:
    """A ``run_ranks`` target running several calls in turn on one group:
    ``fn(group, *args, **kwargs)`` for each ``(fn, args, kwargs)``; returns
    their results in order (``fn`` importable by name)."""
    return [fn(group, *args, **kwargs) for fn, args, kwargs in calls]


def _rank_main(rank, world, method, backend, devices, timeout_s, threads, axes, target, args,
               results) -> None:
    from dynamo_tpu_torch.parallel.mesh import TPGroup

    if threads:
        torch.set_num_threads(threads)
    group = None
    try:
        group = TPGroup(rank, world, init_method=method, backend=backend, devices=devices,
                        timeout_s=timeout_s, idle_timeout_s=timeout_s, axes=axes)
        with torch.inference_mode():
            out = target(group, *args)
        results.put((rank, True, to_host(out)))
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        if group is not None:
            group.close()


def run_ranks(
    world: int,
    target: Callable,
    rank_args: Sequence[tuple],
    *,
    backend: str = "gloo",
    devices="cpu",
    timeout_s: float = 120.0,
    threads: int = 1,
    axes=None,
) -> list:
    """Spawn ``world`` ranks of a new group (a grid of ``axes`` sizes,
    TPGroup's; default tp = world); global rank r runs
    ``target(group, *rank_args[r])`` (``target`` importable by name) and its
    result comes back through ``to_host``. Returns the results in rank
    order; raises RuntimeError with a rank's traceback when one fails, and
    TimeoutError (after killing them) when the ranks take longer than
    ``timeout_s``."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    method = init_method(free_port())
    procs = [
        ctx.Process(target=_rank_main, daemon=True, args=(
            r, world, method, backend, devices, timeout_s, threads, axes, target,
            tuple(rank_args[r]), results))
        for r in range(world)
    ]
    for p in procs:
        p.start()
    out: dict[int, Any] = {}
    try:
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=timeout_s)
            except queue_mod.Empty:
                raise TimeoutError(f"{world - len(out)} of {world} ranks gave no result "
                                   f"within {timeout_s} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]
