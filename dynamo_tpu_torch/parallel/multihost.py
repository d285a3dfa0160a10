"""The leader / follower step protocol of a tensor-parallel engine, on one
node.

Counterpart of dynamo_tpu/parallel/multihost.py (``LeaderLostError``
:43-47, the opcodes :47-60, ``SpmdStepChannel`` :162-200,
``SpmdModelRunner`` :200-472, ``follower_loop`` :563). Every rank's model
calls issue collectives, so all ranks must make the same calls in the same
order with the same host inputs. The engine's asyncio loop is dynamic, so
only the leader (rank 0) runs it; each follower runs ``follower_loop``,
which receives every runner call the leader makes through the step channel
and replays it. The leader's ``SpmdModelRunner`` broadcasts each call
(opcode and host inputs) before running it. Sampling keys are drawn on the
leader and ride in the payload, so every rank samples the same tokens; only
the leader reads its results back.

The channel broadcasts over the group's control group
(``TPGroup.broadcast(..., control=True)``): a header tensor [opcode,
payload bytes], then the pickled (args, kwargs) of the call as a uint8
tensor. A follower whose leader dies sees the broken connection in that
broadcast and raises ``LeaderLostError`` instead of waiting on.

Multi-node bring-up (the fabric rendezvous and ``jax.distributed``-style
initialisation) is not ported: ranks are processes of one node
(engine/torch_engine/factory.py spawns them).
"""

from __future__ import annotations

import logging
import pickle

import numpy as np
import torch

logger = logging.getLogger("dynamo_tpu_torch.parallel.multihost")


class LeaderLostError(RuntimeError):
    """The leader went away while this follower waited for its next step:
    the follower exits rather than wedge inside a collective."""


# opcodes of the leader -> follower step broadcast (the reference's where
# the call is the same)
OP_STOP = 0
OP_DECODE = 1
OP_PREFILL = 2
OP_CHUNK = 3
OP_PACKED = 6
OP_MIXED = 10
OP_LOGITS = 11
OP_STATS = 12

_METHODS = {
    OP_DECODE: "decode",
    OP_PREFILL: "prefill",
    OP_CHUNK: "prefill_chunk",
    OP_PACKED: "prefill_packed_arrays",
    OP_MIXED: "mixed_step",
    OP_LOGITS: "decode_logits",
}


class SpmdStepChannel:
    """Leader -> follower replay channel over the group's control group."""

    def __init__(self, group) -> None:
        self.group = group
        self.is_leader = group.rank == 0

    def send(self, op: int, args: tuple = (), kwargs: dict | None = None) -> None:
        payload = pickle.dumps((args, kwargs or {}), protocol=pickle.HIGHEST_PROTOCOL)
        self.group.broadcast(torch.tensor([op, len(payload)], dtype=torch.int64), control=True)
        self.group.broadcast(torch.frombuffer(bytearray(payload), dtype=torch.uint8), control=True)

    def recv(self) -> tuple[int, tuple, dict]:
        try:
            header = self.group.broadcast(torch.zeros(2, dtype=torch.int64), control=True)
            buf = self.group.broadcast(torch.empty(int(header[1]), dtype=torch.uint8), control=True)
        except Exception as e:  # noqa: BLE001 - any broken broadcast means the leader is gone
            raise LeaderLostError(
                f"rank {self.group.rank}: the leader's step broadcast failed ({e})") from e
        args, kwargs = pickle.loads(buf.numpy().tobytes())
        return int(header[0]), args, kwargs


def rank_stats(group, reset: bool = False) -> dict:
    """This rank's kernel launch counters, its peak device memory (on a
    card) and its group's collective counters (ops/kernels.py,
    TPGroup.stats); with ``reset`` each is set to 0 after reading."""
    from dynamo_tpu_torch.ops import kernels

    out = {"launches": kernels.launch_counts(), **group.stats()}
    if group.device.type == "cuda":
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(group.device)
    if reset:
        kernels.reset_launch_counts()
        group.staged_ops = group.staged_bytes = 0
        group.seconds = 0.0
        if group.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(group.device)
    return out


class SpmdModelRunner:
    """Wraps the leader's TorchModelRunner so that every model call replays
    on every follower. Each intercepted call draws its missing sampling
    keys here, broadcasts (opcode, inputs), then runs; everything else
    (``pack_prefill``, ``fetch_sample``, attributes) is the wrapped
    runner's."""

    def __init__(self, runner, channel: SpmdStepChannel, processes=()) -> None:
        self._runner = runner
        self._channel = channel
        self._processes = list(processes)
        self.final_stats: list[dict] | None = None
        self._stopped = False

    def __getattr__(self, name):  # delegate everything not intercepted
        return getattr(self._runner, name)

    def _call(self, op: int, *args, **kwargs):
        self._channel.send(op, args, kwargs)
        return getattr(self._runner, _METHODS[op])(*args, **kwargs)

    # -- intercepted calls (follower_loop replays the same methods) --

    def prefill(self, token_ids, block_ids, temperature, top_p, top_k, rep_pen=1.0,
                key_data=None, eos_ids=None, eos_suppress=False):
        if key_data is None:
            key_data = self._runner._next_key_data()
        return self._call(OP_PREFILL, list(token_ids), list(block_ids), temperature, top_p,
                          top_k, rep_pen=rep_pen, key_data=np.asarray(key_data),
                          eos_ids=eos_ids, eos_suppress=eos_suppress)

    def prefill_chunk(self, token_chunk, chunk_start, total_len, block_ids, temperature, top_p,
                      top_k, rep_pen=1.0, key_data=None, eos_ids=None, eos_suppress=False):
        if key_data is None:
            key_data = self._runner._next_key_data()
        return self._call(OP_CHUNK, list(token_chunk), int(chunk_start), int(total_len),
                          list(block_ids), temperature, top_p, top_k, rep_pen=rep_pen,
                          key_data=np.asarray(key_data), eos_ids=eos_ids,
                          eos_suppress=eos_suppress)

    def prefill_packed_arrays(self, *args, **kwargs):
        return self._call(OP_PACKED, *args, **kwargs)

    def mixed_step(self, chunks, tokens, positions, block_tables, slot_indices, keys, temps,
                   top_ps, top_ks, eos_ids=None, eos_suppress=None):
        # each chunk slot's key row (index 8) drawn here when missing
        chunks = [
            (*c[:8], np.asarray(c[8] if c[8] is not None else self._runner._next_key_data()),
             *c[9:])
            for c in chunks
        ]
        return self._call(OP_MIXED, chunks, tokens, positions, block_tables, slot_indices,
                          keys, temps, top_ps, top_ks, eos_ids=eos_ids,
                          eos_suppress=eos_suppress)

    def decode(self, tokens, positions, block_tables, slot_indices, temps, top_ps, top_ks,
               keys=None, penalties=None, eos_mask=None):
        if keys is None:
            keys = self._runner._next_decode_keys(len(tokens))
        return self._call(OP_DECODE, tokens, positions, block_tables, slot_indices, temps,
                          top_ps, top_ks, keys=keys, penalties=penalties, eos_mask=eos_mask)

    def decode_logits(self, tokens, positions, block_tables, slot_indices):
        return self._call(OP_LOGITS, tokens, positions, block_tables, slot_indices)

    def spec_verify(self, *args, **kwargs):
        raise NotImplementedError("spec decode under tensor parallelism is not ported yet")

    def rank_stats(self, reset: bool = False) -> list[dict]:
        """Every rank's ``rank_stats`` (launch counters, peak memory,
        collective counters), in rank order; each set to 0 after reading
        with ``reset``."""
        self._channel.send(OP_STATS, (reset,))
        return self._runner.group.gather_objects(rank_stats(self._runner.group, reset))

    def shutdown(self, timeout_s: float = 60.0) -> None:
        """Stop the followers: each hands its ``rank_stats`` (its launch
        counters among them) back (``final_stats``, rank order, the
        leader's first) and leaves the group; then the leader leaves it."""
        if self._stopped:
            return
        self._stopped = True
        group = self._runner.group
        self._channel.send(OP_STOP)
        self.final_stats = group.gather_objects(rank_stats(group))
        for p in self._processes:
            p.join(timeout_s)
            if p.is_alive():
                logger.warning("follower pid %s did not stop; terminating it", p.pid)
                p.terminate()
                p.join(5)
        group.close()


def follower_loop(runner, channel: SpmdStepChannel) -> list[dict]:
    """Run on every follower: replay the leader's runner calls until
    OP_STOP, then hand this rank's ``rank_stats`` (its launch counters
    among them) back. Raises LeaderLostError when the leader goes away.
    Returns every rank's final stats."""
    group = channel.group
    while True:
        op, args, kwargs = channel.recv()
        if op == OP_STOP:
            return group.gather_objects(rank_stats(group))
        if op == OP_STATS:
            group.gather_objects(rank_stats(group, *args))
            continue
        if op not in _METHODS:
            raise RuntimeError(f"unknown step opcode {op}")
        getattr(runner, _METHODS[op])(*args, **kwargs)
