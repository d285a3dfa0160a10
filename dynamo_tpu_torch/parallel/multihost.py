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
broadcast and raises ``LeaderLostError`` instead of waiting on. A leader
that stays idle keeps its followers: after a quarter of the control
group's ``idle_timeout_s`` without a broadcast it sends ``OP_KEEPALIVE``,
which a follower receives and ignores (the counterpart of the reference's
barrier lease, :535-555, which a waiting follower checks instead of
leaving). The horizon (``decode_multi``, ``OP_DECODE_MULTI``) replays as
any other call: every rank runs its H steps eagerly, with the leader's
keys. The KV block moves of disaggregation and the tiers ride
``OP_EXTRACT`` / ``OP_INJECT`` (the reference's numbers, :53-54): the
payload names the runner's method and the block ids, and for an inject the
shape and dtype of each rank's part; the runner's method then gathers the
ranks' heads into the dense array on the leader, or scatters each rank only
its own heads of the leader's (where the reference broadcasts the whole
payload to every host, :390-427, :707-720).

The verify pass of speculative decoding rides ``OP_VERIFY``, which the
reference's channel lacks (:50-59) because its verify pass runs as one
program under its mesh (models/llama.py:849): here the leader's drafter
proposes the drafts, the channel broadcasts the verify inputs and the
number of chained steps E, and every rank runs the verify body on its head
shard, the partials summed.

The channel spans the whole rank grid (parallel/mesh.py): the leader is
global rank 0, and every rank -- whatever its dp, sp, ep or tp coordinate
-- replays every call; the collectives inside each call run over the axis
lines the model names. Ranks may be processes of one node
(engine/torch_engine/factory.py spawns them) or one process per node
(multi-node bring-up, parallel/multinode.py): a node that is not the
leader gets a ``FollowerHandle`` (:474 upstream) whose ``serve`` replays the
channel, and whose ``serve_async`` follows the leader's liveness by its
bring-up lease as well as by the broken broadcast.
"""

from __future__ import annotations

import asyncio
import logging
import pickle
import threading
import time

import numpy as np
import torch

from dynamo_tpu_torch.parallel.mesh import ScatterSpec
from dynamo_tpu_torch.parallel.multinode import BARRIER_ID

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
OP_EXTRACT = 4
OP_INJECT = 5
OP_PACKED = 6
OP_DECODE_MULTI = 9
OP_MIXED = 10
OP_LOGITS = 11
OP_STATS = 12
OP_KEEPALIVE = 13
OP_VERIFY = 14
OP_PREFILL_LOGITS = 15
OP_VERIFY_LOGITS = 16

_METHODS = {
    OP_DECODE: "decode",
    OP_PREFILL: "prefill",
    OP_CHUNK: "prefill_chunk",
    OP_PACKED: "prefill_packed_arrays",
    OP_DECODE_MULTI: "decode_multi",
    OP_MIXED: "mixed_step",
    OP_LOGITS: "decode_logits",
    OP_VERIFY: "spec_verify",
    OP_PREFILL_LOGITS: "prefill_logits",
    OP_VERIFY_LOGITS: "verify_logits",
}

# the block moves (OP_EXTRACT / OP_INJECT), ridden by the method's name
_EXTRACTS = ("extract_blocks", "extract_blocks_quant", "extract_blocks_device", "extract_pages")
# inject method -> (its arrays' head dim, their block dim, each array's
# dtype when it comes as numpy: None keeps its own)
_INJECTS = {
    "inject_blocks": (1, 2, (None, None)),
    "inject_blocks_device": (1, 2, (None, None)),
    "inject_blocks_quant": (1, 2, (np.int8, np.float32, np.int8, np.float32)),
    "inject_pages": (2, 0, None),
}


class SpmdStepChannel:
    """Leader -> follower replay channel over the group's control group."""

    def __init__(self, group) -> None:
        self.group = group
        self.is_leader = group.global_rank == 0
        # the leader's control-group traffic (step broadcasts, keep-alives,
        # stats gathers) one exchange at a time, and when it last spoke
        self.lock = threading.RLock()
        self.last_send = time.monotonic()

    def send(self, op: int, args: tuple = (), kwargs: dict | None = None) -> None:
        payload = pickle.dumps((args, kwargs or {}), protocol=pickle.HIGHEST_PROTOCOL)
        with self.lock:
            self.group.broadcast(torch.tensor([op, len(payload)], dtype=torch.int64), control=True)
            self.group.broadcast(torch.frombuffer(bytearray(payload), dtype=torch.uint8),
                                 control=True)
            self.last_send = time.monotonic()

    def recv(self) -> tuple[int, tuple, dict]:
        try:
            header = self.group.broadcast(torch.zeros(2, dtype=torch.int64), control=True)
            buf = self.group.broadcast(torch.empty(int(header[1]), dtype=torch.uint8), control=True)
        except Exception as e:  # noqa: BLE001 - any broken broadcast means the leader is gone
            raise LeaderLostError(
                f"rank {self.group.global_rank}: the leader's step broadcast failed ({e})") from e
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
        # keep-alives while idle: a quarter of the followers' wait limit
        self._keepalive_s = runner.group.idle_timeout_s / 4
        self._halt = threading.Event()
        self._keepalive = threading.Thread(target=self._keep_alive, daemon=True,
                                           name="tp-keepalive")
        self._keepalive.start()

    def _keep_alive(self) -> None:
        ch = self._channel
        while not self._halt.wait(self._keepalive_s / 4):
            with ch.lock:
                if self._halt.is_set():
                    return
                if time.monotonic() - ch.last_send >= self._keepalive_s:
                    ch.send(OP_KEEPALIVE)

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

    def prefill_logits(self, token_ids, block_ids):
        return self._call(OP_PREFILL_LOGITS, list(token_ids), list(block_ids))

    def verify_logits(self, tokens, positions, block_tables, slot_indices):
        return self._call(OP_VERIFY_LOGITS, tokens, positions, block_tables, slot_indices)

    def decode_multi(self, H, tokens, positions, block_tables, temps, top_ps, top_ks, keys,
                     active, limit_remaining, min_remaining, eos_ids, penalties=None):
        # every rank runs the same H steps; a penalty batch's history rides
        # the payload (the reference's OP_DECODE_MULTI, multihost.py:311-346)
        return self._call(OP_DECODE_MULTI, int(H), tokens, positions, block_tables, temps,
                          top_ps, top_ks, keys, active, limit_remaining, min_remaining,
                          eos_ids, penalties=penalties)

    # The block moves: the leader sends the method and the block ids (and,
    # for an inject, the shape and dtype of each rank's part), then every
    # rank runs the runner's method, whose gather / scatter of the heads
    # meets the others' (model_runner.py's data plane). Everything an
    # inject could refuse is checked here, before any rank moves.

    def _extract(self, method: str, block_ids):
        ids = [int(b) for b in block_ids]
        self._channel.send(OP_EXTRACT, (method, ids))
        return getattr(self._runner, method)(ids)

    def extract_blocks(self, block_ids):
        return self._extract("extract_blocks", block_ids)

    def extract_blocks_quant(self, block_ids):
        return self._extract("extract_blocks_quant", block_ids)

    def extract_blocks_device(self, block_ids):
        return self._extract("extract_blocks_device", block_ids)

    def extract_pages(self, block_ids):
        return self._extract("extract_pages", block_ids)

    def _inject(self, method: str, block_ids, *arrays):
        from dynamo_tpu_torch.engine.torch_engine.model_runner import host_tensor

        head_dim, n_dim, dtypes = _INJECTS[method]
        ids = [int(b) for b in block_ids]
        self._runner._block_index(ids, writes=True)
        tp = self._runner.group.world_size
        arrays = [host_tensor(a, dtypes[i] if dtypes else None) for i, a in enumerate(arrays)]
        parts = []
        for a in arrays:
            shape = list(a.shape)
            if len(shape) <= max(head_dim, n_dim) or shape[n_dim] != len(ids) or shape[head_dim] % tp:
                raise ValueError(f"{method}: an array of shape {tuple(a.shape)} for {len(ids)} "
                                 f"block ids does not split into {tp} ranks' heads")
            shape[head_dim] //= tp
            parts.append(ScatterSpec(tuple(shape), a.dtype))
        self._channel.send(OP_INJECT, (method, ids, parts))
        return getattr(self._runner, method)(ids, *arrays)

    def inject_blocks(self, block_ids, k_blocks, v_blocks):
        return self._inject("inject_blocks", block_ids, k_blocks, v_blocks)

    def inject_blocks_quant(self, block_ids, kq, ks, vq, vs):
        return self._inject("inject_blocks_quant", block_ids, kq, ks, vq, vs)

    def inject_blocks_device(self, block_ids, k_dev, v_dev):
        return self._inject("inject_blocks_device", block_ids, k_dev, v_dev)

    def inject_pages(self, block_ids, *pages):
        if len(pages) != len(self._runner._pages()):
            raise ValueError(f"{len(pages)} planes for a cache of {len(self._runner._pages())}")
        return self._inject("inject_pages", block_ids, *pages)

    def spec_verify(self, spec_k, extras, *args, **kwargs):
        # the drafts, the sampling keys and the chained steps' count ride
        # the payload; every rank runs the verify body on its heads
        return self._call(OP_VERIFY, int(spec_k), int(extras), *args, **kwargs)

    def rank_stats(self, reset: bool = False) -> list[dict]:
        """Every rank's ``rank_stats`` (launch counters, peak memory,
        collective counters), in global rank order; each set to 0 after
        reading with ``reset``."""
        with self._channel.lock:
            self._channel.send(OP_STATS, (reset,))
            return self._runner.group.gather_objects(rank_stats(self._runner.group, reset))

    def shutdown(self, timeout_s: float = 60.0) -> None:
        """Stop the followers: each hands its ``rank_stats`` (its launch
        counters among them) back (``final_stats``, rank order, the
        leader's first) and leaves the group; then the leader leaves it."""
        if self._stopped:
            return
        self._stopped = True
        self._halt.set()
        self._keepalive.join()
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


class FollowerHandle:
    """What a node that is not the leader gets from the factory in place of
    an engine (the reference's, multihost.py:474): ``serve()`` replays the
    leader's runner calls until it stops, then leaves the grid.

    ``serve_async()`` runs that replay on a daemon thread and follows the
    leader's liveness: a leader that dies closes its connections, which the
    waiting broadcast sees (LeaderLostError); with a fabric, a follower that
    has seen no step for ``idle_grace_s`` also looks for the barrier's data
    key, which lives under the leader's bring-up lease, and raises
    LeaderLostError when it is gone. The leader keeps that lease alive for
    the engine's lifetime; a quiet leader whose key is there is waited for.
    After LeaderLostError the replay thread may still sit inside a
    collective: leave the process (``os._exit``)."""

    def __init__(self, runner, channel: SpmdStepChannel, fabric=None,
                 barrier_id: str = BARRIER_ID, idle_grace_s: float = 10.0) -> None:
        self.runner = runner
        self.channel = channel
        self.fabric = fabric
        self.barrier_id = barrier_id
        self.idle_grace_s = idle_grace_s
        self.final_stats: list[dict] | None = None
        self._progress = 0

    def _bump(self) -> None:
        self._progress += 1

    def serve(self) -> list[dict]:
        """Replay until OP_STOP, leave the grid, return every rank's final
        stats. Raises LeaderLostError when the leader goes away."""
        self.final_stats = follower_loop(self.runner, self.channel, progress_cb=self._bump)
        self.channel.group.close()
        return self.final_stats

    async def serve_async(self) -> list[dict]:
        done = threading.Event()
        errs: list[BaseException] = []

        def run() -> None:
            try:
                self.serve()
            except BaseException as e:  # noqa: BLE001 - raised below
                errs.append(e)
            finally:
                done.set()

        threading.Thread(target=run, daemon=True, name="spmd-follower").start()
        loop = asyncio.get_running_loop()
        last_progress, last_change = self._progress, loop.time()
        while not done.is_set():
            await asyncio.sleep(0.5)
            if self._progress != last_progress:
                last_progress, last_change = self._progress, loop.time()
                continue
            if self.fabric is not None and loop.time() - last_change > self.idle_grace_s:
                key = f"barriers/{self.barrier_id}/data"
                try:
                    alive = await self.fabric.kv_get(key) is not None
                except Exception:  # noqa: BLE001 - the fabric itself is gone
                    alive = False
                if not alive:
                    raise LeaderLostError(
                        f"no step for {self.idle_grace_s:.0f} s and the leader's barrier "
                        f"lease ({key}) is gone")
                last_change = loop.time()
        if errs:
            raise errs[0]
        return self.final_stats


def follower_loop(runner, channel: SpmdStepChannel, progress_cb=None) -> list[dict]:
    """Run on every follower: replay the leader's runner calls until
    OP_STOP, then hand this rank's ``rank_stats`` (its launch counters
    among them) back. Raises LeaderLostError when the leader goes away.
    ``progress_cb`` fires after every received step. Returns every rank's
    final stats."""
    group = channel.group
    while True:
        op, args, kwargs = channel.recv()
        if progress_cb is not None:
            progress_cb()
        if op == OP_STOP:
            return group.gather_objects(rank_stats(group))
        if op == OP_STATS:
            group.gather_objects(rank_stats(group, *args))
            continue
        if op == OP_KEEPALIVE:
            continue
        if op == OP_EXTRACT and args[0] in _EXTRACTS:
            getattr(runner, args[0])(args[1])  # this rank's heads go to the leader
            continue
        if op == OP_INJECT and args[0] in _INJECTS:
            getattr(runner, args[0])(args[1], *args[2])  # receives its heads
            continue
        if op not in _METHODS:
            raise RuntimeError(f"unknown step opcode {op}")
        getattr(runner, _METHODS[op])(*args, **kwargs)
