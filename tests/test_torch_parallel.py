"""The port's tensor-parallel serving against the JAX package's, on the CPU.

The JAX side runs on the host devices the suite's conftest forces, through
``build_mesh`` / ``shard_llama`` and the meshed model (``interpret=True``
for its fused programs off the TPU); the port's side runs its ranks as gloo
processes on the CPU (``run_ranks``, or the factory's own followers), each
holding its Megatron slice. Everything is f32 (parameters from the JAX
init, carried across with ``params_from_jax``), so the bars are the JAX
package's own (tests/test_parallel.py, tests/test_meshed_fused.py:139-205)
held tighter:

* ``shard_llama``: each rank's slice equals the JAX shard on that rank's
  device (``addressable_shards``), bit for bit, at tp = 2 and 4, with Qwen2
  biases and with int8 weights (scales ride with their columns);
* ``prefill_packed`` then ``decode`` under tp = 2, unfused, fused, fused
  with the ring tail, and int8 weights fused: the logits equal the jitted
  JAX meshed model's (atol / rtol 1e-5: the same f32 ops, summed in another
  order) with the same argmax;
* ``build_torch_engine(tensor_parallel_size=2)`` on the default admission
  path (a prompt chunked alone, one chunked inside mixed steps beside a
  decode lane, two packed) streams the greedy tokens of a ``JaxEngine``
  over a tp = 2 mesh, exactly, unfused, fused, fused with the ring tail,
  and with int8 weights and an int8 KV cache; at tp = 4 (4 kv heads) with
  the ring tail too; every rank holds its share of the kv heads and its
  follower processes end cleanly;
* a follower whose leader goes away leaves with LeaderLostError (exit 3);
  CUDA graphs under a group (spec decode's too) raise; a group larger than
  the card count raises.
"""

import asyncio
import dataclasses
import functools
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from dynamo_tpu.engine.jax_engine.engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.engine.jax_engine.model_runner import ModelRunner
from dynamo_tpu.models import llama as jl
from dynamo_tpu.parallel.mesh import build_mesh
from dynamo_tpu.parallel.sharding import shard_llama as jshard_llama
from dynamo_tpu.pipeline.context import Context as JaxContext
from dynamo_tpu.protocols import common as jp
from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
from dynamo_tpu_torch.engine.torch_engine.weights import params_from_jax
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.parallel.launch import call_each, call_with_group, run_ranks
from dynamo_tpu_torch.parallel.mesh import rank_devices
from dynamo_tpu_torch.parallel.multihost import SpmdModelRunner
from dynamo_tpu_torch.parallel.sharding import shard_llama
from dynamo_tpu_torch.protocols import common as tp

TOL = dict(atol=1e-5, rtol=1e-5)
BS, C, MAX_LEN, NB, MAX_BATCH, VOCAB = 4, 8, 64, 64, 4, 64
TIMEOUT_S = 120


class _Rank:  # what shard_llama reads of a group
    def __init__(self, rank, world_size):
        self.rank, self.world_size = rank, world_size


@functools.lru_cache(maxsize=None)
def _models(quant=False, **over):
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=VOCAB), **over)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32, quantize=quant)
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=VOCAB), **over)
    return jcfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


# ------------------------------------------------------------------ sharding


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("tpn", [2, 4])
def test_shard_llama_slices_equal_the_jax_shards(tpn, quant):
    jcfg, jparams, tcfg, tparams = _models(quant, num_kv_heads=4, attn_bias=True)
    mesh = build_mesh(tp=tpn)
    jsharded, _ = jshard_llama(mesh, jcfg, jparams)
    devices = list(mesh.devices.reshape(-1))
    for r in range(tpn):
        mine = dict(_leaves(shard_llama(_Rank(r, tpn), tcfg, tparams)))
        seen = 0
        for path, arr in _leaves(jsharded):
            shard = next(s for s in arr.addressable_shards if s.device == devices[r])
            want = np.asarray(shard.data)
            got = mine[path]
            got = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
            np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=str(path))
            seen += 1
        assert seen == len(mine)


def test_shard_llama_refuses_heads_that_do_not_split():
    *_, tcfg, tparams = _models()  # 2 kv heads
    with pytest.raises(ValueError, match="num_kv_heads=2 not divisible by tp=4"):
        shard_llama(_Rank(0, 4), tcfg, tparams)


# ------------------------------------------------------------------- model

VARIANTS = {
    "unfused": (False, dict()),
    "fused": (False, dict(fused_decode=True)),
    "fused_overlap": (False, dict(fused_decode=True, collective_overlap=True)),
    "int8_fused": (True, dict(fused_decode=True)),
}
PACK = [[3, 9, 14, 2, 7], [11, 5, 60, 8], [1, 2, 3, 4, 5, 6, 7]]  # three prompts packed
NBLK = 16


def _packed_arrays():
    P = 24
    tokens = np.zeros(P, np.int32)
    positions = np.zeros(P, np.int32)
    seg = np.full(P, -1, np.int32)
    slots = np.zeros(P, np.int32)
    last = np.zeros(4, np.int32)
    off = 0
    for i, p in enumerate(PACK):
        n = len(p)
        tokens[off:off + n], positions[off:off + n], seg[off:off + n] = p, np.arange(n), i
        slots[off:off + n] = (1 + 2 * i) * BS + np.arange(n)  # blocks 1-2, 3-4, 5-6
        last[i] = off + n - 1
        off += n
    return tokens, positions, seg, slots, last


def _decode_arrays():
    toks = np.array([5, 6, 7], np.int32)
    pos = np.array([len(p) for p in PACK], np.int32)
    tables = np.array([[1 + 2 * i, 2 + 2 * i, 0, 0] for i in range(3)], np.int32)
    slots = tables[np.arange(3), pos // BS] * BS + pos % BS
    return toks, pos, tables, slots


@functools.lru_cache(maxsize=None)
def _jax_model(name):
    quant, flags = VARIANTS[name]
    jcfg, jparams, _, _ = _models(quant)
    cfg = dataclasses.replace(jcfg, **flags)
    mesh = build_mesh(tp=2)
    sp, kv_sharding = jshard_llama(mesh, cfg, jparams)
    shape = (cfg.num_layers, cfg.num_kv_heads, NBLK, BS, cfg.head_dim)
    kc = jax.device_put(jnp.zeros(shape, jnp.float32), kv_sharding)
    vc = jax.device_put(jnp.zeros(shape, jnp.float32), kv_sharding)
    a = [jnp.asarray(x) for x in _packed_arrays()]
    lp, kc, vc = jax.jit(functools.partial(jl.prefill_packed, sp, cfg, mesh=mesh))(
        a[0], a[1], a[2], a[3], kc, vc, a[4])
    d = [jnp.asarray(x) for x in _decode_arrays()]
    ld, _, _ = jax.jit(functools.partial(jl.decode, sp, cfg, mesh=mesh))(
        d[0], d[1], kc, vc, d[2], d[3])
    return np.asarray(lp), np.asarray(ld)


@functools.lru_cache(maxsize=None)
def _port_model():
    """Every variant's packed prefill then decode, on one tp = 2 group."""
    tpn = 2
    calls = [[] for _ in range(tpn)]
    t64 = lambda a: torch.from_numpy(a.astype(np.int64))  # noqa: E731
    pa = [t64(a) for a in _packed_arrays()]
    da = _decode_arrays()
    for name in VARIANTS:
        quant, flags = VARIANTS[name]
        *_, tcfg, tparams = _models(quant)
        cfg = dataclasses.replace(tcfg, **flags)
        for r in range(tpn):
            params = shard_llama(_Rank(r, tpn), cfg, tparams)
            shape = (cfg.num_layers, cfg.num_kv_heads // tpn, NBLK, BS, cfg.head_dim)
            kc, vc = torch.zeros(shape), torch.zeros(shape)
            calls[r] += [
                (call_with_group, (tl.prefill_packed, params, cfg, pa[0], pa[1], pa[2], pa[3],
                                   kc, vc, pa[4]), {}),
                (call_with_group, (tl.decode, params, cfg, t64(da[0]), t64(da[1]), kc, vc,
                                   torch.from_numpy(da[2]), t64(da[3])), {}),
            ]
    ranks = run_ranks(tpn, call_each, [(c,) for c in calls], timeout_s=TIMEOUT_S)
    return {name: [(ranks[r][2 * i], ranks[r][2 * i + 1]) for r in range(tpn)]
            for i, name in enumerate(VARIANTS)}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_prefill_packed_and_decode_match_the_jax_meshed_model(name):
    want_p, want_d = _jax_model(name)
    got = _port_model()[name]
    for lp, ld in got:  # the logits are all-gathered: every rank has them all
        np.testing.assert_array_equal(lp, got[0][0])
        np.testing.assert_array_equal(ld, got[0][1])
    lp, ld = got[0]
    np.testing.assert_allclose(lp[:len(PACK)], want_p[:len(PACK)], **TOL)
    np.testing.assert_allclose(ld, want_d, **TOL)
    np.testing.assert_array_equal(lp[:len(PACK)].argmax(-1), want_p[:len(PACK)].argmax(-1))
    np.testing.assert_array_equal(ld.argmax(-1), want_d.argmax(-1))


# ------------------------------------------------------------------ engines

# name -> (tp, engine knobs); tp = 4 needs 4 kv heads
ENGINES = {
    "unfused": (2, dict()),
    "fused": (2, dict(fused_decode=True)),
    "fused_overlap": (2, dict(fused_decode=True, collective_overlap=True)),
    "int8_int8kv": (2, dict(fused_decode=True, quantize=True, kv_dtype="int8")),
    "tp4_fused_overlap": (4, dict(fused_decode=True, collective_overlap=True)),
}


def _engine_models(name, quant):
    tpn = ENGINES[name][0]
    return _models(quant, **({"num_kv_heads": 4} if tpn == 4 else {}))
LONG = [int(t) for t in np.random.default_rng(1).integers(1, VOCAB, 40)]
LONG2 = [int(t) for t in np.random.default_rng(2).integers(1, VOCAB, 30)]


def _request(mod, prompt, max_tokens):
    return mod.PreprocessedRequest(
        token_ids=list(prompt), sampling=mod.SamplingOptions(greedy=True),
        stop=mod.StopConditions(max_tokens=max_tokens, ignore_eos=True))


async def _collect(engine, req, ctx, first=None):
    toks = []
    async for out in engine.generate(req, ctx):
        toks.extend(out.token_ids)
        if first is not None and toks:
            first.set()
    return toks


async def _overlapped(engine, mod, ctx):
    """A 40-token prompt is chunked alone, then decodes 16 tokens; meanwhile
    a 30-token prompt is chunked beside it (mixed steps) and two short
    prompts are packed into one prefill."""
    first = asyncio.Event()
    a = asyncio.create_task(_collect(engine, _request(mod, LONG, 16), ctx(), first))
    await asyncio.wait_for(first.wait(), 60)
    rest = [(LONG2, 6), ([1, 2, 3], 8), ([9, 8, 7, 6, 5], 6)]
    outs = await asyncio.gather(*(_collect(engine, _request(mod, p, n), ctx()) for p, n in rest))
    return [await a, *outs]


def _jax_engine(name):
    tpn, flags = ENGINES[name]
    quant = flags.get("quantize", False)
    jcfg, jparams, _, _ = _engine_models(name, quant)
    mesh = build_mesh(tp=tpn)
    sp, kv_sharding = jshard_llama(mesh, jcfg, jparams)
    runner = ModelRunner(
        jcfg, sp, num_blocks=NB, block_size=BS, max_batch=MAX_BATCH, max_model_len=MAX_LEN,
        kv_dtype=flags.get("kv_dtype", jnp.float32), prefill_chunk_tokens=C,
        fused_decode=flags.get("fused_decode", False),
        collective_overlap=flags.get("collective_overlap", False),
        mesh=mesh, kv_sharding=kv_sharding)
    return JaxEngine(runner, JaxEngineConfig(
        max_batch=MAX_BATCH, block_size=BS, num_blocks=NB, max_model_len=MAX_LEN))


async def _serve_jax(name):
    engine = _jax_engine(name)
    try:
        return await _overlapped(engine, jp, JaxContext)
    finally:
        await engine.close()


@pytest.mark.parametrize("name", sorted(ENGINES))
async def test_tp_engine_streams_the_matching_jax_engines_greedy_tokens(name):
    """tp = 2 in every form, and tp = 4 with the ring tail (multi-hop
    rings), each against a JaxEngine over a mesh of the same tp."""
    tpn, flags = ENGINES[name]
    flags = dict(flags)
    quant = flags.pop("quantize", False)
    _, _, tcfg, tparams = _engine_models(name, quant)
    want = await _serve_jax(name)
    engine = build_torch_engine(
        tcfg, device="cpu", params=tparams,
        dtype=torch.float32, kv_block_size=BS, max_batch=MAX_BATCH, num_blocks=NB,
        max_model_len=MAX_LEN, prefill_chunk_tokens=C, tensor_parallel_size=tpn, **flags)
    try:
        runner = engine.runner
        assert isinstance(runner, SpmdModelRunner) and runner.group.world_size == tpn
        # each rank holds its share of the kv heads
        kc = runner.k_cache
        assert (kc["q"] if isinstance(kc, dict) else kc).shape[1] == tcfg.num_kv_heads // tpn
        got = await _overlapped(engine, tp, tp.Context)
        s = engine.stats
        assert s.packed_prefills > 0 and s.chunk_steps > 0 and s.mixed_steps > 0
    finally:
        await engine.close()
    assert got == want
    assert [len(t) for t in got] == [16, 6, 8, 6]
    assert [p.exitcode for p in runner._processes] == [0] * (tpn - 1)
    assert len(runner.final_stats) == tpn


# ------------------------------------------------------------ the protocol


def _doomed_leader(pids) -> None:
    """A leader process that builds a tp = 2 engine, reports its
    follower's pid and dies without stopping it."""
    *_, tparams = _models()
    engine = build_torch_engine(
        tl.LlamaConfig.tiny(vocab_size=VOCAB), device="cpu", params=tparams,
        dtype=torch.float32, kv_block_size=BS, max_batch=MAX_BATCH, num_blocks=NB,
        max_model_len=MAX_LEN, prefill_chunk_tokens=C, tensor_parallel_size=2)
    pids.put(engine.runner._processes[0].pid)
    time.sleep(1)
    os._exit(1)


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(") ")[1][0] != "Z"
    except FileNotFoundError:
        return False


def test_a_follower_leaves_when_its_leader_dies(capfd):
    """The leader process dies between steps: the follower's wait for the
    next step breaks at once and it leaves with LeaderLostError (exit 3)
    instead of waiting inside the broadcast."""
    ctx = mp.get_context("spawn")
    pids = ctx.Queue()
    leader = ctx.Process(target=_doomed_leader, args=(pids,))
    leader.start()
    follower = pids.get(timeout=TIMEOUT_S)
    leader.join(TIMEOUT_S)
    assert leader.exitcode == 1
    t0 = time.monotonic()
    while _alive(follower) and time.monotonic() - t0 < 30:
        time.sleep(0.1)
    assert not _alive(follower)
    assert "LeaderLostError" in capfd.readouterr().err


def test_spec_decode_with_tensor_parallelism_raises():
    """Spec decode under tensor parallelism is ported
    (tests/test_torch_spec_tp.py): what still raises is asking for CUDA
    graphs under the group, which the verify pass would ride, before any
    rank is spawned."""
    with pytest.raises(ValueError, match="CUDA graphs are not captured under a tensor-parallel"):
        build_torch_engine(tl.LlamaConfig.tiny(vocab_size=VOCAB), device="cpu",
                           tensor_parallel_size=2, spec_k=3, cuda_graphs=True)


def test_a_group_larger_than_the_card_count_raises():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"tp={have + 1} needs {have + 1} CUDA devices"):
        rank_devices(have + 1)
    assert [d.type for d in rank_devices(3, "cpu")] == ["cpu"] * 3
