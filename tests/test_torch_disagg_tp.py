"""Disaggregation and the KV tiers under a tensor-parallel group, the port
against the JAX package, on the CPU.

The port's groups are gloo ranks on the CPU (``build_torch_engine(
tensor_parallel_size=N)`` spawns the followers); the JAX package's are
meshes over the host devices the suite's conftest forces. The reference's
tiny Llama in f32 (block 4, chunk 8), parameters from the JAX init carried
over bit for bit. A group's greedy tokens are held EXACTLY to a JaxEngine
over a mesh of the same size (its sums run in the same order as the
group's), a single engine's to a single JaxEngine.

* a tp = 2 decode group lands tp = 1 prefills from a ``PrefillWorkerService``
  over the fabric, streamed and monolithic; a tp = 2 prefill group serves a
  tp = 1 decode engine (the reference's tests/test_disagg_stream.py:629,
  whose JAX twin runs beside it);
* every landing is bitwise: tp = 1 blocks injected into a tp = 2 group (and
  a group's into one engine) come back from the group's gather equal, with
  the leader's own heads equal to their slice of the dense payload; f32,
  bf16 and int8 caches (the int8 mantissas and scales verbatim);
* the colocated device path tp = 1 -> tp = 2 and tp = 1 -> tp = 4
  (tests/test_colocated_disagg.py:161 / :169, whose tp 2 -> tp 4 would need
  two groups led by one process);
* the tiers under a tp = 2 group: pages stored from the group and loaded
  back into other blocks are bitwise the group's, and an engine built with
  ``DYN_KV_HOST_OFFLOAD_GB`` onboards a repeated prompt's prefix with the
  tokens of a tp = 2 JaxEngine.
"""

import asyncio
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.disagg.colocated import ColocatedPrefillClient as JColocated
from dynamo_tpu.disagg.router import DisaggConfig as JConfig
from dynamo_tpu.disagg.router import DisaggregatedRouter as JRouter
from dynamo_tpu.disagg.transfer import PrefillWorkerService as JService
from dynamo_tpu.disagg.transfer import RemotePrefillClient as JClient
from dynamo_tpu.engine.jax_engine.engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.engine.jax_engine.model_runner import ModelRunner
from dynamo_tpu.fabric.client import FabricClient as JFabric
from dynamo_tpu.models import llama as jl
from dynamo_tpu.parallel.mesh import build_mesh
from dynamo_tpu.parallel.sharding import shard_llama as jshard_llama
from dynamo_tpu.pipeline.context import Context as JContext
from dynamo_tpu.protocols import common as jp
from dynamo_tpu_torch.block_manager import LayoutConfig, TieredBlockManager
from dynamo_tpu_torch.disagg.colocated import ColocatedPrefillClient
from dynamo_tpu_torch.disagg.router import DisaggConfig, DisaggregatedRouter
from dynamo_tpu_torch.disagg.transfer import PrefillWorkerService, RemotePrefillClient
from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
from dynamo_tpu_torch.engine.torch_engine.weights import params_from_jax
from dynamo_tpu_torch.fabric.client import FabricClient
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.parallel.multihost import SpmdModelRunner
from dynamo_tpu_torch.protocols import common as tp

BS, C, MAX_LEN, NB, MAX_BATCH, VOCAB = 4, 8, 64, 64, 4, 64
LONG = list(range(2, 42))  # 40 tokens: 5 chunks, 4 frames and a final
PROMPTS = [list(range(2, 2 + n)) for n in (9, 17)]


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch):
    """Each rank a thread or two: the suite runs files side by side, and
    ranks that each spin a thread per core starve the others' timings."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # read by the spawned followers
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _models(kv_heads=None, quant=False):
    over = {"num_kv_heads": kv_heads} if kv_heads else {}
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=VOCAB), **over)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32, quantize=quant)
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=VOCAB), **over)
    return jcfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _torch(tpn=1, chunk=C, kv_heads=None, kv="bf16", dtype=torch.float32, **kw):
    *_, tcfg, tparams = _models(kv_heads)
    if dtype != torch.float32:
        tparams = jax.tree.map(lambda t: t.to(dtype) if t.is_floating_point() else t, tparams)
    return build_torch_engine(
        tcfg, device="cpu", params=tparams, dtype=dtype, kv_block_size=BS, max_batch=MAX_BATCH,
        num_blocks=NB, max_model_len=MAX_LEN, prefill_chunk_tokens=chunk, kv_dtype=kv,
        tensor_parallel_size=tpn, **kw)


def _jax(tpn=1, chunk=C, kv_heads=None, devices=None, **kw):
    jcfg, jparams, *_ = _models(kv_heads)
    mesh = kv_sharding = None
    params = jparams
    if tpn > 1:
        mesh = build_mesh(tp=tpn, devices=devices)
        params, kv_sharding = jshard_llama(mesh, jcfg, jparams)
    runner = ModelRunner(jcfg, params, num_blocks=NB, block_size=BS, max_batch=MAX_BATCH,
                         max_model_len=MAX_LEN, kv_dtype=jnp.float32, prefill_chunk_tokens=chunk,
                         mesh=mesh, kv_sharding=kv_sharding)
    return JaxEngine(runner, JaxEngineConfig(max_batch=MAX_BATCH, block_size=BS, num_blocks=NB,
                                             max_model_len=MAX_LEN, watermark_blocks=2), **kw)


async def _tokens(engine, prompt, max_tokens=8):
    mod, ctx = (jp, JContext()) if isinstance(engine, JaxEngine) else (tp, tp.Context())
    req = mod.PreprocessedRequest(
        token_ids=list(prompt), sampling=mod.SamplingOptions(greedy=True),
        stop=mod.StopConditions(max_tokens=max_tokens, ignore_eos=True))
    out = []
    async for o in engine.generate(req, ctx):
        out.extend(o.token_ids)
    return out


async def _local(engine, prompts):
    try:
        return [await _tokens(engine, p) for p in prompts]
    finally:
        await engine.close()


async def _over_fabric(prefill, decode, prompts, jax_side=False):
    """The prompts through ``decode``, its prefills served by ``prefill``
    from the fabric's queue (one package's pieces); the decode engine's
    stats."""
    fabric = JFabric.in_process() if jax_side else FabricClient.in_process()
    service = (JService if jax_side else PrefillWorkerService)(fabric, "tp", prefill)
    client = (JClient if jax_side else RemotePrefillClient)(fabric, "tp", block_size=BS,
                                                            timeout=60)
    await service.start()
    await client.start()
    if jax_side:
        decode.disagg_router = JRouter(fabric, "tp", JConfig(4, 100))
    else:
        decode.disagg_router = DisaggregatedRouter(DisaggConfig(4, 100), namespace="tp",
                                                   fabric=fabric)
    decode.remote_prefill_client = client
    try:
        return [await _tokens(decode, p) for p in prompts], client.stats
    finally:
        for o in (decode, client, service, prefill):
            await o.close()


# --------------------------------------------------------- over the fabric

@pytest.mark.parametrize("stream", ["streamed", "monolithic"])
async def test_a_tp2_decode_group_lands_tp1_prefills_over_the_fabric(stream, monkeypatch):
    monkeypatch.setenv("DYN_KV_STREAM", "1" if stream == "streamed" else "0")
    prompts = [LONG, PROMPTS[1]]
    want = await _local(_jax(2), prompts)
    decode = _torch(2)
    assert isinstance(decode.runner, SpmdModelRunner)
    got, stats = await _over_fabric(_torch(1), decode, prompts)
    assert got == want
    s = decode.stats
    assert s.remote_prefills == 2 and s.remote_fallbacks == 0
    assert (stats.frames_rx > 0) == (stream == "streamed")
    assert [p.exitcode for p in decode.runner._processes] == [0]
    theirs, _ = await _over_fabric(_jax(1), _jax(2), prompts, jax_side=True)
    assert theirs == want


async def test_a_tp2_prefill_group_serves_a_tp1_decode_engine():
    """The reference's tests/test_disagg_stream.py:629 (a tp = 2 prefill
    fleet streaming into one decode engine), both packages."""
    prompts = [LONG]
    prefill = _torch(2)
    got, stats = await _over_fabric(prefill, _torch(1), prompts)
    assert stats.frames_rx >= 2
    assert [p.exitcode for p in prefill.runner._processes] == [0]
    theirs, jstats = await _over_fabric(_jax(2), _jax(1), prompts, jax_side=True)
    assert got == theirs == await _local(_jax(1), prompts)
    assert stats.frames_rx == jstats.frames_rx and stats.bytes_rx == jstats.bytes_rx


# -------------------------------------------------------- bitwise landings

@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
async def test_each_rank_lands_its_heads_bitwise(kv):
    """tp = 1 -> tp = 2 and tp = 2 -> tp = 1: the host payload's arrays
    (an int8 cache's mantissas and scales verbatim) land bit for bit, as
    the group's gather gives them back; the device path's blocks land in
    the group exactly as in one engine (over an int8 cache both quantize
    each block on the way in); the leader's own cache holds exactly its
    slice of the heads."""
    dtype = torch.bfloat16 if kv == "bf16" else torch.float32
    tkv = "int8" if kv == "int8" else "bf16"
    one, two = _torch(1, kv=tkv, dtype=dtype), _torch(2, kv=tkv, dtype=dtype)
    quant = kv == "int8"
    extract = "extract_blocks_quant" if quant else "extract_blocks"
    inject = "inject_blocks_quant" if quant else "inject_blocks"
    ids, host_ids, dev_ids = [3, 4, 5, 6, 7, 8], [20, 21, 22, 23, 24, 25], [30, 31, 32, 33, 34, 35]
    try:
        r1, r2 = one.runner, two.runner
        for r in (r1, r2):
            r.prefill(LONG[:23], ids, 0.0, 1.0, 0)
        for src, dst in ((r1, r2), (r2, r1)):
            blocks = getattr(src, extract)(ids)
            getattr(dst, inject)(host_ids, *blocks)
            for a, b in zip(getattr(dst, extract)(host_ids), blocks):
                np.testing.assert_array_equal(a, b)
            k, v, n = src.extract_blocks_device(ids)
            assert n == len(ids)
            for r in (r1, r2):
                r.inject_blocks_device(dev_ids, k, v)
            for a, b in zip(getattr(r1, extract)(dev_ids), getattr(r2, extract)(dev_ids)):
                np.testing.assert_array_equal(a, b)
            if not quant:
                for a, b in zip(r2.extract_blocks(dev_ids), src.extract_blocks(ids)):
                    np.testing.assert_array_equal(a, b)
        # the leader's own cache: heads [0, Hkv / 2) of the landed blocks
        blocks = getattr(r1, extract)(ids)
        r2_inject = getattr(r2, inject)
        r2_inject(host_ids, *blocks)
        leader = r2.k_cache["q"] if quant else r2.k_cache
        h = leader.shape[1]
        got = leader[:, :, host_ids]
        if got.dtype == torch.bfloat16:
            got = got.view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(blocks[0])[:, :h])
    finally:
        await two.close()
        await one.close()


def test_a_group_refuses_a_bad_inject_before_any_rank_moves():
    """An inject the group would refuse is refused on the leader before
    the followers are told: the group stays usable."""
    two = _torch(2)
    try:
        r = two.runner
        k, v = r.extract_blocks([1, 2])
        with pytest.raises(ValueError, match="null block"):
            r.inject_blocks([0, 3], k, v)
        with pytest.raises(ValueError, match="block ids"):
            r.inject_blocks([3, 4, 5], k, v)
        with pytest.raises(ValueError, match="planes"):
            r.inject_pages([3, 4], *r.extract_pages([1, 2])[:1])
        r.inject_blocks([3, 4], k, v)
        for a, b in zip(r.extract_blocks([3, 4]), (k, v)):
            np.testing.assert_array_equal(a, b)
    finally:
        asyncio.run(two.close())


# --------------------------------------------------- the colocated device path

@pytest.mark.parametrize("ptp,dtp,kv_heads", [(1, 2, None), (1, 4, 4)], ids=["tp1_to_tp2",
                                                                           "tp1_to_tp4"])
async def test_colocated_asymmetric_tp(ptp, dtp, kv_heads):
    """tests/test_colocated_disagg.py:161 / :169: the device path between
    a prefill engine and a decode group of another size; tokens equal a
    JaxEngine over a mesh of the decode group's size, and the JAX package's
    own colocated pair. The reference's second case is tp 2 -> tp 4; a
    process leads one group (it is rank 0 of torch.distributed's default
    group), so two colocated groups cannot share one, and the port's
    second case cuts four ways from one engine instead."""
    want = await _local(_jax(dtp, chunk=512, kv_heads=kv_heads), PROMPTS)
    prefill = _torch(ptp, chunk=512, kv_heads=kv_heads)
    decode = _torch(dtp, chunk=512, kv_heads=kv_heads)
    decode.disagg_router = DisaggregatedRouter(DisaggConfig(4, 100))
    decode.remote_prefill_client = ColocatedPrefillClient(prefill, BS)
    try:
        got = [await _tokens(decode, p) for p in PROMPTS]
        assert decode.stats.remote_prefills == 2 and decode.stats.remote_fallbacks == 0
    finally:
        await decode.close()
        await prefill.close()
    devs = jax.devices()
    jpre = _jax(ptp, chunk=512, kv_heads=kv_heads, devices=devs[:ptp] if ptp > 1 else None)
    jdec = _jax(dtp, chunk=512, kv_heads=kv_heads, devices=devs[4:4 + dtp])
    jdec.disagg_router = JRouter(JFabric.in_process(), "colo", JConfig(4, 100))
    jdec.disagg_router._queue_depth_cache = 0
    jdec.remote_prefill_client = JColocated(jpre, block_size=BS)
    theirs = await _local(jdec, PROMPTS)
    await jpre.close()
    assert got == want == theirs


# ------------------------------------------------------------- the tiers

def test_tier_pages_round_trip_a_tp2_group_bitwise():
    two = _torch(2)
    try:
        r = two.runner
        cfg = _models()[2]
        r.prefill(LONG[:23], [3, 4, 5, 6, 7, 8], 0.0, 1.0, 0)
        bm = TieredBlockManager(LayoutConfig(num_layers=cfg.num_layers, page_size=BS,
                                             num_kv_heads=cfg.num_kv_heads,
                                             head_dim=cfg.head_dim, dtype="float32"), 16)
        pages = r.extract_pages([3, 4, 5, 6, 7, 8])
        assert pages[0].shape[2] == cfg.num_kv_heads  # dense: every rank's heads
        assert bm.store_blocks_device([11, 12, 13, 14, 15, 16], *pages) == 6
        r.inject_pages([40, 41, 42, 43, 44, 45],
                       *bm.load_blocks_device([11, 12, 13, 14, 15, 16], "cpu"))
        for a, b in zip(r.extract_pages([40, 41, 42, 43, 44, 45]), pages):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        for a, b in zip(r.extract_blocks([40, 41, 42, 43, 44, 45]),
                        r.extract_blocks([3, 4, 5, 6, 7, 8])):
            np.testing.assert_array_equal(a, b)
    finally:
        asyncio.run(two.close())


async def test_a_tp2_group_with_host_tiers_onboards_a_repeated_prefix(monkeypatch):
    monkeypatch.setenv("DYN_KV_HOST_OFFLOAD_GB", "0.001")
    prompt = LONG[:30]
    want = await _local(_jax(2), [prompt])
    engine = _torch(2)
    try:
        assert engine.block_manager is not None
        first = await _tokens(engine, prompt)
        await engine.drain_offloads()
        for _ in range(200):
            if engine.block_manager.stats.offloaded_g2 >= 7:
                break
            await asyncio.sleep(0.02)
        second = await _tokens(engine, prompt)
        s = engine.stats
        assert [first, second] == want * 2
        assert s.kv_offloaded_blocks >= 7 and s.kv_onboarded_blocks >= 7
        assert s.kv_offload_errors == s.kv_onboard_errors == 0
    finally:
        await engine.close()
