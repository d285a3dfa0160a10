"""The port's peer tier (G4-lite, dynamo_tpu_torch/block_manager/peer.py)
against the JAX package's, on the CPU.

- Twins of tests/test_peer_blocks.py: the manager-level pull lands the peer's
  blocks bit for bit, a partial overlap pulls only the advertised prefix,
  the advert goes with the service; the cross-worker engine hit, where
  engine B pulls the prompt engine A offloaded, onboards it and streams the
  greedy tokens the JAX pair streams in f32 (blocks pulled >= 9).
- Every outcome of ``PULL_OUTCOMES`` (pulled, a miss with a plan and with an
  evicted reply, integrity under ``corrupt_kv=bits``, a fenced advert and a
  fenced reply, the timeout, an error), the quarantine cap, the directed
  pull and its ``avoid`` list: the same scenario through both packages'
  services and clients (seeded blocks) gives the same counts by outcome,
  the same blocks landed and the same server picked.
- The engine's admission: a plan on the Context feeds ``note_fleet_heat``
  and directs the pull; ``kv_pull_outcomes`` reaches ``load_metrics``.
- The frame limit, over a fabric server and the TCP response plane with a
  small ``MAX_FRAME``: the reference's over-limit reply breaks the response
  connection and lands nothing; the port's service caps the reply at what
  one frame holds, and the client lands that prefix bit for bit.
"""

import asyncio
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dynamo_tpu import integrity as j_integrity
from dynamo_tpu.block_manager import peer as j_peer
from dynamo_tpu.block_manager.layout import LayoutConfig as JLayout
from dynamo_tpu.block_manager.manager import TieredBlockManager as JManager
from dynamo_tpu.engine.jax_engine.engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.engine.jax_engine.model_runner import ModelRunner
from dynamo_tpu.fabric import wire as j_wire
from dynamo_tpu.fabric.client import FabricClient as JFabricClient
from dynamo_tpu.fabric.server import FabricServer as JFabricServer
from dynamo_tpu.models import llama as jl
from dynamo_tpu.pipeline.context import Context as JContext
from dynamo_tpu.protocols import common as jp
from dynamo_tpu.runtime.config import RuntimeConfig as JRuntimeConfig
from dynamo_tpu.runtime.distributed import DistributedRuntime as JDRT
from dynamo_tpu.testing import faults as j_faults
from dynamo_tpu.tokens import TokenBlockSequence as JTokenBlockSequence
from dynamo_tpu_torch import integrity as t_integrity
from dynamo_tpu_torch.block_manager import LayoutConfig, TieredBlockManager
from dynamo_tpu_torch.block_manager import peer as t_peer
from dynamo_tpu_torch.engine.torch_engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.engine.torch_engine.model_runner import TorchModelRunner
from dynamo_tpu_torch.engine.torch_engine.weights import params_from_jax
from dynamo_tpu_torch.entrypoint.inputs import load_metrics
from dynamo_tpu_torch.fabric import client as t_client
from dynamo_tpu_torch.fabric import wire as t_wire
from dynamo_tpu_torch.fabric.client import FabricClient
from dynamo_tpu_torch.fabric.server import FabricServer
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.protocols import common as tp
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime as TDRT
from dynamo_tpu_torch.testing import faults as t_faults
from dynamo_tpu_torch.tokens import TokenBlockSequence

BLOCK = 4
VOCAB = 64
PUBLISH_S = 0.05

PKGS = {
    "ref": types.SimpleNamespace(
        DRT=JDRT, Service=j_peer.PeerBlockService, Client=j_peer.PeerBlockClient,
        Manager=JManager, Layout=JLayout, faults=j_faults, integrity=j_integrity,
        Fabric=JFabricClient, Server=JFabricServer, RuntimeConfig=JRuntimeConfig, wire=j_wire),
    "port": types.SimpleNamespace(
        DRT=TDRT, Service=t_peer.PeerBlockService, Client=t_peer.PeerBlockClient,
        Manager=TieredBlockManager, Layout=LayoutConfig, faults=t_faults, integrity=t_integrity,
        Fabric=FabricClient, Server=FabricServer, RuntimeConfig=RuntimeConfig, wire=t_wire),
}


@pytest.fixture(autouse=True)
def _fresh_state():
    """A clean in-memory fabric of the port (the suite's conftest resets
    the JAX package's) and no fault injector in either package."""
    t_client.reset_shared_state()
    for pkg in PKGS.values():
        pkg.faults.set_injector(None)
    yield
    for pkg in PKGS.values():
        pkg.faults.set_injector(None)
    t_client.reset_shared_state()


def test_pull_outcomes_are_the_reference_contract():
    assert t_peer.PULL_OUTCOMES == j_peer.PULL_OUTCOMES


def _manager(pkg, dims=None, host_blocks=64):
    dims = dims or dict(num_layers=2, page_size=BLOCK, num_kv_heads=2, head_dim=16)
    return pkg.Manager(pkg.Layout(**dims, dtype="bfloat16"), host_blocks=host_blocks)


def _blocks(n, seed, dims=None):
    dims = dims or dict(num_layers=2, page_size=BLOCK, num_kv_heads=2, head_dim=16)
    shape = (dims["num_layers"], dims["num_kv_heads"], n, dims["page_size"], dims["head_dim"])
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2**16, size=shape).astype(np.uint16),
            rng.integers(0, 2**16, size=shape).astype(np.uint16))


# ------------------------------------------- twins of tests/test_peer_blocks.py


@pytest.mark.parametrize("name", ["ref", "port"])
async def test_peer_fetch_manager_level(name):
    pkg = PKGS[name]
    drt = await pkg.DRT.detached()
    try:
        m_a, m_b = _manager(pkg), _manager(pkg)
        hashes = [101, 202, 303]
        k, v = _blocks(3, 0)
        m_a.store_blocks(hashes, k, v)
        svc = pkg.Service(drt, "g4", m_a, publish_interval_s=PUBLISH_S)
        await svc.start()
        client = pkg.Client(drt, "g4", m_b)
        await asyncio.sleep(0.2)  # the advert publishes

        assert m_b.lookup_prefix(hashes) == 0
        assert await client.fetch_remote_prefix(hashes) == 3
        assert m_b.lookup_prefix(hashes) == 3
        kb, vb = m_b.load_blocks(hashes)
        np.testing.assert_array_equal(kb, k)
        np.testing.assert_array_equal(vb, v)

        # partial overlap: the peer holds only the first two of a longer chain
        longer = [101, 202, 909]
        assert await client.fetch_remote_prefix(longer) == 0  # already held
        m_c = _manager(pkg)
        client_c = pkg.Client(drt, "g4", m_c)
        assert await client_c.fetch_remote_prefix(longer) == 2
        assert m_c.lookup_prefix(longer) == 2
        assert client.pull_outcomes["pulled"] == 3 and client_c.pull_outcomes["pulled"] == 2
        await svc.close()
        # the advert goes with the service
        assert not await drt.fabric.kv_get_prefix("kvbm/adverts/g4/")
    finally:
        await drt.close()


# ------------------------------------------------ outcomes against the reference

HASHES = [1000 + i for i in range(6)]


async def _run_case(pkg, case, monkeypatch):
    """One pull scenario on ``pkg``: (counts by outcome, blocks fetched, the
    local prefix after it, which service served, landed bytes equal)."""
    drts = [await pkg.DRT.detached() for _ in range(3)]  # a lease (epoch) each
    services = []
    try:
        m_a, m_c, m_b = _manager(pkg), _manager(pkg), _manager(pkg)
        k, v = _blocks(len(HASHES), 7)
        m_a.store_blocks(HASHES, k, v)
        m_c.store_blocks(HASHES[:3], k[:, :, :3], v[:, :, :3])
        served = []
        for drt, m, wid in ((drts[0], m_a, 1), (drts[1], m_c, 2)):
            orig = m.load_blocks

            def spy(hs, orig=orig, wid=wid):
                served.append(wid)
                if case == "timeout":
                    import time

                    time.sleep(0.5)
                return orig(hs)

            m.load_blocks = spy
            svc = pkg.Service(drt, "oc", m, publish_interval_s=PUBLISH_S, worker_id=wid)
            await svc.start()
            services.append(svc)
        client = pkg.Client(drts[2], "oc", m_b)
        await asyncio.sleep(0.2)
        plan = None
        if case == "miss_planned":
            plan = {"src": 9, "blocks": 6, "hashes": HASHES, "avoid": [1, 2]}
        elif case == "miss_evicted":
            for svc in services:
                svc.publish_interval_s = 60.0  # the stale advert stays
            await asyncio.sleep(0.1)
            m_a.clear()
            m_c.clear()
        elif case == "integrity":
            pkg.faults.set_injector(pkg.faults.FaultInjector(
                pkg.faults.FaultSpec.parse("corrupt_kv=bits")))
        elif case == "fenced_advert":
            plan = {"src": 1, "blocks": 6, "hashes": HASHES, "avoid": []}
            await (await drts[2].fences()).fence(drts[0].fencing_epoch)
        elif case == "fenced_reply":
            pull_from = client._pull_from

            async def pull_then_fence(*args):
                reply = await pull_from(*args)
                await (await drts[2].fences()).fence(drts[0].fencing_epoch)
                return reply

            client._pull_from = pull_then_fence
        elif case == "timeout":
            monkeypatch.setenv("DYN_PULL_TIMEOUT_S", "0.1")
        elif case == "error":
            def boom(*_):
                raise RuntimeError("store failed")

            m_b.store_blocks = boom
        elif case == "quarantine":
            m_b._quarantined.add(HASHES[3])
        elif case == "directed":
            plan = {"src": 2, "blocks": 3, "hashes": HASHES[:3], "avoid": []}
        elif case == "avoid":
            plan = {"src": 7, "blocks": 6, "hashes": HASHES, "avoid": [1]}
        fetched = await client.fetch_remote_prefix(HASHES, plan=plan)
        if case == "timeout":
            await asyncio.sleep(0.6)  # the peer's slow load ends before teardown
        held = m_b.lookup_prefix(HASHES)
        landed_ok = True
        if held:
            kb, vb = m_b.load_blocks(HASHES[:held])
            landed_ok = (np.array_equal(kb, k[:, :, :held]) and np.array_equal(vb, v[:, :, :held]))
        return {"outcomes": dict(client.pull_outcomes), "fetched": fetched,
                "fetched_blocks": client.fetched_blocks, "held": held, "served": served,
                "landed_ok": landed_ok}
    finally:
        for svc in services:
            await svc.close()
        for drt in drts:
            await drt.close()


OUTCOME_CASES = {
    "pulled": ("pulled", 6),
    "miss_planned": ("fallback_miss", 6),
    "miss_evicted": ("fallback_miss", 6),
    "integrity": ("fallback_integrity", 6),
    "fenced_advert": ("fallback_fenced", 6),
    "fenced_reply": ("fallback_fenced", 6),
    "timeout": ("fallback_timeout", 6),
    "error": ("fallback_error", 6),
    "quarantine": ("pulled", 3),
    "directed": ("pulled", 3),
    "avoid": ("pulled", 3),
}


@pytest.mark.parametrize("case", list(OUTCOME_CASES))
async def test_pull_outcome_counts_equal_the_reference(case, monkeypatch):
    got = {}
    for name, pkg in PKGS.items():
        got[name] = await _run_case(pkg, case, monkeypatch)
        monkeypatch.delenv("DYN_PULL_TIMEOUT_S", raising=False)
        pkg.faults.set_injector(None)
    assert got["port"] == got["ref"], case
    outcome, blocks = OUTCOME_CASES[case]
    counts = got["port"]["outcomes"]
    assert counts[outcome] == blocks
    assert sum(counts.values()) == blocks
    assert got["port"]["landed_ok"]
    if case == "directed":
        assert got["port"]["served"] == [2]  # the plan's source, not the longer holder
    if case == "avoid":
        assert got["port"]["served"] == [2]  # worker 1 holds more but is avoided


# ------------------------------------------------------------------- engines


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny(vocab_size=VOCAB)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tparams


def _engine(pkg_name, models, bm, client=None):
    jcfg, jparams, tparams = models
    dims = dict(num_blocks=64, block_size=BLOCK, max_batch=4, max_model_len=64)
    if pkg_name == "ref":
        runner = ModelRunner(jcfg, jparams, kv_dtype=jnp.float32, prefill_chunk_tokens=512, **dims)
        return JaxEngine(runner, JaxEngineConfig(**dims), block_manager=bm,
                         peer_block_client=client)
    runner = TorchModelRunner(tl.LlamaConfig.tiny(vocab_size=VOCAB), tparams, device="cpu",
                              prefill_chunk_tokens=512, **dims)
    return TorchEngine(runner, TorchEngineConfig(**dims), block_manager=bm,
                       peer_block_client=client)


def _f32_manager(pkg, cfg):
    return pkg.Manager(pkg.Layout(num_layers=cfg.num_layers, page_size=BLOCK,
                                  num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                                  dtype="float32"), host_blocks=64)


async def _collect(engine, prompt, ctx, mod, max_tokens=8):
    req = mod.PreprocessedRequest(token_ids=list(prompt), sampling=mod.SamplingOptions(greedy=True),
                                  stop=mod.StopConditions(max_tokens=max_tokens, ignore_eos=True))
    toks = []
    async for out in engine.generate(req, ctx):
        toks.extend(out.token_ids)
    return toks


async def _cross_worker(name, models, plan_of=None):
    """Engine A serves a 37-token prompt (9 full blocks) and offloads it;
    engine B, holding nothing, pulls A's blocks, onboards them and serves
    the same prompt. ``plan_of(svc_a, chain)`` puts a pull plan on B's
    Context."""
    pkg = PKGS[name]
    mod, Ctx = (jp, JContext) if name == "ref" else (tp, tp.Context)
    cfg = models[0]
    drt_a, drt_b = await pkg.DRT.detached(), await pkg.DRT.detached()
    m_a, m_b = _f32_manager(pkg, cfg), _f32_manager(pkg, cfg)
    engine_a = _engine(name, models, m_a)
    engine_b = None
    svc = None
    try:
        prompt = list(range(2, 2 + 37))
        ref = await _collect(engine_a, prompt, Ctx(), mod)
        for _ in range(200):
            if m_a.stats.offloaded_g2 >= 9:
                break
            await asyncio.sleep(0.02)
        assert m_a.stats.offloaded_g2 >= 9
        svc = pkg.Service(drt_a, "g4e", m_a, publish_interval_s=PUBLISH_S, worker_id=11)
        await svc.start()
        client = pkg.Client(drt_b, "g4e", m_b)
        await asyncio.sleep(0.2)
        engine_b = _engine(name, models, m_b, client)
        Seq = JTokenBlockSequence if name == "ref" else TokenBlockSequence
        chain = Seq(prompt, BLOCK).block_hashes()
        ctx = Ctx()
        if plan_of is not None:
            ctx.decisions().pull_plan = plan_of(chain)
        got = await _collect(engine_b, prompt, ctx, mod)
        pages_a = m_a.load_blocks(chain)
        pages_b = m_b.load_blocks(chain)
        return {"a": ref, "b": got, "fetched": client.fetched_blocks,
                "outcomes": dict(client.pull_outcomes), "held": m_b.lookup_prefix(chain),
                "pages_equal": all(np.array_equal(x, y) for x, y in zip(pages_a, pages_b)),
                "engine_b": engine_b, "chain": chain, "manager_b": m_b}
    finally:
        if svc is not None:
            await svc.close()
        await engine_a.close()
        if engine_b is not None:
            await engine_b.close()
        await drt_a.close()
        await drt_b.close()


async def test_cross_worker_prefix_hit_end_to_end(models):
    """B pulls A's offloaded prefix, onboards it and streams the greedy
    tokens A streamed, equal to the JAX pair's in f32."""
    got = {name: await _cross_worker(name, models) for name in PKGS}
    port, ref = got["port"], got["ref"]
    assert port["a"] == ref["a"]
    assert port["b"] == ref["b"] == port["a"]
    assert port["fetched"] >= 9 and port["fetched"] == ref["fetched"]
    assert port["outcomes"] == ref["outcomes"]
    assert port["held"] >= 9 and port["pages_equal"]
    engine_b = port["engine_b"]
    assert engine_b.stats.kv_onboarded_blocks >= 9
    assert engine_b.stats.kv_pull_outcomes == port["outcomes"]
    # the counts by outcome reach the worker's load metrics
    ws = load_metrics(engine_b).worker_stats
    assert ws.kv_pulled_blocks_by_outcome == {k: v for k, v in port["outcomes"].items()}


async def test_plan_directs_the_pull_and_feeds_fleet_heat(models):
    """A plan on the Context (the KV router's): B pulls from the plan's
    source, and its tier records the plan's fleet heat, as JaxEngine does."""
    def plan_of(chain):
        return {"src": 11, "blocks": 9, "hashes": chain, "avoid": [],
                "freq": [9 - i for i in range(len(chain))]}

    got = {name: await _cross_worker(name, models, plan_of) for name in PKGS}
    port, ref = got["port"], got["ref"]
    assert port["b"] == ref["b"] == port["a"]
    assert port["outcomes"] == ref["outcomes"] and port["outcomes"]["pulled"] >= 9
    heat = port["manager_b"]._fleet_heat
    assert heat == ref["manager_b"]._fleet_heat
    assert [heat[h] for h in port["chain"]] == [float(9 - i) for i in range(len(port["chain"]))]


# --------------------------------------------------------------- frame limit


async def _frame_limit_case(pkg, monkeypatch):
    """A 12-block pull of 256 KiB blocks (3 MiB of K/V) over a fabric server
    and the TCP response plane, with ``MAX_FRAME`` at 3 MiB."""
    monkeypatch.setattr(pkg.wire, "MAX_FRAME", 3 << 20)
    server = pkg.Server("127.0.0.1", 0)
    await server.start()
    drts = []
    for _ in range(2):
        drt = pkg.DRT(await pkg.Fabric.connect(server.addr),
                      pkg.RuntimeConfig(fabric_addr=server.addr))
        await drt._start_primary_lease()
        drts.append(drt)
    svc = None
    try:
        dims = dict(num_layers=4, page_size=16, num_kv_heads=8, head_dim=128)
        m_a, m_b = _manager(pkg, dims, host_blocks=16), _manager(pkg, dims, host_blocks=16)
        hashes = [5000 + i for i in range(12)]
        k, v = _blocks(12, 3, dims)
        m_a.store_blocks(hashes, k, v)
        svc = pkg.Service(drts[0], "fl", m_a, publish_interval_s=PUBLISH_S)
        await svc.start()
        client = pkg.Client(drts[1], "fl", m_b)
        await asyncio.sleep(0.3)
        fetched = await asyncio.wait_for(client.fetch_remote_prefix(hashes), 30)
        held = m_b.lookup_prefix(hashes)
        landed = True
        if held:
            kb, vb = m_b.load_blocks(hashes[:held])
            landed = np.array_equal(kb, k[:, :, :held]) and np.array_equal(vb, v[:, :, :held])
        return fetched, held, dict(client.pull_outcomes), landed, svc
    finally:
        if svc is not None:
            await svc.close()
        for drt in drts:
            await drt.close()
        await server.close()


async def test_a_reply_over_the_frame_limit_is_capped_where_the_reference_breaks(monkeypatch):
    fetched, held, outcomes, _, _ = await _frame_limit_case(PKGS["ref"], monkeypatch)
    # the reference: the reply's frame is refused by the caller's response
    # server, the stream ends in a disconnect, nothing lands
    assert (fetched, held) == (0, 0)
    assert outcomes["fallback_miss"] == 12 and outcomes["pulled"] == 0
    fetched, held, outcomes, landed, svc = await _frame_limit_case(PKGS["port"], monkeypatch)
    # the port: (3 MiB - 1 MiB of slack) / 256 KiB = 8 blocks in one reply
    assert fetched == held == 8 and landed
    assert outcomes["pulled"] == 8 and sum(outcomes.values()) == 8
    assert svc.capped_replies == 1
