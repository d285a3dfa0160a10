"""The port's fault injection (``dynamo_tpu_torch/testing/faults.py``) against
the JAX package's, on the CPU, and the twins of the seed's fault suites.

- ``FaultSpec.parse`` gives equal fields for every spec of the grammar and
  refuses the same bad specs with the same message.
- Two injectors, one of each package, fire identically over one scripted
  sequence of fault-point visits under a fixed clock (the return values, the
  ``fired`` counts and the corrupted bytes, arrays and files), and
  ``corrupt_array`` flips a CPU tensor's bytes as the reference flips an
  array's.
- ``abort_after_tokens`` fails the same lanes with the same code in
  ``TorchEngine`` and ``JaxEngine``, every block comes back, and the next
  request is served.
- Twins: ``test_integrity.py``'s ``corrupt_kv`` cases for the tier store,
  the G3 page and the disagg frames (every stream token-identical to the
  unfaulted run), ``zombie_partition`` self-fencing the engine, a
  ``fabric_blackout`` shorter than ``DYN_DEGRADED_MAX_S`` that every
  in-flight stream rides out with zero fences, and
  ``test_fault_tolerance.py``'s mid-stream kill under ``DYN_FAULT`` through
  the port's agg graph on its echo engine (migrations counted from the
  frontend's own exit stats).
"""

import asyncio
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.block_manager.layout import LayoutConfig as JLayout
from dynamo_tpu.block_manager.manager import TieredBlockManager as JManager
from dynamo_tpu.engine.jax_engine.engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.engine.jax_engine.model_runner import ModelRunner
from dynamo_tpu.models import llama as jl
from dynamo_tpu.pipeline.context import Context as JaxContext
from dynamo_tpu.protocols import common as jp
from dynamo_tpu.runtime import clock as jclock
from dynamo_tpu.testing import faults as jfaults
from dynamo_tpu_torch import integrity
from dynamo_tpu_torch.block_manager.layout import LayoutConfig
from dynamo_tpu_torch.block_manager.manager import TieredBlockManager
from dynamo_tpu_torch.disagg.router import DisaggConfig, DisaggregatedRouter
from dynamo_tpu_torch.disagg.transfer import PrefillWorkerService, RemotePrefillClient
from dynamo_tpu_torch.engine.echo import EchoEngineCore
from dynamo_tpu_torch.engine.torch_engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.engine.torch_engine.model_runner import TorchModelRunner
from dynamo_tpu_torch.engine.torch_engine.weights import params_from_jax
from dynamo_tpu_torch.entrypoint.inputs import make_engine_handler
from dynamo_tpu_torch.fabric.client import FabricClient
from dynamo_tpu_torch.fabric.state import FabricState
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.pipeline.router import PushRouter, RouterMode
from dynamo_tpu_torch.discovery import RemoteEngine
from dynamo_tpu_torch.protocols import common as tp
from dynamo_tpu_torch.runtime import clock as tclock
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.serve import _free_port
from dynamo_tpu_torch.testing import faults
from tests.test_torch_frontend import afetch, sse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS, VOCAB = 4, 64


@pytest.fixture(autouse=True)
def _no_faults():
    """No injector in either package before or after a test."""
    faults.set_injector(None)
    jfaults.set_injector(None)
    integrity.COUNTERS.reset()
    yield
    faults.set_injector(None)
    jfaults.set_injector(None)
    integrity.COUNTERS.reset()


def _both(spec: str):
    """(port injector, reference injector) of one spec, installed."""
    ours = faults.FaultInjector(faults.FaultSpec.parse(spec))
    ref = jfaults.FaultInjector(jfaults.FaultSpec.parse(spec))
    faults.set_injector(ours)
    jfaults.set_injector(ref)
    return ours, ref


# ------------------------------------------------------------------ grammar

GOOD_SPECS = [
    "", " , ", "kill_after_tokens=12", "abort_after_tokens=5", "delay_dispatch=0.05",
    "delay_dispatch=0.2,every=4", "slow_decode=5", "slow_decode=5,after=20",
    "slow_decode=5,every=3", "slow_decode=5, after=2 ,every=2", "gray_flap=5,period=2",
    "stall_transfer=1.5", "drop_fabric_conn=3", "corrupt_kv=bits", "corrupt_kv=truncate,every=3",
    "zombie_partition=2", "fabric_blackout=3", "fabric_flap=1,every=4", "every=0", "after=-3",
    "corrupt_kv=bits,every=2,abort_after_tokens=7,delay_dispatch=0.5",
]
BAD_SPECS = [
    "nope=1", "corrupt_kv=nonsense", "every", "every=", "kill_after_tokens=x",
    "delay_dispatch=abc", "slow_decode", "=3", "corrupt_kv=bits,bogus=2", "period=fast",
]


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_fault_spec_parse_gives_the_references_fields(spec):
    ours = dataclasses.asdict(faults.FaultSpec.parse(spec))
    assert ours == dataclasses.asdict(jfaults.FaultSpec.parse(spec))


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_fault_spec_parse_refuses_what_the_reference_refuses(spec):
    with pytest.raises(jfaults.FaultSpecError) as ref:
        jfaults.FaultSpec.parse(spec)
    with pytest.raises(faults.FaultSpecError) as ours:
        faults.FaultSpec.parse(spec)
    assert isinstance(ours.value, ValueError) and str(ours.value) == str(ref.value)


# --------------------------------------------------------------- injectors


class _FixedClock:
    def __init__(self) -> None:
        self.t = 1000.0

    def now(self) -> float:
        return self.t

    def wall(self) -> float:
        return 1.7e9 + self.t


SCRIPTED = [
    "abort_after_tokens=3", "delay_dispatch=0.001,every=2", "slow_decode=3,after=2,every=2",
    "gray_flap=4,period=1", "drop_fabric_conn=3", "corrupt_kv=bits,every=2",
    "corrupt_kv=truncate", "zombie_partition=0.5", "fabric_blackout=0.5",
    "fabric_flap=0.3,every=1", "stall_transfer=0.001",
]


async def _visit(inj, clock, tmp, tag):
    """One fixed script of every fault point, 0.07 s apart on ``clock``."""
    rng = np.random.default_rng(7)
    out = []
    for step in range(36):
        clock.t += 0.07
        kind = step % 9
        if kind == 0:
            out.append(("token", inj.on_token()))
        elif kind == 1:
            await inj.on_dispatch()
            out.append(("slow", inj.dispatch_slow_factor()))
        elif kind == 2:
            out.append(("keepalive", inj.keepalive_swallowed(7)))
        elif kind == 3:
            out.append(("dark", inj.fabric_unreachable()))
        elif kind == 4:
            out.append(("drop", inj.should_drop_fabric()))
        elif kind == 5:
            out.append(("bytes", inj.corrupt_bytes(rng.bytes(53))))
        elif kind == 6:
            arr = rng.integers(0, 2**16, (3, 5), dtype=np.uint16)
            out.append(("array", inj.corrupt_array(arr), arr.tobytes()))
        elif kind == 7:
            path = os.path.join(tmp, f"{tag}-{step}.kvb")
            with open(path, "wb") as f:
                f.write(rng.bytes(41))
            fired = inj.corrupt_file(path)
            with open(path, "rb") as f:
                out.append(("file", fired, f.read()))
        else:
            await inj.on_transfer()
            out.append(("transfer",))
    return out, dict(inj.fired), (inj.tokens, inj.dispatches, inj.publishes, inj.kv_payloads)


@pytest.mark.parametrize("spec", SCRIPTED)
async def test_injectors_fire_identically_over_one_scripted_sequence(spec, tmp_path):
    got = {}
    for name, mod, clk in (("ours", faults, tclock), ("ref", jfaults, jclock)):
        clock = _FixedClock()
        prev = clk.set_clock(clock)
        try:
            inj = mod.FaultInjector(mod.FaultSpec.parse(spec))
            got[name] = await _visit(inj, clock, str(tmp_path), name)
        finally:
            clk.set_clock(prev)
    assert got["ours"] == got["ref"]
    assert got["ours"][1], f"{spec} never fired in the script"


@pytest.mark.parametrize("mode", ["bits", "truncate"])
def test_corrupt_bytes_and_a_cpu_tensor_corrupt_as_the_reference(mode):
    ours, ref = _both(f"corrupt_kv={mode}")
    data = np.random.default_rng(3).bytes(4099)
    for _ in range(3):
        assert ours.corrupt_bytes(data) == ref.corrupt_bytes(data) != data
    # a CPU tensor (a bf16 arena slot) flips the bytes the reference flips
    # in the same numpy array
    words = np.random.default_rng(4).integers(0, 2**16, (2, 3, 4), dtype=np.uint16)
    t = torch.from_numpy(words.copy().view(np.int16)).view(torch.bfloat16)
    a = words.copy()
    assert ours.corrupt_array(t) and ref.corrupt_array(a)
    np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16), a)
    assert (a != words).sum() == 1
    assert ours.fired == ref.fired


def test_corrupt_array_never_touches_a_tensor_off_the_cpu():
    ours, _ = _both("corrupt_kv=bits")
    meta = torch.empty(4, device="meta")
    assert not ours.corrupt_array(meta) and ours.kv_payloads == 0


def test_the_injector_arms_from_dyn_fault_as_the_reference(monkeypatch):
    monkeypatch.setenv("DYN_FAULT", "slow_decode=4,after=1")
    faults.reset()
    jfaults.reset()
    assert faults.active() and jfaults.active()
    assert dataclasses.asdict(faults.get_injector().spec) == dataclasses.asdict(
        jfaults.get_injector().spec)
    monkeypatch.delenv("DYN_FAULT")
    faults.reset()
    assert not faults.active() and faults.get_injector() is None


# ------------------------------------------------------------------ engines


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny(vocab_size=VOCAB)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return jcfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _torch(models, chunk=0, nb=48, max_batch=4, max_len=64):
    dims = dict(num_blocks=nb, block_size=BS, max_batch=max_batch, max_model_len=max_len)
    return TorchEngine(TorchModelRunner(tl.LlamaConfig.tiny(vocab_size=VOCAB), models[2],
                                        device="cpu", prefill_chunk_tokens=chunk, **dims),
                       TorchEngineConfig(**dims, watermark_blocks=2))


def _pair(models, nb=48, max_batch=4, max_len=64, chunk=0, host_blocks=0):
    jcfg, jparams, tparams = models
    dims = dict(num_blocks=nb, block_size=BS, max_batch=max_batch, max_model_len=max_len)
    ecfg = dict(dims, watermark_blocks=2)
    jbm = tbm = None
    if host_blocks:
        lay = dict(num_layers=jcfg.num_layers, page_size=BS, num_kv_heads=jcfg.num_kv_heads,
                   head_dim=jcfg.head_dim, dtype="float32")
        jbm, tbm = JManager(JLayout(**lay), host_blocks), TieredBlockManager(LayoutConfig(**lay),
                                                                             host_blocks)
    jeng = JaxEngine(ModelRunner(jcfg, jparams, kv_dtype=jnp.float32, prefill_chunk_tokens=chunk,
                                 **dims), JaxEngineConfig(**ecfg), block_manager=jbm)
    teng = TorchEngine(TorchModelRunner(tl.LlamaConfig.tiny(vocab_size=VOCAB), tparams,
                                        device="cpu", prefill_chunk_tokens=chunk, **dims),
                       TorchEngineConfig(**ecfg), block_manager=tbm)
    return jeng, teng


async def _stream(engine, prompt, max_tokens=8):
    mod, ctx = (tp, tp.Context) if isinstance(engine, TorchEngine) else (jp, JaxContext)
    toks, final = [], None
    async for out in engine.generate(mod.PreprocessedRequest(
            token_ids=list(prompt), sampling=mod.SamplingOptions(greedy=True),
            stop=mod.StopConditions(max_tokens=max_tokens, ignore_eos=True)), ctx()):
        toks.extend(out.token_ids)
        if out.finish_reason is not None:
            final = (out.finish_reason.value, (out.error or {}).get("code"),
                     (out.error or {}).get("phase"))
    return toks, final


PROMPTS = [[5, 9, 17, 23, 2, 40], [1, 2, 3], [33, 3, 41, 14, 8, 8, 7, 19, 2]]


async def test_abort_after_tokens_fails_the_same_lanes_as_the_jax_engine(models):
    """The 7th token aborts every lane with ``injected_fault``; the engine
    frees every block and serves the next request in full."""
    jeng, teng = _pair(models)
    got = {}
    for name, eng in (("jax", jeng), ("torch", teng)):
        _both("abort_after_tokens=7")
        first = await asyncio.gather(*(_stream(eng, p) for p in PROMPTS))
        faults.set_injector(None)
        jfaults.set_injector(None)
        after = await _stream(eng, PROMPTS[0])
        got[name] = (first, after)
        await eng.close()
    assert got["torch"] == got["jax"]
    first, after = got["torch"]
    assert {f[1] for _, f in first} == {"injected_fault"}
    assert after[1] == ("length", None, None) and len(after[0]) == 8
    assert teng.allocator.free_count == teng.config.num_blocks - 1
    assert all(s is None for s in teng.slots) and not teng.waiting


async def test_slow_decode_stretches_dispatches_and_keeps_the_watchdog_quiet(models):
    """``slow_decode=3``: every dispatch takes three times as long, the
    label's EMA takes the stretched time, the watchdog (a budget far above
    the stretch) does not trip and the tokens are the unfaulted run's."""
    teng = _torch(models)
    base = await _stream(teng, PROMPTS[0])
    t0 = time.monotonic()
    await _stream(teng, PROMPTS[0])
    plain_s = time.monotonic() - t0
    ema0 = teng._dispatch_ema["decode"]
    ours, _ = _both("slow_decode=3")
    t0 = time.monotonic()
    slow = await _stream(teng, PROMPTS[0])
    slow_s = time.monotonic() - t0
    assert slow == base and ours.fired["slow_decode"] >= 8
    assert slow_s > 1.5 * plain_s
    assert teng._dispatch_ema["decode"] > 1.5 * ema0
    assert teng.stats.watchdog_trips == 0 and teng._dispatch_info is None
    await teng.close()


# --------------------------------------------------------- corrupt_kv twins

LAY = dict(num_layers=2, page_size=BS, num_kv_heads=2, head_dim=16, dtype="bfloat16")


def _blocks(n, seed):
    rng = np.random.default_rng(seed)
    shape = (2, 2, n, BS, 16)
    return (rng.integers(0, 2**16, shape, dtype=np.uint16),
            rng.integers(0, 2**16, shape, dtype=np.uint16))


def test_corrupt_kv_fires_in_the_tier_store_after_the_checksum():
    """test_integrity.py:243: the arena is corrupted after checksumming, so
    the next load fails and the block is counted (then quarantined, on its
    second failure, as the reference)."""
    _both("corrupt_kv=bits")
    m = TieredBlockManager(LayoutConfig(**LAY), host_blocks=4)
    jm = JManager(JLayout(**LAY), host_blocks=4)
    k, v = _blocks(1, seed=4)
    assert m.store_blocks([300], k, v) == jm.store_blocks([300], k, v) == 1
    np.testing.assert_array_equal(m._k_arena[m._host[300].index], jm._k_arena[jm._host[300].index])
    with pytest.raises(integrity.IntegrityError):
        m.load_blocks([300])
    assert m.stats.integrity_failures == 1
    assert integrity.COUNTERS.failures["tier_host"] == 1


def test_corrupt_kv_tears_the_g3_page(tmp_path):
    """A block spilled to disk under the fault has its page torn after the
    header's checksums were written: its promotion fails, never decoded."""
    m = TieredBlockManager(LayoutConfig(**LAY), host_blocks=1, disk_dir=str(tmp_path / "d"))
    k, v = _blocks(1, seed=5)
    assert m.store_blocks([11], k, v) == 1
    ours, _ = _both("corrupt_kv=bits")
    k2, v2 = _blocks(1, seed=6)
    assert m.store_blocks([12], k2, v2) == 1  # evicts 11 to disk: its page is torn
    assert ours.fired["corrupt_kv"] == 2 and 11 in m._disk
    faults.set_injector(None)
    with pytest.raises(integrity.IntegrityError):
        m.load_blocks([11])
    assert integrity.COUNTERS.failures.get("tier_disk") == 1


async def test_corrupt_tier_blocks_are_recomputed_token_identical(models):
    """An engine whose offloaded blocks were corrupted in the host arena:
    the next request's prefix hit fails its onboard, the prefix is
    recomputed, and the stream equals the unfaulted run and the JAX
    engine's under the same fault."""
    prompt = list(range(2, 19))
    got = {}
    for faulted in (False, True):
        jeng, teng = _pair(models, host_blocks=16, chunk=8)
        for name, eng in (("jax", jeng), ("torch", teng)):
            if faulted:
                _both("corrupt_kv=bits")
            first = await _stream(eng, prompt)
            for _ in range(200):  # 24 positions' KV: six blocks offloaded
                if eng.block_manager.stats.offloaded_g2 >= 6:
                    break
                await asyncio.sleep(0.02)
            faults.set_injector(None)
            jfaults.set_injector(None)
            second = await _stream(eng, prompt)
            got[(name, faulted)] = (first, second, eng.block_manager.stats.integrity_failures)
            await eng.close()
        if faulted:
            assert teng.stats.kv_onboard_errors == 1 and teng.stats.kv_onboarded_blocks == 0
        else:
            assert teng.stats.kv_onboarded_blocks > 0
    assert got[("torch", True)] == got[("jax", True)]
    assert got[("torch", True)][:2] == got[("torch", False)][:2]
    assert got[("torch", True)][2] == 1


async def test_corrupt_disagg_frames_are_refused_and_the_stream_is_token_identical(models):
    """test_integrity.py:313: every streamed frame and the final payload
    corrupted on the wire; the client refuses each at landing, the decode
    engine prefills locally, and the stream equals a local engine's."""
    local = _torch(models, chunk=8)
    prompt = list(range(2, 2 + 4 * BS + 3))
    ref = await _stream(local, prompt)
    await local.close()
    prefill, decode = _torch(models, chunk=8), _torch(models, chunk=8)
    fabric = FabricClient.in_process(FabricState())
    service = PrefillWorkerService(fabric, "integ", prefill)
    client = RemotePrefillClient(fabric, "integ", block_size=BS, timeout=10)
    decode.disagg_router = DisaggregatedRouter(DisaggConfig(max_local_prefill_length=4,
                                                            max_prefill_queue_size=100))
    decode.remote_prefill_client = client
    await service.start()
    await client.start()
    try:
        ours, _ = _both("corrupt_kv=bits,every=1")
        got = await _stream(decode, prompt)
        assert got == ref
        assert service.stats.frames_tx >= 2
        assert integrity.COUNTERS.failures.get("disagg_frame", 0) == service.stats.frames_tx
        assert integrity.COUNTERS.failures.get("disagg_final", 0) == 1
        assert ours.fired["corrupt_kv"] == service.stats.frames_tx + 1
        assert decode.stats.kv_frames_rx == 0  # nothing corrupt ever landed
        assert decode.stats.remote_fallbacks == 1
    finally:
        faults.set_injector(None)
        await decode.close()
        await prefill.close()
        await client.close()
        await service.close()
        await fabric.close()


# -------------------------------------------------------- control-plane twins


async def test_zombie_partition_self_fences_the_engine(models):
    """test_integrity.py:426: keepalives are swallowed while the fabric
    expires the lease; when the window ends the next keepalive finds the
    lease dead and the runtime's fence fails every lane with
    ``worker_fenced``; new work is refused with it."""
    # the dispatches stretched 50 times, so the stream outlives the window
    _both("zombie_partition=0.6,slow_decode=50")
    drt = await DistributedRuntime.detached(config=RuntimeConfig(lease_ttl_s=0.3),
                                            state=FabricState())
    engine = _torch(models)
    reasons = []

    def on_fence(reason: str) -> None:
        reasons.append(reason)
        engine.fence(reason)

    drt.on_fence(on_fence)
    try:
        task = asyncio.create_task(_stream(engine, PROMPTS[0], max_tokens=40))
        deadline = time.monotonic() + 10
        while not drt.fenced:
            assert time.monotonic() < deadline, "the runtime never self-fenced"
            await asyncio.sleep(0.05)
        toks, final = await asyncio.wait_for(task, 10)
        assert final[1] == "worker_fenced" and reasons and "lease" in reasons[0]
        assert len(toks) < 40
        _, again = await _stream(engine, [1, 2], 4)
        assert again[1] == "worker_fenced"
    finally:
        faults.set_injector(None)
        await engine.close()
        await drt.close()


async def test_fabric_blackout_within_the_budget_finishes_every_stream_unfenced(monkeypatch):
    """A control-plane blackout shorter than DYN_DEGRADED_MAX_S while three
    streams run over the data plane: every stream ends complete, no runtime
    self-fences and the worker's lease survives the heal."""
    monkeypatch.setenv("DYN_DEGRADED_MAX_S", "10")
    monkeypatch.setenv("DYN_TOKEN_ECHO_DELAY_MS", "40")
    state = FabricState()
    worker = await DistributedRuntime.detached(config=RuntimeConfig(lease_ttl_s=0.3), state=state)
    front = await DistributedRuntime.detached(config=RuntimeConfig(lease_ttl_s=0.3), state=state)
    fences = []
    for drt in (worker, front):
        drt.on_fence(fences.append)
    served = None
    try:
        ep = worker.namespace("bo").component("w").endpoint("generate")
        served = await ep.serve_endpoint(make_engine_handler(EchoEngineCore()))
        client = await front.namespace("bo").component("w").endpoint("generate").client()
        await client.wait_for_instances(5.0)
        remote = RemoteEngine(PushRouter(client, RouterMode.ROUND_ROBIN))
        prompts = [list(range(10 + i, 40 + i)) for i in range(3)]

        async def run(prompt):
            toks, final = [], None
            req = tp.PreprocessedRequest(token_ids=prompt, stop=tp.StopConditions(max_tokens=30))
            async for out in remote(req, tp.Context()):
                toks.extend(out.token_ids)
                if out.finish_reason is not None:
                    final = (out.finish_reason.value, out.error)
            return toks, final

        tasks = [asyncio.create_task(run(p)) for p in prompts]
        await asyncio.sleep(0.2)
        ours, _ = _both("fabric_blackout=0.7")
        results = await asyncio.wait_for(asyncio.gather(*tasks), 30)
        assert ours.fired.get("fabric_blackout", 0) > 0
        for (toks, final), prompt in zip(results, prompts):
            assert toks == prompt and final == ("length", None)
        await asyncio.sleep(0.6)  # the janitor's heal tick
        faults.set_injector(None)
        assert fences == [] and not worker.fenced and not front.fenced
        assert await worker.fabric.lease_keepalive(worker.primary_lease) is True
    finally:
        faults.set_injector(None)
        if served is not None:
            await served.stop()
        await front.close()
        await worker.close()


# ------------------------------------------------------- serve-graph twins


def _stop_group(proc) -> None:
    for sig, wait in ((signal.SIGTERM, 30), (signal.SIGKILL, 10)):
        try:
            os.killpg(proc.pid, sig)
        except ProcessLookupError:
            return
        try:
            proc.wait(wait)
        except subprocess.TimeoutExpired:
            pass


async def test_midstream_kill_under_dyn_fault_migrates_the_stream(tmp_path):
    """test_fault_tolerance.py:384 through the port's agg graph on its echo
    engine: every worker process is SIGKILLed by ``DYN_FAULT`` after 10
    tokens; the 30-token stream survives each death by migration, its text
    equals the unfaulted echo, and the frontend's exit stats count the
    migrations (at least two)."""
    from tests.test_torch_serve_graphs import wait_models

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("DYN_FABRIC_ADDR", None)
    out_path = tmp_path / "serve.log"
    log = open(out_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.serve", "dynamo_tpu_torch.graphs.agg",
         "--env", f"DYN_HTTP_PORT={port}", "--env", "DYN_HTTP_HOST=127.0.0.1",
         "--env", "DYN_LEASE_TTL_S=2", "--env", "DYN_TOKEN_ECHO_DELAY_MS=30",
         "--env", "DYN_FAULT=kill_after_tokens=10", "--replicas", "Worker=2"],
        cwd=str(tmp_path), env=env, stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
    try:
        models = await wait_models(port)
        words = [f"w{i}" for i in range(30)]
        st, _, data = await afetch(port, "POST", "/v1/completions", {
            "model": models[0]["id"], "prompt": " ".join(words), "stream": True,
            "max_tokens": 30}, timeout=120)
        assert st == 200
        events = sse(data)
        assert not [e for e in events if e.event == "error"], "the stream surfaced an error"
        text = "".join(c.get("text") or "" for e in events if e.event is None
                       for c in e.json().get("choices", []))
        assert text.split() == words
        proc.send_signal(signal.SIGTERM)
        assert await asyncio.to_thread(proc.wait, 60) == 0
    finally:
        _stop_group(proc)
        log.close()
    lines = out_path.read_text().splitlines()
    stats = [json.loads(ln)["exit_stats"] for ln in lines if ln.startswith('{"exit_stats"')]
    migrations = [sum(s["migrations"].values()) for s in stats if "migrations" in s]
    assert migrations and max(migrations) >= 2, lines[-40:]
