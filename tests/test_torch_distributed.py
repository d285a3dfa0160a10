"""The port's distributed runtime against the JAX package's, on the CPU.

- Twins of ``tests/test_component.py`` (the component model over the
  in-process fabric and over a fabric server), of ``test_lifeguard.py``'s
  context wire round trip and runtime drain, and discovery end to end as
  ``test_http_service.py::test_http_dynamic_discovery_e2e``.
- The port's frontend (``run_http`` over ``EngineConfig.dynamic``) over two
  f32 ``TorchEngine`` workers against the JAX frontend over two ``JaxEngine``
  workers with the same weights, each over its own package's fabric server:
  equal SSE texts, finish reasons and usage; round robin alternates.
- Cards and frames cross packages: a JAX worker serves the port's frontend
  and a port worker the JAX frontend.
- ``TorchEngine``'s migration resume contract (greedy equal to
  ``JaxEngine``'s at cuts 1 / 4 / 9, seeded equal to its own unfaulted run),
  a worker killed mid-stream (the stream completes token-identical, the
  migration counted), ``fence`` as ``JaxEngine.fence``, a worker's drain,
  ``RouterMode.KV`` wired through the KV router and ``direct`` refused.
- The CLI: the fabric server, a ``run in=dyn:// out=torch --device cpu``
  worker and a ``run in=http out=dyn`` frontend as processes; a streamed
  completion arrives, and a SIGKILLed worker leaves discovery within the
  lease TTL + 2 s.
"""

import asyncio
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest

from dynamo_tpu.discovery import register_llm as j_register_llm
from dynamo_tpu.engine.echo import EchoEngineCore as JEchoEngineCore
from dynamo_tpu.entrypoint import inputs as j_inputs
from dynamo_tpu.fabric import FabricClient as JFabricClient
from dynamo_tpu.fabric import FabricServer as JFabricServer
from dynamo_tpu.pipeline.context import Context as JContext
from dynamo_tpu.pipeline.router import RouterMode as JRouterMode
from dynamo_tpu.protocols import common as jp
from dynamo_tpu.runtime.config import RuntimeConfig as JRuntimeConfig
from dynamo_tpu.runtime.distributed import DistributedRuntime as JDistributedRuntime
from dynamo_tpu_torch import run as port_run
from dynamo_tpu_torch.discovery import ModelWatcher, register_llm
from dynamo_tpu_torch.engine.echo import EchoEngineCore
from dynamo_tpu_torch.entrypoint import inputs as t_inputs
from dynamo_tpu_torch.fabric import FabricClient, FabricServer
from dynamo_tpu_torch.fabric import client as t_client
from dynamo_tpu_torch.http.service import ModelManager
from dynamo_tpu_torch.model_card import ModelDeploymentCard
from dynamo_tpu_torch.pipeline.context import Context
from dynamo_tpu_torch.pipeline.router import PushRouter, RouterMode
from dynamo_tpu_torch.protocols import common as tp
from dynamo_tpu_torch.runtime.barrier import LeaderBarrier, WorkerBarrier
from dynamo_tpu_torch.runtime.component import NoInstancesError
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.protocols import EndpointId
from tests.test_torch_engine import make_jax_engine, make_torch_engine
from tests.test_torch_frontend import HTTP_CASES, MODEL, afetch, cards, sse, summarize, write_model_dir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_port_fabric():
    """Each test gets a clean process-shared in-memory fabric of the port
    (the suite's conftest resets the JAX package's)."""
    t_client.reset_shared_state()
    yield
    t_client.reset_shared_state()


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return write_model_dir(tmp_path_factory.mktemp("tiny_model"))


async def port_drt(addr: str) -> DistributedRuntime:
    drt = DistributedRuntime(await FabricClient.connect(addr), RuntimeConfig(fabric_addr=addr))
    await drt._start_primary_lease()
    return drt


async def jax_drt(addr: str):
    drt = JDistributedRuntime(await JFabricClient.connect(addr), JRuntimeConfig(fabric_addr=addr))
    await drt._start_primary_lease()
    return drt


async def wait_models(port: int, n: int = 1, timeout: float = 15.0) -> None:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        st, _, body = await afetch(port, "GET", "/v1/models")
        if st == 200 and len(json.loads(body)["data"]) >= n:
            return
        await asyncio.sleep(0.05)
    raise TimeoutError("no model discovered")


# --------------------------------------- twins of tests/test_component.py


def test_endpoint_id_parsing():
    eid = EndpointId.parse("dyn://ns.comp.ep")
    assert (eid.namespace, eid.component, eid.name) == ("ns", "comp", "ep")
    assert EndpointId.parse("comp.ep").namespace == "dynamo"
    assert str(eid) == "dyn://ns.comp.ep"
    with pytest.raises(ValueError):
        EndpointId.parse("only_one")


async def echo_handler(request, context):
    for tok in request["text"].split():
        yield {"token": tok}


async def failing_handler(request, context):
    yield {"token": "ok"}
    raise RuntimeError("boom")


async def test_serve_and_call_local_short_circuit():
    drt = await DistributedRuntime.detached()
    try:
        ep = drt.namespace("test").component("echo").endpoint("generate")
        service = await ep.serve_endpoint(echo_handler)
        client = await ep.client()
        assert await client.wait_for_instances(2.0) == [service.instance_id]
        stream = await client.round_robin({"text": "a b c"})
        toks = [a.data["token"] async for a in stream if a.data]
        assert toks == ["a", "b", "c"]
        await service.stop()
        await asyncio.sleep(0.05)  # watch delete event propagates async
        assert client.instances == {}
        with pytest.raises(NoInstancesError):
            await client.random({"text": "x"})
        await client.close()
    finally:
        await drt.close()


async def test_handler_error_surfaces_as_error_annotation():
    drt = await DistributedRuntime.detached()
    try:
        ep = drt.namespace("test").component("bad").endpoint("generate")
        await ep.serve_endpoint(failing_handler)
        client = await ep.client()
        stream = await client.random({})
        items = [a async for a in stream]
        assert items[0].data == {"token": "ok"}
        assert items[-1].is_error()
        assert "boom" in items[-1].error_message()
        await client.close()
    finally:
        await drt.close()


async def test_remote_round_trip_over_fabric_server():
    """Two runtimes over a real fabric server and the TCP response plane;
    the handler's error crosses the wire as an error annotation too."""
    server = FabricServer("127.0.0.1", 0)
    await server.start()
    try:
        worker_drt, caller_drt = await port_drt(server.addr), await port_drt(server.addr)
        try:
            ep_w = worker_drt.namespace("ns").component("c").endpoint("e")
            service = await ep_w.serve_endpoint(echo_handler)
            await worker_drt.namespace("ns").component("c").endpoint("bad").serve_endpoint(failing_handler)
            ep_c = caller_drt.namespace("ns").component("c").endpoint("e")
            client = await ep_c.client()
            await client.wait_for_instances(5.0)
            stream = await client.direct({"text": "hello distributed world"}, service.instance_id)
            toks = [a.data["token"] async for a in stream if a.data]
            assert toks == ["hello", "distributed", "world"]
            bad = await caller_drt.namespace("ns").component("c").endpoint("bad").client()
            await bad.wait_for_instances(5.0)
            items = [a async for a in await bad.random({})]
            assert items[0].data == {"token": "ok"} and "boom" in items[-1].error_message()
            await client.close()
            await bad.close()
        finally:
            await caller_drt.close()
            await worker_drt.close()
    finally:
        await server.close()


async def test_push_router_modes():
    drt = await DistributedRuntime.detached()
    try:
        ns = drt.namespace("rt")
        ep = ns.component("w").endpoint("gen")
        seen: list[int] = []

        def make_handler(tag):
            async def handler(request, context):
                seen.append(tag)
                yield {"tag": tag}

            return handler

        lease_a = await drt.create_lease()
        lease_b = await drt.create_lease()
        await ep.serve_endpoint(make_handler(1), lease_id=lease_a)
        await ep.serve_endpoint(make_handler(2), lease_id=lease_b)
        client = await ep.client()
        await client.wait_for_instances(2.0)
        router = PushRouter(client, RouterMode.ROUND_ROBIN)
        for _ in range(4):
            stream = await router.generate({})
            async for _item in stream:
                pass
        assert sorted(seen) == [1, 1, 2, 2]
        seen.clear()
        router_d = PushRouter(client, RouterMode.DIRECT)
        stream = await router_d.generate({}, instance_id=lease_b)
        async for _item in stream:
            pass
        assert seen == [2]
        # random mode reaches both; an exclusion set steers off one
        seen.clear()
        router_r = PushRouter(client, RouterMode.RANDOM)
        for _ in range(6):
            async for _item in await router_r.generate({}, exclude={lease_a}):
                pass
        assert seen == [2] * 6
        await client.close()
    finally:
        await drt.close()


async def test_instance_removed_on_lease_expiry():
    drt = await DistributedRuntime.detached()
    try:
        ep = drt.namespace("ft").component("w").endpoint("gen")
        lease = await drt.fabric.lease_grant(0.6)  # short, un-refreshed
        await ep.serve_endpoint(echo_handler, lease_id=lease)
        client = await ep.client()
        await client.wait_for_instances(2.0)
        assert len(client.instances) == 1
        await asyncio.sleep(1.5)  # janitor expires the lease
        assert client.instances == {}
        await client.close()
    finally:
        await drt.close()


async def test_leader_worker_barrier():
    drt = await DistributedRuntime.detached()
    try:
        fabric = drt.fabric
        lease = drt.primary_lease
        results = {}

        async def leader():
            await LeaderBarrier("b1", num_workers=2, timeout=5).sync(fabric, lease, {"addr": "10.0.0.1:1234"})
            results["leader"] = True

        async def worker(wid):
            results[wid] = await WorkerBarrier("b1", wid, timeout=5).sync(fabric, lease)

        await asyncio.wait_for(asyncio.gather(leader(), worker("w0"), worker("w1")), 10)
        assert results["leader"]
        assert results["w0"]["addr"] == "10.0.0.1:1234"
        assert results["w1"]["addr"] == "10.0.0.1:1234"
    finally:
        await drt.close()


async def test_stream_cancellation_kills_context():
    """Over the in-process short circuit and over the TCP response plane:
    closing the caller's stream kills the worker's context."""
    server = FabricServer("127.0.0.1", 0)
    await server.start()
    drts = [await DistributedRuntime.detached(), await port_drt(server.addr)]
    try:
        for drt in drts:
            cancelled = asyncio.Event()

            async def slow_handler(request, context, cancelled=cancelled):
                try:
                    for i in range(1000):
                        yield {"i": i}
                        await asyncio.sleep(0.01)
                finally:
                    if context.is_killed():
                        cancelled.set()

            ep = drt.namespace("cx").component("slow").endpoint("gen")
            await ep.serve_endpoint(slow_handler)
            client = await ep.client()
            stream = await client.random({})
            count = 0
            async for _item in stream:
                count += 1
                if count >= 3:
                    break
            await stream.close()
            await asyncio.wait_for(cancelled.wait(), 5.0)
            await client.close()
    finally:
        for drt in drts:
            await drt.close()
        await server.close()


async def test_a_caller_gone_before_the_first_item_kills_the_context():
    """Over the TCP response plane: a caller that closes its stream before
    the worker's first item (a remote prefill in flight) kills the worker's
    context at once, not at the worker's first send. (In-process, the
    handler runs only while the caller iterates.)"""
    server = FabricServer("127.0.0.1", 0)
    await server.start()
    drts = [await port_drt(server.addr)]
    try:
        for drt in drts:
            killed = asyncio.Event()

            async def waiting_handler(request, context, killed=killed):
                for _ in range(1000):
                    if context.is_killed():
                        killed.set()
                        return
                    await asyncio.sleep(0.01)
                yield {"late": True}

            ep = drt.namespace("cx").component("wait").endpoint("gen")
            await ep.serve_endpoint(waiting_handler)
            client = await ep.client()
            stream = await client.random({})
            await asyncio.sleep(0.2)
            await stream.close()
            await asyncio.wait_for(killed.wait(), 5.0)
            await client.close()
    finally:
        for drt in drts:
            await drt.close()
        await server.close()


def test_runtime_config_reads_toml_and_env_as_the_jax_package(tmp_path, monkeypatch):
    path = tmp_path / "runtime.toml"
    path.write_text('[runtime]\nnamespace = "prod"\nlease_ttl_s = 7.5\ntcp_port = 7000\nunknown = 1\n')
    monkeypatch.setenv("DYN_RUNTIME_CONFIG", str(path))
    monkeypatch.setenv("DYN_FABRIC_ADDR", "10.0.0.1:6650,10.0.0.2:6650")
    monkeypatch.setenv("DYN_TCP_HOST", "10.0.0.9")
    monkeypatch.setenv("DYN_LEASE_TTL_S", "3")
    monkeypatch.setenv("DYN_DEGRADED_MAX_S", "60")
    monkeypatch.setenv("DYN_WARM_RESTART_DIR", str(tmp_path / "warm"))
    ours, ref = RuntimeConfig.from_settings(), JRuntimeConfig.from_settings()
    for name in ("fabric_addr", "tcp_host", "tcp_port", "lease_ttl_s", "namespace"):
        assert getattr(ours, name) == getattr(ref, name), name
    assert (ours.namespace, ours.lease_ttl_s, ours.tcp_port) == ("prod", 3.0, 7000)
    assert ours.degraded_max_s == 60.0 and ours.warm_restart_dir == str(tmp_path / "warm")
    monkeypatch.delenv("DYN_RUNTIME_CONFIG")
    monkeypatch.delenv("DYN_LEASE_TTL_S")
    assert RuntimeConfig.from_settings().lease_ttl_s == JRuntimeConfig.from_settings().lease_ttl_s == 10.0


# ------------------------------------------- twins of test_lifeguard.py


def test_context_deadline_wire_roundtrip():
    ctx = Context()
    ctx.set_deadline_ms(5000, ttft_ms=1000)
    assert not ctx.expired()
    h = ctx.to_header()
    back = Context.from_header(h)
    assert back.deadline == ctx.deadline
    assert back.ttft_deadline == ctx.ttft_deadline
    child = back.child()
    assert child.deadline == back.deadline and child.id == back.id
    expired = Context()
    expired.set_deadline_ms(0.001)
    time.sleep(0.002)
    assert expired.expired()
    # the header is the JAX package's, both ways; a kill reaches children
    j = JContext(metadata={"worker_instance_id": 5})
    j.set_deadline_ms(3000)
    assert Context.from_header(j.to_header()).to_header() == j.to_header()
    assert JContext.from_header(h).to_header() == h
    back.kill()
    assert child.is_killed() and child.is_stopped() and not Context().child().is_killed()


async def test_runtime_drain_runs_callbacks_bounded():
    drt = await DistributedRuntime.detached()
    try:
        ran = []

        async def quick():
            ran.append("quick")

        async def stuck():
            await asyncio.sleep(60)

        drt.on_drain(quick)
        drt.on_drain(stuck)  # must not block exit past the budget
        t0 = time.monotonic()
        await drt.drain(timeout_s=0.2)
        assert ran == ["quick"]
        assert time.monotonic() - t0 < 5
        await drt.drain(timeout_s=0.2)  # callbacks are consumed
    finally:
        await drt.close()


# ---------------------------------------------------------------- discovery


def echo_card(model_dir: str, name: str) -> ModelDeploymentCard:
    return ModelDeploymentCard.from_model_dir(model_dir, name)


async def test_http_dynamic_discovery_e2e(model_dir):
    """A worker registers a model via register_llm; the frontend's
    ModelWatcher discovers it, serves OpenAI requests routed over the
    fabric, and drops it when the worker's lease goes."""
    worker_drt = await DistributedRuntime.detached()
    front_drt = await DistributedRuntime.detached()
    service = None
    try:
        endpoint = worker_drt.namespace("demo").component("worker").endpoint("generate")
        served = await endpoint.serve_endpoint(t_inputs.make_engine_handler(EchoEngineCore()))
        key = await register_llm(worker_drt, endpoint, echo_card(model_dir, "distributed-echo"))
        config = t_inputs.EngineConfig.dynamic(RouterMode.ROUND_ROBIN)
        service = await t_inputs.run_http(config, host="127.0.0.1", port=0, drt=front_drt)
        await wait_models(service.port)
        body = {"model": "distributed-echo", "prompt": "fox jumps over", "stream": True, "max_tokens": 8}
        st, _, data = await afetch(service.port, "POST", "/v1/completions", body)
        got = summarize(st, data, True)
        assert got["choices"][0]["text"].split() == ["fox", "jumps", "over"]
        assert got["choices"][0]["finish"] == "stop"
        await served.stop()
        await worker_drt.fabric.kv_delete(key)
        for _ in range(50):
            if not service.manager.list_models():
                break
            await asyncio.sleep(0.02)
        assert service.manager.list_models() == []
    finally:
        if service:
            await service.close()
            await service.watcher.stop()
        await front_drt.close()
        await worker_drt.close()


async def test_cards_and_frames_cross_packages(model_dir):
    """A JAX echo worker on the port's fabric server serves the port's
    frontend, and a port echo worker on the JAX fabric server serves the
    JAX frontend: the card's JSON, the request plane and the fabric's
    frames read the same in both packages."""
    from tests.util import make_test_mdc

    words = "the quick brown fox jumps over lazy dog"
    # JAX worker -> port frontend, over the port's server
    server = FabricServer("127.0.0.1", 0)
    await server.start()
    jw, front = await jax_drt(server.addr), await port_drt(server.addr)
    service = None
    try:
        ep = jw.namespace("x").component("w").endpoint("generate")
        await ep.serve_endpoint(j_inputs.make_engine_handler(JEchoEngineCore(), stamp={"iid": 1, "ep": 1}))
        await j_register_llm(jw, ep, make_test_mdc("jax-echo"))
        service = await t_inputs.run_http(t_inputs.EngineConfig.dynamic(), host="127.0.0.1", port=0, drt=front)
        await wait_models(service.port)
        card = await ModelDeploymentCard.download(front.fabric, "jax-echo")
        assert card.to_json() == make_test_mdc("jax-echo").to_json().replace(
            '"tokenizer_obj": null', '"tokenizer_obj": "jax-echo/tokenizer.json"')
        st, _, data = await afetch(service.port, "POST", "/v1/completions",
                                   {"model": "jax-echo", "prompt": words, "stream": True, "max_tokens": 5})
        assert summarize(st, data, True)["choices"][0]["text"].split() == words.split()[:5]
    finally:
        if service:
            await service.close()
            await service.watcher.stop()
        await front.close()
        await jw.close()
        await server.close()
    # port worker -> JAX frontend, over the JAX server
    server = JFabricServer("127.0.0.1", 0)
    await server.start()
    tw, front = await port_drt(server.addr), await jax_drt(server.addr)
    jservice = None
    try:
        ep = tw.namespace("x").component("w").endpoint("generate")
        await ep.serve_endpoint(t_inputs.make_engine_handler(EchoEngineCore()))
        await register_llm(tw, ep, echo_card(model_dir, "port-echo"))
        jservice = await j_inputs.run_http(front, j_inputs.EngineConfig.dynamic(JRouterMode.ROUND_ROBIN),
                                           host="127.0.0.1", port=0)
        await wait_models(jservice.port)
        st, _, data = await afetch(jservice.port, "POST", "/v1/completions",
                                   {"model": "port-echo", "prompt": words, "stream": True, "max_tokens": 4})
        assert summarize(st, data, True)["choices"][0]["text"].split() == words.split()[:4]
    finally:
        if jservice:
            await jservice.close()
        await front.close()
        await tw.close()
        await server.close()


class Recording:
    """Delegates to an engine, noting its tag in a shared log per request."""

    def __init__(self, engine, tag, log) -> None:
        self.engine, self.tag, self.log = engine, tag, log

    def generate(self, request, context):
        self.log.append(self.tag)
        return self.engine.generate(request, context)


async def serve_workers(drts, engines, mdc, register):
    for drt, engine in zip(drts, engines):
        ep = drt.namespace("dynamo").component("backend").endpoint("generate")
        await ep.serve_endpoint(t_inputs.make_engine_handler(engine) if register is register_llm
                                else j_inputs.make_engine_handler(engine))
        await register(drt, ep, mdc)


async def test_port_frontend_over_two_torch_workers_matches_the_jax_frontend(model_dir, monkeypatch):
    # the round-robin check below needs both workers in the route set: a
    # loaded CPU can make one look 3x slower for the health scorer's three
    # ticks, which would eject it (the tail plane's own tests cover that)
    monkeypatch.setenv("DYN_EJECT_INTERVALS", "1000000")
    ref_mdc, port_mdc = cards(model_dir)
    log_j, log_t = [], []
    jserver, tserver = JFabricServer("127.0.0.1", 0), FabricServer("127.0.0.1", 0)
    await jserver.start()
    await tserver.start()
    jdrts = [await jax_drt(jserver.addr) for _ in range(3)]
    tdrts = [await port_drt(tserver.addr) for _ in range(3)]
    jengines = [make_jax_engine(), make_jax_engine()]
    tengines = [make_torch_engine(), make_torch_engine()]
    jsvc = tsvc = None
    try:
        await serve_workers(jdrts[:2], [Recording(e, i, log_j) for i, e in enumerate(jengines)],
                            ref_mdc, j_register_llm)
        await serve_workers(tdrts[:2], [Recording(e, i, log_t) for i, e in enumerate(tengines)],
                            port_mdc, register_llm)
        jsvc = await j_inputs.run_http(jdrts[2], j_inputs.EngineConfig.dynamic(JRouterMode.ROUND_ROBIN),
                                       host="127.0.0.1", port=0)
        tsvc = await t_inputs.run_http(t_inputs.EngineConfig.dynamic(RouterMode.ROUND_ROBIN),
                                       host="127.0.0.1", port=0, drt=tdrts[2])
        await wait_models(jsvc.port)
        await wait_models(tsvc.port)
        for path, body in HTTP_CASES:
            body = {"model": MODEL, **body}
            a = await afetch(jsvc.port, "POST", path, body)
            b = await afetch(tsvc.port, "POST", path, body)
            sa, sb = summarize(a[0], a[2], body["stream"]), summarize(b[0], b[2], body["stream"])
            assert sb == sa, (path, body)
            assert sa["status"] == 200 and all(c["finish"] for c in sa["choices"].values())
        # an engine error crosses the wire as the same typed SSE error
        too_long = {"model": MODEL, "prompt": [5] * 70, "max_tokens": 4, "stream": True}
        ea = [e for e in sse((await afetch(jsvc.port, "POST", "/v1/completions", too_long))[2])
              if e.event == "error"]
        eb = [e for e in sse((await afetch(tsvc.port, "POST", "/v1/completions", too_long))[2])
              if e.event == "error"]
        assert len(ea) == len(eb) == 1
        assert eb[0].json()["error"]["type"] == ea[0].json()["error"]["type"] == "prompt_too_long"
        # round robin alternates the two workers, one engine request at a time
        log_t.clear()
        for _ in range(4):
            st, _, data = await afetch(tsvc.port, "POST", "/v1/completions",
                                       {"model": MODEL, "prompt": "one two", "max_tokens": 2})
            assert st == 200
        assert log_t in ([0, 1, 0, 1], [1, 0, 1, 0])
        assert all(e.allocator.free_count == e.config.num_blocks - 1 for e in tengines)
    finally:
        for svc in (jsvc, tsvc):
            if svc:
                await svc.close()
        if tsvc:
            await tsvc.watcher.stop()
        for drt in jdrts + tdrts:
            await drt.close()
        for e in jengines + tengines:
            await e.close()
        await jserver.close()
        await tserver.close()


# ------------------------------------------------------- engine contracts


async def collect(engine, request, ctx):
    toks, final = [], None
    async for out in engine.generate(request, ctx):
        toks.extend(out.token_ids)
        if out.finish_reason is not None:
            final = out
    return toks, final


def resume_request(mod, prompt, sampling, tail=(), max_tokens=10, **extra):
    return mod.PreprocessedRequest(
        token_ids=list(prompt) + list(tail), sampling=mod.SamplingOptions(**sampling),
        stop=mod.StopConditions(max_tokens=max_tokens, ignore_eos=True, **extra),
        extra={"resume_prompt_len": len(prompt)} if tail else {},
    )


async def test_torch_engine_resume_contract():
    """Replaying prompt + emitted tokens under resume_prompt_len continues
    the stream: greedy equal to JaxEngine's at cuts 1 / 4 / 9 (and the
    unfaulted streams equal), seeded equal to the engine's own unfaulted
    run, and max_tokens counts the replayed tail. With penalties the resumed
    tail is held to JaxEngine's: both part from their unfaulted run at cut
    9 (the reference's behaviour, ROADMAP.md Queue C)."""
    prompt = [5, 9, 17, 23, 2, 40]
    jeng, teng = make_jax_engine(), make_torch_engine()
    try:
        greedy = {"greedy": True}
        jbase, _ = await collect(jeng, resume_request(jp, prompt, greedy), JContext())
        tbase, final = await collect(teng, resume_request(tp, prompt, greedy), Context())
        assert tbase == jbase and len(tbase) == 10 and final.finish_reason is tp.FinishReason.LENGTH
        for cut in (1, 4, 9):
            jt, _ = await collect(jeng, resume_request(jp, prompt, greedy, jbase[:cut]), JContext())
            tt, final = await collect(teng, resume_request(tp, prompt, greedy, tbase[:cut]), Context())
            assert tt == jt == tbase[cut:], cut
            assert final.finish_reason is tp.FinishReason.LENGTH
        for sampling in ({"temperature": 0.9, "top_k": 8, "seed": 1234},
                         {"greedy": True, "frequency_penalty": 0.7, "repetition_penalty": 1.3}):
            base, _ = await collect(teng, resume_request(tp, prompt, sampling), Context())
            jb, _ = await collect(jeng, resume_request(jp, prompt, sampling), JContext())
            for cut in (1, 4, 9):
                tail, _ = await collect(teng, resume_request(tp, prompt, sampling, base[:cut]), Context())
                if "seed" in sampling:
                    assert tail == base[cut:], (cut, sampling)
                else:  # penalties, greedy: JAX's tokens
                    assert base == jb
                    jt, _ = await collect(jeng, resume_request(jp, prompt, sampling, jb[:cut]), JContext())
                    assert tail == jt and len(tail) == 10 - cut, cut
        assert teng.allocator.free_count == teng.config.num_blocks - 1
    finally:
        await jeng.close()
        await teng.close()


async def test_fence_fails_lanes_as_the_jax_engine_does():
    finals = {}
    for name, engine, mod, ctx_cls in (("jax", make_jax_engine(), jp, JContext),
                                       ("torch", make_torch_engine(), tp, Context)):
        try:
            req = mod.PreprocessedRequest(token_ids=[3, 4, 5], sampling=mod.SamplingOptions(greedy=True),
                                          stop=mod.StopConditions(max_tokens=50, ignore_eos=True))
            got, finals_seen = [], []
            async for out in engine.generate(req, ctx_cls()):
                got.extend(out.token_ids)
                if len(got) == 2:
                    engine.fence("lease 7 lost")
                if out.finish_reason is not None:
                    finals_seen.append(out)
            _, refused = await collect(engine, req, ctx_cls())
            finals[name] = ([(f.finish_reason.value, f.error["code"], f.error["phase"]) for f in finals_seen],
                            (refused.error["code"], refused.error["phase"]), len(got) < 50)
        finally:
            await engine.close()
    assert finals["torch"] == finals["jax"]
    assert finals["torch"][0] == [("error", "worker_fenced", "decode")]
    assert finals["torch"][1] == ("worker_fenced", "admission") and finals["torch"][2]


class DyingEngine:
    """A TorchEngine whose stream breaks (as a SIGKILLed worker's response
    plane does) after ``die_after`` tokens, every time it serves."""

    def __init__(self, engine, die_after: int) -> None:
        self.engine, self.die_after, self.served = engine, die_after, 0

    async def generate(self, request, context):
        self.served += 1
        n = 0
        async for out in self.engine.generate(request, context):
            if out.finish_reason is None and n >= self.die_after:
                raise ConnectionResetError("worker died mid-stream")
            yield out
            n += 1


async def test_midstream_worker_death_migrates_token_identical(model_dir):
    """Round robin over a dying TorchEngine worker and a healthy one, over a
    fabric server: the stream that lands on the dying one is replayed onto
    the other (prompt + emitted tokens under resume_prompt_len) and equals
    an unfaulted run, and the migration is counted."""
    _, port_mdc = cards(model_dir)
    server = FabricServer("127.0.0.1", 0)
    await server.start()
    drts = [await port_drt(server.addr) for _ in range(3)]
    dying = DyingEngine(make_torch_engine(), die_after=3)
    healthy = make_torch_engine()
    service = None
    try:
        await serve_workers(drts[:2], [dying, healthy], port_mdc, register_llm)
        service = await t_inputs.run_http(t_inputs.EngineConfig.dynamic(), host="127.0.0.1", port=0,
                                          drt=drts[2])
        await wait_models(service.port)
        body = {"model": MODEL, "prompt": "the quick brown fox jumps", "max_tokens": 12, "stream": True,
                "temperature": 0.0, "nvext": {"ignore_eos": True}, "stream_options": {"include_usage": True}}

        async def stream_one():
            st, _, data = await afetch(service.port, "POST", "/v1/completions", body)
            assert not [e for e in sse(data) if e.event == "error"]
            return summarize(st, data, True)

        out1, out2 = await stream_one(), await stream_one()
        served_faulty = dying.served
        dying.die_after = 10 ** 9
        baseline = await stream_one()
        assert out1 == baseline and out2 == baseline
        assert baseline["usage"]["completion_tokens"] == 12
        assert served_faulty >= 1
        assert service.watcher.migrations[MODEL] >= 1
        assert port_run.frontend_stats(service)["migrations"][MODEL] >= 1
        for e in (dying.engine, healthy):
            assert e.allocator.free_count == e.config.num_blocks - 1
    finally:
        if service:
            await service.close()
            await service.watcher.stop()
        for drt in drts:
            await drt.close()
        await dying.engine.close()
        await healthy.close()
        await server.close()


async def test_worker_drain_leaves_discovery_and_finishes_in_flight(model_dir, monkeypatch):
    """``run_endpoint``'s drain (the CLI's SIGTERM): the instance leaves
    discovery at once, the stream in flight finishes, run_endpoint returns;
    a fenced runtime fences the engine."""
    monkeypatch.setenv("DYN_TOKEN_ECHO_DELAY_MS", "20")
    server = FabricServer("127.0.0.1", 0)
    await server.start()
    worker, caller = await port_drt(server.addr), await port_drt(server.addr)
    try:
        config = t_inputs.EngineConfig.static_(EchoEngineCore(), echo_card(model_dir, "drain-echo"))
        task = asyncio.ensure_future(t_inputs.run_input("dyn://ns.w.generate", config, drt=worker))
        client = await caller.namespace("ns").component("w").endpoint("generate").client()
        await client.wait_for_instances(5.0)
        req = tp.PreprocessedRequest(token_ids=list(range(5, 25)), stop=tp.StopConditions(max_tokens=20))
        stream = await client.random(req.to_dict())
        it = stream.__aiter__()
        first = await it.__anext__()
        assert first.data["stamp"] == {"iid": worker.primary_lease, "ep": worker.primary_lease}
        drain = asyncio.ensure_future(worker.drain(10.0))
        await asyncio.sleep(0.1)
        assert await caller.fabric.kv_get_prefix("instances/ns/w/generate") == {}
        rest = [a async for a in it]
        toks = first.data["token_ids"] + [t for a in rest if a.data for t in a.data["token_ids"]]
        assert toks == list(range(5, 25)) and rest[-1].data["finish_reason"] == "length"
        await drain
        await asyncio.wait_for(task, 5)
        await client.close()
    finally:
        await caller.close()
        await worker.close()
        await server.close()

    class Fenceable(EchoEngineCore):
        fenced = None

        def fence(self, reason):
            self.fenced = reason

    drt = await DistributedRuntime.detached(RuntimeConfig(lease_ttl_s=0.6))
    try:
        engine = Fenceable()
        config = t_inputs.EngineConfig.static_(engine, echo_card(model_dir, "fence-echo"))
        task = asyncio.ensure_future(t_inputs.run_endpoint(drt, config, "ns.f.generate"))
        await asyncio.sleep(0.2)
        await drt.fabric.lease_revoke(drt.primary_lease)  # the cluster lost us
        await asyncio.wait_for(task, 5)
        assert engine.fenced and "lost" in engine.fenced and drt.fenced
    finally:
        await drt.close()


async def test_router_mode_kv_builds_the_kv_router_and_direct_is_refused(model_dir, capsys):
    """``RouterMode.KV`` builds a PushRouter over a selector and a
    ModelWatcher; ``run_http`` and ``run_text`` start in KV mode and serve
    an echo worker through a KvRouter; ``direct`` stays refused."""
    from dynamo_tpu_torch.kv_router.router import KvPushRouter, KvRouter

    worker = await DistributedRuntime.detached()
    drt = await DistributedRuntime.detached()
    service = None
    try:
        ep = worker.namespace("k").component("w").endpoint("generate")
        await ep.serve_endpoint(t_inputs.make_engine_handler(EchoEngineCore()))
        await register_llm(worker, ep, echo_card(model_dir, "kv-echo"))
        client = await drt.namespace("k").component("w").endpoint("generate").client()
        with pytest.raises(ValueError, match="WorkerSelector"):
            PushRouter(client, RouterMode.KV)
        kv = KvRouter(drt.namespace("k").component("w"), client, block_size=4)
        assert PushRouter(client, RouterMode.KV, selector=KvPushRouter(kv)).mode is RouterMode.KV
        await kv.close()
        watcher = ModelWatcher(drt, ModelManager(), RouterMode.KV)
        await watcher.start()
        assert list(watcher.kv_routers) == ["dyn://k.w.generate"]
        await watcher.stop()
        service = await t_inputs.run_http(t_inputs.EngineConfig.dynamic(RouterMode.KV), host="127.0.0.1",
                                          port=0, drt=drt)
        await wait_models(service.port)
        st, _, data = await afetch(service.port, "POST", "/v1/completions",
                                   {"model": "kv-echo", "prompt": "fox jumps over", "max_tokens": 3})
        assert st == 200 and json.loads(data)["choices"][0]["text"].split() == ["fox", "jumps", "over"]
        assert service.watcher.kv_routers["dyn://k.w.generate"].scheduler.hit_stats["decisions"] == 1
        config = port_run.build_config(port_run.parse_args(["in=http", "out=dyn", "--router-mode", "kv"]))
        assert config.router_mode is RouterMode.KV and config.kv_router_config.router_temperature == 0.5
        await t_inputs.run_text(config, prompt_once="lazy dog", drt=drt)
        assert "lazy dog" in capsys.readouterr().out
        # direct needs an instance id a frontend never picks: refused at start too
        with pytest.raises(ValueError, match="round_robin or random"):
            ModelWatcher(drt, ModelManager(), RouterMode.DIRECT)
        with pytest.raises(SystemExit):
            port_run.parse_args(["in=http", "out=dyn", "--router-mode", "direct"])
        await client.close()
    finally:
        if service:
            await service.close()
            await service.watcher.stop()
        await drt.close()
        await worker.close()


@pytest.mark.parametrize("inout", [["in=http", "out=dyn"], ["in=dyn://dynamo.backend.generate", "out=torch"]])
def test_cli_refuses_a_distributed_role_without_a_fabric_address(inout, monkeypatch):
    monkeypatch.delenv("DYN_FABRIC_ADDR", raising=False)
    monkeypatch.delenv("DYN_RUNTIME_CONFIG", raising=False)
    with pytest.raises(SystemExit, match="DYN_FABRIC_ADDR"):
        asyncio.run(port_run.amain(port_run.parse_args([*inout, "--model-path", "unused", "--device", "cpu"])))


def test_runtime_http_server_knob_is_refused_not_ignored(tmp_path, monkeypatch):
    # the status server is ported: the knob is honoured (never ignored),
    # read as the JAX package's RuntimeConfig reads it
    from dynamo_tpu.runtime.config import RuntimeConfig as JRuntimeConfig

    monkeypatch.delenv("DYN_RUNTIME_CONFIG", raising=False)
    monkeypatch.delenv("DYN_RUNTIME_HTTP_PORT", raising=False)
    monkeypatch.delenv("DYN_RUNTIME_HTTP_ENABLED", raising=False)
    cfg = RuntimeConfig.from_settings()
    assert (cfg.http_enabled, cfg.http_port) == (False, 9090)
    monkeypatch.setenv("DYN_RUNTIME_HTTP_ENABLED", "1")
    monkeypatch.setenv("DYN_RUNTIME_HTTP_PORT", "9191")
    cfg, ref = RuntimeConfig.from_settings(), JRuntimeConfig.from_settings()
    assert (cfg.http_enabled, cfg.http_port) == (ref.http_enabled, ref.http_port) == (True, 9191)
    monkeypatch.delenv("DYN_RUNTIME_HTTP_ENABLED")
    monkeypatch.delenv("DYN_RUNTIME_HTTP_PORT")
    path = tmp_path / "runtime.toml"
    path.write_text("[runtime]\nhttp_enabled = true\nhttp_port = 9292\n")
    cfg, ref = RuntimeConfig.from_settings(str(path)), JRuntimeConfig.from_settings(str(path))
    assert (cfg.http_enabled, cfg.http_port) == (ref.http_enabled, ref.http_port) == (True, 9292)
    path.write_text("[runtime]\nhttp_enabled = false\nnamespace = \"x\"\n")
    assert RuntimeConfig.from_settings(str(path)).namespace == "x"


# --------------------------------------------------------------------- CLI


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_get(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


@pytest.mark.timeout(170)
def test_cli_fabric_worker_frontend_and_a_killed_worker(tmp_path):
    model_dir = write_model_dir(tmp_path / "model")
    fport, hport, ttl = free_port(), free_port(), 2.0
    env = dict(os.environ, PYTHONPATH=ROOT, DYN_FABRIC_ADDR=f"127.0.0.1:{fport}", DYN_LEASE_TTL_S=str(ttl))
    logs = {name: open(tmp_path / f"{name}.log", "w+") for name in ("fabric", "worker", "frontend")}
    cmds = {
        "fabric": ["-m", "dynamo_tpu_torch.fabric.server", "--port", str(fport)],
        "worker": ["-m", "dynamo_tpu_torch.run", "in=dyn://dynamo.backend.generate", "out=torch",
                   "--model-path", model_dir, "--model-name", MODEL, "--device", "cpu",
                   "--context-length", "64", "--num-blocks", "64", "--max-batch", "4"],
        "frontend": ["-m", "dynamo_tpu_torch.run", "in=http", "out=dyn", "--router-mode", "round_robin",
                     "--http-host", "127.0.0.1", "--http-port", str(hport)],
    }
    procs = {}

    def tail(name):
        logs[name].flush()
        logs[name].seek(0)
        return logs[name].read()[-3000:]

    try:
        for name in ("fabric", "worker", "frontend"):
            procs[name] = subprocess.Popen([sys.executable, *cmds[name]], cwd=ROOT, env=env,
                                           stdout=logs[name], stderr=subprocess.STDOUT)
            if name == "fabric":
                time.sleep(0.5)
        t0 = time.monotonic()
        while True:
            for name, p in procs.items():
                assert p.poll() is None, (name, tail(name))
            try:
                st, data = http_get(hport, "/v1/models")
                if st == 200 and json.loads(data)["data"]:
                    break
            except OSError:
                pass
            assert time.monotonic() - t0 < 120, (tail("worker"), tail("frontend"))
            time.sleep(0.2)
        body = {"model": MODEL, "messages": [{"role": "user", "content": "hello world"}], "max_tokens": 6,
                "temperature": 0.0, "stream": True, "stream_options": {"include_usage": True},
                "nvext": {"ignore_eos": True}}
        conn = http.client.HTTPConnection("127.0.0.1", hport, timeout=60)
        conn.request("POST", "/v1/chat/completions", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        got = summarize(200, resp.read(), True)
        conn.close()
        assert got["usage"]["completion_tokens"] == 6 and got["choices"][0]["finish"] == "length"

        async def instances():
            c = await FabricClient.connect(f"127.0.0.1:{fport}")
            try:
                return await c.kv_get_prefix("instances/dynamo/backend/generate")
            finally:
                await c.close()

        assert len(asyncio.run(instances())) == 1
        procs["worker"].send_signal(signal.SIGKILL)
        procs["worker"].wait(10)
        t_kill = time.monotonic()
        while asyncio.run(instances()):
            assert time.monotonic() - t_kill < ttl + 2.0, "the killed worker's instance stayed"
            time.sleep(0.1)
    finally:
        for name in ("frontend", "worker", "fabric"):
            p = procs.get(name)
            if p is not None and p.poll() is None:
                p.send_signal(signal.SIGTERM)
                try:
                    p.wait(20)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(10)
        for f in logs.values():
            f.close()
    out = (tmp_path / "frontend.log").read_text()
    stats = [json.loads(line)["exit_stats"] for line in out.splitlines() if line.startswith('{"exit_stats"')]
    assert stats and stats[-1]["migrations"] == {MODEL: 0}, out[-2000:]
