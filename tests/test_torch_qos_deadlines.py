"""Deadlines (C6) and QoS classes (C7) in the port, on the CPU.

- ``TorchEngine`` sheds an expired request as ``JaxEngine`` does
  (``tests/test_lifeguard.py::test_jax_deadline_structured_error_and_stats``:
  the same typed final and ``stats.deadline_exceeded``), and at the
  reference's other points: at admission (the TTFT budget too), while
  queued, awaiting a remote prefill (the blocks held until the task ends)
  and mid-generation (lane and blocks freed), after the mocker cases of
  ``test_lifeguard.py``. Each case runs on a JaxEngine and a TorchEngine
  over the same weights, and their errors, stats and freed blocks must be
  equal.
- The HTTP edge: an ``ext.timeout_ms`` past its stream's length ends it with
  a typed SSE ``deadline_exceeded`` event (the twin of
  ``test_http_deadline_streams_typed_error_and_metric`` without its
  ``/metrics`` line), a 504 when not streamed, and ``DYN_DEFAULT_DEADLINE_MS``
  arms it when the request names none.
- The classes: twins of ``tests/test_priority.py``'s resolution and
  drain-rate cases; the header, then ``ext``, then the env default reach the
  engine; ``TorchEngine`` admits by class rank, then deadline, then arrival
  in the order ``JaxEngine`` does (after
  ``test_mocker_priority_then_deadline_queue_order``).
"""

import asyncio
import json

from dynamo_tpu import qos as j_qos
from dynamo_tpu.disagg.router import DisaggConfig as JDisaggConfig
from dynamo_tpu.disagg.router import DisaggregatedRouter as JRouter
from dynamo_tpu.disagg.transfer import PrefillStreamCancelled as JPrefillStreamCancelled
from dynamo_tpu.fabric.client import FabricClient
from dynamo_tpu.pipeline.context import Context as JContext
from dynamo_tpu.protocols import common as jp
from dynamo_tpu_torch import qos
from dynamo_tpu_torch.disagg.protocols import PrefillStreamCancelled
from dynamo_tpu_torch.engine.echo import EchoEngineCore
from dynamo_tpu_torch.entrypoint.inputs import EngineConfig, run_http
from dynamo_tpu_torch.pipeline.context import Context, decisions_of
from dynamo_tpu_torch.protocols import common as tp
from tests.test_torch_disagg import _router
from tests.test_torch_engine import MAX_BATCH, make_jax_engine, make_torch_engine
from tests.test_torch_frontend import MODEL, afetch, sse, write_model_dir
from tests.test_torch_kv_router import slowed


def req(mod, prompt, max_tokens=8, priority=None, **sampling):
    pre = mod.PreprocessedRequest(
        token_ids=list(prompt),
        sampling=mod.SamplingOptions(**(sampling or {"greedy": True})),
        stop=mod.StopConditions(max_tokens=max_tokens, ignore_eos=True),
    )
    if priority is not None:
        pre.extra["priority"] = priority
    return pre


async def collect(engine, request, ctx, first=None):
    toks, final = [], None
    async for out in engine.generate(request, ctx):
        toks.extend(out.token_ids)
        if first is not None and toks:
            first.set()
        if out.finish_reason is not None:
            final = out
    return toks, final


def blocks_free(engine) -> bool:
    return engine.allocator.free_count == engine.config.num_blocks - 1


# ------------------------------------------------------------------ C6: engine


async def test_torch_deadline_structured_error_and_stats_as_the_jax_engine():
    finals = {}
    for name, engine, mod, ctx_cls in (("jax", make_jax_engine(), jp, JContext),
                                       ("port", make_torch_engine(), tp, Context)):
        ctx = ctx_cls(id="r-expired")
        ctx.set_deadline_ms(0.001)
        await asyncio.sleep(0.01)
        toks, final = await collect(engine, req(mod, [1, 2, 3]), ctx)
        assert toks == [] and final.finish_reason.value == "error"
        assert engine.stats.deadline_exceeded == 1
        # a live engine keeps serving after a shed
        live, _ = await collect(engine, req(mod, [4, 5, 6], max_tokens=3), ctx_cls())
        finals[name] = (final.error, live)
        await engine.close()
    assert finals["port"] == finals["jax"]
    assert finals["port"][0] == {"request_id": "r-expired", "phase": "admission",
                                 "cause": "deadline expired before admission",
                                 "code": "deadline_exceeded"}
    assert len(finals["port"][1]) == 3


ENGINES = (("jax", make_jax_engine, jp, JContext), ("port", make_torch_engine, tp, Context))


async def on_both(scenario, prepare=None):
    """``scenario(engine, mod, ctx_cls)`` on a JaxEngine and on a TorchEngine
    over the same weights, each warmed first (a JaxEngine's first
    dispatches compile), then set up by ``prepare(engine, mod)`` and slowed.
    Returns {engine: the scenario's outcome}."""
    out = {}
    for name, make, mod, ctx_cls in ENGINES:
        engine = make()
        try:
            await collect(engine, req(mod, [4, 5, 6, 7], max_tokens=3), ctx_cls())
            if prepare is not None:
                prepare(engine, mod)
            out[name] = await scenario(slowed(engine), mod, ctx_cls)
        finally:
            await engine.close()
    return out


def prefill_dispatches(engine) -> int:
    return sum(n for label, n in engine.dispatches.items() if label.startswith("prefill"))


async def test_deadline_expired_at_admission_and_ttft_budget():
    async def scenario(engine, mod, ctx_cls):
        errors = []
        for i, arm in enumerate(({"timeout_ms": 0.001}, {"timeout_ms": None, "ttft_ms": 0.001})):
            ctx = ctx_cls(id=f"adm-{i}")
            ctx.set_deadline_ms(arm["timeout_ms"], arm.get("ttft_ms"))
            await asyncio.sleep(0.01)
            toks, final = await collect(engine, req(mod, [1, 2, 3]), ctx)
            errors.append((toks, final.finish_reason.value, final.error))
        return errors, engine.stats.deadline_exceeded

    got = await on_both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"] == ([([], "error", {"request_id": f"adm-{i}", "phase": "admission",
                                           "cause": "deadline expired before admission",
                                           "code": "deadline_exceeded"}) for i in range(2)], 2)


async def test_deadline_while_queued_is_shed_before_its_prefill():
    """Every lane busy: a queued request whose deadline (or TTFT budget)
    lapses is shed from the queue, never prefilled; the same errors, counts
    and freed blocks from both engines."""

    async def scenario(engine, mod, ctx_cls):
        firsts = [asyncio.Event() for _ in range(engine.config.max_batch)]
        busy = [asyncio.ensure_future(collect(engine, req(mod, [7, i + 3], max_tokens=40), ctx_cls(),
                                              first=firsts[i]))
                for i in range(engine.config.max_batch)]
        # every one admitted and prefilled (a deadline would queue ahead of them)
        await asyncio.wait_for(asyncio.gather(*(f.wait() for f in firsts)), 30)
        prefills = prefill_dispatches(engine)
        shed = []
        for i, arm in enumerate(((0.15, None), (None, 0.15))):
            ctx = ctx_cls(id=f"queued-{i}")
            ctx.set_deadline_ms(arm[0] and arm[0] * 1e3, arm[1] and arm[1] * 1e3)
            shed.append((ctx, asyncio.ensure_future(collect(engine, req(mod, [9, 9, 9]), ctx))))
        errors = []
        for ctx, fut in shed:
            toks, final = await asyncio.wait_for(fut, 10)
            errors.append((toks, final.error, ctx.is_killed()))
        shed_stats = (engine.stats.deadline_exceeded, prefill_dispatches(engine) - prefills)
        lengths = [len((await fut)[0]) for fut in busy]
        return errors, shed_stats, lengths, blocks_free(engine)

    got = await on_both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"] == ([([], {"request_id": f"queued-{i}", "phase": "queue",
                                  "cause": "deadline exceeded while queued",
                                  "code": "deadline_exceeded"}, True) for i in range(2)],
                           (2, 0), [40] * MAX_BATCH, True)


async def test_deadline_mid_generation_frees_the_lane_and_blocks():
    async def scenario(engine, mod, ctx_cls):
        ctx = ctx_cls(id="mid")
        ctx.set_deadline_ms(150)
        toks, final = await asyncio.wait_for(collect(engine, req(mod, [1, 2, 3, 4], max_tokens=50), ctx), 10)
        await asyncio.sleep(0.05)
        return (final.finish_reason.value, final.error, 0 < len(toks) < 50, engine.stats.deadline_exceeded,
                ctx.is_killed(), all(s is None for s in engine.slots), blocks_free(engine))

    got = await on_both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"] == ("error", {"request_id": "mid", "phase": "decode",
                                     "cause": "deadline exceeded mid-generation",
                                     "code": "deadline_exceeded"}, True, 1, True, True, True)


async def test_deadline_awaiting_remote_prefill_holds_blocks_until_the_task_ends():
    class HangingClient:
        """A remote prefill that ends (cancelled) only after its request's
        context is killed and the test releases it."""

        def __init__(self, cancelled):
            self.cancelled, self.calls, self.release = cancelled, 0, asyncio.Event()

        async def prefill(self, token_ids, ctx=None, deadline=None, **kw):
            assert deadline == ctx.deadline
            self.calls += 1
            await ctx.killed()
            await self.release.wait()
            raise self.cancelled("cancelled")

    def prepare(engine, mod):
        if mod is tp:
            engine.disagg_router = _router(1)
            engine.remote_prefill_client = HangingClient(PrefillStreamCancelled)
        else:
            engine.disagg_router = JRouter(FabricClient.in_process(), "t", JDisaggConfig(
                max_local_prefill_length=1, max_prefill_queue_size=100))
            engine.remote_prefill_client = HangingClient(JPrefillStreamCancelled)

    async def scenario(engine, mod, ctx_cls):
        client = engine.remote_prefill_client
        ctx = ctx_cls(id="remote")
        ctx.set_deadline_ms(100)
        toks, final = await asyncio.wait_for(collect(engine, req(mod, list(range(2, 20))), ctx), 10)
        await asyncio.sleep(0.05)
        held = not blocks_free(engine)  # a late inject would land in them
        client.release.set()
        for _ in range(200):
            if blocks_free(engine):
                break
            await asyncio.sleep(0.01)
        if mod is tp:
            assert engine.stats.remote_prefills == 1
        return toks, final.error, client.calls, held, blocks_free(engine), engine.stats.deadline_exceeded

    got = await on_both(scenario, prepare)
    assert got["port"] == got["jax"]
    assert got["port"] == ([], {"request_id": "remote", "phase": "remote_prefill",
                                "cause": "deadline exceeded awaiting remote prefill",
                                "code": "deadline_exceeded"}, 1, True, True, 1)


# -------------------------------------------------------------------- C6: HTTP


async def test_http_deadline_streams_typed_error_and_504(tmp_path, monkeypatch):
    monkeypatch.delenv("DYN_DEFAULT_DEADLINE_MS", raising=False)
    from dynamo_tpu_torch.model_card import ModelDeploymentCard

    mdc = ModelDeploymentCard.from_model_dir(write_model_dir(tmp_path / "m"), "lifeguard-echo")
    service = await run_http(EngineConfig.static_(EchoEngineCore(), mdc), host="127.0.0.1", port=0)
    try:
        body = {"model": "lifeguard-echo", "messages": [{"role": "user", "content": " ".join(["w1"] * 40)}],
                "stream": True, "max_tokens": 40, "ext": {"timeout_ms": 80}}
        st, _, data = await afetch(service.port, "POST", "/v1/chat/completions", body)
        assert st == 200
        errors = [e.json()["error"] for e in sse(data) if e.event == "error"]
        assert errors and errors[-1]["type"] == "deadline_exceeded" and errors[-1]["request_id"]
        st, _, data = await afetch(service.port, "POST", "/v1/chat/completions", {**body, "stream": False})
        assert st == 504 and json.loads(data)["error"]["type"] == "deadline_exceeded"
        # DYN_DEFAULT_DEADLINE_MS arms the deadline of a request naming none
        monkeypatch.setenv("DYN_DEFAULT_DEADLINE_MS", "80")
        st, _, data = await afetch(service.port, "POST", "/v1/completions",
                                   {"model": "lifeguard-echo", "prompt": " ".join(["w2"] * 40),
                                    "max_tokens": 40})
        assert st == 504 and json.loads(data)["error"]["type"] == "deadline_exceeded"
        monkeypatch.delenv("DYN_DEFAULT_DEADLINE_MS")
        st, _, data = await afetch(service.port, "POST", "/v1/completions",
                                   {"model": "lifeguard-echo", "prompt": "w3 w4", "max_tokens": 2})
        assert st == 200
    finally:
        await service.close()


async def test_http_deadline_reaches_the_torch_engine(tmp_path):
    """Through the HTTP edge to a (slowed) TorchEngine: the engine sheds the
    stream mid-generation with the typed error, and counts it."""
    from dynamo_tpu_torch.model_card import ModelDeploymentCard

    mdc = ModelDeploymentCard.from_model_dir(write_model_dir(tmp_path / "m"), MODEL)
    engine = slowed(make_torch_engine())
    service = await run_http(EngineConfig.static_(engine, mdc), host="127.0.0.1", port=0)
    try:
        body = {"model": MODEL, "prompt": "one two three", "max_tokens": 40, "stream": True,
                "temperature": 0, "nvext": {"ignore_eos": True, "timeout_ms": 200}}
        st, _, data = await afetch(service.port, "POST", "/v1/completions", body)
        errors = [e.json()["error"] for e in sse(data) if e.event == "error"]
        assert st == 200 and errors[-1]["type"] == "deadline_exceeded"
        assert engine.stats.deadline_exceeded == 1
        await asyncio.sleep(0.05)
        assert blocks_free(engine)
    finally:
        await service.close()
        await engine.close()


# ---------------------------------------------------------------- C7: classes


def test_priority_resolution_precedence(monkeypatch):
    monkeypatch.delenv("DYN_PRIORITY_DEFAULT", raising=False)
    assert qos.resolve_priority() == "standard"
    assert qos.normalize_priority("BATCH") == "bulk"
    assert qos.normalize_priority(0) == "interactive"
    assert qos.normalize_priority("frobnicate") is None
    monkeypatch.setenv("DYN_PRIORITY_DEFAULT", "bulk")
    assert qos.resolve_priority() == "bulk"
    assert qos.resolve_priority(ext_value="standard") == "standard"
    assert qos.resolve_priority(header="interactive", ext_value="bulk") == "interactive"
    monkeypatch.setenv("DYN_PRIORITY_DEFAULT", "evals-8b=bulk, chat-70b=interactive, standard")
    assert qos.default_priority("evals-8b") == "bulk"
    assert qos.default_priority("chat-70b") == "interactive"
    assert qos.default_priority("other") == "standard"
    ctx = Context()
    pre = req(tp, [1, 2, 3], priority="batch")
    assert qos.stamp_priority(pre, ctx) == "bulk"
    assert ctx.metadata["priority"] == "bulk" and pre.extra["priority"] == "bulk"
    ctx2 = Context(metadata={"priority": "interactive"})
    pre2 = req(tp, [1], priority="bulk")
    assert qos.stamp_priority(pre2, ctx2) == "interactive"
    assert pre2.extra["priority"] == "interactive"
    # every spelling and every env form resolves as the reference's
    for header in (None, "HIGH", "low", "2", "x"):
        for ext in (None, "normal", 0, "batch"):
            for model in (None, "evals-8b", "other"):
                assert qos.resolve_priority(header, ext, model) == j_qos.resolve_priority(header, ext, model)
                assert qos.priority_source(header, ext) == j_qos.priority_source(header, ext)
    assert decisions_of(None).priority is None


def test_drain_rate_estimator():
    est = qos.DrainRateEstimator(window_s=10.0)
    assert est.retry_after_s(4, fallback_s=1.5, now=100.0) == 1.5
    for i in range(21):
        est.note(now=90.0 + 0.5 * i)
    r = est.rate(now=100.0)
    assert r is not None and 1.8 < r < 2.3
    assert 2.4 < est.retry_after_s(6, fallback_s=1.0, now=100.0) < 3.5
    assert est.retry_after_s(6, fallback_s=1.0, now=500.0) == 1.0


class Capturing:
    """Delegates to an engine, keeping each request's class as it arrives."""

    def __init__(self, engine):
        self.engine, self.seen = engine, []

    def generate(self, request, context):
        self.seen.append((decisions_of(context).priority, request.extra.get("priority")))
        return self.engine.generate(request, context)


async def test_http_priority_header_then_ext_then_env_default(tmp_path, monkeypatch):
    from dynamo_tpu_torch.model_card import ModelDeploymentCard

    monkeypatch.setenv("DYN_PRIORITY_DEFAULT", f"{MODEL}=bulk,standard")
    mdc = ModelDeploymentCard.from_model_dir(write_model_dir(tmp_path / "m"), MODEL)
    engine = Capturing(EchoEngineCore())
    service = await run_http(EngineConfig.static_(engine, mdc), host="127.0.0.1", port=0)
    try:
        body = {"model": MODEL, "prompt": "one two", "max_tokens": 2}
        for headers, ext in (({"x-dyn-priority": "interactive"}, {"priority": "bulk"}),
                             ({}, {"priority": "high"}), ({}, None), ({"x-dyn-priority": "?"}, None)):
            b = {**body, "ext": ext} if ext else body
            st, _, _ = await afetch(service.port, "POST", "/v1/completions", b, headers=headers)
            assert st == 200
        assert engine.seen == [("interactive", "interactive"), ("interactive", "interactive"),
                               ("bulk", "bulk"), ("bulk", "bulk")]
    finally:
        await service.close()


async def test_torch_engine_admits_by_class_then_deadline_then_arrival():
    """One lane held: a later interactive request overtakes queued bulk
    work; within a class the tighter deadline goes first; bulk last. The
    same order from TorchEngine and JaxEngine."""

    def one_lane(engine, mod):
        engine.config.max_batch = 1
        engine.slots = engine.slots[:1]

    async def scenario(engine, mod, ctx_cls):
        order: list[str] = []

        async def run(name, request, ctx=None):
            await collect(engine, request, ctx or ctx_cls())
            order.append(name)

        first = asyncio.ensure_future(run("warm", req(mod, [5, 6, 7], max_tokens=20)))
        await asyncio.sleep(0.05)
        std_tight = ctx_cls()
        std_tight.set_deadline_ms(60_000)
        futs = []
        for name, request, ctx in (("bulk", req(mod, [1, 2], 2, priority="bulk"), None),
                                   ("std-loose", req(mod, [3, 4], 2, priority="standard"), None),
                                   ("std-tight", req(mod, [3, 9], 2, priority="standard"), std_tight),
                                   ("default", req(mod, [3, 8], 2), None),
                                   ("interactive", req(mod, [8, 9], 2, priority="interactive"), None)):
            futs.append(asyncio.ensure_future(run(name, request, ctx)))
            await asyncio.sleep(0.005)
        await asyncio.wait_for(asyncio.gather(first, *futs), 30)
        return order

    got = await on_both(scenario, one_lane)
    assert got["port"] == got["jax"]
    assert got["port"] == ["warm", "interactive", "std-tight", "std-loose", "default", "bulk"]
