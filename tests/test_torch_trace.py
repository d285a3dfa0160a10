"""The port's request tracing (``dynamo_tpu_torch/telemetry/trace.py``)
against the JAX package's, on the CPU, and the twins of the seed's
``tests/test_telemetry.py`` that need no SLO plane, logging module or mocker.

- Spans exported by either package ingest into the other (the same dict:
  keys, 32-hex trace ids, 16-hex span ids), and ``chrome_trace`` and
  ``breakdown`` of the same spans are equal.
- For tiny-model f32 greedy requests the span tree through ``TorchEngine``
  equals the one through ``JaxEngine`` (names, parentage, attributes and
  events; times left out): chunked admission with packed and mixed steps, a
  preemption, deadline sheds while queued and mid-decode, and a colocated
  remote prefill.
- ``DYN_TRACE=auto`` sets the same flags as the JAX package's, and the
  disabled ``span()`` costs a flag check (the reference's
  ``test_disabled_overhead_guard``).
- Twins of the core cases, of the one-trace-across-processes disagg case
  (on ``TorchEngine`` prefill and decode workers over the fabric, through
  the port's HTTP frontend), the migration replay, the debug endpoint, the
  pipeline's prompt close and the standalone router's reply span.
"""

import asyncio
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dynamo_tpu.disagg.colocated import ColocatedPrefillClient as JColocated
from dynamo_tpu.engine.jax_engine.engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.engine.jax_engine.model_runner import ModelRunner
from dynamo_tpu.models import llama as jl
from dynamo_tpu.pipeline.context import Context as JaxContext
from dynamo_tpu.protocols import common as jp
from dynamo_tpu.telemetry import trace as jtrace
from dynamo_tpu_torch.disagg.colocated import ColocatedPrefillClient
from dynamo_tpu_torch.disagg.router import DisaggConfig, DisaggregatedRouter
from dynamo_tpu_torch.disagg.transfer import PrefillWorkerService, RemotePrefillClient
from dynamo_tpu_torch.discovery import register_llm
from dynamo_tpu_torch.engine.echo import EchoEngineCore
from dynamo_tpu_torch.engine.torch_engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.engine.torch_engine.model_runner import TorchModelRunner
from dynamo_tpu_torch.engine.torch_engine.weights import params_from_jax
from dynamo_tpu_torch.entrypoint.inputs import EngineConfig, make_engine_handler, run_http
from dynamo_tpu_torch.fabric.client import FabricClient
from dynamo_tpu_torch.fabric.state import FabricState
from dynamo_tpu_torch.http.service import ModelExecution
from dynamo_tpu_torch.model_card import ModelDeploymentCard
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.pipeline.router import RouterMode
from dynamo_tpu_torch.protocols import common as tp
from dynamo_tpu_torch.protocols.openai import CompletionRequest
from dynamo_tpu_torch.router import StandaloneRouter
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.telemetry import trace as dtrace
from dynamo_tpu_torch.telemetry.trace import NULL_CM, NULL_SPAN
from tests.test_torch_frontend import afetch, model_dir, sse  # noqa: F401 (fixture)

BS, VOCAB = 4, 64


@pytest.fixture
def traced():
    """Tracing on in both packages with fresh rings; off again after."""
    dtrace.set_enabled(True)
    dtrace.reset(proc="frontend")
    jtrace.set_enabled(True)
    jtrace.reset(proc="frontend")
    yield
    dtrace.set_enabled(False)
    dtrace.reset()
    jtrace.set_enabled(False)
    jtrace.reset()


# -------------------------------------------------------------------- core


def test_span_identity_parenting_and_events(traced):
    ctx = tp.Context()
    with dtrace.root_span("http_request", ctx, request_id=ctx.id) as root:
        assert len(root.trace_id) == 32 and len(root.span_id) == 16
        with dtrace.span("route", ctx=ctx) as route:
            assert route.trace_id == root.trace_id and route.parent_id == root.span_id
            route.set(worker="ab")
        dtrace.event("migration", cause="test")
    spans = dtrace.spans_for_trace(root.trace_id)
    assert {s.name for s in spans} == {"http_request", "route"}
    got_root = [s for s in spans if s.name == "http_request"][0]
    assert got_root.parent_id is None
    assert [e["name"] for e in got_root.events] == ["migration"]
    assert dtrace.trace_for_request(ctx.id) == root.trace_id
    assert all(s.dur_ns >= 0 and s.end_ns is not None for s in spans)


def test_traceparent_roundtrip_and_rejects():
    tid, sid = "0af7651916cd43dd8448eb211c80319c", "b7ad6b7169203331"
    header = dtrace.format_traceparent(tid, sid)
    assert header == jtrace.format_traceparent(tid, sid)
    for h in (header, "garbage", "00-" + "0" * 32 + "-" + sid + "-01", "00-abc-def-01",
              " 00-" + tid.upper() + "-" + sid + "-00 ", None):
        assert dtrace.parse_traceparent(h) == jtrace.parse_traceparent(h)
    assert dtrace.parse_traceparent(header) == (tid, sid)


def test_disabled_mode_shared_noop_and_fast(traced):
    dtrace.set_enabled(False)
    cm = dtrace.span("x", ctx=tp.Context())
    assert cm is NULL_CM and dtrace.span("y") is NULL_CM
    assert dtrace.root_span("r", tp.Context()) is NULL_CM
    assert dtrace.begin("b", ctx=tp.Context()) is None
    assert dtrace.wire_span("w") is NULL_CM and dtrace.span_from_wire("f", {"tid": "a"}) is NULL_CM
    with cm as sp:
        assert sp is NULL_SPAN
        sp.set(a=1)
        sp.event("e")
    assert dtrace.tracer().ring_len() == 0
    t0 = time.monotonic()
    for _ in range(100_000):
        with dtrace.span("hot"):
            pass
    assert time.monotonic() - t0 < 1.0


def test_disabled_overhead_guard():
    """The DYN_TRACE=0 fast path stays near free: each disabled call is a
    flag check and a shared singleton, bounded loosely (2 us an op, as the
    reference's guard) so only a real regression (an allocation, a clock
    read, a lock per call) trips it."""
    assert not dtrace.enabled()
    ctx = tp.Context()
    calls = {
        "span": lambda: dtrace.span("hot", ctx=ctx),
        "enabled": dtrace.enabled,
        "event": lambda: dtrace.event("e", a=1),
        "begin": lambda: dtrace.begin("b", ctx=ctx),
        "wire_span": lambda: dtrace.wire_span("w"),
    }
    n = 50_000
    for name, fn in calls.items():
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        per_op = (time.perf_counter_ns() - t0) / n
        assert per_op < 2000, f"disabled {name}() costs {per_op:.0f} ns/op"


def test_dyn_trace_auto_is_refused_naming_the_roadmap_item(traced):
    # auto is no longer refused (the SLO plane decides retention): every
    # mode sets the same (enabled, auto) flags as the JAX package's
    from dynamo_tpu.telemetry import trace as jtrace

    for mode in ("auto", "0", "1", "AUTO", "on", "auto"):
        dtrace.set_mode(mode)
        jtrace.set_mode(mode)
        assert (dtrace.enabled(), dtrace.auto()) == (jtrace.enabled(), jtrace.auto())
    assert dtrace.enabled() and dtrace.auto()
    dtrace.set_enabled(True)
    assert dtrace.enabled() and not dtrace.auto()
    jtrace.set_mode("0")


def test_phase_spans_without_trace_context_are_noops(traced):
    assert dtrace.span("orphan") is NULL_CM
    assert dtrace.wire_span("orphan") is NULL_CM
    assert dtrace.tracer().ring_len() == 0


def test_ring_buffer_bounded_under_churn(traced):
    dtrace.reset(proc="t", ring=64)
    ctx = tp.Context()
    with dtrace.root_span("root", ctx):
        for i in range(1000):
            with dtrace.span(f"phase{i % 7}", ctx=ctx):
                pass
    assert dtrace.tracer().ring_len() <= 64
    for i in range(1500):
        dtrace.tracer().remember_request(f"r{i}", "t" * 32)
    assert len(dtrace.tracer()._requests) <= 1024


def test_ring_and_track_come_from_the_environment(monkeypatch):
    monkeypatch.setenv("DYN_TRACE_RING", "20")
    monkeypatch.setenv("DYN_TRACE_PROC", "decode-7")
    t = dtrace.Tracer()
    assert t.proc == "decode-7" and t._ring.maxlen == 20
    monkeypatch.setenv("DYN_TRACE_RING", "junk")
    assert dtrace.Tracer()._ring.maxlen == 4096


def test_ingest_dedupes_and_survives_garbage(traced):
    ctx = tp.Context()
    with dtrace.root_span("root", ctx) as root:
        pass
    wire = dtrace.export_for_trace(root.trace_id)
    assert len(wire) == 1 and dtrace.ingest(wire) == 0  # same span_id: deduped
    foreign = dict(wire[0], span_id="f" * 16, proc="worker-x")
    assert dtrace.ingest([foreign, {"bad": True}, "not-a-dict"]) == 1
    spans = dtrace.spans_for_trace(root.trace_id)
    assert len(spans) == 2 and any(s.remote and s.proc == "worker-x" for s in spans)
    assert len(dtrace.export_for_trace(root.trace_id, include_remote=False)) == 1


def test_chrome_trace_export_shape(traced, tmp_path, monkeypatch):
    ctx = tp.Context()
    with dtrace.root_span("http_request", ctx, request_id=ctx.id):
        with dtrace.span("decode", ctx=ctx) as sp:
            sp.event("deadline_exceeded", phase="decode")
        dtrace.counter("step_ms", 3.5)
    tid = dtrace.trace_for_request(ctx.id)
    doc = dtrace.chrome_trace(tid)
    json.dumps(doc)
    evs = doc["traceEvents"]
    assert any(e["ph"] == "M" and e["name"] == "process_name" for e in evs)
    slices = [e for e in evs if e["ph"] == "X"]
    assert {e["name"] for e in slices} == {"http_request", "decode"}
    assert all("ts" in e and e["dur"] > 0 for e in slices)
    assert any(e["ph"] == "i" and e["name"] == "deadline_exceeded" for e in evs)
    assert any(e["ph"] == "C" and e["name"] == "step_ms" for e in evs)
    bd = dtrace.breakdown(tid)
    assert bd["spans"] == 2 and "decode" in bd["phases"]
    assert dtrace.maybe_write_trace(tid, "r/../x") is None  # DYN_TRACE_DIR unset
    monkeypatch.setenv("DYN_TRACE_DIR", str(tmp_path))
    path = dtrace.maybe_write_trace(tid, "r/../x")
    assert os.path.dirname(path) == str(tmp_path)
    assert json.load(open(path))["otherData"]["trace_id"] == tid


# ---------------------------------------------------------------- interop


def _one_trace(mod, ctx):
    """A root, a phase span with an event, a wire span and a manual span."""
    with mod.root_span("http_request", ctx, request_id=ctx.id, proc="frontend") as root:
        with mod.span("route", ctx=ctx, tokens=3) as r:
            r.event("pick", worker="ab")
            with mod.wire_span("fabric:publish", nbytes=9):
                pass
        sp = mod.begin("queue_wait", ctx=ctx, proc="worker:1", tokens=3)
        sp.event("deadline_exceeded", phase="queue")
        mod.finish(sp, shed=True)
    return root.trace_id


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_spans_of_either_package_ingest_into_the_other(traced, direction):
    src, dst, ctx = ((dtrace, jtrace, tp.Context()) if direction == "port_to_reference"
                     else (jtrace, dtrace, JaxContext()))
    tid = _one_trace(src, ctx)
    wire = src.export_for_trace(tid)
    assert len(tid) == 32 and all(len(d["span_id"]) == 16 for d in wire)
    other = _one_trace(dst, tp.Context() if dst is dtrace else JaxContext())
    assert sorted(wire[0]) == sorted(dst.export_for_trace(other)[0])  # the same dict's keys
    assert dst.ingest(wire) == len(wire) == 4
    back = dst.export_for_trace(tid)
    assert sorted(back, key=lambda d: d["span_id"]) == sorted(wire, key=lambda d: d["span_id"])


def test_chrome_trace_and_breakdown_of_the_same_spans_are_equal(traced):
    tid = _one_trace(jtrace, JaxContext())
    wire = jtrace.export_for_trace(tid)
    dtrace.reset(proc="x")
    jtrace.reset(proc="x")
    assert dtrace.ingest(wire) == jtrace.ingest(wire) == 4
    assert dtrace.chrome_trace(tid) == jtrace.chrome_trace(tid)
    assert dtrace.breakdown(tid) == jtrace.breakdown(tid)
    assert dtrace.breakdown(None) == jtrace.breakdown(None) == {}


# ---------------------------------------------------------- engine trees


def _tree(mod, tid):
    """Each span as (its names up to the root, proc, attrs, events without
    times), sorted: the span tree with no ids and no times (request ids are
    random)."""
    spans = mod.spans_for_trace(tid)
    by_id = {s.span_id: s for s in spans}

    def path(s):
        names = []
        while s is not None:
            names.append(s.name)
            s = by_id.get(s.parent_id)
        return tuple(reversed(names))

    out = []
    for s in spans:
        evs = [(e["name"], sorted((e.get("attrs") or {}).items())) for e in s.events]
        attrs = sorted((k, v) for k, v in s.attrs.items() if k not in ("error", "request_id"))
        out.append((path(s), s.proc, attrs, evs))
    return sorted(out, key=repr)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jl.LlamaConfig.tiny(vocab_size=VOCAB)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return jcfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _engines(tiny, *, chunk=0, nb=64, max_batch=4, max_len=64, max_preemptions=8,
             watermark=2, **kw):
    jcfg, jparams, tparams = tiny
    dims = dict(num_blocks=nb, block_size=BS, max_batch=max_batch, max_model_len=max_len)
    ecfg = dict(dims, watermark_blocks=watermark, max_preemptions=max_preemptions,
                preempt_backoff_ms=0.0)
    jeng = JaxEngine(ModelRunner(jcfg, jparams, kv_dtype=jnp.float32, prefill_chunk_tokens=chunk,
                                 **dims), JaxEngineConfig(**ecfg), **kw.get("jax", {}))
    teng = TorchEngine(TorchModelRunner(tl.LlamaConfig.tiny(vocab_size=VOCAB), tparams,
                                        device="cpu", prefill_chunk_tokens=chunk, **dims),
                       TorchEngineConfig(**ecfg), **kw.get("torch", {}))
    jeng.trace_proc = teng.trace_proc = "worker:1"
    return jeng, teng


async def _traced_stream(engine, prompt, max_tokens, on_first=None):
    """One greedy request under its own root span; (tokens, final code,
    trace id)."""
    mod, ctx_cls, tr = ((tp, tp.Context, dtrace) if isinstance(engine, TorchEngine)
                        else (jp, JaxContext, jtrace))
    ctx = ctx_cls()
    toks, code = [], None
    with tr.root_span("request", ctx, request_id=ctx.id, proc="frontend") as root:
        async for out in engine.generate(mod.PreprocessedRequest(
                token_ids=list(prompt), sampling=mod.SamplingOptions(greedy=True),
                stop=mod.StopConditions(max_tokens=max_tokens, ignore_eos=True)), ctx):
            toks.extend(out.token_ids)
            if on_first is not None and toks:
                on_first(ctx)
                on_first = None
            if out.finish_reason is not None:
                code = (out.finish_reason.value, (out.error or {}).get("code"))
    return toks, code, root.trace_id


async def _trees(jeng, teng, scenario):
    got = {}
    for name, eng, tr in (("jax", jeng, jtrace), ("torch", teng, dtrace)):
        results = await scenario(eng)
        await eng.close()
        got[name] = [(toks, code, _tree(tr, tid)) for toks, code, tid in results]
    return got


def _names(tree):
    return {path[-1] for path, *_ in tree}


async def test_span_trees_equal_the_jax_engines_with_chunked_admission(traced, tiny):
    """Two prompts chunked (8-token chunks, mixed steps beside the decode
    lanes) and two packed into one prefill, all arriving together."""
    jeng, teng = _engines(tiny, chunk=8)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, VOCAB, 30).tolist(), rng.integers(1, VOCAB, 21).tolist(),
               [1, 2, 3], [9, 8, 7, 6, 5]]

    async def scenario(eng):
        return await asyncio.gather(*(_traced_stream(eng, p, n) for p, n in
                                      zip(prompts, (12, 6, 9, 7))))

    got = await _trees(jeng, teng, scenario)
    assert got["torch"] == got["jax"]
    trees = [t for *_, t in got["torch"]]
    assert {"queue_wait", "prefill", "decode"} <= _names(trees[0])
    chunk_events = [e for path, _, _, evs in trees[0] if path[-1] == "prefill" for e, _ in evs]
    assert chunk_events.count("prefill_chunk") == 4
    assert teng.stats.mixed_steps > 0 and teng.stats.packed_prefills > 0


async def test_span_trees_equal_the_jax_engines_through_a_preemption(traced, tiny):
    """The storm guard's scenario (13 usable blocks, four growing lanes):
    preempted sequences close their spans with ``preempted`` and queue again
    (``resumed``); one preempted past the limit ends with
    ``preempted_too_often`` and an ``error`` event."""
    jeng, teng = _engines(tiny, nb=14, max_preemptions=1, watermark=0)
    prompts = [[5, 9, 17, 23, 2, 40], [1, 2, 3], [33, 3, 41, 14, 8, 8], [42] * 6]

    async def scenario(eng):
        return await asyncio.gather(*(_traced_stream(eng, p, 30) for p in prompts))

    got = await _trees(jeng, teng, scenario)
    assert got["torch"] == got["jax"]
    events = {e for *_, t in got["torch"] for *_, evs in t for e, _ in evs}
    assert {"preempted", "preempted_too_often", "error", "decode_step"} <= events
    resumed = [a for *_, t in got["torch"] for path, _, a, _ in t
               if path[-1] == "queue_wait" and ("resumed", True) in a]
    assert resumed and teng.stats.preemptions > 0


async def test_span_trees_equal_the_jax_engines_for_deadline_sheds(traced, tiny):
    """One lane: a request queued behind it passes its deadline (shed while
    queued), then a lone request passes its deadline after its first token
    (shed mid-decode; its per-dispatch events depend on timing and are left
    out)."""
    jeng, teng = _engines(tiny, max_batch=1)

    def expire(ctx):
        ctx.deadline = time.time() - 1.0

    async def scenario(eng):
        ctx_box = {}
        started = asyncio.Event()

        def first(ctx):
            started.set()

        a = asyncio.create_task(_traced_stream(eng, [5, 6, 7, 8], 24, on_first=first))
        await started.wait()
        mod, ctx_cls, tr = ((tp, tp.Context, dtrace) if isinstance(eng, TorchEngine)
                            else (jp, JaxContext, jtrace))
        ctx = ctx_cls()
        with tr.root_span("request", ctx, request_id=ctx.id, proc="frontend") as root:
            agen = eng.generate(mod.PreprocessedRequest(
                token_ids=[3, 4], sampling=mod.SamplingOptions(greedy=True),
                stop=mod.StopConditions(max_tokens=4, ignore_eos=True)), ctx)
            pending = asyncio.ensure_future(anext(agen))
            await asyncio.sleep(0.01)
            expire(ctx)  # still queued behind the running lane
            out = await pending
            await agen.aclose()
        ctx_box["b"] = ([], (out.finish_reason.value, out.error["code"]), root.trace_id)
        ra = await a
        rc = await _traced_stream(eng, [11, 12, 13], 40, on_first=expire)
        return [ra, ctx_box["b"], rc]

    got = await _trees(jeng, teng, scenario)

    def drop_steps(results):
        return [(code, [(p, pr, a, [e for e in evs if e[0] != "decode_step"])
                        for p, pr, a, evs in tree]) for _, code, tree in results]

    assert got["torch"][:2] == got["jax"][:2]
    assert drop_steps(got["torch"]) == drop_steps(got["jax"])
    (_, qcode, qtree), (_, dcode, dtree) = got["torch"][1], got["torch"][2]
    assert qcode == dcode == ("error", "deadline_exceeded")
    assert [evs for path, _, _, evs in qtree if path[-1] == "queue_wait"] == [
        [("deadline_exceeded", [("phase", "queue")])]]
    decode_evs = [e for path, _, _, evs in dtree if path[-1] == "decode" for e, _ in evs]
    assert decode_evs[-2:] == ["deadline_exceeded", "error"]


class _JaxColocated(JColocated):
    """The reference's colocated client under the keyword surface its engine
    calls with (the reference's own takes the first-token keywords only),
    its device response given the two fields the engine reads of every
    response (``code``, ``streamed_blocks``)."""

    async def prefill(self, token_ids, **kw):
        keep = ("temperature", "top_p", "top_k", "cached_blocks", "rep_pen", "key_data",
                "eos_ids", "eos_suppress")
        resp = await super().prefill(token_ids, **{k: kw[k] for k in keep if k in kw})
        resp.code, resp.streamed_blocks = None, 0
        return resp


async def test_span_trees_equal_the_jax_engines_with_a_colocated_remote_prefill(traced, tiny):
    jpre, tpre = _engines(tiny)
    router = dict(max_local_prefill_length=4, max_prefill_queue_size=100)
    from dynamo_tpu.disagg.router import DisaggConfig as JDisaggConfig
    from dynamo_tpu.disagg.router import DisaggregatedRouter as JRouter

    jeng, teng = _engines(tiny, jax=dict(
        disagg_router=JRouter(FabricClient.in_process(), "t", JDisaggConfig(**router)),
        remote_prefill_client=_JaxColocated(jpre, BS)), torch=dict(
        disagg_router=DisaggregatedRouter(DisaggConfig(**router)),
        remote_prefill_client=ColocatedPrefillClient(tpre, BS)))

    async def scenario(eng):
        # one after the other: when a shipped prompt lands beside a running
        # lane depends on the clock
        return [await _traced_stream(eng, p, 6) for p in ([2, 3, 4, 5, 6, 7, 8, 9, 10], [1, 2, 3])]

    got = await _trees(jeng, teng, scenario)
    await jpre.close()
    await tpre.close()
    assert got["torch"] == got["jax"]
    remote = [a for path, _, a, _ in got["torch"][0][2] if path[-1] == "remote_prefill"]
    assert remote and ("fallback_local", False) in remote[0]
    assert teng.stats.remote_prefills == 1 and teng.stats.remote_fallbacks == 0
    assert "remote_prefill" not in _names(got["torch"][1][2])  # the short one stays local


async def test_disabled_tracing_records_nothing_through_the_engine(tiny):
    assert not dtrace.enabled()
    dtrace.reset()
    _, teng = _engines(tiny)
    toks, code, tid = await _traced_stream(teng, list(range(2, 14)), 4)
    await teng.close()
    assert len(toks) == 4 and tid == "" and dtrace.tracer().ring_len() == 0


# ------------------------------------------------------------ end to end


def _card(model_dir, name):
    return ModelDeploymentCard.from_model_dir(model_dir, name)


def _tiny128(chunk):
    jcfg = jl.LlamaConfig.tiny(vocab_size=128)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    dims = dict(num_blocks=64, block_size=BS, max_batch=4, max_model_len=64)
    runner = TorchModelRunner(tl.LlamaConfig.tiny(vocab_size=128),
                              params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"),
                              device="cpu", prefill_chunk_tokens=chunk, **dims)
    return TorchEngine(runner, TorchEngineConfig(**dims, watermark_blocks=2))


async def test_disagg_request_is_one_trace_over_three_tracks(traced, model_dir, tmp_path,
                                                             monkeypatch):
    """test_telemetry.py:210 on the port: one streamed request through the
    HTTP frontend to a decode TorchEngine whose prefill a PrefillWorkerService
    streams over the fabric yields one trace (the inbound traceparent's)
    with the decode and prefill workers' tracks, valid Chrome JSON from
    /debug/traces, the breakdown on the final SSE usage chunk and a file in
    DYN_TRACE_DIR."""
    monkeypatch.setenv("DYN_TRACE_DIR", str(tmp_path))
    fabric = FabricClient.in_process(FabricState())
    prefill, decode = _tiny128(8), _tiny128(8)
    prefill.trace_proc, decode.trace_proc = "prefill-0", "decode-0"
    service = PrefillWorkerService(fabric, "tele", prefill)
    client = RemotePrefillClient(fabric, "tele", block_size=BS)
    decode.disagg_router = DisaggregatedRouter(DisaggConfig(max_local_prefill_length=8,
                                                            max_prefill_queue_size=100))
    decode.remote_prefill_client = client
    await service.start()
    await client.start()
    http = await run_http(EngineConfig.static_(decode, _card(model_dir, "tele")),
                          host="127.0.0.1", port=0)
    tid = "0af7651916cd43dd8448eb211c80319c"
    try:
        words = " ".join(["the quick brown fox jumps over the lazy dog"] * 4)
        st, headers, data = await afetch(http.port, "POST", "/v1/completions", {
            "model": "tele", "prompt": words, "stream": True, "max_tokens": 6,
            "stream_options": {"include_usage": True}},
            headers={"x-request-id": "trace me/../weird#id",
                     "traceparent": f"00-{tid}-b7ad6b7169203331-01"})
        assert st == 200
        rid = headers["x-request-id"]
        assert rid == "trace-me-..-weird-id" and headers["x-dyn-trace-id"] == tid
        usage = [e.json()["usage"] for e in sse(data) if e.event is None and e.json().get("usage")]
        phases = usage[-1]["timing"]["phases"]
        for want in ("queue_wait", "remote_prefill", "decode", "prefill_serve", "kv_land",
                     "kv_frame_tx"):
            assert want in phases, (want, sorted(phases))
        st, _, body = await afetch(http.port, "GET", f"/debug/traces/{rid}")
        assert st == 200
        doc = json.loads(body)
    finally:
        await http.close()
        await decode.close()
        await prefill.close()
        await client.close()
        await service.close()
        await fabric.close()
    assert doc["otherData"]["trace_id"] == tid and not doc["otherData"]["partial"]
    slices = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(slices) >= 8, [e["name"] for e in slices]
    procs = {e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert {"frontend", "decode-0", "prefill-0"} <= procs
    spans = {s.span_id: s for s in dtrace.spans_for_trace(tid)}
    assert all(s.parent_id in spans for s in spans.values() if s.name != "http_request")
    by_name = {}
    for s in spans.values():
        by_name.setdefault(s.name, s)
    assert (by_name["http_request"].start_unix_ns <= by_name["remote_prefill"].start_unix_ns
            <= by_name["decode"].start_unix_ns)
    assert spans[by_name["prefill_serve"].parent_id].name == "remote_prefill"
    qw = by_name["queue_wait"]
    assert qw.start_ns + qw.dur_ns <= by_name["decode"].start_ns
    files = list(tmp_path.glob("trace-*.json"))
    assert files and json.loads(files[0].read_text())["traceEvents"]


async def test_migration_replay_is_one_trace(traced, model_dir):
    """test_telemetry.py:311: a stream surviving a mid-stream worker death
    is one trace: a dispatch span per attempt under the same root, worker
    spans from both workers' tracks, and a ``migration`` event."""

    class DyingEngine:
        def __init__(self, die_after=3):
            self.inner = EchoEngineCore()
            self.die_after = die_after

        async def generate(self, request, context):
            n = 0
            async for out in self.inner.generate(request, context):
                if out.finish_reason is None and n >= self.die_after:
                    raise ConnectionResetError("worker died mid-stream")
                yield out
                n += 1

    worker_a = await DistributedRuntime.detached()
    worker_b = await DistributedRuntime.detached()
    front = await DistributedRuntime.detached()
    http = None
    try:
        card = _card(model_dir, "tele-mig")
        for drt, engine, label in ((worker_a, DyingEngine(), "worker-a"),
                                   (worker_b, EchoEngineCore(), "worker-b")):
            ep = drt.namespace("tm").component("worker").endpoint("generate")
            await ep.serve_endpoint(make_engine_handler(engine, label))
            await register_llm(drt, ep, card)
        http = await run_http(EngineConfig.dynamic(RouterMode.ROUND_ROBIN), host="127.0.0.1",
                              port=0, drt=front)
        for _ in range(100):
            st, _, body = await afetch(http.port, "GET", "/v1/models")
            if json.loads(body)["data"]:
                break
            await asyncio.sleep(0.1)
        words = "the quick brown fox jumps over lazy dog one two"
        for rid in ("mig-0", "mig-1"):  # round robin: one lands on the dying worker
            st, _, data = await afetch(http.port, "POST", "/v1/completions", {
                "model": "tele-mig", "prompt": words, "stream": True, "max_tokens": 10},
                headers={"x-request-id": rid})
            assert st == 200 and not [e for e in sse(data) if e.event == "error"]
    finally:
        if http is not None:
            await http.close()
            await http.watcher.stop()
        for drt in (front, worker_a, worker_b):
            await drt.close()
    migrated = None
    for rid in ("mig-0", "mig-1"):
        spans = dtrace.spans_for_trace(dtrace.trace_for_request(rid))
        dispatches = sorted((s for s in spans if s.name == "dispatch"),
                            key=lambda s: s.attrs.get("attempt", 0))
        if len(dispatches) >= 2:
            migrated = (spans, dispatches)
    assert migrated is not None, "no request migrated"
    spans, dispatches = migrated
    assert len({s.trace_id for s in spans}) == 1
    root = [s for s in spans if s.name == "http_request"]
    assert len(root) == 1
    assert all(d.parent_id == root[0].span_id for d in dispatches)
    assert [d.attrs["attempt"] for d in dispatches[:2]] == [1, 2]
    assert dispatches[1].attrs["replayed_tokens"] >= 1
    assert {"worker-a", "worker-b"} <= {s.proc for s in spans if s.name == "worker_generate"}
    assert "migration" in [e["name"] for e in root[0].events]


async def test_pipeline_closes_the_engine_generator_promptly(traced, model_dir):
    """test_telemetry.py:408: when the decoder ends a stream (max_tokens
    counted at the frontend) the pipeline closes the engine generator at
    once, not at garbage collection."""
    closed = asyncio.Event()

    async def engine_fn(req, ctx):
        try:
            for t in req.token_ids:
                yield tp.LLMEngineOutput(token_ids=[t])
        finally:
            closed.set()

    execution = ModelExecution(_card(model_dir, "close-t"), engine_fn)
    req = CompletionRequest.from_dict({"model": "close-t", "prompt": "one two three four five six",
                                       "stream": True, "max_tokens": 2})
    async for _ in execution.completion_stream(req, tp.Context()):
        pass
    assert closed.is_set()


async def test_debug_trace_endpoint_disabled_and_missing(traced, model_dir):
    http = await run_http(EngineConfig.static_(EchoEngineCore(), _card(model_dir, "tele-404")),
                          host="127.0.0.1", port=0)
    try:
        st, _, body = await afetch(http.port, "GET", "/debug/traces/nope")
        assert st == 404 and "no trace" in json.loads(body)["error"]["message"]
        dtrace.set_enabled(False)
        st, _, body = await afetch(http.port, "GET", "/debug/traces/nope")
        assert st == 404 and "disabled" in json.loads(body)["error"]["message"]
    finally:
        await http.close()


async def test_standalone_router_ships_its_decision_span(traced):
    """test_telemetry.py:577 (the trace half): the find_best hop joins the
    request's trace and its span rides back in the reply."""
    drt = await DistributedRuntime.detached()
    router = None
    try:
        ep = drt.namespace("tr").component("backend").endpoint("generate")
        await ep.serve_endpoint(make_engine_handler(EchoEngineCore()))
        router = StandaloneRouter(drt, namespace="tr", component="backend",
                                  endpoint="generate", block_size=BS)
        await router.start()
        finder = await drt.namespace("tr").component("router").endpoint("find_best").client()
        await finder.wait_for_instances(5.0)
        ctx = tp.Context()
        with dtrace.root_span("http_request", ctx, request_id=ctx.id):
            stream = await finder.direct({"token_ids": list(range(2 * BS)), "request_id": ctx.id},
                                         finder.instance_ids()[0], ctx)
            decision = None
            async for item in stream:
                decision = item.data if hasattr(item, "data") else item
        assert "worker_id" in decision and decision.get("trace"), decision
        dtrace.ingest(decision["trace"])
        spans = dtrace.spans_for_trace(dtrace.trace_for_request(ctx.id))
        route = [s for s in spans if s.name == "route_decision"]
        assert route and route[0].proc == "router" and route[0].attrs["overlap_blocks"] >= 0
    finally:
        if router is not None:
            await router.close()
        await drt.close()
