"""The port's metrics and logging against the JAX package's, on the CPU.

- ``runtime/prom.py`` and ``http/metrics.py``: a port ``ServiceMetrics`` and
  the reference's (``prometheus_client``), with every ``attach_*`` hook the
  port has wired to the same sources and fed the same observations, render
  text that ``prometheus_client.parser`` reads into the same families:
  names, types, help, labels and values (the reference's optional
  ``_created`` samples aside), the decision-provenance families included
  (each process's ledger seeded with the same records). Label values and
  help text are escaped as the reference's are.
- ``test_metrics_lint.py``'s rules on the port's registries (frontend,
  standalone router, system status): ``_total`` only on counters, a unit on
  every histogram, help on every family, and the QoS, integrity, control
  plane, tail and prefix-cache families present with their types.
- ``build_router_registry`` renders what the reference's renders over the
  same scheduler, scorer and counters.
- Over HTTP: the frontend's request, TTFT and inflight families count the
  traffic sent, ``/live`` answers, and a worker's status server
  (``inputs._start_status_server``) serves ``/health``, ``/live`` and
  ``/metrics`` with its engine's phase histograms counting its streams.
- ``runtime/logging.py``: ``DYN_LOG`` filters parse as the reference's, and a
  JSONL ``with_fields`` line under a trace span carries the trace id.
"""

import asyncio
import io
import json
import logging

import pytest
from prometheus_client.parser import text_string_to_metric_families

from dynamo_tpu.http import metrics as jm
from dynamo_tpu.router import build_router_registry as j_router_registry
from dynamo_tpu.runtime import logging as jlog
from dynamo_tpu.telemetry import health as jh
from dynamo_tpu.telemetry import provenance as jprov
from dynamo_tpu_torch.entrypoint.inputs import EngineConfig, _start_status_server, run_http
from dynamo_tpu_torch.http import metrics as tm
from dynamo_tpu_torch.kv_router.scheduler import KvScheduler
from dynamo_tpu_torch.model_card import ModelDeploymentCard
from dynamo_tpu_torch.pipeline.context import Context
from dynamo_tpu_torch.protocols import common as tp
from dynamo_tpu_torch.router import build_router_registry
from dynamo_tpu_torch.runtime import logging as dlog
from dynamo_tpu_torch.runtime.http_server import SystemStatusServer
from dynamo_tpu_torch.runtime.prom import generate_latest
from dynamo_tpu_torch.telemetry import brownout as tb
from dynamo_tpu_torch.telemetry import health as th
from dynamo_tpu_torch.telemetry import provenance as tprov
from dynamo_tpu_torch.telemetry import trace as dtrace
from tests.test_torch_engine import make_torch_engine
from tests.test_torch_frontend import MODEL, afetch, model_dir  # noqa: F401
from tests.test_torch_qos_deadlines import collect, req

UNIT_SUFFIXES = ("_seconds", "_bytes", "_ms")
DECISION_FAMILIES = {"dyn_llm_decisions", "dyn_llm_decision_ring_dropped"}


def _same_ledgers() -> None:
    """Both processes' decision ledgers fresh, with the same records."""
    for prov in (tprov, jprov):
        prov.set_mode("1")
        prov.reset(proc="test", ring=16)
        prov.record("router", "route", 1, reason="overlap", request_id="r1")
        prov.record("admission", "shed", "bulk", reason="watermark", request_id="r2")
        for i in range(20):  # 16 kept, 4 evicted
            prov.record("qos", "priority", "standard", reason="default", request_id=f"q{i}")


def parsed(text: str) -> dict:
    """{family: (type, help, sorted samples)} without ``_created``."""
    out = {}
    for fam in text_string_to_metric_families(text):
        if fam.name.endswith("_created"):
            continue
        samples = sorted((s.name, tuple(sorted(s.labels.items())), s.value)
                         for s in fam.samples if not s.name.endswith("_created"))
        out[fam.name] = (fam.type, fam.documentation, samples)
    return out


class _Sched:
    hit_rate = 0.25
    fleet_hit_rate = 0.5
    hit_stats = {"matched_blocks": 12}
    pull_stats = {"plans": 3, "planned_blocks": 9}


class _Hedger:
    outcomes = {"won": 2, "lost": 5, "budget_denied": 1}
    wasted_tokens = 7


STATS = {"num_drafts": 4, "num_draft_tokens": 12, "num_accepted_tokens": 9,
         "kv_wire_bytes_tx": 1024, "kv_wire_bytes_rx": 4096, "kv_frames_tx": 3, "kv_frames_rx": 5,
         "kv_frames_inflight": 1, "prefill_dropped_expired": 0, "kv_bytes_overlapped": 2048,
         "preemptions_by_class": {"bulk": 3, "standard": 1}, "preempted_too_often": 1,
         "shed_brownout": 2}
INTEGRITY = {"integrity_failures_by_path": {"disagg_frame": 2, "tier_host": 1},
             "blocks_quarantined": 1, "fenced_rejects_by_plane": {"dispatch": 4}}
FABRIC = {"connected": True, "degraded": False, "degraded_seconds_total": 1.5,
          "blackouts_total": 1, "buffered_publishes": 3, "flushed_publishes": 3}


def _scorers():
    out = []
    for mod in (th, jh):
        t = [0.0]
        s = mod.HealthScorer(mod.HealthConfig(eject_intervals=1, alpha=1.0, min_healthy=1),
                             now_fn=lambda: t[0])
        for wid, ms in {0x1a: 100.0, 0x2b: 100.0, 0x3c: 900.0}.items():
            s.record(wid, "first_frame", ms)
        t[0] += 1.0
        s.tick()
        out.append(s)
    return out


def _fed(mod, scorer, brownout):
    m = mod.ServiceMetrics()
    m.attach_spec_stats(STATS)
    m.attach_kv_transfer_stats(STATS)
    m.attach_engine_qos(STATS)
    m.attach_integrity(INTEGRITY)
    m.attach_control_plane(FABRIC)
    m.attach_health(scorer, _Hedger())
    m.attach_brownout(brownout)
    m.attach_kv_hit_stats(_Sched(), lambda: {"pulled": 6, "fallback_miss": 2})
    for model, ep in (("m1", "chat_completions"), ('we"ird\\na\nme', "completions")):
        m.requests_total.labels(model, ep, "success").inc(3)
        m.requests_total.labels(model, ep, "error").inc()
        m.inflight.labels(model, ep).inc(2)
        m.inflight.labels(model, ep).dec()
        for v in (0.003, 0.04, 0.7, 2.2, 400.0):
            m.request_duration.labels(model, ep).observe(v)
            m.time_to_first_token.labels(model).observe(v / 10)
            m.inter_token_latency.labels(model).observe(v / 100)
        m.prompt_tokens.labels(model).inc(17)
        m.output_tokens.labels(model).inc(5)
        m.requests_shed.labels(model).inc(2)
        m.request_migrations.labels(model).inc()
        m.deadline_exceeded.labels(model).inc()
        m.class_shed.labels(model, "bulk", "watermark").inc(2)
        m.class_shed.labels(model, "standard", "brownout").inc()
    return m


def test_exposition_parses_to_the_reference_families():
    sp, sr = _scorers()
    bp, br = tb.BrownoutController(), tb.BrownoutController()
    bp.level = br.level = 2
    bp.steps_up = br.steps_up = 2
    _same_ledgers()
    port = parsed(_fed(tm, sp, bp).render().decode())
    ref = parsed(_fed(jm, sr, br).render().decode())
    assert set(ref) == set(port) and DECISION_FAMILIES <= set(port)
    for name in port:
        assert port[name] == ref[name], name
    assert port["dyn_llm_workers_ejected"][2][0][2] == 1.0
    # the escaped label value round-trips
    assert any(dict(s[1]).get("model") == 'we"ird\\na\nme'
               for s in port["dyn_llm_http_service_requests"][2])


def _port_registries():
    front = tm.ServiceMetrics()
    front.attach_spec_stats(STATS)
    front.attach_kv_transfer_stats(STATS)
    front.attach_kv_hit_stats(_Sched())
    front.attach_health(_scorers()[0], _Hedger())
    front.attach_brownout(tb.BrownoutController())
    front.attach_engine_qos(STATS)
    front.attach_integrity(INTEGRITY)
    front.attach_control_plane(FABRIC)
    return {"frontend": front.registry,
            "router": build_router_registry(_Sched(), lambda: 0, lambda: 0, health=_scorers()[0]),
            "system": SystemStatusServer().registry}


def _families(registry):
    return list(text_string_to_metric_families(generate_latest(registry).decode()))


def test_metrics_lint_rules_hold_on_the_port_registries():
    problems = []
    for role, reg in _port_registries().items():
        for fam in _families(reg):
            if fam.type != "counter" and any(s.name.endswith("_total") for s in fam.samples):
                problems.append(f"{role}: {fam.name} {fam.type} has a _total sample")
            if fam.type == "histogram" and not fam.name.endswith(UNIT_SUFFIXES):
                problems.append(f"{role}: histogram {fam.name} has no unit")
            if not fam.documentation.strip():
                problems.append(f"{role}: {fam.name} has no help")
    assert not problems, problems


@pytest.mark.parametrize("role,names", [
    ("frontend", {"dyn_llm_class_requests_shed": "counter", "dyn_llm_brownout_level": "gauge",
                  "dyn_llm_brownout_transitions": "counter", "dyn_llm_preemptions": "counter",
                  "dyn_llm_preempted_too_often": "counter", "dyn_llm_brownout_sheds": "counter"}),
    ("frontend", {"dyn_llm_kv_integrity_failures": "counter", "dyn_llm_blocks_quarantined": "counter",
                  "dyn_llm_fenced_rejects": "counter"}),
    ("frontend", {"dyn_fabric_connected": "gauge", "dyn_llm_degraded_mode": "gauge",
                  "dyn_llm_degraded_seconds": "counter", "dyn_fabric_blackouts": "counter",
                  "dyn_llm_degraded_publishes_buffered": "counter",
                  "dyn_llm_degraded_publishes_flushed": "counter"}),
    ("frontend", {"dyn_llm_worker_health_score": "gauge", "dyn_llm_workers_ejected": "gauge",
                  "dyn_llm_ejections": "counter", "dyn_llm_hedges": "counter",
                  "dyn_llm_hedge_wasted_tokens": "counter"}),
    ("frontend", {"dyn_llm_kv_hit_rate": "gauge", "dyn_llm_kv_matched_blocks": "counter",
                  "dyn_llm_kv_fleet_hit_rate": "gauge", "dyn_llm_kv_pulled_blocks": "counter"}),
    ("router", {"dyn_llm_kv_hit_rate": "gauge", "dyn_llm_kv_pull_plans": "counter",
                "dyn_llm_router_decisions": "counter", "dyn_llm_requests_shed": "counter",
                "dyn_llm_worker_health_score": "gauge", "dyn_llm_ejections": "counter"}),
    ("system", {"dyn_runtime_uptime_seconds": "gauge", "dyn_runtime_health": "gauge"}),
])
def test_families_present_with_correct_types(role, names):
    fams = {f.name: f.type for f in _families(_port_registries()[role])}
    for name, typ in names.items():
        assert fams.get(name) == typ, (role, name, fams.get(name))


def test_router_registry_renders_as_the_reference():
    sp, sr = _scorers()
    _same_ledgers()
    port = parsed(generate_latest(build_router_registry(_Sched(), lambda: 5, lambda: 2, health=sp)).decode())
    from prometheus_client import generate_latest as j_generate

    ref = parsed(j_generate(j_router_registry(_Sched(), lambda: 5, lambda: 2, health=sr)).decode())
    assert set(ref) == set(port) and DECISION_FAMILIES <= set(port)
    for name in port:
        assert port[name] == ref[name], name
    # the port's scheduler has the properties the registry reads
    sched = KvScheduler(block_size=4)
    assert (sched.hit_rate, sched.fleet_hit_rate) == (0.0, 0.0)


# --------------------------------------------------------------------- HTTP


async def test_frontend_metrics_count_the_traffic(model_dir):
    engine = make_torch_engine()
    mdc = ModelDeploymentCard.from_model_dir(model_dir, MODEL)
    svc = await run_http(EngineConfig.static_(engine, mdc), host="127.0.0.1", port=0)
    try:
        sent = {"chat_completions": 0, "completions": 0}
        for i in range(3):
            st, _, _ = await afetch(svc.port, "POST", "/v1/completions",
                                    {"model": MODEL, "prompt": "a b c", "max_tokens": 3,
                                     "stream": i % 2 == 0})
            assert st == 200
            sent["completions"] += 1
        st, _, _ = await afetch(svc.port, "POST", "/v1/chat/completions",
                                {"model": MODEL, "messages": [{"role": "user", "content": "a"}],
                                 "max_tokens": 2})
        assert st == 200
        sent["chat_completions"] += 1
        st, hdrs, body = await afetch(svc.port, "GET", "/metrics")
        assert st == 200 and hdrs["content-type"].startswith("text/plain")
        fams = parsed(body.decode())
        reqs = {dict(s[1])["endpoint"]: s[2] for s in fams["dyn_llm_http_service_requests"][2]
                if dict(s[1])["status"] == "success"}
        assert reqs == sent
        ttft = [s[2] for s in fams["dyn_llm_http_service_time_to_first_token_seconds"][2]
                if s[0].endswith("_count")]
        assert ttft == [4.0]
        assert all(s[2] == 0 for s in fams["dyn_llm_http_service_inflight_requests"][2])
        assert "dyn_llm_preemptions" in fams and "dyn_llm_kv_integrity_failures" in fams
        st, _, body = await afetch(svc.port, "GET", "/live")
        assert st == 200 and json.loads(body)["status"] == "healthy"
    finally:
        await svc.close()
        await engine.close()


async def test_worker_status_server_serves_health_live_and_phase_histograms():
    engine = make_torch_engine()
    controller = tb.BrownoutController()
    server = await _start_status_server(0, engine, controller)
    try:
        await asyncio.gather(*(collect(engine, req(tp, [3 + i, 4, 5], max_tokens=4), Context())
                               for i in range(3)))
        st, _, body = await afetch(server.port, "GET", "/health")
        assert st == 200 and json.loads(body)["status"] == "healthy"
        st, _, body = await afetch(server.port, "GET", "/live")
        assert st == 200 and json.loads(body) == {"status": "live"}
        st, _, body = await afetch(server.port, "GET", "/metrics")
        fams = parsed(body.decode())
        counts = {dict(s[1])["phase"]: s[2] for s in fams["dyn_llm_phase_duration_seconds"][2]
                  if s[0].endswith("_count")}
        assert counts == {"queue_wait": 3, "ttft": 3, "prefill": 3, "inter_token": 9, "e2e": 3}
        assert fams["dyn_llm_brownout_level"][2][0][2] == 0.0
        assert fams["dyn_runtime_uptime_seconds"][2][0][2] > 0
        st, _, _ = await afetch(server.port, "GET", "/nope")
        assert st == 404
    finally:
        await server.close()
        await engine.close()


# ------------------------------------------------------------------ logging


@pytest.mark.parametrize("spec", ["info", "debug,dynamo_tpu_torch.router=trace",
                                  "warn, a.b=error ,c=bogus", "", "trace"])
def test_log_filters_parse_as_the_reference(spec):
    assert dlog._parse_filter(spec) == jlog._parse_filter(spec)


def test_jsonl_with_fields_carries_the_trace_id():
    buf = io.StringIO()
    handler = logging.StreamHandler(buf)
    handler.setFormatter(dlog.JsonlFormatter())
    log = dlog.get_logger("dynamo_tpu_torch.test_jsonl")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    dtrace.set_enabled(True)
    dtrace.reset(proc="frontend")
    try:
        ctx = Context(id="rid-7")
        with dtrace.root_span("http_request", ctx, request_id=ctx.id):
            dlog.with_fields(log, logging.INFO, "served", tokens=3)
        dlog.with_fields(log, logging.INFO, "outside")
        lines = [json.loads(x) for x in buf.getvalue().splitlines()]
        assert lines[0]["trace_id"] == dtrace.ctx_trace_id(ctx) and lines[0]["request_id"] == "rid-7"
        assert lines[0]["tokens"] == 3 and lines[0]["message"] == "served"
        assert "trace_id" not in lines[1]
        assert set(lines[0]) >= {"time", "level", "target", "message"}
    finally:
        log.removeHandler(handler)
        dtrace.set_enabled(False)
        dtrace.reset()
