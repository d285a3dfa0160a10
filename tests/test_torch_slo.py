"""The port's SLO plane against the JAX package's, on the CPU.

- ``telemetry/histogram.py``: the same observations give bucket-identical
  histograms (wire dicts, percentiles, ``fraction_over``), and merges and
  subtractions are equal; the reference's merge, error-bound and wire cases
  run on the port.
- ``telemetry/slo.py``: ``SloConfig`` reads the same env / TOML precedence,
  ``SloEngine`` goes through the same states and statuses on the same
  observation stream under a fake clock, ``retention_reason`` decides the
  same, and the flight recorder evicts by its byte budget (the twins of
  ``tests/test_slo.py``'s unit cases).
- ``TorchEngine`` records the always-on phase histograms ``JaxEngine``
  records (counts per phase), and ``inputs.load_metrics`` ships them typed.
- The frontend: a forced breach flips ``GET /debug/slo``, publishes a
  ``slo-status`` event and steps the brownout ladder; ``DYN_TRACE=auto``
  keeps an errored request's trace and drops a fast one's, listed at
  ``GET /debug/traces`` (the twins of ``test_forced_breach_flips_debug_slo_and_emits_event``
  and ``test_auto_mode_keeps_errored_drops_fast``).
"""

import asyncio
import json
import random

import pytest

from dynamo_tpu.telemetry import histogram as jh
from dynamo_tpu.telemetry import slo as jslo
from dynamo_tpu_torch.entrypoint.inputs import EngineConfig, load_metrics, run_http
from dynamo_tpu_torch.model_card import ModelDeploymentCard
from dynamo_tpu_torch.pipeline.context import Context
from dynamo_tpu_torch.telemetry import histogram as th
from dynamo_tpu_torch.telemetry import slo as tslo
from dynamo_tpu_torch.telemetry import trace as dtrace
from tests.test_torch_engine import make_jax_engine, make_torch_engine
from tests.test_torch_frontend import MODEL, afetch, model_dir, sse  # noqa: F401
from tests.test_torch_qos_deadlines import collect, req

from dynamo_tpu.protocols import common as jp
from dynamo_tpu.pipeline.context import Context as JContext
from dynamo_tpu_torch.protocols import common as tp


def _values(seed: int, n: int = 400) -> list[float]:
    rng = random.Random(seed)
    out = [rng.lognormvariate(3.0, 1.5) for _ in range(n)]
    return out + [0.0, 0.01, 0.05, 1e-9, 1e7, 3e7, th.BOUNDS[5], th.BOUNDS[40]]


# ------------------------------------------------------------- histograms


@pytest.mark.parametrize("seed", range(4))
def test_histograms_are_bucket_identical_and_merge_equal(seed):
    vals = _values(seed)
    assert [th.bucket_index(v) for v in vals] == [jh.bucket_index(v) for v in vals]
    assert th.BOUNDS == jh.BOUNDS and th.NUM_BUCKETS == jh.NUM_BUCKETS
    ports, refs = [], []
    for part in range(3):
        p, r = th.PhaseHistograms(), jh.PhaseHistograms()
        for i, v in enumerate(vals[part::3]):
            phase = ("ttft", "inter_token", "e2e")[i % 3]
            p.observe(phase, v)
            r.observe(phase, v)
        assert p.to_dict() == r.to_dict()
        ports.append(p)
        refs.append(r)
    pm, rm = th.PhaseHistograms(), jh.PhaseHistograms()
    for p, r in zip(ports, refs):
        pm.merge(p)
        rm.merge(r)
    assert pm.to_dict() == rm.to_dict()
    for phase in ("ttft", "inter_token", "e2e"):
        a, b = pm.phases[phase], rm.phases[phase]
        for q in (50, 90, 95, 99, 99.9):
            assert a.percentile(q) == b.percentile(q)
        for thr in (1.0, 20.0, 333.0):
            assert a.fraction_over(thr) == b.fraction_over(thr)
    # subtraction (the SLO windows' deltas) and the wire round trip
    d_port = pm.phases["ttft"].sub(ports[0].phases["ttft"])
    d_ref = rm.phases["ttft"].sub(refs[0].phases["ttft"])
    assert d_port.to_dict() == d_ref.to_dict()
    back = th.PhaseHistograms.from_dict(json.loads(json.dumps(rm.to_dict())))
    assert back.to_dict() == pm.to_dict()


def test_bucket_merge_associative_and_commutative():
    hs = []
    for seed in range(3):
        h = th.PhaseHistogram()
        for v in _values(seed, 200):
            h.observe(v)
        hs.append(h)
    a, b, c = hs

    def merged(*xs):
        out = th.PhaseHistogram()
        for x in xs:
            out.merge(x)
        return out

    assert merged(merged(a, b), c).to_dict() == merged(a, merged(b, c)).to_dict()
    assert merged(a, b, c).to_dict() == merged(c, a, b).to_dict()


def test_percentile_error_bound():
    vals = sorted(_values(7, 4000)[:4000])
    h = th.PhaseHistogram()
    for v in vals:
        h.observe(v)
    for q in (50, 90, 99):
        true = vals[min(len(vals) - 1, int(q / 100 * len(vals)))]
        assert abs(h.percentile(q) - true) / true <= th.QUANTILE_REL_ERROR + 0.02


# --------------------------------------------------------------- SloConfig


def test_slo_config_env_and_toml_precedence(tmp_path, monkeypatch):
    path = tmp_path / "slo.toml"
    path.write_text('ttft_ms = 300\npercentile = 90\n[models."m1"]\nttft_ms = 120\nitl_ms = 40\n')
    monkeypatch.setenv("DYN_SLO_CONFIG", str(path))
    for env in ({}, {"DYN_SLO_ITL_MS": "25"}, {"DYN_SLO_TTFT_MS": "80", "DYN_SLO_PERCENTILE": "99"}):
        for k in ("DYN_SLO_ITL_MS", "DYN_SLO_TTFT_MS", "DYN_SLO_PERCENTILE"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for model in (None, "m1", "m2"):
            assert tslo.SloConfig.from_env(model).to_dict() == jslo.SloConfig.from_env(model).to_dict()
    monkeypatch.delenv("DYN_SLO_CONFIG")
    for k in ("DYN_SLO_ITL_MS", "DYN_SLO_TTFT_MS", "DYN_SLO_PERCENTILE"):
        monkeypatch.delenv(k, raising=False)
    assert not tslo.SloConfig.from_env().enabled


# --------------------------------------------------------------- SloEngine


@pytest.mark.parametrize("seed", range(3))
def test_slo_engine_goes_through_the_same_transitions(seed):
    """The same random breach / recovery stream through both engines under
    one fake clock: the same status at every tick, the same transitions."""
    rng = random.Random(seed)
    kw = dict(ttft_ms=100.0, itl_ms=40.0, percentile=95.0, fast_window_s=60.0,
              slow_window_s=600.0, breach_factor=6.0)
    clock = {"t": 0.0}
    ev_p, ev_r = [], []
    ep = tslo.SloEngine(tslo.SloConfig(**kw), on_transition=lambda o, n, s: ev_p.append((o, n)),
                        now_fn=lambda: clock["t"])
    er = jslo.SloEngine(jslo.SloConfig(**kw), on_transition=lambda o, n, s: ev_r.append((o, n)),
                        now_fn=lambda: clock["t"])
    cp, cr = th.PhaseHistograms(), jh.PhaseHistograms()
    for tick in range(60):
        clock["t"] += rng.choice((5.0, 20.0, 60.0))
        bad = tick % 20 < 6  # bursts of violation, then recovery
        for _ in range(rng.randint(0, 40)):
            ttft = rng.uniform(200, 900) if bad and rng.random() < 0.6 else rng.uniform(1, 60)
            itl = rng.uniform(50, 200) if bad and rng.random() < 0.3 else rng.uniform(1, 30)
            for c in (cp, cr):
                c.observe("ttft", ttft)
                c.observe("inter_token", itl)
        assert ep.observe(cp) == er.observe(cr)
    assert ev_p == ev_r and len(ev_p) >= 2
    assert (ep.breaches_total, ep.state) == (er.breaches_total, er.state)


def test_burn_rate_breach_and_recovery_sequence():
    cfg = tslo.SloConfig(ttft_ms=100.0, percentile=95.0, fast_window_s=60.0,
                         slow_window_s=600.0, breach_factor=6.0)
    clock = {"t": 0.0}
    events = []
    eng = tslo.SloEngine(cfg, on_transition=lambda old, new, st: events.append((old, new)),
                         now_fn=lambda: clock["t"])
    cum = th.PhaseHistograms()
    assert eng.observe(cum)["state"] == "ok"
    clock["t"] = 10.0
    for _ in range(100):
        cum.observe("ttft", 10.0)
    assert eng.observe(cum)["state"] == "ok"
    clock["t"] = 20.0
    for _ in range(50):
        cum.observe("ttft", 500.0)
    status = eng.observe(cum)
    assert status["state"] == "breached" and events == [("ok", "breached")]
    clock["t"] = 100.0
    for _ in range(100):
        cum.observe("ttft", 10.0)
    assert eng.observe(cum)["state"] == "burning"
    for t in range(200, 800, 100):
        clock["t"] = float(t)
        for _ in range(50):
            cum.observe("ttft", 10.0)
        status = eng.observe(cum)
    assert status["state"] == "ok"
    assert events == [("ok", "breached"), ("breached", "burning"), ("burning", "ok")]


def test_retention_decisions_equal_the_reference():
    cfgs = [(tslo.SloConfig(ttft_ms=100.0, itl_ms=50.0), jslo.SloConfig(ttft_ms=100.0, itl_ms=50.0)),
            (None, None)]
    for cp, cr in cfgs:
        for err in (None, "deadline_exceeded", "internal_error"):
            for ttft in (None, 50.0, 250.0):
                for itl in (None, 10.0, 80.0):
                    for migrated in (False, True):
                        for sample, r in ((0, 0.5), (2, 0.1), (2, 0.9)):
                            kw = dict(error_code=err, ttft_ms=ttft, max_itl_ms=itl,
                                      migrated=migrated, sample=sample, rng=lambda r=r: r)
                            assert tslo.retention_reason(cp, **kw) == jslo.retention_reason(cr, **kw)
    assert tslo.retention_reason(cfgs[0][0], ttft_ms=250.0, sample=0) == "slo_ttft"


def test_flight_recorder_budget_eviction(tmp_path):
    dtrace.set_enabled(True)
    dtrace.reset(proc="t")
    try:
        tids = []
        for i in range(3):
            ctx = Context(id=f"req-{i}")
            with dtrace.root_span("http_request", ctx, request_id=ctx.id):
                with dtrace.span("decode", ctx=ctx):
                    pass
            tids.append(dtrace.ctx_trace_id(ctx))
        rec = tslo.FlightRecorder(out_dir=str(tmp_path), max_bytes=100_000)
        for i, tid in enumerate(tids):
            rec.retain(tid, f"req-{i}", "slo_ttft")
        assert len(rec.entries()) == 3
        one = rec.entries()[0]["bytes"]
        rec2 = tslo.FlightRecorder(out_dir=str(tmp_path), max_bytes=int(one * 1.5))
        for i, tid in enumerate(tids):
            rec2.retain(tid, f"req-{i}", "slo_ttft")
        assert [e["request_id"] for e in rec2.entries()] == ["req-2"]
        assert rec2.evicted_total == 2
        assert {p.name for p in tmp_path.glob("trace-*.json")} == {"trace-req-2.json"}
        doc = json.loads((tmp_path / "trace-req-2.json").read_text())
        assert doc["otherData"]["retention_reason"] == "slo_ttft"
    finally:
        dtrace.set_enabled(False)
        dtrace.reset()


# ------------------------------------------------------------------ engine


async def test_torch_engine_records_the_phase_histograms_jax_engine_records():
    assert not dtrace.enabled()  # always on: not tied to tracing
    counts = {}
    for name, engine, mod, ctx_cls in (("jax", make_jax_engine(), jp, JContext),
                                       ("port", make_torch_engine(), tp, Context)):
        try:
            await asyncio.gather(*(collect(engine, req(mod, [3 + i, 4, 5, 6], max_tokens=5), ctx_cls())
                                   for i in range(4)))
            ph = engine.stats.phase_histograms
            counts[name] = {k: v.count for k, v in ph.phases.items()}
            if name == "port":
                shipped = load_metrics(engine).phase_histograms
                assert shipped.to_dict() == ph.to_dict()
                assert isinstance(shipped, th.PhaseHistograms)
        finally:
            await engine.close()
    assert counts["port"] == counts["jax"]
    assert counts["port"] == {"queue_wait": 4, "ttft": 4, "prefill": 4, "inter_token": 16, "e2e": 4}


# ---------------------------------------------------------------- frontend


@pytest.fixture
def auto_traced(tmp_path):
    dtrace.set_mode("auto")
    dtrace.reset(proc="frontend")
    tslo.reset_recorder(out_dir=str(tmp_path), max_bytes=50_000_000)
    yield tmp_path
    dtrace.set_enabled(False)
    dtrace.reset()
    tslo.reset_recorder()


async def _local_service(model_dir, engine):
    mdc = ModelDeploymentCard.from_model_dir(model_dir, MODEL)
    return await run_http(EngineConfig.static_(engine, mdc), host="127.0.0.1", port=0)


async def test_forced_breach_flips_debug_slo_and_emits_event(model_dir, monkeypatch):
    # a TTFT objective no request can meet: every request is a violation
    monkeypatch.setenv("DYN_SLO_TTFT_MS", "0.001")
    monkeypatch.setenv("DYN_SLO_TICK_S", "0.05")
    monkeypatch.setenv("DYN_BROWNOUT_STEP_UP_S", "0")
    engine = make_torch_engine()
    svc = await _local_service(model_dir, engine)
    published, ladder = [], []
    svc.slo_publisher = published.append
    svc.brownout_publisher = ladder.append
    try:
        st, _, body = await afetch(svc.port, "GET", "/debug/slo")
        assert st == 200 and json.loads(body)["models"][MODEL]["state"] == "ok"
        for _ in range(3):  # interactive: no rung of the ladder sheds it
            st, _, _ = await afetch(svc.port, "POST", "/v1/completions",
                                    {"model": MODEL, "prompt": "a b c", "max_tokens": 3},
                                    headers={"x-dyn-priority": "interactive"})
            assert st == 200
        for _ in range(100):
            if published and ladder and ladder[-1]["level"] >= 2:
                break
            await asyncio.sleep(0.05)
        st, _, body = await afetch(svc.port, "GET", "/debug/slo")
        doc = json.loads(body)
        assert doc["models"][MODEL]["state"] == "breached"
        assert published[0]["old"] == "ok" and published[0]["new"] == "breached"
        assert published[0]["model"] == MODEL
        # the ladder steps a rung at a time: bulk shed first
        assert [e["level"] for e in ladder][:2] == [1, 2]
        assert ladder[0]["shed_classes"] == ["bulk"] and ladder[1]["spec_off"]
        assert engine._brownout_level == doc["brownout"]["level"] >= 2
        st, hdrs, body = await afetch(svc.port, "POST", "/v1/completions",
                                      {"model": MODEL, "prompt": "a", "max_tokens": 2},
                                      headers={"x-dyn-priority": "bulk"})
        assert st == 429 and json.loads(body)["error"]["type"] == "overloaded"
        assert int(hdrs["retry-after"]) >= 1
    finally:
        await svc.close()
        await engine.close()


async def test_auto_mode_keeps_errored_drops_fast(model_dir, auto_traced, monkeypatch):
    monkeypatch.setenv("DYN_SLO_TTFT_MS", "60000")
    engine = make_torch_engine()
    svc = await _local_service(model_dir, engine)
    try:
        st, _, _ = await afetch(svc.port, "POST", "/v1/completions",
                                {"model": MODEL, "prompt": "a b", "max_tokens": 2},
                                headers={"x-request-id": "fast-1"})
        assert st == 200
        st, _, body = await afetch(svc.port, "POST", "/v1/completions",
                                   {"model": MODEL, "prompt": "a b", "max_tokens": 2,
                                    "stream": True, "ext": {"timeout_ms": 0.001}},
                                   headers={"x-request-id": "slow-err"})
        assert [e.json()["error"]["type"] for e in sse(body) if e.event == "error"] == [
            "deadline_exceeded"]
        st, _, body = await afetch(svc.port, "GET", "/debug/traces")
        doc = json.loads(body)
        assert st == 200 and doc["mode"] == "auto"
        kept = {e["request_id"]: e["reason"] for e in doc["traces"]}
        assert kept == {"slow-err": "error:deadline_exceeded"}
        assert doc["stats"]["dropped"] == 1
        assert (auto_traced / "trace-slow-err.json").exists()
    finally:
        await svc.close()
        await engine.close()
