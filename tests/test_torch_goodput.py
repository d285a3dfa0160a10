"""The port's goodput ledger against the JAX package's, on the CPU.

- ``telemetry/goodput.py``: the same ``record_*`` calls on a port and a
  reference ledger give the same wire dict and summary; wire dicts cross
  packages both ways; merges are associative and commutative and equal the
  reference's merge of the same ledgers; the label cap, bubble accounting
  and ``mark_idle``, the ``DYN_GOODPUT`` switch, ``RecompileDetector``'s
  thresholds and ``step_phase`` equal the reference's; a recompile warns
  naming its shape.
- ``TorchEngine``'s ledger against ``JaxEngine``'s on the same tiny model
  and greedy requests: the same steps by label, lanes, capacity, prefill
  and decode tokens. Recompiles come from the runner's ``warm_events``:
  a cold dispatch after a label's first is ``shape_miss``, or
  ``prebake_miss`` when the prebake manifest covers the label; first
  dispatches are compile records only. Waste: a migration's replayed tail,
  a spec engine's rejected drafts (= drafted minus accepted tokens), a
  cancelled stream's partial output.
- The frontend: ``attach_goodput`` renders the reference's families with
  the hedger's ``hedge_loser`` overlay; ``GET /debug/goodput`` on a
  frontend over a colocated mocker.

The reference's 2 us wall-clock bound on ``record_step`` is not copied: the
card's host measures that cost (chip_smoke.py).
"""

import asyncio
import json
import logging
import random

import pytest
from prometheus_client import generate_latest as j_generate

from dynamo_tpu.http import metrics as jm
from dynamo_tpu.telemetry import goodput as ref
from dynamo_tpu.telemetry.health import HedgeController as JHedgeController
from dynamo_tpu_torch.engine.mocker import MockEngine, MockEngineArgs
from dynamo_tpu_torch.entrypoint.inputs import EngineConfig, run_http
from dynamo_tpu_torch.http import metrics as tm
from dynamo_tpu_torch.protocols import common as tp
from dynamo_tpu_torch.run import build_test_mdc
from dynamo_tpu_torch.runtime.prom import generate_latest
from dynamo_tpu_torch.telemetry import goodput as port
from dynamo_tpu_torch.telemetry.health import HedgeController
from tests.test_torch_engine import (
    MAX_NEW,
    PROMPTS,
    JaxContext,
    collect,
    jp,
    make_jax_engine,
    make_torch_engine,
    request,
)
from tests.test_torch_frontend import afetch
from tests.test_torch_metrics import parsed


def _drive(mod, seed: int):
    """A seeded sequence of every recorder on a ledger of ``mod``."""
    rng = random.Random(seed)
    gp = mod.GoodputLedger(enabled=True)
    t = 100.0
    for i in range(60 + 13 * seed):
        label = rng.choice(("prefill", "decode", "decode_multi@H4", "mixed_step@c2",
                            "prefill_chunk", "spec_verify"))
        dur = rng.lognormvariate(-4.0 + 0.3 * seed, 0.5)
        gp.record_step(label, dur, lanes=rng.randrange(0, 9), capacity=8,
                       prefill_tokens=rng.randrange(0, 256), t_start=t)
        t += dur + rng.random() * 0.002
        if i % 17 == 0:
            gp.mark_idle()
            t += 5.0
    gp.record_decode_tokens(seed * 100 + 7)
    for cause in ref.WASTE_CAUSES:
        gp.record_waste(cause, rng.randrange(0, 50))
    gp.record_waste("spec_rejected", 0)  # ignored
    gp.record_compile("decode", 10.0 + seed)
    gp.record_compile("prefill", 3.25 * (seed + 1))
    if seed % 2:
        gp.record_recompile("decode", "shape_miss", shape="lanes=9")
        gp.record_recompile("prefill", "prebake_miss")
    gp.set_perf_gauges(0.1 * (seed + 1), 1e8 * (seed + 1))
    return gp


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_wire_dicts_and_summaries_equal_the_reference(seed):
    p, r = _drive(port, seed), _drive(ref, seed)
    assert p.to_dict() == r.to_dict()
    assert p.summary() == r.summary()
    assert (p.occupancy, p.phase_bubble_fraction, p.mfu_achieved, p.hbm_bytes_per_token) == (
        r.occupancy, r.phase_bubble_fraction, r.mfu_achieved, r.hbm_bytes_per_token)
    wire = json.loads(json.dumps(r.to_dict()))
    # each package reads the other's wire dict to the same dict
    assert port.GoodputStats.from_dict(wire).to_dict() == ref.GoodputStats.from_dict(wire).to_dict()
    assert ref.GoodputStats.from_dict(p.to_dict()).summary() == \
        port.GoodputStats.from_dict(p.to_dict()).summary()


def test_merge_is_associative_and_equals_the_references():
    ps = [_drive(port, s) for s in range(3)]
    rs = [_drive(ref, s) for s in range(3)]

    def fold(mod, *parts):
        out = mod.GoodputStats()
        for x in parts:
            out.merge(x.copy())
        return out

    def same(x, y):
        dx, dy = x.to_dict(), y.to_dict()
        for key in ("st", "ms", "mpt", "mdt", "ls", "lc", "pt", "dt", "w", "rc", "cs", "n", "sh"):
            assert dx[key] == dy[key], key
        for key in ("bub", "bus", "pg", "mfu", "hbm"):  # float sums: order-rounded
            assert dx[key] == pytest.approx(dy[key], rel=1e-9), key

    a, b, c = ps
    left, right = fold(port, fold(port, a, b), c), fold(port, a, fold(port, b, c))
    same(left, right)
    same(fold(port, a, b), fold(port, b, a))
    # the same merges in the same order: the reference's dict exactly
    assert fold(port, fold(port, a, b), c).to_dict() == fold(ref, fold(ref, *rs[:2]), rs[2]).to_dict()
    assert left.steps_total == sum(x.steps_total for x in ps)
    assert left.compile_s_by_label["decode"] == 12.0
    assert left.mfu_achieved == pytest.approx(0.2)


def test_ledger_units_equal_the_reference(monkeypatch):
    # the label cap under churn
    for mod in (port, ref):
        gp = mod.GoodputLedger(enabled=True)
        for i in range(100):
            gp.record_step(f"decode@bs{i}", 0.004)
            gp.record_compile(f"decode@bs{i}", 1.0 + i)
            gp.record_recompile(f"decode@bs{i}", "shape_miss", shape=f"bs={i}")
        gp.record_step("decode@bs0", 0.004)
        assert gp.steps_total == 101 and gp.step_hists.phases["decode@bs0"].count == 2
        assert len(gp.step_hists.phases) == len(gp.compile_s_by_label) == mod.MAX_LABELS
    # bubbles, mark_idle, the phase-transition share
    out = []
    for mod in (port, ref):
        gp = mod.GoodputLedger(enabled=True)
        gp.record_step("prefill", 0.010, t_start=100.000)
        gp.record_step("decode", 0.010, t_start=100.015)  # 5 ms, a phase gap
        gp.record_step("decode", 0.010, t_start=100.027)  # 2 ms, not one
        gp.mark_idle()
        gp.record_step("prefill", 0.010, t_start=300.0)  # idle: no bubble
        out.append((gp.bubble_s_total, gp.phase_gap_s_total, gp.busy_s_total))
    assert out[0] == out[1] and out[0][0] == pytest.approx(0.007)
    # the switch: a disabled ledger records nothing
    for mod in (port, ref):
        gp = mod.GoodputLedger(enabled=False)
        gp.record_step("decode", 0.004, lanes=3, capacity=8, prefill_tokens=64)
        gp.record_decode_tokens(10)
        gp.record_waste("spec_rejected", 5)
        gp.record_compile("decode", 2.0)
        gp.record_recompile("decode", "shape_miss")
        gp.set_perf_gauges(0.4, 1e8)
        assert gp.total_events() == 0
    for value, on in (("0", False), ("off", False), ("1", True)):
        monkeypatch.setenv("DYN_GOODPUT", value)
        assert port.enabled_from_env() is ref.enabled_from_env() is on
        assert port.GoodputLedger().enabled is on
    monkeypatch.delenv("DYN_GOODPUT")
    assert port.enabled_from_env() and ref.enabled_from_env()
    # the reference's recompile heuristic, kept and held to it
    for args in ((2.5, 0.004), (0.03, 0.002), (0.5, 0.2), (0.2, 0.02)):
        assert (port.RecompileDetector(0.2, 10.0).is_recompile(*args)
                == ref.RecompileDetector(0.2, 10.0).is_recompile(*args))
    monkeypatch.setenv("DYN_RECOMPILE_MIN_S", "1.5")
    monkeypatch.setenv("DYN_RECOMPILE_FACTOR", "4")
    assert (port.RecompileDetector().min_s, port.RecompileDetector().factor) == (1.5, 4.0)
    for label in ("prefill@2048", "prefill_packed", "prefill_chunk", "decode", "decode_eos",
                  "decode_multi@H4", "spec_verify", "mixed_step", "mixed_step@c3", "kv_offload"):
        assert port.step_phase(label) == ref.step_phase(label)
        assert port.normalize_label(label) == ref.normalize_label(label)
    assert port.WASTE_CAUSES == ref.WASTE_CAUSES
    assert port.RECOMPILE_CAUSES == ref.RECOMPILE_CAUSES


def test_a_recompile_warns_naming_its_shape(caplog):
    gp = port.GoodputLedger(enabled=True)
    with caplog.at_level(logging.WARNING, logger="dynamo_tpu_torch.telemetry.goodput"):
        gp.record_recompile("decode", "shape_miss", shape="lanes=9,tokens=0")
    assert gp.recompiles == {"decode|shape_miss": 1}
    assert any("decode" in r.getMessage() and "lanes=9,tokens=0" in r.getMessage()
               for r in caplog.records), caplog.text


async def test_torch_engine_ledger_equals_the_jax_engines():
    jeng, teng = make_jax_engine(), make_torch_engine()
    try:
        jres = await asyncio.gather(*(
            collect(jeng, request(jp, p, n), JaxContext()) for p, n in zip(PROMPTS, MAX_NEW)))
        tres = await asyncio.gather(*(
            collect(teng, request(tp, p, n), tp.Context()) for p, n in zip(PROMPTS, MAX_NEW)))
    finally:
        await jeng.close()
        await teng.close()
    assert [t for t, _, _ in tres] == [t for t, _, _ in jres]
    jg, tg = jeng.stats.goodput, teng.stats.goodput
    assert {k: h.count for k, h in tg.step_hists.phases.items()} == \
        {k: h.count for k, h in jg.step_hists.phases.items()}
    for name in ("steps_total", "lane_steps", "lane_capacity_steps", "prefill_tokens",
                 "decode_tokens", "mixed_steps"):
        assert getattr(tg, name) == getattr(jg, name), name
    assert tg.decode_tokens == sum(MAX_NEW)
    assert tg.wasted_total() == jg.wasted_total() == 0
    # a first dispatch per label is its compile record, nothing more
    assert set(tg.compile_s_by_label) == set(tg.step_hists.phases) and not tg.recompiles


def _warming(engine, every_call_of: str, on_call: int, monkeypatch):
    """Make the runner report a one-off cost (a kernel library loaded) on
    the ``on_call``-th call of one of its methods."""
    from dynamo_tpu_torch.ops import _build

    runner = engine.runner
    real = getattr(runner, every_call_of)
    calls = [0]

    def wrapped(*a, **kw):
        calls[0] += 1
        if calls[0] == on_call:
            monkeypatch.setattr(_build, "load_events", _build.load_events + 1)
        return real(*a, **kw)

    monkeypatch.setattr(runner, every_call_of, wrapped)


@pytest.mark.parametrize("prebaked", [False, True])
async def test_a_cold_dispatch_after_the_first_is_a_recompile(prebaked, tmp_path, monkeypatch):
    monkeypatch.setenv("DYN_KERNEL_CACHE_DIR", str(tmp_path))
    if prebaked:
        port.write_prebake_manifest(str(tmp_path), [("prefill@64", 0.1), ("decode", 0.2)])
    eng = make_torch_engine()
    assert eng._prebaked_labels == (frozenset({"prefill", "decode"}) if prebaked else frozenset())
    _warming(eng, "decode", 3, monkeypatch)  # the third decode step loads a library
    try:
        await collect(eng, request(tp, PROMPTS[0], 8), tp.Context())
    finally:
        await eng.close()
    gp = eng.stats.goodput
    cause = "prebake_miss" if prebaked else "shape_miss"
    assert gp.recompiles == {f"decode|{cause}": 1}
    assert set(gp.compile_s_by_label) == {"prefill", "decode"}
    assert eng.stats.cold_dispatches == 1


async def test_waste_causes_on_the_torch_engine():
    eng = make_torch_engine()
    try:
        # a migration resume replays the tail a dead worker streamed
        prompt = PROMPTS[1]
        base, _, _ = await collect(eng, request(tp, prompt, 10), tp.Context())
        resumed = request(tp, list(prompt) + base[:4], 10)
        resumed.extra["resume_prompt_len"] = len(prompt)
        tail, _, _ = await collect(eng, resumed, tp.Context())
        assert tail == base[4:]
        assert eng.stats.goodput.waste_by_cause == {"migration_replay": 4}
        # a consumer gone mid-stream: its partial output is wasted
        ctx = tp.Context()
        gen = eng.generate(request(tp, prompt, 40), ctx)
        got = 0
        async for out in gen:
            got += len(out.token_ids)
            if got >= 3:
                ctx.kill()
                break
        await gen.aclose()
        for _ in range(200):
            if "cancelled_partial" in eng.stats.goodput.waste_by_cause:
                break
            await asyncio.sleep(0.01)
        assert eng.stats.goodput.waste_by_cause["cancelled_partial"] >= 3
    finally:
        await eng.close()


async def test_spec_rejected_waste_is_drafts_minus_accepts():
    from tests import test_torch_spec_decode as ts

    jcfg, jparams, _, tparams = ts._models(vocab=ts.VOCAB)
    jeng, teng = ts._jax_engine(jcfg, jparams), ts._torch_engine(tparams)
    jres = await ts._serve(jeng, jp, JaxContext)
    tres = await ts._serve(teng, tp, tp.Context)
    assert [t for t, _ in tres] == [t for t, _ in jres]
    st = teng.stats
    assert st.num_draft_tokens > st.num_accepted_tokens > 0
    assert st.goodput.waste_by_cause["spec_rejected"] == \
        st.num_draft_tokens - st.num_accepted_tokens == \
        jeng.stats.goodput.waste_by_cause["spec_rejected"]


def test_frontend_attach_goodput_renders_the_references_families():
    out = {}
    for name, mod, mod_gp, hedger, render in (
            ("port", tm, port, HedgeController(), lambda m: m.render().decode()),
            ("ref", jm, ref, JHedgeController(), lambda m: j_generate(m.registry).decode())):
        metrics = mod.ServiceMetrics()
        gp = _drive(mod_gp, 1)
        hedger.wasted_tokens = 7
        metrics.attach_goodput({"goodput": gp}, hedger)
        metrics.attach_goodput({"goodput": gp}, hedger)  # attached once
        fams = parsed(render(metrics))
        out[name] = {k: v for k, v in fams.items() if not k.startswith("dyn_llm_decision")}
    assert out["port"].keys() == out["ref"].keys()
    for name in out["port"]:
        assert out["port"][name] == out["ref"][name], name
    text = tm.ServiceMetrics()
    gp = port.GoodputLedger(enabled=True)
    hedger = HedgeController()
    hedger.wasted_tokens = 7
    text.attach_goodput({"goodput": gp}, hedger)
    gp.record_waste("cancelled_partial", 16)
    rendered = generate_latest(text.registry).decode()
    assert 'dyn_llm_tokens_wasted_total{cause="hedge_loser"} 7.0' in rendered
    assert 'dyn_llm_tokens_wasted_total{cause="cancelled_partial"} 16.0' in rendered


async def test_http_debug_goodput_over_a_colocated_mocker():
    engine = MockEngine(MockEngineArgs(speedup_ratio=1000.0))
    config = EngineConfig.static_(engine, build_test_mdc("goodput-mock"))
    service = await run_http(config, host="127.0.0.1", port=0)
    try:
        status, _, _ = await afetch(service.port, "POST", "/v1/completions", {
            "model": "goodput-mock", "prompt": "one two three four five six",
            "stream": True, "max_tokens": 4})
        assert status == 200
        status, _, body = await afetch(service.port, "GET", "/debug/goodput")
        assert status == 200
        doc = json.loads(body)
        assert doc["scope"] == "frontend" and doc["enabled"] is True
        summary = doc["goodput"]
        assert summary["decode_tokens"] == 4
        assert summary["steps_by_label"]["decode"]["count"] == 4
        assert set(summary["tokens_wasted"]) == set(port.WASTE_CAUSES)
        _, _, text = await afetch(service.port, "GET", "/metrics")
        assert 'dyn_llm_device_tokens_total{phase="decode"} 4.0' in text.decode()
    finally:
        await service.close()
        await engine.close()
