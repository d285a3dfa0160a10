"""Brownout and admission in the port against the JAX package's, on the CPU.

- ``telemetry/brownout.py``: ``BrownoutController`` steps through the same
  levels and transitions on the same observation stream under a fake clock
  (and the reference's ladder case runs on the port); ``shed_classes_for``,
  ``chunk_capped`` and ``qos.effective_chunk_budget`` answer the same, the
  budget always on the KV block grid.
- ``TorchEngine.apply_brownout`` holds against ``JaxEngine``'s rungs (the
  twin of ``tests/test_priority.py::test_jax_brownout_rungs``): the same
  sheds and stats, the same chunk budgets; under the chunk cap the chunked
  prompt runs in half-width chunks and its greedy tokens equal JaxEngine's;
  with spec paused no verify pass runs and the tokens are unchanged.
- ``AdmissionController``: the reference's class-watermark, drain-rate and
  cold-prefix decisions on the same calls (``test_priority.py:105``,
  ``:132``), and over HTTP the class sheds (``:445``), the brownout ladder
  engaging and disengaging (``:498``), a fleet ``slo-status`` event driving
  the frontend's ladder (``:594``, the event published by hand in place of
  the metrics component), and the overload 429 with ``Retry-After`` and the
  shed counter on ``/metrics`` (``test_lifeguard.py:192``).
"""

import asyncio
import json
import random
import time

import pytest

from dynamo_tpu import qos as j_qos
from dynamo_tpu.http.service import AdmissionController as JAdmission
from dynamo_tpu.pipeline.context import Context as JContext
from dynamo_tpu.protocols import common as jp
from dynamo_tpu.telemetry import brownout as jb
from dynamo_tpu_torch import qos
from dynamo_tpu_torch.engine.echo import EchoEngineCore
from dynamo_tpu_torch.entrypoint.inputs import EngineConfig, run_http
from dynamo_tpu_torch.http.service import AdmissionController
from dynamo_tpu_torch.model_card import ModelDeploymentCard
from dynamo_tpu_torch.pipeline.context import Context
from dynamo_tpu_torch.protocols import common as tp
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.telemetry import brownout as tb
from dynamo_tpu_torch.telemetry import slo as tslo
from tests.test_torch_chunked import BS, C, _jax_engine, _models, _torch_engine
from tests.test_torch_engine import make_torch_engine
from tests.test_torch_frontend import MODEL, afetch, model_dir  # noqa: F401
from tests.test_torch_qos_deadlines import collect, req


# ------------------------------------------------------------------ ladder


@pytest.mark.parametrize("seed", range(4))
def test_brownout_controller_steps_as_the_reference(seed):
    rng = random.Random(seed)
    t = [0.0]
    cfg = dict(step_up_s=1.0, step_down_s=3.0)
    ch_p, ch_r = [], []
    cp = tb.BrownoutController(tb.BrownoutConfig(**cfg), now_fn=lambda: t[0],
                               on_change=lambda o, n, r: ch_p.append((o, n, r)))
    cr = jb.BrownoutController(jb.BrownoutConfig(**cfg), now_fn=lambda: t[0],
                               on_change=lambda o, n, r: ch_r.append((o, n, r)))
    for _ in range(200):
        t[0] += rng.choice((0.1, 0.5, 1.2, 3.5))
        state = rng.choice(("ok", "ok", "burning", "breached"))
        assert cp.observe(state) == cr.observe(state)
        assert cp.actions() == cr.actions()
        assert cp.status() == cr.status()
    assert ch_p == ch_r and len(ch_p) > 4


def test_brownout_controller_ladder():
    t = [0.0]
    ctrl = tb.BrownoutController(tb.BrownoutConfig(step_up_s=1.0, step_down_s=3.0),
                                 now_fn=lambda: t[0])
    changes = []
    ctrl.on_change = lambda old, new, rung: changes.append((old, new, rung))
    assert ctrl.observe("breached") == 1 and ctrl.actions()["shed_classes"] == ["bulk"]
    t[0] = 0.5
    assert ctrl.observe("breached") == 1
    t[0] = 1.1
    assert ctrl.observe("burning") == 2 and ctrl.actions()["spec_off"]
    t[0] = 2.2
    assert ctrl.observe("burning") == 3 and ctrl.actions()["chunk_cap"]
    t[0] = 3.3
    assert ctrl.observe("breached") == 4
    assert ctrl.actions()["shed_classes"] == ["bulk", "standard"]
    t[0] = 4.4
    assert ctrl.observe("breached") == 4
    t[0] = 5.0
    assert ctrl.observe("ok") == 4
    t[0] = 8.1
    assert ctrl.observe("ok") == 3
    t[0] = 11.2
    assert ctrl.observe("ok") == 2
    t[0] = 12.0
    assert ctrl.observe("burning") == 2
    t[0] = 12.3
    assert ctrl.observe("burning") == 3
    t[0] = 20.0
    assert ctrl.observe("ok") == 3
    t[0] = 23.1
    assert ctrl.observe("ok") == 2
    assert [c[:2] for c in changes] == [(0, 1), (1, 2), (2, 3), (3, 4), (4, 3), (3, 2), (2, 3), (3, 2)]
    assert ctrl.transitions == len(changes) and ctrl.status()["rung"] == "spec_off"
    off = tb.BrownoutController(tb.BrownoutConfig(enabled=False), now_fn=lambda: t[0])
    assert off.observe("breached") == 0


def test_config_rungs_and_chunk_budget_equal_the_reference(monkeypatch):
    monkeypatch.setenv("DYN_BROWNOUT_STEP_UP_S", "0.25")
    monkeypatch.setenv("DYN_BROWNOUT_MAX_LEVEL", "3")
    assert tb.BrownoutConfig.from_env() == tb.BrownoutConfig(**jb.BrownoutConfig.from_env().__dict__)
    assert tb.LADDER == jb.LADDER
    for level in range(-1, 6):
        assert tb.shed_classes_for(level) == jb.shed_classes_for(level)
        assert tb.chunk_capped(level) == jb.chunk_capped(level)
    for bs in (1, 4, 16, 32):
        for base in (0, bs, 2 * bs, 3 * bs, 512, 1024, 48 * bs):
            for cap in (False, True):
                got = qos.effective_chunk_budget(base, chunk_cap=cap, block_size=bs)
                ref = j_qos.effective_chunk_budget(base, chunk_cap=cap, block_size=bs)
                assert got % bs == 0 and (got == 0) == (base == 0)
                if ref % bs == 0:
                    assert got == ref  # the reference's value wherever it is on the grid
                else:
                    assert got == ref // bs * bs  # rounded down to the grid


# ------------------------------------------------------------------ engines


async def test_torch_brownout_rungs_hold_against_the_jax_engine():
    jcfg, jparams, _, tparams = _models()
    out = {}
    for name, engine, mod, ctx_cls in (("jax", _jax_engine(jcfg, jparams), jp, JContext),
                                       ("port", _torch_engine(tparams), tp, Context)):
        try:
            rows = []
            engine.apply_brownout(1)
            _, final = await collect(engine, req(mod, [1, 2], max_tokens=2, priority="bulk"),
                                     ctx_cls(id="shed-1"))
            rows.append((engine.stats.brownout_level, final.error, engine.stats.shed_brownout))
            _, final = await collect(engine, req(mod, [1, 2], max_tokens=2), ctx_cls())
            rows.append(final.finish_reason.value)
            full = engine._chunk_budget()
            engine.apply_brownout(2)
            rows.append((engine._spec_paused, engine._chunk_budget() == full))
            engine.apply_brownout(3)
            rows.append((engine._chunk_budget(), full, engine._chunk_tokens()))
            engine.apply_brownout(4)
            _, final = await collect(engine, req(mod, [1, 2], max_tokens=2, priority="standard"),
                                     ctx_cls())
            rows.append(final.error["code"])
            toks, final = await collect(engine, req(mod, [1, 2], max_tokens=2, priority="interactive"),
                                        ctx_cls())
            rows.append((toks, final.finish_reason.value))
            engine.apply_brownout(0)
            rows.append((engine._spec_paused, engine._chunk_budget() == full))
            _, final = await collect(engine, req(mod, [1, 2], max_tokens=2, priority="bulk"), ctx_cls())
            rows.append((final.finish_reason.value, engine.stats.brownout_level))
            out[name] = rows
        finally:
            await engine.close()
    assert out["port"] == out["jax"]
    assert out["port"][0][1]["code"] == "brownout_shed"
    assert out["port"][3] == (max(BS, 2 * C // 2), 2 * C, C // 2)


async def test_chunk_cap_halves_the_chunks_and_keeps_the_tokens():
    jcfg, jparams, _, tparams = _models()
    prompt = [int(t) for t in random.Random(3).choices(range(3, 60), k=29)]
    toks = {}
    for name, engine, mod, ctx_cls in (("jax", _jax_engine(jcfg, jparams), jp, JContext),
                                       ("port", _torch_engine(tparams, mixed_step=False), tp, Context)):
        try:
            engine.apply_brownout(3)
            toks[name], final = await collect(engine, req(mod, prompt, max_tokens=6), ctx_cls())
            assert final.finish_reason.value == "length"
            if name == "port":
                # 29 prompt tokens in chunks of C / 2: ceil(29 / 4) chunks
                assert engine.stats.chunk_steps == -(-len(prompt) // (C // 2))
                assert engine._step_chunk_tokens == C // 2
        finally:
            await engine.close()
    assert toks["port"] == toks["jax"]


async def test_spec_pause_runs_decode_steps_and_keeps_the_tokens():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dynamo_tpu.models import llama as jl
    from dynamo_tpu_torch.engine.torch_engine.weights import params_from_jax
    from tests.test_torch_spec_decode import VOCAB
    from tests.test_torch_spec_decode import _torch_engine as spec_engine

    jparams = jl.init_params(jl.LlamaConfig.tiny(vocab_size=VOCAB), jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    prompt = [3, 4, 5, 6] * 4
    got = {}
    for paused in (False, True):
        engine = spec_engine(tparams)
        try:
            if paused:
                engine.apply_brownout(2)
            got[paused], _ = await collect(engine, req(tp, prompt, max_tokens=12), Context())
            if paused:
                assert engine.stats.verify_steps == 0 and engine.stats.num_drafts == 0
                assert engine.stats.decode_steps > 0
            else:
                assert engine.stats.verify_steps > 0
        finally:
            await engine.close()
    assert got[True] == got[False]


# --------------------------------------------------------------- admission


def test_admission_decisions_equal_the_reference(monkeypatch):
    monkeypatch.setenv("DYN_ADMISSION_CLASS_FRACTIONS", "bulk=0.4,standard=0.9,bogus=1")
    for cap in (None, 3):
        port = AdmissionController(max_inflight=10)
        ref = JAdmission(max_inflight=10)
        if cap:
            port.set_capacity_fn("m", lambda: cap)
            ref.set_capacity_fn("m", lambda: cap)
        rng = random.Random(cap or 0)
        for i in range(300):
            op = rng.random()
            prio = rng.choice(("bulk", "standard", "interactive", "weird", None))
            sig = rng.choice((None, 1, 2, 3))
            if op < 0.15:
                port.release("m")
                ref.release("m")
            elif op < 0.25:
                frac = rng.random()
                port.note_prefix_heat("m", sig, frac)
                ref.note_prefix_heat("m", sig, frac)
            elif op < 0.3:
                level = rng.randint(0, 4)
                port.brownout_shed = tb.shed_classes_for(level)
                ref.brownout_shed = jb.shed_classes_for(level)
            else:
                a = port.try_acquire("m", prio or "standard", prefix_sig=sig)
                b = ref.try_acquire("m", prio or "standard", prefix_sig=sig)
                assert (a is None) == (b is None), i
            assert port.inflight("m") == ref.inflight("m")
            assert port.shed_by_class == ref.shed_by_class
        for prio in ("bulk", "standard", "interactive"):
            assert port.class_watermark("m", prio) == ref.class_watermark("m", prio)


def test_admission_class_watermarks():
    adm = AdmissionController(max_inflight=10)
    assert [adm.class_watermark("m", c) for c in ("bulk", "standard", "interactive")] == [5, 8, 10]
    for _ in range(5):
        assert adm.try_acquire("m", "bulk") is None
    assert adm.try_acquire("m", "bulk") is not None
    for _ in range(3):
        assert adm.try_acquire("m", "standard") is None
    assert adm.try_acquire("m", "standard") is not None
    assert adm.try_acquire("m", "interactive") is None
    assert adm.try_acquire("m", "interactive") is None
    assert adm.try_acquire("m", "interactive") is not None
    assert adm.shed_by_class == {"bulk": 1, "standard": 1, "interactive": 1}
    adm2 = AdmissionController(max_inflight=10)
    adm2.brownout_shed = tb.shed_classes_for(1)
    assert adm2.try_acquire("m", "bulk") is not None
    assert adm2.try_acquire("m", "standard") is None
    adm2.brownout_shed = tb.shed_classes_for(4)
    assert adm2.try_acquire("m", "standard") is not None
    assert adm2.try_acquire("m", "interactive") is None


def test_admission_retry_after_uses_drain_rate():
    adm = AdmissionController(max_inflight=2)
    adm.retry_after_s = 7.0
    assert adm.try_acquire("m") is None and adm.try_acquire("m") is None
    assert adm.try_acquire("m") == 7.0
    now = time.monotonic()
    for i in range(40):
        adm.drain.note(now=now - 4.0 + 0.1 * i)
    hint = adm.try_acquire("m")
    assert hint is not None and hint < 7.0


# -------------------------------------------------------------------- HTTP


async def _echo_service(model_dir, drt=None):
    mdc = ModelDeploymentCard.from_model_dir(model_dir, MODEL)
    return await run_http(EngineConfig.static_(EchoEngineCore(), mdc), host="127.0.0.1", port=0,
                          drt=drt)


def _chat(prompt_words=30, max_tokens=30):
    return {"model": MODEL, "messages": [{"role": "user", "content": " ".join(["a"] * prompt_words)}],
            "stream": False, "max_tokens": max_tokens}


async def test_http_priority_header_and_class_sheds(model_dir, monkeypatch):
    monkeypatch.setenv("DYN_TOKEN_ECHO_DELAY_MS", "5")
    svc = await _echo_service(model_dir)
    try:
        svc.admission.max_inflight = 4  # bulk cap 2, interactive cap 4
        svc.admission._capacity_fns.clear()

        async def one(priority, via_header):
            body = _chat()
            headers = None
            if via_header:
                headers = {"x-dyn-priority": priority}
            else:
                body["ext"] = {"priority": priority}
            st, hdrs, _ = await afetch(svc.port, "POST", "/v1/chat/completions", body, headers=headers)
            return st, hdrs

        results = await asyncio.gather(*(one("bulk", i % 2 == 0) for i in range(8)))
        statuses = [st for st, _ in results]
        assert statuses.count(429) >= 4, statuses
        assert all("retry-after" in h for st, h in results if st == 429)
        _, _, text = await afetch(svc.port, "GET", "/metrics")
        assert ('dyn_llm_class_requests_shed_total{model="tiny",priority="bulk",reason="watermark"}'
                in text.decode())
        st, _ = await one("interactive", True)
        assert st == 200
    finally:
        await svc.close()


async def test_http_brownout_engages_and_disengages(model_dir, monkeypatch):
    for k, v in (("DYN_SLO_TTFT_MS", "10"), ("DYN_SLO_FAST_WINDOW_S", "0.6"),
                 ("DYN_SLO_SLOW_WINDOW_S", "1.2"), ("DYN_SLO_TICK_S", "0.05"),
                 ("DYN_BROWNOUT_STEP_UP_S", "0.05"), ("DYN_BROWNOUT_STEP_DOWN_S", "0.2")):
        monkeypatch.setenv(k, v)
    svc = await _echo_service(model_dir)
    events = []
    svc.brownout_publisher = events.append
    hist = svc.metrics.phase_hist_for(MODEL)
    try:
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and svc.brownout.level < 3:
            hist.observe("ttft", 500.0)
            await asyncio.sleep(0.05)
        st, _, body = await afetch(svc.port, "GET", "/debug/slo")
        slo = json.loads(body)
        assert slo["brownout"]["level"] >= 3
        assert slo["brownout"]["spec_off"] and slo["brownout"]["chunk_cap"]
        st, hdrs, _ = await afetch(svc.port, "POST", "/v1/chat/completions", _chat(2, 2),
                                   headers={"x-dyn-priority": "bulk"})
        assert st == 429 and "retry-after" in hdrs
        _, _, text = await afetch(svc.port, "GET", "/metrics")
        text = text.decode()
        assert "dyn_llm_brownout_level 3.0" in text or "dyn_llm_brownout_level 4.0" in text
        assert 'reason="brownout"' in text
        ups = [e for e in events if e["level"] > e["old_level"]]
        assert [e["rung"] for e in ups[:3]] == ["shed_bulk", "spec_off", "chunk_cap"]
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and svc.brownout.level > 0:
            await asyncio.sleep(0.1)
        assert svc.brownout.level == 0, svc.brownout.status()
        assert len([e for e in events if e["level"] < e["old_level"]]) >= 3
        st, _, _ = await afetch(svc.port, "POST", "/v1/chat/completions", _chat(2, 2),
                                headers={"x-dyn-priority": "bulk"})
        assert st == 200
    finally:
        await svc.close()


async def test_fleet_slo_event_drives_frontend_brownout(model_dir, monkeypatch):
    monkeypatch.setenv("DYN_BROWNOUT_STEP_UP_S", "0.05")
    monkeypatch.setenv("DYN_BROWNOUT_STEP_DOWN_S", "0.2")
    drt = await DistributedRuntime.detached()
    svc = None
    try:
        svc = await _echo_service(model_dir, drt=drt)
        ns = drt.namespace(drt.config.namespace)
        await asyncio.sleep(0.1)  # the subscription is up
        await ns.publish_event(tslo.SLO_STATUS_SUBJECT, {"old": "ok", "new": "breached"})
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and svc.brownout.level < 1:
            await asyncio.sleep(0.05)
        assert svc.brownout.level >= 1 and svc._remote_slo_state == "breached"
        await ns.publish_event(tslo.SLO_STATUS_SUBJECT, {"old": "breached", "new": "ok"})
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and svc.brownout.level > 0:
            svc.note_remote_slo("ok")  # the ladder steps on observations
            await asyncio.sleep(0.1)
        assert svc.brownout.level == 0, svc.brownout.status()
    finally:
        if svc is not None:
            await svc.close()
        await drt.close()


async def test_http_admission_control_sheds_with_429(model_dir, monkeypatch):
    monkeypatch.setenv("DYN_TOKEN_ECHO_DELAY_MS", "5")
    svc = await _echo_service(model_dir)
    try:
        svc.admission.max_inflight = 3
        svc.admission._capacity_fns.clear()
        results = await asyncio.gather(*(afetch(svc.port, "POST", "/v1/chat/completions", _chat())
                                         for _ in range(9)))
        statuses = [st for st, _, _ in results]
        shed = [h for st, h, _ in results if st == 429]
        assert shed and statuses.count(200) >= 3, statuses
        assert all("retry-after" in h for h in shed)
        for st, _, body in results:
            doc = json.loads(body)
            if st == 200:
                assert doc["choices"][0]["message"]["content"]
            else:
                assert doc["error"]["type"] == "overloaded"
        _, _, text = await afetch(svc.port, "GET", "/metrics")
        line = [ln for ln in text.decode().splitlines()
                if ln.startswith('dyn_llm_requests_shed_total{model="tiny"}')][0]
        assert float(line.rsplit(" ", 1)[1]) == len(shed)
        st, _, _ = await afetch(svc.port, "POST", "/v1/chat/completions", _chat())
        assert st == 200
    finally:
        await svc.close()


# ------------------------------------------------------------ C11 (repaired)


async def test_ladders_step_back_down_without_a_local_objective(model_dir, monkeypatch):
    """A fleet breach then its ok, with no local SLO objective: the port's
    frontend and worker ladders step back to 0 on their ticks. The
    reference's frontend ticks its ladder only with an objective, so after
    the remote ok it stays at its rung (ROADMAP C11)."""
    from dynamo_tpu.http.service import HttpService as JHttpService
    from dynamo_tpu_torch.entrypoint.inputs import run_endpoint
    from dynamo_tpu_torch.http.service import HttpService

    for k in ("DYN_SLO_TTFT_MS", "DYN_SLO_ITL_MS", "DYN_SLO_CONFIG"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("DYN_BROWNOUT_STEP_UP_S", "0.05")
    monkeypatch.setenv("DYN_BROWNOUT_STEP_DOWN_S", "0.1")
    monkeypatch.setenv("DYN_SLO_TICK_S", "0.05")
    port, ref = HttpService(host="127.0.0.1", port=0), JHttpService(host="127.0.0.1", port=0)
    drt = await DistributedRuntime.detached()
    engine = make_torch_engine()
    mdc = ModelDeploymentCard.from_model_dir(model_dir, MODEL)
    worker = asyncio.ensure_future(run_endpoint(drt, EngineConfig.static_(engine, mdc),
                                                "dyn://ops.backend.generate"))
    try:
        await port.start()
        await ref.start()
        await asyncio.sleep(0.3)  # the worker subscribed to slo-status
        ns = drt.namespace("ops")
        for svc in (port, ref):
            svc.note_remote_slo("breached")
        await ns.publish_event(tslo.SLO_STATUS_SUBJECT, {"old": "ok", "new": "breached"})
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and min(port.brownout.level, engine._brownout_level) < 3:
            ref.note_remote_slo("breached")  # the reference steps on these calls only
            await asyncio.sleep(0.05)
        assert port.brownout.level >= 3 and engine._brownout_level >= 3 and ref.brownout.level >= 1
        for svc in (port, ref):
            svc.note_remote_slo("ok")
        await ns.publish_event(tslo.SLO_STATUS_SUBJECT, {"old": "breached", "new": "ok"})
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and max(port.brownout.level, engine._brownout_level) > 0:
            await asyncio.sleep(0.05)
        assert port.brownout.level == 0 and engine._brownout_level == 0
        assert ref.brownout.level >= 1  # the reference's ladder is stuck at its rung
    finally:
        await port.close()
        await ref.close()
        worker.cancel()
        await asyncio.gather(worker, return_exceptions=True)
        await drt.close()
        await engine.close()
