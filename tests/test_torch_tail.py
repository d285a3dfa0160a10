"""The port's tail-tolerance plane against the JAX package's, on the CPU.

- ``telemetry/health.py``: ``HealthScorer`` gives the same scores,
  penalties, ejections, restores and probation trickle as the reference's
  on the same latency and self-reported-histogram stream under one fake
  clock; ``HedgeController`` the same delays, grants and outcomes; the
  reference's unit cases run on the port (``tests/test_tail.py``).
- Routing composition: ``Client._eligible`` and ``KvScheduler`` (route set
  and deweighting) decide as the reference's with the same scorer state.
- End to end over two tiny ``TorchEngine`` workers, one made slow: a hedged
  interactive stream equals its unhedged twin (greedy and seeded), the
  hedge wins, and both engines free every block (the loser's lane and KV
  are released); a zero budget denies every hedge; with ``DYN_HEDGE`` unset
  no hedge runs.
- The twin of ``test_ejection_diverts_traffic_e2e`` on the port's clock
  seam (``runtime/clock.py``): the process clock moves only by each
  worker's first-token latency (50 ms, the straggler's 1 s), so every
  latency the scorer sees is known, not raced against the wall, and the
  straggler (known by its instance id) is ejected and then gets no
  traffic.
"""

import asyncio
import random
import time

import pytest

from dynamo_tpu.kv_router.indexer import OverlapScores as JOverlapScores
from dynamo_tpu.kv_router.scheduler import KvScheduler as JKvScheduler
from dynamo_tpu.telemetry import health as jh
from dynamo_tpu.telemetry.histogram import PhaseHistograms as JPhaseHistograms
from dynamo_tpu_torch.discovery import RemoteEngine
from dynamo_tpu_torch.kv_router.indexer import OverlapScores
from dynamo_tpu_torch.kv_router.scheduler import KvScheduler
from dynamo_tpu_torch.pipeline.context import Context
from dynamo_tpu_torch.pipeline.router import PushRouter, RouterMode
from dynamo_tpu_torch.protocols import common as tp
from dynamo_tpu_torch.runtime import clock as dclock
from dynamo_tpu_torch.runtime.component import Client
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.telemetry import health as th
from dynamo_tpu_torch.telemetry.histogram import PhaseHistograms
from tests.test_torch_engine import make_torch_engine
from tests.test_torch_kv_router import _serve_worker
from dynamo_tpu_torch.kv_router import publisher as t_publisher


class _Clock:
    def __init__(self) -> None:
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


CFG = dict(eject_ratio=3.0, eject_intervals=3, recover_ratio=1.5, recover_intervals=3,
           min_healthy=1, probe_every=4, deweight_ratio=1.5, alpha=0.5, stale_after_s=10.0,
           forget_after_s=1000.0)


def _cfg(mod=th, **kw):
    return mod.HealthConfig(**{**CFG, **kw})


def _feed(scorer, latencies_ms, signal="first_frame"):
    for wid, ms in latencies_ms.items():
        scorer.record(wid, signal, ms)


# ---------------------------------------------------------- against the reference


@pytest.mark.parametrize("seed", range(4))
def test_health_scorer_scores_and_ejects_as_the_reference(seed):
    rng = random.Random(seed)
    clock = _Clock()
    ev_p, ev_r = [], []
    sp = th.HealthScorer(_cfg(alpha=rng.choice((0.4, 0.8, 1.0)), min_healthy=rng.choice((1, 2))),
                         now_fn=clock, on_eject=lambda w, c: ev_p.append(("e", w, c)),
                         on_restore=lambda w: ev_p.append(("r", w)))
    sr = jh.HealthScorer(_cfg(jh, alpha=sp.config.alpha, min_healthy=sp.config.min_healthy),
                         now_fn=clock, on_eject=lambda w, c: ev_r.append(("e", w, c)),
                         on_restore=lambda w: ev_r.append(("r", w)))
    slow = {wid: rng.choice((1.0, 1.0, 2.0, 6.0)) for wid in (1, 2, 3, 4)}
    cum_p = {w: PhaseHistograms() for w in slow}
    cum_r = {w: JPhaseHistograms() for w in slow}
    for tick in range(40):
        if tick == 20:
            slow = {w: 1.0 for w in slow}  # everyone recovers
        for wid, f in slow.items():
            if rng.random() < 0.15:
                continue  # a missed scrape ages the score
            for sig in ("dispatch", "first_frame", "inter_frame"):
                ms = rng.uniform(80, 120) * f
                sp.record(wid, sig, ms)
                sr.record(wid, sig, ms)
            for _ in range(rng.randint(0, 5)):
                v = rng.uniform(50, 150) * f
                cum_p[wid].observe("ttft", v)
                cum_r[wid].observe("ttft", v)
                cum_p[wid].observe("inter_token", v / 10)
                cum_r[wid].observe("inter_token", v / 10)
            sp.observe_worker_hists(wid, cum_p[wid])
            sr.observe_worker_hists(wid, cum_r[wid])
        clock.t += rng.choice((0.5, 1.0, 4.0))
        sp.tick()
        sr.tick()
        assert sp.scores() == sr.scores()
        assert sp.ejected() == sr.ejected()
        assert {w: sp.penalty(w) for w in slow} == {w: sr.penalty(w) for w in slow}
        assert [sorted(sp.routing_excluded()) for _ in range(3)] == [
            sorted(sr.routing_excluded()) for _ in range(3)]
        assert sp.route_set([1, 2, 3, 4]) == sr.route_set([1, 2, 3, 4])
    assert ev_p == ev_r
    assert (sp.ejections_total, sp.restores_total) == (sr.ejections_total, sr.restores_total)


def test_hedge_controller_decides_as_the_reference(monkeypatch):
    rng = random.Random(5)
    hp = th.HedgeController(budget_fraction=0.1, min_delay_ms=7.0)
    hr = jh.HedgeController(budget_fraction=0.1, min_delay_ms=7.0)
    for _ in range(300):
        op = rng.random()
        if op < 0.4:
            hp.note_dispatch()
            hr.note_dispatch()
        elif op < 0.7:
            ms = rng.uniform(1, 200)
            hp.note_first_frame(ms)
            hr.note_first_frame(ms)
        elif op < 0.85:
            assert hp.try_acquire() == hr.try_acquire()
        else:
            out, w = rng.choice(("won", "lost")), rng.randint(0, 3)
            hp.note_outcome(out, wasted_tokens=w)
            hr.note_outcome(out, wasted_tokens=w)
        assert hp.delay_ms() == hr.delay_ms()
    assert hp.outcomes == hr.outcomes and hp.wasted_tokens == hr.wasted_tokens
    assert hp.status() == hr.status()
    for env in ("1", "0", "true", ""):
        monkeypatch.setenv("DYN_HEDGE", env)
        assert th.hedge_enabled() == jh.hedge_enabled()


def test_schedulers_route_and_deweight_as_the_reference():
    clock = _Clock()
    sp = th.HealthScorer(_cfg(alpha=1.0, probe_every=10**9), now_fn=clock)
    sr = jh.HealthScorer(_cfg(jh, alpha=1.0, probe_every=10**9), now_fn=clock)
    for _ in range(4):
        for s in (sp, sr):
            _feed(s, {1: 100.0, 2: 600.0, 3: 250.0, 4: 100.0, 5: 100.0})
        clock.t += 1.0
        sp.tick()
        sr.tick()
    assert sp.ejected() == sr.ejected() == {2}
    port, ref = KvScheduler(block_size=4), JKvScheduler(block_size=4)
    for sched in (port, ref):  # argmin, ties broken by one seeded draw
        sched.selector.config.router_temperature = 0.0
        sched.selector.rng = random.Random(1)
    port.health, ref.health = sp, sr
    assert sp.penalty(3) == sr.penalty(3) > 1.0  # a suspect, deweighted
    port.update_workers([1, 2, 3, 4, 5])
    ref.update_workers([1, 2, 3, 4, 5])
    for i in range(10):
        toks = list(range(i, i + 8))
        ov = {3: min(i, 2), 4: i % 2}
        a = port.schedule(toks, OverlapScores(scores=dict(ov)), request_id=f"r{i}")
        b = ref.schedule(toks, JOverlapScores(scores=dict(ov)), request_id=f"r{i}")
        assert a.worker_id == b.worker_id != 2
    assert port.hit_stats == ref.hit_stats and port.hit_rate == ref.hit_rate


# ------------------------------------------------------------- reference cases


def test_health_score_ratio_vs_fleet_median():
    clock = _Clock()
    s = th.HealthScorer(_cfg(alpha=1.0), now_fn=clock)
    for _ in range(4):
        _feed(s, {1: 100.0, 2: 100.0, 3: 110.0, 4: 500.0})
        clock.t += 1.0
        s.tick()
    assert 4.0 < s.score(4) < 6.0
    assert all(s.score(w) < 1.5 for w in (1, 2, 3))


def test_ejection_enter_probation_reentry():
    clock = _Clock()
    events = []
    s = th.HealthScorer(_cfg(alpha=1.0), now_fn=clock,
                        on_eject=lambda wid, cause: events.append(("eject", wid, cause)),
                        on_restore=lambda wid: events.append(("restore", wid)))
    for _ in range(2):
        _feed(s, {1: 100.0, 2: 100.0, 3: 100.0, 4: 500.0})
        clock.t += 1.0
        s.tick()
    assert s.ejected() == set()
    _feed(s, {1: 100.0, 2: 100.0, 3: 100.0, 4: 500.0})
    clock.t += 1.0
    s.tick()
    assert s.ejected() == {4} and events == [("eject", 4, "first_frame")]
    excluded = [4 in s.routing_excluded() for _ in range(8)]
    assert excluded.count(False) == 2 and excluded.count(True) == 6
    for i in range(20):
        _feed(s, {1: 100.0, 2: 100.0, 3: 100.0, 4: 105.0})
        clock.t += 1.0
        s.tick()
        if not s.ejected():
            break
    assert i >= 2 and s.ejected() == set() and s.workers[4].state == th.HEALTHY
    assert s.restores_total == 1 and events[-1] == ("restore", 4)


def test_min_healthy_floor_blocks_ejection():
    clock = _Clock()
    s = th.HealthScorer(_cfg(alpha=1.0, min_healthy=2), now_fn=clock)
    for _ in range(6):
        _feed(s, {1: 100.0, 2: 500.0})
        clock.t += 1.0
        s.tick()
    assert s.score(2) > 3.0 and s.ejected() == set()


def test_client_eligible_composes_ejection_with_exclusions():
    clock = _Clock()
    s = th.HealthScorer(_cfg(alpha=1.0, probe_every=10**9), now_fn=clock)
    for _ in range(4):
        _feed(s, {1: 100.0, 2: 100.0, 3: 500.0})
        clock.t += 1.0
        s.tick()
    assert s.ejected() == {3}
    from dynamo_tpu.runtime.component import Client as JClient

    c, jc = Client.__new__(Client), JClient.__new__(JClient)
    for client in (c, jc):
        client.instances = {1: object(), 2: object(), 3: object()}
        client.health = s
    assert c._eligible({1}) == jc._eligible({1}) == [2]
    # 1 and 2 just died, 3 is ejected but alive: the port falls back to the
    # ejected worker; the reference hands back the dead ones too (C13)
    assert c._eligible({1, 2}) == [3]
    assert set(jc._eligible({1, 2})) == {1, 2, 3}
    assert set(c._eligible({1, 2, 3})) == {1, 2, 3}
    c.health = None
    assert c._eligible({1}) == [2, 3]


def test_hedge_budget_and_delay():
    h = th.HedgeController(budget_fraction=0.05, min_delay_ms=7.0)
    assert h.delay_ms() == 7.0
    for i in range(100):
        h.note_first_frame(float(i + 1))
    assert 90.0 <= h.delay_ms() <= 100.0
    for _ in range(100):
        h.note_dispatch()
    assert sum(1 for _ in range(8) if h.try_acquire()) == 5
    assert h.outcomes["budget_denied"] == 3


# ------------------------------------------------------------------- e2e


def _req(prompt, max_tokens, priority="interactive", seed=None):
    sampling = tp.SamplingOptions(greedy=True) if seed is None else tp.SamplingOptions(
        temperature=0.9, top_k=8, seed=seed)
    r = tp.PreprocessedRequest(token_ids=list(prompt), sampling=sampling,
                               stop=tp.StopConditions(max_tokens=max_tokens, ignore_eos=True))
    r.extra["priority"] = priority
    return r


async def _collect(remote, req):
    toks, final = [], None
    async for out in remote(req, Context()):
        toks.extend(out.token_ids)
        if out.finish_reason is not None:
            final = out
            break
    return toks, final


def _delayed(engine, seconds: float):
    """Each device call of ``engine`` waits ``seconds`` first."""
    device = engine._device
    engine.device_calls = 0

    async def _slow(fn, label):
        engine.device_calls += 1
        await asyncio.sleep(seconds)
        return await device(fn, label)

    engine._device = _slow
    return engine


async def _fleet(ns, engines):
    drts, services = [], []
    for engine in engines:
        drt = await DistributedRuntime.detached()
        _, svc = await _serve_worker(drt, engine, t_publisher, namespace=ns, component="worker")
        drts.append(drt)
        services.append(svc)
    front = await DistributedRuntime.detached()
    client = await front.namespace(ns).component("worker").endpoint("generate").client()
    await client.wait_for_instances(5.0)
    assert len(client.instance_ids()) == len(engines)
    return drts, services, front, client


async def _settled(engines, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(e.allocator.free_count == e.config.num_blocks - 1 and not e.waiting
               and all(s is None for s in e.slots) for e in engines):
            return True
        await asyncio.sleep(0.05)
    return False


async def test_hedged_streams_equal_unhedged_and_free_the_losers_blocks(monkeypatch):
    monkeypatch.setenv("DYN_HEDGE", "1")
    engines = [_delayed(make_torch_engine(), 0.3), make_torch_engine()]
    drts, services, front, client = await _fleet("tailhedge", engines)
    try:
        plain = RemoteEngine(PushRouter(client, RouterMode.ROUND_ROBIN))
        hedger = th.HedgeController(budget_fraction=1.0, min_delay_ms=20.0)
        hedged = RemoteEngine(PushRouter(client, RouterMode.ROUND_ROBIN), hedger=hedger)
        assert hedged._hedge and not plain._hedge
        for seed in (None, 4242):
            prompt = [7, 11, 13, 17, 19]
            want, _ = await _collect(plain, _req(prompt, 8, seed=seed))
            assert len(want) == 8
            for _ in range(4):  # round robin puts half the primaries on the slow worker
                got, final = await _collect(hedged, _req(prompt, 8, seed=seed))
                assert final.error is None and got == want
        assert hedger.outcomes["won"] >= 2, hedger.status()
        assert hedger.hedges <= hedger.dispatches
        assert await _settled(engines), [e.allocator.free_count for e in engines]
    finally:
        await client.close()
        for drt in drts + [front]:
            await drt.close()
        for e in engines:
            await e.close()


async def test_hedge_budget_denied_and_disabled(monkeypatch):
    engines = [_delayed(make_torch_engine(), 0.1), make_torch_engine()]
    drts, services, front, client = await _fleet("tailbudget", engines)
    try:
        monkeypatch.setenv("DYN_HEDGE", "1")
        hedger = th.HedgeController(budget_fraction=0.0, min_delay_ms=5.0)
        hedger.hedges = 2  # the burst floor spent: a zero rate
        remote = RemoteEngine(PushRouter(client, RouterMode.ROUND_ROBIN), hedger=hedger)
        for _ in range(2):
            toks, final = await _collect(remote, _req([1, 2, 3], 3))
            assert final.error is None and len(toks) == 3
        assert hedger.outcomes["budget_denied"] >= 1 and hedger.outcomes["won"] == 0
        monkeypatch.setenv("DYN_HEDGE", "0")
        off = th.HedgeController(budget_fraction=1.0, min_delay_ms=1.0)
        remote = RemoteEngine(PushRouter(client, RouterMode.ROUND_ROBIN), hedger=off)
        assert not remote._hedge
        for _ in range(2):
            toks, final = await _collect(remote, _req([1, 2, 3], 3))
            assert final.error is None
        assert off.hedges == 0 and sum(off.outcomes.values()) == 0
        assert await _settled(engines)
    finally:
        await client.close()
        for drt in drts + [front]:
            await drt.close()
        for e in engines:
            await e.close()


class _StepClock:
    """A process clock that moves only when told: each worker's first token
    advances it by that worker's latency, so every latency the frontend
    measures is known exactly, whatever the machine's load (the wall clock
    keeps epoch time for deadlines)."""

    def __init__(self) -> None:
        self.t = 1000.0

    def now(self) -> float:
        return self.t

    def wall(self) -> float:
        return time.time()


def _first_token_after(engine, clock: _StepClock, seconds: float) -> None:
    """``engine``'s first token of each stream comes ``seconds`` of the
    clock after its request; ``engine.streams`` counts its streams."""
    generate = engine.generate
    engine.streams = 0

    async def timed(request, context):
        engine.streams += 1
        first = True
        async for out in generate(request, context):
            if first and out.token_ids:
                clock.t += seconds
                first = False
            yield out

    engine.generate = timed


@pytest.mark.parametrize("run", range(3))
async def test_ejection_diverts_traffic_e2e(run):
    clock = _StepClock()
    dclock.set_clock(clock)
    engines = [make_torch_engine() for _ in range(3)]
    for k, e in enumerate(engines):  # the middle worker 20x slower to its first token
        _first_token_after(e, clock, 1.0 if k == 1 else 0.05)
    slow = engines[1]
    drts, services, front, client = await _fleet(f"taileject{run}", engines)
    try:
        slow_wid = services[1].instance_id
        scorer = th.HealthScorer(_cfg(alpha=0.8, eject_intervals=2, probe_every=10**9))
        client.health = scorer
        remote = RemoteEngine(PushRouter(client, RouterMode.ROUND_ROBIN), health=scorer)
        for _ in range(6):  # round robin: two requests on each worker
            _, final = await _collect(remote, _req([1, 2, 3, 4], 4, priority="standard"))
            assert final.error is None
        for _ in range(2):
            clock.t += 1.0
            scorer.tick()
        assert scorer.ejected() == {slow_wid}, scorer.status()
        assert scorer.score(slow_wid) > 10 and all(
            scorer.score(w) == 1.0 for w in client.instance_ids() if w != slow_wid)
        before = slow.streams
        for _ in range(6):
            _, final = await _collect(remote, _req([1, 2, 3, 4], 4, priority="standard"))
            assert final.error is None
        assert slow.streams == before
        assert await _settled(engines)
    finally:
        dclock.reset_clock()
        await client.close()
        for drt in drts + [front]:
            await drt.close()
        for e in engines:
            await e.close()
