"""The port's metrics component against the JAX package's, on the CPU.

- ``runtime/http_server.py``: ``/live``, ``/health`` (200, then 503 with a
  failing check), ``/metrics`` and an added route (twin of
  tests/test_metrics_component.py::test_system_status_server).
- Both packages' ``MetricsComponent`` scrape the same two workers (the
  port's ``MockWorkerMetrics`` snapshots, published fixed) through one
  fabric: their ``/metrics`` parse to the same families (name, type, help,
  label sets) with the same values, save the process's own clocks, and the
  merged phase histograms' buckets are the sums of the workers' buckets.
- The twin of test_metrics_component.py's mock-worker scrape (slots,
  blocks, hit-rate events, counters, spec acceptance, phase families).
- ``GET /debug/goodput``: the fleet merge of three different ledgers equals
  their direct merge (twin of test_goodput.py's fleet case), with the
  per-worker views beside it; ``MockWorkerMetrics`` publishes the whole
  goodput surface.
- The planner and rolling-upgrade families render from their fabric keys
  as the reference's family functions render the same status, and empty
  without.
- ``python -m dynamo_tpu_torch.components.metrics --mock-worker`` serves
  ``/metrics`` against a fabric server with no torch in the process.
"""

import asyncio
import json
import math
import os
import random
import signal
import subprocess
import sys
import time

import pytest
from prometheus_client import CollectorRegistry as JRegistry
from prometheus_client import generate_latest as j_generate

from dynamo_tpu.components import metrics as jcm
from dynamo_tpu.runtime.protocols import EndpointId as JEndpointId
from dynamo_tpu.telemetry import provenance as jprov
from dynamo_tpu_torch.components import metrics as cm
from dynamo_tpu_torch.fabric import FabricServer, mpack
from dynamo_tpu_torch.kv_router import KV_HIT_RATE_SUBJECT
from dynamo_tpu_torch.kv_router.protocols import ForwardPassMetrics
from dynamo_tpu_torch.kv_router.publisher import WorkerMetricsPublisher
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.http_server import SystemStatusServer
from dynamo_tpu_torch.runtime.prom import CollectorRegistry, generate_latest
from dynamo_tpu_torch.runtime.protocols import EndpointId
from dynamo_tpu_torch.telemetry import provenance as tprov
from dynamo_tpu_torch.telemetry.goodput import WASTE_CAUSES, GoodputLedger, GoodputStats
from dynamo_tpu_torch.telemetry.histogram import QUANTILE_REL_ERROR, PhaseHistograms
from tests.test_torch_distributed import jax_drt, port_drt
from tests.test_torch_frontend import afetch
from tests.test_torch_metrics import parsed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# what differs between two processes scraping the same fleet: their uptimes,
# and the health scores, an EWMA over each process's own count of scrapes
# (test_torch_tail.py holds the scorers to each other on the same ticks)
PROCESS_OWN = {"dyn_runtime_uptime_seconds", "dyn_llm_worker_health_score"}


async def test_system_status_server_with_an_added_route():
    srv = SystemStatusServer(port=0)
    healthy = True

    async def check() -> bool:
        return healthy

    async def extra():
        return 200, b'{"ok": true}', "application/json"

    srv.add_health_check("engine", check)
    srv.add_route("/debug/extra", extra)
    port = await srv.start()
    try:
        assert (await afetch(port, "GET", "/live"))[0] == 200
        status, _, body = await afetch(port, "GET", "/health")
        assert status == 200 and json.loads(body)["checks"] == {"engine": True}
        healthy = False
        assert (await afetch(port, "GET", "/health"))[0] == 503
        assert b"dyn_runtime_uptime_seconds" in (await afetch(port, "GET", "/metrics"))[2]
        assert json.loads((await afetch(port, "GET", "/debug/extra"))[2]) == {"ok": True}
        assert (await afetch(port, "GET", "/nope"))[0] == 404
    finally:
        await srv.close()


class _Ep:
    """The little of an Endpoint MockWorkerMetrics reads."""

    def __init__(self, component, eid):
        self.component, self.id = component, eid


def _snapshots(component, eid) -> list[ForwardPassMetrics]:
    """Two workers' rich load metrics: MockWorkerMetrics snapshots."""
    out = []
    for iid, slow in ((0x11, 1.0), (0x22, 3.0)):
        mock = cm.MockWorkerMetrics(_Ep(component, eid), instance_id=iid, total_blocks=512,
                                    slow_factor=slow)
        for _ in range(7):
            snap = mock.snapshot()
        out.append(snap)
    return out


async def test_both_components_render_the_same_fleet():
    for mod in (tprov, jprov):  # each process exports its own ledger
        mod.reset(proc="metrics")
    server = FabricServer("127.0.0.1", 0)
    await server.start()
    tdrt, jdrt = await port_drt(server.addr), await jax_drt(server.addr)
    try:
        comp = tdrt.namespace("mc").component("backend")
        eid = EndpointId("mc", "backend", "generate")
        snaps = _snapshots(comp, eid)
        pubs = []
        for iid, snap in zip((0x11, 0x22), snaps):
            pub = WorkerMetricsPublisher(comp, eid, iid, interval_s=0.05)
            pub.publish(snap)
            await pub.start()
            pubs.append(pub)
        tcomp = cm.MetricsComponent(comp, eid, poll_interval=0.05, port=0)
        jcomp = jcm.MetricsComponent(jdrt.namespace("mc").component("backend"),
                                     JEndpointId("mc", "backend", "generate"),
                                     poll_interval=0.05, port=0)
        await tcomp.start()
        await jcomp.start()
        for _ in range(200):
            if all(c.last is not None and c.last.worker_stats.request_total_slots == 32
                   for c in (tcomp, jcomp)):
                break
            await asyncio.sleep(0.05)
        await asyncio.sleep(0.2)
        port = parsed(generate_latest(tcomp.registry).decode())
        ref = parsed(j_generate(jcomp.registry).decode())
        await tcomp.close()
        await jcomp.close()
        for pub in pubs:
            await pub.stop()
    finally:
        await tdrt.close()
        await jdrt.close()
        await server.close()
    assert set(port) == set(ref)
    for name in set(port) - PROCESS_OWN:
        assert port[name] == ref[name], name
    for name in PROCESS_OWN:  # the same type, help and series
        assert port[name][:2] == ref[name][:2]
        assert [smp[:2] for smp in port[name][2]] == [smp[:2] for smp in ref[name][2]]
    assert port["dyn_llm_worker_count"][2][0][2] == 2.0
    # the fleet histogram's buckets are the sums of the workers' buckets
    merged = PhaseHistograms()
    for snap in snaps:
        merged.merge(snap.phase_histograms)
    h = merged.phases["ttft"]
    inf = [s for s in port["dyn_llm_phase_duration_seconds"][2]
           if s[0].endswith("_count") and dict(s[1])["phase"] == "ttft"]
    assert inf[0][2] == h.count == sum(s.phase_histograms.phases["ttft"].count for s in snaps)
    buckets = sorted((float(dict(lbl)["le"]), v) for n, lbl, v in port["dyn_llm_phase_duration_seconds"][2]
                     if n.endswith("_bucket") and dict(lbl)["phase"] == "ttft")
    for idx, (le, v) in zip(cm._EXPORT_IDX, buckets):
        assert v == sum(h.counts[: idx + 1])


async def test_the_component_scrapes_a_mock_worker():
    drt = await DistributedRuntime.detached()
    try:
        ns = drt.namespace("metrics-test")
        comp = ns.component("backend")
        eid = EndpointId("metrics-test", "backend", "generate")
        mock = cm.MockWorkerMetrics(comp.endpoint("generate"), instance_id=7, total_blocks=512)
        await mock.start()
        metrics = cm.MetricsComponent(comp, eid, poll_interval=0.05, port=0)
        port = await metrics.start()
        for overlap in (2, 4):
            await ns.publish_event(KV_HIT_RATE_SUBJECT,
                                   {"worker_id": 7, "isl_blocks": 8, "overlap_blocks": overlap})
        for _ in range(100):
            if (metrics.last is not None and metrics.last.kv_stats.kv_total_blocks
                    and metrics.last.goodput is not None):
                break
            await asyncio.sleep(0.05)
        assert metrics.last.kv_stats.kv_total_blocks == 512
        assert metrics.last.worker_stats.request_total_slots == 16
        text = (await afetch(port, "GET", "/metrics"))[2].decode()
        assert "dyn_llm_kv_blocks_capacity 512.0" in text
        assert "dyn_llm_worker_count 1.0" in text
        assert "dyn_llm_kv_hit_rate_events_total 2.0" in text
        assert "dyn_llm_kv_hit_rate_cumulative 0.375" in text
        assert "# TYPE dyn_llm_deadline_exceeded_total counter" in text
        assert "# TYPE dyn_llm_kv_wire_tx_bytes_total counter" in text
        assert "dyn_llm_spec_decode_acceptance_rate 0.75" in text
        assert 'dyn_llm_phase_duration_seconds_bucket{le="+Inf",phase="ttft"}' in text
        assert 'dyn_llm_phase_latency_seconds{phase="ttft",quantile="p95"}' in text
        assert "# TYPE dyn_llm_mfu_decode_est gauge" in text
        # the mock worker's whole goodput surface
        gp = metrics.last.goodput
        assert gp.steps_total > 0 and gp.step_hists.phases["decode"].count > 0
        assert gp.decode_tokens > 0 and 0.0 < gp.occupancy <= 1.0
        assert gp.waste_by_cause.get("spec_rejected", 0) > 0
        assert "prefill" in gp.compile_s_by_label and gp.mfu_achieved > 0.0
        status, _, body = await afetch(port, "GET", "/debug/slo")
        assert status == 200 and "enabled" in json.loads(body)
        await metrics.close()
        await mock.stop()
    finally:
        await drt.close()


async def test_fleet_debug_goodput_matches_direct_merge():
    drt = await DistributedRuntime.detached()
    try:
        comp = drt.namespace("goodput-fleet").component("backend")
        eid = EndpointId("goodput-fleet", "backend", "generate")
        rng = random.Random(7)
        ledgers, all_ms, pubs = [], [], []
        for w in range(3):
            gp = GoodputLedger(enabled=True)
            mu = (-6.0, -5.0, -4.0)[w]
            for _ in range(300):
                dur = rng.lognormvariate(mu, 0.4)
                gp.record_step("decode", dur, lanes=2 + w, capacity=8)
                all_ms.append(dur * 1e3)
            gp.record_waste("spec_rejected", 10 * (w + 1))
            gp.record_waste("preempt_replay", 5)
            gp.record_compile("decode", 9.0 + w)
            gp.set_perf_gauges(0.2 + 0.1 * w, 1e8)
            ledgers.append(gp)
            pub = WorkerMetricsPublisher(comp, eid, instance_id=w, interval_s=0.05)
            pub.publish(ForwardPassMetrics(goodput=gp))
            await pub.start()
            pubs.append(pub)
        metrics = cm.MetricsComponent(comp, eid, poll_interval=0.05, port=0)
        port = await metrics.start()
        for _ in range(100):
            last = metrics.last
            if last is not None and last.goodput is not None and last.goodput.steps_total == 900:
                break
            await asyncio.sleep(0.05)
        direct = GoodputStats()
        for gp in ledgers:
            direct.merge(gp)
        doc = json.loads((await afetch(port, "GET", "/debug/goodput"))[2])
        text = (await afetch(port, "GET", "/metrics"))[2].decode()
        await metrics.close()
        for pub in pubs:
            await pub.stop()
    finally:
        await drt.close()
    fleet = doc["fleet"]
    assert doc["scope"] == "fleet" and len(doc["workers"]) == 3
    assert fleet["steps_total"] == direct.steps_total == 900
    assert fleet["tokens_wasted"] == {c: direct.waste_by_cause.get(c, 0) for c in WASTE_CAUSES}
    assert fleet["tokens_wasted"]["spec_rejected"] == 60
    assert fleet["occupancy"] == pytest.approx(direct.occupancy, abs=1e-4)
    assert fleet["compile_s_by_label"]["decode"] == pytest.approx(11.0)
    assert fleet["mfu_achieved"] == pytest.approx(0.3, abs=1e-4)
    pooled = sorted(all_ms)
    for q in (50, 99):
        direct_ms = pooled[min(len(pooled) - 1, math.ceil(len(pooled) * q / 100) - 1)]
        fleet_ms = fleet["steps_by_label"]["decode"][f"p{q}_ms"]
        assert abs(fleet_ms - direct_ms) / direct_ms <= QUANTILE_REL_ERROR + 0.02, (q, fleet_ms)
    assert "dyn_llm_steps_total 900.0" in text
    assert 'dyn_llm_tokens_wasted_total{cause="spec_rejected"} 60.0' in text
    assert 'dyn_llm_compile_seconds{label="decode"} 11.0' in text


PLANNER = {"decisions_total": {"up|slo_ttft": 3, "hold|steady": 5, "frozen": 1}, "frozen": 0,
           "replicas_target": {"decode": 3, "prefill": 1}, "replicas_actual": {"decode": 2},
           "supervisor": {"restarts_total": 4, "quarantined": 1}}
UPGRADE = {"phase": "handoff", "handoff_blocks": {"pulled": 17, "fallback_error": 2},
           "rollbacks_total": 1, "replaced": 2}


def _render(mod, registry_cls, render, planner, upgrade):
    class _C:
        def describe(self):
            return []

        def collect(self):
            yield from mod.planner_families(planner)
            yield from mod.fleet_upgrade_families(upgrade)

    reg = registry_cls()
    reg.register(_C())
    return parsed(render(reg).decode())


async def test_planner_and_upgrade_families_read_their_fabric_keys():
    assert cm.PLANNER_STATUS_KEY == "planner/status"
    assert cm.UPGRADE_STATUS_KEY == "fleet/upgrade-status"
    from dynamo_tpu.fleet.upgrade import PHASES

    assert cm.PHASES == PHASES
    for planner, upgrade in ((PLANNER, UPGRADE), ({}, {})):
        assert _render(cm, CollectorRegistry, generate_latest, planner, upgrade) == \
            _render(jcm, JRegistry, j_generate, planner, upgrade)
    drt = await DistributedRuntime.detached()
    try:
        comp = drt.namespace("pl").component("backend")
        eid = EndpointId("pl", "backend", "generate")
        metrics = cm.MetricsComponent(comp, eid, poll_interval=0.05, port=0)
        port = await metrics.start()
        text = (await afetch(port, "GET", "/metrics"))[2].decode()
        assert 'dyn_fleet_upgrade_phase{phase="idle"} 1.0' in text  # no key: empty status
        await drt.fabric.kv_put(cm.PLANNER_STATUS_KEY, mpack.packb(PLANNER))
        await drt.fabric.kv_put(cm.UPGRADE_STATUS_KEY, json.dumps(UPGRADE).encode())
        for _ in range(100):
            if metrics.planner_status and metrics.upgrade_status:
                break
            await asyncio.sleep(0.05)
        assert metrics.planner_status == PLANNER and metrics.upgrade_status == UPGRADE
        text = (await afetch(port, "GET", "/metrics"))[2].decode()
        assert 'dyn_planner_decisions_total{direction="up",reason="slo_ttft"} 3.0' in text
        assert 'dyn_fleet_upgrade_phase{phase="handoff"} 1.0' in text
        await metrics.close()
    finally:
        await drt.close()


def test_the_cli_serves_metrics_with_a_mock_worker():
    env = dict(os.environ, PYTHONPATH=ROOT)
    fab = subprocess.Popen([sys.executable, "-m", "dynamo_tpu_torch.fabric.server", "--port", "0"],
                           cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    comp = None
    try:
        addr = None
        t0 = time.monotonic()
        while addr is None and time.monotonic() - t0 < 30:
            line = fab.stdout.readline()
            if "listening" in line or ":" in line:
                for tok in line.replace(",", " ").split():
                    if tok.count(":") == 1 and tok.split(":")[1].isdigit():
                        addr = tok
        assert addr, "the fabric server did not say where it listens"
        with __import__("socket").socket() as s:
            s.bind(("127.0.0.1", 0))
            mport = s.getsockname()[1]
        code = ("import runpy, sys; sys.argv = ['metrics', '--namespace', 'cli', '--port', '%d', "
                "'--poll-interval', '0.1', '--mock-worker']\n"
                "runpy.run_module('dynamo_tpu_torch.components.metrics', run_name='__main__')" % mport)
        comp = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                env=dict(env, DYN_FABRIC_ADDR=addr), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        from tests.test_torch_frontend import fetch

        text = ""
        t0 = time.monotonic()
        while "dyn_llm_worker_count 1.0" not in text and time.monotonic() - t0 < 30:
            time.sleep(0.2)
            try:
                text = fetch(mport, "GET", "/metrics", timeout=5)[2].decode()
            except OSError:
                pass
        assert "dyn_llm_worker_count 1.0" in text
        assert "dyn_llm_steps_total" in text and "dyn_llm_decisions_total" in text
        code = ("import sys, dynamo_tpu_torch.components.metrics; print('torch' in sys.modules)")
        assert subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                              text=True).stdout.strip() == "False"
    finally:
        for p in (comp, fab):
            if p is not None:
                p.send_signal(signal.SIGTERM)
                try:
                    p.wait(10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
