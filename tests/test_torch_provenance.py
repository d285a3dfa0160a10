"""The port's decision provenance against the JAX package's, on the CPU.

- ``telemetry/provenance.py``: the same records give the same
  ``stable_lines`` and ``digest`` in both packages; a record's wire dict
  crosses packages both ways with its identity; the taxonomy is the same and
  closed; the ring is bounded and counts its evictions; ``DYN_DECISIONS=0``
  records nothing; ``auto`` keeps only what the retention verdict keeps;
  ingest dedupes and assembling in any order gives the same record set; the
  timeline is ordered across processes.
- Routing: the port's and the reference's ``KvScheduler`` over the same
  seeded event stream and queries (prefix pulls on) record digest-identical
  ``router/route`` and ``router/prefix_pull`` decisions.
- The control-plane sites against the reference's on the same inputs: the
  health scorer's eject / probe / restore, the brownout ladder's steps, the
  admission controller's admit / shed verdicts and ``qos.stamp_priority``.
- End to end (twin of tests/test_provenance.py's fleet scenario): a bulk
  request is shed by brownout, retried under the same id, admitted, routed
  by the KV router and preempted by an interactive grower on a starved
  mocker worker; ``GET /debug/decisions/{id}`` gives one causal timeline
  of >= 6 records from two processes, ``tools/explain.py`` renders it,
  ``GET /debug/fleet`` counts them, and the token streams equal those of
  the same scenario with the ledger off. An unknown request is a 404; a
  known one whose records have not landed is partial.
"""

import asyncio
import json
import os
import random

import pytest

from dynamo_tpu import qos as jqos
from dynamo_tpu.http import service as jservice
from dynamo_tpu.kv_router import indexer as j_indexer
from dynamo_tpu.kv_router import protocols as j_protocols
from dynamo_tpu.kv_router import scheduler as j_scheduler
from dynamo_tpu.pipeline.context import Context as JContext
from dynamo_tpu.protocols import common as jp
from dynamo_tpu.telemetry import brownout as jbrownout
from dynamo_tpu.telemetry import health as jhealth
from dynamo_tpu.telemetry import provenance as jprov
from dynamo_tpu_torch import qos as tqos
from dynamo_tpu_torch.discovery import register_llm
from dynamo_tpu_torch.engine.mocker import MockEngine, MockEngineArgs
from dynamo_tpu_torch.entrypoint.inputs import EngineConfig, make_engine_handler, run_http
from dynamo_tpu_torch.fabric.state import FabricState
from dynamo_tpu_torch.http import service as tservice
from dynamo_tpu_torch.kv_router import indexer as t_indexer
from dynamo_tpu_torch.kv_router import protocols as t_protocols
from dynamo_tpu_torch.kv_router import scheduler as t_scheduler
from dynamo_tpu_torch.pipeline.context import Context
from dynamo_tpu_torch.pipeline.router import RouterMode
from dynamo_tpu_torch.protocols import common as tp
from dynamo_tpu_torch.run import build_test_mdc
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.telemetry import brownout as tbrownout
from dynamo_tpu_torch.telemetry import health as thealth
from dynamo_tpu_torch.telemetry import provenance as dprov
from dynamo_tpu_torch.telemetry import trace as dtrace
from dynamo_tpu_torch.tools import explain
from tests.test_torch_frontend import afetch
from tests.test_torch_kv_router import random_event_stream

BOTH = (dprov, jprov)


@pytest.fixture
def prov():
    """Both ledgers on with a fresh ring; restored to the env default."""
    for mod in BOTH:
        mod.set_enabled(True)
        mod.reset(proc="frontend")
    yield
    for mod in BOTH:
        mod.set_mode(os.environ.get("DYN_DECISIONS", "1"))
        mod.reset()


def _script(mod):
    """The same decisions, recorded through ``mod``."""
    mod.record("router", "route", 7, reason="overlap", request_id="r-1",
               alternatives=[{"worker": 7, "overlap": 3}, {"worker": 9, "overlap": 0}],
               overlap_blocks=3)
    mod.record("admission", "shed", "bulk", reason="watermark", request_id="r-2", watermark=4)
    mod.record("health", "eject", "1f", reason="ttft", epoch="1f", score=5.25)
    mod.record("engine", "preempt", "bulk", reason="class_rank", request_id="r-2",
               grower="r-3", grower_class="interactive")
    mod.record("brownout", "level", "shed_bulk", reason="step_up", epoch="frontend",
               from_level=0, to_level=1, slo_state="burning")


def test_records_digest_and_wire_equal_the_reference(prov):
    assert dprov.TAXONOMY == jprov.TAXONOMY
    for mod in BOTH:
        _script(mod)
    assert dprov.stable_lines() == jprov.stable_lines()
    assert dprov.digest() == jprov.digest()
    assert dprov.counts() == jprov.counts()
    # a port record read by the reference (and back) keeps its identity
    for src, dst in ((dprov, jprov), (jprov, dprov)):
        for rec in src.records_for_request("r-2"):
            wire = json.loads(json.dumps(rec.to_dict()))
            back = dst.DecisionRecord.from_dict(wire)
            assert back.remote and back.rec_id == rec.rec_id
            assert back.stable_key() == rec.stable_key()
            assert back.to_dict() == rec.to_dict()
    # the closed vocabulary
    for mod in BOTH:
        with pytest.raises(ValueError):
            mod.record("router", "shed", 1)
        with pytest.raises(ValueError):
            mod.record("scheduler", "route", 1)
    # the context supplies the request and trace identity
    ctx = Context()
    ctx.metadata["trace"] = {"tid": "t" * 32}
    rec = dprov.record("qos", "priority", "bulk", reason="header", ctx=ctx)
    assert (rec.request_id, rec.trace_id) == (ctx.id, "t" * 32)


def test_ring_modes_ingest_and_timeline_equal_the_reference(prov):
    out = []
    for mod in BOTH:
        mod.reset(proc="frontend", ring=64)
        for i in range(200):
            mod.record("admission", "admit", "m", reason="under_watermark", request_id=f"r{i}")
        led = mod.ledger()
        out.append((led.ring_len(), mod.dropped_total(), mod.counts(),
                    mod.records_for_request("r0"), len(mod.records_for_request("r199"))))
        # disabled: nothing, not even validation
        mod.set_enabled(False)
        assert mod.record("not-an-actor", "nope") is None
        # auto: a completed request's records are kept only by verdict
        mod.set_mode("auto")
        mod.reset(proc="frontend")
        for rid in ("keep-1", "drop-1"):
            mod.record("admission", "admit", "m", reason="under_watermark", request_id=rid)
            mod.record("router", "route", 3, reason="load", request_id=rid)
        mod.maybe_retain("drop-1", None)
        mod.maybe_retain("keep-1", "slo_breach")
        out.append((len(mod.records_for_request("keep-1")), mod.records_for_request("drop-1"),
                    mod.ledger().retention_of("keep-1"), mod.ledger().discarded_total))
        mod.set_mode("1")
    assert out[0] == out[2] and out[1] == out[3]
    assert out[0][:2] == (64, 136) and out[1][0] == 2

    def shipment(mod, n, proc):
        mod.reset(proc=proc)
        for i in range(n):
            mod.record("engine", "preempt", "bulk", reason="class_rank", request_id="req-x",
                       generated=i)
        return mod.export_for_request("req-x")

    # a port frontend assembles shipments from workers of either package
    a, b, c = shipment(dprov, 3, "frontend"), shipment(jprov, 2, "worker-1"), \
        shipment(dprov, 4, "worker-2")
    dprov.reset(proc="frontend")
    assert dprov.ingest(a) == 3 and dprov.ingest(a) == 0
    dprov.ingest(b)
    dprov.ingest(c)
    left = {r.rec_id for r in dprov.records_for_request("req-x")}
    dprov.reset(proc="frontend")
    dprov.ingest(b + c)
    dprov.ingest(a)
    right = {r.rec_id for r in dprov.records_for_request("req-x")}
    assert left == right and len(left) == 9
    tl = dprov.timeline("req-x")
    assert [(r["unix_ns"], r["t_ns"]) for r in tl] == sorted((r["unix_ns"], r["t_ns"]) for r in tl)
    assert {r["proc"] for r in tl} == {"frontend", "worker-1", "worker-2"}


def test_seeded_routing_scenario_gives_the_references_digest(prov):
    bs = 4
    events, queries = random_event_stream(11, bs, n_workers=4)
    lines = {}
    for name, prov_mod, ix_mod, sc_mod, pr_mod in (
            ("ref", jprov, j_indexer, j_scheduler, j_protocols),
            ("port", dprov, t_indexer, t_scheduler, t_protocols)):
        prov_mod.reset(proc="router")
        ix = ix_mod.KvIndexer(bs)
        for d in events[:250]:
            ix.apply_event(pr_mod.RouterEvent.from_dict(d))
        cfg = sc_mod.KvRouterConfig(router_temperature=0.5, overlap_score_weight=1.5,
                                    prefix_pull=True, prefix_pull_min_blocks=1)
        sched = sc_mod.KvScheduler(bs, sc_mod.DefaultWorkerSelector(cfg), config=cfg)
        sched.update_workers([0, 1, 2, 3])
        random.seed(99)
        for i, q in enumerate(queries[:120]):
            sched.schedule(q, ix.find_matches_for_request(q), request_id=f"r{i}")
            if i % 3 == 2:
                sched.free(f"r{i - 1}")
        lines[name] = (prov_mod.stable_lines(), prov_mod.digest(), prov_mod.counts())
    assert lines["port"] == lines["ref"]
    counts = lines["port"][2]
    assert counts[("router", "route")] == 120 and counts.get(("router", "prefix_pull"), 0) > 0


def test_control_plane_sites_record_what_the_references_do(prov):
    # health: a gray worker ejected, probed on probation, restored; the
    # brownout ladder up on a breach and down after the fleet's ok
    for prov_mod, mod, br in ((dprov, thealth, tbrownout), (jprov, jhealth, jbrownout)):
        prov_mod.reset(proc="frontend")
        clock = [0.0]
        cfg = mod.HealthConfig(eject_ratio=3.0, eject_intervals=2, recover_ratio=1.5,
                               recover_intervals=2, probe_every=3, min_healthy=1)
        sc = mod.HealthScorer(cfg, now_fn=lambda: clock[0])
        for tick in range(12):
            clock[0] += 1.0
            slow = 10.0 if tick < 5 else 1.0
            for wid, f in ((1, 1.0), (2, 1.0), (3, slow)):
                for _ in range(5):
                    sc.record(wid, "first_frame", 50.0 * f)
            sc.tick()
            for _ in range(3):
                sc.route_set([1, 2, 3])
        ctl = br.BrownoutController(scope="frontend", now_fn=lambda: clock[0])
        for state in ("breached", "breached", "burning", "ok", "ok", "ok"):
            clock[0] += 10.0
            ctl.observe(state)
    assert dprov.stable_lines() == jprov.stable_lines()
    kinds = {k for k in dprov.counts()}
    assert {("health", "eject"), ("brownout", "level")} <= kinds
    # admission and QoS at the edge
    for prov_mod, svc, qmod, ctx_cls, pmod in ((dprov, tservice, tqos, Context, tp),
                                               (jprov, jservice, jqos, JContext, jp)):
        prov_mod.reset(proc="frontend")
        adm = svc.AdmissionController(None)
        adm.set_capacity_fn("m", lambda: 2)
        for i, prio in enumerate(("interactive", "bulk", "standard", "bulk", "interactive")):
            adm.try_acquire("m", prio, request_id=f"a{i}")
        adm.brownout_shed = frozenset({"bulk"})
        adm.try_acquire("m", "bulk", request_id="a9")
        pre = pmod.PreprocessedRequest(token_ids=[1, 2], extra={"priority": "bulk"})
        ctx = ctx_cls(id="q1")
        qmod.stamp_priority(pre, ctx)
    assert dprov.stable_lines() == jprov.stable_lines()
    assert {("admission", "admit"), ("admission", "shed"), ("qos", "priority")} <= set(dprov.counts())


# tests/util.py's vocabulary: distinct words, distinct block hashes
TEST_WORDS = ("hello world the quick brown fox jumps over lazy dog a b c d e f g "
              "STOP assistant user im_start im_end one two three four five six").split()


def _word_card(name: str):
    """tests/util.make_test_mdc's card over the port's tokenizer.json reader."""
    from dynamo_tpu_torch.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.tokenizer import TokenizerWrapper
    from dynamo_tpu_torch.tokenizer_json import JsonTokenizer

    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for w in TEST_WORDS:
        vocab.setdefault(w, len(vocab))
    tok = JsonTokenizer(json.dumps({
        "version": "1.0", "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"},
        "pre_tokenizer": {"type": "Whitespace"}}))
    return ModelDeploymentCard.from_tokenizer(name, TokenizerWrapper(tok, eos_token_ids=[2]))
TRACKED_PROMPT = "hello world the quick brown fox jumps over"  # 8 tokens
GROWER_PROMPT = " ".join(["one two three four five six"] * 10)  # 60 tokens
BS = 4


def _sse_text(body: bytes) -> str:
    out = []
    for line in body.decode().splitlines():
        line = line.strip()
        if line.startswith("data:") and line != "data: [DONE]":
            for ch in json.loads(line[len("data:"):]).get("choices") or []:
                out.append(ch.get("text") or "")
    return "".join(out)


async def _drive_fleet_scenario(collect_debug: bool):
    """shed -> retry -> admit -> route -> preempt -> readmit through a
    one-worker KV-routed fleet (tests/test_provenance.py:253-395)."""
    rid = "prov-e2e-req"
    state = FabricState()  # a fabric of this scenario's own
    front_drt = await DistributedRuntime.detached(state=state)
    wdrt = await DistributedRuntime.detached(state=state)
    service = None
    try:
        mdc = _word_card("prov-e2e")
        mdc.kv_block_size = BS
        endpoint = wdrt.namespace("prov").component("mock").endpoint("generate")
        # either stream fits alone (27 and 22 blocks at their peaks), not
        # both at once: the worker preempts the bulk victim and re-admits it
        eng = MockEngine(MockEngineArgs(num_blocks=28, block_size=BS, max_batch=8,
                                        speedup_ratio=10.0, decode_per_token_s=0.01,
                                        preempt_backoff_ms=1.0, max_preemptions=1000))
        eng.trace_proc = "worker-1"
        await endpoint.serve_endpoint(make_engine_handler(eng, "worker-1"))
        await register_llm(wdrt, endpoint, mdc)
        config = EngineConfig.dynamic(
            RouterMode.KV, kv_router_config=t_scheduler.KvRouterConfig(router_temperature=0.0))
        service = await run_http(config, host="127.0.0.1", port=0, drt=front_drt)
        port = service.port
        for _ in range(50):
            _, _, body = await afetch(port, "GET", "/v1/models")
            if json.loads(body)["data"]:
                break
            await asyncio.sleep(0.1)
        payload = {"model": "prov-e2e", "prompt": TRACKED_PROMPT, "max_tokens": 96,
                   "stream": True}
        headers = {"x-request-id": rid, "x-dyn-priority": "bulk"}
        service.admission.brownout_shed = frozenset({"bulk"})
        status, _, _ = await afetch(port, "POST", "/v1/completions", payload, headers)
        assert status == 429
        service.admission.brownout_shed = frozenset()
        tracked = asyncio.ensure_future(afetch(port, "POST", "/v1/completions", payload, headers))
        for _ in range(1000):
            if any(s.generated > 0 for s in eng.active):
                break
            await asyncio.sleep(0.002)
        grower = await afetch(port, "POST", "/v1/completions",
                              {"model": "prov-e2e", "prompt": GROWER_PROMPT, "max_tokens": 24,
                               "stream": True}, {"x-dyn-priority": "interactive"})
        status, _, tracked_body = await tracked
        assert status == grower[0] == 200
        debug = None
        if collect_debug:
            status, _, body = await afetch(port, "GET", f"/debug/decisions/{rid}")
            assert status == 200, body
            timeline = json.loads(body)
            status, _, body = await afetch(port, "GET", "/debug/fleet")
            assert status == 200, body
            debug = (timeline, json.loads(body))
        else:
            status, _, _ = await afetch(port, "GET", f"/debug/decisions/{rid}")
            assert status == 404  # the ledger is off
        return _sse_text(tracked_body), _sse_text(grower[2]), debug
    finally:
        if service is not None:
            await service.close()
        await wdrt.close()
        await front_drt.close()


async def test_e2e_timeline_six_records_two_procs_token_identical(prov):
    tracked_on, grower_on, (timeline, fleet) = await _drive_fleet_scenario(True)
    assert timeline["request_id"] == "prov-e2e-req" and timeline["partial"] is False
    recs = timeline["decisions"]
    assert timeline["count"] == len(recs) >= 6
    assert {"frontend", "worker-1"} <= set(timeline["procs"])
    kinds = [(r["actor"], r["kind"]) for r in recs]
    for expected in (("admission", "shed"), ("admission", "admit"), ("qos", "priority"),
                     ("router", "route"), ("engine", "preempt"), ("engine", "readmit")):
        assert expected in kinds, (expected, kinds)
    stamps = [(r["unix_ns"], r["t_ns"]) for r in recs]
    assert stamps == sorted(stamps)
    assert kinds.index(("admission", "shed")) < kinds.index(("admission", "admit")) \
        < kinds.index(("engine", "preempt")) < kinds.index(("engine", "readmit"))
    shed = next(r for r in recs if r["kind"] == "shed")
    assert shed["reason"] == "brownout" and shed["chosen"] == "bulk"
    preempt = next(r for r in recs if r["kind"] == "preempt")
    assert preempt["proc"] == "worker-1" and preempt["chosen"] == "bulk"
    route = next(r for r in recs if r["kind"] == "route")
    assert route["reason"] == "single_candidate"
    # the reader renders every record, alternatives included
    text = explain.render_timeline(timeline)
    assert text.splitlines()[0].startswith("request prov-e2e-req: ")
    assert "router/route" in text and "engine/preempt" in text and "[brownout]" in text
    assert "fleet snapshot" in explain.render_fleet(fleet)
    dec = fleet["decisions"]
    assert dec["enabled"] is True
    assert dec["counts"].get("engine/preempt", 0) >= 1
    assert dec["counts"].get("admission/shed", 0) >= 1
    assert "brownout" in fleet and "admission" in fleet and "health" in fleet
    # the ledger does not bend the data plane
    dprov.set_enabled(False)
    tracked_off, grower_off, _ = await _drive_fleet_scenario(False)
    assert tracked_on == tracked_off and tracked_on
    assert grower_on == grower_off and grower_on


async def test_debug_decisions_is_wait_bounded_not_404(prov, monkeypatch):
    monkeypatch.setenv("DYN_TRACE_ASSEMBLE_MS", "80")
    dtrace.set_enabled(True)
    dtrace.reset(proc="frontend", ring=16)
    engine = MockEngine(MockEngineArgs(speedup_ratio=1000.0))
    service = await run_http(EngineConfig.static_(engine, build_test_mdc("wb")),
                             host="127.0.0.1", port=0)
    try:
        ctx = Context(id="known-rid")
        with dtrace.root_span("http_request", ctx, request_id=ctx.id):
            pass
        status, _, body = await afetch(service.port, "GET", "/debug/decisions/known-rid")
        assert status == 200
        doc = json.loads(body)
        assert doc["partial"] is True and doc["decisions"] == []
        status, _, _ = await afetch(service.port, "GET", "/debug/decisions/never-seen")
        assert status == 404
    finally:
        await service.close()
        await engine.close()
        dtrace.set_enabled(False)
        dtrace.reset()
