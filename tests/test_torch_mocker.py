"""The port's mocker against the JAX package's, on the CPU.

Twins of tests/test_kv_router.py's mocker cases (:327-420) and of
tests/test_goodput.py's mocker ledger cases, each run on both packages'
``MockEngine`` over the same requests:

- the token streams, the KV events (stored blocks with their parents,
  removed hashes) and the block bookkeeping are identical, also under LRU
  eviction and with a shared prefix reused across requests;
- the goodput ledger over simulated seconds (whole-prompt prefill, mixed
  steps with a chunk budget, a migration's replayed tail) gives the
  reference's wire dict;
- the disagg frames of ``MockPrefillEngine`` (streamed and monolithic) carry
  the reference's sequence numbers, block ranges, payload shapes and first
  token;
- ``MockFleetPrefixRegistry`` pulls what the reference's pulls;
- two mocker workers behind the port's KV router put a shared prefix on the
  warm worker, as two reference mocker workers behind the reference's router
  do;
- ``python -m dynamo_tpu_torch.run in=batch:FILE out=mocker`` serves with no
  torch in the process.
"""

import asyncio
import json
import os
import subprocess
import sys

import pytest

from dynamo_tpu.engine import mocker as jm
from dynamo_tpu.kv_router import publisher as j_publisher
from dynamo_tpu.kv_router.router import KvRouter as JKvRouter
from dynamo_tpu.kv_router.scheduler import KvRouterConfig as JKvRouterConfig
from dynamo_tpu.pipeline.context import Context as JContext
from dynamo_tpu.protocols import common as jp
from dynamo_tpu.runtime.distributed import DistributedRuntime as JDistributedRuntime
from dynamo_tpu_torch.engine import mocker as tm
from dynamo_tpu_torch.fabric.state import FabricState
from dynamo_tpu_torch.kv_router import publisher as t_publisher
from dynamo_tpu_torch.kv_router.router import KvRouter
from dynamo_tpu_torch.kv_router.scheduler import KvRouterConfig
from dynamo_tpu_torch.pipeline.context import Context
from dynamo_tpu_torch.protocols import common as tp
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS = 4
PKGS = (("ref", jm, jp, JContext), ("port", tm, tp, Context))


def _req(pmod, prompt, max_tokens, **extra):
    r = pmod.PreprocessedRequest(token_ids=list(prompt),
                                 sampling=pmod.SamplingOptions(greedy=True),
                                 stop=pmod.StopConditions(max_tokens=max_tokens, ignore_eos=True))
    r.extra.update(extra)
    return r


async def _collect(engine, req, ctx):
    toks, final = [], None
    async for out in engine.generate(req, ctx):
        toks.extend(out.token_ids)
        if out.finish_reason is not None:
            final = out
    return toks, final.finish_reason.value if final and final.finish_reason else None


def _requests():
    """Sequential traffic: shared prefixes, a long prompt, repeats."""
    base = list(range(3, 3 + 3 * BS))
    return [
        (list(range(10)), 12),
        (base + [90, 91], 9),
        (base + [92], 6),
        ([7] * 23, 5),
        (base + [90, 91], 9),
        (list(range(40, 40 + 8 * BS + 3)), 7),
    ]


async def _serve(mod, pmod, ctx_cls, args_kw, requests=None):
    events = []
    eng = mod.MockEngine(
        mod.MockEngineArgs(**args_kw),
        on_blocks_stored=lambda b: events.append(("stored", [dict(x) for x in b])),
        on_blocks_removed=lambda h: events.append(("removed", list(h))),
    )
    outs = []
    try:
        for prompt, n in requests or _requests():
            outs.append(await _collect(eng, _req(pmod, prompt, n), ctx_cls()))
    finally:
        await eng.close()
    return outs, events, eng


@pytest.mark.parametrize("num_blocks", [64, 12])
async def test_streams_events_and_blocks_equal_the_reference(num_blocks):
    kw = dict(num_blocks=num_blocks, block_size=BS, speedup_ratio=1000.0)
    got = {name: await _serve(mod, pmod, ctx, kw) for name, mod, pmod, ctx in PKGS}
    (r_outs, r_ev, r_eng), (p_outs, p_ev, p_eng) = got["ref"], got["port"]
    assert p_outs == r_outs
    assert all(len(t) == n for (t, _), (_, n) in zip(p_outs, _requests()))
    assert p_ev == r_ev and any(k == "stored" for k, _ in p_ev)
    if num_blocks == 12:  # LRU eviction emitted Removed events
        assert any(k == "removed" for k, _ in p_ev)
    assert (p_eng.cache.free_blocks, p_eng.cache.refs, list(p_eng.cache.lru)) == \
        (r_eng.cache.free_blocks, r_eng.cache.refs, list(r_eng.cache.lru))
    assert p_eng.prefilled_tokens == r_eng.prefilled_tokens
    assert p_eng.generated_tokens == r_eng.generated_tokens
    # the ledger over simulated seconds is the reference's
    assert p_eng.goodput.to_dict() == r_eng.goodput.to_dict()


async def test_mixed_steps_and_migration_replay_equal_the_reference():
    kw = dict(num_blocks=256, block_size=BS, speedup_ratio=1000.0, chunk_budget=8)
    reqs = [(list(range(30)), 6), (list(range(5, 45)), 4)]
    ledgers, outs = {}, {}
    for name, mod, pmod, ctx_cls in PKGS:
        eng = mod.MockEngine(mod.MockEngineArgs(**kw))
        try:
            res = await asyncio.gather(*(_collect(eng, _req(pmod, p, n), ctx_cls()) for p, n in reqs))
            prompt = [7, 3, 9, 4, 1]
            base, _ = await _collect(eng, _req(pmod, prompt, 12), ctx_cls())
            resumed = _req(pmod, prompt + base[:5], 12, resume_prompt_len=len(prompt))
            tail, _ = await _collect(eng, resumed, ctx_cls())
            assert tail == base[5:]
            outs[name] = (res, base, tail)
            ledgers[name] = eng.goodput
        finally:
            await eng.close()
    assert outs["port"] == outs["ref"]
    assert ledgers["port"].waste_by_cause == ledgers["ref"].waste_by_cause == {"migration_replay": 5}
    assert ledgers["port"].mixed_steps == ledgers["ref"].mixed_steps > 0
    assert ledgers["port"].to_dict() == ledgers["ref"].to_dict()


async def test_prefill_frames_equal_the_reference():
    from dynamo_tpu.disagg.protocols import RemotePrefillRequest as JReq
    from dynamo_tpu_torch.disagg.protocols import RemotePrefillRequest as TReq

    tokens = list(range(11, 11 + 5 * BS + 2))
    got = {}
    for name, mod, req_cls in (("ref", jm, JReq), ("port", tm, TReq)):
        eng = mod.MockPrefillEngine(mod.MockEngineArgs(block_size=BS, speedup_ratio=1000.0),
                                    chunk_blocks=2)
        frames = []

        async def emit(frame, frames=frames):
            frames.append((frame.seq, frame.first_block, tuple(frame.payload.shape),
                           frame.payload.num_blocks))

        req = req_cls(request_id="p1", token_ids=tokens, reply_subject="r", block_size=BS)
        final = await eng.prefill_only_stream(req, emit)
        mono = await eng.prefill_only(req)
        got[name] = (frames, final.first_token, final.first_block, final.streamed_blocks,
                     tuple(final.payload.shape), mono.first_token, tuple(mono.payload.shape),
                     eng.served, eng.frames_emitted)
    assert got["port"] == got["ref"]
    assert len(got["port"][0]) == 3


async def test_fleet_prefix_pulls_equal_the_reference():
    got = {}
    for name, mod, pmod, ctx_cls in PKGS:
        reg = mod.MockFleetPrefixRegistry(fail_every=3)
        engines = [mod.MockEngine(mod.MockEngineArgs(num_blocks=128, block_size=BS,
                                                     speedup_ratio=1000.0), peer_registry=reg)
                   for _ in range(3)]
        engines[2].fenced = True
        prefix = list(range(50, 50 + 6 * BS))
        try:
            await _collect(engines[0], _req(pmod, prefix, 2), ctx_cls())
            for i in range(4):
                await _collect(engines[1], _req(pmod, prefix + [200 + i] * BS, 2), ctx_cls())
                await _collect(engines[1], _req(pmod, list(range(300 + 10 * i, 310 + 10 * i)), 2),
                               ctx_cls())
        finally:
            for e in engines:
                await e.close()
        got[name] = (reg.pull_outcomes, reg.pulled_blocks, [e.pull_outcomes for e in engines],
                     [e.prefilled_tokens for e in engines], [e.kv_pulled_blocks for e in engines])
    assert got["port"] == got["ref"]
    assert got["port"][1] > 0


async def _warm_route(pkg):
    """Two mocker workers behind a KV router: the worker that served a
    prefix is chosen for a request extending it (test_kv_router.py:372)."""
    if pkg == "port":
        drt_cls, mod, pmod, pub_mod, router_cls, cfg_cls, ctx_cls = (
            DistributedRuntime, tm, tp, t_publisher, KvRouter, KvRouterConfig, Context)
        drt = await DistributedRuntime.detached(state=FabricState())
    else:
        drt_cls, mod, pmod, pub_mod, router_cls, cfg_cls, ctx_cls = (
            JDistributedRuntime, jm, jp, j_publisher, JKvRouter, JKvRouterConfig, JContext)
        drt = await JDistributedRuntime.detached()
    try:
        component = drt.namespace("mocktest").component("mock")
        ep = component.endpoint("generate")
        services = []
        for _ in range(2):
            eng = mod.MockEngine(mod.MockEngineArgs(num_blocks=256, block_size=BS,
                                                    speedup_ratio=1000.0))

            async def handler(request, context, _eng=eng, _pmod=pmod):
                req = _pmod.PreprocessedRequest.from_dict(request)
                async for out in _eng.generate(req, context):
                    yield out.to_dict()

            svc = await ep.serve_endpoint(handler)
            pub = pub_mod.KvEventPublisher(component, svc.instance_id)
            eng.cache.on_stored = pub.on_blocks_stored
            eng.cache.on_removed = pub.on_blocks_removed
            services.append(svc)
        client = await ep.client()
        await client.wait_for_instances(2.0)
        router = router_cls(component, client, block_size=BS,
                            config=cfg_cls(router_temperature=0.0))
        await router.start()
        prefix = list(range(4 * BS))
        warm = services[1].instance_id
        stream = await client.direct(_req(pmod, prefix, 4).to_dict(), warm, ctx_cls())
        async for _ in stream:
            pass
        await asyncio.sleep(0.1)  # the Stored events reach the indexer
        wid, overlap = await router.find_best_match(prefix + [999] * 3)
        await router.close()
        return wid == warm, overlap
    finally:
        await drt.close()


async def test_two_mocker_workers_route_a_shared_prefix_as_the_reference():
    port, ref = await _warm_route("port"), await _warm_route("ref")
    assert port == ref == (True, 4)


def test_out_mocker_serves_a_batch_without_torch(tmp_path):
    batch = tmp_path / "batch.jsonl"
    batch.write_text("\n".join(json.dumps(r) for r in (
        {"text": "hello world", "max_tokens": 6}, {"prompt": "the quick brown fox", "max_tokens": 4})) + "\n")
    code = ("import sys, runpy; sys.argv = ['run', 'in=batch:%s', 'out=mocker', '--num-blocks', '64'];"
            "\ntry:\n    runpy.run_module('dynamo_tpu_torch.run', run_name='__main__')\nfinally:\n"
            "    print('TORCH', 'torch' in sys.modules)" % batch)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "TORCH False" in proc.stdout
    rows = [json.loads(line) for line in (tmp_path / "batch.jsonl.out.jsonl").read_text().splitlines()]
    assert len(rows) == 2 and all(r["elapsed_ms"] > 0 for r in rows)
    stats = json.loads(next(line for line in proc.stdout.splitlines() if "exit_stats" in line))
    assert stats["exit_stats"]["generated_tokens"] == 10
