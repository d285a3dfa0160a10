"""The port's disaggregation over the fabric against the JAX package's, on
the CPU.

Every case runs the same scenario twice over an in-process fabric: the
port's ``PrefillQueue`` / ``DisaggregatedRouter`` / ``RemotePrefillClient``
/ ``PrefillWorkerService`` between ``TorchEngine``s on its
``FabricClient.in_process()``, and the JAX package's between ``JaxEngine``s
on its own. The reference's tiny Llama (f32, block 4, max_model_len 64),
parameters from the JAX init carried over bit for bit, prompts from
``range`` as the reference's tests. Greedy tokens are held EXACTLY to a
local JaxEngine and to the JAX package's disaggregated run; the counters
the reference's tests check are held to the reference's run where both
count the same thing.

* twins of tests/test_disagg.py: the queue round trip (and the queue's
  wire bytes equal the reference's), thresholds with the live update
  through the fabric's KV watch (the published value byte for byte), end to
  end against local, a short prompt staying local and a failing client
  falling back to local;
* twins of tests/test_disagg_stream.py's fabric legs: expired entries
  dropped, streamed greedy and seeded sampling (seeded against the port's
  own local engine), a worker dying mid stream with idempotent redelivery,
  a lost frame falling back to local, a decode cancel conserving blocks on
  both sides, and the int8 wire within the reference's logprob bound at
  under 0.6 of bf16's bytes;
* a payload over the fabric's frame limit is answered with an error, so
  the decode worker prefills locally at once;
* the disagg graph (``python -m dynamo_tpu_torch.serve
  dynamo_tpu_torch.graphs.disagg``) with tiny-torch on ``DYN_DEVICE=cpu``,
  two PrefillWorkers, one SIGKILLed with requests in flight: every request
  completes (the twin of tests/test_fault_tolerance.py:116, over stdlib
  HTTP).
"""

import asyncio
import json
import time

import jax
import jax.numpy as jnp
import msgpack
import numpy as np

from dynamo_tpu.disagg.prefill_queue import PrefillQueue as JQueue
from dynamo_tpu.disagg.protocols import RemotePrefillRequest as JReq
from dynamo_tpu.disagg.protocols import RemotePrefillResponse as JResp
from dynamo_tpu.disagg.router import DisaggConfig as JConfig
from dynamo_tpu.disagg.router import DisaggregatedRouter as JRouter
from dynamo_tpu.disagg.transfer import PrefillWorkerService as JService
from dynamo_tpu.disagg.transfer import RemotePrefillClient as JClient
from dynamo_tpu.engine.jax_engine.engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.engine.jax_engine.model_runner import ModelRunner
from dynamo_tpu.fabric.client import FabricClient as JFabric
from dynamo_tpu.models import llama as jl
from dynamo_tpu.pipeline.context import Context as JContext
from dynamo_tpu.protocols import common as jp
from dynamo_tpu_torch.disagg import transfer
from dynamo_tpu_torch.disagg.prefill_queue import PrefillQueue
from dynamo_tpu_torch.disagg.protocols import RemotePrefillRequest, RemotePrefillResponse
from dynamo_tpu_torch.disagg.router import DisaggConfig, DisaggregatedRouter
from dynamo_tpu_torch.disagg.transfer import PrefillWorkerService, RemotePrefillClient
from dynamo_tpu_torch.engine.torch_engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.engine.torch_engine.model_runner import TorchModelRunner
from dynamo_tpu_torch.engine.torch_engine.weights import params_from_jax
from dynamo_tpu_torch.fabric import mpack
from dynamo_tpu_torch.fabric.client import FabricClient
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.protocols import common as tp

BS, MAX_LEN, NB, MAX_BATCH, VOCAB = 4, 64, 64, 4, 64
CHUNK = 8  # the streaming cases' chunk: two blocks a frame
LONG = list(range(2, 42))  # 40 tokens: 5 chunks, 4 frames and a final
PROMPTS = [list(range(2, 2 + n)) for n in (9, 17, 23)]

_MODELS: dict = {}


def _models():
    if not _MODELS:
        jcfg = jl.LlamaConfig.tiny(vocab_size=VOCAB)
        jparams = jl.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
        _MODELS.update(jcfg=jcfg, jparams=jparams,
                       tparams=params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"))
    return _MODELS


# ---------------------------------------------------------- both packages

class Side:
    """One package's pieces: its fabric, engines, service, client and router."""

    def __init__(self, name: str):
        self.name = name
        self.torch = name == "torch"
        self.fabric = FabricClient.in_process() if self.torch else JFabric.in_process()
        self.mod = tp if self.torch else jp

    def engine(self, chunk=CHUNK, **kw):
        m = _models()
        if self.torch:
            runner = TorchModelRunner(
                tl.LlamaConfig.tiny(vocab_size=VOCAB), m["tparams"], num_blocks=NB, block_size=BS,
                max_batch=MAX_BATCH, max_model_len=MAX_LEN, device="cpu",
                prefill_chunk_tokens=chunk)
            return TorchEngine(runner, TorchEngineConfig(
                max_batch=MAX_BATCH, block_size=BS, num_blocks=NB, max_model_len=MAX_LEN,
                watermark_blocks=2), **kw)
        runner = ModelRunner(m["jcfg"], m["jparams"], num_blocks=NB, block_size=BS,
                             max_batch=MAX_BATCH, max_model_len=MAX_LEN, prefill_chunk_tokens=chunk,
                             kv_dtype=jnp.float32)
        return JaxEngine(runner, JaxEngineConfig(
            max_batch=MAX_BATCH, block_size=BS, num_blocks=NB, max_model_len=MAX_LEN,
            watermark_blocks=2), **kw)

    def service(self, ns, engine, cls=None, **kw):
        return (cls or (PrefillWorkerService if self.torch else JService))(
            self.fabric, ns, engine, **kw)

    def client(self, ns, timeout=30):
        cls = RemotePrefillClient if self.torch else JClient
        return cls(self.fabric, ns, block_size=BS, timeout=timeout)

    def router(self, ns, threshold=4, queue_size=100):
        if self.torch:
            return DisaggregatedRouter(DisaggConfig(threshold, queue_size), namespace=ns,
                                       fabric=self.fabric)
        return JRouter(self.fabric, ns, JConfig(threshold, queue_size))

    def queue(self, ns):
        return (PrefillQueue if self.torch else JQueue)(self.fabric, ns)

    def context(self):
        return tp.Context() if self.torch else JContext()

    async def tokens(self, engine, prompt, max_tokens=8, sampling=None, ctx=None, lps=False):
        mod = self.mod
        req = mod.PreprocessedRequest(
            token_ids=list(prompt),
            sampling=sampling or mod.SamplingOptions(greedy=True, logprobs=lps or None),
            stop=mod.StopConditions(max_tokens=max_tokens, ignore_eos=True))
        toks, logprobs, reason = [], [], None
        async for out in engine.generate(req, ctx or self.context()):
            toks.extend(out.token_ids)
            logprobs.extend(out.log_probs or [])
            if out.finish_reason is not None:
                reason = out.finish_reason.value
        return (toks, logprobs, reason) if lps or ctx is not None else toks


SIDES = ("torch", "jax")


async def _local(prompts, chunk=CHUNK):
    jax_side = Side("jax")
    engine = jax_side.engine(chunk)
    try:
        return [await jax_side.tokens(engine, p) for p in prompts]
    finally:
        await engine.close()


async def _closing(*objs):
    for o in objs:
        await o.close()


# ------------------------------------------------------ tests/test_disagg.py

def _raw_queue_bytes(side, ns):
    """The bytes the fabric holds for the queue's first message."""
    st = side.fabric._state
    return st._queue(f"{ns}.prefill_queue").ready[0].payload


async def test_prefill_queue_round_trip_matches_the_reference():
    out = {}
    for name in SIDES:
        side = Side(name)
        q = side.queue("ns1")
        cls = RemotePrefillRequest if side.torch else JReq
        req = cls(request_id="r1", token_ids=[1, 2, 3], reply_subject="s", block_size=4,
                  key_data=[5, 6], deadline=12.5, extra={"a": 1})
        await q.enqueue(req)
        raw = _raw_queue_bytes(side, "ns1")
        depth1 = await q.depth()
        msg_id, back = await q.dequeue(timeout=1)
        acked = await q.ack(msg_id)
        out[name] = (raw, depth1, back.to_wire(), acked, await q.depth(),
                     await q.dequeue(timeout=0.05))
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == msgpack.packb(out["jax"][2], use_bin_type=True)
    assert out["torch"][1:] == (1, out["jax"][2], True, 0, None)


async def test_router_thresholds_and_live_update_match_the_reference():
    out = {}
    for name in SIDES:
        side = Side(name)
        r = side.router("ns2", threshold=50, queue_size=2)
        seen = [r.prefill_remote(50, 0), r.prefill_remote(51, 0), r.prefill_remote(100, 60)]
        q = side.queue("ns2")
        cls = RemotePrefillRequest if side.torch else JReq
        for i in range(2):
            await q.enqueue(cls(request_id=str(i), token_ids=[1], reply_subject="x"))
        await r.refresh_queue_depth()
        seen.append(r.prefill_remote(500, 0))
        # a value published before the watch starts is its initial snapshot
        await r.publish_config((DisaggConfig if side.torch else JConfig)(
            max_local_prefill_length=7, max_prefill_queue_size=9))
        await r.start_watching()
        seen.append((r.config.max_local_prefill_length, r.config.max_prefill_queue_size))
        await r.publish_config((DisaggConfig if side.torch else JConfig)(
            max_local_prefill_length=5))
        for _ in range(100):
            if r.config.max_local_prefill_length == 5:
                break
            await asyncio.sleep(0.01)
        seen.append(r.config.max_local_prefill_length)
        # a bad update is ignored
        await side.fabric.kv_put("disagg_router/ns2/decode", b"not json")
        await asyncio.sleep(0.05)
        seen.append(r.config.max_local_prefill_length)
        await r.close()
        out[name] = seen
    assert out["torch"] == out["jax"] == [False, True, False, False, (7, 9), 5, 5]


async def test_live_threshold_value_is_the_references_bytes():
    vals = {}
    for name in SIDES:
        side = Side(name)
        r = side.router("ns3")
        await r.publish_config((DisaggConfig if side.torch else JConfig)(
            max_local_prefill_length=11, max_prefill_queue_size=3))
        watch = await side.fabric.watch_prefix("disagg_router/ns3/decode")
        vals[name] = [ev.value for ev in watch.initial]
        await watch.cancel()
    assert vals["torch"] == vals["jax"] == [b'{"max_local_prefill_length": 11, '
                                            b'"max_prefill_queue_size": 3}']


async def _disagg_run(name, ns, prompts, chunk=CHUNK, stream=None, **service_kw):
    """Tokens of the prompts through one package's remote prefill, and its
    counters."""
    side = Side(name)
    prefill = side.engine(chunk)
    service = side.service(ns, prefill, **service_kw)
    await service.start()
    client = side.client(ns)
    await client.start()
    decode = side.engine(chunk, disagg_router=side.router(ns),
                         remote_prefill_client=client)
    try:
        outs = await asyncio.gather(*(side.tokens(decode, p) for p in prompts))
        return list(outs), dict(served=service.served, frames_rx=client.stats.frames_rx,
                                frames_tx=service.stats.frames_tx,
                                bytes_rx=client.stats.bytes_rx, bytes_tx=service.stats.bytes_tx,
                                decode=decode.stats, prefill=prefill.stats)
    finally:
        await _closing(decode, client, service, prefill)


async def test_disagg_end_to_end_matches_local_and_the_reference(monkeypatch):
    monkeypatch.setenv("DYN_KV_STREAM", "0")
    refs = await _local(PROMPTS, chunk=0)
    ours, s = await _disagg_run("torch", "disagg-e2e", PROMPTS, chunk=0)
    theirs, r = await _disagg_run("jax", "disagg-e2e", PROMPTS, chunk=0)
    assert ours == theirs == refs
    assert s["served"] == r["served"] == len(PROMPTS)  # all went remote
    assert s["decode"].remote_prefills == 3 and s["decode"].remote_fallbacks == 0
    # the same payload bytes crossed (the codec is the reference's)
    assert s["bytes_rx"] == s["bytes_tx"] == r["bytes_rx"] == r["bytes_tx"] > 0


async def test_disagg_short_prompt_stays_local():
    prompt = [3, 4, 5]
    (ref,) = await _local([prompt])
    for name in SIDES:
        side = Side(name)
        client = side.client("disagg-local")
        await client.start()
        engine = side.engine(disagg_router=side.router("disagg-local", threshold=100),
                             remote_prefill_client=client)
        # no prefill worker exists: a remote prefill would time out
        got = await asyncio.wait_for(side.tokens(engine, prompt), timeout=20)
        await _closing(engine, client)
        assert got == ref
        assert client.stats.frames_rx == 0 and not client._pending


async def test_remote_failure_falls_back_local():
    prompt = list(range(2, 14))
    (ref,) = await _local([prompt])

    class FailingClient:
        block_size = BS

        async def prefill(self, token_ids, **kw):
            raise RuntimeError("prefill fleet down")

    for name in SIDES:
        side = Side(name)
        engine = side.engine(disagg_router=side.router("disagg-fb", threshold=1),
                             remote_prefill_client=FailingClient())
        got = await side.tokens(engine, prompt)
        await engine.close()
        assert got == ref
        if side.torch:
            assert engine.stats.remote_fallbacks == 1


# ----------------------------------------------- tests/test_disagg_stream.py

async def test_prefill_worker_drops_expired_entries():
    got = {}
    for name in SIDES:
        side = Side(name)
        engine = side.engine()
        service = side.service("stream-exp", engine)
        await service.start()
        sub = await side.fabric.subscribe("exp.reply")
        cls = RemotePrefillRequest if side.torch else JReq
        await side.queue("stream-exp").enqueue(cls(
            request_id="dead", token_ids=LONG, reply_subject="exp.reply", stream=True,
            deadline=time.time() - 5.0))
        msg = await sub.next(timeout=10)
        resp = (RemotePrefillResponse if side.torch else JResp).from_wire(
            mpack.unpackb(msg[1]) if side.torch else msgpack.unpackb(msg[1], raw=False))
        got[name] = (resp.code, resp.first_token, service.stats.dropped_expired,
                     engine.stats.prefill_dropped_expired, service.served)
        await sub.unsubscribe()
        await _closing(service, engine)
    assert got["torch"] == got["jax"] == ("deadline_exceeded", -1, 1, 1, 1)


async def test_streamed_disagg_token_identical_greedy_and_seeded():
    (ref,) = await _local([LONG])
    seen = {}
    for name in SIDES:
        side = Side(name)
        prefill = side.engine()
        service = side.service("stream-e2e", prefill)
        client = side.client("stream-e2e")
        await service.start()
        await client.start()
        decode = side.engine(disagg_router=side.router("stream-e2e"),
                             remote_prefill_client=client)
        local = side.engine()
        got = await side.tokens(decode, LONG)
        s = decode.stats
        seen[name] = (got, service.served, client.stats.frames_rx, s.kv_frames_rx,
                      service.stats.frames_tx, prefill.stats.kv_frames_tx,
                      service.stats.frames_inflight, 0.0 < s.kv_stream_overlap <= 1.0,
                      s.kv_bytes_overlapped > 0)
        # seeded sampling: the first token is drawn remotely from the
        # requester's stream, so it equals this package's local engine
        sampling = side.mod.SamplingOptions(temperature=0.9, seed=1234)
        assert (await side.tokens(decode, LONG, sampling=sampling)
                == await side.tokens(local, LONG, sampling=sampling))
        assert service.served == 2
        await _closing(decode, client, service, prefill, local)
    assert seen["torch"] == seen["jax"] == (ref, 1, 4, 4, 4, 4, 0, True, True)


class _Died(Exception):
    pass


def _dying_service(base):
    class DyingService(base):
        """SIGKILL mid stream: publishes ``die_after`` frames, then vanishes
        with no ack and no answer."""

        die_after = 2
        died = False

        async def _serve_one(self, msg_id, req):
            try:
                emit, drain = self._make_emit(req)
                sent = 0

                async def dying_emit(frame):
                    nonlocal sent
                    await emit(frame)
                    sent += 1
                    if sent >= self.die_after:
                        raise _Died()

                await self.engine.prefill_only_stream(req, dying_emit, cancelled=None)
                raise AssertionError("the stream outlived its death")
            except _Died:
                await drain()
                self.died = True
                self._stopped.set()
            finally:
                self._sem.release()

    return DyingService


async def test_midstream_worker_death_redelivery_idempotent():
    """A worker dying after two frames: the unacked request is redelivered
    to a healthy worker, which re-streams from block 0; the duplicate frames
    overwrite the same blocks and the tokens are unchanged."""
    (ref,) = await _local([LONG])
    seen = {}
    for name in SIDES:
        side = Side(name)
        ns = "stream-kill"
        side.fabric._state._queue(f"{ns}.prefill_queue").redeliver_after = 0.3
        prefill = side.engine()
        base = PrefillWorkerService if side.torch else JService
        dying = side.service(ns, prefill, cls=_dying_service(base))
        await dying.start()
        client = side.client(ns)
        await client.start()
        decode = side.engine(disagg_router=side.router(ns), remote_prefill_client=client)
        healthy = side.service(ns, prefill)

        async def start_healthy_after_death():
            while not dying.died:
                await asyncio.sleep(0.02)
            await healthy.start()

        starter = asyncio.get_running_loop().create_task(start_healthy_after_death())
        got = await side.tokens(decode, LONG)
        await starter
        seen[name] = (got, dying.died, healthy.served,
                      client.stats.frames_rx > healthy.stats.frames_tx)
        if side.torch:  # the JAX engine does not count its fallbacks
            assert decode.stats.remote_fallbacks == 0
        await _closing(decode, client, healthy, dying, prefill)
    assert seen["torch"] == seen["jax"] == (ref, True, 1, True)


def _lossy_service(base):
    class LossyService(base):
        def _make_emit(self, req):
            emit, drain = super()._make_emit(req)
            count = 0

            async def lossy_emit(frame):
                nonlocal count
                count += 1
                if count == 2:
                    return  # the frame vanishes on the wire
                await emit(frame)

            return lossy_emit, drain

    return LossyService


async def test_lost_frame_detected_and_falls_back_local():
    (ref,) = await _local([LONG])
    seen = {}
    for name in SIDES:
        side = Side(name)
        prefill = side.engine()
        base = PrefillWorkerService if side.torch else JService
        service = side.service("stream-loss", prefill, cls=_lossy_service(base))
        await service.start()
        client = side.client("stream-loss")
        await client.start()
        decode = side.engine(disagg_router=side.router("stream-loss"),
                             remote_prefill_client=client)
        got = await side.tokens(decode, LONG)
        seen[name] = (got, service.served, client.stats.frames_rx)
        if side.torch:
            assert decode.stats.remote_fallbacks == 1
        await _closing(decode, client, service, prefill)
    assert seen["torch"] == seen["jax"] == (ref, 1, 3)


class _SlowStream:
    """An engine whose frames go out slowly, so a cancel lands mid stream
    (and between the worker's chunks)."""

    def __init__(self, inner):
        self.inner = inner
        self.stats = inner.stats

    async def prefill_only_stream(self, req, emit, cancelled=None):
        async def slow_emit(frame):
            await emit(frame)
            await asyncio.sleep(0.2)

        return await self.inner.prefill_only_stream(req, slow_emit, cancelled=cancelled)

    async def prefill_only(self, req):
        return await self.inner.prefill_only(req)


async def _settle(pred, tries=300):
    for _ in range(tries):
        if pred():
            return True
        await asyncio.sleep(0.02)
    return pred()


async def test_decode_cancel_mid_stream_conserves_blocks():
    seen = {}
    for name in SIDES:
        side = Side(name)
        prefill = side.engine()
        service = side.service("stream-cancel", _SlowStream(prefill))
        await service.start()
        client = side.client("stream-cancel")
        await client.start()
        decode = side.engine(disagg_router=side.router("stream-cancel"),
                             remote_prefill_client=client)
        free, p_free = decode.allocator.free_count, prefill.allocator.free_count
        ctx = side.context()
        task = asyncio.get_running_loop().create_task(side.tokens(decode, LONG, ctx=ctx))
        assert await _settle(lambda: decode.stats.kv_frames_rx >= 1)
        ctx.kill()
        _, _, reason = await asyncio.wait_for(task, 30)
        assert await _settle(lambda: decode.allocator.free_count == free)
        assert await _settle(lambda: service.stats.streams_cancelled >= 1
                             and prefill.allocator.free_count == p_free)
        seen[name] = (reason in ("cancelled", "error"), client.stats.streams_cancelled >= 1,
                      service.stats.streams_cancelled >= 1)
        if side.torch:
            assert decode.stats.remote_fallbacks == 0
        await _closing(decode, client, service, prefill)
    assert seen["torch"] == seen["jax"] == (True, True, True)


async def test_int8_wire_parity_bounded_logprob_delta(monkeypatch):
    monkeypatch.setenv("DYN_KV_WIRE", "int8")
    local = Side("jax")
    ref_engine = local.engine()
    ref, ref_lps, _ = await local.tokens(ref_engine, LONG, lps=True)
    await ref_engine.close()
    seen = {}
    for name in SIDES:
        monkeypatch.setenv("DYN_KV_WIRE", "int8")
        side = Side(name)
        prefill = side.engine()
        service = side.service("stream-int8", prefill)
        client = side.client("stream-int8")
        await service.start()
        await client.start()
        decode = side.engine(disagg_router=side.router("stream-int8"),
                             remote_prefill_client=client)
        got, lps, _ = await side.tokens(decode, LONG, lps=True)
        # int8 KV is lossy: the same greedy tokens, logprobs within the
        # reference's bound, and under 0.6 of a bf16 run's wire bytes
        assert got == ref and len(lps) == len(ref_lps)
        assert max(abs(a - b) for a, b in zip(lps, ref_lps)) < 0.35
        int8_bytes = client.stats.bytes_rx
        monkeypatch.setenv("DYN_KV_WIRE", "bf16")
        assert await side.tokens(decode, LONG) == ref
        bf16_bytes = client.stats.bytes_rx - int8_bytes
        assert 0 < int8_bytes < 0.6 * bf16_bytes
        seen[name] = (int8_bytes, bf16_bytes, client.stats.frames_rx)
        await _closing(decode, client, service, prefill)
    assert seen["torch"] == seen["jax"]


async def test_a_payload_over_the_frame_limit_falls_back_local_at_once(monkeypatch):
    """A response whose packed size exceeds the fabric's frame limit is
    answered with ``too_large``: the decode worker prefills locally without
    waiting out its timeout, and the request is acked (no redelivery)."""
    monkeypatch.setenv("DYN_KV_STREAM", "0")
    (ref,) = await _local([LONG], chunk=0)
    side = Side("torch")
    monkeypatch.setattr(transfer.wire, "MAX_FRAME", 64 * 1024 + 4096)
    prefill = side.engine(0)
    service = side.service("too-large", prefill)
    client = side.client("too-large", timeout=60)
    await service.start()
    await client.start()
    decode = side.engine(0, disagg_router=side.router("too-large"), remote_prefill_client=client)
    t0 = time.monotonic()
    got = await side.tokens(decode, LONG)
    assert time.monotonic() - t0 < 20
    assert got == ref
    assert service.stats.too_large == 1 and service.served == 1
    assert decode.stats.remote_prefills == decode.stats.remote_fallbacks == 1
    assert await side.queue("too-large").depth() == 0
    await _closing(decode, client, service, prefill)


# ------------------------------------------- the graph, a prefill worker killed

async def test_disagg_graph_loses_no_request_when_a_prefill_worker_is_killed():
    """tiny-torch on the CPU, two PrefillWorkers: one is SIGKILLed with
    requests in flight; the queue redelivers its unacked work and every
    request completes (tests/test_fault_tolerance.py:116)."""
    from dynamo_tpu_torch.serve import _free_port, serve_graph
    from tests.test_torch_serve_graphs import chat, wait_models

    port = _free_port()
    # a thread a process: the graph's five processes beside the suite's
    sup = await serve_graph("dynamo_tpu_torch.graphs.disagg", extra_env={
        "DYN_HTTP_HOST": "127.0.0.1", "DYN_HTTP_PORT": str(port), "DYN_DEVICE": "cpu",
        "DYN_LEASE_TTL_S": "5", "DYN_MAX_LOCAL_PREFILL": "4", "DYN_PREFILL_TIMEOUT_S": "60",
        "OMP_NUM_THREADS": "1"},
        replica_overrides={"PrefillWorker": 2})
    prompt = " ".join(f"w{i % 50}" for i in range(24))  # over the local limit
    try:
        await wait_models(port, timeout=90)
        for _ in range(120):  # a healthy round trip before the fault
            st, _, _ = await chat(port, prompt, max_tokens=2)
            if st == 200:
                break
            await asyncio.sleep(0.5)
        else:
            raise AssertionError("the disagg graph never became healthy")

        async def one_with_retry():
            # a decode worker restarting under load may fail a request; what
            # is checked is that no prefill is LOST
            for _ in range(4):
                st, _, data = await chat(port, prompt, max_tokens=6)
                if st == 200:
                    return json.loads(data)
                await asyncio.sleep(2.0)
            return None

        tasks = [asyncio.create_task(one_with_retry()) for _ in range(4)]
        await asyncio.sleep(0.3)  # the work reaches the queue
        sup["PrefillWorker-0"].kill()
        bodies = await asyncio.wait_for(asyncio.gather(*tasks), timeout=120)
        for body in bodies:
            assert body is not None, "a request was lost after the prefill worker's kill"
            assert body["choices"][0]["message"]["content"]
    finally:
        await sup.stop_all()
