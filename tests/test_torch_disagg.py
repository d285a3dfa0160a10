"""The port's disaggregated prefill/decode against the JAX package, on the
CPU.

The reference's tiny Llama (f32, block 4, max_model_len 64), parameters
from the JAX init carried over bit for bit; inputs from numpy seeds.

* the payload codec, raw and int8, bf16 (uint16 words) and f32: the port's
  ``to_wire()`` dicts EQUAL the reference's (bytes, checksums and tags), and
  a payload encoded by either package decodes in the other BIT FOR BIT; the
  frame, request and response dicts equal too;
* the router's decision table equals ``DisaggregatedRouter.prefill_remote``'s;
* ``extract_blocks*`` / ``inject_blocks*`` over the same cache contents give
  the JAX runner's arrays and caches BIT FOR BIT (f32, bf16 and int8 caches);
* ``prefill_only`` gives ``JaxEngine.prefill_only``'s first token exactly and
  its payload within 1e-5 (two f32 pipelines; the same tolerance as the
  other runner parity tests), its header field for field;
* end to end, every disaggregated engine streams a local ``JaxEngine``'s
  greedy tokens EXACTLY: a hand-landed payload, a prompt under the threshold
  that stays local, a failing client and a lost frame that fall back to a
  local prefill, the colocated device path, streamed frames covering every
  block, and int8-resident engines on both roles; the colocated path runs
  ``prefill_only_device`` once per shipped prompt with no fallback and no
  wire codec;
* a cancel mid remote prefill returns every block on both engines;
* the router's live thresholds over the port's in-process fabric (and
  ValueError without one); an engine under a tensor-parallel group serving
  as a decode engine with a block manager, and as a prefill engine.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu import integrity as j_integrity
from dynamo_tpu.disagg import protocols as JP
from dynamo_tpu.disagg.router import DisaggConfig as JDisaggConfig
from dynamo_tpu.disagg.router import DisaggregatedRouter as JRouter
from dynamo_tpu.disagg.transfer import from_wire_array as j_from_wire
from dynamo_tpu.disagg.transfer import to_wire_array as j_to_wire
from dynamo_tpu.engine.jax_engine.engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.engine.jax_engine.model_runner import ModelRunner
from dynamo_tpu.fabric.client import FabricClient
from dynamo_tpu.models import llama as jl
from dynamo_tpu.pipeline.context import Context as JaxContext
from dynamo_tpu.protocols import common as jp
from dynamo_tpu_torch import integrity as t_integrity
from dynamo_tpu_torch.disagg import protocols as TP
from dynamo_tpu_torch.disagg.colocated import ColocatedPrefillClient, HostPrefillClient
from dynamo_tpu_torch.disagg.router import DisaggConfig, DisaggregatedRouter
from dynamo_tpu_torch.engine.torch_engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.engine.torch_engine.model_runner import TorchModelRunner
from dynamo_tpu_torch.engine.torch_engine.weights import params_from_jax
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.protocols import common as tp

BS, MAX_LEN, NB, MAX_BATCH, VOCAB = 4, 64, 64, 4, 64
CHUNK = 8  # the streaming tests' chunk: two blocks a frame
TOL = dict(atol=1e-5, rtol=1e-5)
PROMPTS = [list(range(2, 2 + n)) for n in (9, 17, 23)]


# ------------------------------------------------------------------ codec

def _bf16_words(rng, shape):
    return rng.standard_normal(shape).astype(ml_dtypes.bfloat16).view(np.uint16)


def _arrays(dtype, seed=0, shape=(2, 3, 4, 2, 8)):
    rng = np.random.default_rng(seed)
    if dtype == "bfloat16":
        return _bf16_words(rng, shape), _bf16_words(rng, shape)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _logical(a, dtype):
    return a.view(ml_dtypes.bfloat16) if dtype == "bfloat16" else a


def _words(a):
    """Reference decode output (ml_dtypes bf16 or f32) in the port's wire
    form."""
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.mark.parametrize("codec", ["raw", "int8"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_payload_wire_dicts_equal_the_reference_and_decode_across(codec, dtype):
    k, v = _arrays(dtype)
    ours = TP.KvBlockPayload.encode(k, v, codec, dtype)
    ref = JP.KvBlockPayload.encode(_logical(k, dtype), _logical(v, dtype), codec)
    assert ours.to_wire() == ref.to_wire()
    assert ours.sum_algo == j_integrity.ALGO and ours.wire_nbytes == ref.wire_nbytes
    # the other package's payload decodes bit for bit
    for src, dst in ((ours, JP.KvBlockPayload), (ref, TP.KvBlockPayload)):
        back = dst.from_wire(src.to_wire()).decode()
        want = TP.KvBlockPayload.from_wire(ours.to_wire()).decode()
        for a, b in zip(back, want):
            np.testing.assert_array_equal(_words(a), b)
    if codec == "raw":
        for a, b in zip(ours.decode(), (k, v)):
            np.testing.assert_array_equal(a, b)


def test_int8_quantize_and_verbatim_payloads_equal_the_reference():
    k, v = _arrays("bfloat16", seed=3)
    q, s = TP.kv_quantize_int8(k, "bfloat16")
    jq, js = JP.kv_quantize_int8(_logical(k, "bfloat16"))
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(TP.kv_dequantize_int8(q, s, "bfloat16"),
                                  _words(JP.kv_dequantize_int8(jq, js, "bfloat16")))
    vq, vs = TP.kv_quantize_int8(v, "bfloat16")
    ours = TP.KvBlockPayload.from_quantized(q, s, vq, vs)
    assert ours.to_wire() == JP.KvBlockPayload.from_quantized(q, s, vq, vs).to_wire()
    for a, b in zip(ours.quantized_arrays(), (q, s, vq, vs)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        TP.KvBlockPayload.encode(k, v, "raw", "bfloat16").quantized_arrays()


@pytest.mark.parametrize("algo", ["xxh3", "b2b8"])
def test_checksums_equal_the_references_and_catch_a_flipped_bit(algo):
    data = np.random.default_rng(1).integers(0, 256, 4099, dtype=np.uint8).tobytes()
    assert t_integrity.checksum_with(algo, data, b"xy") == j_integrity.checksum_with(
        algo, data, b"xy")
    assert t_integrity.checksum_with("nope", data) is None
    k, v = _arrays("float32", seed=2)
    d = TP.KvBlockPayload.encode(k, v).to_wire()
    bad = bytearray(d["k"])
    bad[7] ^= 0x10
    for mod in (TP, JP):
        p = mod.KvBlockPayload.from_wire({**d, "k": bytes(bad)})
        with pytest.raises((t_integrity.IntegrityError, j_integrity.IntegrityError)):
            p.decode()


def test_frame_request_response_and_array_helpers_equal_the_reference():
    k, v = _arrays("bfloat16", seed=4)
    tpay = TP.KvBlockPayload.encode(k, v, "raw", "bfloat16")
    jpay = JP.KvBlockPayload.encode(_logical(k, "bfloat16"), _logical(v, "bfloat16"))
    tf = TP.KvStreamFrame(request_id="r", seq=2, first_block=4, payload=tpay, stamp={"ep": 1})
    jf = JP.KvStreamFrame(request_id="r", seq=2, first_block=4, payload=jpay, stamp={"ep": 1})
    assert tf.to_wire() == jf.to_wire()
    assert TP.KvStreamFrame.from_wire(jf.to_wire()).to_wire() == jf.to_wire()
    kw = dict(request_id="q", token_ids=[1, 2, 3], reply_subject="s", temperature=0.5,
              cached_blocks=1, rep_pen=1.1, key_data=[3, 4], eos_ids=[9, -1],
              eos_suppress=True, stream=True, deadline=12.5, extra={"a": 1})
    assert TP.RemotePrefillRequest(**kw).to_wire() == JP.RemotePrefillRequest(**kw).to_wire()
    assert TP.RemotePrefillRequest.from_wire({**kw, "unknown": 1}) == TP.RemotePrefillRequest(**kw)
    rkw = dict(request_id="q", first_token=5, first_block=1, streamed_blocks=2,
               first_logprob=-0.5, first_top=[[5, -0.5]], code=None)
    tr = TP.RemotePrefillResponse(payload=tpay, **rkw)
    jr = JP.RemotePrefillResponse(payload=jpay, **rkw)
    assert tr.to_wire() == jr.to_wire()
    assert TP.RemotePrefillResponse.from_wire(jr.to_wire()).to_wire() == jr.to_wire()
    # the array helpers: a bf16 tensor's words, and back without a copy
    t = torch.from_numpy(k.view(np.int16)).view(torch.bfloat16)
    np.testing.assert_array_equal(TP.to_wire_array(t), j_to_wire(_logical(k, "bfloat16")))
    back = TP.from_wire_array(k, "bfloat16")
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)
    np.testing.assert_array_equal(TP.to_wire_array(back),
                                  j_from_wire(k, "bfloat16").view(np.uint16))


# ----------------------------------------------------------------- router

def test_router_decision_table_equals_the_reference():
    for cfg in ((50, 2), (4, 100), (0, 1)):
        ours = DisaggregatedRouter(DisaggConfig(*cfg))
        ref = JRouter(FabricClient.in_process(), "t", JDisaggConfig(*cfg))
        for depth in (0, 1, 2, 150):
            ours._queue_depth_cache = ref._queue_depth_cache = depth
            for n in (1, 4, 5, 49, 50, 51, 200):
                for hit in (0, 3, 48):
                    assert ours.prefill_remote(n, hit) == ref.prefill_remote(n, hit)
    assert DisaggConfig() == DisaggConfig(**dataclasses.asdict(JDisaggConfig()))


async def test_router_refreshes_its_queue_depth_and_refuses_the_fabric():
    """The queue depth (any ``async depth()``) refreshes and a failed read
    counts as full; with the port's in-process fabric the thresholds are
    live (the published value, then a later put); without a fabric the two
    live-threshold methods raise ValueError."""
    from dynamo_tpu_torch.disagg.prefill_queue import PrefillQueue
    from dynamo_tpu_torch.fabric.client import FabricClient as TFabric

    class Queue:
        def __init__(self, depth):
            self.d = depth

        async def depth(self):
            if self.d is None:
                raise ConnectionError("queue down")
            return self.d

    r = DisaggregatedRouter(queue=Queue(2))
    assert r.prefill_remote(100)  # not refreshed yet: depth 0
    await r.maybe_refresh()
    assert not r.prefill_remote(100)
    r.queue.d = None
    await r.maybe_refresh(max_age=0.0)  # a failed read counts as full
    assert r._queue_depth_cache == r.config.max_prefill_queue_size
    assert await DisaggregatedRouter().refresh_queue_depth() == 0
    for call in (r.publish_config(DisaggConfig()), r.start_watching()):
        with pytest.raises(ValueError, match="needs a fabric"):
            await call
    fabric = TFabric.in_process()
    live = DisaggregatedRouter(namespace="ns", fabric=fabric)
    assert isinstance(live.queue, PrefillQueue) and await live.refresh_queue_depth() == 0
    await live.publish_config(DisaggConfig(max_local_prefill_length=7))
    await live.start_watching()
    assert live.config == DisaggConfig(max_local_prefill_length=7)
    await DisaggregatedRouter(namespace="ns", fabric=fabric).publish_config(
        DisaggConfig(max_local_prefill_length=3, max_prefill_queue_size=5))
    for _ in range(100):
        if live.config.max_local_prefill_length == 3:
            break
        await asyncio.sleep(0.01)
    assert live.config == DisaggConfig(3, 5) and live.prefill_remote(4)
    await live.close()


# ------------------------------------------------------------ block plane

def _models(quantize=False):
    jcfg = jl.LlamaConfig.tiny(vocab_size=VOCAB)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32, quantize=quantize)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tparams


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast(v, dtype) for v in tree)
    return tree.to(dtype) if isinstance(tree, torch.Tensor) and tree.is_floating_point() else tree


KV_FORMS = {"f32": (jnp.float32, torch.float32, "bf16"),
            "bf16": (jnp.bfloat16, torch.bfloat16, "bf16"),
            "int8": ("int8", torch.float32, "int8")}


def _runner_pair(kv):
    jdtype, tdtype, tkv = KV_FORMS[kv]
    jcfg, jparams, tparams = _models()
    kw = dict(num_blocks=NB, block_size=BS, max_batch=MAX_BATCH, max_model_len=MAX_LEN,
              prefill_chunk_tokens=0)
    jr = ModelRunner(jcfg, jparams, kv_dtype=jdtype, **kw)
    tr = TorchModelRunner(tl.LlamaConfig.tiny(vocab_size=VOCAB), _cast(tparams, tdtype),
                          device="cpu", kv_dtype=tkv, **kw)
    return jr, tr


def _leaves(cache):
    return [cache["q"], cache["s"]] if isinstance(cache, dict) else [cache]


def _np(t):
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()


def _j_np(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _same_caches(jr, tr, quantized_by_xla=False):
    """Every block but null block 0, the garbage sink that the reference's
    padding lanes write (zeros) and the port never writes. Bit for bit,
    but where the reference's jitted inject quantized (``quantized_by_xla``):
    XLA computes its ``amax / 127`` as a product with the rounded
    reciprocal, one ulp off the true quotient now and then (the reference's
    own wire codec divides, as the port does), so there scales agree within
    one ulp and mantissas within one step."""
    for jc, tc in ((jr.k_cache, tr.k_cache), (jr.v_cache, tr.v_cache)):
        for j, t in zip(_leaves(jc), _leaves(tc)):
            got, want = _np(t)[:, :, 1:], _j_np(j)[:, :, 1:]
            if not quantized_by_xla:
                np.testing.assert_array_equal(got, want)
            elif got.dtype == np.float32:
                np.testing.assert_array_max_ulp(got, want, maxulp=1)
            else:
                assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("kv", sorted(KV_FORMS))
def test_extract_and_inject_equal_the_jax_runners_bit_for_bit(kv):
    """The JAX runner prefills, the port's cache takes its contents, then
    every extract gives the same arrays and every inject the same caches."""
    jr, tr = _runner_pair(kv)
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, VOCAB, 23).tolist()
    ids = [9, 3, 14, 27, 5, 11]
    jr.prefill(prompt, ids, 0.0, 1.0, 0)
    for jc, tc in ((jr.k_cache, tr.k_cache), (jr.v_cache, tr.v_cache)):
        for j, t in zip(_leaves(jc), _leaves(tc)):
            t.copy_(torch.from_numpy(np.array(j.astype(jnp.float32) if j.dtype == jnp.bfloat16
                                              else j)).to(t.dtype))
    _same_caches(jr, tr)
    some = [3, 27, 11, 9]
    for a, b in zip(tr.extract_blocks(some), jr.extract_blocks(some)):
        np.testing.assert_array_equal(a, _j_np(b))
    # the port never pads, so its one gather is also the reference's tight one
    np.testing.assert_array_equal(tr.extract_blocks(some)[0],
                                  _j_np(jr.extract_blocks_tight(some)[0]))
    k_dev, v_dev, n = tr.extract_blocks_device(some)
    jk, jv, jn = jr.extract_blocks_device(some)
    assert n == jn == len(some) and k_dev.device.type == "cpu"
    np.testing.assert_array_equal(_np(k_dev), _j_np(jk)[:, :, :n])
    # host inject of fresh blocks, then device inject of the extracted ones
    L, H, _, _, D = _leaves(tr.k_cache)[0].shape
    shape = (L, H, 3, BS, D)
    fresh = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    if kv != "f32":  # bf16 words: exact in both caches' forms
        fresh = [f.astype(ml_dtypes.bfloat16) for f in fresh]
    tr.inject_blocks([40, 41, 42], *[_j_np(f) for f in fresh])
    jr.inject_blocks([40, 41, 42], *fresh)
    tr.inject_blocks_device([50, 51, 52, 53], k_dev, v_dev)
    if kv == "int8":
        # the reference's inject_blocks_device raises over an int8 cache
        # without a mesh (model_runner.py:1568 asks the cache dict for its
        # devices); its host inject runs the same quantize-on-inject
        jr.inject_blocks([50, 51, 52, 53], np.asarray(jk)[:, :, :n], np.asarray(jv)[:, :, :n])
    else:
        jr.inject_blocks_device([50, 51, 52, 53], jk, jv)
    _same_caches(jr, tr, quantized_by_xla=kv == "int8")
    if kv == "int8":
        # the quantize-on-inject is the reference's wire codec bit for bit
        for ids_, blocks in (([40, 41, 42], fresh[0]), ([50, 51, 52, 53], np.asarray(jk))):
            q, s = JP.kv_quantize_int8(blocks[:, :, :len(ids_)])
            np.testing.assert_array_equal(tr.k_cache["q"][:, :, ids_].numpy(), q)
            np.testing.assert_array_equal(tr.k_cache["s"][:, :, ids_].numpy(), s)
        got = tr.extract_blocks_quant(some)
        want = jr.extract_blocks_quant(some)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))
        tr.inject_blocks_quant([60, 61, 62, 63], *got)
        jr.inject_blocks_quant([60, 61, 62, 63], *want)
        for c in (tr.k_cache, tr.v_cache):
            for part, want_ in zip(("q", "s"), got[:2] if c is tr.k_cache else got[2:]):
                np.testing.assert_array_equal(c[part][:, :, 60:64].numpy(), want_)
    else:
        with pytest.raises(ValueError):
            tr.extract_blocks_quant(some)


def test_injects_write_in_place_and_never_the_null_block():
    _, tr = _runner_pair("int8")
    ptrs = [t.data_ptr() for c in (tr.k_cache, tr.v_cache) for t in _leaves(c)]
    k, v, _ = tr.extract_blocks_device([1, 2])
    tr.inject_blocks_device([7, 8], k, v)
    tr.inject_blocks([9, 10], *tr.extract_blocks([1, 2]))
    tr.inject_blocks_quant([11, 12], *tr.extract_blocks_quant([1, 2]))
    assert ptrs == [t.data_ptr() for c in (tr.k_cache, tr.v_cache) for t in _leaves(c)]
    for bad in ([0, 3], [-1, 3]):
        with pytest.raises(ValueError, match="null block"):
            tr.inject_blocks_device(bad, k, v)
    with pytest.raises(ValueError, match="block ids"):
        tr.inject_blocks_device([7, 8, 9], k, v)


# ---------------------------------------------------------------- engines

def _torch_engine(tparams, chunk=0, kv="bf16", **kw):
    runner = TorchModelRunner(
        tl.LlamaConfig.tiny(vocab_size=VOCAB), tparams, num_blocks=NB, block_size=BS,
        max_batch=MAX_BATCH, max_model_len=MAX_LEN, device="cpu", prefill_chunk_tokens=chunk,
        kv_dtype=kv)
    return TorchEngine(runner, TorchEngineConfig(
        max_batch=MAX_BATCH, block_size=BS, num_blocks=NB, max_model_len=MAX_LEN,
        watermark_blocks=2), **kw)


def _jax_engine(jcfg, jparams, chunk=0, kv=jnp.float32):
    runner = ModelRunner(jcfg, jparams, num_blocks=NB, block_size=BS, max_batch=MAX_BATCH,
                         max_model_len=MAX_LEN, kv_dtype=kv, prefill_chunk_tokens=chunk)
    return JaxEngine(runner, JaxEngineConfig(
        max_batch=MAX_BATCH, block_size=BS, num_blocks=NB, max_model_len=MAX_LEN,
        watermark_blocks=2))


def _request(mod, prompt, max_tokens=8):
    return mod.PreprocessedRequest(
        token_ids=list(prompt), sampling=mod.SamplingOptions(greedy=True),
        stop=mod.StopConditions(max_tokens=max_tokens, ignore_eos=True))


async def _tokens(engine, prompt, mod=tp, ctx=None, max_tokens=8):
    toks, reason = [], None
    async for out in engine.generate(_request(mod, prompt, max_tokens),
                                     ctx or (tp.Context() if mod is tp else JaxContext())):
        toks.extend(out.token_ids)
        if out.finish_reason is not None:
            reason = out.finish_reason.value
    return toks, reason


async def _local(prompts, chunk=0, quantize=False):
    """The greedy tokens of a local JaxEngine (int8 weights and KV with
    ``quantize``)."""
    jcfg, jparams, _ = _models(quantize)
    engine = _jax_engine(jcfg, jparams, chunk, "int8" if quantize else jnp.float32)
    try:
        return [(await _tokens(engine, p, jp))[0] for p in prompts]
    finally:
        await engine.close()


def _router(threshold=4):
    return DisaggregatedRouter(DisaggConfig(max_local_prefill_length=threshold,
                                            max_prefill_queue_size=100))


def _remote_req(prompt):
    return TP.RemotePrefillRequest(request_id="x", token_ids=prompt, reply_subject="-",
                                   block_size=BS)


async def test_prefill_only_matches_the_jax_engines():
    jcfg, jparams, tparams = _models()
    prompt = list(range(2, 19))  # 4 full blocks and a tail
    ours_engine, ref_engine = _torch_engine(tparams), _jax_engine(jcfg, jparams)
    ours = await ours_engine.prefill_only(_remote_req(prompt))
    ref = await ref_engine.prefill_only(JP.RemotePrefillRequest(
        request_id="x", token_ids=prompt, reply_subject="-", block_size=BS))
    await ref_engine.close()
    assert ours.error is None and ours.first_token == ref.first_token
    assert ours.first_block == ref.first_block == 0
    assert [t for t, _ in ours.first_top] == [t for t, _ in ref.first_top]
    np.testing.assert_allclose(ours.first_logprob, ref.first_logprob, **TOL)
    od, rd = ours.payload.to_wire(), ref.payload.to_wire()
    assert {k: v for k, v in od.items() if k not in ("k", "v", "ksm", "vsm")} == {
        k: v for k, v in rd.items() if k not in ("k", "v", "ksm", "vsm")}
    for a, b in zip(ours.payload.decode(), ref.payload.decode()):
        np.testing.assert_allclose(a, b, **TOL)
    assert ours_engine.allocator.free_count == NB - 1  # scratch blocks freed
    assert ours_engine.stats.prefills_served == 1
    too_long = await ours_engine.prefill_only(_remote_req(list(range(MAX_LEN + 1))))
    assert too_long.first_token == -1 and "max_model_len" in too_long.error
    await ours_engine.close()


async def test_extract_inject_transfers_kv_exactly():
    """The reference's case: prefill on engine A, hand its payload to
    engine B through a stub client; B decodes as a local engine would."""
    _, _, tparams = _models()
    prompt = list(range(2, 19))
    (ref,) = await _local([prompt])
    a = _torch_engine(tparams)
    resp = await a.prefill_only(_remote_req(prompt))
    assert resp.payload.num_blocks == (len(prompt) + BS - 1) // BS

    class StubClient:
        async def prefill(self, token_ids, **kw):
            return resp

    b = _torch_engine(tparams, disagg_router=_router(1), remote_prefill_client=StubClient())
    got, _ = await _tokens(b, prompt)
    assert got == ref
    assert b.stats.remote_prefills == 1 and b.stats.remote_fallbacks == 0
    assert b.stats.prefills == b.stats.packed_prefills == 0
    assert b.stats.kv_wire_bytes_rx == resp.payload.wire_nbytes
    assert b.allocator.free_count == NB - 1
    await a.close()
    await b.close()


async def test_disagg_short_prompt_stays_local():
    _, _, tparams = _models()

    class NoClient:
        async def prefill(self, token_ids, **kw):
            raise AssertionError("a short prompt went remote")

    engine = _torch_engine(tparams, disagg_router=_router(100), remote_prefill_client=NoClient())
    prompt = [3, 4, 5]
    (ref,) = await _local([prompt])
    got, _ = await asyncio.wait_for(_tokens(engine, prompt), 20)
    assert got == ref and engine.stats.remote_prefills == 0 and engine.stats.prefills == 1
    await engine.close()


async def test_remote_failure_falls_back_local():
    _, _, tparams = _models()

    class FailingClient:
        async def prefill(self, token_ids, **kw):
            raise RuntimeError("prefill fleet down")

    engine = _torch_engine(tparams, disagg_router=_router(1),
                           remote_prefill_client=FailingClient())
    prompt = list(range(2, 14))
    (ref,) = await _local([prompt])
    got, _ = await _tokens(engine, prompt)
    assert got == ref
    assert engine.stats.remote_prefills == engine.stats.remote_fallbacks == 1
    await engine.close()


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
async def test_colocated_device_path_matches_local_and_really_runs_remotely(
        monkeypatch, quantize):
    """Every shipped prompt runs ``prefill_only_device`` once, nothing falls
    back, and the wire codec is never touched; the tokens are a local
    JaxEngine's (int8: int8 weights and KV on every engine; the device
    payload is dequantized to bf16 and quantized again on landing)."""
    _, _, tparams = _models(quantize)
    kv = "int8" if quantize else "bf16"
    refs = await _local(PROMPTS, quantize=quantize)
    prefill = _torch_engine(tparams, kv=kv)
    calls = []
    real = prefill.prefill_only_device

    async def counted(req):
        calls.append(len(req.token_ids))
        return await real(req)

    monkeypatch.setattr(prefill, "prefill_only_device", counted)

    def boom(*a, **k):
        raise AssertionError("wire codec used on the device path")

    for name in ("encode", "decode", "from_quantized", "quantized_arrays"):
        monkeypatch.setattr(TP.KvBlockPayload, name, boom)
    decode = _torch_engine(tparams, kv=kv, disagg_router=_router(),
                           remote_prefill_client=ColocatedPrefillClient(prefill, BS))
    outs = [(await _tokens(decode, p))[0] for p in PROMPTS]
    assert outs == refs
    assert calls == [len(p) for p in PROMPTS]
    s = decode.stats
    assert s.remote_prefills == len(PROMPTS) and s.remote_fallbacks == 0
    assert s.prefills == s.packed_prefills == s.chunk_steps == 0
    assert prefill.stats.prefills_served == len(PROMPTS)
    assert decode.allocator.free_count == prefill.allocator.free_count == NB - 1
    await decode.close()
    await prefill.close()


class LossyClient(HostPrefillClient):
    """Drops the second streamed frame on its way to the decode engine."""

    async def prefill(self, token_ids, *, on_frame=None, **kw):
        count = 0

        async def lossy(frame):
            nonlocal count
            count += 1
            if count != 2:
                await on_frame(frame)

        return await super().prefill(token_ids, on_frame=lossy, **kw)


@pytest.mark.parametrize("client", ["stream", "monolithic", "lossy", "int8"])
async def test_host_payload_paths_match_local(client, monkeypatch):
    """Streamed frames cover every block but the tail, which the final
    payload carries; a monolithic answer (``DYN_KV_STREAM=0``) carries them
    all; a lost frame is detected and falls back to a local prefill;
    int8-resident engines ship mantissas and scales verbatim. Tokens equal
    a local JaxEngine's."""
    monkeypatch.setenv("DYN_KV_STREAM", "0" if client == "monolithic" else "1")
    quantize = client == "int8"
    _, _, tparams = _models(quantize)
    kv = "int8" if quantize else "bf16"
    prompt = list(range(2, 42))  # 40 tokens: 5 chunks, 4 frames of 2 blocks
    (ref,) = await _local([prompt], CHUNK, quantize)
    prefill = _torch_engine(tparams, CHUNK, kv)
    cls = LossyClient if client == "lossy" else HostPrefillClient
    decode = _torch_engine(tparams, CHUNK, kv, disagg_router=_router(),
                           remote_prefill_client=cls(prefill, BS))
    got, _ = await _tokens(decode, prompt)
    assert got == ref
    s, p = decode.stats, prefill.stats
    assert s.remote_prefills == 1 and s.chunk_steps == s.mixed_steps == 0
    if client == "lossy":
        assert s.remote_fallbacks == 1 and s.prefills == 1 and s.kv_frames_rx == 3
    elif client == "monolithic":
        assert s.remote_fallbacks == 0 and p.kv_frames_tx == 0
        assert s.kv_wire_bytes_rx == p.kv_wire_bytes_tx > 0
    else:
        assert s.remote_fallbacks == s.prefills == 0
        assert s.kv_frames_rx == p.kv_frames_tx == 4 and 0 < s.kv_stream_overlap < 1
        assert s.kv_wire_bytes_rx == p.kv_wire_bytes_tx
    assert decode.allocator.free_count == prefill.allocator.free_count == NB - 1
    await decode.close()
    await prefill.close()


async def test_a_cancel_mid_remote_prefill_conserves_blocks():
    """The reference's mid-stream cancel (test_disagg_stream.py:512): the
    request is killed after a frame landed; the stream stops between
    chunks, the sequence finishes cancelled, both engines get every block
    back."""
    _, _, tparams = _models()
    prefill = _torch_engine(tparams, CHUNK)
    real = prefill.prefill_only_stream

    async def slow(req, emit, cancelled=None):
        async def slow_emit(frame):
            await emit(frame)
            await asyncio.sleep(0.2)

        return await real(req, slow_emit, cancelled=cancelled)

    prefill.prefill_only_stream = slow
    decode = _torch_engine(tparams, CHUNK, disagg_router=_router(),
                           remote_prefill_client=HostPrefillClient(prefill, BS))
    ctx = tp.Context()
    task = asyncio.create_task(_tokens(decode, list(range(2, 42)), ctx=ctx))
    for _ in range(300):
        if decode.stats.kv_frames_rx >= 1:
            break
        await asyncio.sleep(0.02)
    assert decode.stats.kv_frames_rx >= 1
    ctx.kill()
    toks, reason = await asyncio.wait_for(task, 30)
    assert reason == "cancelled"
    for _ in range(300):
        if decode.allocator.free_count == prefill.allocator.free_count == NB - 1:
            break
        await asyncio.sleep(0.02)
    assert decode.allocator.free_count == prefill.allocator.free_count == NB - 1
    assert prefill.stats.kv_frames_tx < 4 and decode.stats.remote_fallbacks == 0
    await decode.close()
    await prefill.close()


async def test_a_landed_lane_joins_a_horizon_beside_running_lanes():
    """A decode engine at H 4: a local lane is decoding when a shipped
    prompt lands; both stream a local JaxEngine's tokens."""
    jcfg, jparams, tparams = _models()
    ref_engine = _jax_engine(jcfg, jparams)
    refs = [(await _tokens(ref_engine, p, jp, max_tokens=12))[0] for p in ([3, 4], PROMPTS[2])]
    await ref_engine.close()
    prefill = _torch_engine(tparams)
    decode = _torch_engine(tparams, disagg_router=_router(),
                           remote_prefill_client=ColocatedPrefillClient(prefill, BS))
    decode.config.decode_horizon = 4
    first = asyncio.create_task(_tokens(decode, [3, 4], max_tokens=12))
    for _ in range(20000):
        if decode.stats.generated_tokens >= 2:
            break
        await asyncio.sleep(0.001)
    second = await _tokens(decode, PROMPTS[2], max_tokens=12)
    assert [(await first)[0], second[0]] == refs
    assert decode.stats.horizon_dispatches > 0 and decode.stats.remote_prefills == 1
    await decode.close()
    await prefill.close()


async def test_an_engine_under_a_tensor_parallel_group_refuses_disaggregation(monkeypatch):
    """Once refused, now served: a tp = 2 TorchEngine (gloo ranks on the
    CPU) takes a router, a remote prefill client and a block manager, and
    streams a shipped prompt's greedy tokens equal to a JaxEngine over a
    tp = 2 mesh; as a prefill engine its device role gives the dense
    blocks."""
    from dynamo_tpu.parallel.mesh import build_mesh
    from dynamo_tpu.parallel.sharding import shard_llama
    from dynamo_tpu_torch.block_manager import LayoutConfig, TieredBlockManager
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned follower's threads
    jcfg, jparams, tparams = _models()
    mesh = build_mesh(tp=2)
    sp, kv_sharding = shard_llama(mesh, jcfg, jparams)
    ref = JaxEngine(ModelRunner(jcfg, sp, num_blocks=NB, block_size=BS, max_batch=MAX_BATCH,
                                max_model_len=MAX_LEN, kv_dtype=jnp.float32,
                                prefill_chunk_tokens=0, mesh=mesh, kv_sharding=kv_sharding),
                    JaxEngineConfig(max_batch=MAX_BATCH, block_size=BS, num_blocks=NB,
                                    max_model_len=MAX_LEN, watermark_blocks=2))
    want = (await _tokens(ref, PROMPTS[1], jp))[0]
    await ref.close()
    cfg = tl.LlamaConfig.tiny(vocab_size=VOCAB)
    engine = build_torch_engine(cfg, device="cpu", params=tparams, dtype=torch.float32,
                                kv_block_size=BS, max_batch=MAX_BATCH, num_blocks=NB,
                                max_model_len=MAX_LEN, prefill_chunk_tokens=0,
                                tensor_parallel_size=2)
    prefill = _torch_engine(tparams)
    try:
        assert engine.runner.group.world_size == 2
        engine.disagg_router = _router()
        engine.remote_prefill_client = HostPrefillClient(prefill, BS)
        engine.block_manager = TieredBlockManager(LayoutConfig(
            num_layers=cfg.num_layers, page_size=BS, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, dtype="float32"), 32)
        got, reason = await _tokens(engine, PROMPTS[1])
        assert got == want and reason == "length"
        assert engine.stats.remote_prefills == 1 and engine.stats.remote_fallbacks == 0
        resp = await engine.prefill_only_device(_remote_req(PROMPTS[1]))
        assert resp.error is None and resp.num_blocks == 5
        assert tuple(resp.k_dev.shape) == (cfg.num_layers, cfg.num_kv_heads, 5, BS, cfg.head_dim)
        k, _ = engine.runner.extract_blocks([1])
        assert k.shape[1] == cfg.num_kv_heads
    finally:
        await engine.close()
        await prefill.close()
