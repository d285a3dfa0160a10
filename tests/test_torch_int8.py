"""The port's int8 deployment against the JAX package, on the CPU.

int8 weight-only quantization of the dense projections
(``DYN_JAX_QUANTIZE_INT8``) and the int8-resident KV cache
(``DYN_KV_DTYPE=int8``), at the tiny sizes of the reference's own tests.
Inputs are made from a seed with numpy; parameters come from the JAX init
(``quantize=True``), carried over bit for bit with ``params_from_jax``.

* ``quantize_int8`` gives the JAX mantissas and bf16 scales bit for bit
  (an all-zero channel keeps scale 1); ``linear`` over int8 weights gives
  the JAX result bit for bit where every partial sum is exact (integer
  activations: f32, bf16 and int8 ones), and within rtol 1e-6 of it on
  random f32 activations (only the f32 summation order differs);
* the plain fused heads in their int8 mode (what ``chip_smoke.py`` and the
  ``cuda`` tests hold the int8 kernels against) equal the JAX Pallas heads
  in interpret mode and the port's unfused heads (f32, atol 1e-5);
* ``params_from_jax`` carries {"q": int8, "s": bf16} leaves bit for bit;
  ``load_hf_safetensors(quantize=True)`` equals the JAX loader's
  quantized parameters bit for bit (f32 and bf16);
* the runners, int8 weights and int8 KV on both sides, block 4: prefill and
  decode samples (tokens equal, logprobs within 1e-4: the K/V written by
  the two packages differ in the last f32 bits, so a mantissa at a rounding
  boundary may land one step apart) and the caches' scales (rtol 1e-5);
* ``TorchEngine`` and ``JaxEngine`` in that configuration, block size equal
  on both sides, stream identical greedy tokens: on the default admission
  path (packed, chunked, mixed-step prefill), and with fused decode and
  spec_k 3;
* ``build_torch_engine`` reads ``DYN_JAX_QUANTIZE_INT8`` and
  ``DYN_KV_DTYPE`` under the JAX factory's names and meanings, keeps the
  block size it is given, and ``default_num_blocks`` equals the JAX
  factory's int8 sizing for a given budget.
"""

import asyncio
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from dynamo_tpu.engine.jax_engine import factory as jfactory
from dynamo_tpu.engine.jax_engine.engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.engine.jax_engine.model_runner import ModelRunner
from dynamo_tpu.engine.jax_engine.weights import load_hf_safetensors as jax_load
from dynamo_tpu.models import llama as jl
from dynamo_tpu.ops import linear as jlin
from dynamo_tpu.pipeline.context import Context as JaxContext
from dynamo_tpu.protocols import common as jp
from dynamo_tpu_torch.engine.torch_engine import factory as tfactory
from dynamo_tpu_torch.engine.torch_engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.engine.torch_engine.model_runner import TorchModelRunner
from dynamo_tpu_torch.engine.torch_engine.weights import (
    init_params,
    load_hf_safetensors,
    params_from_jax,
)
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.ops import linear as tlin
from dynamo_tpu_torch.ops.basics import rope_freqs
from dynamo_tpu_torch.ops.layers import attn_out, qkv_head
from dynamo_tpu_torch.protocols import common as tp

ATOL = 1e-5


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# ------------------------------------------------------------ the op level


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_matches_jax_bit_for_bit(dtype):
    w = np.random.default_rng(0).standard_normal((48, 40)).astype(np.float32) * 0.3
    w[:, 7] = 0.0  # an all-zero channel: scale 1
    jw = jnp.asarray(w, getattr(jnp, dtype))
    tw = torch.from_numpy(np.asarray(jw.astype(jnp.float32))).to(getattr(torch, dtype))
    want = jlin.quantize_int8(jw)
    got = tlin.quantize_int8(tw)
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(_bits(got["s"]), _jbits(want["s"]))
    assert float(got["s"][7]) == 1.0 and not got["q"][:, 7].any()


def _int8_weight(K, N, seed):
    w = np.random.default_rng(seed).standard_normal((K, N)).astype(np.float32) * 0.2
    jw = jlin.quantize_int8(jnp.asarray(w))
    return jw, params_from_jax(jax.tree.map(np.asarray, jw), device="cpu")


@pytest.mark.parametrize("act", ["float32", "bfloat16", "int8"])
def test_linear_over_int8_weights_matches_jax_bit_for_bit(act):
    """Integer activations: every product and partial sum is exact in f32,
    so any summation order gives the same bits, then the same scale and
    cast."""
    jw, tw = _int8_weight(64, 24, 1)
    x = np.random.default_rng(2).integers(-8, 9, (5, 64))
    jx = jnp.asarray(x, getattr(jnp, act))
    tx = torch.from_numpy(x).to(getattr(torch, act))
    want = jlin.linear(jx, jw)
    got = tlin.linear(tx, tw)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_array_equal(_bits(got), _jbits(want))


def test_linear_over_int8_weights_matches_jax_on_random_activations():
    jw, tw = _int8_weight(96, 32, 3)
    x = np.random.default_rng(4).standard_normal((7, 96)).astype(np.float32)
    want = jlin.linear(jnp.asarray(x), jw)
    got = tlin.linear(torch.from_numpy(x), tw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


HIDDEN, HQ, D, EPS = 64, 4, 16, 1e-5


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_plain_int8_fused_qkv_rope_matches_pallas_and_unfused(G, bias):
    rng = np.random.default_rng(G + 10 * bias)
    hkv, M = HQ // G, 5
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x, norm = f(M, HIDDEN), 1.0 + 0.1 * f(HIDDEN)
    jws = [jlin.quantize_int8(jnp.asarray(0.2 * f(HIDDEN, n))) for n in (HQ * D, hkv * D, hkv * D)]
    tws = [params_from_jax(jax.tree.map(np.asarray, w), device="cpu") for w in jws]
    biases = [f(n) for n in (HQ * D, hkv * D, hkv * D)] if bias else [None] * 3
    tb = [None if b is None else torch.from_numpy(b) for b in biases]
    jb = [None if b is None else jnp.asarray(b) for b in biases]
    positions = rng.integers(0, 300, M)
    inv = rope_freqs(D, 10000.0, {"rope_type": "llama3", "factor": 8.0,
                                  "original_max_position_embeddings": 64})
    angles = torch.from_numpy(positions)[:, None].float() * inv
    cos, sin = torch.cos(angles), torch.sin(angles)
    kw = dict(eps=EPS, num_heads=HQ, num_kv_heads=hkv, head_dim=D)
    got = tlin.fused_qkv_rope(torch.from_numpy(x), torch.from_numpy(norm), *tws, cos, sin,
                              bq=tb[0], bk=tb[1], bv=tb[2], **kw)
    want = jlin.fused_qkv_rope(jnp.asarray(x), jnp.asarray(norm), *jws,
                               jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()),
                               bq=jb[0], bk=jb[1], bv=jb[2], interpret=True, **kw)
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(), hidden_size=HIDDEN, num_heads=HQ,
                              num_kv_heads=hkv, head_dim=D, rms_eps=EPS)
    layer = {"attn_norm": torch.from_numpy(norm), "wq": tws[0], "wk": tws[1], "wv": tws[2]}
    if bias:
        layer.update(bq=tb[0], bk=tb[1], bv=tb[2])
    unfused = qkv_head(torch.from_numpy(x), layer, cfg, inv, torch.from_numpy(positions))
    for g, w, u in zip(got, want, unfused):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
        np.testing.assert_allclose(g.numpy(), u.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("M", [1, 6])
def test_plain_int8_fused_attn_out_residual_matches_pallas_and_unfused(M):
    rng = np.random.default_rng(M)
    attn = rng.standard_normal((M, HQ * D)).astype(np.float32)
    x = rng.standard_normal((M, HIDDEN)).astype(np.float32)
    jw = jlin.quantize_int8(jnp.asarray(0.2 * rng.standard_normal((HQ * D, HIDDEN)), jnp.float32))
    tw = params_from_jax(jax.tree.map(np.asarray, jw), device="cpu")
    got = tlin.fused_attn_out_residual(torch.from_numpy(attn), tw, torch.from_numpy(x))
    want = jlin.fused_attn_out_residual(jnp.asarray(attn), jw, jnp.asarray(x), interpret=True)
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(), hidden_size=HIDDEN, num_heads=HQ, head_dim=D)
    unfused = attn_out(torch.from_numpy(attn), torch.from_numpy(x), {"wo": tw}, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), unfused.numpy(), atol=ATOL, rtol=0)


# --------------------------------------------------------------- weights


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _same_tree(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        t = got[name]
        assert tuple(t.shape) == np.asarray(ref).shape, name
        np.testing.assert_array_equal(_bits(t), _jbits(ref), err_msg=name)


def test_params_from_jax_carries_int8_leaves_bit_for_bit():
    cfg = jl.LlamaConfig.tiny(vocab_size=64)
    jparams = jl.init_params(cfg, jax.random.PRNGKey(0), jnp.bfloat16, quantize=True)
    got = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    _same_tree(got, jparams)
    assert got["layers"][0]["wq"]["q"].dtype == torch.int8
    assert got["layers"][0]["wq"]["s"].dtype == torch.bfloat16
    assert got["lm_head"]["q"].dtype == torch.int8


def test_init_params_quantizes_the_dense_projections_only():
    cfg = tl.LlamaConfig.tiny(vocab_size=64)
    p = init_params(cfg, seed=0, device="cpu", quantize=True)
    plain = init_params(cfg, seed=0, device="cpu")
    for name in ("wq", "wk", "wv", "wo", "wg", "wu", "wd"):
        w = p["layers"][1][name]
        assert w["q"].dtype == torch.int8 and w["s"].dtype == torch.bfloat16
        want = tlin.quantize_int8(plain["layers"][1][name])
        assert torch.equal(w["q"], want["q"]) and torch.equal(w["s"], want["s"])
    assert p["lm_head"]["q"].dtype == torch.int8
    assert p["embed"].dtype == torch.bfloat16 and p["layers"][0]["attn_norm"].dtype == torch.bfloat16


HF_LLAMA = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama", "vocab_size": 96,
    "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "rope_theta": 10000.0,
    "max_position_embeddings": 128, "tie_word_embeddings": False,
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_hf_safetensors_quantized_matches_the_jax_loader(tmp_path, dtype):
    (tmp_path / "config.json").write_text(json.dumps(HF_LLAMA))
    cfg = tl.LlamaConfig.from_model_dir(str(tmp_path))
    rng = np.random.default_rng(5)
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    t = {"model.embed_tokens.weight": rng.standard_normal((V, H)),
         "model.norm.weight": rng.standard_normal(H), "lm_head.weight": rng.standard_normal((V, H))}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = rng.standard_normal(H)
        t[p + "post_attention_layernorm.weight"] = rng.standard_normal(H)
        for name, shape in (("self_attn.q_proj", (cfg.q_dim, H)), ("self_attn.k_proj", (cfg.kv_dim, H)),
                            ("self_attn.v_proj", (cfg.kv_dim, H)), ("self_attn.o_proj", (H, cfg.q_dim)),
                            ("mlp.gate_proj", (I, H)), ("mlp.up_proj", (I, H)),
                            ("mlp.down_proj", (H, I))):
            t[p + name + ".weight"] = rng.standard_normal(shape) * shape[1] ** -0.5
    save_file({k: v.astype(np.float32) for k, v in t.items()}, str(tmp_path / "model.safetensors"))
    want = jax_load(str(tmp_path), jl.LlamaConfig.from_model_dir(str(tmp_path)), quantize=True,
                    dtype=getattr(jnp, dtype))
    got = load_hf_safetensors(str(tmp_path), cfg, device="cpu", dtype=getattr(torch, dtype),
                              quantize=True)
    _same_tree(got, want)
    assert got["layers"][1]["wd"]["q"].dtype == torch.int8


# ---------------------------------------------------------- runners, engines

BS, C, MAX_LEN, NB, MAX_BATCH, VOCAB = 4, 8, 64, 64, 4, 64


def _models(vocab=VOCAB):
    jcfg = jl.LlamaConfig.tiny(vocab_size=vocab)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32, quantize=True)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tl.LlamaConfig.tiny(vocab_size=vocab), tparams


def test_runners_prefill_and_decode_agree_with_int8_weights_and_kv():
    jcfg, jparams, tcfg, tparams = _models()
    kw = dict(num_blocks=NB, block_size=BS, max_batch=MAX_BATCH, max_model_len=MAX_LEN,
              prefill_chunk_tokens=0, kv_dtype="int8")
    jr = ModelRunner(jcfg, jparams, **kw)
    tr = TorchModelRunner(tcfg, tparams, device="cpu", **kw)
    assert tr.kv_quantized and jr.kv_quantized
    rng = np.random.default_rng(6)
    B = 2
    prompts = [[int(t) for t in rng.integers(1, VOCAB, n)] for n in (9, 14)]
    blocks = [list(range(1, 9)), list(range(9, 17))]
    fed = []
    for p, b in zip(prompts, blocks):
        jo = [np.asarray(a) for a in jr.prefill(p, b, 0.0, 1.0, 0)]
        to = tr.fetch_sample(tr.prefill(p, b, 0.0, 1.0, 0))
        np.testing.assert_array_equal(to[0].reshape(jo[0].shape), jo[0])
        np.testing.assert_allclose(to[1].reshape(jo[1].shape), jo[1], atol=1e-4, rtol=0)
        fed.append(int(to[0][0]))
    tables = np.zeros((B, MAX_LEN // BS), np.int32)
    for i, b in enumerate(blocks):
        tables[i, :len(b)] = b
    pos = np.array([len(p) for p in prompts], np.int32)
    zeros, ones, kz = np.zeros(B, np.float32), np.ones(B, np.float32), np.zeros(B, np.int32)
    for _ in range(6):
        slots = (tables[np.arange(B), pos // BS] * BS + pos % BS).astype(np.int32)
        toks = np.array(fed, np.int32)
        keys = np.zeros((B, 2), np.uint32)
        jo = [np.asarray(a) for a in jr.decode(toks, pos, tables, slots, zeros, ones, kz,
                                               keys=keys)]
        to = tr.fetch_sample(tr.decode(toks, pos, tables, slots, zeros, ones, kz,
                                       keys=keys.astype(np.int64)))
        np.testing.assert_array_equal(to[0].reshape(jo[0].shape), jo[0])
        np.testing.assert_allclose(to[1].reshape(jo[1].shape), jo[1], atol=1e-4, rtol=0)
        fed = [int(t) for t in to[0]]
        pos = pos + 1
    for j, t in ((jr.k_cache, tr.k_cache), (jr.v_cache, tr.v_cache)):
        np.testing.assert_allclose(t["s"].numpy(), np.asarray(j["s"]), rtol=1e-5, atol=0)
        # mantissas: at most one step apart where the f32 inputs straddle a
        # rounding boundary
        diff = np.abs(t["q"].numpy().astype(np.int32) - np.asarray(j["q"]).astype(np.int32))
        assert diff.max() <= 1


def _torch_engine(tparams, chunk=C, fused=False, spec_k=0, coverage=0.5, vocab=VOCAB,
                  max_batch=MAX_BATCH, max_len=MAX_LEN, nb=NB):
    runner = TorchModelRunner(
        tl.LlamaConfig.tiny(vocab_size=vocab), tparams, num_blocks=nb, block_size=BS,
        max_batch=max_batch, max_model_len=max_len, device="cpu", prefill_chunk_tokens=chunk,
        fused_decode=fused, kv_dtype="int8",
    )
    return TorchEngine(runner, TorchEngineConfig(
        max_batch=max_batch, block_size=BS, num_blocks=nb, max_model_len=max_len,
        watermark_blocks=2, spec_k=spec_k, spec_min_coverage=coverage))


def _jax_engine(jcfg, jparams, chunk=C, fused=False, spec_k=0, max_batch=MAX_BATCH,
                max_len=MAX_LEN, nb=NB):
    runner = ModelRunner(jcfg, jparams, num_blocks=nb, block_size=BS, max_batch=max_batch,
                         max_model_len=max_len, kv_dtype="int8", prefill_chunk_tokens=chunk,
                         fused_decode=fused)
    return JaxEngine(runner, JaxEngineConfig(
        max_batch=max_batch, block_size=BS, num_blocks=nb, max_model_len=max_len,
        watermark_blocks=2, spec_k=spec_k, **({"decode_horizon": 1} if spec_k else {})))


def _request(mod, prompt, max_tokens):
    return mod.PreprocessedRequest(
        token_ids=list(prompt), sampling=mod.SamplingOptions(greedy=True),
        stop=mod.StopConditions(max_tokens=max_tokens, ignore_eos=True),
    )


async def _collect(engine, req, ctx, first=None):
    toks = []
    async for out in engine.generate(req, ctx):
        toks.extend(out.token_ids)
        if first is not None and toks:
            first.set()
    return toks


LONG = [int(t) for t in np.random.default_rng(1).integers(1, VOCAB, 40)]
LONG2 = [int(t) for t in np.random.default_rng(2).integers(1, VOCAB, 30)]


async def _overlapped(engine, mod, ctx):
    """A 40-token prompt is chunked alone and then decodes 24 tokens;
    meanwhile a 30-token prompt is chunked beside it and two short prompts
    are packed into one prefill."""
    first = asyncio.Event()
    a = asyncio.create_task(_collect(engine, _request(mod, LONG, 24), ctx(), first))
    await asyncio.wait_for(first.wait(), 60)
    rest = [(LONG2, 6), ([1, 2, 3], 12), ([9, 8, 7, 6, 5], 10)]
    outs = await asyncio.gather(*(_collect(engine, _request(mod, p, n), ctx()) for p, n in rest))
    out = [await a, *outs]
    await engine.close()
    return out


async def test_default_path_int8_engine_streams_jax_engines_greedy_tokens():
    jcfg, jparams, _, tparams = _models()
    want = await _overlapped(_jax_engine(jcfg, jparams), jp, JaxContext)
    engine = _torch_engine(tparams)
    got = await _overlapped(engine, tp, tp.Context)
    assert got == want
    assert [len(t) for t in got] == [24, 6, 12, 10]
    s = engine.stats
    assert s.packed_prefills > 0 and s.chunk_steps > 0 and s.mixed_steps > 0
    assert engine.runner.kv_quantized and engine.allocator.free_count == NB - 1


SPEC_VOCAB, SPEC_BATCH, SPEC_LEN, SPEC_NB = 24, 6, 96, 96


def _quoting_prompts():
    """Six prompts that repeat a random segment 2-4 times: the n-gram
    drafter drafts on most steps."""
    rng = np.random.default_rng(7)
    return [[int(t) for t in rng.integers(0, SPEC_VOCAB, 4 + i)] * (2 + i % 3) for i in range(6)]


async def test_fused_spec_int8_engine_streams_jax_engines_greedy_tokens():
    jcfg, jparams, _, tparams = _models(vocab=SPEC_VOCAB)
    kw = dict(chunk=0, fused=True, spec_k=3, max_batch=SPEC_BATCH, max_len=SPEC_LEN, nb=SPEC_NB)
    jeng = _jax_engine(jcfg, jparams, **kw)
    teng = _torch_engine(tparams, vocab=SPEC_VOCAB, **kw)
    lens = [14, 18, 12, 20, 16, 15]

    async def serve(engine, mod, ctx):
        try:
            return await asyncio.gather(*(_collect(engine, _request(mod, p, n), ctx())
                                          for p, n in zip(_quoting_prompts(), lens)))
        finally:
            await engine.close()

    want = await serve(jeng, jp, JaxContext)
    got = await serve(teng, tp, tp.Context)
    assert got == want
    assert [len(t) for t in got] == lens
    ts, js = teng.stats, jeng.stats
    assert ts.verify_steps > 0 and ts.num_accepted_tokens > 0
    assert (ts.num_drafts, ts.num_accepted_tokens) == (js.num_drafts, js.num_accepted_tokens)


# ---------------------------------------------------------------- factory


def test_build_torch_engine_reads_the_jax_factorys_variables(monkeypatch):
    cfg = tl.LlamaConfig.tiny(vocab_size=64)
    for q, kv in (("1", "int8"), ("0", "bf16"), ("true", "INT8"), ("", "fp8")):
        monkeypatch.setenv("DYN_JAX_QUANTIZE_INT8", q)
        monkeypatch.setenv("DYN_KV_DTYPE", kv)
        assert tfactory.quantize_from_env() == (
            jfactory.os.environ.get("DYN_JAX_QUANTIZE_INT8", "0") in ("1", "true"))
        assert tfactory.kv_dtype_from_env() == jfactory.kv_dtype_from_env()
    monkeypatch.setenv("DYN_JAX_QUANTIZE_INT8", "1")
    monkeypatch.setenv("DYN_KV_DTYPE", "int8")
    engine = tfactory.build_torch_engine(cfg, device="cpu", max_batch=2, max_model_len=64)
    runner = engine.runner
    assert runner.kv_quantized and runner.k_cache["q"].dtype == torch.int8
    assert runner.params["layers"][0]["wq"]["q"].dtype == torch.int8
    assert runner.block_size == 16  # not raised to 32 as the JAX factory does for Mosaic
    # the arguments win over the environment
    engine = tfactory.build_torch_engine(cfg, device="cpu", max_batch=2, max_model_len=64,
                                         quantize=False, kv_dtype="bf16")
    assert not engine.runner.kv_quantized
    assert isinstance(engine.runner.params["layers"][0]["wq"], torch.Tensor)


@pytest.mark.parametrize("quantized,kv_dtype", [(False, "bf16"), (True, "bf16"),
                                                (False, "int8"), (True, "int8")])
def test_default_num_blocks_matches_the_jax_sizing(monkeypatch, quantized, kv_dtype):
    """Llama-3.1-8B shapes under a 24 GiB budget, where the budget (not the
    lanes' want) decides: int8 weights free 8 GB for blocks, and an int8
    block costs about half a bf16 one."""
    monkeypatch.setenv("DYN_HBM_GB", "24")
    kw = dict(block_size=16, quantized=quantized, kv_dtype=kv_dtype)
    want = jfactory.default_num_blocks(jl.LlamaConfig.llama3_8b(), 131072, 64, **kw)
    got = tfactory.default_num_blocks(tl.LlamaConfig.llama3_8b(), 131072, 64,
                                      budget_bytes=24 * 2**30, dtype_bytes=2, **kw)
    assert got == want
    assert got < 64 * 131072 // 16  # the cap binds
