"""The port's fused decode-step heads against the JAX package, on the CPU.

``fused_qkv_rope`` (RMSNorm -> Q/K/V -> bias -> RoPE) and
``fused_attn_out_residual`` (o-proj -> residual) in their plain versions are
what ``chip_smoke.py`` and the ``cuda`` tests hold the CUDA kernels against,
so they are checked here against the JAX package's Pallas programs in
interpret mode (``interpret=True``, as its own tests run them) and against
the port's unfused heads (ops/layers.py). f32 inputs made with numpy, atol
1e-5 (same op sequence; only the summation order differs). Then the model:
``llama.decode`` with ``fused_decode`` on equals it off (f32 logits, rtol
1e-4), and layers with qk-norm or a sandwich norm keep the unfused heads.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jl
from dynamo_tpu.ops import linear as jlin
from dynamo_tpu_torch.engine.torch_engine.weights import init_params, params_from_jax
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.ops import linear as tlin
from dynamo_tpu_torch.ops.basics import rope_freqs
from dynamo_tpu_torch.ops.layers import attn_out, qkv_head

ATOL = 1e-5
HIDDEN, HQ, D, EPS = 64, 4, 16, 1e-5


def _qkv_inputs(G, bias, M=5, seed=0):
    rng = np.random.default_rng(seed)
    hkv = HQ // G
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    arrs = {
        "x": f(M, HIDDEN), "norm": 1.0 + 0.1 * f(HIDDEN),
        "wq": 0.2 * f(HIDDEN, HQ * D), "wk": 0.2 * f(HIDDEN, hkv * D),
        "wv": 0.2 * f(HIDDEN, hkv * D),
        "bq": None, "bk": None, "bv": None,
    }
    if bias:
        arrs.update(bq=f(HQ * D), bk=f(hkv * D), bv=f(hkv * D))
    positions = rng.integers(0, 300, M)
    inv = rope_freqs(D, 10000.0, {"rope_type": "llama3", "factor": 8.0,
                                  "original_max_position_embeddings": 64})
    angles = torch.from_numpy(positions)[:, None].float() * inv
    return arrs, hkv, torch.from_numpy(positions), inv, torch.cos(angles), torch.sin(angles)


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_plain_fused_qkv_rope_matches_pallas_and_unfused(G, bias):
    arrs, hkv, positions, inv, cos, sin = _qkv_inputs(G, bias, seed=G + 10 * bias)
    t = {k: None if v is None else torch.from_numpy(v) for k, v in arrs.items()}
    kw = dict(eps=EPS, num_heads=HQ, num_kv_heads=hkv, head_dim=D)
    got = tlin.fused_qkv_rope(
        t["x"], t["norm"], t["wq"], t["wk"], t["wv"], cos, sin,
        bq=t["bq"], bk=t["bk"], bv=t["bv"], **kw,
    )
    j = {k: None if v is None else jnp.asarray(v) for k, v in arrs.items()}
    want = jlin.fused_qkv_rope(
        j["x"], j["norm"], j["wq"], j["wk"], j["wv"],
        jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()),
        bq=j["bq"], bk=j["bk"], bv=j["bv"], interpret=True, **kw,
    )
    cfg = dataclasses.replace(
        tl.LlamaConfig.tiny(), hidden_size=HIDDEN, num_heads=HQ,
        num_kv_heads=hkv, head_dim=D, rms_eps=EPS,
    )
    layer = {"attn_norm": t["norm"], "wq": t["wq"], "wk": t["wk"], "wv": t["wv"]}
    if bias:
        layer.update(bq=t["bq"], bk=t["bk"], bv=t["bv"])
    unfused = qkv_head(t["x"], layer, cfg, inv, positions)
    for g, w, u in zip(got, want, unfused):
        assert g.shape == u.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
        np.testing.assert_allclose(g.numpy(), u.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("M", [1, 6])
def test_plain_fused_attn_out_residual_matches_pallas_and_unfused(M):
    rng = np.random.default_rng(M)
    attn = rng.standard_normal((M, HQ * D)).astype(np.float32)
    wo = (0.2 * rng.standard_normal((HQ * D, HIDDEN))).astype(np.float32)
    x = rng.standard_normal((M, HIDDEN)).astype(np.float32)
    got = tlin.fused_attn_out_residual(*(torch.from_numpy(a) for a in (attn, wo, x)))
    want = jlin.fused_attn_out_residual(
        jnp.asarray(attn), jnp.asarray(wo), jnp.asarray(x), interpret=True
    )
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(), hidden_size=HIDDEN, num_heads=HQ, head_dim=D)
    unfused = attn_out(torch.from_numpy(attn), torch.from_numpy(x), {"wo": torch.from_numpy(wo)}, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), unfused.numpy(), atol=ATOL, rtol=0)


def test_fused_heads_refuse_int8_weights_and_partial_out():
    """The int8 mode is ported (tests/test_torch_int8.py), but one head
    takes all of its weights int8 or none of them: a mixed head is refused,
    as is a mantissa that is not int8; partial_out (the tensor-parallel raw
    partial) is not ported yet."""
    x = torch.zeros(2, HIDDEN)
    w = torch.zeros(HIDDEN, HQ * D)
    q8 = {"q": w.to(torch.int8), "s": torch.ones(HQ * D)}
    cs = torch.zeros(2, D // 2)
    kw = dict(eps=EPS, num_heads=HQ, num_kv_heads=HQ, head_dim=D)
    with pytest.raises(TypeError, match="all of its weights int8"):
        tlin.fused_qkv_rope(x, x[0], q8, w, w, cs, cs, **kw)
    with pytest.raises(TypeError, match="int8 mantissas"):
        tlin.fused_attn_out_residual(x, {"q": w.T, "s": torch.ones(HIDDEN)}, x)
    with pytest.raises(NotImplementedError):
        tlin.fused_attn_out_residual(x, w.T, x, partial_out=True)


# ------------------------------------------------------------------ model

LLAMA3_SCALING = {
    "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
    "high_freq_factor": 4.0, "original_max_position_embeddings": 64,
}
VARIANTS = {
    "llama": {},
    "llama3_rope_gqa4": {"rope_scaling": LLAMA3_SCALING, "num_kv_heads": 1},
    "qwen2_bias_window": {"attn_bias": True, "sliding_window": 6},
}
BS, NB = 4, 32


def _params(variant):
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=128), **VARIANTS[variant])
    params = jl.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    if jcfg.attn_bias:  # the JAX init leaves biases at zero; make them bite
        rng = np.random.default_rng(0)
        for layer in params["layers"]:
            for name in ("bq", "bk", "bv"):
                layer[name] = jnp.asarray(rng.standard_normal(layer[name].shape) * 0.5, jnp.float32)
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=128), **VARIANTS[variant])
    return tcfg, params_from_jax(jax.tree.map(np.asarray, params), device="cpu")


def _decode_logits(cfg, params, steps=3):
    """Prefill two prompts, then `steps` batched decode steps; the logits
    of every call, stacked."""
    shape = (cfg.num_layers, cfg.num_kv_heads, NB, BS, cfg.head_dim)
    k, v = torch.zeros(shape), torch.zeros(shape)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 128, 10), rng.integers(0, 128, 5)]
    tables = torch.tensor([[3, 5, 9, 11, 0, 0], [7, 2, 4, 0, 0, 0]], dtype=torch.int32)
    out, last = [], []
    for b, p in enumerate(prompts):
        toks = torch.zeros(12, dtype=torch.long)
        toks[: len(p)] = torch.from_numpy(p)
        lg = tl.prefill(params, cfg, toks, len(p), k, v, tables[b, :3].long())
        out.append(lg)
        last.append(int(lg.argmax()))
    pos = torch.tensor([10, 5])
    toks = torch.tensor(last)
    for _ in range(steps):
        slots = tables[torch.arange(2), pos // BS].long() * BS + pos % BS
        lg = tl.decode(params, cfg, toks, pos, k, v, tables, slots)
        out.append(lg)
        toks, pos = lg.argmax(-1), pos + 1
    return torch.cat([o.reshape(-1, 128) for o in out])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_fused_on_equals_off(variant):
    cfg, params = _params(variant)
    off = _decode_logits(cfg, params)
    on = _decode_logits(dataclasses.replace(cfg, fused_decode=True), params)
    np.testing.assert_allclose(on.numpy(), off.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", ["qk_norm", "sandwich_norms"])
def test_qk_norm_and_sandwich_layers_keep_the_unfused_heads(family, monkeypatch):
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=128), **{family: True})
    params = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    want = _decode_logits(cfg, params, steps=1)

    def refuse(*a, **k):
        raise AssertionError("a fused head ran on a layer it does not cover")

    monkeypatch.setattr(tl, "fused_qkv_rope", refuse)
    monkeypatch.setattr(tl, "fused_attn_out_residual", refuse)
    fused_cfg = dataclasses.replace(cfg, fused_decode=True)
    assert not any(tl._use_fused_decode(fused_cfg, layer) for layer in params["layers"])
    got = _decode_logits(fused_cfg, params, steps=1)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_plain_llama_layers_do_take_the_fused_heads(monkeypatch):
    cfg, params = _params("llama")
    calls = {"qkv": 0, "out": 0}
    real_qkv, real_out = tl.fused_qkv_rope, tl.fused_attn_out_residual

    def qkv(*a, **k):
        calls["qkv"] += 1
        return real_qkv(*a, **k)

    def out(*a, **k):
        calls["out"] += 1
        return real_out(*a, **k)

    monkeypatch.setattr(tl, "fused_qkv_rope", qkv)
    monkeypatch.setattr(tl, "fused_attn_out_residual", out)
    _decode_logits(dataclasses.replace(cfg, fused_decode=True), params, steps=2)
    # two decode steps x two layers; prefill keeps the unfused heads
    assert calls == {"qkv": 4, "out": 4}
