"""The port's Llama forward pass against the JAX package's, on the CPU.

Parameters are made once by the JAX init and carried over bit for bit with
``params_from_jax``; the same tokens and block tables go to
``llama.prefill`` / ``llama.decode`` on both sides. In f32 the logits agree
to rtol 1e-4 (same op sequence, different summation order and XLA fusion).
bf16 rounds at other places in the two frameworks, so the bf16 case is held
to 3% of the logits' scale instead.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.engine.torch_engine.weights import init_params, params_from_jax
from dynamo_tpu_torch.models import llama as tl

LLAMA3_SCALING = {
    "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
    "high_freq_factor": 4.0, "original_max_position_embeddings": 64,
}
VARIANTS = {
    "llama": {},
    "llama3_rope": {"rope_scaling": LLAMA3_SCALING},
    "qwen2_bias_window": {"attn_bias": True, "sliding_window": 6},
    "gemma2_like": {
        "mlp_act": "gelu_tanh", "embed_scale": True, "sandwich_norms": True,
        "attn_logit_softcap": 20.0, "final_logit_softcap": 15.0,
        "query_pre_attn_scalar": 24.0, "tie_word_embeddings": True,
        "sliding_window": 5, "layer_pattern": (True, False),
    },
}
BS, NB = 4, 32


def _configs(variant):
    kw = VARIANTS[variant]
    return (
        dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=128), **kw),
        dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=128), **kw),
    )


def _jax_params(jcfg, dtype, seed=0):
    params = jl.init_params(jcfg, jax.random.PRNGKey(seed), dtype)
    if jcfg.attn_bias:  # the JAX init leaves biases at zero; make them bite
        rng = np.random.default_rng(seed)
        for layer in params["layers"]:
            for name in ("bq", "bk", "bv"):
                layer[name] = jnp.asarray(
                    rng.standard_normal(layer[name].shape) * 0.5, dtype
                )
    return params


def _run_both(variant, jdtype, tdtype):
    jcfg, tcfg = _configs(variant)
    jparams = _jax_params(jcfg, jdtype)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    shape = (jcfg.num_layers, jcfg.num_kv_heads, NB, BS, jcfg.head_dim)
    jk, jv = jnp.zeros(shape, jdtype), jnp.zeros(shape, jdtype)
    tk, tv = torch.zeros(shape, dtype=tdtype), torch.zeros(shape, dtype=tdtype)
    rng = np.random.default_rng(1)
    T, P = 10, 12
    tokens = np.zeros(P, np.int32)
    tokens[:T] = rng.integers(0, 128, T)
    table = np.array([3, 5, 9], np.int32)
    jlog, jk, jv = jl.prefill(
        jparams, jcfg, jnp.asarray(tokens), jnp.int32(T), jk, jv, jnp.asarray(table)
    )
    tlog = tl.prefill(tparams, tcfg, torch.from_numpy(tokens).long(), T, tk, tv,
                      torch.from_numpy(table))
    out = [(tlog.numpy(), np.asarray(jlog))]
    # two decode steps for a batch of 2: the prompt above plus a fresh lane
    # whose first token sits at position 0 of block 12
    bt = np.zeros((2, 8), np.int32)
    bt[0, :3] = table
    bt[1, 0] = 12
    feed = np.array([int(np.argmax(out[0][1])), 7], np.int32)
    pos = np.array([T, 0], np.int32)
    for _ in range(2):
        slots = np.array(
            [bt[b, pos[b] // BS] * BS + pos[b] % BS for b in range(2)], np.int32
        )
        jlog, jk, jv = jl.decode(
            jparams, jcfg, jnp.asarray(feed), jnp.asarray(pos), jk, jv,
            jnp.asarray(bt), jnp.asarray(slots),
        )
        tlog = tl.decode(
            tparams, tcfg, torch.from_numpy(feed).long(), torch.from_numpy(pos).long(),
            tk, tv, torch.from_numpy(bt), torch.from_numpy(slots).long(),
        )
        out.append((tlog.numpy(), np.asarray(jlog)))
        feed = np.array(jnp.argmax(jlog, axis=-1), np.int32)
        pos = pos + 1
    return out, (tk, tv), (jk, jv)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_and_decode_logits_match_jax_f32(variant):
    out, (tk, tv), (jk, jv) = _run_both(variant, jnp.float32, torch.float32)
    for got, want in out:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)


def test_prefill_and_decode_logits_match_jax_bf16():
    out, _, _ = _run_both("llama3_rope", jnp.bfloat16, torch.bfloat16)
    for got, want in out:
        assert np.abs(got - want).max() <= 0.03 * np.abs(want).max()


def test_params_from_jax_is_bit_exact_for_bf16():
    jcfg, _ = _configs("llama")
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(3), jnp.bfloat16)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    jw = np.asarray(jparams["layers"][1]["wq"]).view(np.uint16)
    tw = tparams["layers"][1]["wq"].view(torch.int16).numpy().view(np.uint16)
    assert tparams["layers"][1]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tw, jw)


def test_init_params_scales_follow_the_jax_init():
    _, tcfg = _configs("llama")
    p = init_params(tcfg, seed=0, device="cpu", dtype=torch.float32)
    wq = p["layers"][0]["wq"]
    assert wq.shape == (tcfg.hidden_size, tcfg.q_dim)
    assert abs(float(wq.std()) - tcfg.hidden_size ** -0.5) < 0.02
    assert abs(float(p["embed"].std()) - 0.02) < 0.002
    assert torch.equal(p["final_norm"], torch.ones(tcfg.hidden_size))
    again = init_params(tcfg, seed=0, device="cpu", dtype=torch.float32)
    assert torch.equal(wq, again["layers"][0]["wq"])


def test_config_from_hf_dict_matches_jax():
    hf = {
        "architectures": ["LlamaForCausalLM"], "hidden_size": 4096,
        "intermediate_size": 14336, "num_attention_heads": 32,
        "num_hidden_layers": 32, "num_key_value_heads": 8, "rms_norm_eps": 1e-5,
        "rope_scaling": dict(LLAMA3_SCALING, original_max_position_embeddings=8192),
        "rope_theta": 500000.0, "vocab_size": 128256,
        "max_position_embeddings": 131072,
    }
    j = jl.LlamaConfig.from_hf_dict(hf)
    t = tl.LlamaConfig.from_hf_dict(hf)
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert tl.param_count(t) == jl.param_count(j)
