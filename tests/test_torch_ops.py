"""Parity of the PyTorch port's core ops with the JAX package's, on the CPU.

The same numpy inputs (seeded) go through the JAX function and its
counterpart in dynamo_tpu_torch; f32 throughout, atol 1e-5 (both sides
compute the same f32 ops; only the summation order may differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models.llama import LlamaConfig as JaxConfig
from dynamo_tpu.ops import basics as jb
from dynamo_tpu.ops import layers as jl
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.ops import basics as tb
from dynamo_tpu_torch.ops import layers as tl

ATOL = 1e-5
LLAMA3_SCALING = {
    "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
    "high_freq_factor": 4.0, "original_max_position_embeddings": 8192,
}


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _layer(rng, cfg, bias=False, qk_norm=False, post=False):
    d, q, kv = cfg.hidden_size, cfg.q_dim, cfg.kv_dim
    layer = {
        "attn_norm": 1.0 + _rand(rng, d, scale=0.1),
        "wq": _rand(rng, d, q, scale=d ** -0.5),
        "wk": _rand(rng, d, kv, scale=d ** -0.5),
        "wv": _rand(rng, d, kv, scale=d ** -0.5),
        "wo": _rand(rng, q, d, scale=q ** -0.5),
    }
    if bias:
        layer.update(bq=_rand(rng, q), bk=_rand(rng, kv), bv=_rand(rng, kv))
    if qk_norm:
        layer.update(q_norm=1.0 + _rand(rng, cfg.head_dim, scale=0.1),
                     k_norm=1.0 + _rand(rng, cfg.head_dim, scale=0.1))
    if post:
        layer["post_attn_norm"] = 1.0 + _rand(rng, d, scale=0.1)
    return layer


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=0)


def _case_rms_norm(rng):
    x, w = _rand(rng, 5, 64, scale=3.0), _rand(rng, 64)
    _close(tb.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           jb.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


def _case_rope_freqs_plain(rng):
    _close(tb.rope_freqs(128, 500000.0), jb.rope_freqs(128, 500000.0), atol=1e-9)


def _case_rope_freqs_llama3(rng):
    _close(tb.rope_freqs(128, 500000.0, LLAMA3_SCALING),
           jb.rope_freqs(128, 500000.0, LLAMA3_SCALING), atol=1e-9)


def _case_apply_rope(rng):
    x = _rand(rng, 7, 4, 32)
    pos = rng.integers(0, 5000, 7)
    tf = tb.rope_freqs(32, 10000.0, LLAMA3_SCALING)
    jf = jb.rope_freqs(32, 10000.0, LLAMA3_SCALING)
    _close(tb.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), tf),
           jb.apply_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), jf), atol=1e-4)


def _case_swiglu(rng):
    g, u = _rand(rng, 6, 40, scale=3.0), _rand(rng, 6, 40)
    _close(tb.swiglu(torch.from_numpy(g), torch.from_numpy(u)),
           jb.swiglu(jnp.asarray(g), jnp.asarray(u)))


def _qkv_case(bias, qk_norm):
    def case(rng):
        tcfg, jcfg = LlamaConfig.tiny(), JaxConfig.tiny()
        layer = _layer(rng, tcfg, bias=bias, qk_norm=qk_norm)
        x = _rand(rng, 6, tcfg.hidden_size)
        pos = np.arange(3, 9)
        tq = tl.qkv_head(
            torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in layer.items()},
            tcfg, tb.rope_freqs(16, 10000.0), torch.from_numpy(pos),
        )
        jq = jl.qkv_head(
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in layer.items()},
            jcfg, jb.rope_freqs(16, 10000.0), jnp.asarray(pos, jnp.int32),
        )
        for t, j in zip(tq, jq):
            _close(t, j)
    return case


def _attn_out_case(post):
    def case(rng):
        tcfg, jcfg = LlamaConfig.tiny(), JaxConfig.tiny()
        layer = _layer(rng, tcfg, post=post)
        attn = _rand(rng, 6, tcfg.num_heads, tcfg.head_dim)
        x = _rand(rng, 6, tcfg.hidden_size)
        _close(
            tl.attn_out(torch.from_numpy(attn), torch.from_numpy(x),
                        {k: torch.from_numpy(v) for k, v in layer.items()}, tcfg),
            jl.attn_out(jnp.asarray(attn), jnp.asarray(x),
                        {k: jnp.asarray(v) for k, v in layer.items()}, jcfg),
        )
    return case


CASES = {
    "rms_norm": _case_rms_norm,
    "rope_freqs_plain": _case_rope_freqs_plain,
    "rope_freqs_llama3": _case_rope_freqs_llama3,
    "apply_rope": _case_apply_rope,
    "swiglu": _case_swiglu,
    "qkv_head": _qkv_case(False, False),
    "qkv_head_bias_qknorm": _qkv_case(True, True),
    "attn_out": _attn_out_case(False),
    "attn_out_sandwich": _attn_out_case(True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    CASES[name](np.random.default_rng(sorted(CASES).index(name)))


def test_linear_rejects_int8_weights():
    """int8 weights are ported (tests/test_torch_int8.py); a {"q", "s"}
    container whose mantissas are not int8 is refused, not misread."""
    from dynamo_tpu_torch.ops.linear import linear

    with pytest.raises(TypeError, match="int8 mantissas"):
        linear(torch.zeros(2, 4), {"q": torch.zeros(4, 4), "s": torch.ones(4)})
