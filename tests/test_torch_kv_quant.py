"""The port's int8-resident KV cache against the JAX package, on the CPU.

* ``kv_quant.write_blocks_quant`` / ``write_tokens_quant`` leave the same
  int8 mantissas and f32 scales as ``dynamo_tpu.ops.kv_quant`` (exactly:
  both run the same f32 formulas, elementwise): whole blocks, scale growth
  with the rescale of the block's earlier mantissas, the reset of a
  recycled block at offset 0, several tokens of one block in one call (the
  cases of tests/test_int8_kv.py:61-135), and a random mix over a random
  cache state with repeated blocks;
* the attention writes (``write_prefill_kv``, ``write_chunk_kv``,
  ``write_decode_kv``) route an int8 cache to those writes, as the
  reference's do;
* the plain paged decode and verify ops (what ``chip_smoke.py`` and the
  ``cuda`` tests hold the int8 kernels against) and the chunked prefill op
  over an int8 cache equal the reference's XLA gather branch (f32 queries:
  atol 1e-5, only the summation order differs) and its Pallas int8 kernels
  in interpret mode (bf16 queries: atol 2e-2, the reference's own bar
  between those two, tests/test_int8_kv.py:140-180); window and softcap.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import attention as ja
from dynamo_tpu.ops import kv_quant as jq
from dynamo_tpu_torch.ops import attention as ta
from dynamo_tpu_torch.ops import kv_quant as tq

Hkv, NB, BS, D, Hq = 2, 8, 8, 16, 4


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _bf16(a):
    """numpy f32 -> (jax bf16, torch bf16) with the same bits."""
    j = jnp.asarray(a, jnp.bfloat16)
    t = torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)
    return j, t


def _layers(seed=None):
    """A (jax, torch) pair of equal int8 layers [Hkv, NB, BS, D]: zeros, or
    random mantissas and scales."""
    if seed is None:
        q = np.zeros((Hkv, NB, BS, D), np.int8)
        s = np.zeros((Hkv, NB), np.float32)
    else:
        rng = np.random.default_rng(seed)
        q = rng.integers(-127, 128, (Hkv, NB, BS, D)).astype(np.int8)
        s = rng.uniform(0.001, 0.05, (Hkv, NB)).astype(np.float32)
    return ({"q": jnp.asarray(q), "s": jnp.asarray(s)},
            {"q": torch.from_numpy(q.copy()), "s": torch.from_numpy(s.copy())})


def _same(jlayer, tlayer):
    np.testing.assert_array_equal(tlayer["q"].numpy(), np.asarray(jlayer["q"]))
    np.testing.assert_array_equal(tlayer["s"].numpy(), np.asarray(jlayer["s"]))


@pytest.mark.parametrize("start", ["zeros", "random"])
def test_write_blocks_quant_matches_jax_bit_for_bit(start):
    jl, tl = _layers(None if start == "zeros" else 3)
    blocks = _rand((Hkv, 3, BS, D), 1, 2.0)
    blocks[:, 1] = 0.0  # an all-zero block: scale 0, inverse 0
    jb, tb = _bf16(blocks)
    table = np.array([5, 2, 7], np.int32)
    jl = jq.write_blocks_quant(jl, jb, jnp.asarray(table))
    tq.write_blocks_quant(tl, tb, torch.from_numpy(table))
    _same(jl, tl)


def _tokens(jl, tl, toks, slots):
    jt, tt = _bf16(toks)
    jl = jq.write_tokens_quant(jl, jt, jnp.asarray(np.asarray(slots, np.int32)))
    tq.write_tokens_quant(tl, tt, torch.tensor(slots))
    _same(jl, tl)
    return jl, tl


def test_append_writes_grow_the_scale_and_rescale_like_jax():
    """Four appends to one fresh block with magnitudes 0.5, 1, 4, 2: the
    scale grows twice (each time the block's mantissas are rescaled once)
    and then stays."""
    jl, tl = _layers()
    for i, mag in enumerate([0.5, 1.0, 4.0, 2.0]):
        jl, tl = _tokens(jl, tl, _rand((1, Hkv, D), 10 + i, mag), [3 * BS + i])
    assert (tl["s"][:, 3] > 0).all()


def test_a_write_at_offset_0_resets_a_recycled_blocks_scale_like_jax():
    jl, tl = _layers()
    jl, tl = _tokens(jl, tl, _rand((1, Hkv, D), 3, 1000.0), [5 * BS])
    assert float(tl["s"][0, 5]) > 1.0
    jl, tl = _tokens(jl, tl, _rand((1, Hkv, D), 4, 0.01), [5 * BS])
    assert float(tl["s"][0, 5]) < 1e-3


def test_several_tokens_of_one_block_in_one_call_like_jax():
    """The verify / packed write: three tokens of block 2 (offset 0, so
    the block is fresh) and one of block 3, in one call."""
    jl, tl = _layers()
    _tokens(jl, tl, _rand((4, Hkv, D), 5), [2 * BS, 2 * BS + 1, 2 * BS + 2, 3 * BS])


def test_a_random_mix_over_a_random_cache_matches_jax():
    """Twelve tokens over a random cache state: blocks hit once and several
    times, fresh (offset 0) and grown, with magnitudes spanning 1000x."""
    jl, tl = _layers(seed=9)
    rng = np.random.default_rng(11)
    slots = [1 * BS + 3, 1 * BS + 4, 4 * BS, 4 * BS + 1, 4 * BS + 7, 6 * BS + 2,
             7 * BS + 5, 7 * BS + 6, 7 * BS + 7, 2 * BS + 1, 3 * BS, 5 * BS + 6]
    toks = _rand((len(slots), Hkv, D), 12) * rng.choice([0.01, 0.3, 10.0], (len(slots), 1, 1))
    _tokens(jl, tl, toks.astype(np.float32), slots)


def test_attention_writes_route_an_int8_cache_like_jax():
    """write_prefill_kv, write_chunk_kv and write_decode_kv of the two
    packages over the {"q", "s"} container, one after another."""
    (jk, tk), (jv, tv) = _layers(), _layers()
    k_new, v_new = _rand((2 * BS, Hkv, D), 20), _rand((2 * BS, Hkv, D), 21)
    (jkn, tkn), (jvn, tvn) = _bf16(k_new), _bf16(v_new)
    table = np.array([1, 2], np.int32)
    jk, jv = ja.write_prefill_kv(jk, jv, jkn, jvn, jnp.asarray(table))
    ta.write_prefill_kv(tk, tv, tkn, tvn, torch.from_numpy(table))
    whole = np.array([3, 4, 5, 6], np.int32)
    jk, jv = ja.write_chunk_kv(jk, jv, jkn, jvn, jnp.asarray(whole), jnp.int32(BS))
    ta.write_chunk_kv(tk, tv, tkn, tvn, torch.from_numpy(whole), BS)
    slots = np.array([2 * BS + 2, 6 * BS + 5, 6 * BS + 6], np.int32)
    (jd, td) = _bf16(_rand((3, Hkv, D), 22, 3.0))
    jk, jv = ja.write_decode_kv(jk, jv, jd, jd, jnp.asarray(slots))
    ta.write_decode_kv(tk, tv, td, td, torch.from_numpy(slots))
    _same(jk, tk)
    _same(jv, tv)


# ------------------------------------------------------------ attention

FEATURES = {"full": {}, "window": {"window": 12}, "softcap": {"logit_softcap": 30.0}}


def _filled(seed):
    """Equal int8 caches written by the JAX package (two prompts' worth of
    blocks 1-2 and 3-4, then appended tokens so the scales differ per
    page): (jax k, jax v, torch k, torch v)."""
    (jk, tk), (jv, tv) = _layers(), _layers()
    P = 2 * BS
    for t0, table in ((0, [1, 2]), (1, [3, 4])):
        jk, jv = ja.write_prefill_kv(
            jk, jv, jnp.asarray(_rand((P, Hkv, D), seed + t0, 1.0 + t0), jnp.bfloat16),
            jnp.asarray(_rand((P, Hkv, D), seed + 5 + t0), jnp.bfloat16),
            jnp.asarray(np.array(table, np.int32)))
    for name, j in (("k", jk), ("v", jv)):
        t = tk if name == "k" else tv
        t["q"].copy_(torch.from_numpy(np.asarray(j["q"])))
        t["s"].copy_(torch.from_numpy(np.asarray(j["s"])))
    return jk, jv, tk, tv


@pytest.mark.parametrize("feature", sorted(FEATURES))
def test_plain_paged_decode_over_int8_matches_xla_and_pallas(feature):
    kw = FEATURES[feature]
    jk, jv, tk, tv = _filled(30)
    bt = np.array([[1, 2], [3, 4]], np.int32)
    cl = np.array([2 * BS - 1, 2 * BS], np.int32)
    q = _rand((2, Hq, D), 31)
    got = ta.paged_decode_attention(torch.from_numpy(q), tk, tv, torch.from_numpy(bt),
                                    torch.from_numpy(cl), **kw)
    want = ja.paged_decode_attention(jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(cl),
                                     impl="xla", **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    jqb, tqb = _bf16(q)
    got = ta.paged_decode_attention(tqb, tk, tv, torch.from_numpy(bt), torch.from_numpy(cl), **kw)
    want = ja.paged_decode_attention(jqb, jk, jv, jnp.asarray(bt), jnp.asarray(cl),
                                     impl="pallas_interpret", **kw)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2e-2, rtol=0)


@pytest.mark.parametrize("feature", sorted(FEATURES))
def test_plain_paged_verify_over_int8_matches_xla_and_pallas(feature):
    kw = FEATURES[feature]
    jk, jv, tk, tv = _filled(40)
    bt = np.array([[1, 2], [3, 4]], np.int32)
    S = 3
    pos = np.array([[2 * BS - 3 + s for s in range(S)]] * 2, np.int32)
    q = _rand((2, S, Hq, D), 41)
    got = ta.paged_verify_attention(torch.from_numpy(q), tk, tv, torch.from_numpy(bt),
                                    torch.from_numpy(pos), **kw)
    want = ja.paged_verify_attention(jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(pos),
                                     impl="xla", **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    jqb, tqb = _bf16(q)
    got = ta.paged_verify_attention(tqb, tk, tv, torch.from_numpy(bt), torch.from_numpy(pos), **kw)
    want = ja.paged_verify_attention(jqb, jk, jv, jnp.asarray(bt), jnp.asarray(pos),
                                     impl="pallas_interpret", **kw)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2e-2, rtol=0)


@pytest.mark.parametrize("feature", sorted(FEATURES))
@pytest.mark.parametrize("chunk_start", [0, BS])
def test_chunked_prefill_over_int8_matches_xla(chunk_start, feature):
    kw = FEATURES[feature]
    jk, jv, tk, tv = _filled(50)
    table = np.array([1, 2, 0, 0], np.int32)  # the whole prompt's table, padded
    q = _rand((BS, Hq, D), 51)
    got = ta.chunked_prefill_attention(torch.from_numpy(q), tk, tv, torch.from_numpy(table),
                                       chunk_start, **kw)
    want = ja.chunked_prefill_attention(jnp.asarray(q), jk, jv, jnp.asarray(table),
                                        jnp.int32(chunk_start), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_make_cache_and_its_views():
    c = tq.make_cache((3, Hkv, NB, BS, D), torch.bfloat16, quantized=True)
    assert c["q"].dtype == torch.int8 and tuple(c["s"].shape) == (3, Hkv, NB)
    assert tq.cache_nbytes(c) == 3 * Hkv * NB * (BS * D + 4)
    layer = tq.cache_layer(c, 1)
    layer["s"][0, 2] = 5.0  # a view: writes land in the container
    assert float(c["s"][1, 0, 2]) == 5.0
    assert tq.cache_nbytes(tq.make_cache((2, 4), torch.bfloat16, quantized=False)) == 16
    assert tq.cache_nbytes(c) == jq.cache_nbytes(
        jq.make_cache((3, Hkv, NB, BS, D), jnp.bfloat16, quantized=True))
