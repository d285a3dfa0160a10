"""The port's on-device sampler against the JAX package's, on the CPU.

Greedy tokens must match exactly; logprobs and the top-20 within 1e-5 (the
same f32 log-softmax). Random draws use a different counter-based generator
than JAX's threefry, so sampled rows are checked for their support (top-k /
nucleus), their determinism per key, and their distribution.

The penalty tables, the penalty appliers and the min_tokens EOS mask must
equal their JAX counterparts on the same seeded inputs: the tables and the
mask exactly, the penalised logits within 1e-6 (one f32 rounding of a
division by the repetition penalty may differ), and lanes with penalties
0 / 0 / 1 bit-exactly unchanged.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import sampling as js
from dynamo_tpu.ops.sampling import sample_tokens_full as jax_sample_full
from dynamo_tpu_torch.ops import sampling as ts
from dynamo_tpu_torch.ops.sampling import (
    SAMPLE_CANDIDATES,
    gumbel_noise,
    make_key_data,
    sample_tokens,
    sample_tokens_full,
)


def _logits(seed, B=6, V=300):
    return (np.random.default_rng(seed).standard_normal((B, V)) * 3).astype(np.float32)


def _keys(B, stream=11, counter=0):
    return torch.from_numpy(np.stack([make_key_data(stream + b, counter) for b in range(B)]))


@pytest.mark.parametrize("all_greedy", [False, True])
def test_greedy_and_logprobs_match_jax(all_greedy):
    logits = _logits(0)
    B = logits.shape[0]
    temps = np.zeros(B, np.float32)
    top_p = np.ones(B, np.float32)
    top_k = np.zeros(B, np.int32)
    tok, lp, tid, tlp = sample_tokens_full(
        torch.from_numpy(logits), torch.from_numpy(temps), torch.from_numpy(top_p),
        torch.from_numpy(top_k).long(), _keys(B), all_greedy=all_greedy,
    )
    jkeys = jnp.asarray(np.stack([[b, 0] for b in range(B)]), jnp.uint32)
    jtok, jlp, jtid, jtlp = jax_sample_full(
        jnp.asarray(logits), None, jnp.asarray(temps), jnp.asarray(top_p),
        jnp.asarray(top_k), keys=jkeys,
    )
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jtid))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jtlp), atol=1e-5, rtol=0)


@pytest.mark.parametrize(
    "temp,top_p,top_k",
    [(0.7, 1.0, 5), (1.0, 0.5, 0), (1.3, 0.9, 20), (0.5, 0.3, 3)],
)
def test_sampled_ids_stay_in_support(temp, top_p, top_k):
    logits = _logits(1, B=1, V=300)[0]
    scaled = logits / temp
    order = np.argsort(-scaled)
    allowed = order[: top_k or len(order)]
    probs = np.exp(scaled[allowed] - scaled[allowed].max())
    probs /= probs.sum()
    keep = (np.cumsum(probs) - probs) < top_p
    support = set(allowed[keep].tolist())
    n = 200
    toks = sample_tokens(
        torch.from_numpy(np.tile(logits, (n, 1))),
        torch.full((n,), temp), torch.full((n,), top_p),
        torch.full((n,), top_k, dtype=torch.long),
        torch.from_numpy(np.stack([make_key_data(5, c) for c in range(n)])),
    )
    assert set(toks.tolist()) <= support
    assert len(set(toks.tolist())) > 1 or len(support) == 1


def test_same_key_same_token_other_key_other_draw():
    logits = torch.zeros(1, 50)
    args = (torch.ones(1), torch.ones(1), torch.zeros(1, dtype=torch.long))
    draws = [
        int(sample_tokens(logits, *args, torch.from_numpy(make_key_data(9, c)[None]))[0])
        for c in range(40)
    ]
    again = [
        int(sample_tokens(logits, *args, torch.from_numpy(make_key_data(9, c)[None]))[0])
        for c in range(40)
    ]
    assert draws == again
    assert len(set(draws)) > 10  # uniform over 50 ids: 40 draws spread out


def test_draws_follow_the_softmax():
    logits = torch.tensor([[0.0, 1.0, 2.0, -1.0]])
    n = 4000
    keys = torch.from_numpy(np.stack([make_key_data(3, c) for c in range(n)]))
    toks = sample_tokens(
        logits.repeat(n, 1), torch.ones(n), torch.ones(n),
        torch.zeros(n, dtype=torch.long), keys,
    )
    freq = np.bincount(toks.numpy(), minlength=4) / n
    np.testing.assert_allclose(freq, torch.softmax(logits[0], -1).numpy(), atol=0.03)


def test_wide_nucleus_draws_from_the_full_vocab():
    """top_p >= 0.99 at temperature > 1.25 skips the 256-candidate pool."""
    V, n = 1000, 300
    logits = torch.zeros(n, V)
    keys = torch.from_numpy(np.stack([make_key_data(4, c) for c in range(n)]))
    toks = sample_tokens(
        logits, torch.full((n,), 1.5), torch.full((n,), 0.995),
        torch.zeros(n, dtype=torch.long), keys,
    )
    pool = set(torch.topk(logits[0], SAMPLE_CANDIDATES).indices.tolist())
    assert any(t not in pool for t in toks.tolist())


def test_gumbel_noise_is_exact_integer_hash():
    keys = torch.from_numpy(np.stack([make_key_data(1, 2), make_key_data(2**32 - 1, 7)]))
    g = gumbel_noise(keys, 8)
    assert g.shape == (2, 8) and torch.isfinite(g).all()
    assert torch.equal(g, gumbel_noise(keys, 8))
    assert not torch.equal(g[0], g[1])


# ------------------------------------------------- penalties and the EOS mask

PEN_TOL = 1e-6  # an f32 division by the repetition penalty may round apart


def _penalty_inputs(seed, B=7, V=97, L=40):
    """Ragged histories (some empty, one past a short prompt only, one full)
    over a small vocab, so tokens repeat; lanes mixing 0 / 0 / 1 with
    non-zero penalties; -1-padded EOS rows."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    hist = rng.integers(0, V, (B, L)).astype(np.int32)
    hist_len = np.array([0, 1, 9, 23, L, 17, 31][:B], np.int32)
    prompt_len = np.minimum(np.array([0, 1, 4, 23, 12, 0, 30][:B], np.int32), hist_len)
    hist[np.arange(L)[None, :] >= hist_len[:, None]] = -1  # junk past each history
    freq = np.array([0.0, 0.5, 0.0, 1.5, 0.0, -0.3, 0.2][:B], np.float32)
    pres = np.array([0.0, 0.0, 0.7, 0.4, 0.0, 0.25, 0.0][:B], np.float32)
    rep = np.array([1.0, 1.0, 1.3, 1.0, 1.0, 0.8, 2.0][:B], np.float32)
    eos = np.full((B, js.MAX_EOS_IDS), -1, np.int32)
    eos[1, :1] = [3]
    eos[2, :3] = [5, 96, 0]
    eos[4, :] = [7, 8, 9, 10]
    eos[5, :2] = [11, 11]
    suppress = np.array([False, True, True, False, True, True, False][:B])
    return logits, hist, hist_len, prompt_len, freq, pres, rep, eos, suppress


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_penalty_count_tables_match_jax(seed):
    logits, hist, hist_len, prompt_len, *_ = _penalty_inputs(seed)
    V = logits.shape[1]
    got = ts.penalty_count_tables(*_t(hist, hist_len, prompt_len), V)
    want = js.penalty_count_tables(jnp.asarray(hist), jnp.asarray(hist_len),
                                   jnp.asarray(prompt_len), V)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_penalties_match_jax_and_plain_lanes_pass_through(seed):
    logits, hist, hist_len, prompt_len, freq, pres, rep, *_ = _penalty_inputs(seed)
    got = ts.apply_penalties(*_t(logits, hist, hist_len, prompt_len, freq, pres, rep)).numpy()
    want = np.asarray(js.apply_penalties(*(jnp.asarray(a) for a in (
        logits, hist, hist_len, prompt_len, freq, pres, rep))))
    np.testing.assert_allclose(got, want, atol=PEN_TOL, rtol=0)
    plain = (freq == 0) & (pres == 0) & (rep == 1)
    assert plain.sum() >= 2
    np.testing.assert_array_equal(got[plain], logits[plain])
    # the table form the verify pass uses gives the same logits
    tables = ts.penalty_count_tables(*_t(hist, hist_len, prompt_len), logits.shape[1])
    np.testing.assert_array_equal(
        ts.apply_penalties_from_tables(torch.from_numpy(logits), *tables, *_t(freq, pres, rep)).numpy(),
        got)


@pytest.mark.parametrize("rp", [1.0, 1.25, 0.7])
@pytest.mark.parametrize("batched", [False, True], ids=["row", "batch"])
def test_prompt_repetition_penalty_matches_jax(rp, batched):
    rng = np.random.default_rng(int(rp * 100))
    V = 61
    logits = (rng.standard_normal((3, V) if batched else (V,)) * 3).astype(np.float32)
    prompt = rng.integers(0, V, 24).astype(np.int32)
    for valid in (0, 1, 13, 24):
        got = ts.apply_repetition_penalty_from_prompt(
            torch.from_numpy(logits), torch.from_numpy(prompt), valid, rp).numpy()
        want = np.asarray(js.apply_repetition_penalty_from_prompt(
            jnp.asarray(logits), jnp.asarray(prompt), jnp.int32(valid), jnp.float32(rp)))
        np.testing.assert_allclose(got, want, atol=PEN_TOL, rtol=0)
        if rp == 1.0 or valid == 0:
            np.testing.assert_array_equal(got, logits)


@pytest.mark.parametrize("seed", [0, 1])
def test_mask_eos_logits_matches_jax(seed):
    logits, *_, eos, suppress = _penalty_inputs(seed)
    got = ts.mask_eos_logits(*_t(logits, eos, suppress)).numpy()
    want = np.asarray(js.mask_eos_logits(jnp.asarray(logits), jnp.asarray(eos), jnp.asarray(suppress)))
    np.testing.assert_array_equal(got, want)
    assert (got[~suppress] == logits[~suppress]).all()
    assert (got[2, [5, 96, 0]] == ts.NEG_INF).all() and got[2, 1] == logits[2, 1]
    # the single-row form (the prefill tail)
    row = ts.mask_eos_logits(torch.from_numpy(logits[2]), torch.from_numpy(eos[2]),
                             torch.tensor(True)).numpy()
    np.testing.assert_array_equal(row, want[2])
    assert ts.MAX_EOS_IDS == js.MAX_EOS_IDS
