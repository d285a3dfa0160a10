"""Speculative decoding under tensor parallelism against the JAX package's,
on the CPU.

The JAX side verifies under a tp = 2 mesh on the suite's host devices
(``decode_verify(mesh=...)``, the reference's one-program verify pass); the
port's side runs two gloo ranks, the leader drafting and every rank
verifying on its head shard after the step channel's ``OP_VERIFY``. Every
number is f32, so the bars are tests/test_torch_spec_decode.py's:

* ``decode_verify`` on each rank's slice equals the JAX meshed verify's
  logits (rtol / atol 1e-4), unfused and fused (#4 on the rank's heads and
  #5's partial, summed), and every rank holds the same all-gathered logits;
* ``build_torch_engine(tensor_parallel_size=2, spec_k=3)`` streams the
  greedy tokens of a tp = 2 ``JaxEngine`` with spec_k 3, token for token,
  with the same drafts and acceptances: fused, unfused with the decode
  horizon 4 (every verify chains 3 decode steps on every rank), and fused
  with penalties and min_tokens (tests/test_spec_decode.py's grid under
  tp = 2).
"""

import asyncio
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.jax_engine.engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.engine.jax_engine.model_runner import ModelRunner
from dynamo_tpu.models import llama as jl
from dynamo_tpu.parallel.mesh import build_mesh
from dynamo_tpu.parallel.sharding import shard_llama as jshard_llama
from dynamo_tpu.pipeline.context import Context as JaxContext
from dynamo_tpu.protocols import common as jp
from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
from dynamo_tpu_torch.engine.torch_engine.weights import params_from_jax
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.parallel.launch import run_ranks
from dynamo_tpu_torch.parallel.multihost import OP_VERIFY, SpmdStepChannel
from dynamo_tpu_torch.parallel.sharding import shard_leaf
from dynamo_tpu_torch.protocols import common as tp

TP, BS, NB, TIMEOUT_S = 2, 4, 64, 120
CP_NB, CP_LEN = 128, 512  # the sp x tp grid's pool: a 300-token prompt in 4-token blocks


@functools.lru_cache(maxsize=None)
def _models(vocab):
    jcfg = jl.LlamaConfig.tiny(vocab_size=vocab)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tcfg = tl.LlamaConfig.tiny(vocab_size=vocab)
    return jcfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


# ------------------------------------------------------------ the verify op


def _verify_batch():
    """Two lanes whose prompts are prefilled, then a verify window of S = 4
    fed tokens each; lane 1's last position is invalid (slot 0)."""
    rng = np.random.default_rng(5)
    tables = np.array([[3, 5, 9, 11, 0, 0], [7, 2, 4, 0, 0, 0]], np.int32)
    lens = [10, 5]
    prompts = [rng.integers(0, 128, n) for n in lens]
    fed = rng.integers(0, 128, (2, 4))
    positions = np.array(lens)[:, None] + np.arange(4)[None, :]
    slots = tables[np.arange(2)[:, None], positions // BS] * BS + positions % BS
    slots[1, 3] = 0
    return tables, prompts, fed, positions, slots


def _rank_verify(group, cfg, full):
    """Prefill both prompts, then verify, on this rank's slice."""
    params = {k: shard_leaf(k, v, group.rank, TP) for k, v in full.items() if k != "layers"}
    params["layers"] = [{k: shard_leaf(k, v, group.rank, TP) for k, v in layer.items()}
                        for layer in full["layers"]]
    tables, prompts, fed, positions, slots = _verify_batch()
    shape = (cfg.num_layers, cfg.num_kv_heads // TP, NB, BS, cfg.head_dim)
    k, v = torch.zeros(shape), torch.zeros(shape)
    for b, p in enumerate(prompts):
        toks = torch.zeros(12, dtype=torch.long)
        toks[: len(p)] = torch.from_numpy(p)
        tl.prefill(params, cfg, toks, len(p), k, v, torch.from_numpy(tables[b, :3]).long(),
                   group=group)
    return tl.decode_verify(params, cfg, torch.from_numpy(fed), torch.from_numpy(positions), k, v,
                            torch.from_numpy(tables), torch.from_numpy(slots), group=group)


def _verify_pair(group, tcfg, tparams):
    return [_rank_verify(group, dataclasses.replace(tcfg, fused_decode=f), tparams)
            for f in (False, True)]


@functools.lru_cache(maxsize=None)
def _port_verify():
    """Both forms on one group of two ranks: each rank's [unfused, fused]."""
    *_, tcfg, tparams = _models(128)
    return run_ranks(TP, _verify_pair, [(tcfg, tparams)] * TP, timeout_s=TIMEOUT_S)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_decode_verify_on_two_ranks_matches_the_jax_meshed_verify(fused):
    jcfg, jparams, *_ = _models(128)
    jcfg = dataclasses.replace(jcfg, fused_decode=fused)
    mesh = build_mesh(tp=TP)
    sp, kv_sharding = jshard_llama(mesh, jcfg, jparams)
    tables, prompts, fed, positions, slots = _verify_batch()
    shape = (jcfg.num_layers, jcfg.num_kv_heads, NB, BS, jcfg.head_dim)
    jk = jax.device_put(jnp.zeros(shape), kv_sharding)
    jv = jax.device_put(jnp.zeros(shape), kv_sharding)
    for b, p in enumerate(prompts):
        toks = np.zeros(12, np.int32)
        toks[: len(p)] = p
        _, jk, jv = jl.prefill(sp, jcfg, jnp.asarray(toks), jnp.int32(len(p)), jk, jv,
                               jnp.asarray(tables[b, :3]))
    want, _, _ = jax.jit(functools.partial(jl.decode_verify, sp, jcfg, mesh=mesh))(
        jnp.asarray(fed, jnp.int32), jnp.asarray(positions, jnp.int32), jk, jv,
        jnp.asarray(tables), jnp.asarray(slots, jnp.int32))
    ranks = [r[int(fused)] for r in _port_verify()]
    np.testing.assert_array_equal(ranks[0], ranks[1])  # all-gathered logits
    assert ranks[0].shape == (2, 4, 128)
    np.testing.assert_allclose(ranks[0], np.asarray(want), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ engines

MAX_BATCH, MAX_LEN, K, VOCAB = 6, 96, 3, 24


def _prompts():
    """Six prompts that repeat a random segment 2-4 times (lanes draft on
    most steps)."""
    rng = np.random.default_rng(7)
    out = []
    for i in range(6):
        seg = [int(t) for t in rng.integers(0, VOCAB, 4 + i)]
        out.append(seg * (2 + i % 3))
    return out


MAX_NEW = [14, 18, 12, 20, 16, 15]
SPEC_PENALTIES = [{}, {"frequency_penalty": 0.6}, {"repetition_penalty": 1.4},
                  {"presence_penalty": 0.8, "repetition_penalty": 1.2}, {},
                  {"frequency_penalty": 0.3}]


def _requests(mod, penalties: bool):
    out = []
    for i, (p, n) in enumerate(zip(_prompts(), MAX_NEW)):
        mt = penalties and i in (0, 4)
        sampling = dict(greedy=True, **(SPEC_PENALTIES[i] if penalties else {}))
        out.append(mod.PreprocessedRequest(
            token_ids=list(p), sampling=mod.SamplingOptions(**sampling),
            stop=mod.StopConditions(max_tokens=n, min_tokens=8 if mt else None),
            eos_token_ids=[p[1]] if mt else [],
        ))
    return out


async def _collect(engine, req, ctx):
    toks, reason = [], None
    async for out in engine.generate(req, ctx):
        toks.extend(out.token_ids)
        if out.finish_reason is not None:
            reason = out.finish_reason.value
    return toks, reason


async def _serve(engine, mod, ctx, penalties):
    try:
        return list(await asyncio.gather(*(_collect(engine, r, ctx())
                                           for r in _requests(mod, penalties))))
    finally:
        await engine.close()


def _dims():
    return dict(num_blocks=NB, block_size=BS, max_batch=MAX_BATCH, max_model_len=MAX_LEN)


ENGINES = {
    "fused": dict(fused=True, H=1, penalties=False),
    "unfused_horizon4": dict(fused=False, H=4, penalties=False),
    "fused_penalties_min_tokens": dict(fused=True, H=1, penalties=True),
}


@pytest.mark.parametrize("name", sorted(ENGINES))
async def test_spec_tp2_engine_streams_the_tp2_jax_engines_greedy_tokens(name, monkeypatch):
    knobs = ENGINES[name]
    jcfg, jparams, tcfg, tparams = _models(VOCAB)
    mesh = build_mesh(tp=TP)
    sp, kv_sharding = jshard_llama(mesh, jcfg, jparams)
    jrunner = ModelRunner(jcfg, sp, kv_dtype=jnp.float32, prefill_chunk_tokens=0,
                          fused_decode=knobs["fused"], mesh=mesh, kv_sharding=kv_sharding,
                          **_dims())
    jeng = JaxEngine(jrunner, JaxEngineConfig(watermark_blocks=2, spec_k=K,
                                              decode_horizon=knobs["H"], **_dims()))
    want = await _serve(jeng, jp, JaxContext, knobs["penalties"])
    sent = []  # the leader's broadcasts: (opcode, (spec_k, extras) of a verify)
    send = SpmdStepChannel.send

    def counting_send(self, op, args=(), kwargs=None):
        sent.append((op, args[:2] if op == OP_VERIFY else ()))
        return send(self, op, args, kwargs)

    monkeypatch.setattr(SpmdStepChannel, "send", counting_send)
    engine = build_torch_engine(
        tcfg, device="cpu", params=tparams, dtype=torch.float32, kv_block_size=BS,
        max_batch=MAX_BATCH, num_blocks=NB, max_model_len=MAX_LEN, prefill_chunk_tokens=0,
        tensor_parallel_size=TP, spec_k=K, fused_decode=knobs["fused"],
        decode_horizon=knobs["H"], spec_min_coverage=0.5)
    runner = engine.runner
    got = await _serve(engine, tp, tp.Context, knobs["penalties"])
    assert got == want
    js, ts = jeng.stats, engine.stats
    assert ts.verify_steps > 0 and ts.num_accepted_tokens > 0
    assert (ts.num_drafts, ts.num_draft_tokens, ts.num_accepted_tokens) == (
        js.num_drafts, js.num_draft_tokens, js.num_accepted_tokens)
    verifies = [a for op, a in sent if op == OP_VERIFY]
    assert len(verifies) == ts.verify_steps
    if knobs["H"] > 1 and not knobs["penalties"]:
        assert any(extras > 0 for _, extras in verifies)  # chained steps rode the broadcast
    assert [p.exitcode for p in runner._processes] == [0]
    assert engine.allocator.free_count == NB - 1


def test_the_logits_opcodes_replay_on_an_sp_by_tp_grid():
    """``prefill_logits`` (OP_PREFILL_LOGITS) through the leader of an sp x
    tp = 2 x 2 grid: a 300-token prompt, whose bucket (512) reaches the
    runner's ``cp_min_tokens``, prefills context parallel, the short ones
    serially; then ``verify_logits`` (OP_VERIFY_LOGITS) over the short
    ones. Each equals a one-device runner's on the same weights (f32,
    1e-4)."""
    from dynamo_tpu_torch.engine.torch_engine.model_runner import TorchModelRunner

    *_, tcfg, tparams = _models(128)
    tables, prompts, fed, positions, slots = _verify_batch()
    long_prompt = np.random.default_rng(6).integers(0, 128, 300).tolist()
    long_blocks = list(range(16, 16 + 300 // BS))  # past the verify batch's blocks
    dims = dict(num_blocks=CP_NB, block_size=BS, max_batch=4, max_model_len=CP_LEN)
    one = TorchModelRunner(tcfg, tparams, device="cpu", **dims)
    engine = build_torch_engine(
        tcfg, device="cpu", params=tparams, dtype=torch.float32, kv_block_size=BS,
        max_batch=4, num_blocks=CP_NB, max_model_len=CP_LEN, prefill_chunk_tokens=0,
        tensor_parallel_size=2, context_parallel_size=2)
    try:
        runner = engine.runner
        assert runner.uses_cp_prefill(512) and not runner.uses_cp_prefill(256)
        assert runner.pick_bucket(len(long_prompt)) == 512
        np.testing.assert_allclose(runner.prefill_logits(long_prompt, long_blocks).numpy(),
                                   one.prefill_logits(long_prompt, long_blocks).numpy(),
                                   rtol=1e-4, atol=1e-4)
        for b, p in enumerate(prompts):
            blocks = tables[b, :3].tolist()
            np.testing.assert_allclose(runner.prefill_logits(p.tolist(), blocks).numpy(),
                                       one.prefill_logits(p.tolist(), blocks).numpy(),
                                       rtol=1e-4, atol=1e-4)
        got = runner.verify_logits(fed, positions, tables, slots).numpy()
        want = one.verify_logits(fed, positions, tables, slots).numpy()
        assert got.shape == (2, 4, 128)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    finally:
        asyncio.run(engine.close())
    assert [p.exitcode for p in engine.runner._processes] == [0, 0, 0]
