"""The decode horizon under tensor parallelism, and an idle group, on the CPU.

* ``build_torch_engine(tensor_parallel_size=2, decode_horizon=4)``: the
  leader broadcasts each horizon (``OP_DECODE_MULTI``) and both gloo ranks
  run its four steps eagerly with the leader's keys; the greedy tokens
  equal a tp = 2 ``JaxEngine`` at H = 4 on the same f32 parameters
  (tests/test_torch_parallel.py's traffic: a prompt chunked alone, two
  packed, penalties riding the horizon).
* A leader that stays idle longer than its followers' wait limit keeps
  them: it sends keep-alives on the control group, and the next request is
  served by both ranks.
"""

import asyncio
import functools

import jax
import jax.numpy as jnp
import numpy as np
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
from dynamo_tpu_torch.parallel.multihost import SpmdModelRunner
from dynamo_tpu_torch.protocols import common as tp

BS, C, MAX_LEN, NB, MAX_BATCH, VOCAB, TP = 4, 8, 64, 64, 4, 64, 2
LONG = [int(t) for t in np.random.default_rng(1).integers(1, VOCAB, 20)]


@functools.cache
def _models():
    jcfg = jl.LlamaConfig.tiny(vocab_size=VOCAB)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tcfg = tl.LlamaConfig.tiny(vocab_size=VOCAB)
    return jcfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _requests(mod):
    def req(prompt, n, **pen):
        return mod.PreprocessedRequest(
            token_ids=list(prompt), sampling=mod.SamplingOptions(greedy=True, **pen),
            stop=mod.StopConditions(max_tokens=n, ignore_eos=True))

    return [req(LONG, 11), req([1, 2, 3], 9), req([9, 8, 7, 6, 5], 6, repetition_penalty=1.3)]


async def _collect(engine, req, ctx):
    return [t async for out in engine.generate(req, ctx) for t in out.token_ids]


async def _serve(engine, mod, ctx):
    try:
        return await asyncio.gather(*(_collect(engine, r, ctx()) for r in _requests(mod)))
    finally:
        await engine.close()


def _torch_engine(**kw):
    *_, tcfg, tparams = _models()
    return build_torch_engine(
        tcfg, device="cpu", params=tparams, dtype=torch.float32, kv_block_size=BS,
        max_batch=MAX_BATCH, num_blocks=NB, max_model_len=MAX_LEN, prefill_chunk_tokens=C,
        tensor_parallel_size=TP, **kw)


async def test_tp_engine_at_horizon_4_streams_the_jax_engines_tokens():
    jcfg, jparams, _, _ = _models()
    mesh = build_mesh(tp=TP)
    sp, kv_sharding = jshard_llama(mesh, jcfg, jparams)
    jrunner = ModelRunner(jcfg, sp, num_blocks=NB, block_size=BS, max_batch=MAX_BATCH,
                          max_model_len=MAX_LEN, kv_dtype=jnp.float32, prefill_chunk_tokens=C,
                          mesh=mesh, kv_sharding=kv_sharding)
    want = await _serve(JaxEngine(jrunner, JaxEngineConfig(
        max_batch=MAX_BATCH, block_size=BS, num_blocks=NB, max_model_len=MAX_LEN,
        decode_horizon=4)), jp, JaxContext)
    engine = _torch_engine(decode_horizon=4)
    runner = engine.runner
    assert isinstance(runner, SpmdModelRunner) and not runner.cuda_graphs
    got = await _serve(engine, tp, tp.Context)
    assert got == want
    assert [len(t) for t in got] == [11, 9, 6]
    s = engine.stats
    assert s.horizon_dispatches > 0 and s.graph_replays == 0
    assert [p.exitcode for p in runner._processes] == [0]
    # both ranks ran the horizons: the follower's launches are not counted
    # on the CPU, so its stats say only that it stopped cleanly
    assert len(runner.final_stats) == TP


async def test_an_idle_tp_group_keeps_its_followers():
    """Followers give a leader up after 3 s without a broadcast; the leader
    stays idle for 5 s between two requests. Its keep-alives hold the group,
    and the second request is served by both ranks."""
    engine = _torch_engine(decode_horizon=1, tp_idle_timeout_s=3.0)
    runner = engine.runner
    try:
        first = await _collect(engine, _requests(tp)[1], tp.Context())
        await asyncio.sleep(5.0)
        assert all(p.is_alive() for p in runner._processes)
        second = await _collect(engine, _requests(tp)[1], tp.Context())
    finally:
        await engine.close()
    assert first == second and len(first) == 9
    assert [p.exitcode for p in runner._processes] == [0]
    assert len(runner.final_stats) == TP
