"""Multimodal prefill and pooled embeddings under tensor parallelism, on
the CPU.

A tp = 2 gloo group (``build_torch_engine(tensor_parallel_size=2)``): the
leader's runner broadcasts ``OP_MM_PREFILL`` (the vision embeddings ride
the payload as host f32) and ``OP_EMBED``, and every rank runs its head
shard. The runner's results equal a one-device runner's on the same
weights (f32, rtol / atol 1e-4), and a ``MultimodalEngine`` over the tp = 2
engine streams the one-device engine's greedy tokens.
"""

import asyncio

import jax
import numpy as np
import torch

from dynamo_tpu.multimodal import vision as ref_vision
from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
from dynamo_tpu_torch.engine.torch_engine.model_runner import TorchModelRunner
from dynamo_tpu_torch.engine.torch_engine.weights import params_from_jax
from dynamo_tpu_torch.multimodal import vision
from dynamo_tpu_torch.multimodal.encode_worker import EncodeWorker
from dynamo_tpu_torch.multimodal.worker import MultimodalEngine
from dynamo_tpu_torch.parallel.multihost import OP_EMBED, OP_MM_PREFILL, SpmdStepChannel
from tests.test_torch_multimodal import JVIT, TVIT, _greedy, _png_data_url
from tests.test_torch_spec_tp import _models

BS, NB, MAX_LEN = 4, 64, 128


def _dims():
    return dict(num_blocks=NB, block_size=BS, max_batch=4, max_model_len=MAX_LEN)


def test_mm_prefill_and_embed_on_two_ranks_match_one(monkeypatch):
    *_, tcfg, tparams = _models(64)
    one = TorchModelRunner(tcfg, tparams, device="cpu", **_dims())
    sent = []
    send = SpmdStepChannel.send

    def counting_send(self, op, args=(), kwargs=None):
        sent.append(op)
        return send(self, op, args, kwargs)

    monkeypatch.setattr(SpmdStepChannel, "send", counting_send)
    engine = build_torch_engine(
        tcfg, device="cpu", params=tparams, dtype=torch.float32, kv_block_size=BS,
        max_batch=4, num_blocks=NB, max_model_len=MAX_LEN, prefill_chunk_tokens=0,
        tensor_parallel_size=2)
    try:
        runner = engine.runner
        for ids in ([5, 9, 7], list(range(3, 40))):
            np.testing.assert_allclose(runner.embed(ids), one.embed(ids), rtol=1e-4, atol=1e-4)
        rng = np.random.default_rng(2)
        emb = torch.from_numpy(rng.normal(size=(6, tcfg.hidden_size)).astype(np.float32))
        ids = [0] * 6 + [11, 12, 13, 14, 15]
        blocks = [1, 2, 3]
        got = runner.fetch_sample(runner.prefill_mm(ids, blocks, emb, 0, 0.0, 1.0, 0))
        want = one.fetch_sample(one.prefill_mm(ids, blocks, emb.numpy(), 0, 0.0, 1.0, 0))
        assert int(got[0][0]) == int(want[0][0])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got[3], want[3], rtol=1e-4, atol=1e-4)
        # the K/V every rank wrote: the blocks, gathered (OP_EXTRACT)
        k_got, _ = runner.extract_blocks(blocks)
        k_want, _ = one.extract_blocks(blocks)
        np.testing.assert_allclose(np.asarray(k_got, np.float32), np.asarray(k_want, np.float32),
                                   rtol=1e-4, atol=1e-4)
        # the logits themselves, every rank's vocab block gathered
        got_l = runner.prefill_mm(ids, blocks, emb, 0, 0.0, 1.0, 0, return_logits=True)
        want_l = one.prefill_mm(ids, blocks, emb, 0, 0.0, 1.0, 0, return_logits=True)
        np.testing.assert_allclose(got_l.numpy(), want_l.numpy(), rtol=1e-4, atol=1e-4)
        assert sent.count(OP_EMBED) == 2 and sent.count(OP_MM_PREFILL) == 2
    finally:
        asyncio.run(engine.close())
    assert [p.exitcode for p in engine.runner._processes] == [0]


async def test_a_multimodal_engine_over_two_ranks_streams_one_ranks_tokens():
    *_, tcfg, tparams = _models(64)
    jvit = ref_vision.init_vit_params(JVIT, jax.random.PRNGKey(7))
    tvit = params_from_jax(jax.tree.map(np.asarray, jvit), device="cpu")
    assert vision.ViTConfig(**vars(TVIT)) == TVIT
    url = _png_data_url(seed=4)
    out = {}
    for tp in (1, 2):
        inner = build_torch_engine(
            tcfg, device="cpu", params=tparams, dtype=torch.float32, kv_block_size=BS,
            max_batch=4, num_blocks=NB, max_model_len=MAX_LEN, tensor_parallel_size=tp,
            **({"tp_backend": "gloo"} if tp == 2 else {}))
        eng = MultimodalEngine(inner, EncodeWorker(tvit, TVIT), placeholder_id=0,
                               num_patches=TVIT.num_patches)
        out[tp] = await _greedy(eng, [5, 6, 7, 8], {"mm_images": [url]}, n=8)
        out[f"embed{tp}"] = await eng.embed([5, 6, 7, 8, 9])
        await eng.close()
    assert out[1] == out[2] and len(out[1]) == 8
    np.testing.assert_allclose(out["embed2"], out["embed1"], rtol=1e-4, atol=1e-4)
