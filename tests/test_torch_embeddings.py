"""The port's pooled embeddings and ``/v1/embeddings`` against the JAX
package's, on the CPU.

``llama.embed_pooled`` and the runner's ``embed`` against the reference's
(f32, parameters carried over by ``params_from_jax``, rtol 1e-4 / atol
1e-4 x max|want|); the route's 200 (twin of
tests/test_tools_and_embeddings.py::test_embeddings_route: two inputs,
their vectors equal to the JAX frontend's, ``usage``, the token-id form),
404 for an unknown model and 501 without an embed path (the twin of
``test_embeddings_501_without_embed_path``); and the padding rows: the
prefill kernel leaves them unspecified, so a NaN there must not reach the
pooled vector.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.jax_engine.model_runner import ModelRunner
from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.engine.torch_engine.model_runner import TorchModelRunner
from dynamo_tpu_torch.engine.torch_engine.weights import params_from_jax
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.ops import attention as tattn
from tests.test_torch_engine import make_jax_engine, make_torch_engine
from tests.test_torch_frontend import afetch, cards, model_dir  # noqa: F401 (fixture)

VARIANTS = {
    "llama": {},
    "qwen2_bias_window": {"attn_bias": True, "sliding_window": 6},
    "gemma2_like": {
        "mlp_act": "gelu_tanh", "embed_scale": True, "sandwich_norms": True,
        "attn_logit_softcap": 20.0, "final_logit_softcap": 15.0,
        "query_pre_attn_scalar": 24.0, "tie_word_embeddings": True,
        "sliding_window": 5, "layer_pattern": (True, False),
    },
}


def _pair(variant="llama"):
    import dataclasses

    kw = VARIANTS[variant]
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=128), **kw)
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=128), **kw)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return jcfg, tcfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_embed_pooled_matches_jax(variant):
    jcfg, tcfg, jparams, tparams = _pair(variant)
    P, T = 16, 11
    tokens = np.zeros(P, np.int32)
    tokens[:T] = np.random.default_rng(1).integers(3, 128, T)
    want = np.asarray(jl.embed_pooled(jparams, jcfg, jnp.asarray(tokens), jnp.int32(T)))
    got = tl.embed_pooled(tparams, tcfg, torch.from_numpy(tokens).long(), T).numpy()
    assert got.shape == (tcfg.hidden_size,) and got.dtype == np.float32
    _close(got, want)


def test_runner_embed_matches_the_jax_runner():
    jcfg, tcfg, jparams, tparams = _pair()
    kw = dict(num_blocks=16, block_size=4, max_batch=2, max_model_len=64)
    jr = ModelRunner(jcfg, jparams, kv_dtype=jnp.float32, **kw)
    tr = TorchModelRunner(tcfg, tparams, device="cpu", **kw)
    for ids in ([5, 9, 7], list(range(3, 40))):
        _close(tr.embed(ids), np.asarray(jr.embed(ids)))


def test_nan_in_the_padding_rows_leaves_the_pooled_vector_finite(monkeypatch):
    """Padding rows of a bucket are unspecified in the prefill kernel: put
    NaN there (the valid rows computed as the plain op does) and the pooled
    vector stays finite and equal to the plain op's. The reference's mask
    product would give NaN."""
    _, tcfg, _, tparams = _pair()
    P, T = 16, 9
    tokens = torch.zeros(P, dtype=torch.long)
    tokens[:T] = torch.arange(5, 5 + T)
    want = tl.embed_pooled(tparams, tcfg, tokens, T)
    plain = tattn.causal_prefill_attention_plain

    def unspecified_padding(q, k, v, valid_len, **kw):
        out = torch.full_like(q, float("nan"))
        out[:valid_len] = plain(q[:valid_len], k[:valid_len], v[:valid_len], valid_len, **kw)
        return out

    monkeypatch.setattr(tl, "causal_prefill_attention", unspecified_padding)
    got = tl.embed_pooled(tparams, tcfg, tokens, T)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # the reference's pooling over the same rows: NaN
    h = torch.ones(P, 4)
    h[T:] = float("nan")
    mask = (torch.arange(P) < T)[:, None].float()
    assert torch.isnan((h * mask).sum(0)).all()


async def test_embeddings_route_matches_the_jax_frontend(model_dir):  # noqa: F811
    from dynamo_tpu.entrypoint import inputs as ref_inputs
    from dynamo_tpu.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.entrypoint import inputs as port_inputs

    ref_mdc, port_mdc = cards(model_dir)
    drt = await DistributedRuntime.detached()
    jeng, teng = make_jax_engine(), make_torch_engine()
    ref_svc = await ref_inputs.run_http(drt, ref_inputs.EngineConfig.static_(jeng, ref_mdc),
                                        host="127.0.0.1", port=0)
    port_svc = await port_inputs.run_http(port_inputs.EngineConfig.static_(teng, port_mdc),
                                          host="127.0.0.1", port=0)
    try:
        model = port_mdc.name
        payload = {"model": model, "input": ["w1 w2 w3", "w4 w5 w6 w7 w8"]}
        status, _, body = await afetch(port_svc.port, "POST", "/v1/embeddings", payload)
        assert status == 200, body
        got = json.loads(body)
        assert got["object"] == "list" and got["model"] == model and len(got["data"]) == 2
        v0, v1 = (np.array(d["embedding"]) for d in got["data"])
        assert v0.shape == (64,) and np.isfinite(v0).all() and not np.allclose(v0, v1)
        assert [d["index"] for d in got["data"]] == [0, 1]
        r_status, _, r_body = await afetch(ref_svc.port, "POST", "/v1/embeddings", payload)
        assert r_status == 200
        want = json.loads(r_body)
        assert got["usage"] == want["usage"] and got["usage"]["prompt_tokens"] > 0
        for g, w in zip(got["data"], want["data"]):
            _close(np.array(g["embedding"]), np.array(w["embedding"]))
        again = json.loads((await afetch(port_svc.port, "POST", "/v1/embeddings", payload))[2])
        assert again["data"][0]["embedding"] == got["data"][0]["embedding"]
        status, _, body = await afetch(port_svc.port, "POST", "/v1/embeddings",
                                       {"model": model, "input": [1, 2, 3]})
        assert status == 200 and json.loads(body)["usage"]["prompt_tokens"] == 3
        status, _, body = await afetch(port_svc.port, "POST", "/v1/embeddings",
                                       {"model": "nope", "input": "hi"})
        assert status == 404 and json.loads(body)["error"]["type"] == "not_found_error"
        status, _, _ = await afetch(port_svc.port, "POST", "/v1/embeddings", {"model": model})
        assert status == 400
        assert teng.stats.embeds == 5  # 2 + 2 + the token-id input
    finally:
        await port_svc.close()
        await ref_svc.close()
        await jeng.close()
        await teng.close()
        await drt.close()


async def test_embeddings_501_without_embed_path():
    from dynamo_tpu_torch.engine.echo import EchoEngineCore
    from dynamo_tpu_torch.entrypoint.inputs import EngineConfig, run_http
    from dynamo_tpu_torch.graphs.common import word_level_mdc

    service = await run_http(EngineConfig.static_(EchoEngineCore(), word_level_mdc("no-embed")),
                             host="127.0.0.1", port=0)
    try:
        status, _, body = await afetch(service.port, "POST", "/v1/embeddings",
                                       {"model": "no-embed", "input": "hi"})
        assert status == 501, body
        assert json.loads(body)["error"]["type"] == "not_implemented"
    finally:
        await service.close()
