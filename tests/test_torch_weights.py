"""The port's checkpoint loading against the JAX package, on the CPU.

* ``read_safetensors`` (standard library and numpy only) reads what the
  ``safetensors`` package writes and reads: F32, BF16, F16, I32 and I64
  tensors over two shards, with a ``__metadata__`` entry, bit for bit;
* ``load_hf_safetensors`` maps tiny Llama, Qwen2 (q/k/v biases), Gemma2
  (+1 norm fold, sandwich norms, tied embeddings) and Mixtral
  (``block_sparse_moe``: router and stacked experts) checkpoints, written
  here with random numpy weights, onto the same parameters as the JAX
  ``load_hf_safetensors``, bit for bit in f32 and in bf16; an untied
  config without ``lm_head.weight`` falls back to the embeddings on both
  sides;
* ``build_torch_engine(<dir>, device="cpu")`` streams the tokens of a
  ``JaxEngine`` over the JAX loader's parameters from the same directory,
  both with their default admission path, for a Llama and a Mixtral
  (``tiny_moe``-shaped) checkpoint; a checkpoint directory whose config
  cannot be read raises.
"""

import asyncio
import json

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from dynamo_tpu.engine.jax_engine.engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.engine.jax_engine.model_runner import ModelRunner
from dynamo_tpu.engine.jax_engine.weights import load_hf_safetensors as jax_load
from dynamo_tpu.models.llama import LlamaConfig as JaxConfig
from dynamo_tpu.pipeline.context import Context as JaxContext
from dynamo_tpu.protocols import common as jp
from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
from dynamo_tpu_torch.engine.torch_engine.safetensors_reader import (
    SafetensorsError,
    read_safetensors,
    to_torch,
)
from dynamo_tpu_torch.engine.torch_engine.weights import load_hf_safetensors, load_or_init_params
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.protocols import common as tp


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def test_reader_matches_the_safetensors_package_over_two_shards(tmp_path):
    rng = np.random.default_rng(0)
    shards = [
        {
            "a.f32": rng.standard_normal((3, 5), dtype=np.float32),
            "b.bf16": rng.standard_normal((4, 2, 3)).astype(ml_dtypes.bfloat16),
            "c.i64": rng.integers(-2**40, 2**40, 7),
        },
        {
            "d.f16": rng.standard_normal(9).astype(np.float16),
            "e.i32": rng.integers(-2**30, 2**30, (2, 2)).astype(np.int32),
            "f.scalar": np.array(1.5, np.float32),
            "g.empty": np.zeros((0, 4), np.float32),
        },
    ]
    for i, t in enumerate(shards):
        save_file(t, str(tmp_path / f"model-0000{i + 1}-of-00002.safetensors"),
                  metadata={"format": "pt"})
    for i in range(2):
        path = str(tmp_path / f"model-0000{i + 1}-of-00002.safetensors")
        want = load_file(path)
        got = read_safetensors(path)
        assert sorted(got) == sorted(want)
        for name, ref in want.items():
            arr, dtype = got[name]
            assert arr.shape == ref.shape, name
            np.testing.assert_array_equal(arr, _bits(ref), err_msg=name)
            t = to_torch(got[name], "cpu")
            assert t.dtype == dtype and tuple(t.shape) == ref.shape
            if ref.dtype == ml_dtypes.bfloat16:
                np.testing.assert_array_equal(t.view(torch.int16).numpy(), _bits(ref))
            else:
                np.testing.assert_array_equal(t.numpy(), ref)


def test_reader_refuses_a_truncated_file(tmp_path):
    path = tmp_path / "model.safetensors"
    save_file({"w": np.ones((4, 4), np.float32)}, str(path))
    path.write_bytes(path.read_bytes()[:-8])
    with pytest.raises(SafetensorsError, match="data_offsets"):
        read_safetensors(str(path))


# tiny HF config.json files, one per family the loader maps differently
HF_CONFIGS = {
    "llama": {
        "architectures": ["LlamaForCausalLM"], "model_type": "llama", "vocab_size": 96,
        "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "rope_theta": 10000.0,
        "max_position_embeddings": 128, "tie_word_embeddings": False,
    },
    "qwen2": {
        "architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2", "vocab_size": 96,
        "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "rope_theta": 10000.0,
        "max_position_embeddings": 128, "tie_word_embeddings": False,
        "sliding_window": 32, "use_sliding_window": False,
    },
    "gemma2": {
        "architectures": ["Gemma2ForCausalLM"], "model_type": "gemma2", "vocab_size": 96,
        "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 8,
        "rope_theta": 10000.0, "max_position_embeddings": 128, "sliding_window": 6,
        "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
        "query_pre_attn_scalar": 8,
    },
    # tiny_moe's shapes (dynamo_tpu/models/mixtral.py) under Mixtral's names
    "mixtral": {
        "architectures": ["MixtralForCausalLM"], "model_type": "mixtral", "vocab_size": 256,
        "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "rope_theta": 10000.0,
        "max_position_embeddings": 512, "tie_word_embeddings": False,
        "num_local_experts": 4, "num_experts_per_tok": 2,
    },
}


def _hf_tensors(cfg: LlamaConfig, rng, lm_head=True) -> dict:
    """Random weights under HF's names and [out, in] layout, f32."""
    def w(*shape, scale=None):
        return (rng.standard_normal(shape) * (scale or shape[-1] ** -0.5)).astype(np.float32)

    H, I = cfg.hidden_size, cfg.intermediate_size
    t = {"model.embed_tokens.weight": w(cfg.vocab_size, H, scale=0.5),
         "model.norm.weight": w(H, scale=0.1)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = w(H, scale=0.1)
        t[p + "post_attention_layernorm.weight"] = w(H, scale=0.1)
        if cfg.sandwich_norms:
            t[p + "pre_feedforward_layernorm.weight"] = w(H, scale=0.1)
            t[p + "post_feedforward_layernorm.weight"] = w(H, scale=0.1)
        for name, shape in (("q_proj", (cfg.q_dim, H)), ("k_proj", (cfg.kv_dim, H)),
                            ("v_proj", (cfg.kv_dim, H)), ("o_proj", (H, cfg.q_dim))):
            t[p + f"self_attn.{name}.weight"] = w(*shape)
        if cfg.attn_bias:
            for name, n in (("q_proj", cfg.q_dim), ("k_proj", cfg.kv_dim), ("v_proj", cfg.kv_dim)):
                t[p + f"self_attn.{name}.bias"] = w(n, scale=0.5)
        if cfg.num_experts:
            m = p + "block_sparse_moe."
            t[m + "gate.weight"] = w(cfg.num_experts, H)
            for e in range(cfg.num_experts):
                for name, shape in (("w1", (I, H)), ("w3", (I, H)), ("w2", (H, I))):
                    t[f"{m}experts.{e}.{name}.weight"] = w(*shape)
            continue
        for name, shape in (("gate_proj", (I, H)), ("up_proj", (I, H)), ("down_proj", (H, I))):
            t[p + f"mlp.{name}.weight"] = w(*shape)
    if lm_head and not cfg.tie_word_embeddings:
        t["lm_head.weight"] = w(cfg.vocab_size, H)
    return t


def _write_checkpoint(tmp_path, family, lm_head=True, shards=2) -> str:
    d = tmp_path / family
    d.mkdir()
    (d / "config.json").write_text(json.dumps(HF_CONFIGS[family]))
    cfg = LlamaConfig.from_model_dir(str(d))
    tensors = _hf_tensors(cfg, np.random.default_rng(len(family)), lm_head)
    names = sorted(tensors)
    for i in range(shards):  # a sharded checkpoint, as HF writes large ones
        part = {n: tensors[n] for n in names[i::shards]}
        save_file(part, str(d / f"model-{i + 1:05d}-of-{shards:05d}.safetensors"))
    return str(d)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", sorted(HF_CONFIGS))
def test_loader_matches_the_jax_loader_bit_for_bit(tmp_path, family, dtype):
    model_dir = _write_checkpoint(tmp_path, family)
    cfg = LlamaConfig.from_model_dir(model_dir)
    want = jax_load(model_dir, JaxConfig.from_model_dir(model_dir), dtype=getattr(jnp, dtype))
    got = load_hf_safetensors(model_dir, cfg, device="cpu", dtype=getattr(torch, dtype))
    want, got = dict(_leaves(want)), dict(_leaves(got))
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        ref = np.asarray(ref)
        t = got[name]
        assert tuple(t.shape) == ref.shape, name
        if dtype == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), ref.view(np.int16),
                                          err_msg=name)
        else:
            np.testing.assert_array_equal(t.numpy(), ref, err_msg=name)
    if family == "gemma2":  # the +1 fold, the sandwich norms and the tied head
        assert cfg.norm_plus_one and cfg.sandwich_norms and "lm_head" not in got
        assert "/layers/0/post_attn_norm" in got and "/layers/0/post_mlp_norm" in got
    if family == "qwen2":
        assert "/layers/1/bq" in got
    if family == "mixtral":  # the router and the [E, in, out] expert stacks
        assert got["/layers/1/router"].shape == (64, 4)
        assert got["/layers/0/wg"].shape == (4, 64, 128)
        assert got["/layers/0/wd"].shape == (4, 128, 64)


def test_untied_config_without_lm_head_falls_back_to_the_embeddings(tmp_path):
    model_dir = _write_checkpoint(tmp_path, "llama", lm_head=False)
    cfg = LlamaConfig.from_model_dir(model_dir)
    assert not cfg.tie_word_embeddings
    want = jax_load(model_dir, JaxConfig.from_model_dir(model_dir), dtype=jnp.float32)
    got = load_hf_safetensors(model_dir, cfg, device="cpu", dtype=torch.float32)
    assert "lm_head" not in want and "lm_head" not in got


def test_a_directory_without_a_readable_config_raises(tmp_path):
    with pytest.raises(ValueError, match="cannot read the model config"):
        build_torch_engine(str(tmp_path), device="cpu")
    (tmp_path / "config.json").write_text("{not json")
    with pytest.raises(ValueError, match="cannot read the model config"):
        build_torch_engine(str(tmp_path), device="cpu")


def test_a_directory_without_safetensors_gets_seeded_random_weights(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(HF_CONFIGS["llama"]))
    cfg = LlamaConfig.from_model_dir(str(tmp_path))
    a = load_or_init_params(str(tmp_path), cfg, seed=3, device="cpu", dtype=torch.float32)
    b = load_or_init_params(None, cfg, seed=3, device="cpu", dtype=torch.float32)
    for (na, ta), (nb, tb) in zip(_leaves(a), _leaves(b)):
        assert na == nb and torch.equal(ta, tb)


PROMPTS = [[5, 9, 17, 23, 2, 40], [1, 2, 3], list(range(30, 50)), [42] * 9]
MAX_NEW = [8, 12, 6, 10]


async def _serve_checkpoint_both_ways(tmp_path, family):
    """The family's checkpoint through build_torch_engine(<dir>) and through
    a JaxEngine over the JAX loader's parameters; returns the port's engine."""
    model_dir = _write_checkpoint(tmp_path, family)
    jcfg = JaxConfig.from_model_dir(model_dir)
    jparams = jax_load(model_dir, jcfg, dtype=jnp.float32)
    runner = ModelRunner(jcfg, jparams, num_blocks=64, block_size=4, max_batch=4,
                         max_model_len=64, kv_dtype=jnp.float32, prefill_chunk_tokens=8)
    jeng = JaxEngine(runner, JaxEngineConfig(max_batch=4, block_size=4, num_blocks=64,
                                             max_model_len=64, watermark_blocks=2))
    teng = build_torch_engine(model_dir, device="cpu", dtype=torch.float32, kv_block_size=4,
                              max_batch=4, num_blocks=64, max_model_len=64,
                              prefill_chunk_tokens=8)

    async def serve(engine, mod, ctx):
        async def one(p, n):
            toks = []
            req = mod.PreprocessedRequest(token_ids=p, sampling=mod.SamplingOptions(greedy=True),
                                          stop=mod.StopConditions(max_tokens=n))
            async for out in engine.generate(req, ctx()):
                toks.extend(out.token_ids)
            return toks
        try:
            return await asyncio.gather(*(one(p, n) for p, n in zip(PROMPTS, MAX_NEW)))
        finally:
            await engine.close()

    want = await serve(jeng, jp, JaxContext)
    got = await serve(teng, tp, tp.Context)
    assert got == want and [len(t) for t in got] == MAX_NEW
    assert teng.stats.packed_prefills > 0 and teng.stats.prefills == 0
    return teng


async def test_engine_from_a_checkpoint_dir_streams_the_jax_engines_tokens(tmp_path):
    teng = await _serve_checkpoint_both_ways(tmp_path, "llama")
    assert "router" not in teng.runner.params["layers"][0]


async def test_engine_from_a_mixtral_checkpoint_dir_streams_the_jax_engines_tokens(tmp_path):
    """A tiny_moe-shaped Mixtral checkpoint (replacing the MoE refusal the
    port had before its MoE layers): served by build_torch_engine(<dir>,
    device="cpu") through the dropless MoE FFN, token for token."""
    teng = await _serve_checkpoint_both_ways(tmp_path, "mixtral")
    layer = teng.runner.params["layers"][0]
    assert layer["wg"].shape == (4, 64, 128) and layer["router"].shape == (64, 4)
