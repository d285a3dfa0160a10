"""The port's GGUF reader, its parameter mapping and model resolution,
against the JAX package's, on the CPU.

Twins of tests/test_gguf_hub.py's and tests/test_gguf_kquants.py's cases,
on the files those tests write (and on files written here with F16
tensors): every dequantizer bit for bit against the reference's (and the
scalar transcription of the ggml spec); ``params_from_gguf`` bit for bit
against the reference's after ``params_from_jax`` (llama, Qwen2 biases,
Gemma ``1 + w`` norms in F16); the config and the embedded tokenizer; the
factory and the CLI serving a ``.gguf`` with its embedded tokenizer, greedy
tokens equal to ``JaxEngine``'s over the same file (f32); and hub
resolution with the download gate shut (a repo id whose snapshot holds only
a ``.gguf`` resolves to the file).
"""

import dataclasses
import json
import os
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu import gguf as ref_gguf
from dynamo_tpu_torch import gguf
from dynamo_tpu_torch.engine.torch_engine.weights import params_from_jax
from dynamo_tpu_torch.hub import resolve_model
from dynamo_tpu_torch.model_card import ModelDeploymentCard
from tests.test_gguf_hub import _T_ARRAY, _T_F32, _T_STRING, _T_U32, tiny_cfg
from tests.test_gguf_kquants import ALL_QUANTS, _rand_block, _scalar_dequant, _write_raw_gguf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ the writer


def _w_string(f, s):
    b = s.encode()
    f.write(struct.pack("<Q", len(b)) + b)


def _w_value(f, vtype, value):
    if vtype == _T_STRING:
        _w_string(f, value)
    elif vtype == _T_U32:
        f.write(struct.pack("<I", value))
    elif vtype == _T_F32:
        f.write(struct.pack("<f", value))
    else:  # an array
        etype, items = value
        f.write(struct.pack("<IQ", etype, len(items)))
        for it in items:
            _w_value(f, etype, it)


def _blob(arr, gt):
    if gt == gguf.GGML_F32:
        return np.ascontiguousarray(arr, np.float32).tobytes()
    if gt == gguf.GGML_F16:
        return np.ascontiguousarray(arr, np.float16).tobytes()
    if gt == gguf.GGML_BF16:
        t = torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(torch.bfloat16)
        return t.view(torch.int16).numpy().tobytes()
    assert gt == gguf.GGML_Q8_0
    flat = np.ascontiguousarray(arr, np.float32).reshape(-1, 32)
    d = np.abs(flat).max(axis=1) / 127.0
    d = np.where(d == 0, 1e-8, d).astype(np.float16)
    rec = np.zeros(len(flat), dtype=np.dtype([("d", "<f2"), ("q", "i1", (32,))]))
    rec["d"] = d
    rec["q"] = np.clip(np.round(flat / d.astype(np.float32)[:, None]), -127, 127)
    return rec.tobytes()


def write_gguf(path, metadata, tensors, align=32):
    """A GGUF v3 file: ``tensors`` {name: (numpy array [out, in], ggml
    type)} in F32, F16, BF16 or Q8_0."""
    with open(path, "wb") as f:
        f.write(struct.pack("<IIQQ", 0x46554747, 3, len(tensors), len(metadata)))
        for key, (vtype, value) in metadata.items():
            _w_string(f, key)
            f.write(struct.pack("<I", vtype))
            _w_value(f, vtype, value)
        blobs, offset = [], 0
        for name, (arr, gt) in tensors.items():
            _w_string(f, name)
            dims = list(reversed(arr.shape))
            f.write(struct.pack("<I", len(dims)) + b"".join(struct.pack("<Q", d) for d in dims))
            offset = (offset + align - 1) // align * align
            f.write(struct.pack("<IQ", gt, offset))
            blob = _blob(arr, gt)
            blobs.append((offset, blob))
            offset += len(blob)
        pos = f.tell()
        start = (pos + align - 1) // align * align
        for off, blob in blobs:
            f.seek(start + off)
            f.write(blob)


def llama_metadata(cfg, arch="llama", tokenizer=True):
    md = {
        "general.architecture": (_T_STRING, arch),
        f"{arch}.embedding_length": (_T_U32, cfg.hidden_size),
        f"{arch}.feed_forward_length": (_T_U32, cfg.intermediate_size),
        f"{arch}.block_count": (_T_U32, cfg.num_layers),
        f"{arch}.attention.head_count": (_T_U32, cfg.num_heads),
        f"{arch}.attention.head_count_kv": (_T_U32, cfg.num_kv_heads),
        f"{arch}.attention.key_length": (_T_U32, cfg.head_dim),
        f"{arch}.context_length": (_T_U32, cfg.max_position_embeddings),
        f"{arch}.vocab_size": (_T_U32, cfg.vocab_size),
        f"{arch}.rope.freq_base": (_T_F32, cfg.rope_theta),
        f"{arch}.attention.layer_norm_rms_epsilon": (_T_F32, cfg.rms_eps),
    }
    if tokenizer:
        n = cfg.vocab_size - 3
        md.update({
            "tokenizer.ggml.model": (_T_STRING, "llama"),
            "tokenizer.ggml.tokens": (_T_ARRAY, (_T_STRING, ["<unk>", "<s>", "</s>"]
                                                 + [f"▁w{i}" for i in range(n)])),
            "tokenizer.ggml.scores": (_T_ARRAY, (_T_F32, [0.0] * 3 + [-i / 10 for i in range(n)])),
            "tokenizer.ggml.token_type": (_T_ARRAY, (_T_U32, [2, 3, 3] + [1] * n)),
            "tokenizer.ggml.unknown_token_id": (_T_U32, 0),
            "tokenizer.ggml.bos_token_id": (_T_U32, 1),
            "tokenizer.ggml.eos_token_id": (_T_U32, 2),
        })
    return md


def write_model_gguf(path, cfg, seed=0, arch="llama", tokenizer=True):
    """Seeded random weights of ``cfg``'s shapes: F16 embeddings and output,
    F32 norms (F16 for Gemma: its ``1 + w`` is taken in the file's dtype),
    Q8_0 attention projections, BF16 MLP; Qwen2 gets F32 q/k/v biases."""
    rng = np.random.default_rng(seed)
    H, F, q, kv = cfg.hidden_size, cfg.intermediate_size, cfg.q_dim, cfg.kv_dim
    norm_t = gguf.GGML_F16 if arch.startswith("gemma") else gguf.GGML_F32

    def w(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    tensors = {"token_embd.weight": (w(cfg.vocab_size, H), gguf.GGML_F16),
               "output_norm.weight": (1 + w(H), norm_t),
               "output.weight": (w(cfg.vocab_size, H), gguf.GGML_F16)}
    for i in range(cfg.num_layers):
        b = f"blk.{i}."
        tensors.update({
            b + "attn_norm.weight": (1 + w(H), norm_t),
            b + "attn_q.weight": (w(q, H), gguf.GGML_Q8_0),
            b + "attn_k.weight": (w(kv, H), gguf.GGML_Q8_0),
            b + "attn_v.weight": (w(kv, H), gguf.GGML_Q8_0),
            b + "attn_output.weight": (w(H, q), gguf.GGML_Q8_0),
            b + "ffn_norm.weight": (1 + w(H), norm_t),
            b + "ffn_gate.weight": (w(F, H), gguf.GGML_BF16),
            b + "ffn_up.weight": (w(F, H), gguf.GGML_BF16),
            b + "ffn_down.weight": (w(H, F), gguf.GGML_BF16),
        })
        if arch == "qwen2":
            tensors.update({b + "attn_q.bias": (w(q), gguf.GGML_F32),
                            b + "attn_k.bias": (w(kv), gguf.GGML_F32),
                            b + "attn_v.bias": (w(kv), gguf.GGML_F32)})
        if arch == "gemma2":
            tensors.update({b + "post_attention_norm.weight": (w(H), norm_t),
                            b + "post_ffw_norm.weight": (w(H), norm_t)})
    write_gguf(path, llama_metadata(cfg, arch, tokenizer), tensors)
    return path


def _cfg():
    return tiny_cfg()  # vocab 64, hidden 32, 2 layers, 4 heads of 8, 2 kv heads


# --------------------------------------------------------- dequantizers


@pytest.mark.parametrize("gt", ALL_QUANTS)
def test_every_dequantizer_equals_the_reference_bit_for_bit(gt, tmp_path):
    rng = np.random.default_rng(gt)
    bsz, elems = gguf.GGML_BLOCK[gt]
    n = 6
    blob = b"".join(_rand_block(gt, rng) for _ in range(n))
    path = str(tmp_path / "t.gguf")
    _write_raw_gguf(path, "w", blob, (n, elems), gt)
    g, r = gguf.GgufFile(path), ref_gguf.GgufFile(path)
    got, want = g.tensor("w"), r.tensor("w")
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_allclose(got, _scalar_dequant(gt, blob, n).reshape(n, elems),
                               rtol=1e-6, atol=1e-6)
    g.close()
    r.close()


def test_q4_k_roundtrip_and_native_dtypes(tmp_path):
    """The reference's Q4_K round trip read through both readers; F32 /
    F16 natively and BF16 widened exactly to f32 (the reference's bf16
    array's values)."""
    from tests.test_gguf_kquants import test_q4_k_roundtrip_accuracy

    test_q4_k_roundtrip_accuracy(tmp_path)  # writes q4k.gguf and checks the reference
    path = str(tmp_path / "q4k.gguf")
    np.testing.assert_array_equal(gguf.GgufFile(path).tensor("w"),
                                  ref_gguf.GgufFile(path).tensor("w"))
    rng = np.random.default_rng(1)
    a = rng.standard_normal((4, 32)).astype(np.float32)
    path = str(tmp_path / "n.gguf")
    write_gguf(path, {"general.architecture": (_T_STRING, "llama")},
               {"f32": (a, gguf.GGML_F32), "f16": (a, gguf.GGML_F16), "bf16": (a, gguf.GGML_BF16)})
    g, r = gguf.GgufFile(path), ref_gguf.GgufFile(path)
    for name in ("f32", "f16"):
        np.testing.assert_array_equal(g.tensor(name), r.tensor(name))
    np.testing.assert_array_equal(g.tensor("bf16"), r.tensor("bf16").astype(np.float32))
    assert g.version == 3 and g.metadata == r.metadata


# ------------------------------------------------------------ mapping


@pytest.mark.parametrize("arch", ["llama", "qwen2", "gemma2"])
def test_params_from_gguf_bit_for_bit_against_the_reference(arch, tmp_path):
    path = write_model_gguf(str(tmp_path / f"{arch}.gguf"), _cfg(), arch=arch)
    r = ref_gguf.GgufFile(path)
    rcfg, rparams = ref_gguf.params_from_gguf(r)
    want = params_from_jax(jax.tree.map(np.asarray, rparams), device="cpu")
    g = gguf.GgufFile(path)
    cfg, got = gguf.params_from_gguf(g)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, got)) == jax.tree.structure(
        jax.tree.map(lambda t: 0, want))
    for (path_, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                  jax.tree_util.tree_flatten_with_path(want)[0]):
        assert a.dtype == b.dtype == torch.bfloat16, path_
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), path_
    ref_fields = dataclasses.asdict(rcfg)
    for k, v in dataclasses.asdict(cfg).items():
        if k in ref_fields:
            assert v == ref_fields[k], k
    if arch == "qwen2":
        assert cfg.attn_bias and "bq" in got["layers"][0]
    if arch == "gemma2":
        assert cfg.norm_plus_one and "post_attn_norm" in got["layers"][1]
    g.close()
    r.close()


def test_tokenizer_from_gguf_equals_the_reference(tmp_path):
    path = write_model_gguf(str(tmp_path / "t.gguf"), _cfg())
    tok = gguf.tokenizer_from_gguf(gguf.GgufFile(path))
    ref = ref_gguf.tokenizer_from_gguf(ref_gguf.GgufFile(path))
    for text in ("w1 w2", "w5  w60\nw3", "x w7"):
        assert tok.encode(text, add_special_tokens=False).ids == ref.encode(
            text, add_special_tokens=False).ids
    assert tok.eos_token_ids == ref.eos_token_ids
    card = ModelDeploymentCard.from_model_path(path, kv_block_size=4)
    assert card.tokenizer_kind == "sp" and card.name == "t"
    assert card.bos_token == "<s>" and card.eos_token == "</s>"
    assert card.load_tokenizer().decode(tok.encode("w1 w2", add_special_tokens=False).ids) == "w1 w2"


# ------------------------------------------------------------- serving


async def _tokens(engine, prompt, mod, ctx, n=8):
    req = mod.PreprocessedRequest(token_ids=list(prompt), sampling=mod.SamplingOptions(greedy=True),
                                  stop=mod.StopConditions(max_tokens=n, ignore_eos=True))
    out = []
    async for item in engine.generate(req, ctx()):
        out.extend(item.token_ids or [])
    return out


async def test_factory_serves_gguf_like_the_jax_engine(tmp_path):
    """``build_torch_engine('<file>.gguf')`` (its config and weights from
    the file) streams the greedy tokens of a JaxEngine over the reference's
    ``params_from_gguf`` of the same file, both in f32."""
    from dynamo_tpu.engine.jax_engine.engine import JaxEngine, JaxEngineConfig
    from dynamo_tpu.engine.jax_engine.model_runner import ModelRunner
    from dynamo_tpu.pipeline.context import Context as JaxContext
    from dynamo_tpu.protocols import common as jp
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.pipeline.context import Context
    from dynamo_tpu_torch.protocols import common as tp

    path = write_model_gguf(str(tmp_path / "tiny.gguf"), _cfg())
    r = ref_gguf.GgufFile(path)
    rcfg, rparams = ref_gguf.params_from_gguf(r, dtype=np.float32)
    r.close()
    kw = dict(num_blocks=64, block_size=4, max_batch=4, max_model_len=64)
    jeng = JaxEngine(ModelRunner(rcfg, rparams, kv_dtype=jnp.float32, **kw),
                     JaxEngineConfig(max_batch=4, block_size=4, num_blocks=64, max_model_len=64))
    teng = build_torch_engine(path, device="cpu", dtype=torch.float32, kv_block_size=4,
                              max_batch=4, num_blocks=64, max_model_len=64)
    assert teng.runner.params["layers"][0]["wq"].dtype == torch.float32
    for prompt in (list(range(2, 14)), [5, 9, 33, 7]):
        want = await _tokens(jeng, prompt, jp, JaxContext)
        got = await _tokens(teng, prompt, tp, Context)
        assert got == want and len(got) == 8
    await jeng.close()
    await teng.close()


def test_the_cli_serves_a_gguf_by_repo_id_with_its_embedded_tokenizer(tmp_path):
    """``python -m dynamo_tpu_torch.run in=batch:FILE out=torch --model-path
    org/tiny-gguf``: the id resolves through DYN_MODEL_CACHE to the snapshot's
    .gguf, whose own tokenizer serves."""
    cfg = dataclasses.replace(_cfg(), max_position_embeddings=64)
    snap = tmp_path / "cache" / "models--org--tiny-gguf" / "snapshots" / "r1"
    snap.mkdir(parents=True)
    write_model_gguf(str(snap / "tiny-q8.gguf"), cfg)
    batch = tmp_path / "batch.jsonl"
    batch.write_text(json.dumps({"prompt": "w1 w2 w3", "max_tokens": 5}) + "\n")
    env = dict(os.environ, PYTHONPATH=ROOT, DYN_MODEL_CACHE=str(tmp_path / "cache"))
    env.pop("DYN_ALLOW_DOWNLOAD", None)
    proc = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.run", f"in=batch:{batch}", "out=torch",
         "--model-path", "org/tiny-gguf", "--device", "cpu", "--num-blocks", "64",
         "--max-batch", "4", "--kv-block-size", "4"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    rows = [json.loads(x) for x in (tmp_path / "batch.jsonl.out.jsonl").read_text().splitlines()]
    assert len(rows) == 1 and rows[0]["text"]


def test_hub_resolution_with_the_download_gate_shut(tmp_path, monkeypatch):
    d = tmp_path / "model"
    d.mkdir()
    assert resolve_model(str(d)) == str(d)
    f = tmp_path / "m.gguf"
    f.write_bytes(b"GGUF")
    assert resolve_model(str(f)) == str(f)
    cache = tmp_path / "cache"
    snap = cache / "models--org--repo" / "snapshots" / "abc123"
    snap.mkdir(parents=True)
    (snap / "config.json").write_text("{}")
    gsnap = cache / "models--org--ggufs" / "snapshots" / "def456"
    gsnap.mkdir(parents=True)
    (gsnap / "b-q8.gguf").write_bytes(b"GGUF")
    (gsnap / "a-q4.gguf").write_bytes(b"GGUF")
    monkeypatch.setenv("DYN_MODEL_CACHE", str(cache))
    monkeypatch.delenv("DYN_ALLOW_DOWNLOAD", raising=False)
    assert resolve_model("org/repo") == str(snap)
    assert resolve_model("org/ggufs") == str(gsnap / "a-q4.gguf")
    from dynamo_tpu.hub import resolve_model as ref_resolve

    assert ref_resolve("org/repo") == resolve_model("org/repo")
    with pytest.raises(FileNotFoundError, match="Pre-stage"):
        resolve_model("org/absent")
