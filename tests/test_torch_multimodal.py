"""The port's multimodal path against the JAX package's, on the CPU.

Twins of tests/test_multimodal.py's cases: the image processor and the
placeholder expansion, the vision tower (``encode_pixels`` /
``encode_frames``, parameters carried over from the JAX init by
``params_from_jax``, f32, rtol 1e-4 / atol 1e-4 x max|want|),
``prefill_mm`` against the JAX ``prefill_mm`` and against the splice oracle,
the encode worker's wire codec, the device path against the wire path (and
both against the reference's ``MultimodalEngine`` over ``JaxEngine``, token
for token under greedy sampling), the 501 of a text-only model, the HTTP
path end to end (in process and through the port's serve graph), GIF and
mp4 frames (PIL / cv2 are present here), and the preprocessor's lifting of
media parts. Beside them: the stdlib PNG reader against PIL on every colour
type and all five scanline filters, bit for bit, and an mm sequence
emitting no KV event.
"""

import asyncio
import base64
import io
import os
import struct
import subprocess
import sys
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.jax_engine.engine import JaxEngine, JaxEngineConfig
from dynamo_tpu.engine.jax_engine.model_runner import ModelRunner
from dynamo_tpu.models import llama as jl
from dynamo_tpu.multimodal import processor as ref_proc
from dynamo_tpu.multimodal import vision as ref_vision
from dynamo_tpu.multimodal.encode_worker import EncodeWorker as RefEncodeWorker
from dynamo_tpu.multimodal.worker import MultimodalEngine as RefMultimodalEngine
from dynamo_tpu.pipeline.context import Context as JaxContext
from dynamo_tpu.protocols import common as jp
from dynamo_tpu_torch.engine.torch_engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.engine.torch_engine.model_runner import TorchModelRunner
from dynamo_tpu_torch.engine.torch_engine.weights import params_from_jax
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.multimodal import processor as proc
from dynamo_tpu_torch.multimodal import vision
from dynamo_tpu_torch.multimodal.encode_worker import (
    EncodeClient,
    EncodeWorker,
    decode_embeddings,
)
from dynamo_tpu_torch.multimodal.worker import MultimodalEngine
from dynamo_tpu_torch.pipeline.context import Context
from dynamo_tpu_torch.protocols import common as tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JVIT = ref_vision.ViTConfig(image_size=32, patch_size=8, hidden_size=32, num_layers=1,
                            num_heads=2, out_dim=64)  # out_dim == tiny llama hidden
TVIT = vision.ViTConfig(image_size=32, patch_size=8, hidden_size=32, num_layers=1,
                        num_heads=2, out_dim=64)
BS, NB, MAX_BATCH, MAX_LEN = 4, 128, 4, 128


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def _png_data_url(seed=0, size=(40, 24)) -> str:
    from PIL import Image

    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 255, size=(size[1], size[0], 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def _gif_data_url(n_frames=6, seed=0, size=(20, 16)) -> str:
    from PIL import Image

    rng = np.random.default_rng(seed)
    frames = [Image.fromarray(rng.integers(0, 255, size=(size[1], size[0], 3), dtype=np.uint8),
                              "RGB") for _ in range(n_frames)]
    buf = io.BytesIO()
    frames[0].save(buf, format="GIF", save_all=True, append_images=frames[1:], duration=50, loop=0)
    return "data:image/gif;base64," + base64.b64encode(buf.getvalue()).decode()


def _vit_pair(seed=0):
    jparams = ref_vision.init_vit_params(JVIT, jax.random.PRNGKey(seed))
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


# ------------------------------------------------------------ processor


def test_processor_data_url_resize_and_expand():
    url = _png_data_url(seed=1)
    img = proc.load_image_array(url)
    assert img.dtype == np.uint8 and img.shape == (24, 40, 3)
    np.testing.assert_array_equal(img, ref_proc.load_image_array(url))
    px = proc.preprocess_pixels(img, 32)
    assert px.shape == (32, 32, 3) and px.dtype == np.float32
    assert px.min() >= -1.0 and px.max() <= 1.0
    np.testing.assert_array_equal(px, ref_proc.preprocess_pixels(img, 32))
    assert np.array_equal(px, proc.preprocess_pixels(img, 32))
    with pytest.raises(ValueError, match="data: URL"):
        proc.load_image_array("https://example.com/cat.png")
    ids, start = proc.expand_image_prompt([5, 9, 7, 3], 9, 4)
    assert ids == [5, 9, 9, 9, 9, 7, 3] and start == 1
    assert proc.expand_image_prompt([5, 7], 9, 4) == ([5, 7], -1)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _filter_row(ft: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> bytes:
    """Encode one scanline with PNG filter ``ft`` (the decoder's inverse)."""
    x = row.astype(np.int64)
    b = prev.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), b[:-bpp]])
    if ft == 0:
        pred = np.zeros_like(x)
    elif ft == 1:
        pred = a
    elif ft == 2:
        pred = b
    elif ft == 3:
        pred = (a + b) // 2
    else:
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return bytes([ft]) + ((x - pred) % 256).astype(np.uint8).tobytes()


def _write_png(pixels: np.ndarray, color: int, filters, palette=None) -> bytes:
    h, w = pixels.shape[:2]
    bpp = 1 if pixels.ndim == 2 else pixels.shape[2]
    rows = pixels.reshape(h, w * bpp)
    raw, prev = b"", np.zeros(w * bpp, np.uint8)
    for y in range(h):
        raw += _filter_row(filters[y % len(filters)], rows[y], prev, bpp)
        prev = rows[y]
    out = proc.PNG_SIGNATURE + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
    if palette is not None:
        out += _png_chunk(b"PLTE", palette.tobytes())
    return out + _png_chunk(b"IDAT", zlib.compress(raw)) + _png_chunk(b"IEND", b"")


@pytest.mark.parametrize("mode", ["gray", "gray_alpha", "rgb", "rgba", "palette"])
@pytest.mark.parametrize("ft", [0, 1, 2, 3, 4, "mixed"])
def test_stdlib_png_reader_equals_pil(mode, ft):
    from PIL import Image

    rng = np.random.default_rng(zlib.crc32(f"{mode}/{ft}".encode()))
    h, w = 13, 21
    color, ch = {"gray": (0, 1), "gray_alpha": (4, 2), "rgb": (2, 3), "rgba": (6, 4),
                 "palette": (3, 1)}[mode]
    palette = rng.integers(0, 256, (40, 3), dtype=np.uint8) if mode == "palette" else None
    hi = 40 if mode == "palette" else 256
    px = rng.integers(0, hi, (h, w, ch) if ch > 1 else (h, w), dtype=np.uint8)
    data = _write_png(px, color, [0, 1, 2, 3, 4] if ft == "mixed" else [ft], palette)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), dtype=np.uint8)
    got = proc.decode_png(data)
    assert got is not None and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    url = "data:image/png;base64," + base64.b64encode(data).decode()
    np.testing.assert_array_equal(proc.load_image_array(url), want)


APNG_CASES = {"rgb": ("RGB", {}), "rgba_dispose_background": ("RGBA", {"disposal": 1, "blend": 0}),
              "rgba_dispose_previous_over": ("RGBA", {"disposal": 2, "blend": 1}),
              "palette_left_to_pil": ("P", {})}


@pytest.mark.parametrize("case", sorted(APNG_CASES))
def test_animated_png_frames_equal_pil(case):
    """A video as an animated PNG: the stdlib reader's frames are PIL's
    frame iterator's, bit for bit (a 4-bit palette file goes to PIL)."""
    from PIL import Image, ImageSequence

    mode, kw = APNG_CASES[case]
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    frames = []
    for _ in range(5):
        rgb = rng.integers(0, 256, (16, 20, 3), dtype=np.uint8)
        if mode == "RGBA":
            frames.append(Image.fromarray(np.concatenate(
                [rgb, np.full((16, 20, 1), 255, np.uint8)], axis=2), "RGBA"))
        else:
            img = Image.fromarray(rgb, "RGB")
            frames.append(img.quantize(16) if mode == "P" else img)
    buf = io.BytesIO()
    frames[0].save(buf, format="PNG", save_all=True, append_images=frames[1:], duration=40, **kw)
    raw = buf.getvalue()
    want = [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(Image.open(io.BytesIO(raw)))]
    got = proc.decode_apng(raw)
    if mode == "P":
        assert got is None
    else:
        assert len(got) == len(want) == 5
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    url = "data:image/apng;base64," + base64.b64encode(raw).decode()
    np.testing.assert_array_equal(proc.load_video_frames(url, 4),
                                  proc.sample_frames(np.stack(want), 4))


def test_png_reader_refuses_a_corrupt_chunk_and_leaves_16_bit_to_pil():
    data = bytearray(_write_png(np.zeros((4, 4, 3), np.uint8), 2, [0]))
    data[-20] ^= 0xFF  # inside the IDAT chunk: its CRC no longer holds
    with pytest.raises(ValueError, match="CRC"):
        proc.decode_png(bytes(data))
    ihdr = struct.pack(">IIBBBBB", 2, 2, 16, 2, 0, 0, 0)
    sixteen = proc.PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr) + _png_chunk(b"IEND", b"")
    assert proc.decode_png(sixteen) is None  # left to PIL


# --------------------------------------------------------------- tower


def test_vision_encoder_matches_jax_and_is_deterministic():
    jparams, tparams = _vit_pair(0)
    px = (np.random.default_rng(3).random((2, 32, 32, 3)) * 2 - 1).astype(np.float32)
    want = np.asarray(ref_vision.encode_pixels(jparams, JVIT, jnp.asarray(px)))
    got = vision.encode_pixels(tparams, TVIT, torch.from_numpy(px)).numpy()
    assert got.shape == (2, TVIT.num_patches, TVIT.out_dim)
    _close(got, want)
    again = vision.encode_pixels(tparams, TVIT, torch.from_numpy(px)).numpy()
    assert np.array_equal(got, again)
    other = vision.encode_pixels(tparams, TVIT, torch.from_numpy(-px)).numpy()
    assert not np.allclose(got, other)
    # the port's own seeded init: the reference's tree, shapes and scales
    p = vision.init_vit_params(TVIT, torch.Generator().manual_seed(0))
    q = vision.init_vit_params(TVIT, torch.Generator().manual_seed(0))
    assert jax.tree.structure(jax.tree.map(np.asarray, jparams)) == jax.tree.structure(
        jax.tree.map(lambda t: t.numpy(), p))
    assert torch.equal(p["layers"][0]["qkv"], q["layers"][0]["qkv"])
    assert abs(float(p["patch_proj"].std()) - 0.02) < 0.003


def test_encode_frames_matches_per_frame_encode_and_jax():
    jparams, tparams = _vit_pair(0)
    frames = proc.load_video_frames(_gif_data_url(n_frames=5, seed=2), 3)
    px = proc.preprocess_video(frames, TVIT.image_size)
    span = vision.encode_frames(tparams, TVIT, torch.from_numpy(px)).numpy()
    P = TVIT.num_patches
    assert span.shape == (3 * P, TVIT.out_dim)
    for t in range(3):
        solo = vision.encode_pixels(tparams, TVIT, torch.from_numpy(px[t:t + 1])).numpy()[0]
        np.testing.assert_allclose(span[t * P:(t + 1) * P], solo, rtol=1e-6)
    _close(span, np.asarray(ref_vision.encode_frames(jparams, JVIT, jnp.asarray(px))))


# ---------------------------------------------------------- prefill_mm


def test_prefill_mm_matches_jax_and_the_splice_oracle():
    jcfg = jl.LlamaConfig.tiny(vocab_size=64)
    tcfg = tl.LlamaConfig.tiny(vocab_size=64)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    P, bs = 16, 4
    nb = P // bs
    kshape = (jcfg.num_layers, jcfg.num_kv_heads, nb + 1, bs, jcfg.head_dim)
    tokens = np.arange(1, P + 1, dtype=np.int32) % 60
    table = np.arange(1, nb + 1, dtype=np.int32) % (nb + 1)
    M, start = 4, 3
    mm = np.random.default_rng(5).normal(size=(M, jcfg.hidden_size)).astype(np.float32)
    want, jk, _ = jl.prefill_mm(jparams, jcfg, jnp.asarray(tokens), jnp.int32(P),
                                jnp.zeros(kshape, jnp.float32), jnp.zeros(kshape, jnp.float32),
                                jnp.asarray(table), jnp.asarray(mm), jnp.int32(start))
    tk, tv = torch.zeros(kshape), torch.zeros(kshape)
    tt, ttab = torch.from_numpy(tokens).long(), torch.from_numpy(table).long()
    got = tl.prefill_mm(tparams, tcfg, tt, P, tk, tv, ttab, torch.from_numpy(mm), start)
    _close(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5, rtol=0)
    # the oracle: the stack over hand-spliced embeddings
    x = tparams["embed"][tt].clone()
    x[start:start + M] = torch.from_numpy(mm)
    oracle = tl._prefill_from_embeds(tparams, tcfg, x, P, torch.zeros(kshape),
                                     torch.zeros(kshape), ttab)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=1e-5)
    text = tl.prefill(tparams, tcfg, tt, P, torch.zeros(kshape), torch.zeros(kshape), ttab)
    assert not np.allclose(got.numpy(), text.numpy(), atol=1e-3)


# ------------------------------------------------------------- engines


def _jax_llm():
    cfg = jl.LlamaConfig.tiny(vocab_size=64)
    params = jl.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    runner = ModelRunner(cfg, params, num_blocks=NB, block_size=BS, max_batch=MAX_BATCH,
                         max_model_len=MAX_LEN, kv_dtype=jnp.float32)
    return JaxEngine(runner, JaxEngineConfig(max_batch=MAX_BATCH, block_size=BS, num_blocks=NB,
                                             max_model_len=MAX_LEN)), params


def _torch_llm(jparams):
    cfg = tl.LlamaConfig.tiny(vocab_size=64)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    runner = TorchModelRunner(cfg, params, num_blocks=NB, block_size=BS, max_batch=MAX_BATCH,
                              max_model_len=MAX_LEN, device="cpu")
    return TorchEngine(runner, TorchEngineConfig(max_batch=MAX_BATCH, block_size=BS,
                                                 num_blocks=NB, max_model_len=MAX_LEN))


async def _greedy(engine, token_ids, extra=None, n=8, mod=tp, ctx=Context):
    req = mod.PreprocessedRequest(
        token_ids=list(token_ids), sampling=mod.SamplingOptions(greedy=True),
        stop=mod.StopConditions(max_tokens=n, ignore_eos=True), extra=dict(extra or {}))
    out = []
    async for item in engine.generate(req, ctx()):
        out.extend(item.token_ids or [])
        if item.finish_reason is not None:
            break
    return out


def test_encode_wire_codec_roundtrip_exact():
    _, tparams = _vit_pair(3)
    worker = EncodeWorker(tparams, TVIT)
    url = _png_data_url(seed=2)
    local = worker.encode_numpy(url)

    async def roundtrip():
        async for resp in worker.handler({"image_url": url}, Context()):
            return decode_embeddings(dict(resp))

    wire = asyncio.run(roundtrip())
    assert wire.dtype == np.float32 and np.array_equal(local, wire)


async def _device_and_wire(media_key, url, other=None, frames=3):
    """Tokens of one media + text request through the port's device path,
    its wire path (an encode worker on an in-process fabric), and the
    reference's MultimodalEngine over JaxEngine; plus the text-only and
    (for ``other``) another medium's tokens on the device path."""
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    prompt = [5, 6, 7, 8]
    jvit, tvit = _vit_pair(7)
    jeng, jparams = _jax_llm()
    ref = RefMultimodalEngine(jeng, RefEncodeWorker(jvit, JVIT), placeholder_id=0,
                              num_patches=JVIT.num_patches, video_frames=frames)
    out = {"ref": await _greedy(ref, prompt, {media_key: [url]}, mod=jp, ctx=JaxContext)}
    await jeng.close()
    dev = MultimodalEngine(_torch_llm(jparams), EncodeWorker(tvit, TVIT), placeholder_id=0,
                           num_patches=TVIT.num_patches, video_frames=frames)
    out["device"] = await _greedy(dev, prompt, {media_key: [url]})
    out["text"] = await _greedy(dev, prompt)
    if other is not None:
        out["other"] = await _greedy(dev, prompt, {media_key: [other]})
    out["mm_prefills"] = dev.stats.mm_prefills
    await dev.close()
    drt = await DistributedRuntime.detached()
    try:
        svc = await EncodeWorker(tvit, TVIT).serve(drt, "dynamo.encoder.encode")
        client = EncodeClient(drt, "dynamo.encoder.encode")
        wire = MultimodalEngine(_torch_llm(jparams), client, placeholder_id=0,
                                num_patches=TVIT.num_patches, video_frames=frames)
        out["wire"] = await _greedy(wire, prompt, {media_key: [url]})
        await wire.close()
        await client.close()
        await svc.stop(drain=False)
    finally:
        await drt.close()
    return out


async def test_engine_serves_image_device_vs_wire_identical():
    out = await _device_and_wire("mm_images", _png_data_url(seed=4))
    assert out["device"] == out["wire"] == out["ref"], out
    assert out["device"] != out["text"]
    assert out["mm_prefills"] == 1


async def test_engine_serves_video_device_vs_wire_identical():
    out = await _device_and_wire("mm_videos", _gif_data_url(n_frames=6, seed=11),
                                 other=_gif_data_url(n_frames=6, seed=12))
    assert out["device"] == out["wire"] == out["ref"], out
    assert out["device"] != out["text"]
    assert out["device"] != out["other"]


async def test_an_mm_sequence_emits_no_kv_event():
    """Two prompts with different images share their placeholder tokens: a
    Stored event of an mm sequence would poison prefix routing. A text
    prompt on the same engine still emits its blocks."""
    _, tvit = _vit_pair(7)
    _, jparams = _jax_llm()
    eng = MultimodalEngine(_torch_llm(jparams), EncodeWorker(tvit, TVIT), placeholder_id=0,
                           num_patches=TVIT.num_patches)
    stored = []
    eng.on_blocks_stored = lambda *a, **k: stored.append(a)
    assert eng.inner.on_blocks_stored is not None  # the hook reached the inner engine
    await _greedy(eng, [5, 6, 7, 8], {"mm_images": [_png_data_url(seed=4)]}, n=12)
    assert stored == []
    await _greedy(eng, list(range(3, 30)), n=4)
    assert stored
    await eng.close()


async def test_encode_worker_serves_video_over_wire():
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    _, tparams = _vit_pair(0)
    worker = EncodeWorker(tparams, TVIT)
    url = _gif_data_url(n_frames=6, seed=4)
    drt = await DistributedRuntime.detached()
    try:
        await worker.serve(drt, "mm.encoder.encode")
        client = EncodeClient(drt, "mm.encoder.encode")
        got = await client.encode_video(url, num_frames=4)
        want = worker.encode_video_numpy(url, num_frames=4)
        assert got.shape == (4 * TVIT.num_patches, TVIT.out_dim)
        np.testing.assert_array_equal(got, want)
        await client.close()
    finally:
        await drt.close()


# ---------------------------------------------------------------- video


def test_video_frames_gif_and_sampling():
    frames = proc.load_video_frames(_gif_data_url(n_frames=6), num_frames=4)
    assert frames.shape == (4, 16, 20, 3) and frames.dtype == np.uint8
    np.testing.assert_array_equal(frames, ref_proc.load_video_frames(_gif_data_url(n_frames=6), 4))
    short = proc.load_video_frames(_gif_data_url(n_frames=2), num_frames=5)
    assert short.shape == (5, 16, 20, 3)
    stack = (np.arange(10)[:, None, None, None] * np.ones((1, 4, 4, 3), np.uint8)).astype(np.uint8)
    picked = proc.sample_frames(stack, 4)
    assert picked[0].flat[0] == 0 and picked[-1].flat[0] == 9
    px = proc.preprocess_video(frames, 32)
    assert px.shape == (4, 32, 32, 3) and px.dtype == np.float32
    ids, start = proc.expand_video_prompt([5, 9, 7], 9, num_frames=4, num_patches=3)
    assert ids == [5] + [9] * 12 + [7] and start == 1
    with pytest.raises(ValueError, match="data: URL"):
        proc.load_video_frames("https://example.com/cat.mp4")


def test_video_frames_mp4(tmp_path):
    import cv2

    rng = np.random.default_rng(3)
    path = str(tmp_path / "clip.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (32, 24))
    for _ in range(10):
        w.write(rng.integers(0, 255, (24, 32, 3), dtype=np.uint8))
    w.release()
    frames = proc.load_video_frames(path, num_frames=8)
    assert frames.shape == (8, 24, 32, 3)
    assert not np.array_equal(frames[0], frames[-1])
    np.testing.assert_array_equal(frames, ref_proc.load_video_frames(path, num_frames=8))


def test_preprocessor_lifts_video_and_image_parts():
    from dynamo_tpu_torch.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.graphs.common import word_level_mdc

    pre = OpenAIPreprocessor(word_level_mdc("t"))
    req = ChatCompletionRequest.from_dict({
        "model": "t",
        "messages": [{"role": "user", "content": [
            {"type": "video_url", "video_url": {"url": "file:///tmp/a.mp4"}},
            {"type": "image_url", "image_url": {"url": "data:image/png;base64,AAAA"}},
            {"type": "text", "text": "w1 w2"},
        ]}],
    })
    out, prompt = pre.preprocess_chat(req)
    assert out.extra["mm_videos"] == ["file:///tmp/a.mp4"]
    assert out.extra["mm_images"] == ["data:image/png;base64,AAAA"]
    assert "w1 w2" in prompt and "base64" not in prompt


# ----------------------------------------------------------------- http


def _chat(url, text="w1 w2 w3", model="mm-model"):
    return {"model": model, "max_tokens": 6, "temperature": 0, "messages": [
        {"role": "user", "content": [{"type": "image_url", "image_url": {"url": url}},
                                     {"type": "text", "text": text}]}]}


async def test_image_request_rejected_on_text_only_model():
    from dynamo_tpu_torch.engine.echo import EchoEngineCore
    from dynamo_tpu_torch.entrypoint.inputs import EngineConfig, run_http
    from dynamo_tpu_torch.graphs.common import word_level_mdc
    from tests.test_torch_frontend import afetch

    service = await run_http(EngineConfig.static_(EchoEngineCore(), word_level_mdc("t")),
                             host="127.0.0.1", port=0)
    try:
        status, _, body = await afetch(service.port, "POST", "/v1/chat/completions",
                                       _chat(_png_data_url(), "hello", model="t"))
        assert status == 501, body
        assert b"not_implemented" in body
    finally:
        await service.close()


async def test_multimodal_http_e2e():
    """An image_url part -> the preprocessor -> MultimodalEngine -> a
    completion over the port's HTTP server."""
    from dynamo_tpu_torch.entrypoint.inputs import EngineConfig, run_http
    from dynamo_tpu_torch.graphs.common import word_level_mdc
    from tests.test_torch_frontend import afetch

    _, tvit = _vit_pair(7)
    _, jparams = _jax_llm()
    engine = MultimodalEngine(_torch_llm(jparams), EncodeWorker(tvit, TVIT), placeholder_id=0,
                              num_patches=TVIT.num_patches)
    service = await run_http(EngineConfig.static_(engine, word_level_mdc("mm-model")),
                             host="127.0.0.1", port=0)
    try:
        status, _, body = await afetch(service.port, "POST", "/v1/chat/completions",
                                       _chat(_png_data_url(seed=9)))
        assert status == 200, body
        import json

        content = json.loads(body)["choices"][0]["message"]["content"]
        assert isinstance(content, str) and content.strip()
        assert engine.stats.mm_prefills == 1
    finally:
        await service.close()
        await engine.close()


def test_multimodal_graph_over_http(tmp_path):
    """The port's serve graph (fabric, encode worker, tiny-torch worker,
    frontend: four processes on the CPU): an image chat streams tokens over
    the wire path (a 200: the worker's card says it takes images, which
    rides discovery to the frontend)."""
    import json
    import signal

    from tests.test_torch_frontend import fetch
    from dynamo_tpu_torch.parallel.launch import free_port

    port = free_port()
    env = {**os.environ, "PYTHONPATH": REPO, "DYN_DEVICE": "cpu", "DYN_MODEL_NAME": "mm-model"}
    cmd = [sys.executable, "-m", "dynamo_tpu_torch.serve", "dynamo_tpu_torch.graphs.multimodal",
           "--env", f"DYN_HTTP_PORT={port}", "--env", "DYN_HTTP_HOST=127.0.0.1"]
    log = open(tmp_path / "graph.log", "w")
    proc_ = subprocess.Popen(cmd, cwd=str(tmp_path), env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 120
        while True:
            try:
                status, _, body = fetch(port, "GET", "/v1/models", timeout=5)
                if status == 200 and json.loads(body)["data"]:
                    break
            except OSError:
                pass
            assert time.time() < deadline, (tmp_path / "graph.log").read_text()[-3000:]
            time.sleep(0.5)
        body = _chat(_png_data_url(seed=9))
        body["stream"] = True
        status, _, data = fetch(port, "POST", "/v1/chat/completions", body, timeout=60)
        assert status == 200, data
        assert data.count(b"data: ") >= 2 and b"[DONE]" in data
    finally:
        proc_.send_signal(signal.SIGTERM)
        try:
            proc_.wait(30)
        except subprocess.TimeoutExpired:
            proc_.kill()
            proc_.wait()
        log.close()
