"""Guards of the PyTorch port: what it imports, where it runs, and its five
CUDA kernels against their plain versions on a card.

The ``cuda`` tests decide inside the test body whether a card is present, so
every pytest-xdist worker collects the same tests; here, without a card,
they skip. On the H100 (whose machine has no jax, which the suite's
conftest imports) they run with:

    python -m pytest --noconftest tests/test_torch_package.py -m cuda
"""

import ast
import ctypes
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.ops import attention as A
from dynamo_tpu_torch.ops import cuda_attention as K
from dynamo_tpu_torch.ops import cuda_linear as KL
from dynamo_tpu_torch.ops import kernels
from dynamo_tpu_torch.ops import linear as L
from dynamo_tpu_torch.ops.basics import rope_freqs

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the JAX package, and what the card's machine does not have
FORBIDDEN = ("jax", "jaxlib", "dynamo_tpu", "aiohttp", "pydantic", "jinja2", "tokenizers",
             "prometheus_client", "msgpack", "safetensors")


def _port_files():
    return sorted((ROOT / "dynamo_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax_or_the_jax_package(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_scan_covers_every_kernel_wrapper_and_engine_module():
    scanned = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for mod in ("ops/cuda_attention.py", "ops/cuda_linear.py", "ops/kernels.py",
                "engine/torch_engine/drafter.py", "engine/torch_engine/engine.py",
                "engine/torch_engine/model_runner.py", "engine/torch_engine/factory.py",
                "engine/torch_engine/graphs.py",
                "http/service.py", "tokenizer_json.py", "chat_template.py", "tokenizer.py",
                "preprocessor.py", "backend.py", "protocols/openai.py", "run.py",
                "entrypoint/inputs.py", "ops/collective.py", "parallel/mesh.py",
                "parallel/sharding.py", "parallel/multihost.py", "parallel/launch.py",
                "integrity.py", "disagg/protocols.py", "disagg/router.py",
                "disagg/colocated.py", "tokens.py", "block_manager/__init__.py",
                "block_manager/block.py", "block_manager/layout.py",
                "block_manager/offload.py", "block_manager/manager.py",
                "fabric/__init__.py", "fabric/mpack.py", "fabric/wire.py", "fabric/state.py",
                "fabric/server.py", "fabric/client.py", "runtime/__init__.py", "runtime/clock.py",
                "runtime/backoff.py", "runtime/cancellation.py", "runtime/protocols.py",
                "runtime/fencing.py", "runtime/config.py", "runtime/distributed.py",
                "runtime/component.py", "runtime/barrier.py", "pipeline/context.py",
                "pipeline/tcp.py", "pipeline/ingress.py", "pipeline/router.py", "discovery.py",
                "model_card.py", "engine/echo.py"):
        assert f"dynamo_tpu_torch/{mod}" in scanned
    # every kernel the counters cover has its source beside the package, and
    # the build makes it: an int8 mode is its bf16 source's second entry
    # point, #5's partial_out modes its third and fourth
    from dynamo_tpu_torch.ops import _build

    assert set(kernels.SOURCES) == set(kernels.KERNELS)
    for name, (stem, entry) in kernels.SOURCES.items():
        src = ROOT / "dynamo_tpu_torch" / "csrc" / f"{stem}.cu"
        assert src.is_file() and stem in _build.SOURCES
        assert entry.startswith(name.removesuffix("_int8"))
        assert f'extern "C" int {entry}(' in src.read_text()


def _variant_edits():
    from dynamo_tpu_torch.tools import kernel_variants, paged_trace, qkv_trace

    out = [(f"variant:{n}", edits) for n, (_, edits, _) in kernel_variants.VARIANTS.items()]
    out.append(("paged_trace", [("paged_attention.cuh", *e) for e in paged_trace.EDITS]))
    out.append(("qkv_trace", [(qkv_trace.SRC, *e) for e in qkv_trace.EDITS]))
    return out


@pytest.mark.parametrize("name,edits", _variant_edits(), ids=[n for n, _ in _variant_edits()])
def test_design_variant_and_trace_edits_match_the_shipped_sources(name, edits):
    """Each text edit of the design variants and the trace tools matches its
    source exactly once (applied in order), so every variant can still be
    built and timed beside the shipped kernel."""
    csrc = ROOT / "dynamo_tpu_torch" / "csrc"
    texts = {}
    for fname, old, new in edits:
        text = texts.get(fname) or (csrc / fname).read_text()
        assert text.count(old) == 1, (name, fname, old[:60])
        texts[fname] = text.replace(old, new)


def _need_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card refusal")


def test_build_torch_engine_defaults_to_the_card_and_refuses_without_one():
    _need_no_card()
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine

    with pytest.raises(RuntimeError, match="CUDA"):
        build_torch_engine()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_torch_engine(fused_decode=True, spec_k=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()


def test_kernel_wrappers_refuse_cpu_tensors_instead_of_falling_back():
    q = torch.zeros(2, 8, 128, dtype=torch.bfloat16)
    cache = torch.zeros(2, 4, 16, 128, dtype=torch.bfloat16)
    tables = torch.zeros(2, 3, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        K.paged_decode_attention_cuda(q, cache, cache, tables, lens)
    with pytest.raises(ValueError):
        K.flash_prefill_attention_cuda(q, cache[0, :2], cache[0, :2], 2)
    scales = torch.ones(2, 4)
    with pytest.raises(ValueError):
        K.paged_decode_attention_int8_cuda(q, cache.to(torch.int8), cache.to(torch.int8),
                                           tables, lens, scales, scales)
    q4 = q[:, None].expand(2, 3, 8, 128).contiguous()
    pos = torch.arange(3, dtype=torch.int32).repeat(2, 1)
    with pytest.raises(ValueError):
        K.paged_verify_attention_cuda(q4, cache, cache, tables, pos)
    with pytest.raises(ValueError):
        K.paged_verify_attention_int8_cuda(q4, cache.to(torch.int8), cache.to(torch.int8),
                                           tables, pos, scales, scales)
    x = torch.zeros(2, 256, dtype=torch.bfloat16)
    w = torch.zeros(256, 256, dtype=torch.bfloat16)
    cs = torch.zeros(2, 64)
    with pytest.raises(ValueError):
        KL.fused_qkv_rope_cuda(x, x[0], w, w[:, :128], w[:, :128], cs, cs, eps=1e-5,
                               num_heads=2, num_kv_heads=1, head_dim=128)
    with pytest.raises(ValueError):
        KL.fused_attn_out_residual_cuda(x, w, x)
    w8 = {"q": w.to(torch.int8), "s": torch.ones(256, dtype=torch.bfloat16)}
    with pytest.raises(ValueError):
        KL.fused_qkv_rope_int8_cuda(x, x[0], w8, w8, w8, cs, cs, eps=1e-5,
                                    num_heads=2, num_kv_heads=2, head_dim=128)
    with pytest.raises(ValueError):
        KL.fused_attn_out_residual_int8_cuda(x, w8, x)


def test_cpu_tensors_take_the_plain_versions():
    kernels.reset_launch_counts()
    q = torch.randn(4, 8, 16)
    k = torch.randn(4, 2, 16)
    A.causal_prefill_attention(q, k, k, 4)
    A.paged_decode_attention(q, torch.randn(2, 3, 4, 16), torch.randn(2, 3, 4, 16),
                             torch.ones(4, 1, dtype=torch.int32),
                             torch.ones(4, dtype=torch.int32))
    S = 3
    A.paged_verify_attention(torch.randn(4, S, 8, 16), torch.randn(2, 3, 4, 16),
                             torch.randn(2, 3, 4, 16), torch.ones(4, 1, dtype=torch.int32),
                             torch.arange(S, dtype=torch.int32).repeat(4, 1))
    x = torch.randn(4, 64)
    w = torch.randn(64, 64)
    L.fused_qkv_rope(x, x[0], w, w[:, :32], w[:, :32], torch.zeros(4, 8), torch.zeros(4, 8),
                     eps=1e-5, num_heads=4, num_kv_heads=2, head_dim=16)
    L.fused_attn_out_residual(x, w, x)
    # the int8 modes too: an int8-resident cache and int8 weights
    from dynamo_tpu_torch.ops import kv_quant

    kc = kv_quant.make_cache((2, 3, 4, 16), torch.float32, quantized=True)
    A.paged_decode_attention(q, kc, kc, torch.ones(4, 1, dtype=torch.int32),
                             torch.ones(4, dtype=torch.int32))
    A.paged_verify_attention(torch.randn(4, S, 8, 16), kc, kc, torch.ones(4, 1, dtype=torch.int32),
                             torch.arange(S, dtype=torch.int32).repeat(4, 1))
    w8 = L.quantize_int8(w)
    L.fused_qkv_rope(x, x[0], w8, L.quantize_int8(w[:, :32]), L.quantize_int8(w[:, :32]),
                     torch.zeros(4, 8), torch.zeros(4, 8),
                     eps=1e-5, num_heads=4, num_kv_heads=2, head_dim=16)
    L.fused_attn_out_residual(x, w8, x)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


# ------------------------------------------------------------- on the card


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


DECODE = {"full": {}, "window": {"window": 200}, "softcap": {"scale": 0.1, "logit_softcap": 4.0}}


@pytest.mark.cuda
@pytest.mark.parametrize("feature", sorted(DECODE))
def test_decode_kernel_matches_plain_on_card(feature):
    _need_card()
    g = torch.Generator().manual_seed(0)
    lens = [1, 15, 16, 33, 250, 700]
    B, Hq, Hkv, D, bs, nb, mb = len(lens), 32, 8, 128, 16, 128, 48
    perm = torch.randperm(nb - 1, generator=g) + 1
    tables = torch.zeros(B, mb, dtype=torch.int32)
    off = 0
    for b, n in enumerate(lens):
        k = -(-n // bs)
        tables[b, :k] = perm[off:off + k].int()
        off += k
    q = torch.randn(B, Hq, D, generator=g).bfloat16().cuda()
    kc = torch.randn(Hkv, nb, bs, D, generator=g).bfloat16().cuda()
    vc = torch.randn(Hkv, nb, bs, D, generator=g).bfloat16().cuda()
    args = (q, kc, vc, tables.cuda(), torch.tensor(lens, dtype=torch.int32).cuda())
    got = K.paged_decode_attention_cuda(*args, **DECODE[feature]).float()
    want = A.paged_decode_attention_plain(*args, **DECODE[feature]).float()
    torch.cuda.synchronize()
    # f32 in both; only the summation order differs: ~1 bf16 ulp
    assert ((got - want).abs() <= 1e-3 + 2.0 ** -6 * want.abs()).all()


PREFILL = {"full": {}, "window": {"window": 64}, "softcap": {"scale": 0.1, "logit_softcap": 4.0}}


def _prefill_case(P, valid, hq, hkv, d, kw, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(P, hq, d, generator=g).bfloat16().cuda()
    k = torch.randn(P, hkv, d, generator=g).bfloat16().cuda()
    v = torch.randn(P, hkv, d, generator=g).bfloat16().cuda()
    got = K.flash_prefill_attention_cuda(q, k, v, valid, **kw).float()
    want = A.causal_prefill_attention_plain(q, k, v, valid, **kw).float()
    torch.cuda.synchronize()
    # the kernel rounds the softmax weights to bf16 for P @ V
    err = (got[:valid] - want[:valid]).abs()
    assert (err <= 1e-2 + 2.0 ** -6 * want[:valid].abs()).all()
    assert np.isfinite(got.cpu().numpy()).all()
    # query tiles wholly in the padding are written as zeros
    bq = 128 * hkv // hq
    first_pad_tile = -(-valid // bq) * bq
    assert (got[first_pad_tile:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("feature", sorted(PREFILL))
@pytest.mark.parametrize("P,valid", [(128, 100), (300, 300), (512, 37), (129, 129), (300, 0),
                                     (300, 1), (2048, 2000)])
def test_prefill_kernel_matches_plain_on_card(feature, P, valid):
    _need_card()
    _prefill_case(P, valid, 32, 8, 128, PREFILL[feature], seed=P + valid)


@pytest.mark.cuda
@pytest.mark.parametrize("feature", sorted(PREFILL))
@pytest.mark.parametrize("G,D", [(1, 128), (2, 128), (8, 128), (1, 64), (4, 64), (8, 64),
                                 (3, 128), (6, 128), (7, 128), (3, 64), (7, 64),
                                 (1, 256), (2, 256), (8, 256)])
@pytest.mark.parametrize("P,valid", [(129, 129), (300, 257), (1000, 999)])
def test_prefill_kernel_groups_and_head_dims_on_card(feature, G, D, P, valid):
    """GQA groups (Hkv fixed at 8, Hq = 8 G) -- powers of two and groups
    that leave 128 mod G idle rows in the query tile (3, 6, 7) -- and every
    head dim, over ragged prompt lengths (the query tile's edge)."""
    _need_card()
    _prefill_case(P, valid, 8 * G, 8, D, PREFILL[feature], seed=G * 1000 + D + P)


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("M", [1, 8, 32, 64, 70, 96])
def test_fused_kernels_match_plain_on_card(M, bias):
    _need_card()
    g = torch.Generator().manual_seed(M)
    H, hq, hkv, d = 1024, 8, 2, 128
    bf = lambda *s, sd=1.0: (sd * torch.randn(*s, generator=g)).bfloat16().cuda()  # noqa: E731
    x, norm = bf(M, H), (1 + 0.1 * torch.randn(H, generator=g)).bfloat16().cuda()
    wq, wk, wv = bf(H, hq * d, sd=0.03), bf(H, hkv * d, sd=0.03), bf(H, hkv * d, sd=0.03)
    biases = (bf(hq * d, sd=0.1), bf(hkv * d, sd=0.1), bf(hkv * d, sd=0.1)) if bias else (None,) * 3
    angles = torch.randint(0, 4000, (M, 1), generator=g).float() * rope_freqs(d, 500000.0)
    cos, sin = torch.cos(angles).cuda(), torch.sin(angles).cuda()
    kw = dict(eps=1e-5, num_heads=hq, num_kv_heads=hkv, head_dim=d,
              bq=biases[0], bk=biases[1], bv=biases[2])
    got = KL.fused_qkv_rope_cuda(x, norm, wq, wk, wv, cos, sin, **kw)
    want = L.fused_qkv_rope_plain(x, norm, wq, wk, wv, cos, sin, **kw)
    attn, wo = bf(M, hq * d), bf(hq * d, H, sd=0.03)
    got_o = KL.fused_attn_out_residual_cuda(attn, wo, x)
    want_o = L.fused_attn_out_residual_plain(attn, wo, x)
    torch.cuda.synchronize()
    # f32 products summed in another order: a bf16 rounding may flip by one
    # ulp before RoPE / the residual add
    for a, b in zip((*got, got_o), (*want, want_o)):
        a, b = a.float(), b.float()
        assert ((a - b).abs() <= 1e-2 + 2.0 ** -6 * b.abs()).all()


def _qkv_inputs(M, H, hq, hkv, d, bias, seed):
    """The QKV head's inputs; weights of std 0.02, as init_params draws them."""
    g = torch.Generator().manual_seed(seed)
    bf = lambda *s, sd=1.0: (sd * torch.randn(*s, generator=g)).bfloat16().cuda()  # noqa: E731
    x, norm = bf(M, H), (1 + 0.1 * torch.randn(H, generator=g)).bfloat16().cuda()
    wq, wk, wv = bf(H, hq * d, sd=0.02), bf(H, hkv * d, sd=0.02), bf(H, hkv * d, sd=0.02)
    biases = (bf(hq * d, sd=0.1), bf(hkv * d, sd=0.1), bf(hkv * d, sd=0.1)) if bias else (None,) * 3
    angles = torch.randint(0, 4000, (M, 1), generator=g).float() * rope_freqs(d, 500000.0)
    args = (x, norm, wq, wk, wv, torch.cos(angles).cuda(), torch.sin(angles).cuda())
    kw = dict(eps=1e-5, num_heads=hq, num_kv_heads=hkv, head_dim=d,
              bq=biases[0], bk=biases[1], bv=biases[2])
    return args, kw


# (hidden, Hq, Hkv, D): a tile of two 64-wide heads; Gemma-2-9B's heads
# (D 256: a tile is one RoPE half-pair of boxes); Qwen2-7B's (G 7)
QKV_SHAPES = {"D64": (1024, 16, 2, 64), "D256": (3584, 16, 8, 256), "G7": (3584, 28, 4, 128)}


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("M", [1, 8, 32, 64, 70, 96])
@pytest.mark.parametrize("shape", sorted(QKV_SHAPES))
def test_fused_qkv_kernel_head_dims_and_groups_on_card(shape, M, bias):
    """The one-launch QKV head at head dims 64 and 256 and a group of 7,
    over one and two row groups."""
    _need_card()
    args, kw = _qkv_inputs(M, *QKV_SHAPES[shape], bias, seed=M + len(shape))
    got = KL.fused_qkv_rope_cuda(*args, **kw)
    want = L.fused_qkv_rope_plain(*args, **kw)
    torch.cuda.synchronize()
    # the f32 products (and the norm's sum of squares) are summed in another
    # order: a bf16 rounding may flip by one ulp before RoPE
    for name, a, b in zip("qkv", got, want):
        a, b = a.float(), b.float()
        assert torch.isfinite(a).all()
        err = (a - b).abs()
        bad = err > 1e-2 + 2.0 ** -6 * b.abs()
        assert not bad.any(), (name, int(bad.sum()), float(err.max()),
                               a[bad][:4].tolist(), b[bad][:4].tolist())


def _profiled(calls):
    """calls()'s result and the device kernels it launched, (name, records),
    under torch.profiler. On the H100 the profiler can drop a session's
    first device record (after other sessions in the process), so a spin
    kernel goes first and is left out of the list."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        out = calls()
        torch.cuda.synchronize()
    return out, [(e.key, e.count) for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key]


def _poisoned_calls(call, n: int = 3) -> list:
    """n call()s, each output allocated on bytes filled with NaN just
    before (the caching allocator hands the freed block back), so a call
    whose kernel did not write all of its output shows."""
    outs = []
    for _ in range(n):
        poison = torch.full_like(outs[-1] if outs else call(), float("nan"))
        del poison
        outs.append(call())
    torch.cuda.synchronize()
    return outs


@pytest.mark.cuda
def test_fused_qkv_kernel_is_one_launch_on_card():
    """Norm, product, split-K sum, bias and RoPE in one kernel: the launch
    counter and the profiler both see one launch per call."""
    _need_card()
    args, kw = _qkv_inputs(32, 4096, 32, 8, 128, True, seed=3)
    KL.fused_qkv_rope_cuda(*args, **kw)  # build and load first
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    _, device = _profiled(lambda: [KL.fused_qkv_rope_cuda(*args, **kw) for _ in range(3)])
    assert kernels.launch_counts()["fused_qkv_rope"] == 3
    assert len(device) == 1 and "fused_qkv_rope_kernel<" in device[0][0], device
    assert device[0][1] == 3, device


@pytest.mark.cuda
def test_fused_qkv_kernel_allocates_only_q_k_v_on_card():
    """No normed activations and no f32 partials in device memory: one call
    allocates q, k and v and nothing else."""
    _need_card()
    args, kw = _qkv_inputs(32, 4096, 32, 8, 128, False, seed=4)
    KL.fused_qkv_rope_cuda(*args, **kw)  # build and load first
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    outs = KL.fused_qkv_rope_cuda(*args, **kw)
    torch.cuda.synchronize()
    sizes = [t.numel() * t.element_size() for t in outs]
    assert torch.cuda.max_memory_allocated() - before == sum(-(-n // 512) * 512 for n in sizes)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 96])
def test_fused_qkv_kernel_is_bitwise_repeatable_on_card(M):
    """The norm's sums and the splits' partials are added in rank order."""
    _need_card()
    args, kw = _qkv_inputs(M, 4096, 32, 8, 128, True, seed=5)
    outs = [KL.fused_qkv_rope_cuda(*args, **kw) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for o in outs[1:] for a, b in zip(outs[0], o))


def _out_proj_inputs(M, H, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(M, H, generator=g).bfloat16().cuda()
    attn = torch.randn(M, H, generator=g).bfloat16().cuda()  # K = Hq * D = H here
    wo = (0.02 * torch.randn(H, H, generator=g)).bfloat16().cuda()
    return attn, wo, x


@pytest.mark.cuda
@pytest.mark.parametrize("H", [1024, 4096])
@pytest.mark.parametrize("M", [1, 8, 32, 64, 70, 96])
def test_out_proj_kernel_matches_plain_on_card(M, H):
    """The one-launch o-proj + residual at the decode (8), verify (32) and
    prefill-sized row counts, over one and two row groups."""
    _need_card()
    attn, wo, x = _out_proj_inputs(M, H, seed=M + H)
    got = KL.fused_attn_out_residual_cuda(attn, wo, x).float()
    want = L.fused_attn_out_residual_plain(attn, wo, x).float()
    torch.cuda.synchronize()
    # the splits' f32 partials are summed in another order than one matmul:
    # the bf16 rounding of the product may flip by one ulp before the add
    assert ((got - want).abs() <= 1e-2 + 2.0 ** -6 * want.abs()).all()


@pytest.mark.cuda
def test_out_proj_kernel_allocates_only_its_output_on_card():
    """The splits are reduced inside the launch: one call allocates the
    output and no f32 partial buffer."""
    _need_card()
    attn, wo, x = _out_proj_inputs(32, 4096, seed=7)
    KL.fused_attn_out_residual_cuda(attn, wo, x)  # build and load first
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = KL.fused_attn_out_residual_cuda(attn, wo, x)
    torch.cuda.synchronize()
    out_bytes = -(-out.numel() * out.element_size() // 512) * 512  # allocator granularity
    assert torch.cuda.max_memory_allocated() - before == out_bytes


VERIFY = {"full": {}, "window": {"window": 100}, "softcap": {"scale": 0.1, "logit_softcap": 4.0}}


@pytest.mark.cuda
@pytest.mark.parametrize("feature", sorted(VERIFY))
@pytest.mark.parametrize("S", [1, 4, 6])
def test_verify_kernel_matches_plain_on_card(feature, S):
    _need_card()
    g = torch.Generator().manual_seed(S)
    B, Hq, Hkv, D, bs, nb, mb = 5, 32, 8, 128, 16, 160, 40
    bases = [0, 15, 200, 333, 600]
    perm = torch.randperm(nb - 1, generator=g) + 1
    tables = torch.zeros(B, mb, dtype=torch.int32)
    off = 0
    for b, p in enumerate(bases):
        n = (p + S - 1 - b % 2) // bs + 1  # odd lanes drafted one token less
        tables[b, :n] = perm[off:off + n].int()
        off += n
    pos = (torch.tensor(bases)[:, None] + torch.arange(S)[None, :]).int()
    q = torch.randn(B, S, Hq, D, generator=g).bfloat16().cuda()
    kc = torch.randn(Hkv, nb, bs, D, generator=g).bfloat16().cuda()
    vc = torch.randn(Hkv, nb, bs, D, generator=g).bfloat16().cuda()
    args = (q, kc, vc, tables.cuda(), pos.cuda())
    got = K.paged_verify_attention_cuda(*args, **VERIFY[feature]).float()
    want = A.paged_verify_attention_plain(*args, **VERIFY[feature]).float()
    torch.cuda.synchronize()
    # PR 2's kernel rounded the softmax weights to bf16 for P @ V
    assert ((got - want).abs() <= 1e-2 + 2.0 ** -6 * want.abs()).all()


# ----------------------------------- the page-streaming decode / verify design

# chip_smoke.py's decode tolerance: f32 softmax weights (a bf16 hi/lo pair on
# the tensor cores), f32 sums; the page-streaming verify kernel meets it too
DECODE_TOL = (1e-3, 2.0 ** -6)


def _close(got, want, tol):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).abs()
    assert (err <= tol[0] + tol[1] * want.abs()).all(), float(err.max())


def _paged_inputs(ends, pages, S, G, D, bs, max_blocks, seed, hkv=2):
    """Random pages of a [hkv, num_blocks, bs, D] bf16 cache on the card: lane
    b owns pages[b] distinct, shuffled pages; q is [B, S, hkv * G, D]."""
    g = torch.Generator().manual_seed(seed)
    B = len(ends)
    nb = sum(pages) + 2
    perm = torch.randperm(nb - 1, generator=g) + 1
    tables = torch.zeros(B, max_blocks, dtype=torch.int32)
    off = 0
    for b, n in enumerate(pages):
        tables[b, :n] = perm[off:off + n].int()
        off += n
    q = torch.randn(B, S, hkv * G, D, generator=g).bfloat16().cuda()
    kc = torch.randn(hkv, nb, bs, D, generator=g).bfloat16().cuda()
    vc = torch.randn(hkv, nb, bs, D, generator=g).bfloat16().cuda()
    return q, kc, vc, tables.cuda()


def _decode_case(lens, G, D, bs, max_blocks, seed, hkv=2):
    q, kc, vc, tables = _paged_inputs(
        lens, [min(-(-n // bs), max_blocks) for n in lens], 1, G, D, bs, max_blocks, seed, hkv)
    return q[:, 0].contiguous(), kc, vc, tables, torch.tensor(lens, dtype=torch.int32).cuda()


def _verify_case(bases, S, G, D, bs, max_blocks, seed, hkv=2):
    """Odd lanes drafted one token less: their tables end a position early."""
    drafted = [S - 1 - (b % 2 if S > 1 else 0) for b in range(len(bases))]
    pages = [(p + d) // bs + 1 for p, d in zip(bases, drafted)]
    q, kc, vc, tables = _paged_inputs(bases, pages, S, G, D, bs, max_blocks, seed, hkv)
    pos = (torch.tensor(bases)[:, None] + torch.arange(S)[None, :]).int().cuda()
    return q, kc, vc, tables, pos


# every group of the earlier grid, groups that are no power of two (3, 6, 7),
# D 256 at larger groups, and groups of more than one 16-row tile (20, 24)
GROUP_DIMS = [(g, d) for g in (1, 2, 3, 4, 6, 7, 8) for d in (64, 128, 256)
              if d < 256 or g in (1, 2, 4, 8)] + [(20, 128), (24, 64)]
FEATURES = {"full": {}, "window_softcap": {"window": 100, "scale": 0.1, "logit_softcap": 4.0}}


@pytest.mark.cuda
@pytest.mark.parametrize("feature", sorted(FEATURES))
@pytest.mark.parametrize("bs", [16, 32])
@pytest.mark.parametrize("G,D", GROUP_DIMS)
def test_decode_design_groups_dims_and_edges_on_card(G, D, bs, feature):
    """GQA groups and head dims of the decode kernel (any group: 16-row
    tiles), at contexts of 1, a page edge, a ring-stage edge (64 keys),
    three stages, and the table's whole reach."""
    _need_card()
    mb = 20
    lens = [1, bs, bs + 1, 64, 65, 192, mb * bs]
    args = _decode_case(lens, G, D, bs, mb, seed=G * 100 + D + bs)
    got = K.paged_decode_attention_cuda(*args, **FEATURES[feature])
    want = A.paged_decode_attention_plain(*args, **FEATURES[feature])
    torch.cuda.synchronize()
    _close(got, want, DECODE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["long_B1", "short_B64"])
def test_decode_design_long_and_many_short_on_card(case):
    """One 4096-key sequence alone (every split live), and 64 short ones
    (one split each, many pairs)."""
    _need_card()
    if case == "long_B1":
        lens, mb = [4096], 256
    else:
        lens, mb = [int(n) for n in np.random.default_rng(0).integers(1, 100, 64)], 8
    args = _decode_case(lens, 4, 128, 16, mb, seed=len(lens), hkv=8)
    got = K.paged_decode_attention_cuda(*args)
    want = A.paged_decode_attention_plain(*args)
    torch.cuda.synchronize()
    _close(got, want, DECODE_TOL)


VERIFY_GROUP_DIMS = [(g, d) for g in (1, 2, 3, 4, 6, 7, 8) for d in (64, 128)] + [
    (1, 256), (2, 256), (8, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 4, 8])
@pytest.mark.parametrize("G,D", VERIFY_GROUP_DIMS)
def test_verify_design_groups_dims_and_drafts_on_card(G, D, S):
    """GQA groups (powers of two and 3, 6, 7) and head dims (D 256: a
    2-stage ring) of the verify kernel at S = 1, 4 and 8 positions (up to
    four 16-row tiles), lanes whose drafts stop early."""
    _need_card()
    args = _verify_case([0, 15, 63, 200, 333], S, G, D, 16, 30, seed=G * 10 + D + S)
    got = K.paged_verify_attention_cuda(*args)
    want = A.paged_verify_attention_plain(*args)
    torch.cuda.synchronize()
    _close(got, want, DECODE_TOL)


@pytest.mark.cuda
def test_verify_at_one_position_matches_decode_on_card():
    _need_card()
    lens = [1, 17, 64, 65, 300, 1000]
    q, kc, vc, tables, ctx = _decode_case(lens, 4, 128, 16, 64, seed=3, hkv=8)
    dec = K.paged_decode_attention_cuda(q, kc, vc, tables, ctx)
    ver = K.paged_verify_attention_cuda(q[:, None].contiguous(), kc, vc, tables,
                                        (ctx - 1)[:, None].contiguous())
    torch.cuda.synchronize()
    _close(ver[:, 0], dec, DECODE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["decode", "verify"])
def test_paged_kernels_are_bitwise_repeatable_on_card(kernel):
    """The splits merge in a fixed order, whichever finishes last."""
    _need_card()
    if kernel == "decode":
        args = _decode_case([1, 300, 1777, 3001], 4, 128, 16, 200, seed=5, hkv=8)
        fn = K.paged_decode_attention_cuda
    else:
        args = _verify_case([3, 511, 1500, 2996], 4, 4, 128, 16, 200, seed=5, hkv=8)
        fn = K.paged_verify_attention_cuda
    outs = [fn(*args) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["decode", "verify"])
def test_paged_kernels_allocate_only_output_and_partials_on_card(kernel):
    """One call allocates its output and the f32 split partials
    ([pairs x tiles x splits, 16, D] and [.., 16, 2]) and nothing else: the
    tickets are cached per device."""
    _need_card()
    if kernel == "decode":
        args = _decode_case([17, 1000, 3001], 4, 128, 16, 200, seed=6, hkv=8)
        fn = K.paged_decode_attention_cuda
        B, tiles = 3, 1
        splits = K._fn("paged_decode_attention", "paged_decode_num_splits", [ctypes.c_int] * 5)(
            B, 32, 8, 200, 16)
    else:
        args = _verify_case([17, 1000, 3001], 4, 4, 128, 16, 200, seed=6, hkv=8)
        fn = K.paged_verify_attention_cuda
        B, tiles = 3, 1
        splits = K._fn("paged_verify_attention", "paged_verify_num_splits", [ctypes.c_int] * 6)(
            B, 4, 32, 8, 200, 16)
    fn(*args)  # build, load and allocate the tickets first
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn(*args)
    torch.cuda.synchronize()
    n_part = B * 8 * tiles * splits
    sizes = (out.numel() * 2, n_part * 16 * 128 * 4, n_part * 16 * 2 * 4)
    assert torch.cuda.max_memory_allocated() - before == sum(-(-n // 512) * 512 for n in sizes)


# ------------------------------------------------- the int8 modes on the card


def _int8_pages(kc: torch.Tensor, seed: int):
    """An int8-resident cache of kc's shape: random mantissas and a random
    f32 scale per (head, page), so every page of a context scales
    differently."""
    g = torch.Generator().manual_seed(seed)
    hkv, nb = kc.shape[:2]
    q = torch.randint(-127, 128, tuple(kc.shape), generator=g, dtype=torch.int8).cuda()
    s = (0.002 + 0.02 * torch.rand(hkv, nb, generator=g)).cuda()
    return q, s


def _int8_decode_case(lens, G, D, bs, max_blocks, seed, hkv=2):
    q, kc, _, tables, ctx = _decode_case(lens, G, D, bs, max_blocks, seed, hkv)
    (kq, ks), (vq, vs) = _int8_pages(kc, seed + 1), _int8_pages(kc, seed + 2)
    return (q, kq, vq, tables, ctx), dict(k_scales=ks, v_scales=vs)


def _int8_verify_case(bases, S, G, D, bs, max_blocks, seed, hkv=2):
    q, kc, _, tables, pos = _verify_case(bases, S, G, D, bs, max_blocks, seed, hkv)
    (kq, ks), (vq, vs) = _int8_pages(kc, seed + 1), _int8_pages(kc, seed + 2)
    return (q, kq, vq, tables, pos), dict(k_scales=ks, v_scales=vs)


@pytest.mark.cuda
@pytest.mark.parametrize("feature", sorted(FEATURES))
@pytest.mark.parametrize("bs", [16, 32])
@pytest.mark.parametrize("G,D", GROUP_DIMS)
def test_int8_decode_kernel_matches_plain_on_card(G, D, bs, feature):
    """#1's int8 mode over the bf16 mode's groups, head dims and edges
    (contexts of 1, a page edge, a ring-stage edge, three stages, the
    table's reach), every page scaled differently, at the bf16 mode's
    tolerance."""
    _need_card()
    mb = 20
    args, sc = _int8_decode_case([1, bs, bs + 1, 64, 65, 192, mb * bs], G, D, bs, mb,
                                 seed=G * 100 + D + bs)
    got = K.paged_decode_attention_int8_cuda(*args, sc["k_scales"], sc["v_scales"],
                                             **FEATURES[feature])
    want = A.paged_decode_attention_plain(*args, **sc, **FEATURES[feature])
    torch.cuda.synchronize()
    _close(got, want, DECODE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 4, 8])
@pytest.mark.parametrize("G,D", VERIFY_GROUP_DIMS)
def test_int8_verify_kernel_matches_plain_on_card(G, D, S):
    """#2's int8 mode over the bf16 mode's groups, head dims and draft
    counts, lanes whose drafts stop early, window and softcap on one case."""
    _need_card()
    args, sc = _int8_verify_case([0, 15, 63, 200, 333], S, G, D, 16, 30, seed=G * 10 + D + S)
    kw = FEATURES["window_softcap"] if (G, S) == (4, 4) else {}
    got = K.paged_verify_attention_int8_cuda(*args, sc["k_scales"], sc["v_scales"], **kw)
    want = A.paged_verify_attention_plain(*args, **sc, **kw)
    torch.cuda.synchronize()
    _close(got, want, DECODE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["decode", "verify"])
def test_int8_paged_kernels_are_one_launch_and_bitwise_repeatable_on_card(kernel):
    """One launch per call (the counter, and the profiler's one kernel
    name), the same bits on every call, and no bf16 launch. Here the
    profiler dropped one of the three records on the H100 after other
    sessions in the process, so it bounds the records by the calls, and
    each call's output, allocated on NaN bytes, shows that its kernel
    ran."""
    _need_card()
    if kernel == "decode":
        args, sc = _int8_decode_case([1, 300, 1777, 3001], 4, 128, 16, 200, seed=5, hkv=8)
        fn = K.paged_decode_attention_int8_cuda
    else:
        args, sc = _int8_verify_case([3, 511, 1500, 2996], 4, 4, 128, 16, 200, seed=5, hkv=8)
        fn = K.paged_verify_attention_int8_cuda
    fn(*args, sc["k_scales"], sc["v_scales"])  # build and load first
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    outs, device = _profiled(lambda: [fn(*args, sc["k_scales"], sc["v_scales"]) for _ in range(3)])
    counts = kernels.launch_counts()
    assert counts[f"paged_{kernel}_attention_int8"] == 3
    assert sum(counts.values()) == 3
    assert len(device) == 1 and "paged_attention_kernel<" in device[0][0], device
    assert 1 <= device[0][1] <= 3, device
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    kernels.reset_launch_counts()
    poisoned = _poisoned_calls(lambda: fn(*args, sc["k_scales"], sc["v_scales"]))
    assert kernels.launch_counts()[f"paged_{kernel}_attention_int8"] == 4
    assert all(torch.isfinite(o.float()).all() and torch.equal(outs[0], o) for o in poisoned)


@pytest.mark.cuda
def test_int8_kernels_raise_on_what_they_refuse_on_card():
    """A head dim no kernel is built for, mantissas that are not int8 and
    scale planes of the wrong shape raise; nothing launches, nothing falls
    back to a plain version."""
    _need_card()
    kernels.reset_launch_counts()
    args, sc = _int8_decode_case([17, 40], 4, 128, 16, 8, seed=9)
    q, kq, vq, tables, ctx = args
    q96 = torch.zeros(2, 8, 96, dtype=torch.bfloat16, device="cuda")
    k96 = torch.zeros(2, kq.shape[1], 16, 96, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="head_dim 96"):
        K.paged_decode_attention_int8_cuda(q96, k96, k96, tables, ctx, sc["k_scales"],
                                           sc["v_scales"])
    with pytest.raises(TypeError):
        K.paged_decode_attention_int8_cuda(q, kq.bfloat16(), vq.bfloat16(), tables, ctx,
                                           sc["k_scales"], sc["v_scales"])
    with pytest.raises(ValueError, match="k_scales"):
        K.paged_decode_attention_int8_cuda(q, kq, vq, tables, ctx, sc["k_scales"][:, :3],
                                           sc["v_scales"])
    x = torch.zeros(8, 4096, dtype=torch.bfloat16, device="cuda")
    w8 = {"q": torch.zeros(4096, 96 * 32, dtype=torch.int8, device="cuda"),
          "s": torch.ones(96 * 32, dtype=torch.bfloat16, device="cuda")}
    cs = torch.zeros(8, 48, device="cuda")
    with pytest.raises(ValueError, match="head_dim 96"):
        KL.fused_qkv_rope_int8_cuda(x, x[0], w8, w8, w8, cs, cs, eps=1e-5, num_heads=32,
                                    num_kv_heads=32, head_dim=96)
    wo = {"q": torch.zeros(4096, 4000, dtype=torch.int8, device="cuda"),
          "s": torch.ones(4000, dtype=torch.bfloat16, device="cuda")}
    with pytest.raises(ValueError):
        KL.fused_attn_out_residual_int8_cuda(x, wo, torch.zeros(8, 4000, dtype=torch.bfloat16,
                                                                device="cuda"))
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


def _quantized(w: torch.Tensor) -> dict:
    return L.quantize_int8(w)


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("M", [1, 8, 32, 64, 70, 96])
@pytest.mark.parametrize("shape", sorted(QKV_SHAPES) + ["llama"])
def test_int8_fused_qkv_kernel_matches_plain_on_card(shape, M, bias):
    """#4's int8 mode at Llama-3.1-8B's heads, head dims 64 and 256 and a
    group of 7, over one and two row groups, at the bf16 mode's tolerance."""
    _need_card()
    dims = QKV_SHAPES.get(shape, (4096, 32, 8, 128))
    args, kw = _qkv_inputs(M, *dims, bias, seed=M + len(shape))
    x, norm, wq, wk, wv, cos, sin = args
    args = (x, norm, _quantized(wq), _quantized(wk), _quantized(wv), cos, sin)
    got = KL.fused_qkv_rope_int8_cuda(*args, **kw)
    want = L.fused_qkv_rope_plain(*args, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip("qkv", got, want):
        a, b = a.float(), b.float()
        assert torch.isfinite(a).all()
        err = (a - b).abs()
        bad = err > 1e-2 + 2.0 ** -6 * b.abs()
        assert not bad.any(), (name, int(bad.sum()), float(err.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("H", [1024, 4096])
@pytest.mark.parametrize("M", [1, 8, 32, 64, 70, 96])
def test_int8_out_proj_kernel_matches_plain_on_card(M, H):
    _need_card()
    attn, wo, x = _out_proj_inputs(M, H, seed=M + H)
    w8 = _quantized(wo)
    got = KL.fused_attn_out_residual_int8_cuda(attn, w8, x).float()
    want = L.fused_attn_out_residual_plain(attn, w8, x).float()
    torch.cuda.synchronize()
    assert ((got - want).abs() <= 1e-2 + 2.0 ** -6 * want.abs()).all()


@pytest.mark.cuda
def test_int8_fused_heads_are_one_launch_repeatable_and_allocate_only_outputs_on_card():
    """Each int8 head: one launch per call (counted), the same bits on
    every call, and only its outputs allocated."""
    _need_card()
    args, kw = _qkv_inputs(32, 4096, 32, 8, 128, True, seed=6)
    x, norm, wq, wk, wv, cos, sin = args
    qargs = (x, norm, _quantized(wq), _quantized(wk), _quantized(wv), cos, sin)
    attn, wo, xo = _out_proj_inputs(32, 4096, seed=7)
    w8 = _quantized(wo)
    calls = {"fused_qkv_rope_int8": lambda: KL.fused_qkv_rope_int8_cuda(*qargs, **kw),
             "fused_attn_out_residual_int8": lambda: KL.fused_attn_out_residual_int8_cuda(
                 attn, w8, xo)}
    for name, call in calls.items():
        call()  # build and load first
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        first = call()
        torch.cuda.synchronize()
        outs = first if isinstance(first, tuple) else (first,)
        sizes = [t.numel() * t.element_size() for t in outs]
        assert torch.cuda.max_memory_allocated() - before == sum(-(-n // 512) * 512 for n in sizes)
        again = [call() for _ in range(2)]
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert counts[name] == 3 and sum(counts.values()) == 3, counts
        for o in again:
            o = o if isinstance(o, tuple) else (o,)
            assert all(torch.equal(a, b) for a, b in zip(outs, o))


@pytest.mark.cuda
def test_zero_size_calls_launch_nothing_and_count_nothing_on_card():
    """Calls with nothing to compute (B = 0 or S = 0 attention, M = 0
    heads), in both modes, return empty outputs of the right shape without a
    launch, so every counter stays at 0."""
    _need_card()
    q, kc, vc, tables, ctx = _decode_case([17, 40], 4, 128, 16, 8, seed=3)
    (kq, ks), (vq, vs) = _int8_pages(kc, 4), _int8_pages(kc, 5)
    qv, _, _, vtables, pos = _verify_case([3, 20], 4, 4, 128, 16, 8, seed=3)
    x_args, kw = _qkv_inputs(8, 1024, 16, 2, 64, False, seed=3)
    x, norm, wq, wk, wv, cos, sin = x_args
    w8 = [_quantized(w) for w in (wq, wk, wv)]
    attn, wo, xo = _out_proj_inputs(8, 1024, seed=3)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    outs = [
        K.paged_decode_attention_cuda(q[:0], kc, vc, tables[:0], ctx[:0]),
        K.paged_decode_attention_int8_cuda(q[:0], kq, vq, tables[:0], ctx[:0], ks, vs),
        K.paged_verify_attention_cuda(qv[:0], kc, vc, vtables[:0], pos[:0]),
        K.paged_verify_attention_cuda(qv[:, :0], kc, vc, vtables, pos[:, :0]),
        K.paged_verify_attention_int8_cuda(qv[:0], kq, vq, vtables[:0], pos[:0], ks, vs),
        K.paged_verify_attention_int8_cuda(qv[:, :0], kq, vq, vtables, pos[:, :0], ks, vs),
        *KL.fused_qkv_rope_cuda(x[:0], norm, wq, wk, wv, cos[:0], sin[:0], **kw),
        *KL.fused_qkv_rope_int8_cuda(x[:0], norm, *w8, cos[:0], sin[:0], **kw),
        KL.fused_attn_out_residual_cuda(attn[:0], wo, xo[:0]),
        KL.fused_attn_out_residual_int8_cuda(attn[:0], _quantized(wo), xo[:0]),
    ]
    torch.cuda.synchronize()
    assert all(o.numel() == 0 for o in outs)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


@pytest.mark.cuda
def test_int8_linear_on_card_equals_its_f32_product():
    """The unfused int8 product on the card (bf16 x bf16 -> f32 cuBLAS, then
    the scale in f32, then the cast) equals the same values' f32 product up
    to the f32 summation order: at most one bf16 rounding apart."""
    _need_card()
    g = torch.Generator().manual_seed(8)
    x = torch.randn(8, 4096, generator=g).bfloat16().cuda()
    w8 = _quantized((0.02 * torch.randn(4096, 1024, generator=g)).bfloat16().cuda())
    got = L.linear(x, w8).float()
    want = ((x.float() @ w8["q"].float()) * w8["s"].float()).bfloat16().float()
    torch.cuda.synchronize()
    assert ((got - want).abs() <= 2.0 ** -7 * want.abs() + 1e-6).all()


# ---------------------------- packed and chunked prefill ops, the reader, on the card

ADMIT_KW = {"full": {}, "window": {"window": 100}, "softcap": {"scale": 0.1, "logit_softcap": 4.0}}


@pytest.mark.cuda
@pytest.mark.parametrize("kw", sorted(ADMIT_KW))
def test_packed_and_chunked_prefill_ops_on_card_equal_the_cpu(kw):
    """The two ops are torch ops on both devices (the JAX package's are XLA
    ops, not kernels): on the card, in f32 at Llama-3.1-8B heads, they give
    what the same code gives on the CPU, up to the f32 summation order."""
    _need_card()
    g = torch.Generator().manual_seed(11)
    P, Hq, Hkv, D, bs, nb = 512, 32, 8, 128, 16, 300
    q = torch.randn(P, Hq, D, generator=g)
    k = torch.randn(P, Hkv, D, generator=g)
    v = torch.randn(P, Hkv, D, generator=g)
    seg = torch.full((P,), -1, dtype=torch.int64)
    seg[:16], seg[16:116], seg[116:416] = 0, 1, 2
    want = A.packed_prefill_attention(q, k, v, seg, **ADMIT_KW[kw])
    got = A.packed_prefill_attention(q.cuda(), k.cuda(), v.cuda(), seg.cuda(), **ADMIT_KW[kw])
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    kc = torch.randn(Hkv, nb, bs, D, generator=g)
    vc = torch.randn(Hkv, nb, bs, D, generator=g)
    table = torch.zeros(256, dtype=torch.int64)
    table[:128] = torch.randperm(nb - 1, generator=g)[:128] + 1
    for start in (0, 1536):
        want = A.chunked_prefill_attention(q, kc, vc, table, start, **ADMIT_KW[kw])
        got = A.chunked_prefill_attention(q.cuda(), kc.cuda(), vc.cuda(), table.cuda(), start,
                                          **ADMIT_KW[kw])
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_write_chunk_kv_on_card_equals_the_cpu():
    _need_card()
    g = torch.Generator().manual_seed(12)
    kc = torch.randn(8, 64, 16, 128, generator=g)
    new = torch.randn(512, 8, 128, generator=g)
    table = torch.randperm(63, generator=g)[:40] + 1  # the final chunk runs past it
    want, got = kc.clone(), kc.cuda()
    A.write_chunk_kv(want, want.clone(), new, new, table, 512)
    A.write_chunk_kv(got, got.clone(), new.cuda(), new.cuda(), table.cuda(), 512)
    # the tail's 24 blocks all land in null block 0, in no set order
    assert torch.equal(got.cpu()[:, 1:], want[:, 1:])
    assert not torch.equal(want[:, 1:], kc[:, 1:])


@pytest.mark.cuda
def test_checkpoint_reader_uploads_and_transposes_on_card(tmp_path):
    """A bf16 checkpoint written in the safetensors layout by hand (the
    card's machine has no safetensors package) loads onto the card with its
    projections transposed there, bit for bit."""
    import json
    import struct

    from dynamo_tpu_torch.engine.torch_engine.weights import load_hf_safetensors
    from dynamo_tpu_torch.models.llama import LlamaConfig

    _need_card()
    cfg = dataclasses.replace(LlamaConfig.tiny(vocab_size=64), num_layers=1)
    g = torch.Generator().manual_seed(13)
    H, I = cfg.hidden_size, cfg.intermediate_size
    shapes = {"model.embed_tokens.weight": (64, H), "model.norm.weight": (H,),
              "lm_head.weight": (64, H)}
    p = "model.layers.0."
    shapes.update({p + "input_layernorm.weight": (H,), p + "post_attention_layernorm.weight": (H,),
                   p + "self_attn.q_proj.weight": (cfg.q_dim, H),
                   p + "self_attn.k_proj.weight": (cfg.kv_dim, H),
                   p + "self_attn.v_proj.weight": (cfg.kv_dim, H),
                   p + "self_attn.o_proj.weight": (H, cfg.q_dim),
                   p + "mlp.gate_proj.weight": (I, H), p + "mlp.up_proj.weight": (I, H),
                   p + "mlp.down_proj.weight": (H, I)})
    tensors = {n: torch.randn(s, generator=g).to(torch.bfloat16) for n, s in shapes.items()}
    header, off, blobs = {}, 0, []
    for n, t in tensors.items():
        b = t.view(torch.int16).numpy().tobytes()
        header[n] = {"dtype": "BF16", "shape": list(t.shape), "data_offsets": [off, off + len(b)]}
        off += len(b)
        blobs.append(b)
    head = json.dumps(header).encode()
    with open(tmp_path / "model.safetensors", "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))
    params = load_hf_safetensors(str(tmp_path), cfg, device="cuda")
    assert params["layers"][0]["wq"].is_cuda
    assert torch.equal(params["layers"][0]["wq"].cpu(), tensors[p + "self_attn.q_proj.weight"].t())
    assert torch.equal(params["layers"][0]["wd"].cpu(), tensors[p + "mlp.down_proj.weight"].t())
    assert torch.equal(params["lm_head"].cpu(), tensors["lm_head.weight"].t())
    assert torch.equal(params["embed"].cpu(), tensors["model.embed_tokens.weight"])
    assert params["layers"][0]["wq"].is_contiguous()


# ------------------------------------- no host read in the decode / verify step

HOST_READS = {"item", "tolist", "cpu", "numpy", "synchronize"}


def _host_reads(tree: ast.Module, entry: str, *imported: ast.Module) -> list[str]:
    """Calls of HOST_READS methods in `entry` and in every function of the
    module (or of the modules it imports helpers from) it reaches by name."""
    funcs = {n.name: n for t in (*imported, tree) for n in t.body if isinstance(n, ast.FunctionDef)}
    seen, todo, found = set(), [entry], []
    while todo:
        name = todo.pop()
        if name in seen or name not in funcs:
            continue
        seen.add(name)
        for node in ast.walk(funcs[name]):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in HOST_READS:
                found.append(f"{name}: .{f.attr}()")
            elif isinstance(f, ast.Name):
                todo.append(f.id)
    return found


@pytest.mark.parametrize("wrapper", ["paged_decode_attention_cuda", "paged_verify_attention_cuda",
                                     "paged_decode_attention_int8_cuda",
                                     "paged_verify_attention_int8_cuda"])
def test_paged_wrappers_read_nothing_back_from_the_card(wrapper):
    """The decode and verify steps stay capturable by a CUDA graph: the
    wrappers (and the module's helpers they call) never read a tensor on the
    host or synchronise."""
    src = (ROOT / "dynamo_tpu_torch" / "ops" / "cuda_attention.py").read_text()
    tree = ast.parse(src)
    assert wrapper in {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert _host_reads(tree, wrapper) == []


@pytest.mark.parametrize("wrapper", ["fused_qkv_rope_cuda", "fused_attn_out_residual_cuda",
                                     "fused_qkv_rope_int8_cuda",
                                     "fused_attn_out_residual_int8_cuda"])
def test_linear_wrappers_read_nothing_back_from_the_card(wrapper):
    """The fused heads too: their wrappers (and the helpers they import from
    ops/cuda_attention.py) never read a tensor on the host or synchronise."""
    ops = ROOT / "dynamo_tpu_torch" / "ops"
    tree = ast.parse((ops / "cuda_linear.py").read_text())
    helpers = ast.parse((ops / "cuda_attention.py").read_text())
    assert wrapper in {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert _host_reads(tree, wrapper, helpers) == []


# the modules the admission path's runner methods reach
RUNNER_PATH_MODULES = (
    "engine/torch_engine/model_runner.py", "models/llama.py", "ops/attention.py",
    "ops/sampling.py", "ops/layers.py", "ops/basics.py", "ops/linear.py",
    "ops/cuda_attention.py", "ops/cuda_linear.py", "ops/kv_quant.py",
)


def _host_reads_from(trees: list, entry: str, reads=HOST_READS) -> list[str]:
    """Like ``_host_reads``, over methods too: calls by bare name and by
    attribute (``self.decode``, ``llama.prefill_chunk``) are followed into
    every function or method of that name in ``trees``."""
    funcs: dict = {}
    for t in trees:
        for n in ast.walk(t):
            if isinstance(n, ast.FunctionDef):
                funcs.setdefault(n.name, []).append(n)
    seen, todo, found = set(), [entry], []
    while todo:
        name = todo.pop()
        if name in seen or name not in funcs:
            continue
        seen.add(name)
        for fn in funcs[name]:
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr in reads:
                    found.append(f"{name}: .{f.attr}()")
                elif isinstance(f, ast.Attribute):
                    todo.append(f.attr)
                elif isinstance(f, ast.Name):
                    todo.append(f.id)
    return found


@pytest.mark.parametrize("method", ["prefill_chunk", "prefill_packed_arrays", "mixed_step"])
def test_admission_runner_methods_read_nothing_back_from_the_card(method):
    """The chunked, packed and mixed calls read nothing back: the host
    already has every length, so no call waits for the card (and a later
    CUDA graph could capture them); the engine reads a sample only with
    ``fetch_sample``."""
    trees = [ast.parse((ROOT / "dynamo_tpu_torch" / m).read_text()) for m in RUNNER_PATH_MODULES]
    runner_methods = {n.name for n in ast.walk(trees[0]) if isinstance(n, ast.FunctionDef)}
    assert method in runner_methods
    assert _host_reads_from(trees, method) == []
    # the scan does reach a read where there is one
    assert _host_reads_from(trees, "fetch_sample") != []


# calls whose result size depends on the data: the card would be read back
DATA_SIZED = {"unique", "nonzero", "unique_consecutive", "masked_select", "argwhere"}


@pytest.mark.parametrize("entry", ["write_tokens_quant", "write_blocks_quant", "linear",
                                   "write_decode_kv", "write_prefill_kv",
                                   "chunked_prefill_attention", "fused_qkv_rope",
                                   "fused_attn_out_residual"])
def test_int8_paths_read_nothing_back_from_the_card(entry):
    """The int8 cache's writes (duplicate-safe through scatter_reduce, with
    no unique or nonzero) and the int8 products read nothing back, so the
    mixed and packed paths stay free of host reads with an int8 cache and
    int8 weights."""
    trees = [ast.parse((ROOT / "dynamo_tpu_torch" / m).read_text()) for m in RUNNER_PATH_MODULES]
    assert _host_reads_from(trees, entry, HOST_READS | DATA_SIZED) == []
    bad = ast.parse("def w(x):\n    return x[x.nonzero()]\n")
    assert _host_reads_from([bad], "w", HOST_READS | DATA_SIZED) == ["w: .nonzero()"]


def test_host_read_scan_finds_a_read_in_a_helper():
    tree = ast.parse("def w(x):\n    return h(x)\n\ndef h(x):\n    return int(x.max().item())\n")
    assert _host_reads(tree, "w") == ["h: .item()"]


def test_host_read_scan_follows_imported_helpers():
    tree = ast.parse("def w(x):\n    return h(x)\n")
    helpers = ast.parse("def h(x):\n    return x.cpu()\n")
    assert _host_reads(tree, "w") == []
    assert _host_reads(tree, "w", helpers) == ["h: .cpu()"]


# --------------------------------------- shapes the card's kernels refuse

def test_build_torch_engine_refuses_shapes_the_kernels_do_not_take():
    """A head dim no kernel is built for raises at build time, naming the
    refusal, before any request and before the card is looked for -- not at
    the first prefill, and never by falling back to a plain version."""
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.models.llama import LlamaConfig

    cfg = dataclasses.replace(LlamaConfig.tiny(vocab_size=64), head_dim=96)
    with pytest.raises(ValueError, match="head_dim 96 is not one of"):
        build_torch_engine(cfg, device="cuda", fused_decode=False)
    with pytest.raises(ValueError, match="fused QKV head: head_dim 96"):
        build_torch_engine(cfg, device="cuda", fused_decode=True)


# Qwen2-7B, Qwen2-1.5B, Gemma-2B and Gemma-2-9B heads, cut to one layer
CARD_SHAPES = {
    "qwen2_7b": dict(hidden_size=3584, num_heads=28, num_kv_heads=4, head_dim=128, attn_bias=True),
    "qwen2_1p5b": dict(hidden_size=1536, num_heads=12, num_kv_heads=2, head_dim=128,
                       attn_bias=True),
    "gemma_2b": dict(hidden_size=2048, num_heads=8, num_kv_heads=1, head_dim=256),
    "gemma2_9b": dict(hidden_size=3584, num_heads=16, num_kv_heads=8, head_dim=256),
}


@pytest.mark.parametrize("name", sorted(CARD_SHAPES))
def test_card_kernels_take_the_qwen2_and_gemma_head_shapes(name):
    from dynamo_tpu_torch.models.llama import LlamaConfig

    cfg = dataclasses.replace(LlamaConfig.tiny(vocab_size=64), **CARD_SHAPES[name])
    assert kernels.card_shape_problems(cfg, fused_decode=True) == []


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_SHAPES))
def test_build_torch_engine_serves_qwen2_and_gemma_head_shapes_on_card(name):
    """One layer of each model's heads through the engine on the card, fused
    heads and spec decode on: prefill (#3), verify (#2), the fused heads
    (#4, #5) and decode (#1) all launch at these shapes."""
    import asyncio

    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.models.llama import LlamaConfig
    from dynamo_tpu_torch.protocols import common as tp

    _need_card()
    cfg = dataclasses.replace(LlamaConfig.tiny(vocab_size=512), num_layers=1,
                              intermediate_size=512, **CARD_SHAPES[name])
    engine = build_torch_engine(cfg, device="cuda", max_batch=2, max_model_len=256,
                                fused_decode=True, spec_k=3, spec_min_coverage=0.01,
                                prefill_chunk_tokens=0)
    prompt = [int(t) for t in np.random.default_rng(0).integers(0, 512, 40)] * 2
    req = tp.PreprocessedRequest(token_ids=prompt, sampling=tp.SamplingOptions(greedy=True),
                                 stop=tp.StopConditions(max_tokens=24), eos_token_ids=[])

    async def run():
        toks = []
        try:
            kernels.reset_launch_counts()
            async for out in engine.generate(req, tp.Context()):
                assert out.error is None
                toks.extend(out.token_ids)
        finally:
            await engine.close()
        return toks

    toks = asyncio.run(run())
    assert len(toks) == 24 and all(0 <= t < 512 for t in toks)
    launched = kernels.launch_counts()
    assert launched["flash_prefill_attention"] == 1
    assert launched["fused_qkv_rope"] == launched["fused_attn_out_residual"] > 0


# a hand-written WordLevel tokenizer.json: 512 ids, each of which but the
# special </s> decodes to a word
def _word_level_json(n: int = 512) -> str:
    import json

    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2, **{f"w{i}": i for i in range(3, n)}}
    return json.dumps({
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": [
            {"id": 2, "content": "</s>", "single_word": False, "lstrip": False, "rstrip": False,
             "normalized": False, "special": True}],
        "normalizer": None, "pre_tokenizer": {"type": "Whitespace"}, "post_processor": None,
        "decoder": None, "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"},
    })


@pytest.mark.cuda
def test_http_server_streams_a_completion_from_a_card_engine():
    """The port's server in-process over a one-layer engine on the card:
    one streamed completion, read with http.client, ends in [DONE] with a
    finish reason and usage that counts the streamed tokens."""
    import asyncio
    import http.client
    import json

    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.entrypoint.inputs import EngineConfig, run_http
    from dynamo_tpu_torch.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.models.llama import LlamaConfig
    from dynamo_tpu_torch.protocols.sse import SseParser
    from dynamo_tpu_torch.tokenizer import TokenizerWrapper

    _need_card()
    cfg = dataclasses.replace(LlamaConfig.tiny(vocab_size=512), num_layers=1, intermediate_size=512,
                              hidden_size=512, num_heads=4, num_kv_heads=1, head_dim=128)
    engine = build_torch_engine(cfg, device="cuda", max_batch=2, max_model_len=256)
    mdc = ModelDeploymentCard.from_tokenizer(
        "card-tiny", TokenizerWrapper.from_json_str(_word_level_json(), eos_token_ids=[2]))
    body = {"model": "card-tiny", "prompt": " ".join(f"w{i}" for i in range(3, 40)), "max_tokens": 12,
            "stream": True, "temperature": 0, "stream_options": {"include_usage": True}}

    def fetch(port):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            conn.request("POST", "/v1/completions", body=json.dumps(body),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    async def run():
        svc = await run_http(EngineConfig.static_(engine, mdc), host="127.0.0.1", port=0)
        try:
            kernels.reset_launch_counts()
            return await asyncio.to_thread(fetch, svc.port)
        finally:
            await svc.close()
            await engine.close()

    status, data = asyncio.run(run())
    assert status == 200
    events = SseParser().feed(data.decode())
    assert events[-1].is_done()
    chunks = [e.json() for e in events[:-1]]
    texts = [c["choices"][0]["text"] for c in chunks if c["choices"] and c["choices"][0]["text"]]
    finishes = [c["choices"][0].get("finish_reason") for c in chunks if c["choices"]]
    assert finishes[-1] in ("length", "stop") and not any(finishes[:-1])
    usage = chunks[-1]["usage"]
    assert usage["prompt_tokens"] == 37 and 0 < usage["completion_tokens"] <= 12
    assert len(texts) == usage["completion_tokens"]
    assert kernels.launch_counts()["paged_decode_attention"] > 0


# ------------------------------------------- tensor parallelism (#5 partial)


def test_partial_out_wrappers_refuse_cpu_tensors_and_cpu_takes_the_plain_version():
    """#5's partial_out wrappers take CUDA tensors only; on CPU tensors
    fused_attn_out_residual(partial_out=True) runs the plain version and
    counts nothing."""
    attn = torch.zeros(2, 256, dtype=torch.bfloat16)
    w = torch.zeros(256, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        KL.fused_attn_out_partial_cuda(attn, w)
    with pytest.raises(ValueError):
        KL.fused_attn_out_partial_int8_cuda(attn, w.to(torch.int8))
    kernels.reset_launch_counts()
    x = torch.randn(4, 64)
    wf = torch.randn(64, 128)
    for ww in (wf, wf[:, 64:], L.quantize_int8(wf), L.quantize_int8(wf)["q"][:, :64]):
        got = L.fused_attn_out_residual(x, ww, partial_out=True)
        m = ww["q"] if isinstance(ww, dict) else ww
        torch.testing.assert_close(got, x @ m.float(), rtol=1e-6, atol=1e-6)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


# per-rank shapes (K, N, row stride, first column): Llama-3.1-8B tp=2's
# o-proj shard, one ring chunk of it (strided), Llama-3.1-70B tp=8's
PARTIAL_SHAPES = {"8b_tp2": (2048, 4096, 4096, 0), "8b_tp2_chunk1": (2048, 2048, 4096, 2048),
                  "8b_tp2_chunk0": (2048, 2048, 4096, 0), "70b_tp8": (1024, 8192, 8192, 0)}
# the raw f32 partial: only the split-K summation order differs
PARTIAL_TOL = (1e-3, 2.0 ** -10)


def _partial_case(M, K, N, ldw, col, seed):
    g = torch.Generator().manual_seed(seed)
    attn = torch.randn(M, K, generator=g).bfloat16().cuda()
    full = (torch.randn(K, ldw, generator=g) / K ** 0.5).bfloat16().cuda()
    return attn, full[:, col:col + N], _quantized(full)["q"][:, col:col + N]


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 8, 32, 70])
@pytest.mark.parametrize("shape", sorted(PARTIAL_SHAPES))
def test_partial_out_kernel_matches_plain_on_card(shape, M):
    """5p (bf16) and 5pq (int8 mantissas, widened, never scaled) against
    the plain version, over whole shards and strided column chunks; each
    call is one launch, counted on its own mode."""
    _need_card()
    attn, w, q8 = _partial_case(M, *PARTIAL_SHAPES[shape], seed=M)
    kernels.reset_launch_counts()
    got = L.fused_attn_out_residual(attn, w, partial_out=True)
    got8 = L.fused_attn_out_residual(attn, {"q": q8, "s": torch.ones(q8.shape[1]).bfloat16().cuda()},
                                     partial_out=True)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["fused_attn_out_partial"] == 1 and counts["fused_attn_out_partial_int8"] == 1
    assert sum(counts.values()) == 2
    for out, ww in ((got, w), (got8, q8)):
        assert out.dtype == torch.float32 and tuple(out.shape) == (M, w.shape[1])
        _close(out, L.fused_attn_out_partial_plain(attn, ww), PARTIAL_TOL)


@pytest.mark.cuda
def test_partial_out_zero_rows_launch_nothing_and_count_nothing_on_card():
    _need_card()
    attn, w, q8 = _partial_case(8, *PARTIAL_SHAPES["8b_tp2_chunk1"], seed=5)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    outs = [KL.fused_attn_out_partial_cuda(attn[:0], w),
            KL.fused_attn_out_partial_int8_cuda(attn[:0], q8)]
    torch.cuda.synchronize()
    assert all(tuple(o.shape) == (0, w.shape[1]) for o in outs)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


def _group_ops(group):
    """all_reduce, the tiled all_gather and both ring hops of each rank's
    own values, read back to the host."""
    r = group.rank
    x = (torch.arange(12, dtype=torch.float32).reshape(3, 4) + 100 * r).to(group.device)
    return [group.all_reduce(x.clone()).cpu(), group.all_gather(x, dim=1).cpu(),
            group.ppermute(x, shift=-1).cpu(), group.ppermute(x, shift=1).cpu(),
            group.broadcast(x.clone(), src=1).cpu()]


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_give_the_cpu_groups_collectives():
    """Two ranks on cuda:0 over gloo (the ring hop staged through host
    memory) give what two CPU ranks give."""
    _need_card()
    from dynamo_tpu_torch.parallel.launch import run_ranks

    card = run_ranks(2, _group_ops, [(), ()], backend="gloo", devices=["cuda:0", "cuda:0"],
                     threads=0, timeout_s=120)
    cpu = run_ranks(2, _group_ops, [(), ()], backend="gloo", devices="cpu", timeout_s=120)
    for c, h in zip(card, cpu):
        for a, b in zip(c, h):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(card[0][2], card[0][3])  # 2 ranks: both hops bring rank 1's


# ------------------------------------------------- CUDA graphs on the card

# two layers with Llama-3.1-8B's head shape (D 128, a GQA group of 4) at a
# width every kernel takes
GRAPH_CFG = dict(hidden_size=1024, intermediate_size=2048, num_layers=2, num_heads=8,
                 num_kv_heads=2, head_dim=128)
GRAPH_LENS = [5, 17, 33, 64, 100, 130, 200, 250]
GRAPH_B, GRAPH_BS, GRAPH_LEN, GRAPH_VOCAB = 8, 16, 512, 2048


def _graph_runner(kv: str, fused: bool, **over):
    """A card runner whose 8 lanes hold prompts of GRAPH_LENS tokens, with
    blocks for 16 more each (``over``: config fields to change); returns
    (runner, tables, last tokens)."""
    from dynamo_tpu_torch.engine.torch_engine.model_runner import TorchModelRunner
    from dynamo_tpu_torch.engine.torch_engine.weights import load_or_init_params
    from dynamo_tpu_torch.models.llama import LlamaConfig

    cfg = dataclasses.replace(LlamaConfig.tiny(vocab_size=GRAPH_VOCAB), **GRAPH_CFG, **over)
    assert kernels.card_shape_problems(cfg, fused_decode=fused) == []
    params = load_or_init_params(None, cfg, seed=0, device="cuda", quantize=kv == "int8")
    runner = TorchModelRunner(cfg, params, num_blocks=256, block_size=GRAPH_BS,
                              max_batch=GRAPH_B, max_model_len=GRAPH_LEN, device="cuda",
                              fused_decode=fused, kv_dtype=kv, prefill_chunk_tokens=0)
    assert runner.cuda_graphs
    rng = np.random.default_rng(0)
    tables = np.zeros((GRAPH_B, GRAPH_LEN // GRAPH_BS), np.int32)
    nxt = 1
    for b, n in enumerate(GRAPH_LENS):
        used = -(-(n + 16) // GRAPH_BS)
        tables[b, :used] = np.arange(nxt, nxt + used)
        nxt += used
        runner.prefill(rng.integers(0, GRAPH_VOCAB, n).tolist(), list(tables[b, :used]),
                       0.0, 1.0, 0)
    return runner, tables, rng.integers(0, GRAPH_VOCAB, GRAPH_B)


def _cache_leaves(runner):
    return [t for c in (runner.k_cache, runner.v_cache)
            for t in (c.values() if isinstance(c, dict) else (c,))]


def _graph_calls(runner, tables, last, sampled: bool):
    """Every graph key of the three kinds: (name, call) pairs, each call
    returning its samples as one host array."""
    B = GRAPH_B
    pos = np.array(GRAPH_LENS, np.int64)
    temps = np.full(B, 0.8 if sampled else 0.0, np.float32)
    temps[::2] = 0.0  # greedy and sampled lanes side by side
    top_ps, top_ks = np.full(B, 0.95, np.float32), np.full(B, 40, np.int64)
    keys = np.stack([np.arange(B) + 7, np.arange(B) * 3], 1).astype(np.int64)
    slots = tables[np.arange(B), pos // GRAPH_BS].astype(np.int64) * GRAPH_BS + pos % GRAPH_BS
    eos = np.full((B, 4), -1, np.int64)
    eos[:, 0] = 11
    sup = np.arange(B) % 3 == 0
    hist = np.zeros((B, GRAPH_LEN), np.int64)
    hist[:, :4] = [1, 2, 3, 2]
    pen = (hist, np.full(B, 4), np.full(B, 2), np.full(B, 0.5, np.float32),
           np.full(B, 0.3, np.float32), np.full(B, 1.2, np.float32))
    active = np.arange(B) != 5
    limit = np.array([4, 1, 2, 3, 4, 4, 4, 2], np.int64)
    min_rem = np.where(sup, 2, 0).astype(np.int64)
    no_min = np.zeros(B, np.int64)
    drafts = np.random.default_rng(1).integers(0, GRAPH_VOCAB, (B, 3)).astype(np.int64)
    dlen = np.array([3, 0, 1, 2, 3, 3, 0, 1], np.int64)
    vlimit = np.full(B, 8, np.int64)
    d = (last, pos, tables, slots, temps, top_ps, top_ks)
    m = (last, pos, tables, temps, top_ps, top_ks, keys, active)
    v = (last, drafts, dlen, pos, tables, temps, top_ps, top_ks, keys, active, vlimit)

    def fetch(out):
        return np.concatenate([a.reshape(-1) for a in runner.fetch_sample(out)])

    return [
        ("decode", lambda: fetch(runner.decode(*d, keys=keys))),
        ("decode/eos", lambda: fetch(runner.decode(*d, keys=keys, eos_mask=(eos, sup)))),
        ("decode/pen", lambda: fetch(runner.decode(*d, keys=keys, penalties=(*pen, eos, sup)))),
        ("decode_multi", lambda: runner.decode_multi(4, *m, limit, no_min, eos).cpu().numpy()),
        ("decode_multi/eos", lambda: runner.decode_multi(4, *m, limit, min_rem, eos).cpu().numpy()),
        ("decode_multi/pen", lambda: runner.decode_multi(
            4, *m, limit, min_rem, eos, penalties=pen).cpu().numpy()),
        ("verify", lambda: runner.spec_verify(3, 3, *v, no_min, eos).cpu().numpy()),
        ("verify/eos", lambda: runner.spec_verify(3, 3, *v, min_rem, eos).cpu().numpy()),
        ("verify/pen", lambda: runner.spec_verify(
            3, 0, *v, min_rem, eos, penalties=pen).cpu().numpy()),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_graph_replays_equal_eager_calls_bitwise_on_card(kv, fused):
    """Every graph key (decode, decode_multi H 4 and verify S 4 with E 3,
    each plain, EOS-masked and with penalties, all-greedy and sampled)
    replayed against the same call made eagerly on the same cache contents:
    bitwise equal, in both cache forms (int8 weights with the int8 cache)."""
    _need_card()
    runner, tables, last = _graph_runner(kv, fused)
    snap = [t.clone() for t in _cache_leaves(runner)]
    for sampled in (False, True):
        for name, call in _graph_calls(runner, tables, last, sampled):
            out = {}
            for graphed in (False, True):
                runner.cuda_graphs = graphed
                out[graphed] = call()
                for t, s in zip(_cache_leaves(runner), snap):
                    t.copy_(s)
            assert np.array_equal(out[False], out[True], equal_nan=True), (name, sampled)
            assert (out[True] != 0).any(), name
    runner.cuda_graphs = True
    assert len(runner.graph_stats()) == 18


@pytest.mark.cuda
def test_graph_launch_counts_are_replays_times_captured_launches_on_card():
    """A capture counts no launch; each replay adds the launches its capture
    recorded: #1 once per layer and step body (frozen steps included), #2
    once per layer and verify pass, the fused heads once per layer and
    body."""
    _need_card()
    runner, tables, last = _graph_runner("bf16", True)
    calls = dict(_graph_calls(runner, tables, last, False))
    L = GRAPH_CFG["num_layers"]
    kernels.reset_launch_counts()
    for _ in range(3):
        calls["decode_multi"]()
        calls["verify"]()
    stats = runner.graph_stats()
    (multi,) = [s for k, s in stats.items() if k.startswith("decode_multi")]
    (verify,) = [s for k, s in stats.items() if k.startswith("verify")]
    assert multi["replays"] == verify["replays"] == 3 and runner.graph_replays == 6
    assert multi["launches"] == {"paged_decode_attention": 4 * L, "fused_qkv_rope": 4 * L,
                                 "fused_attn_out_residual": 4 * L}
    assert verify["launches"] == {"paged_verify_attention": L, "paged_decode_attention": 3 * L,
                                  "fused_qkv_rope": 4 * L, "fused_attn_out_residual": 4 * L}
    want = dict.fromkeys(kernels.KERNELS, 0)
    for s in (multi, verify):
        for k, n in s["launches"].items():
            want[k] += 3 * n
    assert kernels.launch_counts() == want


# ------------------------------------------- the KV block plane on the card

@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_an_inject_lands_in_place_under_a_captured_decode_graph_on_card(kv):
    """Disaggregated prefill lands KV in a cache the decode graphs recorded:
    the inject must write where the graph reads. Every cache tensor keeps
    its address, and the replay after an inject into lane 0's blocks equals
    the eager step on the same cache, bitwise, and differs from the replay
    before it."""
    _need_card()
    runner, tables, last = _graph_runner(kv, False)
    decode = dict(_graph_calls(runner, tables, last, False))["decode"]
    ptrs = [t.data_ptr() for t in _cache_leaves(runner)]
    snap = [t.clone() for t in _cache_leaves(runner)]
    before = decode()  # captured here, then replayed below
    ids = [int(b) for b in tables[0, :-(-GRAPH_LENS[0] // GRAPH_BS)]]
    k, v, n = runner.extract_blocks_device([int(b) for b in tables[7, :len(ids)]])
    for t, s in zip(_cache_leaves(runner), snap):
        t.copy_(s)
    runner.inject_blocks_device(ids, k, v)
    landed = [t.clone() for t in _cache_leaves(runner)]
    graphed = decode()
    for t, s in zip(_cache_leaves(runner), landed):
        t.copy_(s)
    runner.cuda_graphs = False
    eager = decode()
    runner.cuda_graphs = True
    assert [t.data_ptr() for t in _cache_leaves(runner)] == ptrs
    assert runner.graph_replays >= 1
    assert np.array_equal(graphed, eager, equal_nan=True)
    assert not np.array_equal(graphed, before, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_blocks_move_between_two_runners_on_one_card(kv):
    """A prefill on runner A, its blocks moved into other blocks of runner
    B on the same card: bitwise through the device path (bf16) and the
    verbatim int8 pair; an int8 cache's device path (dequantized to bf16,
    quantized again on landing) within one quantization step of each
    block."""
    _need_card()
    a, tables, _ = _graph_runner(kv, False)
    b = _runner_like(a)
    src = [int(x) for x in tables[6, :8]]
    dst = list(range(200, 208))
    k, v, n = a.extract_blocks_device(src)
    assert n == 8 and k.device == a.device and k.dtype == torch.bfloat16
    b.inject_blocks_device(dst, k, v)
    ka, kb = a.k_cache, b.k_cache
    if kv == "bf16":
        assert torch.equal(kb[:, :, dst], ka[:, :, src])
        assert torch.equal(b.v_cache[:, :, dst], a.v_cache[:, :, src])
        return
    from dynamo_tpu_torch.ops.kv_quant import dequantize

    want = dequantize(ka["q"][:, :, src], ka["s"][:, :, src])
    got = dequantize(kb["q"][:, :, dst], kb["s"][:, :, dst])
    step = ka["s"][:, :, src][..., None, None]
    assert ((got - want).abs() <= 1.01 * step + 1e-6).all()
    b.inject_blocks_quant(dst, *a.extract_blocks_quant(src))
    for part in ("q", "s"):
        assert torch.equal(kb[part][:, :, dst], ka[part][:, :, src])
        assert torch.equal(b.v_cache[part][:, :, dst], a.v_cache[part][:, :, src])


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_a_pinned_tier_round_trip_lands_in_place_under_a_captured_graph_on_card(kv):
    """The tiered block manager's card path: a graphed runner's pages
    (``extract_pages``) into a pinned host arena (``store_blocks_device``),
    back onto the card (``load_blocks_device``, in another order too) and
    into other blocks (``inject_pages``): every plane bitwise at every hop
    (an int8 cache's mantissas and scales verbatim into int8 tiers), the
    arena's numpy view holding the same bytes, the cache's addresses
    unchanged, and the decode graph's replay over the landed blocks equal
    to the eager step."""
    _need_card()
    from dynamo_tpu_torch.block_manager import LayoutConfig, TieredBlockManager

    runner, tables, last = _graph_runner(kv, False)
    decode = dict(_graph_calls(runner, tables, last, False))["decode"]
    ptrs = [t.data_ptr() for t in _cache_leaves(runner)]
    decode()  # captured here
    cfg = runner.config
    bm = TieredBlockManager(
        LayoutConfig(num_layers=cfg.num_layers, page_size=GRAPH_BS, num_kv_heads=cfg.num_kv_heads,
                     head_dim=cfg.head_dim, dtype="bfloat16"),
        host_blocks=32, pin_memory=True, wire_codec="int8" if kv == "int8" else "raw")
    assert bm.pinned
    src = [int(b) for b in tables[7, :9]]  # 250 tokens' first 9 blocks
    dst = [int(b) for b in tables[5, :9]]  # lane 5's 130 tokens' blocks
    pages = runner.extract_pages(src)
    hashes = list(range(1000, 1009))
    assert bm.store_blocks_device(hashes, *pages) == 9
    arenas = [bm._k_host, bm._v_host] + ([bm._k_scales_host, bm._v_scales_host]
                                          if kv == "int8" else [])
    for arena, page in zip(arenas, pages):
        assert page.device.type == "cuda"
        assert torch.equal(arena[:9], page.cpu().view(arena.dtype))
    back = bm.load_blocks_device(hashes[::-1], runner.device)
    for got, page in zip(back, pages):
        assert got.device == page.device and torch.equal(got.flip(0).view(torch.uint8),
                                                         page.view(torch.uint8))
    loaded = bm.load_blocks_device(hashes, runner.device)
    runner.inject_pages(dst, *loaded)
    for plane in runner._pages():
        assert torch.equal(plane[:, :, dst].view(torch.uint8), plane[:, :, src].view(torch.uint8))
    landed = [t.clone() for t in _cache_leaves(runner)]
    graphed = decode()
    for t, s in zip(_cache_leaves(runner), landed):
        t.copy_(s)
    runner.cuda_graphs = False
    eager = decode()
    runner.cuda_graphs = True
    assert [t.data_ptr() for t in _cache_leaves(runner)] == ptrs
    assert np.array_equal(graphed, eager, equal_nan=True)
    assert bm.stats.onboarded == 18 and bm.stats.integrity_failures == 0


def _runner_like(runner):
    """A second runner on the same card and weights, its cache empty."""
    from dynamo_tpu_torch.engine.torch_engine.model_runner import TorchModelRunner

    return TorchModelRunner(runner.config, runner.params, num_blocks=runner.num_blocks,
                            block_size=runner.block_size, max_batch=runner.max_batch,
                            max_model_len=runner.max_model_len, device=runner.device,
                            kv_dtype="int8" if runner.kv_quantized else "bf16",
                            prefill_chunk_tokens=0)


# ------------------------------------------------ the MoE layer's grouped FFN

# the fused heads' tolerance: f32 sums in another order, so a bf16 rounding
# of gate, up, the SwiGLU product or the output may flip by one ulp
GROUPED_TOL = (1e-2, 2.0 ** -6)
# rows per expert (E = 8): decode B = 1 and B = 8, verify B = 8 x S = 4, a
# 512-token chunk; every row on one expert; experts left empty at both ends
GROUPED_CASES = {
    "R2": [0, 1, 0, 0, 0, 1, 0, 0],
    "R16": [2, 3, 1, 0, 4, 2, 2, 2],
    "R64": [8, 12, 4, 9, 7, 8, 6, 10],
    "R1024": [130, 120, 140, 100, 134, 150, 110, 140],
    "one_expert": [0, 0, 0, 16, 0, 0, 0, 0],
    "empty_ends": [0, 0, 30, 1, 0, 33, 0, 0],
}


def _grouped_case(counts, D, F, seed):
    g = torch.Generator().manual_seed(seed)
    E = len(counts)
    R = sum(counts)
    xs = torch.randn(R, D, generator=g).bfloat16().cuda()
    wg, wu = ((torch.randn(E, D, F, generator=g) / D ** 0.5).bfloat16().cuda() for _ in range(2))
    wd = (torch.randn(E, F, D, generator=g) / F ** 0.5).bfloat16().cuda()
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32).cuda()
    return xs, offsets, wg, wu, wd


def test_grouped_ffn_wrapper_refuses_cpu_tensors_and_cpu_takes_the_plain_version():
    from dynamo_tpu_torch.ops import cuda_moe, moe

    xs = torch.zeros(4, 64, dtype=torch.bfloat16)
    w = torch.zeros(2, 64, 64, dtype=torch.bfloat16)
    off = torch.tensor([0, 1, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        cuda_moe.grouped_swiglu_ffn_cuda(xs, off, w, w, w)
    kernels.reset_launch_counts()
    x = torch.randn(6, 64)
    out = moe.moe_ffn_dropless(x, torch.randn(64, 4), *(torch.randn(4, 64, 64) for _ in range(3)),
                               top_k=2)
    assert out.shape == (6, 64) and torch.isfinite(out).all()
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


def test_the_dropless_moe_layer_reads_nothing_back_from_the_card():
    """Routing, the device-side expert order, the kernel's wrapper and the
    combine read nothing back (no host read, no data-sized result, no
    bincount): only the CPU branch's plain version reads its offsets."""
    ops = ROOT / "dynamo_tpu_torch" / "ops"
    trees = [ast.parse((ops / m).read_text()) for m in ("moe.py", "cuda_moe.py",
                                                         "cuda_attention.py", "basics.py")]
    found = _host_reads_from(trees, "moe_ffn_dropless", HOST_READS | DATA_SIZED | {"bincount"})
    assert found == ["grouped_ffn_plain: .tolist()"]


@pytest.mark.cuda
def test_the_grouped_ffn_library_is_built_on_card():
    """The sixth library: built by nvcc with the other five (one process per
    source), exporting its entry point."""
    _need_card()
    from dynamo_tpu_torch.ops import _build

    assert len(_build.SOURCES) == 6 and "grouped_swiglu_ffn" in _build.SOURCES
    info = _build.build_all()
    assert set(info) >= set(_build.SOURCES)
    assert hasattr(_build.load("grouped_swiglu_ffn"), "grouped_swiglu_ffn_bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GROUPED_CASES))
def test_grouped_ffn_kernel_matches_plain_on_card(case):
    """The kernel against grouped_ffn_plain (cuBLAS products over the host's
    row slices, SwiGLU on bf16) at the decode, verify and chunk row counts,
    with empty experts and with every row on one expert; one count per call."""
    _need_card()
    from dynamo_tpu_torch.ops import cuda_moe, moe

    xs, off, wg, wu, wd = _grouped_case(GROUPED_CASES[case], 1024, 2048, seed=len(case))
    kernels.reset_launch_counts()
    got = cuda_moe.grouped_swiglu_ffn_cuda(xs, off, wg, wu, wd)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == dict(dict.fromkeys(kernels.KERNELS, 0),
                                           grouped_swiglu_ffn=1)
    assert got.dtype == torch.bfloat16 and got.shape == xs.shape
    _close(got, moe.grouped_ffn_plain(xs, off, wg, wu, wd), GROUPED_TOL)


@pytest.mark.cuda
def test_grouped_ffn_kernel_at_mixtral_width_and_zero_rows_on_card():
    """Mixtral-8x7B's experts (D 4096, F 14336) at the B = 8 step's 16 rows;
    zero rows launch nothing and count nothing; refused shapes raise."""
    _need_card()
    from dynamo_tpu_torch.ops import cuda_moe, moe

    xs, off, wg, wu, wd = _grouped_case(GROUPED_CASES["R16"], 4096, 14336, seed=3)
    _close(cuda_moe.grouped_swiglu_ffn_cuda(xs, off, wg, wu, wd),
           moe.grouped_ffn_plain(xs, off, wg, wu, wd), GROUPED_TOL)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    empty = cuda_moe.grouped_swiglu_ffn_cuda(xs[:0], torch.zeros_like(off), wg, wu, wd)
    torch.cuda.synchronize()
    assert empty.shape == (0, 4096)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
    with pytest.raises(ValueError, match="not a multiple of 64"):
        cuda_moe.grouped_swiglu_ffn_cuda(xs[:, :4064].contiguous(), off, wg[:, :4064].contiguous(),
                                         wu[:, :4064].contiguous(), wd[:, :, :4064].contiguous())
    with pytest.raises(TypeError):
        cuda_moe.grouped_swiglu_ffn_cuda(xs.float(), off, wg, wu, wd)


@pytest.mark.cuda
def test_moe_dropless_layer_on_card_matches_an_f32_per_token_oracle():
    """moe_ffn_dropless at the B = 8 step's shape (Mixtral widths, random
    routing) against an f32 loop over tokens and their top-2 experts that
    rounds where the kernel rounds: within 2^-5 of each row's largest value
    (bf16 inputs, one bf16 rounding of gate, up, act and the output)."""
    _need_card()
    from dynamo_tpu_torch.ops import moe

    g = torch.Generator().manual_seed(9)
    T, D, F, E = 8, 4096, 14336, 8
    x = torch.randn(T, D, generator=g).bfloat16().cuda()
    rw = (torch.randn(D, E, generator=g) / D ** 0.5).bfloat16().cuda()
    xs, _, wg, wu, wd = _grouped_case([1] * E, D, F, seed=10)
    got = moe.moe_ffn_dropless(x, rw, wg, wu, wd, 2).float()
    logits = x.float() @ rw.float()
    want = torch.zeros(T, D, device="cuda")
    for t in range(T):
        top = torch.sort(logits[t], descending=True, stable=True)
        w = torch.softmax(top.values[:2], 0)
        for e, we in zip(top.indices[:2].tolist(), w):
            gate = (x[t].float() @ wg[e].float()).bfloat16().float()
            up = (x[t].float() @ wu[e].float()).bfloat16().float()
            act = (torch.nn.functional.silu(gate).bfloat16().float() * up).bfloat16().float()
            want[t] += we * (act @ wd[e].float()).bfloat16().float()
    err = (got - want).abs().amax(1)
    assert (err <= 2.0 ** -5 * want.abs().amax(1)).all(), err


@pytest.mark.cuda
def test_moe_graph_replays_equal_eager_calls_bitwise_on_card():
    """An MoE model's decode step, horizon and verify pass captured and
    replayed against the same call made eagerly on the same cache contents:
    bitwise equal (routing, the expert order and the combine run on the
    card with no host read); each replay counts the grouped kernel once per
    layer and step body."""
    _need_card()
    runner, tables, last = _graph_runner("bf16", False, num_experts=4)
    assert "router" in runner.params["layers"][0]
    snap = [t.clone() for t in _cache_leaves(runner)]
    for name, call in _graph_calls(runner, tables, last, True):
        out = {}
        for graphed in (False, True):
            runner.cuda_graphs = graphed
            out[graphed] = call()
            for t, s in zip(_cache_leaves(runner), snap):
                t.copy_(s)
        assert np.array_equal(out[False], out[True], equal_nan=True), name
    runner.cuda_graphs = True
    L = GRAPH_CFG["num_layers"]
    for key, s in runner.graph_stats().items():
        bodies = (s["launches"].get("paged_decode_attention", 0)
                  + s["launches"].get("paged_verify_attention", 0)) // L
        assert s["launches"]["grouped_swiglu_ffn"] == L * bodies, key


@pytest.mark.cuda
def test_an_moe_engine_serves_on_card_without_the_plain_grouped_ffn(monkeypatch):
    """build_torch_engine's defaults (H 4 on graphs, chunk 512, mixed steps)
    serve an MoE model with the plain grouped FFN patched to raise: every
    expert product went through the kernel."""
    _need_card()
    import asyncio

    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.ops import moe
    from dynamo_tpu_torch.protocols.common import (Context, PreprocessedRequest,
                                                   SamplingOptions, StopConditions)

    def refuse(*a, **k):
        raise AssertionError("the card path reached grouped_ffn_plain")

    monkeypatch.setattr(moe, "grouped_ffn_plain", refuse)
    from dynamo_tpu_torch.models.llama import LlamaConfig

    cfg = dataclasses.replace(LlamaConfig.tiny(vocab_size=GRAPH_VOCAB), num_experts=4,
                              **GRAPH_CFG)
    engine = build_torch_engine(cfg, device="cuda", max_batch=4, max_model_len=512)
    assert engine.runner.cuda_graphs and engine.config.decode_horizon == 4
    kernels.reset_launch_counts()

    async def go():
        try:
            out = []
            for n in (7, 40):
                req = PreprocessedRequest(token_ids=list(range(1, n + 1)),
                                          sampling=SamplingOptions(greedy=True),
                                          stop=StopConditions(max_tokens=9, ignore_eos=True))
                toks = []
                async for o in engine.generate(req, Context()):
                    toks.extend(o.token_ids)
                out.append(toks)
            return out
        finally:
            await engine.close()

    out = asyncio.run(go())
    assert [len(t) for t in out] == [9, 9]
    assert kernels.launch_counts()["grouped_swiglu_ffn"] > 0
