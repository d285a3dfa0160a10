#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (dynamo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:

  1. device  -- the card's name, count and power limit (nvidia-smi);
  2. build   -- every CUDA kernel of the serving path, built from
                dynamo_tpu_torch/csrc/ with nvcc for sm_90a, all at once;
  3. parity  -- each kernel against its plain PyTorch version on the card,
                at Llama-3.1-8B shapes (Hq 32, Hkv 8, D 128, block 16,
                hidden 4096), with the window / scale / softcap variants,
                a ragged prompt, GQA groups 1 and 8, verify lanes whose
                drafts stop early, and a bias case; then #1-#4 at Qwen2-7B
                heads (Hq 28, Hkv 4: G 7) and Gemma-2-9B heads (Hq 16,
                Hkv 8, D 256), hidden 3584;
  3b. parity_tp -- #5's partial_out mode (the tensor-parallel o-projection:
                the raw f32 partial, no scale, no residual) against its plain
                version, bf16 weights and int8 mantissas, at per-rank shapes:
                Llama-3.1-8B tp=2 ([M, 2048] @ [2048, 4096]), one ring chunk of
                it (N 2048, a strided column slice) and Llama-3.1-70B tp=8
                ([M, 1024] @ [1024, 8192]), M = 8 and 32, at PARTIAL_TOL; the
                times phase times both modes at those shapes beside their bound
                and a cuBLAS yardstick.
  4. serve   -- TorchEngine built by build_torch_engine at the full width of
                Llama-3.1-8B (random bf16 weights from a seed), fused decode
                and spec decode off, 8 concurrent generate() calls, one of
                them with frequency / presence / repetition penalties and
                min_tokens; checks the outputs (that request: at least
                min_tokens tokens) and that the kernels' launch counters
                equal 32 x prefills and 32 x decode steps (the other
                three: 0);
  5. serve_spec -- the same weights behind an engine with fused_decode and
                spec_k=3, on repeating traffic; checks the outputs, >= 4
                verify dispatches, the launch counters (verify 32 x verify
                dispatches, the fused heads 32 x every decode and verify
                step, decode 32 x plain steps, prefill 32 x prefills), a
                dense reference and that the seeded request repeats;
  6. serve_default -- the default admission path on the serve phase's
                weights: build_torch_engine with its defaults (chunk 512,
                mixed steps on; fused and spec off), the serve phase's 8
                requests twice; short prompts are packed, long ones chunked
                inside the decode batch's mixed steps; checks mixed steps
                and packed prefills > 0, launches (decode 32 x (decode +
                mixed steps), the other four 0), a repeat-identical run and
                the dense reference on the shortest and the longest
                (chunked) prompt;
  7. checkpoint -- a 2-layer, full-width bf16 Llama-3.1-8B checkpoint
                written by this script's own safetensors writer, loaded by
                build_torch_engine(<dir>): the loaded weights equal the
                written ones bit for bit, and its greedy tokens equal an
                engine's built from the same arrays through params=;
  8. times   -- each kernel, its plain version and the PyTorch yardstick
                timed with CUDA events, beside the kernel's bound (and the
                kernel / yardstick ratio where the yardstick is one call),
                #1-#3 also at the Qwen2-7B and Gemma-2-9B head shapes;
                engine TTFT with the 2000-token prefill's device time, the
                B=8 decode step with the fused heads off and on (wall and
                device time, #1's time per launch and #4's per layer),
                tokens/s with spec off and on.

  9. serve_int8 -- the JAX package's int8 deployment: build_torch_engine(
                quantize=True, kv_dtype="int8", fused_decode=True) at full
                width (seed 0: the serve phase's bf16 draws, quantized) on
                the default admission path, the serve phase's 8 requests;
                then an engine over the same weights built from the JAX
                factory's variables (DYN_JAX_QUANTIZE_INT8=1,
                DYN_KV_DTYPE=int8, DYN_FUSED_DECODE=1, DYN_SPEC_K=3) over
                quoting traffic. Checks the outputs, the launch counters
                (the four int8 modes' and no bf16 kernel's), the dense
                reference over the same int8 weights (it attends the
                unquantized K/V: gap bound INT8_REF_GAP) and the int8
                sizing; the parity phase also holds the four int8 modes to
                their plain versions (Llama-3.1-8B, Qwen2-7B and Gemma-2-9B
                heads, window and softcap, pages with their own scales,
                M = 8 and 32), and the times phase times each int8 mode,
                the int8 B=8 fused step and 2000-token TTFT beside bf16's,
                and the unfused int8 products' share of the step.

 10. serve_http -- `python -m dynamo_tpu_torch.run in=http out=torch` in
                its own process (this process's engines freed first) over a
                model directory written under build/serve_http/: the
                published Llama-3.1-8B config.json (no weights: 32 layers of
                seeded random bf16), a Llama-3-shaped byte-level BPE
                tokenizer.json of 128256 ids made by this script, and a
                Llama-3 chat template. Driven with stdlib http.client: one
                lone greedy request (TTFT, ITL), 8 concurrent streamed chat
                completions (prompts of ~16-2000 tokens, one with a stop
                string, one with penalties and min_tokens; each stream's
                form, finish reason and usage checked against the tokens
                streamed), one non-streamed completion, one stream closed
                after 4 chunks and a request after it (its lane must be
                freed: the server's exit stats). Then the lone request
                through an in-process build_torch_engine(<dir>) and the
                port's preprocessor and backend: the text must equal the
                HTTP text. The lone request's timing: 5 pairs in turns
                through HTTP and engine-direct in a process of its own
                alive beside the server (started as the server's is),
                medians and the per-pair difference. Also the host time
                of templating + tokenizing a 2000-token prompt.

 11. serve_tp -- tensor-parallel serving on one card (before serve_http):
                build_torch_engine(tensor_parallel_size=2, tp_backend="gloo",
                tp_devices=["cuda:0", "cuda:0"], fused_decode=True) at full
                width, bf16 then int8 weights + int8 KV, each beside a one-card
                engine on the same seeded weights: the first decode step's
                logits within TP_LOGIT_TOL of the one-card engine's, four of
                serve's requests served to the end, every rank's #1, #4 and 5p
                (5pq) launched 32 x fused steps (summed over both ranks' counters,
                the followers' read back through the step channel), the share of
                greedy tokens that agree with one card, the B=8 step's time on
                both, its collective share and each rank's peak memory; then a
                one-rank NCCL group runs a fused step with
                DYN_COLLECTIVE_OVERLAP=1 (the ring with zero hops). Two ranks on
                one card over gloo check correctness and say nothing of
                collective speed across cards.

The line before the last is one JSON object with a row per kernel; the last
line is {"ok": true, "device": {...}}. Needs torch, numpy and the checkout;
imports nothing of JAX.
"""

from __future__ import annotations

import asyncio
import copy
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Optional

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (data sheet)
HQ, HKV, D, BLOCK = 32, 8, 128, 16  # Llama-3.1-8B attention shapes
MAX_MODEL_LEN = 4096
MAX_BLOCKS = MAX_MODEL_LEN // BLOCK  # block-table width at max_model_len
STEP_CTX = 1024  # the engine phase's B=8 decode step feeds position 1024

# Tolerances of kernel vs plain version (same bf16 inputs on the card; both
# accumulate in f32 and round the output to bf16).
#   decode: only the f32 summation order and exp/tanh differ, so outputs
#     differ by at most ~1 bf16 ulp: |d| <= 1e-3 + 2^-6 |plain|;
#   prefill: the kernel also rounds the softmax weights to bf16 for the
#     tensor-core P @ V product (relative 2^-9 per weight, |v| ~ 1 here):
#     |d| <= 1e-2 + 2^-6 |plain|.
#   verify: PR 2's kernel rounded the softmax weights to bf16 for P @ V, as
#     prefill does (the page-streaming kernel keeps them f32 in a bf16 hi/lo
#     pair and now also meets DECODE_TOL, which the card tests hold it to);
#   fused QKV / o-proj: the f32 products are summed in another order (split
#     contraction) and the norm's sum of squares too, so a bf16 rounding of
#     the normed activations or of the product may flip by one ulp before
#     RoPE / the residual add: a few bf16 ulps of the output,
#     |d| <= 1e-2 + 2^-6 |plain|.
DECODE_TOL = (1e-3, 2.0 ** -6)
PREFILL_TOL = (1e-2, 2.0 ** -6)
VERIFY_TOL = (1e-2, 2.0 ** -6)
GEMV_TOL = (1e-2, 2.0 ** -6)
HIDDEN = 4096  # Llama-3.1-8B hidden size
# other models' attention heads (Hq, Hkv, D) and hidden size, from their
# published config.json files: Qwen2-7B (a GQA group of 7) and Gemma-2-9B
# (head_dim 256)
HEAD_SHAPES = {"qwen2_7b": (28, 4, 128, 3584), "gemma2_9b": (16, 8, 256, 3584)}


class SmokeError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing


HOLD_CYCLES = 2_000_000  # ~1 ms of an idle spin kernel at the H100's clocks


def time_ms(torch, fn, reps: int = 20, warmup: int = 3, flush=None) -> dict:
    """Per-call CUDA-event times of fn() in ms: median and spread over
    `reps` calls. `flush` (if given) runs before every call, outside the
    timed region, to evict the L2 cache the way other layers would. A spin
    kernel that touches no memory holds the stream before the start event
    until fn() has been enqueued, so the time is the device's alone and not
    the host's work to launch it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return {
        "median": statistics.median(times),
        "min": min(times),
        "max": max(times),
        "reps": reps,
    }


def make_flush(torch):
    buf = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")

    def flush():
        buf.zero_()

    return flush


# ------------------------------------------------------------------ inputs


def decode_inputs(torch, ctx_lens, seed: int, num_blocks: int = 2112, hq=HQ, hkv=HKV, d=D):
    """Paged decode inputs at main-path shapes: each sequence owns distinct,
    randomly placed pages of a [hkv, num_blocks, BLOCK, d] bf16 cache."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    B = len(ctx_lens)
    pages = [(n + BLOCK - 1) // BLOCK for n in ctx_lens]
    if sum(pages) >= num_blocks:
        raise SmokeError("decode parity cache too small")
    perm = torch.randperm(num_blocks - 1, generator=g)[: sum(pages)] + 1
    tables = torch.zeros(B, MAX_BLOCKS, dtype=torch.int32)
    off = 0
    for b, n in enumerate(pages):
        tables[b, :n] = perm[off:off + n].to(torch.int32)
        off += n
    shape = (hkv, num_blocks, BLOCK, d)
    k = torch.randn(shape, generator=g).to(torch.bfloat16)
    v = torch.randn(shape, generator=g).to(torch.bfloat16)
    q = torch.randn(B, hq, d, generator=g).to(torch.bfloat16)
    lens = torch.tensor(ctx_lens, dtype=torch.int32)
    return [t.cuda() for t in (q, k, v, tables, lens)]


def prefill_inputs(torch, P: int, seed: int, hq: int = HQ, hkv: int = HKV, d: int = D):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(P, hq, d, generator=g).to(torch.bfloat16)
    k = torch.randn(P, hkv, d, generator=g).to(torch.bfloat16)
    v = torch.randn(P, hkv, d, generator=g).to(torch.bfloat16)
    return q.cuda(), k.cuda(), v.cuda()


def verify_inputs(torch, bases, draft_lens, S: int, seed: int, num_blocks: int = 2112,
                  hq=HQ, hkv=HKV, d=D):
    """Paged verify inputs: lane b feeds positions bases[b] .. bases[b]+S-1;
    its table covers only positions up to bases[b] + draft_lens[b] (a lane
    whose drafts stop early has entries 0 past its last block)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    B = len(bases)
    pages = [(p + d) // BLOCK + 1 for p, d in zip(bases, draft_lens)]
    if sum(pages) >= num_blocks:
        raise SmokeError("verify parity cache too small")
    perm = torch.randperm(num_blocks - 1, generator=g)[: sum(pages)] + 1
    tables = torch.zeros(B, MAX_BLOCKS, dtype=torch.int32)
    off = 0
    for b, n in enumerate(pages):
        tables[b, :n] = perm[off:off + n].to(torch.int32)
        off += n
    shape = (hkv, num_blocks, BLOCK, d)
    k = torch.randn(shape, generator=g).to(torch.bfloat16)
    v = torch.randn(shape, generator=g).to(torch.bfloat16)
    q = torch.randn(B, S, hq, d, generator=g).to(torch.bfloat16)
    pos = (torch.tensor(bases)[:, None] + torch.arange(S)[None, :]).to(torch.int32)
    return [t.cuda() for t in (q, k, v, tables, pos)]


def gemv_inputs(torch, M: int, seed: int, bias: bool = False, hq=HQ, hkv=HKV, d=D,
                hidden=HIDDEN):
    """The fused heads' inputs (Llama-3.1-8B width by default): residual
    rows x, the norm weight, wq / wk / wv / wo (std 0.02, as init_params
    draws them), cos / sin of random positions under llama3 rope scaling,
    and optional q/k/v biases."""
    from dynamo_tpu_torch.ops.basics import rope_freqs

    g = torch.Generator(device="cpu").manual_seed(seed)
    bf = torch.bfloat16
    x = torch.randn(M, hidden, generator=g).to(bf)
    norm = (1.0 + 0.1 * torch.randn(hidden, generator=g)).to(bf)
    wq = (0.02 * torch.randn(hidden, hq * d, generator=g)).to(bf)
    wk = (0.02 * torch.randn(hidden, hkv * d, generator=g)).to(bf)
    wv = (0.02 * torch.randn(hidden, hkv * d, generator=g)).to(bf)
    wo = (0.02 * torch.randn(hq * d, hidden, generator=g)).to(bf)
    attn = torch.randn(M, hq * d, generator=g).to(bf)
    pos = torch.randint(0, MAX_MODEL_LEN, (M,), generator=g)
    inv = rope_freqs(d, LLAMA31_8B["rope_theta"], LLAMA31_8B["rope_scaling"])
    angles = pos[:, None].float() * inv
    biases = (
        tuple((0.1 * torch.randn(n, generator=g)).to(bf) for n in (hq * d, hkv * d, hkv * d))
        if bias else (None, None, None)
    )
    cuda = lambda t: None if t is None else t.cuda()  # noqa: E731
    return {
        "x": cuda(x), "norm": cuda(norm), "wq": cuda(wq), "wk": cuda(wk),
        "wv": cuda(wv), "wo": cuda(wo), "attn": cuda(attn),
        "cos": cuda(torch.cos(angles)), "sin": cuda(torch.sin(angles)),
        "bq": cuda(biases[0]), "bk": cuda(biases[1]), "bv": cuda(biases[2]),
        "heads": (hq, hkv, d),
    }


def qkv_call(fn, t):
    hq, hkv, d = t.get("heads", (HQ, HKV, D))
    return fn(
        t["x"], t["norm"], t["wq"], t["wk"], t["wv"], t["cos"], t["sin"],
        eps=LLAMA31_8B["rms_norm_eps"], num_heads=hq, num_kv_heads=hkv,
        head_dim=d, bq=t["bq"], bk=t["bk"], bv=t["bv"],
    )


def compare(torch, name: str, got, want, tol) -> float:
    got = got.float()
    want = want.float()
    if not torch.isfinite(got).all():
        raise SmokeError(f"{name}: kernel output has non-finite values")
    err = (got - want).abs()
    bound = tol[0] + tol[1] * want.abs()
    worst = float(err.max())
    if bool((err > bound).any()):
        i = int((err - bound).argmax())
        raise SmokeError(
            f"{name}: kernel disagrees with the plain version: max |d| = "
            f"{worst:.3e}; at flat index {i}: kernel {float(got.flatten()[i]):.5f}"
            f" vs plain {float(want.flatten()[i]):.5f}"
        )
    return worst


# ------------------------------------------------------------------ phases

DECODE_LENS = [1, 16, 17, 300, 1000, 1777, 2500, 3001]
DECODE_CASES = [
    ("full", {}),
    ("window", {"window": 1024}),
    ("scale_softcap", {"scale": 0.125, "logit_softcap": 5.0}),
]
PREFILL_CASES = [
    ("P128", 128, 100, {}),
    ("P512", 512, 500, {}),
    ("P2048", 2048, 2000, {}),
    ("P2048_window", 2048, 1900, {"window": 512}),
    ("P512_scale_softcap", 512, 480, {"scale": 0.1, "logit_softcap": 5.0}),
    ("P1000_ragged", 1000, 999, {}),  # P not a multiple of the 128-row tile
]
# other GQA groups G = Hq / Hkv, Hkv fixed at 8: (name, Hq, P, valid_len)
PREFILL_GROUP_CASES = [("G1", HKV, 1000, 999), ("G8", 8 * HKV, 2048, 2000)]
# verify: B=8 lanes of S = spec_k + 1 = 4 positions, ragged bases, three
# lanes whose drafts stop early (their tables end at base + draft_len)
VERIFY_S = 4
VERIFY_BASES = [3, 100, 511, 1023, 1500, 2047, 2600, 2996]
VERIFY_DRAFT_LENS = [3, 3, 0, 1, 3, 2, 3, 3]
# fused heads: M = B (decode) and M = B * S (verify) rows, and a bias case
GEMV_CASES = [(8, False), (32, False), (32, True)]


def phase_parity(torch) -> dict:
    from dynamo_tpu_torch.ops import attention as A
    from dynamo_tpu_torch.ops import cuda_attention as K

    errs = {"paged_decode_attention": 0.0, "flash_prefill_attention": 0.0}
    q, k, v, tables, lens = decode_inputs(torch, DECODE_LENS, seed=1)
    for name, kw in DECODE_CASES:
        got = K.paged_decode_attention_cuda(q, k, v, tables, lens, **kw)
        want = A.paged_decode_attention_plain(q, k, v, tables, lens, **kw)
        torch.cuda.synchronize()
        e = compare(torch, f"decode/{name}", got, want, DECODE_TOL)
        errs["paged_decode_attention"] = max(errs["paged_decode_attention"], e)
        log(f"parity decode/{name}: B={len(DECODE_LENS)} lens={DECODE_LENS} "
            f"max|d|={e:.3e} (tol {DECODE_TOL[0]:g} + {DECODE_TOL[1]:g}|x|)")
    prefill = [(name, HQ, P, vl, kw) for name, P, vl, kw in PREFILL_CASES]
    prefill += [(name, hq, P, vl, {}) for name, hq, P, vl in PREFILL_GROUP_CASES]
    for name, hq, P, vl, kw in prefill:
        q, k, v = prefill_inputs(torch, P, seed=P + vl + hq, hq=hq)
        got = K.flash_prefill_attention_cuda(q, k, v, vl, **kw)
        want = A.causal_prefill_attention_plain(q, k, v, vl, **kw)
        torch.cuda.synchronize()
        e = compare(torch, f"prefill/{name}", got[:vl], want[:vl], PREFILL_TOL)
        errs["flash_prefill_attention"] = max(errs["flash_prefill_attention"], e)
        log(f"parity prefill/{name}: P={P} valid_len={vl} Hq={hq} Hkv={HKV} {kw} "
            f"max|d|={e:.3e} (tol {PREFILL_TOL[0]:g} + {PREFILL_TOL[1]:g}|x|)")
    errs.update(spec_parity(torch))
    for name, e in shape_parity(torch).items():
        errs[name] = max(errs[name], e)
    return errs


def shape_parity(torch) -> dict:
    """#1-#4 at the other models' head shapes (HEAD_SHAPES): a GQA group of
    7 and head_dim 256, under the same tolerances."""
    from dynamo_tpu_torch.ops import attention as A
    from dynamo_tpu_torch.ops import cuda_attention as K
    from dynamo_tpu_torch.ops import cuda_linear as KL
    from dynamo_tpu_torch.ops import linear as L

    errs = dict.fromkeys(("paged_decode_attention", "flash_prefill_attention",
                          "paged_verify_attention", "fused_qkv_rope"), 0.0)

    def check(kernel, label, got, want, tol):
        torch.cuda.synchronize()
        e = compare(torch, label, got, want, tol)
        errs[kernel] = max(errs[kernel], e)
        log(f"parity {label}: max|d|={e:.3e} (tol {tol[0]:g} + {tol[1]:g}|x|)")

    for name, (hq, hkv, d, hidden) in HEAD_SHAPES.items():
        shp = dict(hq=hq, hkv=hkv, d=d)
        tag = f"{name} Hq={hq} Hkv={hkv} D={d}"
        args = decode_inputs(torch, DECODE_LENS, seed=30, **shp)
        for case, kw in DECODE_CASES:
            check("paged_decode_attention", f"decode/{case} {tag}",
                  K.paged_decode_attention_cuda(*args, **kw),
                  A.paged_decode_attention_plain(*args, **kw), DECODE_TOL)
        args = verify_inputs(torch, VERIFY_BASES, VERIFY_DRAFT_LENS, VERIFY_S, seed=31, **shp)
        for case, kw in DECODE_CASES:
            check("paged_verify_attention", f"verify/{case} {tag}",
                  K.paged_verify_attention_cuda(*args, **kw),
                  A.paged_verify_attention_plain(*args, **kw), VERIFY_TOL)
        for case, P, vl, kw in (PREFILL_CASES[2], PREFILL_CASES[4], PREFILL_CASES[5]):
            q, k, v = prefill_inputs(torch, P, seed=32 + P, **shp)
            check("flash_prefill_attention", f"prefill/{case} {tag}",
                  K.flash_prefill_attention_cuda(q, k, v, vl, **kw)[:vl],
                  A.causal_prefill_attention_plain(q, k, v, vl, **kw)[:vl], PREFILL_TOL)
        for M in (8, 32):
            t = gemv_inputs(torch, M, seed=40 + M, bias=name == "qwen2_7b", hidden=hidden, **shp)
            got = qkv_call(KL.fused_qkv_rope_cuda, t)
            want = qkv_call(L.fused_qkv_rope_plain, t)
            for n, a, b in zip("qkv", got, want):
                check("fused_qkv_rope", f"qkv/M{M}/{n} {tag} hidden={hidden}", a, b, GEMV_TOL)
    return errs


def spec_parity(torch) -> dict:
    """The spec + fused path's kernels against their plain versions."""
    from dynamo_tpu_torch.ops import attention as A
    from dynamo_tpu_torch.ops import cuda_attention as K
    from dynamo_tpu_torch.ops import cuda_linear as KL
    from dynamo_tpu_torch.ops import linear as L

    errs = {"paged_verify_attention": 0.0, "fused_qkv_rope": 0.0, "fused_attn_out_residual": 0.0}
    q, k, v, tables, pos = verify_inputs(torch, VERIFY_BASES, VERIFY_DRAFT_LENS, VERIFY_S, seed=4)
    for name, kw in DECODE_CASES:
        got = K.paged_verify_attention_cuda(q, k, v, tables, pos, **kw)
        want = A.paged_verify_attention_plain(q, k, v, tables, pos, **kw)
        torch.cuda.synchronize()
        e = compare(torch, f"verify/{name}", got, want, VERIFY_TOL)
        errs["paged_verify_attention"] = max(errs["paged_verify_attention"], e)
        log(f"parity verify/{name}: B={len(VERIFY_BASES)} S={VERIFY_S} bases={VERIFY_BASES} "
            f"draft_lens={VERIFY_DRAFT_LENS} max|d|={e:.3e} "
            f"(tol {VERIFY_TOL[0]:g} + {VERIFY_TOL[1]:g}|x|)")
    for M, bias in GEMV_CASES:
        t = gemv_inputs(torch, M, seed=10 + M, bias=bias)
        got = qkv_call(KL.fused_qkv_rope_cuda, t)
        want = qkv_call(L.fused_qkv_rope_plain, t)
        torch.cuda.synchronize()
        e = max(compare(torch, f"qkv/M{M}/{n}", a, b, GEMV_TOL) for n, a, b in zip("qkv", got, want))
        errs["fused_qkv_rope"] = max(errs["fused_qkv_rope"], e)
        log(f"parity fused_qkv_rope: M={M} bias={bias} llama3 rope max|d|={e:.3e} "
            f"(tol {GEMV_TOL[0]:g} + {GEMV_TOL[1]:g}|x|)")
        if bias:
            continue
        got = KL.fused_attn_out_residual_cuda(t["attn"], t["wo"], t["x"])
        want = L.fused_attn_out_residual_plain(t["attn"], t["wo"], t["x"])
        torch.cuda.synchronize()
        e = compare(torch, f"out/M{M}", got, want, GEMV_TOL)
        errs["fused_attn_out_residual"] = max(errs["fused_attn_out_residual"], e)
        log(f"parity fused_attn_out_residual: M={M} max|d|={e:.3e} "
            f"(tol {GEMV_TOL[0]:g} + {GEMV_TOL[1]:g}|x|)")
    return errs


def decode_bound(lens, B: int, hq=HQ, hkv=HKV, d=D, kv_bytes: int = 2) -> tuple[float, str, float, float]:
    """Least time for one paged decode call: every live K and V row read
    once (kv_bytes 1: int8 mantissas, plus each live page's k and v scale
    per head), q/tables/lens read once, the output written once; f32 work
    counted against the bf16 peak (the more generous one)."""
    keys = sum(lens)
    pages = sum((n + BLOCK - 1) // BLOCK for n in lens)
    nbytes = (
        2 * keys * hkv * d * kv_bytes  # K and V rows
        + 2 * B * hq * d * 2  # q in, out
        + pages * 4 + B * 4
        + (2 * pages * hkv * 4 if kv_bytes == 1 else 0)  # the pages' f32 scales
    )
    flops = 4 * keys * hq * d
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations", nbytes, flops


def prefill_bound(P: int, vl: int, window=None, hq=HQ, hkv=HKV, d=D) -> tuple[float, str, float, float]:
    """Least time for one prefill attention call: the valid rows of q, k, v
    read once, the [P] output written once; 4 * D flops per (query head,
    visible key) pair over the valid rows."""
    pairs = sum(min(i + 1, window or (i + 1)) for i in range(vl))
    flops = 4 * pairs * hq * d
    nbytes = (vl * (hq + 2 * hkv) * d + P * hq * d) * 2
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations", nbytes, flops


def decode_row(torch, flush, hq=HQ, hkv=HKV, d=D, plain_reps=20) -> dict:
    """#1 at chip_smoke's ragged contexts: kernel, plain and a yardstick."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops import attention as A
    from dynamo_tpu_torch.ops import cuda_attention as K

    lens = DECODE_LENS
    q, k, v, tables, lens_t = decode_inputs(torch, lens, seed=2, hq=hq, hkv=hkv, d=d)
    t_k = time_ms(torch, lambda: K.paged_decode_attention_cuda(q, k, v, tables, lens_t), flush=flush)
    t_p = time_ms(torch, lambda: A.paged_decode_attention_plain(q, k, v, tables, lens_t),
                  reps=plain_reps, flush=flush)
    # library time: SDPA over the same keys already gathered into a dense,
    # padded [B, Hq, S, D] layout with a length mask (the gather is not
    # timed; no PyTorch call takes the paged cache itself)
    S = max(lens)
    kd = torch.zeros(len(lens), hkv, S, d, dtype=torch.bfloat16, device="cuda")
    vd = torch.zeros_like(kd)
    for b, n in enumerate(lens):
        pages = tables[b, : (n + BLOCK - 1) // BLOCK].long()
        kd[b, :, :n] = k[:, pages].reshape(hkv, -1, d)[:, :n]
        vd[b, :, :n] = v[:, pages].reshape(hkv, -1, d)[:, :n]
    mask = (torch.arange(S, device="cuda")[None, :] < lens_t[:, None].long())[:, None, None, :]
    qd = q[:, :, None, :]
    t_s = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, enable_gqa=True), flush=flush)
    b_ms, b_by, nbytes, flops = decode_bound(lens, len(lens), hq, hkv, d)
    return {
        "ms": t_k, "plain_ms": t_p, "library_ms": t_s, "bound_ms": b_ms,
        "bound_by": b_by, "bytes": nbytes, "flops": flops,
        "shape": f"B={len(lens)} Hq={hq} Hkv={hkv} D={d} block={BLOCK} lens={lens}",
    }


def prefill_row(torch, flush, hq=HQ, hkv=HKV, d=D, plain_reps=5) -> dict:
    """#3 at P=2048, valid_len 2000: kernel, plain and causal GQA SDPA."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops import attention as A
    from dynamo_tpu_torch.ops import cuda_attention as K

    P, vl = 2048, 2000
    q, k, v = prefill_inputs(torch, P, seed=3, hq=hq, hkv=hkv, d=d)
    t_k = time_ms(torch, lambda: K.flash_prefill_attention_cuda(q, k, v, vl), flush=flush)
    t_p = time_ms(torch, lambda: A.causal_prefill_attention_plain(q, k, v, vl),
                  reps=plain_reps, warmup=1, flush=flush)
    qs = q[:vl].transpose(0, 1)[None]
    ks = k[:vl].transpose(0, 1)[None]
    vs = v[:vl].transpose(0, 1)[None]
    t_s = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, enable_gqa=True), flush=flush)
    b_ms, b_by, nbytes, flops = prefill_bound(P, vl, None, hq, hkv, d)
    return {
        "ms": t_k, "plain_ms": t_p, "library_ms": t_s, "bound_ms": b_ms,
        "bound_by": b_by, "bytes": nbytes, "flops": flops,
        "ratio_to_library": t_k["median"] / t_s["median"],
        "shape": f"P={P} valid_len={vl} Hq={hq} Hkv={hkv} D={d}",
    }


def phase_kernel_times(torch, card: str) -> dict:
    """Kernel / plain / yardstick times at main-path shapes, then #1-#3 at
    the other models' head shapes (HEAD_SHAPES)."""
    flush = make_flush(torch)
    rows = {}
    rows["paged_decode_attention"] = decode_row(torch, flush)
    rows["paged_decode_attention/step"] = decode_step_times(torch, flush)
    rows["flash_prefill_attention"] = prefill_row(torch, flush)
    rows.update(spec_kernel_times(torch, flush))
    for name, (hq, hkv, d, _) in HEAD_SHAPES.items():
        shp = dict(hq=hq, hkv=hkv, d=d)
        rows[f"paged_decode_attention/{name}"] = decode_row(torch, flush, plain_reps=5, **shp)
        rows[f"flash_prefill_attention/{name}"] = prefill_row(torch, flush, plain_reps=2, **shp)
        rows[f"paged_verify_attention/{name}"] = verify_row(torch, flush, **shp)
    for name, row in rows.items():
        print(json.dumps({"kernel_time": name, "card": card, **row}), flush=True)
    return rows


def decode_step_times(torch, flush) -> dict:
    """#1 at the B=8 decode step's own shape (every context 1025: position
    1024 and the keys before it; a 256-wide table, max_model_len 4096),
    beside one unmasked dense SDPA call with enable_gqa over the same keys
    gathered beforehand (not timed): every key is live, so that call
    computes the same function."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops import attention as A
    from dynamo_tpu_torch.ops import cuda_attention as K

    B, ctx = 8, STEP_CTX + 1
    q, k, v, tables, lens_t = decode_inputs(torch, [ctx] * B, seed=6)
    t_k = time_ms(torch, lambda: K.paged_decode_attention_cuda(q, k, v, tables, lens_t), flush=flush)
    t_p = time_ms(torch, lambda: A.paged_decode_attention_plain(q, k, v, tables, lens_t),
                  reps=5, flush=flush)
    pages = tables[:, : (ctx + BLOCK - 1) // BLOCK].long()
    kd = k[:, pages].reshape(HKV, B, -1, D)[:, :, :ctx].transpose(0, 1).contiguous()
    vd = v[:, pages].reshape(HKV, B, -1, D)[:, :, :ctx].transpose(0, 1).contiguous()
    qd = q[:, :, None, :]
    t_s = time_ms(torch, lambda: F.scaled_dot_product_attention(qd, kd, vd, enable_gqa=True),
                  flush=flush)
    b_ms, b_by, nbytes, flops = decode_bound([ctx] * B, B)
    return {
        "ms": t_k, "plain_ms": t_p, "library_ms": t_s, "bound_ms": b_ms, "bound_by": b_by,
        "bytes": nbytes, "flops": flops, "ratio_to_library": t_k["median"] / t_s["median"],
        "library": "SDPA over the keys gathered dense beforehand, no mask, enable_gqa",
        "shape": f"B={B} ctx={ctx} Hq={HQ} Hkv={HKV} D={D} block={BLOCK} table {MAX_BLOCKS} wide",
    }


def verify_bound(bases, S: int, hq=HQ, hkv=HKV, d=D, kv_bytes: int = 2) -> tuple[float, str, float, float]:
    """Least time for one verify call: each lane's live K and V rows (its
    context, base + S keys; kv_bytes 1: int8, plus the pages' scales) read
    once, q / tables / positions read once, the output written once;
    4 * D flops per (query head, visible key) pair."""
    keys = sum(p + S for p in bases)
    pairs = sum(p + s + 1 for p in bases for s in range(S))
    pages = sum((p + S + BLOCK - 1) // BLOCK for p in bases)
    nbytes = (
        2 * keys * hkv * d * kv_bytes + 2 * len(bases) * S * hq * d * 2
        + pages * 4 + len(bases) * S * 4
        + (2 * pages * hkv * 4 if kv_bytes == 1 else 0)
    )
    flops = 4 * pairs * hq * d
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations", nbytes, flops


def gemv_bound(M: int, K: int, N: int, extra_bytes: int, w_bytes: int = 2) -> tuple[float, str, float, float]:
    """Least time for a fused head: the [K, N] weights (bf16, or w_bytes 1:
    int8 plus a bf16 scale per column), the [M, K] input and the [M, N]
    output moved once, plus `extra_bytes` (norm weight, cos / sin,
    residual); 2 * M * K * N flops."""
    nbytes = K * N * w_bytes + (M * K + M * N) * 2 + extra_bytes + (N * 2 if w_bytes == 1 else 0)
    flops = 2 * M * K * N
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations", nbytes, flops


def verify_row(torch, flush, hq=HQ, hkv=HKV, d=D) -> dict:
    """#2 at the verify shape (B=8, S=4): kernel, plain and a yardstick."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops import attention as A
    from dynamo_tpu_torch.ops import cuda_attention as K

    S, bases = VERIFY_S, VERIFY_BASES
    full = [S - 1] * len(bases)  # every lane drafted S - 1 tokens
    q, k, v, tables, pos = verify_inputs(torch, bases, full, S, seed=5, hq=hq, hkv=hkv, d=d)
    t_k = time_ms(torch, lambda: K.paged_verify_attention_cuda(q, k, v, tables, pos), flush=flush)
    t_p = time_ms(torch, lambda: A.paged_verify_attention_plain(q, k, v, tables, pos),
                  reps=5, flush=flush)
    # yardstick: SDPA over the same keys gathered dense beforehand (not
    # timed), [B, Hkv, ctx, D], with each query row's causal mask
    ctx = max(bases) + S
    kd = torch.zeros(len(bases), hkv, ctx, d, dtype=torch.bfloat16, device="cuda")
    vd = torch.zeros_like(kd)
    for b, p in enumerate(bases):
        n = p + S
        pages = tables[b, : (n + BLOCK - 1) // BLOCK].long()
        kd[b, :, :n] = k[:, pages].reshape(hkv, -1, d)[:, :n]
        vd[b, :, :n] = v[:, pages].reshape(hkv, -1, d)[:, :n]
    mask = torch.arange(ctx, device="cuda")[None, None, :] <= pos.long()[:, :, None]
    qd = q.transpose(1, 2)  # [B, Hq, S, D]
    t_s = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask[:, None], enable_gqa=True), flush=flush)
    b_ms, b_by, nbytes, flops = verify_bound(bases, S, hq, hkv, d)
    return {
        "ms": t_k, "plain_ms": t_p, "library_ms": t_s, "bound_ms": b_ms,
        "bound_by": b_by, "bytes": nbytes, "flops": flops,
        "library": "SDPA over keys gathered dense beforehand, causal mask",
        "shape": f"B={len(bases)} S={S} Hq={hq} Hkv={hkv} D={d} block={BLOCK} bases={bases}",
    }


def spec_kernel_times(torch, flush) -> dict:
    """The spec + fused path's kernels: kernel / plain / yardstick times at
    the verify shape (B=8, S=4) and the fused heads at M = 8 (a decode
    step) and M = 32 (a verify step)."""
    from dynamo_tpu_torch.ops import cuda_linear as KL
    from dynamo_tpu_torch.ops import linear as L
    from dynamo_tpu_torch.ops.basics import rms_norm

    rows = {"paged_verify_attention": verify_row(torch, flush)}
    eps = LLAMA31_8B["rms_norm_eps"]
    for M in (8, 32):
        t = gemv_inputs(torch, M, seed=20 + M)
        wqkv = torch.cat([t["wq"], t["wk"], t["wv"]], dim=1)  # built beforehand
        inv = torch.ones(D // 2, device="cuda")

        def chain():  # the unfused chain: rms_norm -> one matmul -> rope
            from dynamo_tpu_torch.ops.basics import apply_rope

            y = torch.matmul(rms_norm(t["x"], t["norm"], eps), wqkv)
            qh = y[:, : HQ * D].reshape(M, HQ, D)
            kh = y[:, HQ * D: (HQ + HKV) * D].reshape(M, HKV, D)
            p = torch.arange(M, device="cuda")
            return apply_rope(qh, p, inv), apply_rope(kh, p, inv)

        N = (HQ + 2 * HKV) * D
        xn = rms_norm(t["x"], t["norm"], eps)  # normed beforehand, not timed
        t_k = time_ms(torch, lambda: qkv_call(KL.fused_qkv_rope_cuda, t), flush=flush)
        t_p = time_ms(torch, lambda: qkv_call(L.fused_qkv_rope_plain, t), flush=flush)
        t_s = time_ms(torch, chain, flush=flush)
        t_m = time_ms(torch, lambda: torch.matmul(xn, wqkv), flush=flush)
        b_ms, b_by, nbytes, flops = gemv_bound(M, HIDDEN, N, HIDDEN * 2 + M * D * 4)
        rows[f"fused_qkv_rope/M{M}"] = {
            "ms": t_k, "plain_ms": t_p, "library_ms": t_m, "chain_ms": t_s,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
            "ratio_to_library": t_k["median"] / t_m["median"],
            "library": "torch.matmul(xn, [wq|wk|wv]) over a pre-normed x: one cuBLAS "
                       "call for the product alone (no norm, bias or RoPE)",
            "chain": "rms_norm -> matmul on [wq|wk|wv] -> apply_rope (q, k)",
            "shape": f"M={M} hidden={HIDDEN} N={N} (Hq {HQ}, Hkv {HKV}, D {D})",
        }
        t_k = time_ms(torch, lambda: KL.fused_attn_out_residual_cuda(t["attn"], t["wo"], t["x"]),
                      flush=flush)
        t_p = time_ms(torch, lambda: L.fused_attn_out_residual_plain(t["attn"], t["wo"], t["x"]),
                      flush=flush)
        t_s = time_ms(torch, lambda: torch.addmm(t["x"], t["attn"], t["wo"]), flush=flush)
        b_ms, b_by, nbytes, flops = gemv_bound(M, HQ * D, HIDDEN, M * HIDDEN * 2)
        rows[f"fused_attn_out_residual/M{M}"] = {
            "ms": t_k, "plain_ms": t_p, "library_ms": t_s, "bound_ms": b_ms,
            "bound_by": b_by, "bytes": nbytes, "flops": flops,
            "ratio_to_library": t_k["median"] / t_s["median"],
            "library": "torch.addmm(x, attn, wo)",
            "shape": f"M={M} K={HQ * D} N={HIDDEN}",
        }
    return rows


# ------------------------------------------------------------------ serve

# meta-llama/Llama-3.1-8B config.json as published on the Hugging Face hub
# (huggingface.co/meta-llama/Llama-3.1-8B/blob/main/config.json)
LLAMA31_8B = {
    "architectures": ["LlamaForCausalLM"],
    "attention_bias": False,
    "bos_token_id": 128000,
    "eos_token_id": 128001,
    "hidden_act": "silu",
    "hidden_size": 4096,
    "intermediate_size": 14336,
    "max_position_embeddings": 131072,
    "mlp_bias": False,
    "model_type": "llama",
    "num_attention_heads": 32,
    "num_hidden_layers": 32,
    "num_key_value_heads": 8,
    "rms_norm_eps": 1e-05,
    "rope_scaling": {
        "factor": 8.0,
        "low_freq_factor": 1.0,
        "high_freq_factor": 4.0,
        "original_max_position_embeddings": 8192,
        "rope_type": "llama3",
    },
    "rope_theta": 500000.0,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
    "vocab_size": 128256,
}
PROMPT_LENS = [16, 100, 300, 517, 800, 1200, 1600, 2000]
MAX_TOKENS = [32, 40, 48, 56, 64, 32, 48, 64]
SAMPLED = 3  # index of the one seeded, sampled request
# index of the one request with frequency / presence / repetition penalties
# and min_tokens (greedy, the model's EOS id as its stop id)
PENALIZED = 5
PENALTIES = {"frequency_penalty": 0.5, "presence_penalty": 0.5, "repetition_penalty": 1.2}
MIN_TOKENS = 24


def make_requests(np, PreprocessedRequest, SamplingOptions, StopConditions):
    rng = np.random.default_rng(0)
    reqs = []
    for i, (n, m) in enumerate(zip(PROMPT_LENS, MAX_TOKENS)):
        prompt = rng.integers(0, LLAMA31_8B["vocab_size"], n).tolist()
        sampling = (
            SamplingOptions(temperature=0.8, top_p=0.95, top_k=50, seed=1234)
            if i == SAMPLED else SamplingOptions(greedy=True)
        )
        # no eos ids: random weights may emit any id, and every request must
        # run to its max_tokens so the counts can be checked -- but the
        # penalised one, whose EOS stays masked until min_tokens
        eos, min_tokens = [], None
        if i == PENALIZED:
            sampling = SamplingOptions(greedy=True, **PENALTIES)
            eos, min_tokens = [LLAMA31_8B["eos_token_id"]], MIN_TOKENS
        reqs.append(PreprocessedRequest(
            token_ids=prompt, sampling=sampling,
            stop=StopConditions(max_tokens=m, min_tokens=min_tokens), eos_token_ids=eos,
        ))
    return reqs


async def run_requests(engine, reqs, Context):
    async def one(req):
        toks, reason, t0, ttft = [], None, time.perf_counter(), None
        async for out in engine.generate(req, Context()):
            if out.token_ids and ttft is None:
                ttft = time.perf_counter() - t0
            toks.extend(out.token_ids)
            if out.finish_reason is not None:
                reason = out.finish_reason
                if out.error:
                    raise SmokeError(f"request failed: {out.error}")
        return toks, reason, ttft

    return await asyncio.gather(*(one(r) for r in reqs))


def reference_check(torch, runner, prompt, generated, n_check: int = 8,
                    bound: float = 0.25) -> float:
    """Dense reference of the first tokens: one forward over prompt +
    generated[:n_check] with the plain attention version and no cache, over
    the runner's own weights (int8 ones through the int8 products); each
    greedy token of the engine must be the reference's argmax up to bf16
    noise (and, with an int8 cache, quantization noise: `bound`). Returns
    the largest logit gap seen."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.ops import attention as A
    from dynamo_tpu_torch.ops.layers import attn_out, qkv_head

    cfg, params = runner.config, runner.params
    seq = prompt + generated[:n_check]
    with torch.inference_mode():
        tokens = torch.tensor(seq, device=runner.device)
        positions = torch.arange(len(seq), device=runner.device)
        freqs = llama._rope_pair(cfg, tokens.device)
        x = llama._embed(params, cfg, tokens)
        for i, layer in enumerate(params["layers"]):
            q, k, v = qkv_head(x, layer, cfg, llama._layer_freqs(cfg, i, freqs), positions)
            attn = A.causal_prefill_attention_plain(q, k, v, len(seq))
            x = llama._mlp(attn_out(attn, x, layer, cfg), layer, cfg)
        logits = llama._logits(x, params, cfg)
    worst = 0.0
    for j in range(n_check):
        row = logits[len(prompt) - 1 + j]
        gap = float(row.max() - row[generated[j]])
        worst = max(worst, gap)
        # bf16 activations: the kernel path and the dense path round
        # differently, so near-ties may flip; a real fault moves far more
        if gap > bound:
            raise SmokeError(
                f"engine token {generated[j]} at step {j} is {gap:.3f} below "
                f"the reference's best logit"
            )
    return worst


def phase_serve(torch, np, card: str) -> dict:
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.ops import kernels
    from dynamo_tpu_torch.protocols.common import (
        Context, FinishReason, PreprocessedRequest, SamplingOptions, StopConditions,
    )

    t0 = time.perf_counter()
    mem_before = torch.cuda.memory_allocated()
    # chunking off: every prompt through the single-shot prefill (#3), the
    # path this phase has always measured
    engine = build_torch_engine(
        LLAMA31_8B, device="cuda", max_batch=8, max_model_len=MAX_MODEL_LEN, seed=0,
        fused_decode=False, spec_k=0, prefill_chunk_tokens=0,
    )
    torch.cuda.synchronize()
    runner = engine.runner
    wbytes = sum(t.numel() * t.element_size() for t in _leaves(runner.params))
    log(f"serve: engine built in {time.perf_counter() - t0:.1f} s; weights "
        f"{wbytes / 1e9:.2f} GB, KV pool {runner.num_blocks} blocks "
        f"({runner.kv_cache_bytes / 1e9:.2f} GB)")
    reqs = make_requests(np, PreprocessedRequest, SamplingOptions, StopConditions)

    async def serve():
        try:
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            first = await run_requests(engine, reqs, Context)
            wall = time.perf_counter() - t1
            stats = copy.deepcopy(vars(engine.stats))
            launches = kernels.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            # the same requests again: must repeat, and time the engine warm
            # (the first run pays one-time set-up: library handles on the
            # engine's worker thread, first use of each matmul shape)
            t1 = time.perf_counter()
            second = await run_requests(engine, reqs, Context)
            return first, second, wall, time.perf_counter() - t1, stats, launches, peak
        finally:
            await engine.close()

    first, second, wall, wall_warm, stats, launches, peak = asyncio.run(serve())
    vocab = LLAMA31_8B["vocab_size"]
    pen_toks, pen_reason = first[PENALIZED][0], first[PENALIZED][1]
    if len(pen_toks) < MIN_TOKENS or pen_reason not in (FinishReason.LENGTH, FinishReason.EOS):
        raise SmokeError(f"penalised request: {len(pen_toks)} tokens, reason {pen_reason}; "
                         f"expected at least min_tokens {MIN_TOKENS}")
    log(f"serve: the penalised request ({PENALTIES}, min_tokens {MIN_TOKENS}) streamed "
        f"{len(pen_toks)} tokens, reason {pen_reason.value}")
    for i, ((toks, reason, _), req) in enumerate(zip(first, reqs)):
        if i == PENALIZED:
            if not all(0 <= t < vocab for t in toks) or second[i][0] != toks:
                raise SmokeError("penalised request: bad ids, or the repeat differed")
            continue
        if reason is not FinishReason.LENGTH or len(toks) != req.stop.max_tokens:
            raise SmokeError(
                f"request {i}: {len(toks)} tokens, reason {reason}; expected "
                f"{req.stop.max_tokens} and length"
            )
        if not all(0 <= t < vocab for t in toks):
            raise SmokeError(f"request {i}: token id outside the vocab")
        if second[i][0] != toks:
            raise SmokeError(f"request {i}: the repeated run gave other tokens")
    n_layers = runner.config.num_layers
    want = {
        **dict.fromkeys(kernels.KERNELS, 0),  # spec and fused decode are off
        "paged_decode_attention": n_layers * stats["decode_steps"],
        "flash_prefill_attention": n_layers * stats["prefills"],
    }
    if launches != want:
        raise SmokeError(f"kernel launches {launches} != 32 x steps {want}")
    # the shortest and the longest prompt, both greedy
    gap = max(reference_check(torch, runner, reqs[i].token_ids, first[i][0]) for i in (0, -1))
    out_tokens = sum(len(t) for t, _, _ in first)
    res = {
        "requests": len(reqs), "prompt_lens": PROMPT_LENS, "max_tokens": MAX_TOKENS,
        "stats": stats, "launches": launches, "wall_s": wall,
        "output_tok_per_s": out_tokens / wall,
        "ttft_s_concurrent": [t for _, _, t in first],
        "wall_s_warm": wall_warm, "output_tok_per_s_warm": out_tokens / wall_warm,
        "ttft_s_concurrent_warm": [t for _, _, t in second],
        "peak_mem_bytes": peak, "engine_peak_mem_bytes": peak - mem_before,
        "reference_max_logit_gap": gap,
        "penalized_request": {"sampling": PENALTIES, "min_tokens": MIN_TOKENS,
                              "tokens": len(pen_toks), "reason": pen_reason.value},
    }
    log(f"serve: {len(reqs)} requests ({out_tokens} tokens) in {wall:.2f} s "
        f"({wall_warm:.2f} s warm); "
        f"{stats['prefills']} prefills, {stats['decode_steps']} decode steps; "
        f"launches {launches}; repeat identical; reference gap {gap:.3f}")
    print(json.dumps({"serve": res, "card": card}), flush=True)
    res["engine"] = engine
    return res


SPEC_K = 3
SPEC_MAX_TOKENS = 64
# one drafting lane of eight is enough for a verify dispatch: at B=8 the
# card is weight-bound, so scoring S=4 positions per lane costs about what
# one plain step costs (the JAX engine's advice for such chips)
SPEC_COVERAGE = 0.125
SPEC_KERNELS = ("paged_verify_attention", "fused_qkv_rope", "fused_attn_out_residual")


async def repeating_prompts(np, engine, PreprocessedRequest, SamplingOptions, StopConditions,
                            Context):
    """Quoting traffic for the n-gram drafter: per request, random filler,
    then a numpy-seeded 32-128-token segment s followed by the model's own
    greedy continuation of it, 2-4 times over, ending on s again. Each
    continuation is generated (by `engine`, spec off) in the context of the
    copies before it, so the text after the last s is what the model says
    there and the drafter finds it earlier in the prompt. 400-1500 tokens
    per prompt."""
    rng = np.random.default_rng(2)
    vocab = LLAMA31_8B["vocab_size"]
    plans = []
    for _ in range(8):
        seg = rng.integers(0, vocab, int(rng.integers(32, 129))).tolist()
        copies = int(rng.integers(2, 5))
        body = copies * len(seg) + (copies - 1) * SPEC_MAX_TOKENS
        fill = max(0, int(rng.integers(400, 1501)) - body)
        plans.append([rng.integers(0, vocab, fill).tolist(), seg, copies])
    prompts = [fill + seg for fill, seg, _ in plans]

    def greedy(p):
        return PreprocessedRequest(
            token_ids=p, sampling=SamplingOptions(greedy=True),
            stop=StopConditions(max_tokens=SPEC_MAX_TOKENS), eos_token_ids=[],
        )

    for rnd in range(max(c for _, _, c in plans) - 1):
        live = [i for i, (_, _, c) in enumerate(plans) if rnd < c - 1]
        outs = await run_requests(engine, [greedy(prompts[i]) for i in live], Context)
        for i, (toks, _, _) in zip(live, outs):
            prompts[i] = prompts[i] + toks + plans[i][1]
    reqs = [greedy(p) for p in prompts]
    reqs[SAMPLED].sampling = SamplingOptions(temperature=0.8, top_p=0.95, top_k=50, seed=1234)
    return reqs


def phase_serve_spec(torch, np, card: str, params) -> dict:
    """The spec + fused path: TorchEngine with fused_decode and spec_k=3
    over the serve phase's weights (shared, not copied), on repeating
    traffic; and the same traffic through a spec-off engine, for tokens/s
    with spec off and on."""
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.ops import kernels
    from dynamo_tpu_torch.protocols.common import (
        Context, FinishReason, PreprocessedRequest, SamplingOptions, StopConditions,
    )

    def build(spec_k):
        return build_torch_engine(
            LLAMA31_8B, device="cuda", max_batch=8, max_model_len=MAX_MODEL_LEN,
            seed=0, fused_decode=True, spec_k=spec_k, params=params,
            spec_min_coverage=SPEC_COVERAGE, prefill_chunk_tokens=0,
        )

    plain, spec = build(0), build(SPEC_K)

    async def serve():
        try:
            t0 = time.perf_counter()
            reqs = await repeating_prompts(np, plain, PreprocessedRequest, SamplingOptions,
                                           StopConditions, Context)
            log(f"serve_spec: repeating traffic built in {time.perf_counter() - t0:.1f} s; "
                f"prompt lengths {[len(r.token_ids) for r in reqs]}")
            kernels.reset_launch_counts()
            t1 = time.perf_counter()
            first = await run_requests(spec, reqs, Context)
            wall = time.perf_counter() - t1
            stats = copy.deepcopy(vars(spec.stats))
            launches = kernels.launch_counts()
            # warm: the same traffic through spec off, spec on, spec on,
            # spec off (the host's speed drifts; the pairs straddle it)
            walls = {"off": [], "on": []}
            outs = {}
            for name, eng in (("off", plain), ("on", spec), ("on", spec), ("off", plain)):
                t1 = time.perf_counter()
                outs[name] = await run_requests(eng, reqs, Context)
                walls[name].append(time.perf_counter() - t1)
            return reqs, first, outs, wall, walls, stats, launches
        finally:
            await spec.close()
            await plain.close()

    reqs, first, outs, wall, walls, stats, launches = asyncio.run(serve())
    lens = [len(r.token_ids) for r in reqs]
    for i, ((toks, reason, _), req) in enumerate(zip(first, reqs)):
        if reason is not FinishReason.LENGTH or len(toks) != SPEC_MAX_TOKENS:
            raise SmokeError(f"spec request {i}: {len(toks)} tokens, reason {reason}")
    if outs["on"][SAMPLED][0] != first[SAMPLED][0]:
        raise SmokeError("spec: the seeded sampled request did not repeat")
    if stats["verify_steps"] < 4:
        raise SmokeError(f"spec: only {stats['verify_steps']} verify dispatches (want >= 4): {stats}")
    L, steps = spec.runner.config.num_layers, stats["decode_steps"]
    verify = stats["verify_steps"]
    want = {
        **dict.fromkeys(kernels.KERNELS, 0),  # the int8 modes: not on this path
        "paged_decode_attention": L * steps,
        "flash_prefill_attention": L * stats["prefills"],
        "paged_verify_attention": L * verify,
        "fused_qkv_rope": L * (steps + verify),
        "fused_attn_out_residual": L * (steps + verify),
    }
    if launches != want:
        raise SmokeError(f"spec: kernel launches {launches} != 32 x dispatches {want}")
    # every greedy lane's first 32 tokens, most of them from verify
    # dispatches, against a dense reference of the same weights
    gap = max(
        reference_check(torch, spec.runner, reqs[i].token_ids, first[i][0], n_check=32)
        for i in range(len(reqs)) if i != SAMPLED
    )
    out_tokens = len(reqs) * SPEC_MAX_TOKENS
    same = sum(a[0] == b[0] for a, b in zip(outs["on"], outs["off"]))
    # bf16: spec on and off round differently (verify vs decode attention,
    # 32- vs 8-row products), so a near-tie may flip and the lane diverge
    prefix = []
    for a, b in zip(outs["on"], outs["off"]):
        n = 0
        while n < min(len(a[0]), len(b[0])) and a[0][n] == b[0][n]:
            n += 1
        prefix.append(n)
    rate = {k: out_tokens / statistics.median(v) for k, v in walls.items()}
    res = {
        "requests": len(reqs), "prompt_lens": lens, "max_tokens": SPEC_MAX_TOKENS,
        "spec_k": SPEC_K, "stats": stats, "launches": launches, "wall_s_cold": wall,
        "wall_s_warm": walls, "output_tok_per_s_warm": rate,
        "acceptance": stats["num_accepted_tokens"] / max(1, stats["num_draft_tokens"]),
        "tokens_per_verify_lane": (stats["num_accepted_tokens"] + stats["num_drafts"])
        / max(1, stats["num_drafts"]),
        "requests_identical_spec_on_off": same, "common_prefix_spec_on_off": prefix,
        "reference_max_logit_gap": gap,
    }
    log(f"serve_spec: {verify} verify dispatches, {steps} plain decode steps, "
        f"{stats['prefills']} prefills; drafts {stats['num_drafts']} "
        f"({stats['num_draft_tokens']} tokens), accepted {stats['num_accepted_tokens']} "
        f"per position {stats['accepted_per_pos']}; launches {launches}; "
        f"warm tokens/s off {rate['off']:.1f} on {rate['on']:.1f}; "
        f"{same}/8 requests identical spec on/off (common prefixes {prefix}); "
        f"reference gap {gap:.3f} over 32 tokens of each greedy lane")
    print(json.dumps({"serve_spec": res, "card": card}), flush=True)
    res["runner"] = spec.runner
    return res


# --------------------------------------------------- default admission path


def phase_serve_default(torch, np, card: str, params) -> dict:
    """The reference's default single-worker path: build_torch_engine with
    its defaults over the serve phase's weights (shared), the same 8
    requests (16-2000 tokens; prompts of up to 512 tokens are packed, the
    others chunked, 512 tokens at a time, two chunks per mixed step)."""
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.ops import kernels
    from dynamo_tpu_torch.protocols.common import (
        Context, FinishReason, PreprocessedRequest, SamplingOptions, StopConditions,
    )

    engine = build_torch_engine(
        LLAMA31_8B, device="cuda", max_batch=8, max_model_len=MAX_MODEL_LEN, seed=0,
        fused_decode=False, spec_k=0, params=params,
    )
    runner = engine.runner
    if runner.prefill_chunk_tokens != 512 or not engine._mixed_enabled:
        raise SmokeError(f"serve_default: chunk {runner.prefill_chunk_tokens}, mixed "
                         f"{engine._mixed_enabled}; expected the defaults (512, on)")
    reqs = make_requests(np, PreprocessedRequest, SamplingOptions, StopConditions)

    async def serve():
        try:
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            first = await run_requests(engine, reqs, Context)
            wall = time.perf_counter() - t1
            stats = copy.deepcopy(vars(engine.stats))
            launches = kernels.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            t1 = time.perf_counter()
            second = await run_requests(engine, reqs, Context)
            return first, second, wall, time.perf_counter() - t1, stats, launches, peak
        finally:
            await engine.close()

    first, second, wall, wall_warm, stats, launches, peak = asyncio.run(serve())
    vocab = LLAMA31_8B["vocab_size"]
    for i, ((toks, reason, _), req) in enumerate(zip(first, reqs)):
        if i == PENALIZED:
            ok = len(toks) >= MIN_TOKENS and reason in (FinishReason.LENGTH, FinishReason.EOS)
        else:
            ok = reason is FinishReason.LENGTH and len(toks) == req.stop.max_tokens
        if not ok or not all(0 <= t < vocab for t in toks):
            raise SmokeError(f"serve_default request {i}: {len(toks)} tokens, reason {reason}")
        if second[i][0] != toks:
            raise SmokeError(f"serve_default request {i}: the repeated run gave other tokens")
    if stats["mixed_steps"] <= 0 or stats["packed_prefills"] <= 0 or stats["prefills"]:
        raise SmokeError(f"serve_default: did not pack and mix: {stats}")
    L = runner.config.num_layers
    want = {**dict.fromkeys(kernels.KERNELS, 0),
            "paged_decode_attention": L * (stats["decode_steps"] + stats["mixed_steps"])}
    if launches != want:
        raise SmokeError(f"serve_default: kernel launches {launches} != {want}")
    # the shortest (packed) and the longest (chunked) prompt, both greedy
    gap = max(reference_check(torch, runner, reqs[i].token_ids, first[i][0]) for i in (0, -1))
    out_tokens = sum(len(t) for t, _, _ in first)
    res = {
        "requests": len(reqs), "prompt_lens": PROMPT_LENS, "stats": stats,
        "launches": launches, "wall_s": wall, "output_tok_per_s": out_tokens / wall,
        "ttft_s_concurrent": [t for _, _, t in first], "wall_s_warm": wall_warm,
        "output_tok_per_s_warm": out_tokens / wall_warm,
        "ttft_s_concurrent_warm": [t for _, _, t in second], "peak_mem_bytes": peak,
        "reference_max_logit_gap": gap, "chunk": runner.prefill_chunk_tokens,
        "chunk_budget": engine._chunk_budget,
    }
    log(f"serve_default: {len(reqs)} requests ({out_tokens} tokens) in {wall:.2f} s "
        f"({wall_warm:.2f} s warm); {stats['packed_prefills']} packed prefills, "
        f"{stats['chunk_steps']} chunks alone, {stats['mixed_steps']} mixed steps, "
        f"{stats['decode_steps']} decode steps; launches {launches}; repeat identical; "
        f"reference gap {gap:.3f}; peak memory {peak / 1e9:.2f} GB")
    print(json.dumps({"serve_default": res, "card": card}), flush=True)
    res["engine"] = engine
    return res


def chunked_row(torch, flush, C: int = 512, start: int = 1536) -> dict:
    """The chunked prefill attention op (a torch op on the card: the JAX
    package's is an XLA op) at C rows from position `start`, against a
    max_model_len-wide table, beside SDPA over the visible keys gathered
    beforehand (not timed) with the op's causal mask."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops import attention as A

    g = torch.Generator(device="cpu").manual_seed(7)
    nb = 2112
    kc = torch.randn(HKV, nb, BLOCK, D, generator=g).to(torch.bfloat16).cuda()
    vc = torch.randn(HKV, nb, BLOCK, D, generator=g).to(torch.bfloat16).cuda()
    q = torch.randn(C, HQ, D, generator=g).to(torch.bfloat16).cuda()
    S = start + C
    table = torch.zeros(MAX_BLOCKS, dtype=torch.int64)
    table[:S // BLOCK] = torch.randperm(nb - 1, generator=g)[:S // BLOCK] + 1
    table = table.cuda()
    t_op = time_ms(torch, lambda: A.chunked_prefill_attention(q, kc, vc, table, start),
                   reps=10, warmup=2, flush=flush)
    ks = kc[:, table[:S // BLOCK]].reshape(HKV, S, D)[None]
    vs = vc[:, table[:S // BLOCK]].reshape(HKV, S, D)[None]
    qpos = start + torch.arange(C, device="cuda")
    mask = torch.arange(S, device="cuda")[None, :] <= qpos[:, None]
    qs = q.transpose(0, 1)[None]
    t_s = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, enable_gqa=True), flush=flush)
    got = A.chunked_prefill_attention(q, kc, vc, table, start)
    want = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)
    err = compare(torch, "chunked op vs SDPA", got, want[0].transpose(0, 1), PREFILL_TOL)
    pairs = C * start + C * (C + 1) // 2
    flops = 4 * pairs * HQ * D
    nbytes = (2 * C * HQ * D + 2 * S * HKV * D) * 2 + (S // BLOCK) * 8
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return {"ms": t_op, "sdpa_pregathered_ms": t_s, "bound_ms": max(t_b, t_f) * 1e3,
            "bound_by": "bytes" if t_b >= t_f else "operations", "bytes": nbytes,
            "flops": flops, "max_abs_diff_vs_sdpa": err,
            "shape": f"C={C} chunk_start={start} Hq={HQ} Hkv={HKV} D={D} table={MAX_BLOCKS}"}


PACKED_SEGMENTS = [16, 100, 300]  # the serve phase's three short prompts


def packed_row(torch, flush, P: int = 512) -> dict:
    """The packed prefill attention op (a torch op on the card) over the
    short prompts the default path packs into one 512-row buffer, beside
    SDPA with the same block-diagonal causal mask."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops import attention as A

    q, k, v = prefill_inputs(torch, P, seed=8)
    seg = torch.full((P,), -1, dtype=torch.int64)
    off = 0
    for i, n in enumerate(PACKED_SEGMENTS):
        seg[off:off + n] = i
        off += n
    seg = seg.cuda()
    t_op = time_ms(torch, lambda: A.packed_prefill_attention(q, k, v, seg),
                   reps=10, warmup=2, flush=flush)
    pos = torch.arange(P, device="cuda")
    mask = (pos[None, :] <= pos[:, None]) & (seg[None, :] == seg[:, None])
    qs, ks, vs = (t.transpose(0, 1)[None] for t in (q, k, v))
    t_s = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, enable_gqa=True), flush=flush)
    got = A.packed_prefill_attention(q, k, v, seg)[:off]
    want = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)
    err = compare(torch, "packed op vs SDPA", got, want[0].transpose(0, 1)[:off], PREFILL_TOL)
    pairs = sum(n * (n + 1) // 2 for n in PACKED_SEGMENTS)
    flops = 4 * pairs * HQ * D
    nbytes = (2 * P * HQ * D + 2 * P * HKV * D) * 2 + P * 8
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return {"ms": t_op, "sdpa_masked_ms": t_s, "bound_ms": max(t_b, t_f) * 1e3,
            "bound_by": "bytes" if t_b >= t_f else "operations", "bytes": nbytes,
            "flops": flops, "max_abs_diff_vs_sdpa": err,
            "shape": f"P={P} segments={PACKED_SEGMENTS} Hq={HQ} Hkv={HKV} D={D}"}


def top_kernels(kernels: dict, calls: int, n: int = 8) -> list:
    """The n kernels with the most device time in a profile of `calls`
    calls: [name (cut to 100 characters), us per call, launches per call]."""
    rows = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:n]
    return [[k[:100], us / calls, c / calls] for k, (us, c) in rows]


def admission_times(torch, np, engine, card: str) -> dict:
    """The default path's TTFT of one 2000-token prompt alone through four
    512-token chunks (only the last one's sample fetched), one mixed step
    (the B=8 decode step at context 1024 plus one 512-token chunk at
    position 1536; wall around the call and its one fetch, and device time
    by profiler), and the packed and chunked attention ops."""
    runner = engine.runner
    bs, C = runner.block_size, runner.prefill_chunk_tokens
    rng = np.random.default_rng(3)
    vocab = runner.config.vocab_size
    n = 2000
    prompt = rng.integers(0, vocab, n).tolist()
    blocks = list(range(1, (n + bs - 1) // bs + 1))

    def chunked_ttft():
        for s in range(0, n, C):
            out = runner.prefill_chunk(prompt[s:s + C], s, n, blocks, 0.0, 1.0, 0)
        return runner.fetch_sample(out)

    chunked_ttft()  # warm
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        chunked_ttft()
        ts.append((time.perf_counter() - t0) * 1e3)
    dev_ms, prof = profile_calls(torch, chunked_ttft)
    ttft = {"median": statistics.median(ts), "min": min(ts), "max": max(ts),
            "chunks": -(-n // C), "device_ms": dev_ms, "top_kernels": top_kernels(prof, 5)}
    B, ctx = 8, STEP_CTX
    per = (ctx + 1 + bs - 1) // bs
    tables = np.zeros((B, runner.max_blocks_per_seq), np.int32)
    for b in range(B):
        tables[b, :per] = np.arange(1 + b * per, 1 + (b + 1) * per)
    pos = np.full(B, ctx, np.int64)
    slots = tables[np.arange(B), pos // bs].astype(np.int64) * bs + pos % bs
    toks = rng.integers(0, vocab, B)
    zeros, ones, kz = np.zeros(B, np.float32), np.ones(B, np.float32), np.zeros(B, np.int64)
    keys = np.zeros((B, 2), np.int64)
    cprompt = rng.integers(0, vocab, 2048).tolist()
    cblocks = list(range(1 + B * per, 1 + B * per + 2048 // bs))
    chunk = [(cprompt[1536:2048], 1536, 2048, cblocks, 0.0, 1.0, 0, 1.0, None, None, False)]

    def mixed():
        c_outs, d_out = runner.mixed_step(chunk, toks, pos, tables, slots, keys, zeros,
                                          ones, kz)
        return runner.fetch_sample((*c_outs[0], *d_out))

    for _ in range(3):
        mixed()
    ts = []
    for _ in range(10):
        t0 = time.perf_counter()
        mixed()
        ts.append((time.perf_counter() - t0) * 1e3)
    dev_ms, prof = profile_calls(torch, mixed)
    step = {"median": statistics.median(ts), "min": min(ts), "max": max(ts),
            "device_ms": dev_ms, "B": B, "ctx": ctx, "chunk": C, "chunk_start": 1536,
            "decode_attention": per_launch_us(prof, "true"), "top_kernels": top_kernels(prof, 5)}
    flush = make_flush(torch)
    ops = {"chunked_prefill_attention": chunked_row(torch, flush),
           "packed_prefill_attention": packed_row(torch, flush)}
    res = {"ttft_ms_alone_chunked_2000": ttft, "mixed_step_ms_B8_plus_chunk": step,
           "xla_op_ports": ops}
    print(json.dumps({"admission_time": res, "card": card}), flush=True)
    log(f"default path: 2000-token TTFT alone through {ttft['chunks']} chunks "
        f"{ttft['median']:.2f} ms wall / {ttft['device_ms']:.2f} ms device; mixed step "
        f"B=8 + one {C}-token chunk {step['median']:.2f} ms wall / {dev_ms:.2f} ms device")
    for name, row in ops.items():
        yard = row.get("sdpa_pregathered_ms") or row.get("sdpa_masked_ms")
        log(f"{name} (torch op) {row['shape']}: {row['ms']['median']:.4f} ms, bound "
            f"{row['bound_ms']:.5f} ms ({row['bound_by']}), SDPA {yard['median']:.4f} ms")
    return res


# ---------------------------------------------------------------- checkpoint


SAFETENSORS_DTYPES = {"torch.bfloat16": "BF16", "torch.float16": "F16", "torch.float32": "F32"}


def write_safetensors(torch, path: str, tensors: dict) -> None:
    """Write CPU tensors in the safetensors format with the standard library:
    an 8-byte little-endian header length, the JSON header (dtype, shape,
    data_offsets), then each tensor's raw little-endian bytes."""
    header, off = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": SAFETENSORS_DTYPES[str(t.dtype)], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for t in tensors.values():
            f.write(t.contiguous().view(torch.uint8).numpy().data)


def hf_checkpoint_tensors(torch, params: dict, layers: int) -> dict:
    """The port's parameters under HF Llama names, [out, in] projections
    (transposed on the card), moved to the host."""
    out = {"model.embed_tokens.weight": params["embed"],
           "model.norm.weight": params["final_norm"],
           "lm_head.weight": params["lm_head"].t()}
    names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
             "wo": "self_attn.o_proj", "wg": "mlp.gate_proj", "wu": "mlp.up_proj",
             "wd": "mlp.down_proj"}
    for i in range(layers):
        layer, p = params["layers"][i], f"model.layers.{i}."
        out[p + "input_layernorm.weight"] = layer["attn_norm"]
        out[p + "post_attention_layernorm.weight"] = layer["mlp_norm"]
        for key, name in names.items():
            out[f"{p}{name}.weight"] = layer[key].t()
    return {k: v.contiguous().cpu() for k, v in out.items()}


CKPT_LAYERS = 2
CKPT_PROMPTS = [(16, 24), (600, 16), (100, 24)]  # (prompt tokens, max tokens)


def phase_checkpoint(torch, np, card: str) -> dict:
    """A 2-layer, full-width bf16 Llama-3.1-8B checkpoint (random weights
    from a seed, norm weights perturbed so that a lost norm shows) written
    with write_safetensors in two shards, loaded through build_torch_engine
    (<dir>); its weights must equal the written ones bit for bit, and its
    greedy tokens an engine's built from the same arrays through params=."""
    import shutil

    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.engine.torch_engine.weights import init_params
    from dynamo_tpu_torch.models.llama import LlamaConfig
    from dynamo_tpu_torch.protocols.common import (
        Context, PreprocessedRequest, SamplingOptions, StopConditions,
    )

    hf = dict(LLAMA31_8B, num_hidden_layers=CKPT_LAYERS)
    cfg = LlamaConfig.from_hf_dict(hf)
    params = init_params(cfg, seed=5, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(6)
    norms = [params["final_norm"]] + [
        layer[k] for layer in params["layers"] for k in ("attn_norm", "mlp_norm")]
    for norm in norms:
        norm.add_(0.1 * torch.randn(norm.shape, generator=gen, device="cuda").to(norm.dtype))
    model_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                             "chip_smoke_checkpoint")
    shutil.rmtree(model_dir, ignore_errors=True)
    os.makedirs(model_dir)
    try:
        t0 = time.perf_counter()
        tensors = hf_checkpoint_tensors(torch, params, CKPT_LAYERS)
        names = list(tensors)
        for i in range(2):
            shard = os.path.join(model_dir, f"model-0000{i + 1}-of-00002.safetensors")
            write_safetensors(torch, shard, {n: tensors[n] for n in names[i::2]})
        with open(os.path.join(model_dir, "config.json"), "w") as f:
            json.dump(hf, f)
        nbytes = sum(t.numel() * t.element_size() for t in tensors.values())
        del tensors
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = build_torch_engine(model_dir, device="cuda", max_batch=4, max_model_len=1024)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        same = build_torch_engine(hf, device="cuda", max_batch=4, max_model_len=1024,
                                  params=params)
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    def flat(tree, path=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items() for k2, v2 in flat(v, f"{path}/{k}").items()}
        if isinstance(tree, list):
            return {k2: v2 for i, v in enumerate(tree) for k2, v2 in flat(v, f"{path}/{i}").items()}
        return {path: tree}

    a, b = flat(loaded.runner.params), flat(params)
    if sorted(a) != sorted(b) or not all(
            a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in b):
        raise SmokeError("checkpoint: the loaded weights differ from the written ones")
    rng = np.random.default_rng(9)
    reqs = [PreprocessedRequest(token_ids=rng.integers(0, cfg.vocab_size, n).tolist(),
                                sampling=SamplingOptions(greedy=True),
                                stop=StopConditions(max_tokens=m), eos_token_ids=[])
            for n, m in CKPT_PROMPTS]

    async def serve(engine):
        try:
            return await run_requests(engine, reqs, Context)
        finally:
            await engine.close()

    got = asyncio.run(serve(loaded))
    want = asyncio.run(serve(same))
    if [t for t, _, _ in got] != [t for t, _, _ in want]:
        raise SmokeError("checkpoint: the loaded engine's tokens differ from params=")
    if [len(t) for t, _, _ in got] != [m for _, m in CKPT_PROMPTS]:
        raise SmokeError("checkpoint: wrong token counts")
    res = {"layers": CKPT_LAYERS, "bytes": nbytes, "write_s": t_write, "load_s": t_load,
           "prompts": CKPT_PROMPTS, "stats": vars(loaded.stats)}
    log(f"checkpoint: {nbytes / 1e9:.2f} GB in 2 shards written in {t_write:.1f} s, loaded "
        f"by build_torch_engine(<dir>) in {t_load:.1f} s; weights bit-identical; greedy "
        f"tokens equal params= over {len(reqs)} requests")
    print(json.dumps({"checkpoint": res, "card": card}), flush=True)
    return res


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def profile_calls(torch, fn, calls: int = 5) -> tuple[float, dict]:
    """Device time of one fn() call -- the CUDA kernels' total under
    torch.profiler over `calls` calls, per call -- and each kernel's
    (total us, launches) over them. Only the device events count: a CPU
    op's entry repeats the time of the kernels it launched. The profiler
    can drop a session's first device record (seen on the H100): a spin
    kernel goes first and is left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        for _ in range(calls):
            fn()
    kernels = {
        e.key: (getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0),
                e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key
    }
    return sum(us for us, _ in kernels.values()) / 1e3 / calls, kernels


def device_ms_per_call(torch, fn, calls: int = 5) -> float:
    return profile_calls(torch, fn, calls)[0]


def host_ms(torch, fn, reps: int = 20) -> float:
    """Median host time of one fn() call (launching, not waiting), each
    call started with the card idle."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def host_ops(torch, fn, calls: int = 3, n: int = 12) -> dict:
    """torch.profiler's CPU self time per op over `calls` fn() calls, per
    call: the total and the n largest ops (name, ms, calls). The profiler's
    own bookkeeping per op inflates these; compare them only with each
    other."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {"self_cpu_ms": sum(e.self_cpu_time_total for e in ev) / 1e3 / calls,
            "top": [[e.key, e.self_cpu_time_total / 1e3 / calls, e.count // calls]
                    for e in ev[:n]]}


def per_launch_us(kernels: dict, mode: str, int8: bool = False) -> dict:
    """Per-launch device time of the paged attention template's decode
    (mode "true") or verify ("false") instantiation, bf16 or int8 mode, in a
    profile."""
    us = n = 0
    tag = f", {mode}, {'true' if int8 else 'false'}>"
    for key, (t, c) in kernels.items():
        if "paged_attention_kernel<" in key and tag in key:
            us, n = us + t, n + c
    return {"us_per_launch": us / n if n else None, "launches": n}


# #4's kernels: the one launch of the cluster design, and the earlier
# design's three (norm, split-K product, combine + RoPE epilogue), so
# profiles of either design compare
QKV_KERNELS = ("fused_qkv_rope_kernel", "rmsnorm_rows", "splitk_gemm_kernel", "qkv_epilogue")


def qkv_head_us(kernels: dict, calls: int, layers: int) -> dict:
    """#4's device time per layer in a profile of `calls` steps, summed over
    all its launches, and its launches per layer."""
    us = n = 0
    for key, (t, c) in kernels.items():
        if any(name in key for name in QKV_KERNELS):
            us, n = us + t, n + c
    per = calls * layers
    return {"us_per_layer": us / per if n else None, "launches_per_layer": n / per}


def phase_engine_times(torch, np, engine, fused_runner, card: str) -> dict:
    """TTFT per prompt length (one request alone, prefill + first sample +
    fetch) and the B=8 decode step (model + sampling + fetch), host clock
    around work that ends in a device-to-host copy; the step with the fused
    heads off (`engine`'s runner) and on (`fused_runner`, the same weights),
    in turns off, on, on, off, with the device time of each."""
    runner = engine.runner
    bs = runner.block_size
    rng = np.random.default_rng(1)
    vocab = runner.config.vocab_size
    ttft = {}
    for n in (16, 128, 512, 2000):
        prompt = rng.integers(0, vocab, n).tolist()
        blocks = list(range(1, (n + bs - 1) // bs + 1))
        runner.fetch_sample(runner.prefill(prompt, blocks, 0.0, 1.0, 0))  # warm
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            runner.fetch_sample(runner.prefill(prompt, blocks, 0.0, 1.0, 0))
            ts.append((time.perf_counter() - t0) * 1e3)
        ttft[n] = {"median": statistics.median(ts), "min": min(ts), "max": max(ts)}
    # device time of the last (longest) prompt's prefill: all its kernels,
    # by profiler
    ttft[2000]["device_ms"] = device_ms_per_call(
        torch, lambda: runner.fetch_sample(runner.prefill(prompt, blocks, 0.0, 1.0, 0)))
    B, ctx = 8, STEP_CTX
    per = (ctx + 1 + bs - 1) // bs
    tables = np.zeros((B, runner.max_blocks_per_seq), np.int32)
    for b in range(B):
        tables[b, :per] = np.arange(1 + b * per, 1 + (b + 1) * per)
    pos = np.full(B, ctx, np.int64)
    slots = tables[np.arange(B), pos // bs].astype(np.int64) * bs + pos % bs
    toks = rng.integers(0, vocab, B)
    zeros, ones = np.zeros(B, np.float32), np.ones(B, np.float32)
    kz = np.zeros(B, np.int64)

    def step(r):
        return r.fetch_sample(r.decode(toks, pos, tables, slots, zeros, ones, kz))

    runners = {"unfused": runner, "fused": fused_runner}
    walls = {"unfused": [], "fused": []}
    for name in ("unfused", "fused", "fused", "unfused"):
        r = runners[name]
        for _ in range(3):
            step(r)
        for _ in range(10):
            t0 = time.perf_counter()
            step(r)
            walls[name].append((time.perf_counter() - t0) * 1e3)
    decode = {}
    layers = runner.config.num_layers
    for name, r in runners.items():
        ts = walls[name]
        dev_ms, prof = profile_calls(torch, lambda: step(r))
        decode[name] = {
            "median": statistics.median(ts), "min": min(ts), "max": max(ts),
            "device_ms": dev_ms, "B": B, "ctx": ctx,
            "decode_attention": per_launch_us(prof, "true"),
            "qkv_head": qkv_head_us(prof, 5, layers),
        }
    # one B=8, S=4 fused verify dispatch at the same context: each lane
    # re-feeds its token at position 1024 and scores 3 drafts after it
    drafts = rng.integers(0, vocab, (B, 3))
    many = np.full(B, 1 << 20, np.int64)

    def verify():
        return fused_runner.spec_verify(
            3, 0, toks, drafts, np.full(B, 3), pos, tables, zeros, ones, kz,
            np.zeros((B, 2), np.int64), np.ones(B, bool), many).cpu()

    verify()
    dev_ms, prof = profile_calls(torch, verify)
    verify_step = {"device_ms": dev_ms, "B": B, "S": 4, "ctx": ctx,
                   "verify_attention": per_launch_us(prof, "false"),
                   "qkv_head": qkv_head_us(prof, 5, layers)}
    # where a fused decode step's device time goes (torch.profiler, by kernel)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            step(fused_runner)
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12), flush=True)
    res = {
        "ttft_ms_alone": ttft, "decode_step_ms_B8": decode, "verify_dispatch_B8_S4": verify_step,
        "decode_output_tok_per_s_B8": {k: B / (v["median"] / 1e3) for k, v in decode.items()},
    }
    print(json.dumps({"engine_time": res, "card": card}), flush=True)
    log("TTFT alone: " + "; ".join(f"{n} tokens {v['median']:.2f} ms" for n, v in ttft.items())
        + f"; 2000-token prefill device time {ttft[2000]['device_ms']:.2f} ms")
    log(f"decode step B=8 ctx 1024: unfused {decode['unfused']['median']:.2f} ms wall / "
        f"{decode['unfused']['device_ms']:.2f} ms device; fused "
        f"{decode['fused']['median']:.2f} ms wall / {decode['fused']['device_ms']:.2f} ms device; "
        f"decode attention per launch: unfused "
        f"{decode['unfused']['decode_attention']['us_per_launch']} us, fused "
        f"{decode['fused']['decode_attention']['us_per_launch']} us; fused QKV head (#4) "
        f"{decode['fused']['qkv_head']['us_per_layer']} us per layer in "
        f"{decode['fused']['qkv_head']['launches_per_layer']} launch(es)")
    log(f"verify dispatch B=8 S=4 ctx 1024: {verify_step['device_ms']:.3f} ms device; "
        f"verify attention {verify_step['verify_attention']['us_per_launch']} us per launch; "
        f"fused QKV head (#4) {verify_step['qkv_head']['us_per_layer']} us per layer")
    return res


# ------------------------------------------------------------------- int8
#
# The JAX package's int8 deployment (DYN_JAX_QUANTIZE_INT8=1,
# DYN_KV_DTYPE=int8): int8 weight-only dense projections and an
# int8-resident paged KV cache, through the int8 modes of #1, #2, #4, #5.

INT8_KERNELS = ("paged_decode_attention_int8", "paged_verify_attention_int8",
                "fused_qkv_rope_int8", "fused_attn_out_residual_int8")
# the int8 engine's dense reference attends the unquantized K/V of the same
# int8 weights, so its logits carry the cache's quantization noise on top of
# bf16's: the engine's greedy token must lie within this of the best. The
# largest gap read on an H100 80GB HBM3 was 0.125 (the spec leg); the bf16
# engines read 0.031-0.062 against reference_check's default bound of 0.25
INT8_REF_GAP = 0.5


def int8_pages(torch, cache):
    """A bf16 cache [Hkv, nb, bs, D] quantized the way the engine's
    prefill writes it (each (head, page)'s exact absmax, so every page has
    its own scale): (int8 mantissas, f32 scales [Hkv, nb])."""
    from dynamo_tpu_torch.ops import kv_quant

    layer = kv_quant.make_cache(tuple(cache.shape), cache.dtype, quantized=True,
                                device=cache.device)
    kv_quant.write_blocks_quant(layer, cache, torch.arange(cache.shape[1], device=cache.device))
    return layer["q"], layer["s"]


def int8_weights(t: dict) -> dict:
    """gemv_inputs' weights quantized as the engine quantizes them."""
    from dynamo_tpu_torch.ops.linear import quantize_int8

    return dict(t, **{k: quantize_int8(t[k]) for k in ("wq", "wk", "wv", "wo")})


def phase_parity_int8(torch) -> dict:
    """Each int8 mode against its plain version on the same int8 inputs:
    #1q / #2q at Llama-3.1-8B, Qwen2-7B (G 7) and Gemma-2-9B (D 256) heads
    with the window and scale / softcap cases, contexts that cross pages
    (each page its own scale), at DECODE_TOL; #4q at those widths and #5q
    at Llama width, M = 8 and 32, at GEMV_TOL."""
    from dynamo_tpu_torch.ops import attention as A
    from dynamo_tpu_torch.ops import cuda_attention as K
    from dynamo_tpu_torch.ops import cuda_linear as KL
    from dynamo_tpu_torch.ops import linear as L

    errs = dict.fromkeys(INT8_KERNELS, 0.0)

    def check(kernel, label, got, want, tol):
        torch.cuda.synchronize()
        e = compare(torch, label, got, want, tol)
        errs[kernel] = max(errs[kernel], e)
        log(f"parity {label}: max|d|={e:.3e} (tol {tol[0]:g} + {tol[1]:g}|x|)")

    shapes = {"llama31_8b": (HQ, HKV, D, HIDDEN), **HEAD_SHAPES}
    for name, (hq, hkv, d, hidden) in shapes.items():
        shp = dict(hq=hq, hkv=hkv, d=d)
        tag = f"{name} Hq={hq} Hkv={hkv} D={d}"
        q, k, v, tables, lens = decode_inputs(torch, DECODE_LENS, seed=60, **shp)
        (kq, ks), (vq, vs) = int8_pages(torch, k), int8_pages(torch, v)
        del k, v
        for case, kw in DECODE_CASES:
            check("paged_decode_attention_int8", f"int8 decode/{case} {tag}",
                  K.paged_decode_attention_int8_cuda(q, kq, vq, tables, lens, ks, vs, **kw),
                  A.paged_decode_attention_plain(q, kq, vq, tables, lens, k_scales=ks,
                                                 v_scales=vs, **kw), DECODE_TOL)
        q, k, v, tables, pos = verify_inputs(torch, VERIFY_BASES, VERIFY_DRAFT_LENS, VERIFY_S,
                                             seed=61, **shp)
        (kq, ks), (vq, vs) = int8_pages(torch, k), int8_pages(torch, v)
        del k, v
        for case, kw in DECODE_CASES:
            check("paged_verify_attention_int8", f"int8 verify/{case} {tag}",
                  K.paged_verify_attention_int8_cuda(q, kq, vq, tables, pos, ks, vs, **kw),
                  A.paged_verify_attention_plain(q, kq, vq, tables, pos, k_scales=ks,
                                                 v_scales=vs, **kw), DECODE_TOL)
        for M in (8, 32):
            t = int8_weights(gemv_inputs(torch, M, seed=70 + M, bias=name == "qwen2_7b",
                                         hidden=hidden, **shp))
            got = qkv_call(KL.fused_qkv_rope_int8_cuda, t)
            want = qkv_call(L.fused_qkv_rope_plain, t)
            for n, a, b in zip("qkv", got, want):
                check("fused_qkv_rope_int8", f"int8 qkv/M{M}/{n} {tag} hidden={hidden}", a, b,
                      GEMV_TOL)
            if name == "llama31_8b":
                check("fused_attn_out_residual_int8", f"int8 out/M{M} {tag}",
                      KL.fused_attn_out_residual_int8_cuda(t["attn"], t["wo"], t["x"]),
                      L.fused_attn_out_residual_plain(t["attn"], t["wo"], t["x"]), GEMV_TOL)
    return errs


def dequantized(torch, pages, scales):
    """bf16 K / V from int8 pages (what the library call is given: the
    dequantization is not timed)."""
    return (pages.float() * scales[..., None, None]).to(torch.bfloat16)


def int8_attention_times(torch, flush) -> dict:
    """#1q at chip_smoke's ragged contexts and at the B=8 step's shape, and
    #2q at the verify shape: kernel, plain, and SDPA over the same keys
    gathered and dequantized to bf16 beforehand (not timed)."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops import attention as A
    from dynamo_tpu_torch.ops import cuda_attention as K

    rows = {}
    for name, lens in (("paged_decode_attention_int8", DECODE_LENS),
                       ("paged_decode_attention_int8/step", [STEP_CTX + 1] * 8)):
        q, k, v, tables, lens_t = decode_inputs(torch, lens, seed=62)
        (kq, ks), (vq, vs) = int8_pages(torch, k), int8_pages(torch, v)
        kd, vd = dequantized(torch, kq, ks), dequantized(torch, vq, vs)
        del k, v
        t_k = time_ms(torch, lambda: K.paged_decode_attention_int8_cuda(
            q, kq, vq, tables, lens_t, ks, vs), flush=flush)
        t_p = time_ms(torch, lambda: A.paged_decode_attention_plain(
            q, kq, vq, tables, lens_t, k_scales=ks, v_scales=vs), reps=5, flush=flush)
        B, S = len(lens), max(lens)
        kg = torch.zeros(B, HKV, S, D, dtype=torch.bfloat16, device="cuda")
        vg = torch.zeros_like(kg)
        for b, n in enumerate(lens):
            pages = tables[b, : (n + BLOCK - 1) // BLOCK].long()
            kg[b, :, :n] = kd[:, pages].reshape(HKV, -1, D)[:, :n]
            vg[b, :, :n] = vd[:, pages].reshape(HKV, -1, D)[:, :n]
        mask = (torch.arange(S, device="cuda")[None, :] < lens_t[:, None].long())[:, None, None, :]
        qd = q[:, :, None, :]
        t_s = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qd, kg, vg, attn_mask=mask, enable_gqa=True), flush=flush)
        b_ms, b_by, nbytes, flops = decode_bound(lens, B, kv_bytes=1)
        rows[name] = {
            "ms": t_k, "plain_ms": t_p, "library_ms": t_s, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": flops,
            "library": "SDPA over the keys gathered and dequantized to bf16 beforehand, "
                       "length mask, enable_gqa",
            "shape": f"B={B} Hq={HQ} Hkv={HKV} D={D} block={BLOCK} int8 pages, lens "
                     f"{lens if len(set(lens)) > 1 else f'{B} x {lens[0]}'}",
        }
    S_, bases = VERIFY_S, VERIFY_BASES
    q, k, v, tables, pos = verify_inputs(torch, bases, [S_ - 1] * len(bases), S_, seed=63)
    (kq, ks), (vq, vs) = int8_pages(torch, k), int8_pages(torch, v)
    kd, vd = dequantized(torch, kq, ks), dequantized(torch, vq, vs)
    del k, v
    t_k = time_ms(torch, lambda: K.paged_verify_attention_int8_cuda(
        q, kq, vq, tables, pos, ks, vs), flush=flush)
    t_p = time_ms(torch, lambda: A.paged_verify_attention_plain(
        q, kq, vq, tables, pos, k_scales=ks, v_scales=vs), reps=5, flush=flush)
    ctx = max(bases) + S_
    kg = torch.zeros(len(bases), HKV, ctx, D, dtype=torch.bfloat16, device="cuda")
    vg = torch.zeros_like(kg)
    for b, p in enumerate(bases):
        n = p + S_
        pages = tables[b, : (n + BLOCK - 1) // BLOCK].long()
        kg[b, :, :n] = kd[:, pages].reshape(HKV, -1, D)[:, :n]
        vg[b, :, :n] = vd[:, pages].reshape(HKV, -1, D)[:, :n]
    mask = torch.arange(ctx, device="cuda")[None, None, :] <= pos.long()[:, :, None]
    t_s = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), kg, vg, attn_mask=mask[:, None], enable_gqa=True), flush=flush)
    b_ms, b_by, nbytes, flops = verify_bound(bases, S_, kv_bytes=1)
    rows["paged_verify_attention_int8"] = {
        "ms": t_k, "plain_ms": t_p, "library_ms": t_s, "bound_ms": b_ms, "bound_by": b_by,
        "bytes": nbytes, "flops": flops,
        "library": "SDPA over keys gathered and dequantized to bf16 beforehand, causal mask",
        "shape": f"B={len(bases)} S={S_} Hq={HQ} Hkv={HKV} D={D} block={BLOCK} int8 pages",
    }
    return rows


def int8_gemv_times(torch, flush) -> dict:
    """#4q and #5q at M = 8 (a decode step) and 32 (a verify step):
    kernel, plain, and the product alone over weights dequantized to bf16
    beforehand (matmul of pre-normed rows; addmm with the residual)."""
    from dynamo_tpu_torch.ops import cuda_linear as KL
    from dynamo_tpu_torch.ops import linear as L
    from dynamo_tpu_torch.ops.basics import rms_norm

    rows = {}
    eps = LLAMA31_8B["rms_norm_eps"]
    for M in (8, 32):
        t = int8_weights(gemv_inputs(torch, M, seed=80 + M))
        deq = {k: (t[k]["q"].float() * t[k]["s"].float()).to(torch.bfloat16)
               for k in ("wq", "wk", "wv", "wo")}
        wqkv = torch.cat([deq["wq"], deq["wk"], deq["wv"]], dim=1)
        xn = rms_norm(t["x"], t["norm"], eps)
        N = (HQ + 2 * HKV) * D
        t_k = time_ms(torch, lambda: qkv_call(KL.fused_qkv_rope_int8_cuda, t), flush=flush)
        t_p = time_ms(torch, lambda: qkv_call(L.fused_qkv_rope_plain, t), flush=flush)
        t_m = time_ms(torch, lambda: torch.matmul(xn, wqkv), flush=flush)
        b_ms, b_by, nbytes, flops = gemv_bound(M, HIDDEN, N, HIDDEN * 2 + M * D * 4, w_bytes=1)
        rows[f"fused_qkv_rope_int8/M{M}"] = {
            "ms": t_k, "plain_ms": t_p, "library_ms": t_m, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": flops, "ratio_to_library": t_k["median"] / t_m["median"],
            "library": "torch.matmul(xn, [wq|wk|wv]) over a pre-normed x and the weights "
                       "dequantized to bf16 beforehand: the product alone, 2 bytes a weight",
            "shape": f"M={M} hidden={HIDDEN} N={N} int8 weights",
        }
        t_k = time_ms(torch, lambda: KL.fused_attn_out_residual_int8_cuda(t["attn"], t["wo"], t["x"]),
                      flush=flush)
        t_p = time_ms(torch, lambda: L.fused_attn_out_residual_plain(t["attn"], t["wo"], t["x"]),
                      flush=flush)
        t_s = time_ms(torch, lambda: torch.addmm(t["x"], t["attn"], deq["wo"]), flush=flush)
        b_ms, b_by, nbytes, flops = gemv_bound(M, HQ * D, HIDDEN, M * HIDDEN * 2, w_bytes=1)
        rows[f"fused_attn_out_residual_int8/M{M}"] = {
            "ms": t_k, "plain_ms": t_p, "library_ms": t_s, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": flops, "ratio_to_library": t_k["median"] / t_s["median"],
            "library": "torch.addmm(x, attn, wo) over wo dequantized to bf16 beforehand",
            "shape": f"M={M} K={HQ * D} N={HIDDEN} int8 weights",
        }
    return rows


def phase_kernel_times_int8(torch, card: str) -> dict:
    flush = make_flush(torch)
    rows = {**int8_attention_times(torch, flush), **int8_gemv_times(torch, flush)}
    for name, row in rows.items():
        print(json.dumps({"kernel_time": name, "card": card, **row}), flush=True)
        log(f"{name} {row['shape']}: {row['ms']['median']:.4f} ms, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}), plain {row['plain_ms']['median']:.4f} ms, library "
            f"{row['library_ms']['median']:.4f} ms ({card})")
    return rows


def phase_serve_int8(torch, np, card: str, bf16_blocks: int, bf16_peak: int) -> dict:
    """The int8 deployment: build_torch_engine(quantize=True,
    kv_dtype="int8", fused_decode=True) at Llama-3.1-8B width on the
    default admission path (seed 0: the serve phase's bf16 draws,
    quantized), the serve phase's 8 requests; then an engine on the same
    weights built from the JAX factory's variables (DYN_JAX_QUANTIZE_INT8,
    DYN_KV_DTYPE, DYN_FUSED_DECODE, DYN_SPEC_K=3) over quoting traffic.
    The counters are set to 0 just before each run and read just after."""
    from dynamo_tpu_torch.engine.torch_engine.factory import (
        build_torch_engine, default_num_blocks, device_memory_bytes,
    )
    from dynamo_tpu_torch.models.llama import LlamaConfig
    from dynamo_tpu_torch.ops import kernels
    from dynamo_tpu_torch.protocols.common import (
        Context, FinishReason, PreprocessedRequest, SamplingOptions, StopConditions,
    )

    t0 = time.perf_counter()
    # the earlier phases' engines are still on the card: the int8 engine's
    # own peak is the peak above what they hold
    mem_before = torch.cuda.memory_allocated()
    engine = build_torch_engine(
        LLAMA31_8B, device="cuda", max_batch=8, max_model_len=MAX_MODEL_LEN, seed=0,
        quantize=True, kv_dtype="int8", fused_decode=True, spec_k=0,
    )
    torch.cuda.synchronize()
    runner = engine.runner
    build_s = time.perf_counter() - t0
    wbytes = sum(t.numel() * t.element_size() for t in _leaves(runner.params))
    if not runner.kv_quantized or runner.prefill_chunk_tokens != 512 or not engine._mixed_enabled:
        raise SmokeError("serve_int8: not the int8 cache on the default admission path")
    # the JAX factory's sizing: every lane at full context (+64) fits both
    # forms on this card; what the budget would hold shows in the caps
    cfg = LlamaConfig.from_hf_dict(LLAMA31_8B)
    budget = device_memory_bytes(runner.device)
    caps = {kv: default_num_blocks(cfg, 131072, 512, budget_bytes=budget,
                                   quantized=kv == "int8", kv_dtype=kv)
            for kv in ("bf16", "int8")}
    want_blocks = default_num_blocks(cfg, MAX_MODEL_LEN, 8, budget_bytes=budget, quantized=True,
                                     kv_dtype="int8")
    if runner.num_blocks != want_blocks:
        raise SmokeError(f"serve_int8: {runner.num_blocks} blocks, the sizing says {want_blocks}")
    log(f"serve_int8: engine built in {build_s:.1f} s; int8 weights {wbytes / 1e9:.2f} GB, KV "
        f"pool {runner.num_blocks} blocks ({runner.kv_cache_bytes / 1e9:.3f} GB; bf16 engine "
        f"{bf16_blocks} blocks); blocks the budget would hold at 512 x 131072 tokens: bf16 "
        f"{caps['bf16']}, int8 {caps['int8']}")
    reqs = make_requests(np, PreprocessedRequest, SamplingOptions, StopConditions)
    spec_env = {"DYN_JAX_QUANTIZE_INT8": "1", "DYN_KV_DTYPE": "int8", "DYN_FUSED_DECODE": "1",
                "DYN_SPEC_K": str(SPEC_K)}

    async def serve():
        try:
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            first = await run_requests(engine, reqs, Context)
            wall = time.perf_counter() - t1
            stats = copy.deepcopy(vars(engine.stats))
            launches = kernels.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            t1 = time.perf_counter()
            second = await run_requests(engine, reqs, Context)
            wall_warm = time.perf_counter() - t1
            # the spec leg: the JAX factory's variables, the same weights
            saved = {k: os.environ.get(k) for k in spec_env}
            os.environ.update(spec_env)
            try:
                spec = build_torch_engine(LLAMA31_8B, device="cuda", max_batch=8,
                                          max_model_len=MAX_MODEL_LEN, seed=0,
                                          params=runner.params, spec_min_coverage=SPEC_COVERAGE)
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            try:
                if not (spec.runner.kv_quantized and spec.config.spec_k == SPEC_K
                        and spec.runner.config.fused_decode):
                    raise SmokeError("serve_int8: the variables did not build the int8 spec engine")
                sreqs = await repeating_prompts(np, engine, PreprocessedRequest, SamplingOptions,
                                                StopConditions, Context)
                kernels.reset_launch_counts()
                t1 = time.perf_counter()
                sfirst = await run_requests(spec, sreqs, Context)
                swall = time.perf_counter() - t1
                sstats = copy.deepcopy(vars(spec.stats))
                slaunches = kernels.launch_counts()
            finally:
                await spec.close()
            return (first, second, wall, wall_warm, stats, launches, peak, sreqs, sfirst, swall,
                    sstats, slaunches, spec.runner)
        finally:
            await engine.close()

    (first, second, wall, wall_warm, stats, launches, peak, sreqs, sfirst, swall, sstats,
     slaunches, spec_runner) = asyncio.run(serve())
    vocab = LLAMA31_8B["vocab_size"]
    for i, ((toks, reason, _), req) in enumerate(zip(first, reqs)):
        if i == PENALIZED:
            ok = len(toks) >= MIN_TOKENS and reason in (FinishReason.LENGTH, FinishReason.EOS)
        else:
            ok = reason is FinishReason.LENGTH and len(toks) == req.stop.max_tokens
        if not ok or not all(0 <= t < vocab for t in toks):
            raise SmokeError(f"serve_int8 request {i}: {len(toks)} tokens, reason {reason}")
        if second[i][0] != toks:
            raise SmokeError(f"serve_int8 request {i}: the repeated run gave other tokens")
    for i, (toks, reason, _) in enumerate(sfirst):
        if reason is not FinishReason.LENGTH or len(toks) != SPEC_MAX_TOKENS:
            raise SmokeError(f"serve_int8 spec request {i}: {len(toks)} tokens, reason {reason}")
    if stats["mixed_steps"] <= 0 or stats["packed_prefills"] <= 0 or stats["prefills"]:
        raise SmokeError(f"serve_int8: did not pack and mix: {stats}")
    if sstats["verify_steps"] <= 0:
        raise SmokeError(f"serve_int8: no verify dispatch on the spec leg: {sstats}")
    L = runner.config.num_layers
    steps = stats["decode_steps"] + stats["mixed_steps"]
    want = {**dict.fromkeys(kernels.KERNELS, 0), "paged_decode_attention_int8": L * steps,
            "fused_qkv_rope_int8": L * steps, "fused_attn_out_residual_int8": L * steps}
    if launches != want:
        raise SmokeError(f"serve_int8: kernel launches {launches} != {want}")
    ssteps = sstats["decode_steps"] + sstats["mixed_steps"]
    verify = sstats["verify_steps"]
    swant = {**dict.fromkeys(kernels.KERNELS, 0), "paged_decode_attention_int8": L * ssteps,
             "paged_verify_attention_int8": L * verify,
             "fused_qkv_rope_int8": L * (ssteps + verify),
             "fused_attn_out_residual_int8": L * (ssteps + verify)}
    if slaunches != swant:
        raise SmokeError(f"serve_int8 spec: kernel launches {slaunches} != {swant}")
    # every int8 counter moved, no bf16 one, over the two runs
    both = {k: launches[k] + slaunches[k] for k in kernels.KERNELS}
    if any(both[k] == 0 for k in INT8_KERNELS) or any(
            both[k] for k in kernels.KERNELS if k not in INT8_KERNELS):
        raise SmokeError(f"serve_int8: launches {both}")
    gap = max(reference_check(torch, runner, reqs[i].token_ids, first[i][0], bound=INT8_REF_GAP)
              for i in (0, -1))
    sgap = max(reference_check(torch, spec_runner, sreqs[i].token_ids, sfirst[i][0], n_check=32,
                               bound=INT8_REF_GAP)
               for i in range(len(sreqs)) if i != SAMPLED)
    out_tokens = sum(len(t) for t, _, _ in first)
    res = {
        "requests": len(reqs), "prompt_lens": PROMPT_LENS, "stats": stats, "launches": launches,
        "wall_s": wall, "wall_s_warm": wall_warm, "output_tok_per_s_warm": out_tokens / wall_warm,
        "ttft_s_concurrent": [t for _, _, t in first],
        "ttft_s_concurrent_warm": [t for _, _, t in second],
        "engine_peak_mem_bytes": peak - mem_before, "engine_peak_mem_bytes_bf16_serve": bf16_peak,
        "weight_bytes": wbytes, "kv_cache_bytes": runner.kv_cache_bytes,
        "num_blocks": runner.num_blocks, "num_blocks_bf16": bf16_blocks,
        "block_caps_512x131072": caps, "build_s": build_s,
        "reference_max_logit_gap": gap, "reference_bound": INT8_REF_GAP,
        "spec": {"prompt_lens": [len(r.token_ids) for r in sreqs], "stats": sstats,
                 "launches": slaunches, "wall_s": swall,
                 "acceptance": sstats["num_accepted_tokens"] / max(1, sstats["num_draft_tokens"]),
                 "reference_max_logit_gap_32": sgap},
    }
    log(f"serve_int8: {len(reqs)} requests ({out_tokens} tokens) in {wall:.2f} s ({wall_warm:.2f} s "
        f"warm); {stats['packed_prefills']} packed prefills, {stats['mixed_steps']} mixed steps, "
        f"{stats['decode_steps']} decode steps; launches {launches}; repeat identical; reference "
        f"gap {gap:.3f} (bound {INT8_REF_GAP}); the engine's peak memory {(peak - mem_before) / 1e9:.2f}"
        f" GB (bf16 serve engine {bf16_peak / 1e9:.2f} GB)")
    log(f"serve_int8 spec (DYN_* variables): {verify} verify dispatches, {ssteps} decode steps; "
        f"drafts {sstats['num_drafts']}, accepted {sstats['num_accepted_tokens']}; launches "
        f"{slaunches}; reference gap over 32 tokens {sgap:.3f}")
    print(json.dumps({"serve_int8": res, "card": card}), flush=True)
    res["runner"] = runner
    res["launches_both"] = both
    return res


def int8_engine_times(torch, np, int8_runner, bf16_runner, bf16_chunked_runner,
                      card: str) -> dict:
    """The int8 deployment's step and TTFT beside bf16's, same card, in
    turns: the B=8 fused decode step at context 1024 (wall and device time,
    #1q per launch, #4q per layer), the 2000-token TTFT alone through four
    512-token chunks on the default path, and the unfused int8 linear op's
    share of the int8 step (the MLP's three products per layer and lm_head,
    CUDA-event times at M = 8, beside the same products in bf16)."""
    from dynamo_tpu_torch.ops import kv_quant
    from dynamo_tpu_torch.ops.attention import write_decode_kv
    from dynamo_tpu_torch.ops.linear import linear

    rng = np.random.default_rng(11)
    vocab = int8_runner.config.vocab_size
    bs = int8_runner.block_size
    B, ctx = 8, STEP_CTX
    per = (ctx + 1 + bs - 1) // bs
    tables = np.zeros((B, int8_runner.max_blocks_per_seq), np.int32)
    for b in range(B):
        tables[b, :per] = np.arange(1 + b * per, 1 + (b + 1) * per)
    pos = np.full(B, ctx, np.int64)
    slots = tables[np.arange(B), pos // bs].astype(np.int64) * bs + pos % bs
    toks = rng.integers(0, vocab, B)
    zeros, ones, kz = np.zeros(B, np.float32), np.ones(B, np.float32), np.zeros(B, np.int64)

    def step(r):
        return r.fetch_sample(r.decode(toks, pos, tables, slots, zeros, ones, kz))

    runners = {"bf16": bf16_runner, "int8": int8_runner}
    walls = {"bf16": [], "int8": []}
    for name in ("bf16", "int8", "int8", "bf16"):
        r = runners[name]
        for _ in range(3):
            step(r)
        for _ in range(10):
            t0 = time.perf_counter()
            step(r)
            walls[name].append((time.perf_counter() - t0) * 1e3)
    layers = int8_runner.config.num_layers
    decode = {}
    for name, r in runners.items():
        dev_ms, prof = profile_calls(torch, lambda: step(r))
        decode[name] = {
            "median": statistics.median(walls[name]), "min": min(walls[name]),
            "max": max(walls[name]), "device_ms": dev_ms, "B": B, "ctx": ctx,
            "decode_attention": per_launch_us(prof, "true", int8=name == "int8"),
            "qkv_head": qkv_head_us(prof, 5, layers), "top_kernels": top_kernels(prof, 5),
        }
    # TTFT of one 2000-token prompt alone through four chunks, in turns
    n = 2000
    prompt = rng.integers(0, vocab, n).tolist()
    blocks = list(range(1, (n + bs - 1) // bs + 1))

    def chunked_ttft(r):
        C = r.prefill_chunk_tokens
        for s in range(0, n, C):
            out = r.prefill_chunk(prompt[s:s + C], s, n, blocks, 0.0, 1.0, 0)
        return r.fetch_sample(out)

    # the default path's runners (the fused bf16 one does not chunk)
    chunkers = {"bf16": bf16_chunked_runner, "int8": int8_runner}
    ttft = {"bf16": [], "int8": []}
    for name in ("bf16", "int8", "int8", "bf16"):
        chunked_ttft(chunkers[name])
        for _ in range(3):
            t0 = time.perf_counter()
            chunked_ttft(chunkers[name])
            ttft[name].append((time.perf_counter() - t0) * 1e3)
    ttft = {k: {"median": statistics.median(v), "min": min(v), "max": max(v),
                "device_ms": device_ms_per_call(torch, lambda: chunked_ttft(chunkers[k]), calls=2)}
            for k, v in ttft.items()}
    # the unfused products of one step: the MLP's three per layer and lm_head
    flush = make_flush(torch)
    share = {}
    for name, r in runners.items():
        lay, p = r.params["layers"][0], r.params
        h = torch.randn(B, HIDDEN, device="cuda").to(torch.bfloat16)
        a = torch.randn(B, LLAMA31_8B["intermediate_size"], device="cuda").to(torch.bfloat16)
        t_mlp = sum(time_ms(torch, lambda w=lay[k], x=x: linear(x, w), flush=flush)["median"]
                    for k, x in (("wg", h), ("wu", h), ("wd", a)))
        t_head = time_ms(torch, lambda: linear(h, p["lm_head"]), flush=flush)["median"]
        total = layers * t_mlp + t_head
        share[name] = {"mlp_ms_per_layer": t_mlp, "lm_head_ms": t_head, "step_ms": total,
                       "share_of_step_device": total / decode[name]["device_ms"]}
    # where the step's host time goes: the CPU self time per op over a whole
    # step, then the host time of one call of the step's cache write (one
    # layer's K and V, 32 calls a step) and of the unfused products
    # (3 x 32 MLP products and lm_head), each alone
    host = {}
    for name, r in runners.items():
        lay, p = r.params["layers"][0], r.params
        h = torch.randn(B, HIDDEN, device="cuda").to(torch.bfloat16)
        a = torch.randn(B, LLAMA31_8B["intermediate_size"], device="cuda").to(torch.bfloat16)
        kv = torch.randn(B, r.config.num_kv_heads, r.config.head_dim, device="cuda").to(torch.bfloat16)
        sl = torch.from_numpy(slots).cuda()
        kl, vl = kv_quant.cache_layer(r.k_cache, 0), kv_quant.cache_layer(r.v_cache, 0)
        w_ms = host_ms(torch, lambda: write_decode_kv(kl, vl, kv, kv, sl))
        mlp_ms = sum(host_ms(torch, lambda w=lay[k], x=x: linear(x, w))
                     for k, x in (("wg", h), ("wu", h), ("wd", a)))
        head_ms = host_ms(torch, lambda: linear(h, p["lm_head"]))
        step_host = host_ms(torch, lambda: r.decode(toks, pos, tables, slots, zeros, ones, kz), reps=5)
        host[name] = {"step_launch_ms": step_host, "write_ms_per_layer": w_ms,
                      "write_ms_per_step": layers * w_ms, "mlp_linear_ms_per_layer": mlp_ms,
                      "lm_head_ms": head_ms, "linear_ms_per_step": layers * mlp_ms + head_ms,
                      "profile": host_ops(torch, lambda: step(r))}
    res = {"decode_step_ms_B8_fused": decode, "ttft_ms_alone_chunked_2000": ttft,
           "unfused_linear": share, "host_ms": host}
    print(json.dumps({"engine_time_int8": res, "card": card}), flush=True)
    log(f"int8 vs bf16, fused B=8 step at 1024: wall {decode['int8']['median']:.2f} / "
        f"{decode['bf16']['median']:.2f} ms, device {decode['int8']['device_ms']:.2f} / "
        f"{decode['bf16']['device_ms']:.2f} ms; #1 per launch "
        f"{decode['int8']['decode_attention']['us_per_launch']} / "
        f"{decode['bf16']['decode_attention']['us_per_launch']} us; #4 per layer "
        f"{decode['int8']['qkv_head']['us_per_layer']} / {decode['bf16']['qkv_head']['us_per_layer']} us")
    log(f"int8 vs bf16, 2000-token TTFT through 4 chunks: {ttft['int8']['median']:.2f} / "
        f"{ttft['bf16']['median']:.2f} ms wall, {ttft['int8']['device_ms']:.2f} / "
        f"{ttft['bf16']['device_ms']:.2f} ms device; the unfused products (MLP x 32 + lm_head) "
        f"{share['int8']['step_ms']:.2f} / {share['bf16']['step_ms']:.2f} ms, "
        f"{100 * share['int8']['share_of_step_device']:.1f}% / "
        f"{100 * share['bf16']['share_of_step_device']:.1f}% of the step's device time ({card})")
    log(f"int8 vs bf16, host ms of the B=8 fused step: launch {host['int8']['step_launch_ms']:.2f} / "
        f"{host['bf16']['step_launch_ms']:.2f}; cache writes {host['int8']['write_ms_per_step']:.2f} / "
        f"{host['bf16']['write_ms_per_step']:.2f}; unfused products "
        f"{host['int8']['linear_ms_per_step']:.2f} / {host['bf16']['linear_ms_per_step']:.2f} ({card})")
    return res


# ------------------------------------------------------------ tensor parallel

# #5's partial_out mode (the tensor-parallel o-projection) counts under
# these names; both are entry points of #5's source
TP_KERNELS = ("fused_attn_out_partial", "fused_attn_out_partial_int8")
# the raw f32 partial has no bf16 cast, so only the split-K summation order
# differs from the plain version: |d| <= 1e-3 + 2^-10 |plain|
PARTIAL_TOL = (1e-3, 2.0 ** -10)
# per-rank shapes (K, N, row stride, first column): Llama-3.1-8B tp=2's o-proj
# shard, one ring chunk of it (a strided column slice), Llama-3.1-70B tp=8's
PARTIAL_SHAPES = {
    "llama31_8b_tp2": (HQ * D // 2, HIDDEN, HIDDEN, 0),
    "llama31_8b_tp2_ring_chunk": (HQ * D // 2, HIDDEN // 2, HIDDEN, HIDDEN // 2),
    "llama31_70b_tp8": (64 * D // 8, 8192, 8192, 0),
}
TP = 2
TP_BLOCKS = 2112  # per rank: two ranks share the card, so the pool is set here
TP_REQUESTS = (0, 2, 4, 7)  # serve's 16-, 300-, 800- and 2000-token prompts
# the tp=2 engine's first decode step against the one-card engine's on the
# same weights: every row within 2^-4 of that row's largest |logit| (each
# of 32 layers rounds the bf16 residual stream in other places: prefill
# sums the ranks' f32 partials before the one cast where one card casts a
# bf16 product, and the sums run in another order; int8 adds the per-block
# KV scales, which follow the values written)
TP_LOGIT_TOL = 2.0 ** -4


def partial_inputs(torch, M: int, K: int, N: int, ldw: int, col: int, seed: int):
    """attn [M, K] bf16 and a [K, N] column slice (first column ``col``) of
    a [K, ldw] bf16 weight and of its int8 mantissas."""
    from dynamo_tpu_torch.ops.linear import quantize_int8

    g = torch.Generator(device="cuda").manual_seed(seed)
    attn = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
    full = (torch.randn(K, ldw, generator=g, device="cuda") / K ** 0.5).to(torch.bfloat16)
    return attn, full[:, col:col + N], quantize_int8(full)["q"][:, col:col + N]


def phase_parity_tp(torch) -> dict:
    """5p and 5pq against their plain version on the card at the per-rank
    shapes of PARTIAL_SHAPES, M = 8 and 32, at PARTIAL_TOL."""
    from dynamo_tpu_torch.ops import cuda_linear as KL
    from dynamo_tpu_torch.ops import linear as L

    errs = dict.fromkeys(TP_KERNELS, 0.0)
    for shape, (K, N, ldw, col) in PARTIAL_SHAPES.items():
        for M in (8, 32):
            attn, w, q8 = partial_inputs(torch, M, K, N, ldw, col, seed=90 + M + K // 64)
            for name, fn, ww in ((TP_KERNELS[0], KL.fused_attn_out_partial_cuda, w),
                                 (TP_KERNELS[1], KL.fused_attn_out_partial_int8_cuda, q8)):
                got = fn(attn, ww)
                torch.cuda.synchronize()
                e = compare(torch, f"{name}/{shape}/M{M}", got,
                            L.fused_attn_out_partial_plain(attn, ww), PARTIAL_TOL)
                errs[name] = max(errs[name], e)
                log(f"parity {name} {shape} M={M} K={K} N={N} ldw={ldw}: max|d|={e:.3e} "
                    f"(tol {PARTIAL_TOL[0]:g} + {PARTIAL_TOL[1]:g}|x|)")
    return errs


def partial_bound(M: int, K: int, N: int, w_bytes: int) -> tuple[float, str, float, float]:
    """Least time for 5p / 5pq: the [K, N] weight (bf16 or int8) and the
    [M, K] bf16 input read once, the [M, N] f32 output written once; 2 M K N
    tensor-core operations (the int8 mantissas are widened to bf16)."""
    nbytes = K * N * w_bytes + M * K * 2 + M * N * 4
    flops = 2 * M * K * N
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations", nbytes, flops


def tp_partial_times(torch, card: str) -> dict:
    """5p and 5pq at M = 8 (the B=8 fused step) and 32 at each per-rank
    shape: kernel, plain, and the library yardstick: one cuBLAS bf16
    product with f32 output (torch.mm(..., out_dtype=torch.float32)) over
    the same shard, for 5pq over the mantissas widened to bf16
    beforehand."""
    from dynamo_tpu_torch.ops import cuda_linear as KL
    from dynamo_tpu_torch.ops import linear as L

    flush = make_flush(torch)
    rows = {}
    for shape, (K, N, ldw, col) in PARTIAL_SHAPES.items():
        for M in (8, 32):
            attn, w, q8 = partial_inputs(torch, M, K, N, ldw, col, seed=95 + M)
            wide = q8.to(torch.bfloat16)
            for name, fn, ww, lib_w, wb in (
                    (TP_KERNELS[0], KL.fused_attn_out_partial_cuda, w, w, 2),
                    (TP_KERNELS[1], KL.fused_attn_out_partial_int8_cuda, q8, wide, 1)):
                t_k = time_ms(torch, lambda: fn(attn, ww), flush=flush)
                t_p = time_ms(torch, lambda: L.fused_attn_out_partial_plain(attn, ww), flush=flush)
                t_l = time_ms(torch, lambda: torch.mm(attn, lib_w, out_dtype=torch.float32),
                              flush=flush)
                b_ms, b_by, nbytes, flops = partial_bound(M, K, N, wb)
                rows[f"{name}/{shape}/M{M}"] = {
                    "ms": t_k, "plain_ms": t_p, "library_ms": t_l, "bound_ms": b_ms,
                    "bound_by": b_by, "bytes": nbytes, "flops": flops,
                    "ratio_to_library": t_k["median"] / t_l["median"],
                    "library": "torch.mm(attn, w, out_dtype=torch.float32) over the same shard"
                               + (" (mantissas widened to bf16 beforehand)" if wb == 1 else ""),
                    "shape": f"M={M} K={K} N={N} ldw={ldw} {'int8' if wb == 1 else 'bf16'} w",
                }
    for name, row in rows.items():
        print(json.dumps({"kernel_time": name, "card": card, **row}), flush=True)
        log(f"{name} {row['shape']}: {row['ms']['median']:.4f} ms, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}), plain {row['plain_ms']['median']:.4f} ms, library "
            f"{row['library_ms']['median']:.4f} ms ({card})")
    return rows


def step_inputs(np, runner, prompts):
    """A packed prefill of ``prompts`` (blocks from 1 on; at most the
    runner's 512-token buffer) and the decode step after it:
    (pack_prefill's arrays, decode arrays)."""
    from dynamo_tpu_torch.ops.sampling import MAX_EOS_IDS

    bs = runner.block_size
    specs, tables, nxt = [], [], 1
    for p in prompts:
        n = -(-(len(p) + 1) // bs)
        blocks = list(range(nxt, nxt + n))
        nxt += n
        specs.append((p, blocks, 0.0, 1.0, 0, 1.0, np.zeros(2, np.int64),
                      np.full(MAX_EOS_IDS, -1, np.int64), False))
        tables.append(blocks)
    B = len(prompts)
    table = np.zeros((B, runner.max_blocks_per_seq), np.int32)
    for i, b in enumerate(tables):
        table[i, :len(b)] = b
    pos = np.array([len(p) for p in prompts], np.int64)
    slots = table[np.arange(B), pos // bs].astype(np.int64) * bs + pos % bs
    return runner.pack_prefill(specs), (np.arange(B, dtype=np.int64) + 7, pos, table, slots)


def first_step_logits(torch, np, runner, prompts):
    """The logits of the decode step right after a packed prefill of
    ``prompts`` (every rank runs both through the engine's runner)."""
    packed, (toks, pos, table, slots) = step_inputs(np, runner, prompts)
    runner.fetch_sample(runner.prefill_packed_arrays(**packed))
    with torch.inference_mode():
        return runner.decode_logits(toks, pos, table, slots).float().cpu()


TP_STEP_PROMPTS = 8  # the B=8 step: 8 prompts of 64 tokens


def tp_step_times(torch, np, runner, reps: int = 5) -> dict:
    """Wall time of the B=8 fused decode step through the engine's runner
    (host clock around decode + fetch; on a tensor-parallel runner every
    rank runs it) and, with a group, the leader's host time inside its
    collectives and the bytes it staged through host memory per step."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, LLAMA31_8B["vocab_size"], 64).tolist() for _ in range(TP_STEP_PROMPTS)]
    packed, (toks, pos, table, slots) = step_inputs(np, runner, prompts)
    B = len(prompts)
    args = (np.zeros(B, np.float32), np.ones(B, np.float32), np.zeros(B, np.int64))
    runner.fetch_sample(runner.prefill_packed_arrays(**packed))
    runner.fetch_sample(runner.decode(toks, pos, table, slots, *args))  # warm
    group = getattr(runner, "group", None)
    times, coll, staged = [], [], []
    for _ in range(reps):
        c0 = group.seconds if group else 0.0
        b0 = group.staged_bytes if group else 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.fetch_sample(runner.decode(toks, pos, table, slots, *args))
        times.append((time.perf_counter() - t0) * 1e3)
        if group:
            coll.append((group.seconds - c0) * 1e3)
            staged.append(group.staged_bytes - b0)
    out = {"step_ms": statistics.median(times), "step_ms_all": times, "B": B, "ctx": 64}
    if group:
        out.update(collective_ms=statistics.median(coll), staged_bytes=staged[0],
                   collective_share=statistics.median(coll) / statistics.median(times))
    return out


def serve_tp_leg(torch, np, card: str, quant: bool, reqs, Context, FinishReason) -> dict:
    """One leg of serve_tp: the one-card engine (reference logits and
    tokens), then the tp=2 engine on the same seeded weights, two ranks on
    cuda:0 over gloo; checks and reads each rank's counters."""
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.ops import kernels

    kw = dict(max_batch=8, max_model_len=MAX_MODEL_LEN, seed=0, fused_decode=True,
              spec_k=0, quantize=quant, kv_dtype="int8" if quant else "bf16",
              num_blocks=TP_BLOCKS)
    tag = "int8" if quant else "bf16"
    rng = np.random.default_rng(3)
    probe = [rng.integers(0, LLAMA31_8B["vocab_size"], n).tolist() for n in (16, 100, 300)]

    one = build_torch_engine(LLAMA31_8B, device="cuda", **kw)
    want = first_step_logits(torch, np, one.runner, probe)
    one_steps = tp_step_times(torch, np, one.runner)

    async def serve(engine):
        try:
            return await run_requests(engine, reqs, Context)
        finally:
            await engine.close()

    one_out = asyncio.run(serve(one))
    del one
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    engine = build_torch_engine(LLAMA31_8B, device="cuda", tensor_parallel_size=TP,
                                tp_backend="gloo", tp_devices=["cuda:0"] * TP, **kw)
    build_s = time.perf_counter() - t0
    runner = engine.runner
    got = first_step_logits(torch, np, runner, probe)
    err = (got - want).abs()
    scale = want.abs().amax(dim=-1, keepdim=True)
    worst = float((err / scale).max())
    if not torch.isfinite(got).all() or worst > TP_LOGIT_TOL:
        raise SmokeError(f"serve_tp/{tag}: first-step logits {worst:.4f} of the row's max "
                         f"apart from the one-card engine's (tol {TP_LOGIT_TOL})")
    argmax_same = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    steps = tp_step_times(torch, np, runner)
    # every rank's counters to 0 just before the path, read just after
    runner.rank_stats(reset=True)
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    out = asyncio.run(run_requests(engine, reqs, Context))
    wall = time.perf_counter() - t1
    stats = copy.deepcopy(vars(engine.stats))
    ranks = runner.rank_stats()
    asyncio.run(engine.close())
    if [p.exitcode for p in runner._processes] != [0] * (TP - 1):
        raise SmokeError(f"serve_tp/{tag}: followers ended {[p.exitcode for p in runner._processes]}")
    for i, ((toks, reason, _), req) in enumerate(zip(out, reqs)):
        if reason is not FinishReason.LENGTH or len(toks) != req.stop.max_tokens:
            raise SmokeError(f"serve_tp/{tag} request {i}: {len(toks)} tokens, reason {reason}")
    L = LLAMA31_8B["num_hidden_layers"]
    fused_steps = stats["decode_steps"] + stats["mixed_steps"]
    sfx = "_int8" if quant else ""
    per_rank = L * fused_steps
    for r, st in enumerate(ranks):
        lc = st["launches"]
        for k in (f"paged_decode_attention{sfx}", f"fused_qkv_rope{sfx}",
                  f"fused_attn_out_partial{sfx}"):
            if lc[k] != per_rank:
                raise SmokeError(f"serve_tp/{tag} rank {r}: {k} launched {lc[k]} times, "
                                 f"expected {L} x {fused_steps} fused steps")
        moved = {k for k, v in lc.items() if v}
        if moved != {f"paged_decode_attention{sfx}", f"fused_qkv_rope{sfx}",
                     f"fused_attn_out_partial{sfx}"}:
            raise SmokeError(f"serve_tp/{tag} rank {r}: unexpected kernels moved: {lc}")
    launches = {k: sum(st["launches"][k] for st in ranks) for k in kernels.KERNELS}
    if launches[f"fused_attn_out_partial{sfx}"] != L * fused_steps * TP:
        raise SmokeError(f"serve_tp/{tag}: 5p launches {launches} != {L} x {fused_steps} x {TP}")
    n_tok = sum(len(t) for t, _, _ in one_out)
    agree = sum(a == b for (x, _, _), (y, _, _) in zip(one_out, out) for a, b in zip(x, y)) / n_tok
    # random weights leave near-tied logits: after one flipped token a
    # request's continuation differs, so the first divergence is reported too
    diverge = [next((j for j, (a, b) in enumerate(zip(x, y)) if a != b), len(x))
               for (x, _, _), (y, _, _) in zip(one_out, out)]
    res = {
        "weights": tag, "build_s": build_s, "requests": len(reqs), "stats": stats,
        "wall_s": wall, "output_tok_per_s": sum(len(t) for t, _, _ in out) / wall,
        "first_step_max_rel_err": worst, "first_step_argmax_same": argmax_same,
        "greedy_token_agreement": agree, "first_divergence": diverge,
        "rank_launches": [st["launches"] for st in ranks],
        "rank_peak_mem_bytes": [st.get("peak_mem_bytes") for st in ranks],
        "rank_staged_bytes": [st["staged_bytes"] for st in ranks],
        "rank_collective_s": [st["collective_s"] for st in ranks],
        "step_tp2": steps, "step_one_card": one_steps, "launches_summed": launches,
    }
    log(f"serve_tp/{tag}: {len(reqs)} requests in {wall:.2f} s, {stats['mixed_steps']} mixed + "
        f"{stats['decode_steps']} decode steps, {stats['packed_prefills']} packed prefills; "
        f"first-step logits within {worst:.4f} of the row max (argmax same {argmax_same:.3f}); "
        f"greedy tokens agreeing with one card {agree:.3f} (first divergence per request "
        f"{diverge}); 5p launches {launches[f'fused_attn_out_partial{sfx}']}"
        f" (= {L} x {fused_steps} x {TP}); B=8 step {steps['step_ms']:.1f} ms (one card "
        f"{one_steps['step_ms']:.1f} ms), collectives {steps['collective_ms']:.1f} ms of it; "
        f"peak memory per rank {[round(m / 1e9, 2) for m in res['rank_peak_mem_bytes']]} GB ({card})")
    print(json.dumps({"serve_tp": res, "card": card}), flush=True)
    return res


def phase_serve_tp(torch, np, card: str) -> dict:
    """Tensor-parallel serving on one card: build_torch_engine(
    tensor_parallel_size=2, tp_backend="gloo", tp_devices=["cuda:0",
    "cuda:0"], fused_decode=True) at full width on the default path, bf16
    then int8 weights + int8 KV (four of serve's requests each); then a
    one-rank NCCL group running fused steps with DYN_COLLECTIVE_OVERLAP=1
    (the ring with zero hops). Two ranks on one card over gloo check
    correctness; their times say nothing of collective speed across cards."""
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.ops import kernels
    from dynamo_tpu_torch.protocols.common import (
        Context, FinishReason, PreprocessedRequest, SamplingOptions, StopConditions,
    )

    every = make_requests(np, PreprocessedRequest, SamplingOptions, StopConditions)
    reqs = [every[i] for i in TP_REQUESTS]
    legs = {tag: serve_tp_leg(torch, np, card, quant, reqs, Context, FinishReason)
            for tag, quant in (("bf16", False), ("int8", True))}
    gc.collect()
    torch.cuda.empty_cache()

    # one rank over NCCL, the ring tail from DYN_COLLECTIVE_OVERLAP
    os.environ["DYN_COLLECTIVE_OVERLAP"] = "1"
    try:
        engine = build_torch_engine(LLAMA31_8B, device="cuda", tensor_parallel_size=1,
                                    tp_backend="nccl", max_batch=8, max_model_len=MAX_MODEL_LEN,
                                    seed=0, fused_decode=True, spec_k=0, num_blocks=TP_BLOCKS)
    finally:
        del os.environ["DYN_COLLECTIVE_OVERLAP"]
    runner = engine.runner
    if runner.group.backend != "nccl" or not runner.config.collective_overlap:
        raise SmokeError(f"serve_tp/nccl: group {runner.group}, overlap "
                         f"{runner.config.collective_overlap}")
    runner.rank_stats(reset=True)
    kernels.reset_launch_counts()
    packed, (toks, pos, table, slots) = step_inputs(np, runner, [list(range(1, 40))])
    runner.fetch_sample(runner.prefill_packed_arrays(**packed))
    tok = runner.fetch_sample(runner.decode(toks, pos, table, slots, np.zeros(1, np.float32),
                                            np.ones(1, np.float32), np.zeros(1, np.int64)))[0]
    (st,) = runner.rank_stats()
    asyncio.run(engine.close())
    L = LLAMA31_8B["num_hidden_layers"]
    want = {**dict.fromkeys(kernels.KERNELS, 0), "paged_decode_attention": L,
            "fused_qkv_rope": L, "fused_attn_out_partial": L}
    if st["launches"] != want or not 0 <= int(tok[0]) < LLAMA31_8B["vocab_size"]:
        raise SmokeError(f"serve_tp/nccl: launches {st['launches']} != {want}, token {tok}")
    log(f"serve_tp/nccl: one rank over NCCL ran a fused step with the ring tail (zero hops): "
        f"{L} 5p launches, token {int(tok[0])} ({card})")
    return {"legs": legs, "nccl_one_rank": {"launches": st["launches"], "token": int(tok[0])}}


# ------------------------------------------------------------- serve_http

SERVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "serve_http")
# Llama-3-Instruct's chat template (tokenizer_config.json as published)
LLAMA3_CHAT_TEMPLATE = (
    "{% set loop_messages = messages %}{% for message in loop_messages %}"
    "{% set content = '<|start_header_id|>' + message['role'] + '<|end_header_id|>\n\n'"
    "+ message['content'] | trim + '<|eot_id|>' %}{% if loop.index0 == 0 %}"
    "{% set content = bos_token + content %}{% endif %}{{ content }}{% endfor %}"
    "{% if add_generation_prompt %}{{ '<|start_header_id|>assistant<|end_header_id|>\n\n' }}{% endif %}"
)
LLAMA3_SPLIT = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
NAMED_SPECIALS = {128000: "<|begin_of_text|>", 128001: "<|end_of_text|>",
                  128006: "<|start_header_id|>", 128007: "<|end_header_id|>", 128009: "<|eot_id|>"}
SERVER_START_S = 420  # weights init + kernel loads + imports, at most
HTTP_TIMEOUT_S = 180
HTTP_STOP, HTTP_PENALIZED, HTTP_CLOSE_AFTER = 2, PENALIZED, 4


def llama3_style_tokenizer_json(n_regular: int = 128000, seed: int = 0) -> str:
    """A Llama-3-shaped tokenizer.json made here (no checkpoint's tokenizer
    is in the repository): byte-level BPE over the Llama-3 split pattern
    with ignore_merges, a TemplateProcessing BOS, ids 0-255 the byte
    alphabet, 256..n_regular-1 seeded merges that each extend a word by one
    letter, and the 256 special tokens at 128000-128255, so every id the
    model can sample decodes."""
    import random

    from dynamo_tpu_torch.tokenizer_json import bytes_to_unicode

    b2u = bytes_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    merges = []
    letters = [b2u[b] for b in b"abcdefghijklmnopqrstuvwxyz"]
    pool = []

    def add(a, b):
        merges.append([a, b])
        vocab[a + b] = len(vocab)
        pool.append(a + b)

    for c in letters:
        add(b2u[ord(" ")], c)
    rng = random.Random(seed)
    while len(vocab) < n_regular:
        left = rng.choice(pool[-4096:] if rng.random() < 0.5 else pool)
        new = left + rng.choice(letters)
        if len(new) <= 12 and new not in vocab:
            add(left, new[-1])
    added = []
    for i in range(n_regular, LLAMA31_8B["vocab_size"]):
        name = NAMED_SPECIALS.get(i, f"<|reserved_special_token_{i - n_regular}|>")
        vocab[name] = i
        added.append({"id": i, "content": name, "single_word": False, "lstrip": False,
                      "rstrip": False, "normalized": False, "special": True})
    bos = NAMED_SPECIALS[128000]
    return json.dumps({
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT}, "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True, "use_regex": False}]},
        "post_processor": {"type": "Sequence", "processors": [
            {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False, "use_regex": True},
            {"type": "TemplateProcessing",
             "single": [{"SpecialToken": {"id": bos, "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}}],
             "pair": [{"SpecialToken": {"id": bos, "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}},
                      {"SpecialToken": {"id": bos, "type_id": 1}}, {"Sequence": {"id": "B", "type_id": 1}}],
             "special_tokens": {bos: {"id": bos, "ids": [128000], "tokens": [bos]}}}]},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None, "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False, "byte_fallback": False,
                  "ignore_merges": True, "vocab": vocab, "merges": merges},
    })


def write_serve_dir() -> str:
    """The published Llama-3.1-8B config.json, the script's tokenizer.json
    and a Llama-3-style tokenizer_config.json; no weights, so the CLI serves
    seeded random bf16 weights."""
    os.makedirs(SERVE_DIR, exist_ok=True)
    for name in os.listdir(SERVE_DIR):
        if name.endswith(".safetensors"):
            raise SmokeError(f"{SERVE_DIR} holds weights ({name}); this phase serves random ones")
    with open(os.path.join(SERVE_DIR, "config.json"), "w") as f:
        json.dump(LLAMA31_8B, f)
    with open(os.path.join(SERVE_DIR, "tokenizer.json"), "w") as f:
        f.write(llama3_style_tokenizer_json())
    with open(os.path.join(SERVE_DIR, "tokenizer_config.json"), "w") as f:
        json.dump({"chat_template": LLAMA3_CHAT_TEMPLATE, "bos_token": NAMED_SPECIALS[128000],
                   "eos_token": NAMED_SPECIALS[128009]}, f)
    return SERVE_DIR


def prompt_words(tokenizer, n_tokens: int, seed: int) -> str:
    """Text of about ``n_tokens`` tokens: random vocabulary words, some of
    them glued in pairs so BPE has merging to do."""
    import random

    rng = random.Random(seed)
    words, count = [], 0
    while count < n_tokens:
        a = tokenizer.decode([rng.randrange(256 + 26, 128000)]).strip()
        if rng.random() < 0.3:
            a += tokenizer.decode([rng.randrange(256 + 26, 128000)]).strip()
        n = len(tokenizer.encode(" " + a, add_special_tokens=False).ids)
        if count + n > n_tokens:
            break
        words.append(a)
        count += n
    return " ".join(words)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_call(port: int, method: str, path: str, body=None, timeout: float = HTTP_TIMEOUT_S):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def stream_chat(port: int, body: dict, close_after: Optional[int] = None) -> dict:
    """One streamed chat completion over stdlib http.client: every SSE event
    parsed, with the time of each content chunk from the request's send;
    with ``close_after``, the socket is closed after that many chunks."""
    import http.client

    from dynamo_tpu_torch.protocols.sse import SseParser

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_TIMEOUT_S)
    parser, events, times = SseParser(), [], []
    t0 = time.perf_counter()
    try:
        conn.request("POST", "/v1/chat/completions", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise SmokeError(f"stream answered {resp.status}: {resp.read()[:300]!r}")
        if not resp.getheader("Content-Type", "").startswith("text/event-stream"):
            raise SmokeError(f"stream content type {resp.getheader('Content-Type')!r}")
        while True:
            line = resp.readline()
            if not line:
                break
            for ev in parser.feed(line.decode("utf-8")):
                events.append(ev)
                if ev.data and not ev.is_done() and ev.event is None:
                    d = ev.json()
                    if d.get("choices") and (d["choices"][0].get("delta") or {}).get("content"):
                        times.append(time.perf_counter() - t0)
            if close_after is not None and len(events) >= close_after:
                conn.sock.shutdown(2)
                return {"events": events}
    finally:
        conn.close()
    return summarize_stream(events, times)


def summarize_stream(events: list, times: list) -> dict:
    """Check one SSE stream's form: JSON events, a role chunk first, content
    chunks, exactly one finish reason, a usage chunk, then [DONE]."""
    if not events or not events[-1].is_done():
        raise SmokeError("stream does not end in [DONE]")
    text, finish, usage, n_lp, role = "", [], None, 0, None
    for ev in events[:-1]:
        if ev.event is not None:
            raise SmokeError(f"stream carried an {ev.event!r} event: {ev.data}")
        d = ev.json()
        if d.get("object") != "chat.completion.chunk":
            raise SmokeError(f"not a chat chunk: {d}")
        if d.get("usage"):
            usage = d["usage"]
        for ch in d.get("choices", []):
            delta = ch.get("delta") or {}
            role = role or delta.get("role")
            text += delta.get("content") or ""
            n_lp += len((ch.get("logprobs") or {}).get("content") or [])
            if ch.get("finish_reason"):
                finish.append(ch["finish_reason"])
    if role != "assistant" or len(finish) != 1 or usage is None:
        raise SmokeError(f"malformed stream: role {role!r}, finish reasons {finish}, usage {usage}")
    itl = [b - a for a, b in zip(times, times[1:])]
    return {"text": text, "finish": finish[0], "usage": usage, "logprob_tokens": n_lp,
            "ttft_s": times[0] if times else None,
            "itl_ms_mean": statistics.mean(itl) * 1e3 if itl else None}


def chat_body(content: str, max_tokens: int, **extra) -> dict:
    return {"model": "llama31-8b", "messages": [{"role": "user", "content": content}],
            "max_tokens": max_tokens, "temperature": 0, "stream": True,
            "stream_options": {"include_usage": True}, **extra}


async def engine_direct(execution, body: dict, Context) -> dict:
    """The same chat request through the port's ModelExecution in-process
    (preprocess, engine, detokenize; no HTTP), timed like the HTTP client."""
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest

    t0 = time.perf_counter()
    times, text = [], ""
    async for item in execution.chat_stream(ChatCompletionRequest.from_dict(body), Context()):
        if item.is_error():
            raise SmokeError(f"engine-direct request failed: {item.error_message()}")
        for ch in (item.data or {}).get("choices", []):
            piece = (ch.get("delta") or {}).get("content")
            if piece:
                times.append(time.perf_counter() - t0)
                text += piece
    itl = [b - a for a, b in zip(times, times[1:])]
    return {"text": text, "ttft_s": times[0], "itl_ms_mean": statistics.mean(itl) * 1e3}


LONE_PAIRS = 5  # lone requests through HTTP and engine-direct, in turns


def direct_server(model_dir: str) -> None:
    """Run in a process of its own by ``DirectProcess``: build the engine
    the server builds, print a ready line, then time each chat body read
    from stdin engine-direct (the port's ModelExecution, no HTTP) and print
    the result, one JSON line each, until stdin ends."""
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.http.service import ModelExecution
    from dynamo_tpu_torch.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.protocols.common import Context

    mdc = ModelDeploymentCard.from_model_dir(model_dir, "llama31-8b", context_length=MAX_MODEL_LEN)
    engine = build_torch_engine(model_dir, device="cuda", max_model_len=MAX_MODEL_LEN, num_blocks=2112)
    execution = ModelExecution(mdc, engine.generate)

    async def serve():
        loop = asyncio.get_running_loop()
        try:
            print(json.dumps({"ready": True}), flush=True)
            while True:
                line = await loop.run_in_executor(None, sys.stdin.readline)
                if not line.strip():
                    return
                print(json.dumps(await engine_direct(execution, json.loads(line), Context)), flush=True)
        finally:
            await engine.close()

    asyncio.run(serve())


class DirectProcess:
    """``direct_server`` in a new process, started as the server's is and
    alive beside it, so that HTTP and engine-direct requests can be timed
    in turns and differ by the frontend, not by the process (every earlier
    phase ran in this one)."""

    def __init__(self, root: str, model_dir: str, env: dict, stderr) -> None:
        code = "import sys, chip_smoke; chip_smoke.direct_server(sys.argv[1])"
        self.proc = subprocess.Popen([sys.executable, "-c", code, model_dir], cwd=root, env=env,
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=stderr,
                                     text=True)

    def _line(self) -> dict:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(1) as pool:
            line = pool.submit(self.proc.stdout.readline).result(timeout=SERVER_START_S)
        if not line:
            raise SmokeError(f"the engine-direct process exited with {self.proc.wait(30)}")
        return json.loads(line)

    def wait_ready(self) -> None:
        self._line()

    def run(self, body: dict) -> dict:
        self.proc.stdin.write(json.dumps(body) + "\n")
        self.proc.stdin.flush()
        return self._line()

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.stdin.close()
                self.proc.wait(60)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait(30)


def phase_serve_http(torch, np, card: str) -> dict:
    """The CLI's HTTP server in its own process at Llama-3.1-8B width, then
    the lone request engine-direct in this process (see the docstring)."""
    import signal
    from concurrent.futures import ThreadPoolExecutor

    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.http.service import ModelExecution
    from dynamo_tpu_torch.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.ops import kernels
    from dynamo_tpu_torch.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.protocols.common import Context
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest

    t0 = time.perf_counter()
    model_dir = write_serve_dir()
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    mdc = ModelDeploymentCard.from_model_dir(model_dir, "llama31-8b", context_length=MAX_MODEL_LEN)
    t_card = time.perf_counter() - t0
    pre = OpenAIPreprocessor(mdc)
    tok = pre.tokenizer
    log(f"serve_http: model dir written in {t_write:.2f} s (vocab {tok.vocab_size}); "
        f"card + tokenizer loaded in {t_card:.2f} s")
    if tok.vocab_size != LLAMA31_8B["vocab_size"]:
        raise SmokeError(f"tokenizer vocab {tok.vocab_size} != {LLAMA31_8B['vocab_size']}")

    # host time of templating + tokenizing a 2000-token prompt: cold (a new
    # tokenizer, empty word cache) and warm (the same request again)
    long_req = ChatCompletionRequest.from_dict(chat_body(prompt_words(tok, 1990, seed=99), 8))
    fresh = OpenAIPreprocessor(mdc)
    t0 = time.perf_counter()
    long_pre, _ = fresh.preprocess_chat(long_req)
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    fresh.preprocess_chat(long_req)
    t_warm = time.perf_counter() - t0
    log(f"serve_http: template + tokenize of a {len(long_pre.token_ids)}-token prompt: "
        f"{t_cold * 1e3:.2f} ms cold, {t_warm * 1e3:.2f} ms warm (host; {card})")

    lone = chat_body(prompt_words(tok, 490, seed=7), 64, nvext={"ignore_eos": True})
    warm = chat_body("hello there", 4)
    # the template's own tokens around the user's text
    overhead = len(pre.preprocess_chat(ChatCompletionRequest.from_dict(chat_body("", 1)))[0].token_ids)
    contents = [prompt_words(tok, max(4, n - overhead), seed=100 + i) for i, n in enumerate(PROMPT_LENS)]
    bodies = []
    for i, (content, m) in enumerate(zip(contents, MAX_TOKENS)):
        extra = {"logprobs": True}
        if i == HTTP_STOP:
            extra["stop"] = ["e"]
        if i == HTTP_PENALIZED:
            extra.update(PENALTIES, min_tokens=MIN_TOKENS)
        bodies.append(chat_body(content, m, **extra))
    expect_prompt = [len(pre.preprocess_chat(ChatCompletionRequest.from_dict(b))[0].token_ids)
                     for b in bodies]

    port = free_port()
    log_path = os.path.join(SERVE_DIR, "server.log")
    cmd = [sys.executable, "-m", "dynamo_tpu_torch.run", "in=http", "out=torch",
           "--model-path", model_dir, "--model-name", "llama31-8b",
           "--context-length", str(MAX_MODEL_LEN), "--num-blocks", "2112",
           "--http-host", "127.0.0.1", "--http-port", str(port)]
    log("serve_http: " + " ".join(cmd[1:]))
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out: dict = {}
    with open(log_path, "w") as logf, open(os.path.join(SERVE_DIR, "direct.log"), "w") as dlog:
        proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=logf, stderr=subprocess.STDOUT)
        direct = DirectProcess(root, model_dir, env, dlog)
        try:
            t0 = time.perf_counter()
            while True:
                if proc.poll() is not None:
                    raise SmokeError(f"server exited with {proc.returncode} before /health answered")
                try:
                    if http_call(port, "GET", "/health", timeout=5)[0] == 200:
                        break
                except OSError:
                    pass
                if time.perf_counter() - t0 > SERVER_START_S:
                    raise SmokeError(f"server did not answer /health within {SERVER_START_S} s")
                time.sleep(1.0)
            out["server_start_s"] = time.perf_counter() - t0
            log(f"serve_http: server up in {out['server_start_s']:.1f} s")
            st, data = http_call(port, "GET", "/v1/models")
            if st != 200 or json.loads(data)["data"][0]["id"] != "llama31-8b":
                raise SmokeError(f"/v1/models answered {st}: {data[:200]!r}")

            # the lone greedy request through HTTP and engine-direct in
            # turns (after one warm-up request each), both processes alive
            direct.wait_ready()
            stream_chat(port, warm)
            direct.run(warm)
            http_runs, direct_runs = [], []
            for k in range(LONE_PAIRS):
                for mode in (("http", "direct") if k % 2 == 0 else ("direct", "http")):
                    if mode == "http":
                        http_runs.append(stream_chat(port, lone))
                    else:
                        direct_runs.append(direct.run(lone))
            direct.close()
            for r in http_runs + direct_runs:
                if r["text"] != http_runs[0]["text"]:
                    raise SmokeError(f"lone request texts differ:\n{http_runs[0]['text']!r}\n{r['text']!r}")
            out["http_lone"] = http_runs[0]
            out["lone_pairs"] = {
                "http_ttft_ms": [r["ttft_s"] * 1e3 for r in http_runs],
                "http_itl_ms": [r["itl_ms_mean"] for r in http_runs],
                "direct_ttft_ms": [r["ttft_s"] * 1e3 for r in direct_runs],
                "direct_itl_ms": [r["itl_ms_mean"] for r in direct_runs],
            }

            # 8 concurrent streams
            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(bodies)) as pool:
                results = list(pool.map(lambda b: stream_chat(port, b), bodies))
            out["concurrent_wall_s"] = time.perf_counter() - t0
            for i, (r, b, n_prompt) in enumerate(zip(results, bodies, expect_prompt)):
                u = r["usage"]
                if u["prompt_tokens"] != n_prompt:
                    raise SmokeError(f"stream {i}: prompt_tokens {u['prompt_tokens']} != {n_prompt}")
                if u["completion_tokens"] != r["logprob_tokens"] or not 0 < u["completion_tokens"] <= b["max_tokens"]:
                    raise SmokeError(f"stream {i}: usage {u} vs {r['logprob_tokens']} tokens streamed")
                if i == HTTP_STOP and "e" in r["text"]:
                    raise SmokeError(f"stream {i}: the stop string is in the text")
                if i == HTTP_PENALIZED and u["completion_tokens"] < MIN_TOKENS:
                    raise SmokeError(f"stream {i}: {u['completion_tokens']} tokens < min_tokens")
                log(f"serve_http: stream {i}: prompt {u['prompt_tokens']} tokens, "
                    f"{u['completion_tokens']} out, finish {r['finish']}, TTFT {r['ttft_s']} s")
            out["concurrent"] = [{k: r[k] for k in ("finish", "usage", "ttft_s", "itl_ms_mean")}
                                 for r in results]

            # one non-streamed completion
            st, data = http_call(port, "POST", "/v1/completions", {
                "model": "llama31-8b", "prompt": contents[2], "max_tokens": 32, "temperature": 0,
                "stream_options": {"include_usage": True}})
            comp = json.loads(data)
            if st != 200 or comp.get("object") != "text_completion" or not comp["choices"][0].get(
                    "finish_reason") or not 0 < comp["usage"]["completion_tokens"] <= 32:
                raise SmokeError(f"non-streamed completion: {st} {data[:300]!r}")
            out["completion_usage"] = comp["usage"]

            # a stream the client closes after 4 chunks, then a request after it
            closing = chat_body(contents[1], 2000, nvext={"ignore_eos": True})
            stream_chat(port, closing, close_after=HTTP_CLOSE_AFTER)
            t0 = time.perf_counter()
            after = stream_chat(port, chat_body("after the hang up", 8))
            out["after_close_s"] = time.perf_counter() - t0
            log(f"serve_http: closed a stream after {HTTP_CLOSE_AFTER} chunks; the next request "
                f"took {out['after_close_s']:.2f} s ({after['usage']['completion_tokens']} tokens)")
        finally:
            direct.close()
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
                try:
                    proc.wait(60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(30)
    stats = None
    with open(log_path) as f:
        for line in f:
            if line.startswith('{"exit_stats"'):
                stats = json.loads(line)["exit_stats"]
    if stats is None:
        raise SmokeError(f"the server printed no exit stats (see {log_path})")
    streamed = (sum(r["usage"]["completion_tokens"] for r in results) + out["completion_usage"][
        "completion_tokens"] + LONE_PAIRS * out["http_lone"]["usage"]["completion_tokens"] + 4 + 8)
    # the closed stream may have made a few tokens more than the 4 chunks read
    # before its lane was freed; 2000 would show a lane left running
    if stats["busy_lanes"] or stats["free_blocks"] != stats["num_blocks"] - 1 or (
            stats["generated_tokens"] > streamed + 200):
        raise SmokeError(f"the closed stream's lane was not freed: {stats}, {streamed} tokens streamed")
    out["server_exit"] = stats
    launches = stats["kernel_launches"]
    if launches["paged_decode_attention"] <= 0:
        raise SmokeError(f"the HTTP phase launched no #1: {launches}")
    log(f"serve_http: server kernel launches {launches}, generated {stats['generated_tokens']} tokens")

    # the lone request engine-direct in this process, the card now free
    gc.collect()
    torch.cuda.empty_cache()
    engine = build_torch_engine(model_dir, device="cuda", max_model_len=MAX_MODEL_LEN, num_blocks=2112)
    execution = ModelExecution(mdc, engine.generate)

    async def direct():
        try:
            await engine_direct(execution, warm, Context)
            kernels.reset_launch_counts()
            res = await engine_direct(execution, lone, Context)
            res["launches"] = kernels.launch_counts()
            # again with this process's long-lived objects (every earlier
            # phase's) frozen out of the garbage collector's reach: the
            # server process holds far fewer
            gc.collect()
            gc.freeze()
            try:
                res["gc_frozen"] = await engine_direct(execution, lone, Context)
            finally:
                gc.unfreeze()
            return res
        finally:
            await engine.close()

    out["direct_lone"] = asyncio.run(direct())
    del engine, execution
    gc.collect()
    torch.cuda.empty_cache()
    h, d = out["http_lone"], out["direct_lone"]
    f = d["gc_frozen"]
    for got in (d, f):
        if h["text"] != got["text"]:
            raise SmokeError(f"HTTP text differs from the engine's:\n{h['text']!r}\n{got['text']!r}")
    lp = out["lone_pairs"]
    med = {k: statistics.median(v) for k, v in lp.items()}
    d_itl = statistics.median(a - b for a, b in zip(lp["http_itl_ms"], lp["direct_itl_ms"]))
    d_ttft = statistics.median(a - b for a, b in zip(lp["http_ttft_ms"], lp["direct_ttft_ms"]))
    log(f"serve_http: lone greedy request ({h['usage']['prompt_tokens']} + "
        f"{h['usage']['completion_tokens']} tokens), {LONE_PAIRS} in turns, medians: HTTP TTFT "
        f"{med['http_ttft_ms']:.2f} ms, ITL {med['http_itl_ms']:.2f} ms; engine-direct in its own "
        f"process TTFT {med['direct_ttft_ms']:.2f} ms, ITL {med['direct_itl_ms']:.2f} ms; "
        f"HTTP - direct per pair (median) TTFT {d_ttft:.2f} ms, ITL {d_itl:.2f} ms; ITL ranges "
        f"HTTP {min(lp['http_itl_ms']):.2f}-{max(lp['http_itl_ms']):.2f}, direct "
        f"{min(lp['direct_itl_ms']):.2f}-{max(lp['direct_itl_ms']):.2f} ms; engine-direct in this "
        f"process {d['ttft_s'] * 1e3:.2f} / {d['itl_ms_mean']:.2f} ms (garbage collector frozen: "
        f"{f['ttft_s'] * 1e3:.2f} / {f['itl_ms_mean']:.2f} ms); texts identical ({card})")
    print(json.dumps({"serve_http": {
        "card": card, "tokenize_template_ms": {"cold": t_cold * 1e3, "warm": t_warm * 1e3,
                                               "prompt_tokens": len(long_pre.token_ids)},
        "http_lone": {k: h[k] for k in ("ttft_s", "itl_ms_mean", "usage")},
        "direct_lone": {k: d[k] for k in ("ttft_s", "itl_ms_mean", "launches")},
        "direct_lone_gc_frozen": {k: f[k] for k in ("ttft_s", "itl_ms_mean")},
        "lone_pairs": lp, "lone_medians": med,
        "lone_http_minus_direct_ms": {"ttft": d_ttft, "itl": d_itl},
        "decode_launches_server": launches["paged_decode_attention"],
        **{k: out[k] for k in ("server_start_s", "concurrent_wall_s", "concurrent",
                               "completion_usage", "after_close_s", "server_exit")},
    }}), flush=True)
    return out


# ------------------------------------------------------------------ main


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] FAIL: torch.cuda.is_available() is false; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from dynamo_tpu_torch.ops import _build
    except ImportError as e:
        print(f"[chip_smoke] FAIL: the port's package is not beside this "
              f"script: {e}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        # 1. device
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        card = nvidia_smi_line()
        log(f"device: {kind} x{count}; nvidia-smi: {card}")
        log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

        # 2. build
        t0 = time.perf_counter()
        info = _build.build_all()
        log(f"build: {len(info)} kernels in {time.perf_counter() - t0:.1f} s")
        for name, row in info.items():
            log(f"build {name}: {row['seconds']:.1f} s")
            for line in row["ptxas"].splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")

        # 3. parity
        errs = phase_parity(torch)
        errs.update(phase_parity_int8(torch))
        errs.update(phase_parity_tp(torch))

        # 4. serve and 5. serve_spec (each path's counters set to 0 just
        # before it, read just after)
        served = phase_serve(torch, np, card)
        engine = served.pop("engine")
        spec = phase_serve_spec(torch, np, card, engine.runner.params)
        fused_runner = spec.pop("runner")
        # 6. serve_default (its counters set to 0 just before it, read just
        # after) and 7. checkpoint
        default = phase_serve_default(torch, np, card, engine.runner.params)
        default_engine = default.pop("engine")
        phase_checkpoint(torch, np, card)
        # 9. serve_int8 (each of its two runs' counters set to 0 just before
        # it, read just after)
        int8 = phase_serve_int8(torch, np, card, engine.runner.num_blocks,
                                served["engine_peak_mem_bytes"])
        int8_runner = int8.pop("runner")
        # each kernel's launches on the path that owns it: decode (#1) on
        # the default path, prefill (#3) on the chunking-off serve path, the
        # other three on the spec path, the int8 modes on serve_int8's two
        # runs (default path, then spec)
        launches = {
            **served["launches"],
            **{k: spec["launches"][k] for k in SPEC_KERNELS},
            "paged_decode_attention": default["launches"]["paged_decode_attention"],
            **{k: int8["launches_both"][k] for k in INT8_KERNELS},
        }

        # 8. times
        phase_engine_times(torch, np, engine, fused_runner, card)
        admission_times(torch, np, default_engine, card)
        int8_engine_times(torch, np, int8_runner, fused_runner, default_engine.runner, card)
        rows = phase_kernel_times(torch, card)
        rows.update(phase_kernel_times_int8(torch, card))
        rows.update(tp_partial_times(torch, card))
        log(f"peak device memory during serve: {served['peak_mem_bytes'] / 1e9:.2f} GB")

        # 10. serve_http: the CLI's HTTP server in a process of its own, so
        # this process's engines leave the card first
        del engine, default_engine, fused_runner, spec, served, default, int8_runner, int8
        gc.collect()
        torch.cuda.empty_cache()
        # 11. serve_tp: two ranks on this card over gloo, then one over
        # NCCL (every rank's counters set to 0 just before each leg's
        # requests, read just after)
        tp = phase_serve_tp(torch, np, card)
        launches.update({k: tp["legs"][w]["launches_summed"][k]
                         for k, w in zip(TP_KERNELS, ("bf16", "int8"))})
        for k in TP_KERNELS:  # the B=8 step's row of Llama-3.1-8B tp=2's shard
            rows[k] = rows[f"{k}/llama31_8b_tp2/M8"]
        gc.collect()
        torch.cuda.empty_cache()
        log(f"device memory held before the server starts: {torch.cuda.memory_allocated() / 1e9:.2f} GB")
        phase_serve_http(torch, np, card)
    except Exception as e:  # noqa: BLE001 - report and fail the run
        import traceback

        traceback.print_exc()
        print(f"[chip_smoke] FAIL: {type(e).__name__}: {e}", file=sys.stderr)
        return 1

    # the int8 modes replace the same Pallas kernels' int8 branches
    replaces = {
        "paged_decode_attention": "dynamo_tpu/ops/pallas_attention.py:231",
        "flash_prefill_attention": "dynamo_tpu/ops/pallas_attention.py:554",
        "paged_verify_attention": "dynamo_tpu/ops/pallas_attention.py:452",
        "fused_qkv_rope": "dynamo_tpu/ops/linear.py:206",
        "fused_attn_out_residual": "dynamo_tpu/ops/linear.py:334",
        "paged_decode_attention_int8": "dynamo_tpu/ops/pallas_attention.py:231",
        "paged_verify_attention_int8": "dynamo_tpu/ops/pallas_attention.py:452",
        "fused_qkv_rope_int8": "dynamo_tpu/ops/linear.py:206",
        "fused_attn_out_residual_int8": "dynamo_tpu/ops/linear.py:334",
        # the partial_out branch of the same Pallas program (linear.py:321-325)
        "fused_attn_out_partial": "dynamo_tpu/ops/linear.py:334",
        "fused_attn_out_partial_int8": "dynamo_tpu/ops/linear.py:334",
    }
    from dynamo_tpu_torch.ops.kernels import SOURCES

    kernels = []
    for name, replaced in replaces.items():
        # the fused heads' row is at the verify step's shape (M = 32)
        row = rows.get(name) or rows[f"{name}/M32"]
        kernels.append({
            "name": name, "route": "cuda", "source": f"dynamo_tpu_torch/csrc/{SOURCES[name][0]}.cu",
            "replaces": replaced, "launches": launches[name],
            "max_abs_err": errs[name], "ms": row["ms"]["median"],
            "plain_ms": row["plain_ms"]["median"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]["median"] if "library_ms" in row else None,
        })
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
