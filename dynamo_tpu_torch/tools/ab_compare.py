"""Compare two checkouts of the port end to end on one card, in turns.

    git archive <base commit> | tar -x -C build/ab/base   # where git is
    python3 -m dynamo_tpu_torch.tools.ab_compare build/ab/base .

Legs run in the order base, change, change, base, each in its own process
from its own checkout (which builds that checkout's kernels and uses its
``chip_smoke.py`` helpers). Each leg builds Llama-3.1-8B at full width
(random bf16 weights from seed 0) with the fused heads off and on, and
measures: TTFT of one request alone at 16 / 128 / 512 / 2000 tokens, the
2000-token prefill's device time (torch.profiler), the B=8 decode step at
context 1024 with the fused heads off and on (wall and device time), the
device time of those steps and of one B=8, S=4 verify dispatch there with
their paged attention kernels' and fused QKV head's (#4, all its
launches) share per layer (profiler), kernels #3 (prefill, P=2048, valid
2000), #4 (fused QKV, M 8 and 32) and #5 (o-proj, M 8 and 32) beside their
one-call PyTorch yardsticks, #1 (decode) at chip_smoke.py's ragged contexts
and at the step's shape and #2 (verify, B=8, S=4), and spec decode's warm
tokens/s off and on (chip_smoke.py's serve_spec phase). Prints one JSON line per leg, then the
per-checkout medians of the two legs.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time


def _time_ms(torch, fn, flush, reps: int = 20) -> float:
    """Median CUDA-event time of fn() with the L2 cache flushed before each
    call; a spin kernel holds the stream until fn() is enqueued, so the
    host's launch work is not timed (the same method in every leg)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# #4's kernels in either design: one cluster launch, or a norm, a split-K
# product and an epilogue
QKV_KERNELS = ("fused_qkv_rope_kernel", "rmsnorm_rows", "splitk_gemm_kernel", "qkv_epilogue")


def _attention_us(torch, fn, calls: int, layers: int) -> dict:
    """Device time of fn() per call, and of its paged decode / verify
    attention kernels and its fused QKV head per layer, under
    torch.profiler. Kernel names of either design: the earlier
    paged_{decode,verify}_* kernels (with their combine launches) or the
    paged_attention_kernel template; QKV_KERNELS for #4."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the profiler can drop a session's first device record: a spin
        # kernel takes that place and is left out below
        torch.cuda._sleep(1000)
        for _ in range(calls):
            fn()
    total = {"device_ms": 0.0, "decode_attention_us": 0.0, "verify_attention_us": 0.0,
             "qkv_head_us": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or "spin_kernel" in e.key:
            continue
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        total["device_ms"] += us / 1e3 / calls
        # the template's second argument: true for decode, false for verify
        if "paged_decode" in e.key or re.search(r"paged_attention_kernel<\d+, true\b", e.key):
            total["decode_attention_us"] += us / calls / layers
        if "paged_verify" in e.key or re.search(r"paged_attention_kernel<\d+, false\b", e.key):
            total["verify_attention_us"] += us / calls / layers
        if any(name in e.key for name in QKV_KERNELS):
            total["qkv_head_us"] += us / calls / layers
    return total


def _leg(root: str, name: str) -> None:
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.ops import _build
    from dynamo_tpu_torch.ops import cuda_attention as K
    from dynamo_tpu_torch.ops import cuda_linear as KL
    from dynamo_tpu_torch.ops.basics import rms_norm

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi_line()
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    kw = dict(device="cuda", max_batch=8, max_model_len=cs.MAX_MODEL_LEN, seed=0, spec_k=0)
    plain = build_torch_engine(cs.LLAMA31_8B, fused_decode=False, **kw)
    fused = build_torch_engine(cs.LLAMA31_8B, fused_decode=True, params=plain.runner.params, **kw)
    eng = cs.phase_engine_times(torch, np, plain, fused.runner, card)
    r, fr = plain.runner, fused.runner
    L = r.config.num_layers
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, r.config.vocab_size, 2000).tolist()
    blocks = list(range(1, (2000 + r.block_size - 1) // r.block_size + 1))
    prefill_dev = cs.device_ms_per_call(
        torch, lambda: r.fetch_sample(r.prefill(prompt, blocks, 0.0, 1.0, 0)))
    # the B=8 step at context 1024 (fused heads off and on) and one S=4
    # verify dispatch there, with their attention kernels' share
    B, ctx, bs = 8, 1024, r.block_size
    per = (ctx + 1 + bs - 1) // bs
    tables = np.zeros((B, r.max_blocks_per_seq), np.int32)
    for b in range(B):
        tables[b, :per] = np.arange(1 + b * per, 1 + (b + 1) * per)
    pos = np.full(B, ctx, np.int64)
    slots = tables[np.arange(B), pos // bs].astype(np.int64) * bs + pos % bs
    toks = rng.integers(0, r.config.vocab_size, B)
    drafts = rng.integers(0, r.config.vocab_size, (B, 3))
    zeros, ones, kz = np.zeros(B, np.float32), np.ones(B, np.float32), np.zeros(B, np.int64)
    def step(rr):
        return rr.fetch_sample(rr.decode(toks, pos, tables, slots, zeros, ones, kz))

    steps = {f"step_{n}": (lambda rr=rr: step(rr)) for n, rr in (("unfused", r), ("fused", fr))}
    steps["verify_dispatch"] = lambda: fr.spec_verify(
        3, 0, toks, drafts, np.full(B, 3), pos, tables, zeros, ones, kz,
        np.zeros((B, 2), np.int64), np.ones(B, bool), np.full(B, 1 << 20, np.int64)).cpu()
    profiled = {}
    for n, fn in steps.items():
        fn()
        profiled[n] = _attention_us(torch, fn, 5, L)
    flush = cs.make_flush(torch)
    q, k, v = cs.prefill_inputs(torch, 2048, seed=3)
    qs, ks, vs = (x[:2000].transpose(0, 1)[None] for x in (q, k, v))
    kt = {
        "prefill": _time_ms(torch, lambda: K.flash_prefill_attention_cuda(q, k, v, 2000), flush),
        "sdpa": _time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True, enable_gqa=True), flush),
    }
    for M in (8, 32):
        t = cs.gemv_inputs(torch, M, seed=20 + M)
        kt[f"qkv_M{M}"] = _time_ms(torch, lambda: cs.qkv_call(KL.fused_qkv_rope_cuda, t), flush)
        xn = rms_norm(t["x"], t["norm"], 1e-5)
        wqkv = torch.cat([t["wq"], t["wk"], t["wv"]], dim=1)
        kt[f"matmul_M{M}"] = _time_ms(torch, lambda: torch.matmul(xn, wqkv), flush)
        kt[f"oproj_M{M}"] = _time_ms(
            torch, lambda: KL.fused_attn_out_residual_cuda(t["attn"], t["wo"], t["x"]), flush)
        kt[f"addmm_M{M}"] = _time_ms(torch, lambda: torch.addmm(t["x"], t["attn"], t["wo"]), flush)
    for n, lens in (("decode_ragged", cs.DECODE_LENS), ("decode_step", [ctx + 1] * B)):
        args = cs.decode_inputs(torch, lens, seed=2)
        kt[n] = _time_ms(torch, lambda: K.paged_decode_attention_cuda(*args), flush)
    args = cs.verify_inputs(torch, cs.VERIFY_BASES, [cs.VERIFY_S - 1] * 8, cs.VERIFY_S, seed=5)
    kt["verify"] = _time_ms(torch, lambda: K.paged_verify_attention_cuda(*args), flush)
    # spec decode tokens/s on the repeating traffic (the leg's own phase)
    spec = cs.phase_serve_spec(torch, np, card, r.params)
    row = {
        "leg": name, "checkout": root, "card": card, "build_s": build_s,
        "ttft_ms": {n: v["median"] for n, v in eng["ttft_ms_alone"].items()},
        "prefill_2000_device_ms": prefill_dev,
        "decode_step_B8": {n: {"wall_ms": v["median"], "device_ms": v["device_ms"]}
                           for n, v in eng["decode_step_ms_B8"].items()},
        "profiled": profiled,
        "kernel_ms": kt,
        "spec_tok_per_s": spec["output_tok_per_s_warm"],
    }
    print("LEG " + json.dumps(row), flush=True)
    # the engines hold no running loop; leave without waiting on library threads
    os._exit(0)


def _flat(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif isinstance(v, (int, float)):
            out[f"{prefix}{k}"] = v
    return out


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--leg":
        _leg(os.path.abspath(sys.argv[2]), sys.argv[3])
        return 0
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    dirs = {"base": os.path.abspath(sys.argv[1]), "change": os.path.abspath(sys.argv[2])}
    legs = {"base": [], "change": []}
    for name in ("base", "change", "change", "base"):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--leg", dirs[name], name],
                              capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("LEG ")]
        if not lines:
            print(f"leg {name} failed (rc {proc.returncode}):\n{(proc.stdout + proc.stderr)[-3000:]}",
                  file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
        legs[name].append(_flat(json.loads(lines[-1][4:])))
    med = {name: {k: statistics.median(r[k] for r in rows) for k in rows[0]}
           for name, rows in legs.items()}
    print("MEDIANS " + json.dumps(med), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
