"""Compare two checkouts of the port end to end on one card, in turns.

    git archive <base commit> | tar -x -C build/ab/base   # where git is
    python3 -m dynamo_tpu_torch.tools.ab_compare build/ab/base .

Legs run in the order base, change, change, base, each in its own process
from its own checkout (which builds that checkout's kernels and uses its
``chip_smoke.py`` helpers). Each leg builds Llama-3.1-8B at full width
(random bf16 weights from seed 0) with the fused heads off and on, and
measures: TTFT of one request alone at 16 / 128 / 512 / 2000 tokens, the
2000-token prefill's device time (torch.profiler), the B=8 decode step at
context 1024 with the fused heads off and on (wall and device time), and
kernels #3 (prefill, P=2048, valid 2000) and #5 (o-proj, M 8 and 32) beside
their one-call PyTorch yardsticks. Prints one JSON line per leg, then the
per-checkout medians of the two legs.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time


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

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi_line()
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    kw = dict(device="cuda", max_batch=8, max_model_len=cs.MAX_MODEL_LEN, seed=0, spec_k=0)
    plain = build_torch_engine(cs.LLAMA31_8B, fused_decode=False, **kw)
    fused = build_torch_engine(cs.LLAMA31_8B, fused_decode=True, params=plain.runner.params, **kw)
    eng = cs.phase_engine_times(torch, np, plain, fused.runner, card)
    r = plain.runner
    prompt = np.random.default_rng(1).integers(0, r.config.vocab_size, 2000).tolist()
    blocks = list(range(1, (2000 + r.block_size - 1) // r.block_size + 1))
    prefill_dev = cs.device_ms_per_call(
        torch, lambda: r.fetch_sample(r.prefill(prompt, blocks, 0.0, 1.0, 0)))
    flush = cs.make_flush(torch)
    q, k, v = cs.prefill_inputs(torch, 2048, seed=3)
    qs, ks, vs = (x[:2000].transpose(0, 1)[None] for x in (q, k, v))
    kt = {
        "prefill": cs.time_ms(torch, lambda: K.flash_prefill_attention_cuda(q, k, v, 2000), flush=flush),
        "sdpa": cs.time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True, enable_gqa=True), flush=flush),
    }
    for M in (8, 32):
        t = cs.gemv_inputs(torch, M, seed=20 + M)
        kt[f"oproj_M{M}"] = cs.time_ms(
            torch, lambda: KL.fused_attn_out_residual_cuda(t["attn"], t["wo"], t["x"]), flush=flush)
        kt[f"addmm_M{M}"] = cs.time_ms(torch, lambda: torch.addmm(t["x"], t["attn"], t["wo"]), flush=flush)
    row = {
        "leg": name, "checkout": root, "card": card, "build_s": build_s,
        "ttft_ms": {n: v["median"] for n, v in eng["ttft_ms_alone"].items()},
        "prefill_2000_device_ms": prefill_dev,
        "decode_step_B8": {n: {"wall_ms": v["median"], "device_ms": v["device_ms"]}
                           for n, v in eng["decode_step_ms_B8"].items()},
        "kernel_ms": {n: v["median"] for n, v in kt.items()},
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
