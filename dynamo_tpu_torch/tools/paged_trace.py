"""Per-block timeline of the paged decode (#1) and verify (#2) kernels on the
card, from %globaltimer stamps.

    python3 -m dynamo_tpu_torch.tools.paged_trace

Copies csrc/ to ``build/trace/``, inserts stamps into paged_attention.cuh
(each text edit must match once) and builds both libraries there. Then, at
chip_smoke.py's shapes (decode at its ragged contexts and at the B=8 step's
shape, verify B=8, S=4), it runs one call with the stamps cleared and prints
one JSON line per shape: how many blocks were live, the span from the first
block's start to the last one's end, and percentiles (0, 10, 50, 90, 100) in
us of each live block's start, lifetime and phases -- prologue, first stage
landed, producer done issuing, consumers done, warp merge, the ticket, and
the last split's combine (staging the partials' max/sum, summing them) --
and the most blocks seen at once on an SM. Run from the root of a checkout,
on a machine with nvcc and a card. The stamps cost a few global stores per
block; the timeline is for finding where the time goes, not for timing.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "trace"
SLOTS = 16  # stamps per block: 0-6 and 8-9 times, 7 the SM id

_HEADER = f"""__device__ unsigned long long g_trace[65536 * {SLOTS}];
#define BID (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z))
#define TR(e) do {{ unsigned long long t_; \\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); g_trace[BID * {SLOTS} + (e)] = t_; }} while (0)
extern "C" int paged_trace_read(void* dst) {{
  return cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));
}}
extern "C" int paged_trace_clear() {{
  void* p;
  cudaGetSymbolAddress(&p, g_trace);
  return cudaMemset(p, 0, sizeof(g_trace));
}}
namespace paged {{
"""

# (text in paged_attention.cuh, what it becomes)
EDITS = [
    ("namespace paged {\n", _HEADER),
    ("  if (split >= n_live) return;  // nothing live here\n",
     "  if (split >= n_live) return;  // nothing live here\n"
     "  if (threadIdx.x == 0) { TR(0); unsigned sm; asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));"
     f" g_trace[BID * {SLOTS} + 7] = sm; }}\n"),
    ("    mbar_fence_init();\n  }\n  __syncthreads();\n",
     "    mbar_fence_init();\n  }\n  __syncthreads();\n  if (threadIdx.x == 0) TR(1);\n"),
    ("  } else {\n    // ---- consumers:", "    if (lane == 0) TR(2);\n  } else {\n    // ---- consumers:"),
    ("      mbar_wait(&full[st], (j / kStages) & 1);\n",
     "      mbar_wait(&full[st], (j / kStages) & 1);\n      if (warp == 0 && lane == 0 && j == 0) TR(3);\n"),
    ("#pragma unroll\n    for (int rr = 0; rr < 2; ++rr) {\n      l_run[rr] += __shfl_xor_sync",
     "    if (warp == 0 && lane == 0) TR(4);\n#pragma unroll\n    for (int rr = 0; rr < 2; ++rr) {\n"
     "      l_run[rr] += __shfl_xor_sync"),
    ("  if (n_live == 1) return;\n", "  if (tid == 0) TR(5);\n  if (n_live == 1) return;\n"),
    ("  __syncthreads();\n  if (!s_last) return;\n",
     "  __syncthreads();\n  if (tid == 0) TR(8);\n  if (!s_last) return;\n"),
    ("    sl[i] = __ldcg(pml + 2 * i + 1);\n  }\n  __syncthreads();\n",
     "    sl[i] = __ldcg(pml + 2 * i + 1);\n  }\n  __syncthreads();\n  if (tid == 0) TR(9);\n"),
    ("  if (tid == 0) p.tickets[tix] = 0;  // ready for the next call\n",
     "  if (tid == 0) p.tickets[tix] = 0;  // ready for the next call\n  if (tid == 0) TR(6);\n"),
]


def _prepare():
    if OUT.exists():
        shutil.rmtree(OUT)
    shutil.copytree(ROOT / "dynamo_tpu_torch" / "csrc", OUT / "csrc")
    f = OUT / "csrc" / "paged_attention.cuh"
    text = f.read_text()
    for old, new in EDITS:
        if text.count(old) != 1:
            raise RuntimeError(f"stamp edit does not match paged_attention.cuh once: {old[:60]!r}")
        text = text.replace(old, new)
    f.write_text(text)
    from dynamo_tpu_torch.ops import _build

    _build.CSRC = OUT / "csrc"
    os.environ["DYN_KERNEL_CACHE_DIR"] = str(OUT / "lib")
    return _build


def _pct(x) -> list:
    import numpy as np

    if len(x) == 0:
        return None
    return [round(float(np.percentile(x, p)) / 1e3, 2) for p in (0, 10, 50, 90, 100)]


def _timeline(torch, lib, fn, args, label: str) -> dict:
    import numpy as np

    buf = np.zeros(65536 * SLOTS, np.uint64)
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    lib.paged_trace_clear()
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000)  # the call's blocks start together
    fn(*args)
    torch.cuda.synchronize()
    lib.paged_trace_read(buf.ctypes.data)
    t = buf.reshape(-1, SLOTS).astype(np.int64)
    live = t[t[:, 0] > 0]
    end = np.where(live[:, 6] > 0, live[:, 6], live[:, 5])
    t0 = live[:, 0].min()
    ticket = live[:, 8] > 0
    last = live[:, 9] > 0
    per_sm = []
    for sm in set(live[:, 7].tolist()):
        on = live[:, 7] == sm
        events = sorted([(a, 1) for a in live[on, 0]] + [(b, -1) for b in end[on]])
        n = most = 0
        for _, d in events:
            n += d
            most = max(most, n)
        per_sm.append(most)
    return {
        "label": label, "live_blocks": int(len(live)), "span_us": float(end.max() - t0) / 1e3,
        "start_us": _pct(live[:, 0] - t0), "lifetime_us": _pct(end - live[:, 0]),
        "prologue_us": _pct(live[:, 1] - live[:, 0]),
        "first_stage_us": _pct(live[:, 3] - live[:, 1]),
        "producer_issue_us": _pct(live[:, 2] - live[:, 1]),
        "consume_us": _pct(live[:, 4] - live[:, 3]), "merge_us": _pct(live[:, 5] - live[:, 4]),
        "to_ticket_us": _pct((live[:, 8] - live[:, 5])[ticket]),
        "stage_partials_us": _pct((live[:, 9] - live[:, 8])[last]),
        "sum_partials_us": _pct((live[:, 6] - live[:, 9])[last]),
        "sms_used": len(per_sm), "most_blocks_per_sm": [min(per_sm), max(per_sm)],
    }


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("paged_trace: needs a CUDA device", file=sys.stderr)
        return 1
    build = _prepare()
    from dynamo_tpu_torch.ops import cuda_attention as K

    build.build_all(("paged_decode_attention", "paged_verify_attention"))
    libs = {n: build.load(n) for n in ("paged_decode_attention", "paged_verify_attention")}
    for lib in libs.values():
        lib.paged_trace_read.argtypes = [ctypes.c_void_p]
    card = cs.nvidia_smi_line()
    cases = [
        ("decode ragged", "paged_decode_attention", K.paged_decode_attention_cuda,
         cs.decode_inputs(torch, cs.DECODE_LENS, seed=2)),
        ("decode step", "paged_decode_attention", K.paged_decode_attention_cuda,
         cs.decode_inputs(torch, [cs.STEP_CTX + 1] * 8, seed=6)),
        ("verify", "paged_verify_attention", K.paged_verify_attention_cuda,
         cs.verify_inputs(torch, cs.VERIFY_BASES, [cs.VERIFY_S - 1] * 8, cs.VERIFY_S, seed=5)),
    ]
    for label, lib, fn, args in cases:
        row = _timeline(torch, libs[lib], fn, args, label)
        print(json.dumps({**row, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
