"""Per-block timeline of the fused norm + QKV + RoPE kernel (#4) on the card,
from %globaltimer stamps.

    python3 -m dynamo_tpu_torch.tools.qkv_trace

Copies csrc/ to ``build/qkv_trace/``, inserts stamps into fused_qkv_rope.cu
(each text edit must match once) and builds it there. Then, at
chip_smoke.py's fused-head shapes (Llama-3.1-8B width, M = 8 and 32), it
runs one call with the L2 cache flushed before it and one without, and
prints one JSON line per run: the span from the first block's start to the
last one's end, and percentiles (0, 10, 50, 90, 100) in us of each block's
start and of its phases -- prologue (barriers), the norm's sums of x^2 (and
the staging of its weights), the cluster exchange of the sums, the
consumers' start on the first weight stage, the product, the producer's last
load issued, the partials' exchange, the epilogue and the last cluster
barrier -- and the most blocks seen at once on an SM. Run from the root of a checkout, on
a machine with nvcc and a card. The stamps cost a few global stores per
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
OUT = ROOT / "build" / "qkv_trace"
SLOTS = 16  # stamps per block: 0-6 and 8-11 times, 7 the SM id
SRC = "fused_qkv_rope.cu"

_HEADER = f"""__device__ unsigned long long g_trace[65536 * {SLOTS}];
#define BID (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z))
#define TR(e) do {{ unsigned long long t_; \\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); g_trace[BID * {SLOTS} + (e)] = t_; }} while (0)
extern "C" int qkv_trace_read(void* dst) {{
  return cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));
}}
extern "C" int qkv_trace_clear() {{
  void* p;
  cudaGetSymbolAddress(&p, g_trace);
  return cudaMemset(p, 0, sizeof(g_trace));
}}
namespace qkv {{
"""

# (text in fused_qkv_rope.cu, what it becomes)
EDITS = [
    ("namespace qkv {\n", _HEADER),
    ("  __shared__ float s_rs[kRowGroup];  // rsqrt(mean(x^2) + eps) per row\n  if (tid == 0) {\n",
     "  __shared__ float s_rs[kRowGroup];  // rsqrt(mean(x^2) + eps) per row\n  if (tid == 0) {\n"
     "    TR(0); unsigned sm; asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));"
     f" g_trace[BID * {SLOTS} + 7] = sm;\n"),
    ("    mbar_fence_init();\n  }\n  __syncthreads();\n",
     "    mbar_fence_init();\n  }\n  __syncthreads();\n  if (tid == 0) TR(1);\n"),
    ("    __syncwarp();\n    cluster_wait();\n  } else {",
     "    if (tid == kConsumers) TR(10);\n    __syncwarp();\n    cluster_wait();\n  } else {"),
    ("      *reinterpret_cast<uint4*>(s_w + (k - k_lo)) = norm_w8(k);\n    cluster_arrive();\n",
     "      *reinterpret_cast<uint4*>(s_w + (k - k_lo)) = norm_w8(k);\n    if (tid == 0) TR(2);\n"
     "    cluster_arrive();\n"),
    ("    consumers_sync();\n\n    // ---- the product",
     "    consumers_sync();\n    if (tid == 0) TR(3);\n\n    // ---- the product"),
    ("      mbar_wait(full + st, (i / kStages) & 1);\n",
     "      mbar_wait(full + st, (i / kStages) & 1);\n      if (tid == 0 && i == 0) TR(4);\n"),
    ("    consumers_sync();  // every warp is done with the ring: it becomes the partial tile\n",
     "    consumers_sync();  // every warp is done with the ring: it becomes the partial tile\n"
     "    if (tid == 0) TR(5);\n"),
    ("  // every split's partials are in place before any rank reads its peers'\n"
     "  cluster_arrive();\n  cluster_wait();\n",
     "  // every split's partials are in place before any rank reads its peers'\n"
     "  cluster_arrive();\n  cluster_wait();\n  if (tid == 0) TR(6);\n"),
    ("  // no block leaves while a peer may still read its partials\n"
     "  cluster_arrive();\n  cluster_wait();\n",
     "  __syncthreads();\n  if (tid == 0) TR(8);\n"
     "  // no block leaves while a peer may still read its partials\n"
     "  cluster_arrive();\n  cluster_wait();\n  if (tid == 0) TR(9);\n"),
]


def _prepare():
    if OUT.exists():
        shutil.rmtree(OUT)
    shutil.copytree(ROOT / "dynamo_tpu_torch" / "csrc", OUT / "csrc")
    f = OUT / "csrc" / SRC
    text = f.read_text()
    for old, new in EDITS:
        if text.count(old) != 1:
            raise RuntimeError(f"stamp edit does not match {SRC} once: {old[:60]!r}")
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


def _timeline(torch, lib, fn, flush, label: str) -> dict:
    import numpy as np

    buf = np.zeros(65536 * SLOTS, np.uint64)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    lib.qkv_trace_clear()
    if flush is not None:
        flush()
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000)  # the call's blocks start together
    fn()
    torch.cuda.synchronize()
    lib.qkv_trace_read(buf.ctypes.data)
    t = buf.reshape(-1, SLOTS).astype(np.int64)
    live = t[t[:, 0] > 0]
    t0 = live[:, 0].min()
    per_sm = []
    for sm in set(live[:, 7].tolist()):
        on = live[:, 7] == sm
        events = sorted([(a, 1) for a in live[on, 0]] + [(b, -1) for b in live[on, 9]])
        n = most = 0
        for _, d in events:
            n += d
            most = max(most, n)
        per_sm.append(most)
    return {
        "label": label, "blocks": int(len(live)), "span_us": float(live[:, 9].max() - t0) / 1e3,
        "start_us": _pct(live[:, 0] - t0), "lifetime_us": _pct(live[:, 9] - live[:, 0]),
        "prologue_us": _pct(live[:, 1] - live[:, 0]),
        "norm_sums_us": _pct(live[:, 2] - live[:, 1]),
        "norm_exchange_us": _pct(live[:, 3] - live[:, 2]),
        "product_start_us": _pct(live[:, 4] - live[:, 1]),
        "product_us": _pct(live[:, 5] - np.maximum(live[:, 3], live[:, 4])),
        "producer_issue_us": _pct(live[:, 10] - live[:, 1]),
        "partials_exchange_us": _pct(live[:, 6] - live[:, 5]),
        "epilogue_us": _pct(live[:, 8] - live[:, 6]),
        "last_barrier_us": _pct(live[:, 9] - live[:, 8]),
        "sms_used": len(per_sm), "most_blocks_per_sm": [min(per_sm), max(per_sm)],
    }


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("qkv_trace: needs a CUDA device", file=sys.stderr)
        return 1
    build = _prepare()
    from dynamo_tpu_torch.ops import cuda_linear as KL

    build.build_all(("fused_qkv_rope",))
    lib = build.load("fused_qkv_rope")
    lib.qkv_trace_read.argtypes = [ctypes.c_void_p]
    card = cs.nvidia_smi_line()
    flush = cs.make_flush(torch)
    for M in (8, 32):
        t = cs.gemv_inputs(torch, M, seed=20 + M)
        for flushed in (True, False):
            row = _timeline(torch, lib, lambda: cs.qkv_call(KL.fused_qkv_rope_cuda, t),
                            flush if flushed else None, f"M={M} {'flushed' if flushed else 'warm'}")
            print(json.dumps({**row, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
