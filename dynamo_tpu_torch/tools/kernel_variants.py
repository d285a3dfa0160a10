"""Time design variants of the redesigned kernels (#3 flash prefill, #5
o-proj + residual) on the card, beside the shipped design.

    python3 -m dynamo_tpu_torch.tools.kernel_variants [--only NAME ...]

Each variant is the shipped source with a few text edits (``VARIANTS``),
built into its own directory under ``build/variants/`` (all builds at once)
and run in its own process: parity against the plain PyTorch version on the
timing inputs, then the kernel and its one-call PyTorch yardstick timed with
CUDA events, the L2 cache flushed before each call, at Llama-3.1-8B shapes
(prefill P=2048, valid 2000, Hq 32, Hkv 8, D 128; o-proj M 8 and 32,
K = H = 4096). One JSON line per variant, with the ptxas notes that say
whether the compiler serialised wgmma (C75xx). Run from the root of a
checkout, on a machine with nvcc and a card.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "dynamo_tpu_torch" / "csrc"
OUT = ROOT / "build" / "variants"
PF = "flash_prefill_attention.cu"
OF = "fused_attn_out_residual.cu"
HC = "hopper_common.cuh"

_C_LOOP_WAIT = '''__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\\n.reg .pred p;\\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\\n"
        "selp.u32 %0, 1, 0, p;\\n}\\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}'''


def _oproj(cols: int, splits: int, stages: int) -> list:
    return [
        (OF, "constexpr int kCols = 64; ", f"constexpr int kCols = {cols}; "),
        (OF, "constexpr int kSplits = 4; ", f"constexpr int kSplits = {splits}; "),
        (OF, "constexpr int kStages = 3;", f"constexpr int kStages = {stages};"),
    ]


# name -> (kernel, text edits, what the variant changes)
VARIANTS = {
    "prefill/design": ("prefill", [], "as shipped"),
    "prefill/no_pingpong": ("prefill", [
        (PF, "  if (wg == 1) bar_arrive(1, kConsumers);  // warpgroup 0 issues first\n", ""),
        (PF, "  __syncwarp();\n  bar_sync(1 + wg, kConsumers);\n", "  __syncwarp();\n"),
        (PF, "  if (!(wg == 1 && n_tiles == 1)) bar_arrive(2 - wg, kConsumers);\n", ""),
        (PF, "    __syncwarp();\n    bar_sync(1 + wg, kConsumers);\n", "    __syncwarp();\n"),
        (PF, "    if (!(wg == 1 && t == n_tiles - 1)) bar_arrive(2 - wg, kConsumers);\n", ""),
    ], "the two warpgroups issue their products without taking turns"),
    "prefill/no_setmaxnreg": ("prefill", [
        (PF, "    reg_dealloc<kProducerRegs>();\n", ""),
        (PF, "  reg_alloc<kConsumerRegs>();\n", ""),
    ], "every thread keeps the ~168 registers of a 384-thread block"),
    "prefill/c_loop_wait": ("prefill", [
        (HC, "__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {",
         "__device__ __forceinline__ void mbar_wait_unused(uint64_t* bar, uint32_t parity) {"),
        (HC, "// TMA: one box of a tensor map", _C_LOOP_WAIT + "\n\n// TMA: one box of a tensor map"),
    ], "the mbarrier spin loop in C++ instead of inside the asm"),
    "prefill/stages3": ("prefill", [(PF, "constexpr int kStages = 2;", "constexpr int kStages = 3;")],
                        "3-stage K/V rings (224 KB of shared memory)"),
    "oproj/design": ("oproj", [], "as shipped: 64 columns, 4 splits, 3 stages"),
    "oproj/splits8_stages4": ("oproj", _oproj(64, 8, 4), "the first design: 8 splits, 4 stages"),
    "oproj/splits8": ("oproj", _oproj(64, 8, 3), "8 splits (512 blocks)"),
    "oproj/splits2": ("oproj", _oproj(64, 2, 3), "2 splits (128 blocks)"),
    "oproj/stages2": ("oproj", _oproj(64, 4, 2), "2 stages"),
    "oproj/stages4": ("oproj", _oproj(64, 4, 4), "4 stages"),
    "oproj/cols128": ("oproj", _oproj(128, 4, 3), "128-column tiles (two boxes per stage)"),
}


def _slug(name: str) -> str:
    return name.replace("/", "__")


def _prepare(name: str) -> Path:
    """Copy the sources and apply the variant's edits (each must match once)."""
    d = OUT / _slug(name)
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(CSRC, d / "csrc")
    for fname, old, new in VARIANTS[name][1]:
        f = d / "csrc" / fname
        text = f.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: edit does not match {fname} exactly once: {old[:60]!r}")
        f.write_text(text.replace(old, new))
    return d


def _use(d: Path):
    from dynamo_tpu_torch.ops import _build

    _build.CSRC = d / "csrc"
    _build.BUILD_DIR = d / "lib"
    return _build


def _time_ms(torch, fn, flush, reps: int = 30) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _child(name: str) -> dict:
    """Build (already done) and run one variant in this process."""
    import torch
    import torch.nn.functional as F

    kernel = VARIANTS[name][0]
    _use(OUT / _slug(name))
    from dynamo_tpu_torch.ops import attention as A
    from dynamo_tpu_torch.ops import cuda_attention as K
    from dynamo_tpu_torch.ops import cuda_linear as KL
    from dynamo_tpu_torch.ops import linear as L

    buf = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    flush = buf.zero_  # the same flush as chip_smoke.py
    g = torch.Generator().manual_seed(3)
    res = {"variant": name, "what": VARIANTS[name][2], "card": torch.cuda.get_device_name(0)}
    if kernel == "prefill":
        P, vl = 2048, 2000
        q, k, v = (torch.randn(P, h, 128, generator=g).bfloat16().cuda() for h in (32, 8, 8))
        got = K.flash_prefill_attention_cuda(q, k, v, vl)
        want = A.causal_prefill_attention_plain(q, k, v, vl)
        res["max_abs_err"] = float((got[:vl].float() - want[:vl].float()).abs().max())
        qs, ks, vs = (x[:vl].transpose(0, 1)[None] for x in (q, k, v))
        for rnd in range(2):  # kernel, yardstick, kernel, yardstick
            res[f"ms_{rnd}"] = _time_ms(torch, lambda: K.flash_prefill_attention_cuda(q, k, v, vl), flush)
            res[f"sdpa_ms_{rnd}"] = _time_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True, enable_gqa=True), flush)
    else:
        err = 0.0
        for M in (8, 32):
            x = torch.randn(M, 4096, generator=g).bfloat16().cuda()
            attn = torch.randn(M, 4096, generator=g).bfloat16().cuda()
            wo = (0.02 * torch.randn(4096, 4096, generator=g)).bfloat16().cuda()
            got = KL.fused_attn_out_residual_cuda(attn, wo, x)
            want = L.fused_attn_out_residual_plain(attn, wo, x)
            err = max(err, float((got.float() - want.float()).abs().max()))
            for rnd in range(2):
                res[f"M{M}_ms_{rnd}"] = _time_ms(torch, lambda: KL.fused_attn_out_residual_cuda(attn, wo, x), flush)
                res[f"M{M}_addmm_ms_{rnd}"] = _time_ms(torch, lambda: torch.addmm(x, attn, wo), flush)
        res["max_abs_err"] = err
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", default=None, help="variant names (default: all)")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print("VARIANT " + json.dumps(_child(args.child)), flush=True)
        return 0
    names = args.only or list(VARIANTS)
    src = {"prefill": "flash_prefill_attention", "oproj": "fused_attn_out_residual"}
    builds = {}
    for name in names:
        d = _prepare(name)
        code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); from pathlib import Path; "
                f"from dynamo_tpu_torch.tools import kernel_variants as kv; "
                f"b = kv._use(Path({str(d)!r})); "
                f"print(b.build_all(({src[VARIANTS[name][0]]!r},))[{src[VARIANTS[name][0]]!r}]['ptxas'])")
        builds[name] = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
    notes = {}
    for name, proc in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"BUILD FAILED {name}\n{log[-4000:]}", flush=True)
            return 1
        lines = log.splitlines()
        notes[name] = {
            # C7510-C7520: ptxas serialised the kernel's wgmma instructions
            "ptxas": sorted({ln.split("(")[1].split(")")[0] for ln in lines
                             if "Potential Performance Loss" in ln}),
            "spills": [ln.strip() for ln in lines
                       if "spill stores" in ln and not ln.strip().startswith("0 bytes")][:2],
        }
    failed = 0
    for name in names:
        r = subprocess.run([sys.executable, "-m", "dynamo_tpu_torch.tools.kernel_variants", "--child", name],
                           cwd=ROOT, capture_output=True, text=True, timeout=300)
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("VARIANT ")]
        if r.returncode or not lines:
            failed += 1
            print(f"FAILED {name} rc={r.returncode}\n{(r.stdout + r.stderr)[-3000:]}", flush=True)
            continue
        row = json.loads(lines[-1][len("VARIANT "):])
        row.update(notes[name])
        print(json.dumps(row), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
