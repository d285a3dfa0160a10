"""Time design variants of the redesigned kernels (#3 flash prefill, #5
o-proj + residual, and #1 paged decode / #2 paged verify, which share
csrc/paged_attention.cuh) on the card, beside the shipped design.

    python3 -m dynamo_tpu_torch.tools.kernel_variants [--only NAME ...]

Each variant is the shipped source with a few text edits (``VARIANTS``),
built into its own directory under ``build/variants/`` (all builds at once)
and run in its own process: parity against the plain PyTorch version on the
timing inputs, then the kernel and its one-call PyTorch yardstick (the paged
kernels: the kernel alone) timed with CUDA events, the L2 cache flushed
before each call and the host's launch work held out, at Llama-3.1-8B shapes
(prefill P=2048, valid 2000, Hq 32, Hkv 8, D 128; o-proj M 8 and 32,
K = H = 4096; decode at chip_smoke.py's ragged contexts and at the B=8
step's shape, every context 1025; verify B=8, S=4 at chip_smoke.py's
bases). One JSON line per variant, with the ptxas notes that say
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
PA = "paged_attention.cuh"

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


def _paged(big_ring: bool = False, **consts) -> list:
    """Edits of the paged template's constants; a ring too large for the
    decode kernel's D=256 instantiation drops that head dim."""
    edits = []
    for name, value in consts.items():
        old = {"kDecodeStages": "2", "kVerifyStages": "4", "kStageKeys": "64",
               "kBlocksPerSM": "4", "kMinSplitKeys": "64"}[name]
        edits.append((PA, f"constexpr int {name} = {old};", f"constexpr int {name} = {value};"))
    if big_ring:
        edits.append(("paged_decode_attention.cu",
                      "    case 256: return paged::launch<256, true>(p, B, s);\n", ""))
    return edits


_PAGE_RUNS = """      // one copy per run of the stage's rows that lies in one page
      const int pg0 = a / bs;
      const int n_runs = (a + n - 1) / bs - pg0 + 1;
      for (int i = lane; i < n_runs; i += 32) {
        const int pg = pg0 + i;
        const int s0 = max(a, pg * bs);
        const int s1 = min(a + n, (pg + 1) * bs);
        const int page = table[min(pg, last_page)];
        const size_t src = (head_row0 + (size_t)page * bs + (s0 - pg * bs)) * D;
        bulk_load(dk + (s0 - a) * kS, p.k_cache + src, (s1 - s0) * D * 2, &full[st]);
        bulk_load(dv + (s0 - a) * kS, p.v_cache + src, (s1 - s0) * D * 2, &full[st]);
      }
"""
_ROWS = """      for (int r = lane; r < n; r += 32) {  // one copy per key row
        const int kpos = a + r;
        const int page = table[min(kpos / bs, last_page)];
        const size_t src = (head_row0 + (size_t)page * bs + kpos % bs) * D;
        bulk_load(dk + r * kS, p.k_cache + src, D * 2, &full[st]);
        bulk_load(dv + r * kS, p.v_cache + src, D * 2, &full[st]);
      }
"""
_LO_MMA = """          mma_16816(o[n], pl, bf[0], bf[1]);
          mma_16816(o[n + 1], pl, bf[2], bf[3]);
"""
_LO_MMA_DECODE = """          if (kDecode) {
            mma_16816(o[n], pl, bf[0], bf[1]);
            mma_16816(o[n + 1], pl, bf[2], bf[3]);
          }
"""
_PV_MMA = """        const __nv_bfloat16* vr = sv + (c * 16 + (mat & 1) * 8 + (lane & 7)) * kS + (mat >> 1) * 8;
#pragma unroll
        for (int n = 0; n < D / 8; n += 2) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, vr + n * 8);
          mma_16816(o[n], ph, bf[0], bf[1]);
          mma_16816(o[n + 1], ph, bf[2], bf[3]);
""" + _LO_MMA + """        }
"""
# P V in f32 on the CUDA cores: each thread gathers its two rows' 16
# weights from its quad and folds in the V rows at its accumulator columns
_PV_F32 = """        float pw[2][16];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int q4 = 0; q4 < 4; ++q4)
              pw[e >> 1][t * 8 + q4 * 2 + (e & 1)] =
                  __shfl_sync(0xffffffffu, s[t][e], (lane & ~3) | q4);
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const __nv_bfloat16* vk = sv + (c * 16 + k) * kS + tig * 2;
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            const float2 vf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vk + n * 8));
            o[n][0] = fmaf(pw[0][k], vf.x, o[n][0]);
            o[n][1] = fmaf(pw[0][k], vf.y, o[n][1]);
            o[n][2] = fmaf(pw[1][k], vf.x, o[n][2]);
            o[n][3] = fmaf(pw[1][k], vf.y, o[n][3]);
          }
        }
"""

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
    "paged/design": ("paged", [], "as shipped: 2 (decode) / 4 (verify) stages of 64 keys, "
                     "page-run copies, 4 blocks/SM at most, 64-key splits, P V in hi/lo form"),
    "paged/stages3": ("paged", _paged(kDecodeStages=3, kVerifyStages=3), "3-stage rings"),
    "paged/decode_stages4": ("paged", _paged(True, kDecodeStages=4),
                             "4-stage decode ring (no D=256 decode)"),
    "paged/verify_stages2": ("paged", _paged(kVerifyStages=2), "2-stage verify ring"),
    "paged/stage_keys32": ("paged", _paged(kStageKeys=32),
                           "32-key stages (half the bytes in flight)"),
    "paged/stage_keys32_stages4": ("paged", _paged(kStageKeys=32, kDecodeStages=4, kVerifyStages=8),
                                   "4 stages of 32 keys (the same bytes in flight)"),
    "paged/stage_keys128": ("paged", _paged(True, kStageKeys=128, kVerifyStages=2),
                            "2 stages of 128 keys (no D=256 decode)"),
    "paged/row_copy": ("paged", [
        (PA, "  return D;  // unpadded: page runs land as they lie in the cache",
         "  return D + 8;  // padded rows"),
        (PA, _PAGE_RUNS, _ROWS),
    ], "one bulk copy per key row into padded rows (no bank conflicts)"),
    "paged/pv_f32": ("paged", [(PA, _PV_MMA, _PV_F32)],
                     "P V in f32 on the CUDA cores instead of the bf16 hi/lo pair on mma.sync"),
    "paged/blocks_per_sm2": ("paged", _paged(kBlocksPerSM=2), "splits sized for 2 blocks per SM"),
    "paged/blocks_per_sm8": ("paged", _paged(kBlocksPerSM=8), "splits sized for 8 blocks per SM"),
    "paged/min_split128": ("paged", _paged(kMinSplitKeys=128), "splits of at least 128 keys"),
    "paged/min_split16": ("paged", _paged(kMinSplitKeys=16), "splits of at least 16 keys"),
    "paged/verify_bf16_p": ("paged", [(PA, _LO_MMA, _LO_MMA_DECODE)],
                            "verify rounds P to bf16 once (PR 2's numerics)"),
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
        torch.cuda._sleep(2_000_000)  # hold the stream until fn() is enqueued
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
    elif kernel == "paged":
        sys.path.insert(0, str(ROOT))
        import chip_smoke as cs

        err = 0.0
        cases = {
            "decode": (K.paged_decode_attention_cuda, A.paged_decode_attention_plain,
                       cs.decode_inputs(torch, cs.DECODE_LENS, seed=2)),
            "step": (K.paged_decode_attention_cuda, A.paged_decode_attention_plain,
                     cs.decode_inputs(torch, [cs.STEP_CTX + 1] * 8, seed=6)),
            "verify": (K.paged_verify_attention_cuda, A.paged_verify_attention_plain,
                       cs.verify_inputs(torch, cs.VERIFY_BASES, [cs.VERIFY_S - 1] * 8,
                                        cs.VERIFY_S, seed=5)),
        }
        for name, (fn, plain, args) in cases.items():
            err = max(err, float((fn(*args).float() - plain(*args).float()).abs().max()))
            for rnd in range(2):
                res[f"{name}_ms_{rnd}"] = _time_ms(torch, lambda: fn(*args), flush)
        res["max_abs_err"] = err
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
    src = {"prefill": ("flash_prefill_attention",), "oproj": ("fused_attn_out_residual",),
           "paged": ("paged_decode_attention", "paged_verify_attention")}
    builds = {}
    for name in names:
        d = _prepare(name)
        code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); from pathlib import Path; "
                f"from dynamo_tpu_torch.tools import kernel_variants as kv; "
                f"b = kv._use(Path({str(d)!r})); "
                f"info = b.build_all({src[VARIANTS[name][0]]!r}); "
                f"print('\\n'.join(r['ptxas'] for r in info.values()))")
        builds[name] = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
    notes, failed = {}, 0
    for name, proc in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failed += 1
            print(f"BUILD FAILED {name}\n{log[-4000:]}", flush=True)
            continue
        lines = log.splitlines()
        notes[name] = {
            # C7510-C7520: ptxas serialised the kernel's wgmma instructions
            "ptxas": sorted({ln.split("(")[1].split(")")[0] for ln in lines
                             if "Potential Performance Loss" in ln}),
            "spills": [ln.strip() for ln in lines
                       if "spill stores" in ln and not ln.strip().startswith("0 bytes")][:2],
        }
    for name in names:
        if name not in notes:
            continue
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
