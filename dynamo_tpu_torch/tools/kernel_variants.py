"""Time design variants of the redesigned kernels (#3 flash prefill, #4
fused norm + QKV + RoPE, #5 o-proj + residual, and #1 paged decode / #2
paged verify, which share csrc/paged_attention.cuh) on the card, beside the
shipped design.

    python3 -m dynamo_tpu_torch.tools.kernel_variants [--only NAME ...]

Each variant is the shipped source with a few text edits (``VARIANTS``),
built into its own directory under ``build/variants/`` (all builds at once)
and run in its own process: parity against the plain PyTorch version on the
timing inputs, then the kernel and its one-call PyTorch yardstick (the paged
kernels: the kernel alone) timed with CUDA events, the L2 cache flushed
before each call and the host's launch work held out, at Llama-3.1-8B shapes
(prefill P=2048, valid 2000, Hq 32, Hkv 8, D 128; QKV and o-proj M 8 and
32, hidden 4096, QKV beside one matmul over pre-normed rows; decode at
chip_smoke.py's ragged contexts and at the B=8
step's shape, every context 1025; verify B=8, S=4 at chip_smoke.py's
bases). One JSON line per variant, with the ptxas notes that say
whether the compiler serialised wgmma (C75xx). Run from the root of a
checkout, on a machine with nvcc and a card.
"""

from __future__ import annotations

import argparse
import json
import os
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
QF = "fused_qkv_rope.cu"

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


def _qkv(splits: int, stages: int) -> list:
    return [
        (QF, "constexpr int kSplits = 4; ", f"constexpr int kSplits = {splits}; "),
        (QF, "constexpr int kStages = 3;", f"constexpr int kStages = {stages};"),
    ]


def _paged(big_ring: bool = False, **consts) -> list:
    """Edits of the paged template's constants; a ring too large for the
    D=256 instantiations drops that head dim."""
    edits = []
    for name, value in consts.items():
        old = {"kDecodeStages": "2", "kVerifyStages": "4", "kStageKeys": "64",
               "kBlocksPerSM": "4", "kMinSplitKeys": "64"}[name]
        edits.append((PA, f"constexpr int {name} = {old};", f"constexpr int {name} = {value};"))
    if big_ring:
        edits.append(("paged_decode_attention.cu",
                      "    case 256: return paged::launch<256, true>(p, B, s);\n", ""))
        edits.append(("paged_verify_attention.cu",
                      "    case 256: return paged::launch<256, false>(p, B, s);\n", ""))
    return edits


# the bf16 mode's page-run copies as shipped, and one copy per key row into
# padded ring rows (the int8 mode keeps its unpadded int8 rows)
_PAGE_RUNS = """      for (int i = lane; i < n_runs; i += 32) {
        const int pg = pg0 + i;
        const int s0 = max(a, pg * bs);
        const int s1 = min(a + n, (pg + 1) * bs);
        const int page = table[min(pg, last_page)];
        const size_t src = (head_row0 + (size_t)page * bs + (s0 - pg * bs)) * kRowB;
        bulk_load(dk + (s0 - a) * kRowB, kc + src, (s1 - s0) * kRowB, &full[st]);
        bulk_load(dv + (s0 - a) * kRowB, vc + src, (s1 - s0) * kRowB, &full[st]);
      }
"""
_ROWS = """      for (int r = lane; r < n; r += 32) {  // one copy per key row
        const int kpos = a + r;
        const int page = table[min(kpos / bs, last_page)];
        const size_t src = (head_row0 + (size_t)page * bs + kpos % bs) * (D * kEB);
        bulk_load(dk + r * kRowB, kc + src, D * kEB, &full[st]);
        bulk_load(dv + r * kRowB, vc + src, D * kEB, &full[st]);
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
_PV_MMA = """        const __nv_bfloat16* vr = cv + ((mat & 1) * 8 + (lane & 7)) * rs + (mat >> 1) * 8;
#pragma unroll
        for (int n = 0; n < D / 8; n += 2) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, vr + n * 8);
          mma_16816(o[n], ph, bf[0], bf[1]);
          mma_16816(o[n + 1], ph, bf[2], bf[3]);
""" + _LO_MMA + """        }
"""
# #4's norm pass as shipped, and one row at a time per warp
_QKV_NORM_ROWS = '''    // ---- the norm: this rank's sum of x^2 per row over [k_lo, k_hi). Warp
    // w sums rows w, w + 4, w + 8, w + 12 of each 16; each lane keeps the
    // 16-byte loads of all those rows, kNormSteps k steps deep, in flight at
    // once (they come from L2, and this pass delays the first product)
    constexpr int kNormSteps = MT == 1 ? 4 : MT == 2 ? 2 : 1;
    double ss[MT][4];
#pragma unroll
    for (int g = 0; g < MT; ++g)
#pragma unroll
      for (int q = 0; q < 4; ++q) ss[g][q] = 0.0;
    for (int k = k_lo + lane * 8; k < k_hi; k += kNormSteps * 32 * 8) {
      uint4 u[MT][4][kNormSteps];
#pragma unroll
      for (int g = 0; g < MT; ++g)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j = 0; j < kNormSteps; ++j) {
            const int r = g * 16 + warp + 4 * q;
            const int kj = k + j * 32 * 8;
            u[g][q][j] = r < rows && kj < k_hi
                             ? *reinterpret_cast<const uint4*>(a.x + (size_t)(row0 + r) * a.H + kj)
                             : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
      for (int g = 0; g < MT; ++g)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j = 0; j < kNormSteps; ++j) {
            const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u[g][q][j]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(h2[e]);
              ss[g][q] = fma((double)f.x, (double)f.x, ss[g][q]);
              ss[g][q] = fma((double)f.y, (double)f.y, ss[g][q]);
            }
          }
    }
#pragma unroll
    for (int g = 0; g < MT; ++g)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        double v = ss[g][q];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) s_ss[g * 16 + warp + 4 * q] = v;
      }
'''
_QKV_NORM_SERIAL = '''    // ---- the norm: this rank's sum of x^2 per row over [k_lo, k_hi)
    for (int r = warp; r < MT * 16; r += kConsumers / 32) {
      double ss = 0.0;
      if (r < rows) {
        const __nv_bfloat16* xr = a.x + (size_t)(row0 + r) * a.H;
        for (int k = k_lo + lane * 8; k < k_hi; k += 32 * 8) {
          const uint4 u = *reinterpret_cast<const uint4*>(xr + k);
          const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h2[e]);
            ss = fma((double)f.x, (double)f.x, ss);
            ss = fma((double)f.y, (double)f.y, ss);
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      if (lane == 0) s_ss[r] = ss;
    }
'''
# #4's stage normalisation as shipped (replaced by the variants below)
_QKV_SMEM_NORMALISE = """      // x -> bf16 xn in place: x * rsqrt, then * norm_w, one rounding
      unsigned char* sa_p = smem + L::kA + st * L::kABytes;
      for (int j = tid; j < MT * 16 * 8; j += kConsumers) {
        const int r = j >> 3;
        const int ch = j & 7;
        const int k = k0 + ch * 8;
        if (k >= a.H) continue;  // TMA's zeros past H stay zeros
        uint4* p = reinterpret_cast<uint4*>(sa_p + swz128(r, ch));
        uint4 u = *p;
        const uint4 wu = *reinterpret_cast<const uint4*>(s_w + (k - k_lo));
        __nv_bfloat162* xv = reinterpret_cast<__nv_bfloat162*>(&u);
        const __nv_bfloat162* wv = reinterpret_cast<const __nv_bfloat162*>(&wu);
        const float rs = s_rs[r];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xf = __bfloat1622float2(xv[e]);
          const float2 wf = __bfloat1622float2(wv[e]);
          xv[e] = __floats2bfloat162_rn(__fmul_rn(__fmul_rn(xf.x, rs), wf.x),
                                        __fmul_rn(__fmul_rn(xf.y, rs), wf.y));
        }
        *p = u;
      }
"""
# the stage's barrier, which then only the int8 mode's widened weights need
_QKV_STAGE_SYNC = (
    QF, "      fence_proxy_async();  // before a later TMA write refills these bytes\n"
        "      consumers_sync();     // every row of xn (and the widened weights) is in place\n",
    "      if constexpr (kInt8) {  // the widened weights are in place\n"
    "        fence_proxy_async();\n"
    "        consumers_sync();\n"
    "      }\n")
# each thread normalises its own A fragments (rows g, g + 8; k columns kc,
# kc + 1, kc + 8, kc + 9) with two f32 products and one rounding
_QKV_REGISTER_NORMALISE = """          ldsm_x4_at(af[mt], sa + swz128(mt * 16 + (mat & 1) * 8 + (lane & 7), kk * 2 + (mat >> 1)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int g = lane >> 2;
          const int kc = k0 + kk * 16 + 2 * (lane & 3);
          const float rs[2] = {s_rs[mt * 16 + g], s_rs[mt * 16 + g + 8]};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int k = kc + (q >> 1) * 8;
            const float2 w = k < a.H ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s_w + (k - k_lo)))
                                     : make_float2(0.f, 0.f);
            const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&af[mt][q]));
            af[mt][q] = pack_bf16(__fmul_rn(__fmul_rn(x.x, rs[q & 1]), w.x),
                                  __fmul_rn(__fmul_rn(x.y, rs[q & 1]), w.y));
          }
        }
"""

# #4 with the producer warp normalising each landed x tile (off the
# consumers' path) behind a third, "ready" barrier per stage, 4 stages
_QKV_PRODUCER_NORMALISE = [
    (QF, 'constexpr int kKC = 64;                    // contraction rows per ring stage\nconstexpr int kStages = 3;\n',
     'constexpr int kKC = 64;                    // contraction rows per ring stage\nconstexpr int kStages = 4;\n'),
    (QF, "  static constexpr int kNormW = (kBar + 2 * kStages * 8 + 15) & ~15;  // the split's norm weights\n",
     "  static constexpr int kNormW = (kBar + 3 * kStages * 8 + 15) & ~15;  // the split's norm weights\n"),
    (QF, '  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);  // [kStages]\n  uint64_t* empty = full + kStages;\n',
     '  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);  // [kStages]: tiles landed\n  uint64_t* ready = full + kStages;                               // x normalised\n  uint64_t* empty = ready + kStages;                              // consumers done\n'),
    (QF, '      mbar_init(full + s, 1);\n      mbar_init(empty + s, kConsumers / 32);  // one arrival per consumer warp\n',
     '      mbar_init(full + s, 1);\n      mbar_init(ready + s, 1);\n      mbar_init(empty + s, kConsumers / 32);  // one arrival per consumer warp\n'),
    (QF, "  if (tid >= kConsumers) {\n    // ---- producer warp: nothing to publish for the norm; one lane streams\n    // the split's weight and x tiles\n    cluster_arrive();\n    if (tid == kConsumers) {\n      for (int i = 0; i < n; ++i) {\n        const int st = i % kStages;\n        const int k0 = (c_begin + i) * kKC;\n        mbar_wait(empty + st, ((i / kStages) & 1) ^ 1);  // the first round passes at once\n        mbar_expect_tx(full + st, (kInt8 ? kQBytes : kWBytes) + L::kABytes);\n        unsigned char* w = kInt8 ? smem + L::kQ + st * kQBytes : smem + L::kW + st * kWBytes;\n        tma_load_2d(w, tm_w, full + st, c0, k0);\n        tma_load_2d(w + (kInt8 ? kQBoxBytes : kBoxBytes), tm_w, full + st, c1, k0);\n        tma_load_2d(smem + L::kA + st * L::kABytes, &tm_x, full + st, k0, row0);\n      }\n    }\n",
     "  if (tid >= kConsumers) {\n    // ---- producer warp: one lane streams the split's weight and x tiles;\n    // all 32 lanes turn each landed x tile into bf16 xn in place and\n    // signal it ready, off the consumers' path\n    const int pl = tid - kConsumers;\n    auto issue = [&](int i) {\n      const int st = i % kStages;\n      const int k0 = (c_begin + i) * kKC;\n      mbar_expect_tx(full + st, (kInt8 ? kQBytes : kWBytes) + L::kABytes);\n      unsigned char* w = kInt8 ? smem + L::kQ + st * kQBytes : smem + L::kW + st * kWBytes;\n      tma_load_2d(w, tm_w, full + st, c0, k0);\n      tma_load_2d(w + (kInt8 ? kQBoxBytes : kBoxBytes), tm_w, full + st, c1, k0);\n      tma_load_2d(smem + L::kA + st * L::kABytes, &tm_x, full + st, k0, row0);\n    };\n    cluster_arrive();  // nothing to publish for the norm\n    if (pl == 0)\n      for (int i = 0; i < min(kStages, n); ++i) issue(i);\n    __syncwarp();\n    cluster_wait();  // every rank's sums are in place\n    // every rank's sums, in rank order: the same rsqrt on every rank\n    for (int r = pl; r < MT * 16; r += 32) {\n      double total = 0.0;\n      for (int q = 0; q < kSplits; ++q) total += cluster.map_shared_rank(s_ss, q)[r];\n      s_rs[r] = (float)(1.0 / sqrt(total / a.H + (double)a.eps));\n    }\n"),
    (QF, '    __syncwarp();\n    cluster_wait();\n  } else {\n',
     "    __syncwarp();\n    for (int i = 0; i < n; ++i) {\n      const int st = i % kStages;\n      const int k0 = (c_begin + i) * kKC;\n      mbar_wait(full + st, (i / kStages) & 1);\n      // x -> bf16 xn in place: x * rsqrt, then * norm_w, one rounding\n      unsigned char* sa_p = smem + L::kA + st * L::kABytes;\n      for (int j = pl; j < MT * 16 * 8; j += 32) {\n        const int r = j >> 3;\n        const int ch = j & 7;\n        const int k = k0 + ch * 8;\n        if (k >= a.H) continue;  // TMA's zeros past H stay zeros\n        uint4* p = reinterpret_cast<uint4*>(sa_p + swz128(r, ch));\n        uint4 u = *p;\n        const uint4 wu = *reinterpret_cast<const uint4*>(s_w + (k - k_lo));\n        __nv_bfloat162* xv = reinterpret_cast<__nv_bfloat162*>(&u);\n        const __nv_bfloat162* wv = reinterpret_cast<const __nv_bfloat162*>(&wu);\n        const float rs = s_rs[r];\n#pragma unroll\n        for (int e = 0; e < 4; ++e) {\n          const float2 xf = __bfloat1622float2(xv[e]);\n          const float2 wf = __bfloat1622float2(wv[e]);\n          xv[e] = __floats2bfloat162_rn(__fmul_rn(__fmul_rn(xf.x, rs), wf.x),\n                                        __fmul_rn(__fmul_rn(xf.y, rs), wf.y));\n        }\n        *p = u;\n      }\n      fence_proxy_async();  // before a later TMA write refills these bytes\n      __syncwarp();\n      if (pl == 0) {\n        mbar_arrive(ready + st);\n        // refill the slot of tile i - 1 once the consumers are done with it\n        const int j = i - 1 + kStages;\n        if (i >= 1 && j < n) {\n          mbar_wait(empty + (i - 1) % kStages, ((i - 1) / kStages) & 1);\n          issue(j);\n        }\n      }\n      __syncwarp();\n    }\n  } else {\n"),
    (QF, "      *reinterpret_cast<uint4*>(s_w + (k - k_lo)) = norm_w8(k);\n    cluster_arrive();\n    cluster_wait();\n    // every rank's sums, in rank order: the same rsqrt on every rank\n    if (tid < MT * 16) {\n      double total = 0.0;\n      for (int q = 0; q < kSplits; ++q) total += cluster.map_shared_rank(s_ss, q)[tid];\n      s_rs[tid] = (float)(1.0 / sqrt(total / a.H + (double)a.eps));\n    }\n    consumers_sync();\n\n",
     '      *reinterpret_cast<uint4*>(s_w + (k - k_lo)) = norm_w8(k);\n    cluster_arrive();  // the sums are published; the wait comes after the product\n\n'),
    (QF, "      const int st = i % kStages;\n      const int k0 = (c_begin + i) * kKC;\n      mbar_wait(full + st, (i / kStages) & 1);\n" + _QKV_SMEM_NORMALISE,
     "      const int st = i % kStages;\n      mbar_wait(ready + st, (i / kStages) & 1);  // landed, and x normalised\n      __syncwarp();\n      unsigned char* sa_p = smem + L::kA + st * L::kABytes;\n"),
    _QKV_STAGE_SYNC,
    (QF, '    }\n    consumers_sync();  // every warp is done with the ring: it becomes the partial tile\n',
     "    }\n    cluster_wait();    // the norm's exchange (arrived before the product)\n    consumers_sync();  // every warp is done with the ring: it becomes the partial tile\n"),
]

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
          const __nv_bfloat16* vk = cv + k * rs + tig * 2;
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
    "prefill/stages3": ("prefill", [
        (PF, "constexpr int kStages = 2;", "constexpr int kStages = 3;"),
        (PF, "    case 256: return launch<256>(q, k, v, out, P, Hkv, G, valid_len, scale, softcap, window, s);\n",
         ""),
    ], "3-stage K/V rings (224 KB of shared memory; no D=256)"),
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
        (PA, "  constexpr int kRowB = D * kEB;      // bytes per cached K / V row",
         "  constexpr int kRowB = kInt8 ? D : kS * 2;  // ring bytes per K / V row"),
        (PA, "      if (lane == 0) mbar_expect_tx(&full[st], (uint32_t)n * kRowB * 2);",
         "      if (lane == 0) mbar_expect_tx(&full[st], (uint32_t)n * D * kEB * 2);"),
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
    "qkv/design": ("qkv", [], "as shipped: 128-column pair tiles, 4 splits, 3 stages, "
                   "each k16 step added to the running sum with a round-to-nearest add"),
    "qkv/splits2": ("qkv", _qkv(2, 3), "2 splits (96 blocks at hidden 4096)"),
    "qkv/splits8": ("qkv", _qkv(8, 3), "8 splits (384 blocks)"),
    "qkv/stages2": ("qkv", _qkv(4, 2), "2 stages"),
    "qkv/stages4": ("qkv", _qkv(4, 4), "4 stages"),
    "qkv/splits8_stages2": ("qkv", _qkv(8, 2), "8 splits, 2 stages"),
    "qkv/fresh_per_stage": ("qkv", [(QF, "constexpr int kFreshSteps = 1;", "constexpr int kFreshSteps = 4;")],
                            "each 64-row stage summed on the tensor cores, then one round-to-nearest add"),
    "qkv/one_accumulator": ("qkv", [(QF, "constexpr int kFreshSteps = 1;", "constexpr int kFreshSteps = 0;")],
                            "the whole split summed on the tensor cores (no round-to-nearest adds)"),
    "qkv/serial_norm_loads": ("qkv", [(QF, _QKV_NORM_ROWS, _QKV_NORM_SERIAL)],
                              "the norm's x^2 sums one row at a time per warp (one load in flight per lane)"),
    "qkv/norm_w_global": ("qkv", [(QF, "const uint4 wu = *reinterpret_cast<const uint4*>(s_w + (k - k_lo));",
                                   "const uint4 wu = *reinterpret_cast<const uint4*>(a.norm_w + k);")],
                           "each stage reads its norm weights from device memory (L2) instead of the staged slice"),
    "qkv/stages6": ("qkv", _qkv(4, 6), "6 stages (more weights in flight while the norm's sums run)"),
    "qkv/producer_normalise": ("qkv", _QKV_PRODUCER_NORMALISE,
                               "the producer warp normalises each landed x tile and signals it ready; "
                               "the consumers only run ldmatrix + mma (4 stages)"),
    "qkv/register_normalise": ("qkv", [
        (QF, _QKV_SMEM_NORMALISE, "      unsigned char* sa_p = smem + L::kA + st * L::kABytes;\n"),
        _QKV_STAGE_SYNC,
        (QF, "          ldsm_x4_at(af[mt], sa + swz128(mt * 16 + (mat & 1) * 8 + (lane & 7), kk * 2 + (mat >> 1)));\n",
         _QKV_REGISTER_NORMALISE),
    ], "A fragments of raw x normalised in registers after ldmatrix (no shared rewrite, "
       "proxy fence or consumer barrier per stage in the bf16 mode)"),
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
    os.environ["DYN_KERNEL_CACHE_DIR"] = str(d / "lib")
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
    elif kernel == "qkv":
        sys.path.insert(0, str(ROOT))
        import chip_smoke as cs
        from dynamo_tpu_torch.ops.basics import rms_norm

        err = 0.0
        for M in (8, 32):
            t = cs.gemv_inputs(torch, M, seed=20 + M)
            got, want = cs.qkv_call(KL.fused_qkv_rope_cuda, t), cs.qkv_call(L.fused_qkv_rope_plain, t)
            for a, b in zip(got, want):
                err = max(err, float((a.float() - b.float()).abs().max()))
            xn = rms_norm(t["x"], t["norm"], 1e-5)
            wqkv = torch.cat([t["wq"], t["wk"], t["wv"]], dim=1)
            # accuracy: bf16 v (no RoPE) against an f64 truth (the norm and
            # the product in f64, xn rounded to bf16 as the reference does),
            # for the kernel and for the plain f32 version
            x64 = t["x"].double()
            xn64 = (x64 * torch.rsqrt((x64 * x64).mean(-1, keepdim=True) + 1e-5)
                    * t["norm"].double()).bfloat16()
            truth = (xn64.double() @ t["wv"].double()).bfloat16()
            res[f"M{M}_v_flips"] = int((got[2].reshape(M, -1) != truth).sum())
            res[f"M{M}_plain_v_flips"] = int((want[2].reshape(M, -1) != truth).sum())
            for rnd in range(2):
                res[f"M{M}_ms_{rnd}"] = _time_ms(torch, lambda: cs.qkv_call(KL.fused_qkv_rope_cuda, t), flush)
                res[f"M{M}_matmul_ms_{rnd}"] = _time_ms(torch, lambda: torch.matmul(xn, wqkv), flush)
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
           "qkv": ("fused_qkv_rope",),
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
