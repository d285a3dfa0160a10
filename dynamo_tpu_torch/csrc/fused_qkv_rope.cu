// Fused RMSNorm + Q/K/V projections (+ bias) + RoPE for Hopper (sm_90a),
// bf16 activations, bf16 weights or int8 weights with per-output-channel
// bf16 scales, f32 accumulation, one launch. Both modes are instantiations
// of one kernel (kInt8), each with its own entry point below.
//
// Replaces: dynamo_tpu/ops/linear.py::fused_qkv_rope (kernel body
// _fused_qkv_kernel, both modes). For M rows of the residual stream
// x [M, H] (M = B on a decode step, B * S on a spec-decode verify step):
//   xn = bf16((x * rsqrt(mean(x^2) + eps)) * norm_w)      (f32 inside)
//   y  = bf16(xn @ [wq | wk | wv])                         (f32 accumulation)
//        int8: y = bf16((xn @ q) * s), the scale in f32 on the summed product
//   y  = bf16(y + bias)                                    (Qwen2 only)
//   q, k = RoPE(y) in f32, cast to bf16; v = y
// in the reference's op and dtype order (linear.py _finish, _rope_rotate).
//
// What bounds it on an H100: weight bytes. At Llama-3.1-8B width the three
// weights are 4096 x 6144 bf16 = 50.3 MB per layer, 15.0 us at 3.35 TB/s
// (int8: 25.2 MB, 7.5 us), and the product does only 2 * M flops per weight.
//
// Design (one launch, no scratch in device memory; after the o-proj kernel,
// fused_attn_out_residual.cu):
//   * the grid is 128-column tiles x kSplits contraction splits (x row
//     groups of 64); the kSplits blocks of one column tile form a thread
//     block cluster. At Llama-3.1-8B width that is 48 x 4 = 192 blocks,
//     each streaming its [H / kSplits, 128] slice of the weights once for
//     all rows;
//   * a tile is two 64-column TMA boxes, placed so that it owns both halves
//     of every RoPE pair it touches: columns d and d + D/2 of one head
//     (D >= 128: boxes at d0 and d0 + D/2) or two whole heads (D = 64);
//   * RMSNorm is folded in. Each rank sums x^2 over its own contraction
//     slice, in f64, and publishes the per-row sums in shared memory; after
//     a cluster barrier every rank adds all ranks' sums in rank order (so
//     every rank gets the same, deterministic rsqrt per row, exact to its
//     f32 rounding: the plain version's own f32 sum then decides most of
//     their remaining bf16 disagreements). The producer warp does not wait
//     for that: it starts the weight stream at once;
//   * a producer warp keeps a kStages-deep ring of weight tiles and the
//     matching 64-wide slices of x in flight by TMA (128-byte swizzle; rows
//     past M and columns past H read as zeros), with full / empty mbarriers.
//     The consumers turn each landed x slice into bf16 xn in place (the
//     reference's two f32 products and one rounding, with the split's
//     norm weights staged in shared memory once) before its product; no xn
//     tensor is written to device memory. Normalising the A
//     fragments in registers instead, after ldmatrix, saves the rewrite
//     and the barrier per stage but measured slower on the H100
//     (tools/kernel_variants.py, qkv/register_normalise);
//   * four consumer warps own 32 output columns each and run mma.sync
//     m16n8k16 with the rows on M (bytes bound the product, so mma.sync
//     keeps up), fragments by ldmatrix from the swizzled tiles. Each
//     k16 step's products are summed from zero on the tensor cores and
//     added to the running f32 sum with a round-to-nearest add: the tensor
//     cores add into their accumulator with truncation relative to its
//     magnitude, and over a 1024-row split that flipped bf16 roundings of
//     y 3-4x as often as the reference's f32 product does (kFreshSteps;
//     tools/kernel_variants.py times the other choices);
//   * each block leaves its f32 partial tile in its own shared memory (the
//     drained ring); after a cluster barrier, rank r sums the partials of
//     its share of the tile's 64 RoPE pairs through distributed shared
//     memory, in rank order (deterministic), casts, adds the bias, rotates
//     q and k in f32 and stores; a last cluster barrier keeps every block
//     alive until its peers have read it.
//   * the int8 mode (kInt8) streams the int8 weight boxes by TMA (half the
//     bytes, unswizzled) into their own landing ring; the consumers widen
//     each landed box to bf16 (exact: |q| <= 127) into the bf16 ring slot,
//     in the swizzled layout the product reads, in the same pass that
//     normalises x, so the product and everything after it are the bf16
//     mode's; the per-channel scale multiplies the split-K sum in f32
//     before the bf16 cast, the bias and RoPE (the reference's _finish).
// Rounding steps use the _rn intrinsics so nvcc contracts nothing into an
// fma the reference does not do; the kernel and the plain version then
// differ only in the norm's sum (f64 here) and the product's f32 order.
// Not yet (later work): the meshed tensor-parallel form (A9).
#include <cooperative_groups.h>
#include <math.h>

#include "hopper_common.cuh"

namespace qkv {

namespace cg = cooperative_groups;

constexpr int kCols = 128;                 // output columns per block: two 64-column boxes
constexpr int kPairs = kCols / 2;          // RoPE pairs per tile
constexpr int kKC = 64;                    // contraction rows per ring stage
constexpr int kStages = 3;
constexpr int kSplits = 4;                 // contraction splits = blocks per cluster
// k16 steps summed on the tensor cores from zero before one round-to-nearest
// add into the running sum (0: the whole split on the tensor cores)
constexpr int kFreshSteps = 1;
constexpr int kRowGroup = 64;              // rows per row group (grid z)
constexpr int kConsumers = 128;            // 4 warps, kCols / 4 output columns each
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kNT = kCols / 4 / 8;         // n8 tiles per consumer warp
constexpr int kBoxBytes = kKC * 128;       // one [kKC][64] bf16 box
constexpr int kWBytes = 2 * kBoxBytes;     // one weight tile
constexpr int kQBoxBytes = kKC * 64;       // one [kKC][64] int8 box (int8 mode)
constexpr int kQBytes = 2 * kQBoxBytes;    // one int8 weight tile
static_assert(kPairs % (2 * kSplits) == 0 && kNT % 2 == 0, "tile shape");

// shared memory, byte offsets from a 1024-aligned base (swizzle atoms)
template <int MT, bool kInt8>  // 16-row m tiles per row group: 1..4
struct QkvLayout {
  static constexpr int kABytes = MT * 16 * kKC * 2;  // x slice [MT*16 rows][64]
  static constexpr int kW = 0;                       // bf16 weight tiles (int8: widened)
  static constexpr int kA = kW + kStages * kWBytes;
  static constexpr int kQ = kA + kStages * kABytes;  // int8 mode: the int8 weight tiles
  static constexpr int kBar = kQ + (kInt8 ? kStages * kQBytes : 0);  // the ring ends here
  static constexpr int kNormW = (kBar + 2 * kStages * 8 + 15) & ~15;  // the split's norm weights
  // bytes for a split of n_chunks contraction chunks
  static constexpr int bytes(int n_chunks) { return kNormW + n_chunks * kKC * 2 + 1024; }
  // after the product the drained ring holds the f32 partial tile
  static_assert(MT * 16 * kCols * 4 <= kBar, "the partial tile fits the ring");
};

struct QkvArgs {
  const __nv_bfloat16* x;        // [M, H]
  const __nv_bfloat16* norm_w;   // [H]
  const __nv_bfloat16* bias[3];  // q / k / v biases, all null without
  const __nv_bfloat16* wscale[3];  // int8 mode: q / k / v per-channel scales
  const float* cos;              // [M, D / 2]
  const float* sin;
  __nv_bfloat16* out[3];         // q [M, Hq * D], k / v [M, Hkv * D]
  int width[3];                  // Hq * D, Hkv * D, Hkv * D
  int M, H, D;
  float eps;
};

// split arrive / wait of the cluster barrier: the producer warp arrives
// before it streams and waits after, so the norm's exchange never holds
// the weight loads back
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ void consumers_sync() {  // the consumer warps only
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <int MT, bool kInt8>
__global__ void __cluster_dims__(1, kSplits, 1) __launch_bounds__(kThreads)
fused_qkv_rope_kernel(const __grid_constant__ CUtensorMap tm_x,   // x [M, H], box (64, MT*16)
                      const __grid_constant__ CUtensorMap tm_wq,  // wq [H, Hq*D], box (64, 64)
                      const __grid_constant__ CUtensorMap tm_wk,  // wk [H, Hkv*D]
                      const __grid_constant__ CUtensorMap tm_wv,  // wv [H, Hkv*D]
                      const QkvArgs a) {
  using L = QkvLayout<MT, kInt8>;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int row0 = blockIdx.z * kRowGroup;
  const int rows = min(MT * 16, a.M - row0);
  const int tid = threadIdx.x;

  // this block's column tile: segment (q, k or v) and its two boxes
  int t = blockIdx.x, seg = 0;
  const int t_q = a.width[0] / kCols, t_k = a.width[1] / kCols;
  if (t >= t_q + t_k) {
    seg = 2;
    t -= t_q + t_k;
  } else if (t >= t_q) {
    seg = 1;
    t -= t_q;
  }
  const CUtensorMap* tm_w = seg == 0 ? &tm_wq : seg == 1 ? &tm_wk : &tm_wv;
  const int D = a.D;
  int c0, c1, d0;  // the boxes' first columns in the segment; box 0's index in its head
  if (D >= 128) {
    const int per = D / 128;
    c0 = (t / per) * D + (t % per) * 64;
    c1 = c0 + D / 2;
    d0 = (t % per) * 64;
  } else {  // D = 64: two whole heads, each box one head
    c0 = t * kCols;
    c1 = c0 + 64;
    d0 = 0;
  }

  // this split's contraction rows [k_lo, k_hi), in kKC-row chunks
  const int chunks = (a.H + kKC - 1) / kKC;
  const int c_begin = split * chunks / kSplits;
  const int n = (split + 1) * chunks / kSplits - c_begin;
  const int k_lo = c_begin * kKC;
  const int k_hi = min(a.H, (c_begin + n) * kKC);

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);  // [kStages]
  uint64_t* empty = full + kStages;
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem + L::kNormW);  // norm_w[k_lo, k_hi)
  float* red = reinterpret_cast<float*>(smem);  // the partial tile, after the product
  __shared__ double s_ss[kRowGroup];  // this rank's sum of x^2 per row
  __shared__ float s_rs[kRowGroup];  // rsqrt(mean(x^2) + eps) per row
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warp: nothing to publish for the norm; one lane streams
    // the split's weight and x tiles
    cluster_arrive();
    if (tid == kConsumers) {
      for (int i = 0; i < n; ++i) {
        const int st = i % kStages;
        const int k0 = (c_begin + i) * kKC;
        mbar_wait(empty + st, ((i / kStages) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(full + st, (kInt8 ? kQBytes : kWBytes) + L::kABytes);
        unsigned char* w = kInt8 ? smem + L::kQ + st * kQBytes : smem + L::kW + st * kWBytes;
        tma_load_2d(w, tm_w, full + st, c0, k0);
        tma_load_2d(w + (kInt8 ? kQBoxBytes : kBoxBytes), tm_w, full + st, c1, k0);
        tma_load_2d(smem + L::kA + st * L::kABytes, &tm_x, full + st, k0, row0);
      }
    }
    __syncwarp();
    cluster_wait();
  } else {
    const int warp = tid >> 5;
    const int lane = tid & 31;
    // the split's norm weights, staged in shared memory once (zeros past H,
    // where x is zeros): the first piece is loaded here and stored after
    // the norm's loads below, so its latency hides behind theirs
    const int w_end = k_lo + n * kKC;
    auto norm_w8 = [&](int k) {
      return k < a.H ? *reinterpret_cast<const uint4*>(a.norm_w + k) : make_uint4(0u, 0u, 0u, 0u);
    };
    const int kw = k_lo + tid * 8;
    const uint4 w_first = kw < w_end ? norm_w8(kw) : make_uint4(0u, 0u, 0u, 0u);
    // ---- the norm: this rank's sum of x^2 per row over [k_lo, k_hi). Warp
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
    if (kw < w_end) *reinterpret_cast<uint4*>(s_w + (kw - k_lo)) = w_first;
    for (int k = kw + kConsumers * 8; k < w_end; k += kConsumers * 8)
      *reinterpret_cast<uint4*>(s_w + (k - k_lo)) = norm_w8(k);
    cluster_arrive();
    cluster_wait();
    // every rank's sums, in rank order: the same rsqrt on every rank
    if (tid < MT * 16) {
      double total = 0.0;
      for (int q = 0; q < kSplits; ++q) total += cluster.map_shared_rank(s_ss, q)[tid];
      s_rs[tid] = (float)(1.0 / sqrt(total / a.H + (double)a.eps));
    }
    consumers_sync();

    // ---- the product: columns [warp, warp + 1) * kCols / 4 of the tile
    const int mat = lane >> 3;  // which 8x8 matrix this lane addresses in ldmatrix
    float acc[MT][kNT][4];   // the running sum
    float part[MT][kNT][4];  // kFreshSteps k16 steps' products
    float (&dst)[MT][kNT][4] = kFreshSteps > 0 ? part : acc;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < kNT; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
    for (int i = 0; i < n; ++i) {
      const int st = i % kStages;
      const int k0 = (c_begin + i) * kKC;
      mbar_wait(full + st, (i / kStages) & 1);
      // x -> bf16 xn in place: x * rsqrt, then * norm_w, one rounding
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
      if constexpr (kInt8) {
        // the int8 weight boxes -> bf16, into this stage's bf16 slot in the
        // swizzled layout TMA would have written; 16 columns per item
        const unsigned char* q8 = smem + L::kQ + st * kQBytes;
        unsigned char* w16 = smem + L::kW + st * kWBytes;
        for (int j = tid; j < 2 * kKC * 4; j += kConsumers) {
          const int b = j / (kKC * 4);
          const int r = (j >> 2) % kKC;
          const int g = j & 3;
          uint4 lo, hi;
          i8x16_to_bf16x16(*reinterpret_cast<const uint4*>(q8 + b * kQBoxBytes + r * 64 + g * 16),
                           lo, hi);
          *reinterpret_cast<uint4*>(w16 + b * kBoxBytes + swz128(r, 2 * g)) = lo;
          *reinterpret_cast<uint4*>(w16 + b * kBoxBytes + swz128(r, 2 * g + 1)) = hi;
        }
      }
      fence_proxy_async();  // before a later TMA write refills these bytes
      consumers_sync();     // every row of xn (and the widened weights) is in place
      const uint32_t sw = smem_u32(smem + L::kW + st * kWBytes);
      const uint32_t sa = smem_u32(sa_p);
#pragma unroll
      for (int kk = 0; kk < kKC / 16; ++kk) {
        if (kFreshSteps > 0 && kk % kFreshSteps == 0) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int j = 0; j < kNT; ++j)
              part[mt][j][0] = part[mt][j][1] = part[mt][j][2] = part[mt][j][3] = 0.f;
        }
        // A fragments: matrices (rows lo, k lo), (rows hi, k lo), (lo, hi), (hi, hi)
        uint32_t af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldsm_x4_at(af[mt], sa + swz128(mt * 16 + (mat & 1) * 8 + (lane & 7), kk * 2 + (mat >> 1)));
        const int kr = kk * 16 + (mat & 1) * 8 + (lane & 7);
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          // B fragments by ldmatrix.trans: matrices (k lo, n tile 2np),
          // (k hi, 2np), (k lo, 2np + 1), (k hi, 2np + 1)
          const int col = warp * (kCols / 4) + np * 16 + (mat >> 1) * 8;
          uint32_t b[4];
          ldsm_x4_trans_at(b, sw + (col >> 6) * kBoxBytes + swz128(kr, (col & 63) >> 3));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_16816(dst[mt][2 * np], af[mt], b[0], b[1]);
            mma_16816(dst[mt][2 * np + 1], af[mt], b[2], b[3]);
          }
        }
        if (kFreshSteps > 0 && kk % kFreshSteps == kFreshSteps - 1) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int j = 0; j < kNT; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[mt][j][e] = __fadd_rn(acc[mt][j][e], part[mt][j][e]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);  // this warp is done with the stage
    }
    consumers_sync();  // every warp is done with the ring: it becomes the partial tile
    const int g = lane >> 2;
    const int c = warp * (kCols / 4) + 2 * (lane & 3);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        *reinterpret_cast<float2*>(red + (mt * 16 + g) * kCols + c + 8 * j) =
            make_float2(acc[mt][j][0], acc[mt][j][1]);
        *reinterpret_cast<float2*>(red + (mt * 16 + g + 8) * kCols + c + 8 * j) =
            make_float2(acc[mt][j][2], acc[mt][j][3]);
      }
  }
  // every split's partials are in place before any rank reads its peers'
  cluster_arrive();
  cluster_wait();

  // ---- epilogue: rank `split` finishes pairs [split, split + 1) * kPer of
  // the tile: partials summed in rank order, cast, bias, RoPE (q and k)
  constexpr int kPer = kPairs / kSplits;
  const int half = D / 2;
  const __nv_bfloat16* bias = a.bias[seg];
  const __nv_bfloat16* wscale = a.wscale[seg];
  // two adjacent pairs per item: float2 loads from the peers, bf16x2 stores
  for (int i = tid; i < rows * (kPer / 2); i += kThreads) {
    const int r = i / (kPer / 2);
    const int p = split * kPer + 2 * (i % (kPer / 2));
    // pairs p and p + 1: their local columns (lo < hi, each two wide) and
    // lo's index in its head
    int lo, hi, d;
    if (D >= 128) {
      lo = p;
      hi = 64 + p;
      d = d0 + p;
    } else {
      lo = (p >> 5) * 64 + (p & 31);
      hi = lo + 32;
      d = p & 31;
    }
    float2 s1 = make_float2(0.f, 0.f), s2 = make_float2(0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kSplits; ++q) {
      const float* pr = cluster.map_shared_rank(red, q) + r * kCols;
      const float2 v1 = *reinterpret_cast<const float2*>(pr + lo);
      const float2 v2 = *reinterpret_cast<const float2*>(pr + hi);
      s1 = make_float2(__fadd_rn(s1.x, v1.x), __fadd_rn(s1.y, v1.y));
      s2 = make_float2(__fadd_rn(s2.x, v2.x), __fadd_rn(s2.y, v2.y));
    }
    const int col1 = lo < 64 ? c0 + lo : c1 + lo - 64;
    const int col2 = hi < 64 ? c0 + hi : c1 + hi - 64;
    if constexpr (kInt8) {  // the per-channel scale, in f32, before the cast
      const float2 w1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(wscale + col1));
      const float2 w2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(wscale + col2));
      s1 = make_float2(__fmul_rn(s1.x, w1.x), __fmul_rn(s1.y, w1.y));
      s2 = make_float2(__fmul_rn(s2.x, w2.x), __fmul_rn(s2.y, w2.y));
    }
    float2 y1 = make_float2(bf16_round(s1.x), bf16_round(s1.y));
    float2 y2 = make_float2(bf16_round(s2.x), bf16_round(s2.y));
    if (bias != nullptr) {
      const float2 b1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col1));
      const float2 b2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col2));
      y1 = make_float2(bf16_round(__fadd_rn(y1.x, b1.x)), bf16_round(__fadd_rn(y1.y, b1.y)));
      y2 = make_float2(bf16_round(__fadd_rn(y2.x, b2.x)), bf16_round(__fadd_rn(y2.y, b2.y)));
    }
    const size_t m = (size_t)(row0 + r);
    __nv_bfloat16* o = a.out[seg] + m * a.width[seg];
    if (seg < 2) {
      const float2 cs = *reinterpret_cast<const float2*>(a.cos + m * half + d);
      const float2 sn = *reinterpret_cast<const float2*>(a.sin + m * half + d);
      *reinterpret_cast<__nv_bfloat162*>(o + col1) =
          __floats2bfloat162_rn(__fsub_rn(__fmul_rn(y1.x, cs.x), __fmul_rn(y2.x, sn.x)),
                                __fsub_rn(__fmul_rn(y1.y, cs.y), __fmul_rn(y2.y, sn.y)));
      *reinterpret_cast<__nv_bfloat162*>(o + col2) =
          __floats2bfloat162_rn(__fadd_rn(__fmul_rn(y2.x, cs.x), __fmul_rn(y1.x, sn.x)),
                                __fadd_rn(__fmul_rn(y2.y, cs.y), __fmul_rn(y1.y, sn.y)));
    } else {
      *reinterpret_cast<__nv_bfloat162*>(o + col1) = __floats2bfloat162_rn(y1.x, y1.y);
      *reinterpret_cast<__nv_bfloat162*>(o + col2) = __floats2bfloat162_rn(y2.x, y2.y);
    }
  }
  // no block leaves while a peer may still read its partials
  cluster_arrive();
  cluster_wait();
}

template <int MT, bool kInt8>
cudaError_t launch(const void* wq, const void* wk, const void* wv, const QkvArgs& a,
                   cudaStream_t stream) {
  using L = QkvLayout<MT, kInt8>;
  // the tensor maps carry the pointers and M, so they are built per call
  CUtensorMap tx, tw[3];
  const cuuint64_t dx[2] = {(cuuint64_t)a.H, (cuuint64_t)a.M};
  const cuuint64_t sx[1] = {(cuuint64_t)a.H * 2};
  const cuuint32_t bx[2] = {kKC, MT * 16};
  int err = make_tensor_map_bf16(&tx, a.x, 2, dx, sx, bx);
  const void* ws[3] = {wq, wk, wv};
  for (int s = 0; s < 3 && !err; ++s) {
    const cuuint64_t dw[2] = {(cuuint64_t)a.width[s], (cuuint64_t)a.H};
    const cuuint64_t sw[1] = {(cuuint64_t)a.width[s] * (kInt8 ? 1 : 2)};
    const cuuint32_t bw[2] = {64, kKC};
    err = kInt8 ? make_tensor_map_i8(&tw[s], ws[s], 2, dw, sw, bw)
                : make_tensor_map_bf16(&tw[s], ws[s], 2, dw, sw, bw);
  }
  if (err) return static_cast<cudaError_t>(err);
  const int chunks = (a.H + kKC - 1) / kKC;
  const int bytes = L::bytes((chunks + kSplits - 1) / kSplits);  // the longest split's
  const cudaError_t e = cudaFuncSetAttribute(
      fused_qkv_rope_kernel<MT, kInt8>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const int tiles = (a.width[0] + a.width[1] + a.width[2]) / kCols;
  const dim3 grid(tiles, kSplits, (a.M + kRowGroup - 1) / kRowGroup);
  fused_qkv_rope_kernel<MT, kInt8><<<grid, kThreads, bytes, stream>>>(tx, tw[0], tw[1], tw[2], a);
  return cudaGetLastError();
}

// Checks the shapes, fills the arguments and launches the row-group size's
// instantiation. x [M, H], norm_w [H], wq [H, Hq * D], wk / wv [H, Hkv * D]
// (bf16, or int8 with bf16 scales [Hq * D] / [Hkv * D]), q [M, Hq * D],
// k / v [M, Hkv * D], the biases (all null, or [Hq * D] / [Hkv * D]) bf16;
// cos / sin [M, D / 2] f32; every pointer 16-byte aligned. H a multiple of
// 8; D 64 or a multiple of 128; Hq * D and Hkv * D multiples of 128.
template <bool kInt8>
int run(const void* x, const void* norm_w, const void* wq, const void* wk, const void* wv,
        const void* sq, const void* sk, const void* sv, const void* bq, const void* bk,
        const void* bv, const float* cos_t, const float* sin_t, void* q, void* k, void* v, int M,
        int H, int Hq, int Hkv, int D, float eps, void* stream) {
  if (M <= 0 || H <= 0 || H % 8 || !(D == 64 || (D > 0 && D % 128 == 0)) || Hq <= 0 ||
      Hkv <= 0 || (Hq * D) % kCols || (Hkv * D) % kCols || (kInt8 && (!sq || !sk || !sv)))
    return cudaErrorInvalidValue;
  QkvArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.norm_w = static_cast<const __nv_bfloat16*>(norm_w);
  a.bias[0] = static_cast<const __nv_bfloat16*>(bq);
  a.bias[1] = static_cast<const __nv_bfloat16*>(bk);
  a.bias[2] = static_cast<const __nv_bfloat16*>(bv);
  a.wscale[0] = static_cast<const __nv_bfloat16*>(sq);
  a.wscale[1] = static_cast<const __nv_bfloat16*>(sk);
  a.wscale[2] = static_cast<const __nv_bfloat16*>(sv);
  a.cos = cos_t;
  a.sin = sin_t;
  a.out[0] = static_cast<__nv_bfloat16*>(q);
  a.out[1] = static_cast<__nv_bfloat16*>(k);
  a.out[2] = static_cast<__nv_bfloat16*>(v);
  a.width[0] = Hq * D;
  a.width[1] = a.width[2] = Hkv * D;
  a.M = M;
  a.H = H;
  a.D = D;
  a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (std::min((M + 15) / 16, kRowGroup / 16)) {
    case 1: return launch<1, kInt8>(wq, wk, wv, a, s);
    case 2: return launch<2, kInt8>(wq, wk, wv, a, s);
    case 3: return launch<3, kInt8>(wq, wk, wv, a, s);
    default: return launch<4, kInt8>(wq, wk, wv, a, s);
  }
}

}  // namespace qkv

// C entry point bound with ctypes. x [M, H], norm_w [H], wq [H, Hq * D],
// wk / wv [H, Hkv * D], q [M, Hq * D], k / v [M, Hkv * D], the biases
// (all null, or [Hq * D] / [Hkv * D]) bf16; cos / sin [M, D / 2] f32; every
// pointer 16-byte aligned. H a multiple of 8; D 64 or a multiple of 128;
// Hq * D and Hkv * D multiples of 128. One launch, no scratch. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int fused_qkv_rope_bf16(const void* x, const void* norm_w, const void* wq,
                                   const void* wk, const void* wv, const void* bq,
                                   const void* bk, const void* bv, const float* cos_t,
                                   const float* sin_t, void* q, void* k, void* v, int M, int H,
                                   int Hq, int Hkv, int D, float eps, void* stream) {
  return qkv::run<false>(x, norm_w, wq, wk, wv, nullptr, nullptr, nullptr, bq, bk, bv, cos_t,
                         sin_t, q, k, v, M, H, Hq, Hkv, D, eps, stream);
}

// C entry point bound with ctypes: fused_qkv_rope_bf16's arguments with
// int8 wq / wk / wv and their bf16 per-channel scales sq [Hq * D],
// sk / sv [Hkv * D]. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int fused_qkv_rope_int8(const void* x, const void* norm_w, const void* wq,
                                   const void* wk, const void* wv, const void* sq,
                                   const void* sk, const void* sv, const void* bq,
                                   const void* bk, const void* bv, const float* cos_t,
                                   const float* sin_t, void* q, void* k, void* v, int M, int H,
                                   int Hq, int Hkv, int D, float eps, void* stream) {
  return qkv::run<true>(x, norm_w, wq, wk, wv, sq, sk, sv, bq, bk, bv, cos_t, sin_t, q, k, v, M,
                        H, Hq, Hkv, D, eps, stream);
}
