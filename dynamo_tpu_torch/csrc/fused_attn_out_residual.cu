// Fused attention-output projection + residual add for Hopper (sm_90a),
// bf16 activations, bf16 weights or int8 weights with per-output-channel
// bf16 scales, f32 accumulation, one launch. Every mode is an instantiation
// of one kernel (kInt8, kPartial), each with its own entry point below.
//
// Replaces: dynamo_tpu/ops/linear.py::fused_attn_out_residual (kernel body
// _fused_out_kernel, both modes, partial_out False and True). For M rows:
//   out = x + bf16(attn @ wo)          int8: x + bf16((attn @ q) * s)
// with the product accumulated in f32, (the scale applied in f32,) cast to
// bf16, and the residual added after the cast, in bf16 (linear.py:327-331).
// The partial_out mode (kPartial, the tensor-parallel path's row-parallel
// o-projection, linear.py:321-325) stores the raw f32 product attn @ w of
// the rank's shard: no scale (an int8 w is only widened), no cast, no
// residual; the caller sums the ranks' partials before finishing. Its w may
// be a column slice of a wider matrix (leading dimension ldw >= N): the ring
// tail hands it one column chunk of wo per ring step without a copy, since
// the TMA tensor map takes the row stride as it is.
//
// What bounds it on an H100: weight bytes. wo is 4096 x 4096 bf16 =
// 33.6 MB per layer at Llama-3.1-8B width, 10.0 us at 3.35 TB/s (int8:
// 16.8 MB, 5.0 us); the product does 2 * M flops per weight.
//
// Design (one launch, no f32 partials in device memory):
//   * the grid is 64-column tiles x kSplits contraction splits (x row
//     groups of 64); the kSplits blocks of one column tile form a thread
//     block cluster. At hidden 4096 that is 256 blocks, ~2 per SM, each
//     streaming its [K / kSplits, 64] slice of wo exactly once for all rows;
//   * a producer warp keeps a kStages-deep ring of 64 x 64 weight tiles and
//     the matching 64-wide slices of attn in flight by TMA (128-byte
//     swizzle; rows past M read as zeros), with full / empty mbarriers;
//   * four consumer warps own kCols / 4 output columns each and run
//     mma.sync m16n8k16 with the rows on M (bytes bound the product, so
//     mma.sync keeps up), fragments by ldmatrix from the swizzled tiles;
//   * each block leaves its f32 partial tile in its own shared memory; after
//     a cluster barrier, rank r reads columns [r, r + 1) * kCols / kSplits
//     of every rank's partial through distributed shared memory, sums them
//     in rank order (deterministic), casts to bf16, adds x and stores; a
//     second cluster barrier keeps every block alive until its peers have
//     read it.
//   * the shape was chosen on the H100 among 64 / 128 columns, 2 / 4 / 8
//     splits and 2-8 stages: the cluster barrier waits for the slowest
//     rank, so fewer, longer splits win, and deeper rings lose (more
//     requests in flight than the memory serves faster);
//   * the int8 mode (kInt8) streams the int8 weight tiles by TMA (half the
//     bytes, unswizzled) into their own ring; after each lands, the
//     consumer warps widen it to bf16 (exact: |q| <= 127) into the bf16
//     slot in the swizzled layout the product reads, and meet at a barrier
//     before the product; the split-K sum is multiplied by the channel's
//     scale in f32 before the cast and the residual add.
//   * the partial_out mode keeps this design; only the epilogue differs: the
//     split-K sum is stored as f32. Weight bytes still bound it: the rank's
//     wo shard at Llama-3.1-8B tp=2 is 2048 x 4096, 16.8 MB of bf16
//     (5.0 us at 3.35 TB/s; int8 8.4 MB, 2.5 us).
#include <cooperative_groups.h>

#include "hopper_common.cuh"

namespace oproj {

namespace cg = cooperative_groups;

constexpr int kCols = 64;                  // output columns per block
constexpr int kBoxes = kCols / 64;         // 64-column (128-byte) TMA boxes per weight tile
constexpr int kKC = 64;                    // contraction rows per ring stage
constexpr int kStages = 3;
constexpr int kSplits = 4;                 // contraction splits = blocks per cluster
constexpr int kRowGroup = 64;              // rows per row group (grid z)
constexpr int kConsumers = 128;            // 4 warps, kCols / 4 output columns each
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kNT = kCols / 4 / 8;         // n8 tiles per consumer warp
constexpr int kWBytes = kKC * kCols * 2;   // one weight tile: kBoxes boxes of [kKC][64]
constexpr int kQBytes = kKC * kCols;       // one int8 weight tile (int8 mode)
static_assert(kCols % 64 == 0 && kNT % 2 == 0 && kCols % kSplits == 0, "tile shape");

__device__ __forceinline__ void consumers_sync() {  // the consumer warps only
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// shared memory, byte offsets from a 1024-aligned base (swizzle atoms)
template <int MT, bool kInt8>  // 16-row m tiles per row group: 1..4
struct OutLayout {
  static constexpr int kABytes = MT * 16 * kKC * 2;  // attn slice [MT*16 rows][64]
  static constexpr int kW = 0;                       // bf16 weight tiles (int8: widened)
  static constexpr int kA = kW + kStages * kWBytes;
  static constexpr int kQ = kA + kStages * kABytes;  // int8 mode: the int8 weight tiles
  static constexpr int kRed = kQ + (kInt8 ? kStages * kQBytes : 0);  // f32 partial tile [MT*16][kCols]
  static constexpr int kBar = kRed + MT * 16 * kCols * 4;
  static constexpr int kBytes = kBar + 2 * kStages * 8 + 1024;
};

template <int MT, bool kInt8, bool kPartial>
__global__ void __cluster_dims__(1, kSplits, 1) __launch_bounds__(kThreads)
out_proj_residual_kernel(const __grid_constant__ CUtensorMap tm_a,  // attn [M, K], box (64, MT*16)
                         const __grid_constant__ CUtensorMap tm_w,  // wo [K, H] (row stride ldw), box (64, 64)
                         const __nv_bfloat16* __restrict__ x,       // [M, H]; partial: null
                         const __nv_bfloat16* __restrict__ wscale,  // int8 mode: [H]; else null
                         void* __restrict__ out,                    // [M, H] bf16; partial: f32
                         int M, int K, int H) {
  using L = OutLayout<MT, kInt8>;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int col0 = blockIdx.x * kCols;
  const int row0 = blockIdx.z * kRowGroup;
  const int chunks = (K + kKC - 1) / kKC;
  const int c_begin = split * chunks / kSplits;
  const int n = (split + 1) * chunks / kSplits - c_begin;
  const int tid = threadIdx.x;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);  // [kStages]
  uint64_t* empty = full + kStages;
  float* red = reinterpret_cast<float*>(smem + L::kRed);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warp: one lane streams the split's weight and attn tiles
    if (tid == kConsumers) {
      for (int i = 0; i < n; ++i) {
        const int st = i % kStages;
        const int k0 = (c_begin + i) * kKC;
        mbar_wait(empty + st, ((i / kStages) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(full + st, (kInt8 ? kQBytes : kWBytes) + L::kABytes);
        for (int b = 0; b < kBoxes; ++b) {
          if constexpr (kInt8)
            tma_load_2d(smem + L::kQ + st * kQBytes + b * kKC * 64, &tm_w, full + st,
                        col0 + b * 64, k0);
          else
            tma_load_2d(smem + L::kW + st * kWBytes + b * kKC * 128, &tm_w, full + st,
                        col0 + b * 64, k0);
        }
        tma_load_2d(smem + L::kA + st * L::kABytes, &tm_a, full + st, k0, row0);
      }
    }
  } else {
    // ---- consumer warps: columns [warp, warp + 1) * kCols / 4 of the tile
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int mat = lane >> 3;  // which 8x8 matrix this lane addresses in ldmatrix
    float acc[MT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < kNT; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
    for (int i = 0; i < n; ++i) {
      const int st = i % kStages;
      mbar_wait(full + st, (i / kStages) & 1);
      if constexpr (kInt8) {
        // the int8 tile -> bf16 into this stage's bf16 slot, in the swizzled
        // layout TMA would have written; 16 columns per item
        const unsigned char* q8 = smem + L::kQ + st * kQBytes;
        unsigned char* w16 = smem + L::kW + st * kWBytes;
        for (int j = tid; j < kBoxes * kKC * 4; j += kConsumers) {
          const int b = j / (kKC * 4);
          const int r = (j >> 2) % kKC;
          const int g = j & 3;
          uint4 lo, hi;
          i8x16_to_bf16x16(*reinterpret_cast<const uint4*>(q8 + b * kKC * 64 + r * 64 + g * 16),
                           lo, hi);
          *reinterpret_cast<uint4*>(w16 + b * kKC * 128 + swz128(r, 2 * g)) = lo;
          *reinterpret_cast<uint4*>(w16 + b * kKC * 128 + swz128(r, 2 * g + 1)) = hi;
        }
        consumers_sync();  // the whole tile is widened
      }
      __syncwarp();  // ldmatrix / mma need the warp converged
      const uint32_t sw = smem_u32(smem + L::kW + st * kWBytes);
      const uint32_t sa = smem_u32(smem + L::kA + st * L::kABytes);
#pragma unroll
      for (int kk = 0; kk < kKC / 16; ++kk) {
        // A fragments: matrices (rows lo, k lo), (rows hi, k lo), (lo, hi), (hi, hi)
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldsm_x4_at(a[mt], sa + swz128(mt * 16 + (mat & 1) * 8 + (lane & 7), kk * 2 + (mat >> 1)));
        const int kr = kk * 16 + (mat & 1) * 8 + (lane & 7);
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          // B fragments by ldmatrix.trans: matrices (k lo, n tile 2np),
          // (k hi, 2np), (k lo, 2np + 1), (k hi, 2np + 1)
          const int col = warp * (kCols / 4) + np * 16 + (mat >> 1) * 8;
          uint32_t b[4];
          ldsm_x4_trans_at(b, sw + (col >> 6) * kKC * 128 + swz128(kr, (col & 63) >> 3));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_16816(acc[mt][2 * np], a[mt], b[0], b[1]);
            mma_16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);  // this warp is done with the stage
    }
    // this split's partial tile -> its own shared memory
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
  cluster.sync();

  // rank `split` finishes columns [split * kPer, split * kPer + kPer): the
  // partials summed in rank order, cast to bf16, then the residual added
  constexpr int kPer = kCols / kSplits;
  const int rows = min(MT * 16, M - row0);
  for (int i = tid; i < rows * kPer; i += kThreads) {
    const int r = i / kPer;
    const int c = split * kPer + i % kPer;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kSplits; ++q) s = __fadd_rn(s, cluster.map_shared_rank(red, q)[r * kCols + c]);
    const size_t o = (size_t)(row0 + r) * H + col0 + c;
    if constexpr (kPartial) {
      static_cast<float*>(out)[o] = s;  // the raw f32 partial: no scale, cast or residual
    } else {
      if constexpr (kInt8) s = __fmul_rn(s, __bfloat162float(wscale[col0 + c]));  // f32, before the cast
      const float y = __bfloat162float(__float2bfloat16(s));
      static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(__fadd_rn(__bfloat162float(x[o]), y));
    }
  }
  // no block leaves while a peer may still read its partials
  cluster.sync();
}

template <int MT, bool kInt8, bool kPartial>
cudaError_t launch(const void* attn, const void* wo, const void* wscale, const void* x, void* out,
                   int M, int K, int H, int ldw, cudaStream_t stream) {
  using L = OutLayout<MT, kInt8>;
  // the tensor maps carry the pointers and M, so they are built per call
  CUtensorMap ta, tw;
  const cuuint64_t da[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t sa[1] = {(cuuint64_t)K * 2};
  const cuuint32_t ba[2] = {kKC, MT * 16};
  const cuuint64_t dw[2] = {(cuuint64_t)H, (cuuint64_t)K};
  const cuuint64_t sw[1] = {(cuuint64_t)ldw * (kInt8 ? 1 : 2)};
  const cuuint32_t bw[2] = {64, kKC};
  int err = make_tensor_map_bf16(&ta, attn, 2, da, sa, ba);
  if (!err)
    err = kInt8 ? make_tensor_map_i8(&tw, wo, 2, dw, sw, bw)
                : make_tensor_map_bf16(&tw, wo, 2, dw, sw, bw);
  if (err) return static_cast<cudaError_t>(err);
  const cudaError_t e = cudaFuncSetAttribute(
      out_proj_residual_kernel<MT, kInt8, kPartial>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(H / kCols, kSplits, (M + kRowGroup - 1) / kRowGroup);
  out_proj_residual_kernel<MT, kInt8, kPartial><<<grid, kThreads, L::kBytes, stream>>>(
      ta, tw, static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wscale), out,
      M, K, H);
  return cudaGetLastError();
}

// out = x + bf16(attn @ wo) (int8: x + bf16((attn @ wo) * wscale)), attn
// [M, K], wo [K, H] (bf16, or int8 with bf16 scales [H]), x / out [M, H],
// all 16-byte aligned; K a multiple of 32, H of 128. Partial mode: out =
// f32 attn @ wo, no x, no scale; wo's rows ldw elements apart (ldw >= H,
// ldw bytes a multiple of 16).
template <bool kInt8, bool kPartial>
int run(const void* attn, const void* wo, const void* wscale, const void* x, void* out, int M,
        int K, int H, int ldw, void* stream) {
  if (M <= 0 || K <= 0 || K % 32 || H <= 0 || H % 128 || ldw < H ||
      (ldw * (kInt8 ? 1 : 2)) % 16 || (kInt8 && !kPartial && !wscale) || (!kPartial && !x))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (std::min((M + 15) / 16, kRowGroup / 16)) {
    case 1: return launch<1, kInt8, kPartial>(attn, wo, wscale, x, out, M, K, H, ldw, s);
    case 2: return launch<2, kInt8, kPartial>(attn, wo, wscale, x, out, M, K, H, ldw, s);
    case 3: return launch<3, kInt8, kPartial>(attn, wo, wscale, x, out, M, K, H, ldw, s);
    default: return launch<4, kInt8, kPartial>(attn, wo, wscale, x, out, M, K, H, ldw, s);
  }
}

}  // namespace oproj

// C entry point bound with ctypes: out = x + bf16(attn @ wo), attn [M, K],
// wo [K, H], x / out [M, H], all bf16 and 16-byte aligned; K a multiple of
// 32, H of 128. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int fused_attn_out_residual_bf16(const void* attn, const void* wo, const void* x,
                                            void* out, int M, int K, int H, void* stream) {
  return oproj::run<false, false>(attn, wo, nullptr, x, out, M, K, H, H, stream);
}

// C entry point bound with ctypes: fused_attn_out_residual_bf16's arguments
// with an int8 wo and its bf16 per-channel scales wscale [H]. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int fused_attn_out_residual_int8(const void* attn, const void* wo, const void* wscale,
                                            const void* x, void* out, int M, int K, int H,
                                            void* stream) {
  return oproj::run<true, false>(attn, wo, wscale, x, out, M, K, H, H, stream);
}

// C entry point bound with ctypes, the partial_out mode: out = attn @ w in
// f32, attn [M, K] bf16, w [K, N] bf16 with rows ldw elements apart (a
// column slice of a wider matrix), out [M, N] f32 contiguous; pointers
// 16-byte aligned, K a multiple of 32, N of 128, ldw >= N and a multiple of
// 8. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int fused_attn_out_partial_bf16(const void* attn, const void* w, void* out, int M,
                                           int K, int N, int ldw, void* stream) {
  return oproj::run<false, true>(attn, w, nullptr, nullptr, out, M, K, N, ldw, stream);
}

// C entry point bound with ctypes: fused_attn_out_partial_bf16 over int8
// mantissas w (ldw a multiple of 16), widened exactly to bf16 and never
// scaled: the per-channel scale applies after the ranks' partials are
// summed. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int fused_attn_out_partial_int8(const void* attn, const void* w, void* out, int M,
                                           int K, int N, int ldw, void* stream) {
  return oproj::run<true, true>(attn, w, nullptr, nullptr, out, M, K, N, ldw, stream);
}
