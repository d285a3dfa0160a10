// Fused attention-output projection + residual add for Hopper (sm_90a),
// bf16 weights and activations, f32 accumulation, one launch.
//
// Replaces: dynamo_tpu/ops/linear.py::fused_attn_out_residual (kernel body
// _fused_out_kernel, partial_out=False). For M rows:
//   out = x + bf16(attn @ wo)
// with the product accumulated in f32, cast to bf16, and the residual added
// after the cast, in bf16 (linear.py:327-331).
//
// What bounds it on an H100: weight bytes. wo is 4096 x 4096 bf16 =
// 33.6 MB per layer at Llama-3.1-8B width, 10.0 us at 3.35 TB/s; the
// product does 2 * M flops per two weight bytes.
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
//     requests in flight than the memory serves faster).
// Not yet (later work): int8 weights (A9); the raw f32 partial_out mode of
// the tensor-parallel path (A12).
#include <cooperative_groups.h>

#include "hopper_common.cuh"

namespace cg = cooperative_groups;

namespace {

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
static_assert(kCols % 64 == 0 && kNT % 2 == 0 && kCols % kSplits == 0, "tile shape");

// shared memory, byte offsets from a 1024-aligned base (swizzle atoms)
template <int MT>  // 16-row m tiles per row group: 1..4
struct OutLayout {
  static constexpr int kABytes = MT * 16 * kKC * 2;  // attn slice [MT*16 rows][64]
  static constexpr int kW = 0;
  static constexpr int kA = kW + kStages * kWBytes;
  static constexpr int kRed = kA + kStages * kABytes;  // f32 partial tile [MT*16][kCols]
  static constexpr int kBar = kRed + MT * 16 * kCols * 4;
  static constexpr int kBytes = kBar + 2 * kStages * 8 + 1024;
};

template <int MT>
__global__ void __cluster_dims__(1, kSplits, 1) __launch_bounds__(kThreads)
out_proj_residual_kernel(const __grid_constant__ CUtensorMap tm_a,  // attn [M, K], box (64, MT*16)
                         const __grid_constant__ CUtensorMap tm_w,  // wo [K, H], box (64, 64)
                         const __nv_bfloat16* __restrict__ x,       // [M, H]
                         __nv_bfloat16* __restrict__ out,           // [M, H]
                         int M, int K, int H) {
  using L = OutLayout<MT>;
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
        mbar_expect_tx(full + st, kWBytes + L::kABytes);
        for (int b = 0; b < kBoxes; ++b)
          tma_load_2d(smem + L::kW + st * kWBytes + b * kKC * 128, &tm_w, full + st,
                      col0 + b * 64, k0);
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
    const float y = __bfloat162float(__float2bfloat16(s));
    out[o] = __float2bfloat16(__fadd_rn(__bfloat162float(x[o]), y));
  }
  // no block leaves while a peer may still read its partials
  cluster.sync();
}

template <int MT>
cudaError_t launch(const void* attn, const void* wo, const void* x, void* out, int M, int K, int H,
                   cudaStream_t stream) {
  using L = OutLayout<MT>;
  // the tensor maps carry the pointers and M, so they are built per call
  CUtensorMap ta, tw;
  const cuuint64_t da[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t sa[1] = {(cuuint64_t)K * 2};
  const cuuint32_t ba[2] = {kKC, MT * 16};
  const cuuint64_t dw[2] = {(cuuint64_t)H, (cuuint64_t)K};
  const cuuint64_t sw[1] = {(cuuint64_t)H * 2};
  const cuuint32_t bw[2] = {64, kKC};
  int err = make_tensor_map_bf16(&ta, attn, 2, da, sa, ba);
  if (!err) err = make_tensor_map_bf16(&tw, wo, 2, dw, sw, bw);
  if (err) return static_cast<cudaError_t>(err);
  const cudaError_t e = cudaFuncSetAttribute(
      out_proj_residual_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(H / kCols, kSplits, (M + kRowGroup - 1) / kRowGroup);
  out_proj_residual_kernel<MT><<<grid, kThreads, L::kBytes, stream>>>(
      ta, tw, static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), M, K, H);
  return cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes: out = x + bf16(attn @ wo), attn [M, K],
// wo [K, H], x / out [M, H], all bf16 and 16-byte aligned; K a multiple of
// 32, H of 128. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int fused_attn_out_residual_bf16(const void* attn, const void* wo, const void* x,
                                            void* out, int M, int K, int H, void* stream) {
  if (M <= 0 || K <= 0 || K % 32 || H <= 0 || H % 128) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (std::min((M + 15) / 16, kRowGroup / 16)) {
    case 1: return launch<1>(attn, wo, x, out, M, K, H, s);
    case 2: return launch<2>(attn, wo, x, out, M, K, H, s);
    case 3: return launch<3>(attn, wo, x, out, M, K, H, s);
    default: return launch<4>(attn, wo, x, out, M, K, H, s);
  }
}
