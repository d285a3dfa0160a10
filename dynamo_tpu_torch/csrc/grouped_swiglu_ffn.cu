// Grouped SwiGLU FFN for Hopper (sm_90a): the dropless MoE layer's expert
// FFN over rows sorted by expert, bf16 in and out, f32 accumulation, two
// launches from one entry point.
//
// Replaces: dynamo_tpu/ops/moe.py::_grouped_ffn (:111), three
// lax.ragged_dot grouped products -- an XLA op, not a Pallas kernel. For
// rows xs [R, D] sorted by expert, the group bounds offsets [E + 1] (expert
// e owns rows [offsets[e], offsets[e + 1])) and per-expert weights
// wg / wu [E, D, F], wd [E, F, D]:
//   gate = bf16(xs @ wg[e]), up = bf16(xs @ wu[e])    (ragged_dot's outputs
//                                                      are in the input dtype)
//   act  = bf16(bf16(silu(gate)) * up)                 (swiglu on bf16, as
//                                                      torch rounds it)
//   out  = bf16(act @ wd[e])
// Rows past offsets[E] are left unwritten; the caller's rows always sum to R.
//
// Why a kernel: the port's decode runs as CUDA graphs, and a grouped
// product of plain torch ops needs the group sizes on the host (a sync,
// which a capture refuses); its capturable form multiplies every row by
// every expert and reads all E experts' weights. Here the offsets stay on
// the card: a block reads its expert's bounds and returns at once when the
// expert has no rows there, so a weight tile is read only for experts that
// received tokens, and nothing is read back (the decode graphs capture both
// launches as they are).
//
// What bounds it on an H100: weight bytes at decode. Each Mixtral-8x7B
// expert holds 3 x 4096 x 14336 bf16 = 352.3 MB; a B = 8 step routes its 16
// rows to ~7.1 of 8 experts (uniform routing), 2.5 GB a layer, 0.75 ms at
// 3.35 TB/s; B = 1 reads 2 experts, 0.21 ms. A 512-token chunk (R = 1024)
// does 2 * 1024 * 4096 * 14336 * 3 flops = 361 GFLOP a layer, 0.37 ms at
// 989 TFLOP/s: operations bound it there.
//
// Design (simple and right first; wgmma + TMA is a later PR's work):
//   * grid (row tiles of R, N / 64 column tiles, E): the worst case (one
//     expert owns every row); a block covers rows
//     [offsets[e] + x * 16MT, +16MT) of its expert and 64 output columns,
//     and exits before any load when that range is empty. Row tiles vary
//     fastest, so the blocks that share a weight slab run together and read
//     it through L2 once;
//   * four warps, each owning 16 of the 64 columns for all 16MT rows, run
//     mma.sync m16n8k16 (bf16 in, f32 accumulators) on fragments that
//     ldmatrix reads from 128-byte-swizzled tiles;
//   * a kStages-deep cp.async ring of 64-deep contraction slices: the rows'
//     slice (rows past the group read as zeros) and the weights' [64, 64]
//     tiles; the gate/up launch streams wg's and wu's tiles for the same
//     columns together and fuses SwiGLU into its epilogue, so gate and up
//     never reach device memory; only act [R, F] does, which the down
//     launch reads;
//   * MT (16-row m tiles per block, 1-4) follows R: decode's 2-16 rows use
//     one m tile, a chunk's uses four.
#include "hopper_common.cuh"

namespace gffn {

constexpr int kBN = 64;        // output columns per block
constexpr int kBK = 64;        // contraction per stage: one 128-byte swizzle row of bf16
constexpr int kStages = 4;
constexpr int kThreads = 128;  // four warps, kBN / 4 columns each
constexpr int kWBytes = kBK * kBN * 2;  // one [kBK, kBN] weight tile

template <int MT, bool kGateUp>
struct Layout {
  static constexpr int kNW = kGateUp ? 2 : 1;    // weight tiles per stage
  static constexpr int kABytes = MT * 16 * kBK * 2;  // the rows' [16MT, kBK] slice
  static constexpr int kStage = kABytes + kNW * kWBytes;
  static constexpr int kBytes = kStages * kStage + 1024;  // + the 1024-byte alignment
};

// 16 bytes global -> shared, asynchronously; zeros when !valid (no byte read)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// a [R, K] @ w[e] [K, N] for the block's rows of expert e and 64 columns;
// gate/up mode: act = bf16(bf16(silu(bf16(a @ w0))) * bf16(a @ w1)); down
// mode: out = bf16(a @ w0)
template <int MT, bool kGateUp>
__global__ void __launch_bounds__(kThreads)
grouped_ffn_kernel(const __nv_bfloat16* __restrict__ a,    // [R, K], rows sorted by expert
                   const __nv_bfloat16* __restrict__ w0,   // [E, K, N]: wg, or wd
                   const __nv_bfloat16* __restrict__ w1,   // [E, K, N]: wu; down: null
                   const int* __restrict__ offsets,        // [E + 1]
                   __nv_bfloat16* __restrict__ out,        // [R, N]
                   int K, int N) {
  using L = Layout<MT, kGateUp>;
  const int e = blockIdx.z;
  const int row0 = offsets[e] + blockIdx.x * MT * 16;
  const int rows = min(MT * 16, offsets[e + 1] - row0);
  if (rows <= 0) return;  // no rows of this expert here: none of its weights is read
  const int col0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int nk = K / kBK;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const size_t wexp = static_cast<size_t>(e) * K * N;

  // stage st <- contraction slice kc: the rows' slice, then the weight tiles
  auto load = [&](int st, int kc) {
    const uint32_t base = smem_u32(smem + st * L::kStage);
    const int k0 = kc * kBK;
#pragma unroll
    for (int i = 0; i < MT; ++i) {  // 16MT rows x 8 chunks of 16 bytes
      const int p = tid + i * kThreads;
      const int r = p >> 3, c = p & 7;
      const bool ok = r < rows;
      const __nv_bfloat16* src = a + static_cast<size_t>(row0 + (ok ? r : 0)) * K + k0 + c * 8;
      cp_async_16(base + swz128(r, c), src, ok);
    }
#pragma unroll
    for (int m = 0; m < L::kNW; ++m) {
      const __nv_bfloat16* w = (m == 0 ? w0 : w1) + wexp + static_cast<size_t>(k0) * N + col0;
      const uint32_t wb = base + L::kABytes + m * kWBytes;
#pragma unroll
      for (int i = 0; i < kBK * 8 / kThreads; ++i) {  // 64 rows x 8 chunks
        const int p = tid + i * kThreads;
        const int r = p >> 3, c = p & 7;
        cp_async_16(wb + swz128(r, c), w + static_cast<size_t>(r) * N + c * 8, true);
      }
    }
  };

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int mat = lane >> 3;  // which 8x8 matrix this lane addresses in ldmatrix
  float acc[L::kNW][MT][2][4];
#pragma unroll
  for (int m = 0; m < L::kNW; ++m)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j) acc[m][mt][j][0] = acc[m][mt][j][1] = acc[m][mt][j][2] = acc[m][mt][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<kStages - 2>();  // slice i has landed (this thread's copies)
    __syncthreads();               // ... and every thread's; slot (i - 1) is free
    if (i + kStages - 1 < nk) load((i + kStages - 1) % kStages, i + kStages - 1);
    cp_async_commit();
    const uint32_t sa = smem_u32(smem + (i % kStages) * L::kStage);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // A fragments: matrices (rows lo, k lo), (rows hi, k lo), (lo, hi), (hi, hi)
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4_at(af[mt], sa + swz128(mt * 16 + (mat & 1) * 8 + (lane & 7), kk * 2 + (mat >> 1)));
      // B fragments by ldmatrix.trans: (k lo, n tile 0), (k hi, 0), (k lo, 1), (k hi, 1)
      const int kr = kk * 16 + (mat & 1) * 8 + (lane & 7);
      const int col = warp * (kBN / 4) + (mat >> 1) * 8;
#pragma unroll
      for (int m = 0; m < L::kNW; ++m) {
        uint32_t b[4];
        ldsm_x4_trans_at(b, sa + L::kABytes + m * kWBytes + swz128(kr, col >> 3));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_16816(acc[m][mt][0], af[mt], b[0], b[1]);
          mma_16816(acc[m][mt][1], af[mt], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: accumulator (mt, j) holds rows mt*16 + g (+8), columns
  // warp*16 + j*8 + 2*(lane%4) (+1)
  const int g = lane >> 2;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + g + 8 * h;
        if (r >= rows) continue;
        float v[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if constexpr (kGateUp) {
            const float gt = bf16_round(acc[0][mt][j][2 * h + q]);
            const float up = bf16_round(acc[1][mt][j][2 * h + q]);
            v[q] = bf16_round(gt / (1.f + expf(-gt))) * up;
          } else {
            v[q] = acc[0][mt][j][2 * h + q];
          }
        }
        const int c = col0 + warp * (kBN / 4) + j * 8 + 2 * (lane & 3);
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row0 + r) * N + c) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
}

template <int MT, bool kGateUp>
cudaError_t launch(const void* a, const void* w0, const void* w1, const int* offsets, void* out,
                   int R, int E, int K, int N, cudaStream_t stream) {
  using L = Layout<MT, kGateUp>;
  const cudaError_t err = cudaFuncSetAttribute(
      grouped_ffn_kernel<MT, kGateUp>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + MT * 16 - 1) / (MT * 16), N / kBN, E);
  grouped_ffn_kernel<MT, kGateUp><<<grid, kThreads, L::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(w0),
      static_cast<const __nv_bfloat16*>(w1), offsets, static_cast<__nv_bfloat16*>(out), K, N);
  return cudaGetLastError();
}

template <bool kGateUp>
cudaError_t launch_rows(const void* a, const void* w0, const void* w1, const int* offsets,
                        void* out, int R, int E, int K, int N, cudaStream_t stream) {
  switch (std::min((R + 15) / 16, 4)) {
    case 1: return launch<1, kGateUp>(a, w0, w1, offsets, out, R, E, K, N, stream);
    case 2: return launch<2, kGateUp>(a, w0, w1, offsets, out, R, E, K, N, stream);
    case 3: return launch<3, kGateUp>(a, w0, w1, offsets, out, R, E, K, N, stream);
    default: return launch<4, kGateUp>(a, w0, w1, offsets, out, R, E, K, N, stream);
  }
}

}  // namespace gffn

// C entry point bound with ctypes: the grouped SwiGLU FFN, out = bf16(act @
// wd[e]) with act = bf16(bf16(silu(bf16(xs @ wg[e]))) * bf16(xs @ wu[e]))
// for each row of expert e. xs [R, D], wg / wu [E, D, F], wd [E, F, D], act
// [R, F] (scratch the caller allocates), out [R, D], all bf16, contiguous
// and 16-byte aligned; offsets [E + 1] int32 on the card, nondecreasing from
// 0 to at most R; D and F multiples of 64. Two launches on `stream`, no
// synchronisation, nothing read back. Returns the first launch error
// (cudaGetLastError() after each; 0 = both launched).
extern "C" int grouped_swiglu_ffn_bf16(const void* xs, const void* wg, const void* wu,
                                       const void* wd, const void* offsets, void* act, void* out,
                                       int R, int E, int D, int F, void* stream) {
  if (R <= 0 || E <= 0 || D <= 0 || F <= 0 || D % gffn::kBN || F % gffn::kBN || E > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  cudaError_t err = gffn::launch_rows<true>(xs, wg, wu, off, act, R, E, D, F, s);
  if (err != cudaSuccess) return err;
  return gffn::launch_rows<false>(act, wd, nullptr, off, out, R, E, F, D, s);
}
