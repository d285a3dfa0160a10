// Building blocks shared by the port's tensor-core kernels
// (flash_prefill_attention.cu, fused_qkv_rope.cu, fused_attn_out_residual.cu,
// paged_attention.cuh): bf16 mma.sync with f32 accumulators, cp.async
// global -> shared copies and ldmatrix fragment loads, the split-K skinny
// product of the fused QKV kernel, and Hopper's asynchronous machinery --
// mbarriers, 1-D bulk copies, TMA tensor copies and the host-side tensor
// maps they read.
// Everything here is inline or a template, so each library that includes it
// carries its own copy.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <algorithm>

// ------------------------------------------------------ mbarriers and TMA

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// make the barriers' initialisation visible to the async (TMA) proxy and
// the rest of the cluster; one thread, before the block-wide sync
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrive and announce `bytes` of TMA traffic that completes this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase with the given parity has completed. The spin loop
// lives inside the asm (its labels are local to the braces): a loop in C++
// exits per thread, a divergent path before any wgmma that follows, for
// which ptxas may serialise them (C7520, "WG.AR in divergent path")
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// TMA: one box of a tensor map -> shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// 1-D bulk copy (TMA without a tensor map): `bytes` global -> shared,
// completing on `bar`. Both addresses 16-byte aligned, bytes a multiple of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// order this thread's generic-proxy writes to shared memory before later
// async-proxy (bulk copy) writes to the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Host: a bf16 tensor map with 128-byte swizzle (the layout wgmma and the
// swizzled ldmatrix addressing below expect). dims and box innermost first;
// strides[i] is the byte stride of dimension i + 1. cuTensorMapEncodeTiled
// is a driver-API function: it is looked up in the driver library that the
// CUDA runtime has already loaded, so no library links against libcuda.
// Returns 0, or the cudaError_t to report.
inline int make_tensor_map_bf16(CUtensorMap* map, const void* base, int rank,
                                const cuuint64_t* dims, const cuuint64_t* strides,
                                const cuuint32_t* box) {
  using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static const EncodeFn encode = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeFn>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  // out-of-bounds elements of a box read as zeros
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

// Byte offset of 16-byte chunk `chunk` of 128-byte row `row` in a tile that
// TMA wrote with 128-byte swizzle (tile base 1024-byte aligned).
__device__ __forceinline__ uint32_t swz128(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// D (16x8, f32) += A (16x16, bf16, row-major) * B (16x8, bf16, column-major)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte global -> shared copy that bypasses registers; pred false writes
// zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(gmem),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8 and receives (row l / 4, cols 2 * (l % 4) + {0, 1})
// of each (transposed with .trans)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// the same two loads by shared-memory address (for swizzled tiles)
__device__ __forceinline__ void ldsm_x4_at(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans_at(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// (lo, hi) -> one register, lo in the low 16 bits (the lower-indexed element)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------- split-K GEMM
//
// part[split, m, n] = sum over k in the split's slice of A[m, k] * W[k, n]:
// the skinny product (M <= 64 rows per row group) of the fused QKV kernel.
// W is bf16 [K, N] row-major, given as up to three column segments
// (wq | wk | wv), each a multiple of kGemmCols wide. The f32 partials of the splits are
// summed, in split order, by the caller's combine-and-epilogue kernel, so
// the result does not depend on scheduling.
//
// What bounds it: weight bytes. At M <= 64 the product does 2 * M flops per
// weight byte pair, far under the ~295 flop/byte ridge, so every weight
// element is read once for all M rows (the rows ride the mma M dimension)
// and the K dimension is split over enough blocks (~4 per SM) to keep
// 3.35 TB/s of loads in flight. Chunks of kGemmKC weight rows arrive by
// cp.async in a kGemmStages-deep ring.

constexpr int kGemmThreads = 128;  // 4 warps, 32 output columns each
constexpr int kGemmCols = 128;     // output columns per block
constexpr int kGemmKC = 32;        // contraction rows per pipeline chunk
constexpr int kGemmStages = 3;
constexpr int kGemmRows = 64;      // rows per row group (grid z)

struct GemmSegments {
  const __nv_bfloat16* w[3];
  int n[3];  // widths; unused segments have width 0
};

template <int MT>  // 16-row m tiles in a row group: 1..4
__global__ void __launch_bounds__(kGemmThreads)
splitk_gemm_kernel(const __nv_bfloat16* __restrict__ a,  // [M, K]
                   GemmSegments seg, float* __restrict__ part,  // [splits, M, N]
                   int M, int K, int k_split) {
  constexpr int kAStride = kGemmKC + 8;    // padded rows: conflict-free fragment loads
  constexpr int kWStride = kGemmCols + 8;
  __shared__ __align__(16) __nv_bfloat16 sA[kGemmStages][MT * 16][kAStride];
  __shared__ __align__(16) __nv_bfloat16 sW[kGemmStages][kGemmKC][kWStride];

  const int N = seg.n[0] + seg.n[1] + seg.n[2];
  const int col0 = blockIdx.x * kGemmCols;
  const int split = blockIdx.y;
  const int row0 = blockIdx.z * kGemmRows;
  const int k_begin = split * k_split;
  const int k_end = min(K, k_begin + k_split);
  const int n_chunks = (k_end - k_begin) / kGemmKC;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;

  // this block's column tile lies inside one segment
  const __nv_bfloat16* w = seg.w[0];
  int ld = seg.n[0], wc = col0;
  if (col0 >= seg.n[0] + seg.n[1]) {
    w = seg.w[2];
    ld = seg.n[2];
    wc = col0 - seg.n[0] - seg.n[1];
  } else if (col0 >= seg.n[0]) {
    w = seg.w[1];
    ld = seg.n[1];
    wc = col0 - seg.n[0];
  }

  auto load = [&](int c, int stage) {
    const int k0 = k_begin + c * kGemmKC;
    constexpr int kWPieces = kGemmKC * kGemmCols / 8;
    for (int i = tid; i < kWPieces; i += kGemmThreads) {
      const int r = i / (kGemmCols / 8);
      const int cc = (i % (kGemmCols / 8)) * 8;
      cp_async16(&sW[stage][r][cc], w + (size_t)(k0 + r) * ld + wc + cc, true);
    }
    constexpr int kAPieces = MT * 16 * kGemmKC / 8;
    for (int i = tid; i < kAPieces; i += kGemmThreads) {
      const int r = i / (kGemmKC / 8);
      const int cc = (i % (kGemmKC / 8)) * 8;
      const int m = row0 + r;
      const bool live = m < M;
      cp_async16(&sA[stage][r][cc], live ? a + (size_t)m * K + k0 + cc : a, live);
    }
  };

#pragma unroll
  for (int s = 0; s < kGemmStages - 1; ++s) {
    if (s < n_chunks) load(s, s);
    cp_async_commit();  // empty groups keep the wait counts uniform
  }

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;

  const int mat = lane >> 3;
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kGemmStages - 2>();  // chunk c has landed
    __syncthreads();                   // ... for every thread; chunk c-1's stage is free
    if (c + kGemmStages - 1 < n_chunks) load(c + kGemmStages - 1, (c + kGemmStages - 1) % kGemmStages);
    cp_async_commit();
    const int st = c % kGemmStages;
#pragma unroll
    for (int kk = 0; kk < kGemmKC / 16; ++kk) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = mt * 16 + gid;
        const int cc = kk * 16 + tig * 2;
        af[mt][0] = ld_pair(&sA[st][r][cc]);
        af[mt][1] = ld_pair(&sA[st][r + 8][cc]);
        af[mt][2] = ld_pair(&sA[st][r][cc + 8]);
        af[mt][3] = ld_pair(&sA[st][r + 8][cc + 8]);
      }
      // B fragments by ldmatrix.trans: matrices (k lo, n tile j), (k hi, j),
      // (k lo, j + 1), (k hi, j + 1)
      const __nv_bfloat16* wr = &sW[st][kk * 16 + (mat & 1) * 8 + (lane & 7)][warp * 32];
#pragma unroll
      for (int n = 0; n < 4; n += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, wr + (n + (mat >> 1)) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_16816(acc[mt][n], af[mt], b[0], b[1]);
          mma_16816(acc[mt][n + 1], af[mt], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  float* out = part + (size_t)split * M * N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = col0 + warp * 32 + n * 8 + tig * 2;
      const int m0 = row0 + mt * 16 + gid;
      if (m0 < M)
        *reinterpret_cast<float2*>(out + (size_t)m0 * N + col) = make_float2(acc[mt][n][0], acc[mt][n][1]);
      if (m0 + 8 < M)
        *reinterpret_cast<float2*>(out + (size_t)(m0 + 8) * N + col) =
            make_float2(acc[mt][n][2], acc[mt][n][3]);
    }
  }
}

// Launch the split-K product over every row group; k_split is a multiple of
// kGemmKC and every segment width a multiple of kGemmCols (the wrappers
// check both).
inline cudaError_t launch_splitk_gemm(const __nv_bfloat16* a, const GemmSegments& seg, float* part,
                                      int M, int K, int k_split, cudaStream_t stream) {
  const int N = seg.n[0] + seg.n[1] + seg.n[2];
  const dim3 grid(N / kGemmCols, (K + k_split - 1) / k_split, (M + kGemmRows - 1) / kGemmRows);
  const int mt = (std::min(M, kGemmRows) + 15) / 16;
  switch (mt) {
    case 1: splitk_gemm_kernel<1><<<grid, kGemmThreads, 0, stream>>>(a, seg, part, M, K, k_split); break;
    case 2: splitk_gemm_kernel<2><<<grid, kGemmThreads, 0, stream>>>(a, seg, part, M, K, k_split); break;
    case 3: splitk_gemm_kernel<3><<<grid, kGemmThreads, 0, stream>>>(a, seg, part, M, K, k_split); break;
    case 4: splitk_gemm_kernel<4><<<grid, kGemmThreads, 0, stream>>>(a, seg, part, M, K, k_split); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
