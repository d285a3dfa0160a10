// Building blocks shared by the port's tensor-core kernels
// (flash_prefill_attention.cu, fused_qkv_rope.cu, fused_attn_out_residual.cu,
// paged_attention.cuh): bf16 mma.sync with f32 accumulators, ldmatrix
// fragment loads, the exact int8 -> bf16 widening of the int8 modes, and
// Hopper's asynchronous machinery -- mbarriers, 1-D bulk copies, TMA tensor
// copies and the host-side tensor maps they read.
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

// Host: a tensor map of `type` elements with the given swizzle. dims and
// box innermost first; strides[i] is the byte stride of dimension i + 1.
// cuTensorMapEncodeTiled is a driver-API function: it is looked up in the
// driver library that the CUDA runtime has already loaded, so no library
// links against libcuda. Returns 0, or the cudaError_t to report.
inline int make_tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rank,
                           const cuuint64_t* dims, const cuuint64_t* strides,
                           const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
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
  const CUresult r = encode(map, type, rank, const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

// a bf16 tensor map with 128-byte swizzle (the layout wgmma and the
// swizzled ldmatrix addressing below expect)
inline int make_tensor_map_bf16(CUtensorMap* map, const void* base, int rank,
                                const cuuint64_t* dims, const cuuint64_t* strides,
                                const cuuint32_t* box) {
  return make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rank, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_128B);
}

// an int8 tensor map, unswizzled: its boxes land as dense rows
inline int make_tensor_map_i8(CUtensorMap* map, const void* base, int rank,
                              const cuuint64_t* dims, const cuuint64_t* strides,
                              const cuuint32_t* box) {
  return make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, rank, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
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

// (lo, hi) -> one register, lo in the low 16 bits (the lower-indexed element)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// four int8 (one word, little-endian) -> four bf16 (two words), exactly:
// the biased byte u = q + 128 becomes the f32 2^23 + u, minus 2^23 + 128
// leaves q, whose f32 bits end in 16 zeros (|q| <= 127 has at most 7
// significant bits), so the high halves are q in bf16
__device__ __forceinline__ uint2 i8x4_to_bf16x4(uint32_t v) {
  const uint32_t u = v ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)) - 8388736.f);
  return make_uint2(__byte_perm(f[0], f[1], 0x7632), __byte_perm(f[2], f[3], 0x7632));
}

// sixteen int8 (one 16-byte word) -> sixteen bf16 (two 16-byte words)
__device__ __forceinline__ void i8x16_to_bf16x16(const uint4& v, uint4& lo, uint4& hi) {
  const uint2 a = i8x4_to_bf16x4(v.x), b = i8x4_to_bf16x4(v.y);
  const uint2 c = i8x4_to_bf16x4(v.z), d = i8x4_to_bf16x4(v.w);
  lo = make_uint4(a.x, a.y, b.x, b.y);
  hi = make_uint4(c.x, c.y, d.x, d.y);
}
