// Fused RMSNorm + Q/K/V projections (+ bias) + RoPE for Hopper (sm_90a),
// bf16 weights and activations, f32 accumulation.
//
// Replaces: dynamo_tpu/ops/linear.py::fused_qkv_rope (kernel body
// _fused_qkv_kernel). For M rows of the residual stream x [M, H] (M = B on
// a decode step, B * S on a spec-decode verify step):
//   xn = bf16((x * rsqrt(mean(x^2) + eps)) * norm_w)      (f32 inside)
//   y  = bf16(xn @ [wq | wk | wv])                         (f32 accumulation)
//   y  = bf16(y + bias)                                    (Qwen2 only)
//   q, k = RoPE(y) in f32, cast to bf16; v = y
// in the reference's op and dtype order (linear.py _finish, _rope_rotate).
//
// What bounds it on an H100: weight bytes. At Llama-3.1-8B width the three
// weights are 4096 x 6144 bf16 = 50.3 MB per layer, 15.0 us at 3.35 TB/s,
// and the product does only 2 * M flops per two weight bytes.
//
// Design (three launches on the caller's stream):
//   1. rmsnorm_rows: one block per row writes xn [M, H] bf16 (a 0.5 MB
//      scratch at M = 64) -- the one small pre-pass;
//   2. splitk_gemm_kernel (hopper_common.cuh): the three weights as one
//      logical [H, 6144] matrix, cut into 128-column tiles x contraction
//      splits so ~4 blocks per SM stream the weights at once. Tiling by head
//      alone would give 48 blocks for 132 SMs. Every weight element is read
//      once for all M rows (they ride the mma M dimension), on the tensor
//      cores with f32 accumulators, into f32 partials [splits, M, 6144];
//   3. qkv_epilogue: one block per (row, head) sums the head's partials in
//      split order (deterministic), then cast -> bias -> RoPE. RoPE pairs
//      column d with d + D/2 of the same head, which is why the epilogue runs
//      after the split-K combine and not inside the product.
// Rounding steps use the _rn intrinsics so nvcc contracts nothing into an
// fma the reference does not do; the kernel and the plain version then
// differ only in the f32 summation order of the product.
// Not yet (later work): int8 weights with per-channel scales (A9), the
// tensor-parallel split, TMA + wgmma for the weight stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int kNormThreads = 256;

__global__ void __launch_bounds__(kNormThreads)
rmsnorm_rows(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
             __nv_bfloat16* __restrict__ xn, int H, float eps) {
  const int m = blockIdx.x;
  const __nv_bfloat16* xr = x + (size_t)m * H;
  float ss = 0.f;
  for (int i = threadIdx.x; i < H; i += kNormThreads) {
    const float v = __bfloat162float(xr[i]);
    ss = fmaf(v, v, ss);
  }
  __shared__ float red[kNormThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kNormThreads / 32; ++i) total += red[i];
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(total, (float)H), eps));
  for (int i = threadIdx.x; i < H; i += kNormThreads) {
    const float v = __fmul_rn(__bfloat162float(xr[i]), r);
    xn[(size_t)m * H + i] = __float2bfloat16(__fmul_rn(v, __bfloat162float(w[i])));
  }
}

// y = bf16(sum of the splits' partials), then + bias in bf16
__device__ __forceinline__ float finish(const float* __restrict__ part, size_t split_stride,
                                        int splits, size_t idx, const __nv_bfloat16* bias,
                                        int bcol) {
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc = __fadd_rn(acc, part[s * split_stride + idx]);
  float y = __bfloat162float(__float2bfloat16(acc));
  if (bias != nullptr) y = __bfloat162float(__float2bfloat16(__fadd_rn(y, __bfloat162float(bias[bcol]))));
  return y;
}

// grid (M, Hq + 2 * Hkv), D / 2 threads: thread d owns the pair (d, d + D/2)
__global__ void qkv_epilogue(const float* __restrict__ part, int splits, int M,
                             const __nv_bfloat16* __restrict__ bq,
                             const __nv_bfloat16* __restrict__ bk,
                             const __nv_bfloat16* __restrict__ bv,
                             const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                             __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ k,
                             __nv_bfloat16* __restrict__ v, int Hq, int Hkv, int D) {
  const int m = blockIdx.x;
  const int head = blockIdx.y;
  const int half = D / 2;
  const int N = (Hq + 2 * Hkv) * D;
  const size_t stride = (size_t)M * N;
  for (int d = threadIdx.x; d < half; d += blockDim.x) {
    const size_t lo = (size_t)m * N + (size_t)head * D + d;
    const size_t hi = lo + half;
    const __nv_bfloat16* bias;
    __nv_bfloat16* out;
    int local;  // head index inside its own output
    if (head < Hq) {
      bias = bq, out = q, local = head;
    } else if (head < Hq + Hkv) {
      bias = bk, out = k, local = head - Hq;
    } else {
      bias = bv, out = v, local = head - Hq - Hkv;
    }
    const int heads = head < Hq ? Hq : Hkv;
    const int bcol = local * D + d;
    const float y1 = finish(part, stride, splits, lo, bias, bcol);
    const float y2 = finish(part, stride, splits, hi, bias, bcol + half);
    __nv_bfloat16* o = out + ((size_t)m * heads + local) * D;
    if (head < Hq + Hkv) {
      const float c = cos_t[(size_t)m * half + d];
      const float s = sin_t[(size_t)m * half + d];
      o[d] = __float2bfloat16(__fsub_rn(__fmul_rn(y1, c), __fmul_rn(y2, s)));
      o[d + half] = __float2bfloat16(__fadd_rn(__fmul_rn(y2, c), __fmul_rn(y1, s)));
    } else {
      o[d] = __float2bfloat16(y1);
      o[d + half] = __float2bfloat16(y2);
    }
  }
}

}  // namespace

// C entry point bound with ctypes. Biases may all be null. xn [M, H] bf16 and
// part [splits, M, (Hq + 2 Hkv) D] f32 are scratch buffers the wrapper owns,
// splits = ceil(H / k_split). Returns cudaGetLastError() after the launches
// (0 = launched).
extern "C" int fused_qkv_rope_bf16(const void* x, const void* norm_w, const void* wq,
                                   const void* wk, const void* wv, const void* bq,
                                   const void* bk, const void* bv, const float* cos_t,
                                   const float* sin_t, void* q, void* k, void* v, void* xn,
                                   float* part, int M, int H, int Hq, int Hkv, int D, int k_split,
                                   float eps, void* stream) {
  if (M <= 0 || D % 2 || H % kGemmKC || k_split % kGemmKC || (Hq * D) % kGemmCols ||
      (Hkv * D) % kGemmCols)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* xnb = static_cast<__nv_bfloat16*>(xn);
  rmsnorm_rows<<<M, kNormThreads, 0, s>>>(xb, static_cast<const __nv_bfloat16*>(norm_w), xnb, H,
                                           eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  GemmSegments seg;
  seg.w[0] = static_cast<const __nv_bfloat16*>(wq);
  seg.w[1] = static_cast<const __nv_bfloat16*>(wk);
  seg.w[2] = static_cast<const __nv_bfloat16*>(wv);
  seg.n[0] = Hq * D;
  seg.n[1] = seg.n[2] = Hkv * D;
  err = launch_splitk_gemm(xnb, seg, part, M, H, k_split, s);
  if (err != cudaSuccess) return err;
  const int splits = (H + k_split - 1) / k_split;
  const int threads = std::min(std::max(D / 2, 32), 128);
  qkv_epilogue<<<dim3(M, Hq + 2 * Hkv), threads, 0, s>>>(
      part, splits, M, static_cast<const __nv_bfloat16*>(bq),
      static_cast<const __nv_bfloat16*>(bk), static_cast<const __nv_bfloat16*>(bv), cos_t, sin_t,
      static_cast<__nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(k),
      static_cast<__nv_bfloat16*>(v), Hq, Hkv, D);
  return cudaGetLastError();
}
