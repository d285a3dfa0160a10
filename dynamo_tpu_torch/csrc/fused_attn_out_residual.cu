// Fused attention-output projection + residual add for Hopper (sm_90a),
// bf16 weights and activations, f32 accumulation.
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
// Design (two launches on the caller's stream): the split-K skinny product
// of hopper_common.cuh (128-column tiles x contraction splits, ~4 blocks per
// SM, every weight element read once for all M rows on the tensor cores)
// into f32 partials [splits, M, H], then residual_epilogue sums each
// element's partials in split order (deterministic), casts to bf16 and adds
// x. The epilogue is elementwise, so it could ride the product's last
// split; it is a separate pass because blocks of one column tile finish in
// no order.
// Not yet (later work): int8 weights (A9); the raw f32 partial_out mode of
// the tensor-parallel path (A12); TMA + wgmma for the weight stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int kEpiThreads = 256;

__global__ void __launch_bounds__(kEpiThreads)
residual_epilogue(const float* __restrict__ part, int splits, const __nv_bfloat16* __restrict__ x,
                  __nv_bfloat16* __restrict__ out, size_t total) {
  for (size_t i = (size_t)blockIdx.x * kEpiThreads + threadIdx.x; i < total;
       i += (size_t)gridDim.x * kEpiThreads) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc = __fadd_rn(acc, part[s * total + i]);
    const float y = __bfloat162float(__float2bfloat16(acc));
    out[i] = __float2bfloat16(__fadd_rn(__bfloat162float(x[i]), y));
  }
}

}  // namespace

// C entry point bound with ctypes. part [splits, M, H] f32 is a scratch
// buffer the wrapper owns, splits = ceil(K / k_split) with K = attn's width.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int fused_attn_out_residual_bf16(const void* attn, const void* wo, const void* x,
                                            void* out, float* part, int M, int K, int H,
                                            int k_split, void* stream) {
  if (M <= 0 || K % kGemmKC || k_split % kGemmKC || H % kGemmCols) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GemmSegments seg;
  seg.w[0] = static_cast<const __nv_bfloat16*>(wo);
  seg.w[1] = seg.w[2] = nullptr;
  seg.n[0] = H;
  seg.n[1] = seg.n[2] = 0;
  cudaError_t err =
      launch_splitk_gemm(static_cast<const __nv_bfloat16*>(attn), seg, part, M, K, k_split, s);
  if (err != cudaSuccess) return err;
  const int splits = (K + k_split - 1) / k_split;
  const size_t total = (size_t)M * H;
  const size_t need = (total + kEpiThreads - 1) / kEpiThreads;
  const int blocks = need < 1024 ? (int)need : 1024;
  residual_epilogue<<<blocks, kEpiThreads, 0, s>>>(part, splits,
                                                   static_cast<const __nv_bfloat16*>(x),
                                                   static_cast<__nv_bfloat16*>(out), total);
  return cudaGetLastError();
}
