// Paged attention for the speculative-decoding verify pass, for Hopper
// (sm_90a): bf16 cache and queries, bf16 tensor-core products
// (mma.sync m16n8k16), f32 softmax and accumulation.
//
// Replaces: dynamo_tpu/ops/pallas_attention.py::paged_verify_attention_pallas
// (kernel body _verify_kernel). Each lane b feeds S consecutive positions
// base = positions[b, 0] .. base + S - 1 (the last accepted token and its
// drafts), whose K/V are already in the paged, head-major cache
// [Hkv, num_blocks, block_size, D]. Query row r of a kv head's
// group-expanded [S * G, D] slab is draft position r / G, query head
// h * G + r % G, and sees key kpos iff kpos <= base + r / G and, with a
// window, base + r / G - kpos < window. The live context ends at
// ctx_len = positions[b, S - 1] + 1; pages are looked up at
// min(kpos / block_size, last_page), last_page = min((ctx_len - 1) /
// block_size, max_blocks - 1), so a lane whose drafts stop early (table
// entries 0 past its last block) never reads past its table. Scale and
// softcap (cap * tanh(s / cap)) come before the running max; a row that saw
// no key writes 0.
//
// What bounds it on an H100: bytes. A (lane, kv head) pair reads ctx_len * D
// * 2 bytes of K and as many of V, and does 4 * S * G * D flops per key --
// 64 flops per 512 bytes at S = 4, G = 4, D = 128, far under the card's
// ~295 flop/byte ridge. The kernel's job is to read each live K/V row once
// for all S * G rows and to keep enough loads in flight.
//
// Design:
//   * the S * G rows are cut into 16-row tiles, one mma m16 tile each (one
//     tile at spec_k 3, G 4). Split-KV as in the decode kernel: one thread
//     block per (lane, kv head, row tile, 128-key split of the table's
//     reach), 4 warps; blocks whose split holds no key any row of the tile
//     can see exit at once; a second, small kernel merges the splits;
//   * each warp owns 32 consecutive keys of its block's split. It gathers
//     their K and V rows from the pages by cp.async into its own shared
//     tile (all four warps' loads in flight together), computes
//     S = Q K^T (16 x 32) and O += P V on mma.sync with f32 accumulators,
//     P rounded to bf16 for the second product, and keeps its own online
//     softmax; the four warp states are merged once, through shared memory,
//     into the block's partial;
//   * keys below the tile's window start or above its last position are
//     neither read nor computed.
// Not yet (later work): int8 pages with per-(head, page) scale planes (A9);
// TMA page staging; one pass without split partials at short contexts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;        // query rows per tile (one mma m16 tile)
constexpr int kTile = 32;        // keys per warp
constexpr int kSplit = kWarps * kTile;  // keys per block (split-KV)

template <int D>
constexpr int smem_bytes() {
  // Q tile + each warp's K and V tiles; the merge reuses the K/V region
  return (kRows + 2 * kWarps * kTile) * (D + 8) * 2;
}

template <int D, int G>
__global__ void __launch_bounds__(kThreads)
paged_verify_kernel(const __nv_bfloat16* __restrict__ q,        // [B, S, Hkv*G, D]
                    const __nv_bfloat16* __restrict__ k_cache,  // [Hkv, NB, bs, D]
                    const __nv_bfloat16* __restrict__ v_cache,
                    const int* __restrict__ block_tables,       // [B, max_blocks]
                    const int* __restrict__ positions,          // [B, S]
                    float* __restrict__ part_acc,  // [B, Hkv, T, splits, kRows, D]
                    float* __restrict__ part_ml,   // [B, Hkv, T, splits, kRows, 2]
                    int S, int num_splits, int num_blocks, int block_size, int max_blocks,
                    float scale, float softcap, int window) {
  constexpr int kStride = D + 8;  // padded shared row, in bf16
  constexpr int kVec = D / 8;     // 16-byte pieces per row
  constexpr int kDSteps = D / 16;
  constexpr int kNTiles = kTile / 8;
  constexpr int kOTiles = D / 8;
  static_assert(kRows % G == 0, "G must divide the row tile");
  static_assert(kRows * D * 4 * kWarps <= 2 * kWarps * kTile * kStride * 2,
                "warp partials must fit in the K/V region");

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);  // [kRows][kStride]
  __nv_bfloat16* sKV = sQ + kRows * kStride;  // per warp: K [kTile][kStride], V [kTile][kStride]
  __shared__ float s_m[kWarps][kRows];
  __shared__ float s_l[kWarps][kRows];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int Hkv = gridDim.y;
  const int Hq = Hkv * G;
  const int tile = blockIdx.z / num_splits;
  const int split = blockIdx.z % num_splits;
  const size_t part = ((size_t)b * Hkv + h) * gridDim.z + blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int R = S * G;

  const int base = positions[(size_t)b * S];
  const int ctx = positions[(size_t)b * S + S - 1] + 1;
  // positions past the table's reach do not exist (the plain version's
  // gather window is max_blocks * block_size keys wide)
  const int reach = min(ctx, max_blocks * block_size);
  const int last_page = min((ctx - 1) / block_size, max_blocks - 1);
  const int row_first = tile * kRows;
  const int row_last = min(row_first + kRows, R) - 1;
  const int pos_first = base + row_first / G;
  const int pos_last = base + row_last / G;
  // keys any row of the tile can see: [k_lo, k_hi)
  const int k_lo = window > 0 ? max(pos_first - window + 1, 0) : 0;
  const int k_hi = min(pos_last + 1, reach);
  const int lo = max(k_lo, split * kSplit);
  const int hi = min(k_hi, (split + 1) * kSplit);
  if (lo >= hi) {  // nothing live here: an empty partial
    if (tid < kRows) {
      part_ml[(part * kRows + tid) * 2] = -INFINITY;
      part_ml[(part * kRows + tid) * 2 + 1] = 0.f;
    }
    return;
  }

  // ---- Q tile (rows past R are zero) and this warp's K/V keys, all async
  for (int i = tid; i < kRows * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c = (i % kVec) * 8;
    const int gr = row_first + r;
    const bool live = gr < R;
    const size_t off = live ? (((size_t)b * S + gr / G) * Hq + h * G + gr % G) * D + c : 0;
    cp_async16(sQ + r * kStride + c, q + off, live);
  }
  __nv_bfloat16* sK = sKV + warp * 2 * kTile * kStride;
  __nv_bfloat16* sV = sK + kTile * kStride;
  const int t0 = split * kSplit + warp * kTile;  // this warp's first key
  const int w_lo = max(lo, t0);
  const int w_hi = min(hi, t0 + kTile);
  const int* table = block_tables + (size_t)b * max_blocks;
  const size_t head_rows = (size_t)h * num_blocks;
  for (int i = lane; i < kTile * kVec; i += 32) {
    const int r = i / kVec;
    const int c = (i % kVec) * 8;
    const int kpos = t0 + r;
    const bool live = kpos >= w_lo && kpos < w_hi;
    size_t off = 0;
    if (live) {
      const int page = table[min(kpos / block_size, last_page)];
      off = ((head_rows + page) * block_size + kpos % block_size) * D + c;
    }
    cp_async16(sK + r * kStride + c, k_cache + off, live);
    cp_async16(sV + r * kStride + c, v_cache + off, live);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float o[kOTiles][4];
#pragma unroll
  for (int n = 0; n < kOTiles; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // per-thread partial sums, reduced below

  if (w_lo < w_hi) {
    uint32_t qa[kDSteps][4];
    const int r0 = gid;
#pragma unroll
    for (int kk = 0; kk < kDSteps; ++kk) {
      const int c = kk * 16 + tig * 2;
      qa[kk][0] = ld_pair(sQ + r0 * kStride + c);
      qa[kk][1] = ld_pair(sQ + (r0 + 8) * kStride + c);
      qa[kk][2] = ld_pair(sQ + r0 * kStride + c + 8);
      qa[kk][3] = ld_pair(sQ + (r0 + 8) * kStride + c + 8);
    }
    // ---- S = Q K^T: 16 rows x 32 keys
    float s[kNTiles][4];
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    const int mat = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < kDSteps; ++kk) {
#pragma unroll
      for (int n = 0; n < kNTiles; n += 2) {
        uint32_t bf[4];
        ldsm_x4(bf, sK + ((n + (mat >> 1)) * 8 + (lane & 7)) * kStride + kk * 16 + (mat & 1) * 8);
        mma_16816(s[n], qa[kk], bf[0], bf[1]);
        mma_16816(s[n + 1], qa[kk], bf[2], bf[3]);
      }
    }
    // ---- scale, softcap, per-row causal / window mask; row max per quad
    const int gr0 = row_first + r0;
    const int gr1 = gr0 + 8;
    const int qpos[2] = {base + gr0 / G, base + gr1 / G};
    const bool row_ok[2] = {gr0 < R, gr1 < R};
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e >> 1;
        float x = s[n][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const int kpos = t0 + n * 8 + tig * 2 + (e & 1);
        const bool ok = row_ok[row] && kpos >= w_lo && kpos < w_hi && kpos <= qpos[row] &&
                        (window <= 0 || qpos[row] - kpos < window);
        x = ok ? x : -INFINITY;
        s[n][e] = x;
        mx[row] = fmaxf(mx[row], x);
      }
    }
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 1));
      mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 2));
      m_run[row] = mx[row];
    }
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e >> 1;
        const float p = s[n][e] == -INFINITY ? 0.f : expf(s[n][e] - m_run[row]);
        s[n][e] = p;
        l_run[row] += p;
      }
    }
    // ---- O = P V: two n8 tiles of S form one 16-key A fragment
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * j][0], s[2 * j][1]), pack_bf16(s[2 * j][2], s[2 * j][3]),
          pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]), pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      const __nv_bfloat16* vr = sV + (j * 16 + (mat & 1) * 8 + (lane & 7)) * kStride;
#pragma unroll
      for (int n = 0; n < kOTiles; n += 2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, vr + (n + (mat >> 1)) * 8);
        mma_16816(o[n], pa, bf[0], bf[1]);
        mma_16816(o[n + 1], pa, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      l_run[row] += __shfl_xor_sync(0xffffffffu, l_run[row], 1);
      l_run[row] += __shfl_xor_sync(0xffffffffu, l_run[row], 2);
    }
  }

  // ---- merge the four warps' softmax states into the block's partial
  __syncthreads();  // every warp is done with the K/V region
  float* s_acc = reinterpret_cast<float*>(sKV);  // [kWarps][kRows][D]
#pragma unroll
  for (int n = 0; n < kOTiles; ++n) {
    const int c = n * 8 + tig * 2;
    float* r0p = s_acc + ((size_t)warp * kRows + gid) * D + c;
    r0p[0] = o[n][0];
    r0p[1] = o[n][1];
    r0p[8 * D] = o[n][2];
    r0p[8 * D + 1] = o[n][3];
  }
  if (tig == 0) {
    s_m[warp][gid] = m_run[0];
    s_m[warp][gid + 8] = m_run[1];
    s_l[warp][gid] = l_run[0];
    s_l[warp][gid + 8] = l_run[1];
  }
  __syncthreads();
  float* pacc = part_acc + part * kRows * D;
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int row = i / D;
    float mxw = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mxw = fmaxf(mxw, s_m[w][row]);
    float lsum = 0.f, osum = 0.f;
    if (mxw != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float mw = s_m[w][row];
        if (mw == -INFINITY) continue;
        const float f = expf(mw - mxw);
        lsum = fmaf(s_l[w][row], f, lsum);
        osum = fmaf(s_acc[(size_t)w * kRows * D + i], f, osum);
      }
    }
    pacc[i] = osum;
    if (i % D == 0) {
      part_ml[(part * kRows + row) * 2] = mxw;
      part_ml[(part * kRows + row) * 2 + 1] = lsum;
    }
  }
}

// Second pass: merge a (lane, kv head, row tile)'s split partials into the
// output rows, [B, S, Hkv*G, D] bf16.
template <int D, int G>
__global__ void __launch_bounds__(kThreads)
paged_verify_combine(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                     __nv_bfloat16* __restrict__ out, int S, int num_splits) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int Hkv = gridDim.y;
  const int tile = blockIdx.z;
  const int Hq = Hkv * G;
  const size_t first = (((size_t)b * Hkv + h) * gridDim.z + tile) * num_splits;
  const float* pml = part_ml + first * kRows * 2;
  const float* pacc = part_acc + first * kRows * D;
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int row = i / D;
    const int d = i % D;
    const int gr = tile * kRows + row;
    if (gr >= S * G) break;  // rows are contiguous in i: the rest are padding
    float mx = -INFINITY;
    for (int s = 0; s < num_splits; ++s) mx = fmaxf(mx, pml[(s * kRows + row) * 2]);
    float lsum = 0.f, osum = 0.f;
    if (mx != -INFINITY) {
      for (int s = 0; s < num_splits; ++s) {
        const float ms = pml[(s * kRows + row) * 2];
        if (ms == -INFINITY) continue;
        const float f = expf(ms - mx);
        lsum = fmaf(pml[(s * kRows + row) * 2 + 1], f, lsum);
        osum = fmaf(pacc[(size_t)s * kRows * D + i], f, osum);
      }
    }
    out[(((size_t)b * S + gr / G) * Hq + h * G + gr % G) * D + d] =
        __float2bfloat16(lsum == 0.f ? 0.f : osum / lsum);
  }
}

template <int D, int G>
cudaError_t launch(const void* q, const void* k_cache, const void* v_cache, const int* block_tables,
                   const int* positions, void* out, float* part_acc, float* part_ml, int B, int S,
                   int Hkv, int num_blocks, int block_size, int max_blocks, float scale,
                   float softcap, int window, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<D>();
  // set on every launch: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(paged_verify_kernel<D, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const int tiles = (S * G + kRows - 1) / kRows;
  const int splits = (max_blocks * block_size + kSplit - 1) / kSplit;
  paged_verify_kernel<D, G><<<dim3(B, Hkv, tiles * splits), kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_cache),
      static_cast<const __nv_bfloat16*>(v_cache), block_tables, positions, part_acc, part_ml, S,
      splits, num_blocks, block_size, max_blocks, scale, softcap, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_verify_combine<D, G><<<dim3(B, Hkv, tiles), kThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<__nv_bfloat16*>(out), S, splits);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_g(int G, const void* q, const void* k_cache, const void* v_cache,
                     const int* block_tables, const int* positions, void* out, float* part_acc,
                     float* part_ml, int B, int S, int Hkv, int num_blocks, int block_size,
                     int max_blocks, float scale, float softcap, int window, cudaStream_t stream) {
  switch (G) {
    case 1: return launch<D, 1>(q, k_cache, v_cache, block_tables, positions, out, part_acc, part_ml, B, S, Hkv, num_blocks, block_size, max_blocks, scale, softcap, window, stream);
    case 2: return launch<D, 2>(q, k_cache, v_cache, block_tables, positions, out, part_acc, part_ml, B, S, Hkv, num_blocks, block_size, max_blocks, scale, softcap, window, stream);
    case 4: return launch<D, 4>(q, k_cache, v_cache, block_tables, positions, out, part_acc, part_ml, B, S, Hkv, num_blocks, block_size, max_blocks, scale, softcap, window, stream);
    case 8: return launch<D, 8>(q, k_cache, v_cache, block_tables, positions, out, part_acc, part_ml, B, S, Hkv, num_blocks, block_size, max_blocks, scale, softcap, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point bound with ctypes. softcap <= 0 and window <= 0 mean "off".
// part_acc [B, Hkv, T, splits, 16, D] and part_ml [B, Hkv, T, splits, 16, 2]
// are f32 scratch the wrapper owns (T = ceil(S * G / 16), splits =
// ceil(max_blocks * block_size / 128)). Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int paged_verify_attention_bf16(const void* q, const void* k_cache,
                                           const void* v_cache, const int* block_tables,
                                           const int* positions, void* out, float* part_acc,
                                           float* part_ml, int B, int S, int Hq, int Hkv, int D,
                                           int num_blocks, int block_size, int max_blocks,
                                           float scale, float softcap, int window, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || S <= 0) return cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_g<64>(G, q, k_cache, v_cache, block_tables, positions, out, part_acc, part_ml, B, S, Hkv, num_blocks, block_size, max_blocks, scale, softcap, window, s);
    case 128: return launch_g<128>(G, q, k_cache, v_cache, block_tables, positions, out, part_acc, part_ml, B, S, Hkv, num_blocks, block_size, max_blocks, scale, softcap, window, s);
    default: return cudaErrorInvalidValue;
  }
}
