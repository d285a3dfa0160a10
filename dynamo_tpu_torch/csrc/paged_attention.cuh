// Paged attention over the head-major KV cache for Hopper (sm_90a): one
// page-streaming design, written once, that paged_decode_attention.cu (one
// query position per sequence) and paged_verify_attention.cu (the S draft
// positions of a spec-decode verify pass) instantiate over a bf16 cache, and
// paged_decode_attention_int8.cu / paged_verify_attention_int8.cu over an
// int8-resident one (int8 pages, one f32 scale per (kv head, page)).
//
// The work: a (lane b, kv head h) pair has R query rows -- decode R = G, the
// kv head's GQA group at position base = context_lens[b] - 1; verify R = S * G,
// row r at position base + r / G, base = positions[b, 0]. Any group G: the
// rows go in 16-row tiles (ceil(R / 16) of them), the last one padded. Row r sees key kpos
// iff kpos <= its position and, with a window, position - kpos < window. The
// keys live in pages of the cache [Hkv, num_blocks, block_size, D], found
// through the lane's block table at min(kpos / block_size, last_page). Scale
// and softcap (cap * tanh(s / cap)) come before the running max; a row that
// saw no key writes 0.
//
// What bounds it on an H100: bytes. A pair reads ctx * D * 2 bytes of K and
// as many of V (int8: ctx * D and the pages' scales) and does 4 * R * D flops
// per key -- 16 flops per 512 bytes for decode at G = 4, D = 128 -- far
// under the card's ~295 flop/byte ridge. So
// every live K/V row is read once for all R rows, and the copies stay in
// flight without gaps.
//
// Design (one launch per call):
//   * grid (pair, 16-row tile, split), splits outermost. The host sizes
//     the split dimension NS from B, Hkv, the tiles and the SM count alone
//     (num_splits below), so the wrapper never reads a length back. In the
//     kernel every block sums the call's live keys (B loads), and each
//     (pair, tile) cuts its keys [k_lo, k_hi) into at most NS splits of
//     equal length, a multiple of 16 and at least kMinSplitKeys, about the
//     call's keys over the card's resident blocks: long contexts get more
//     splits, and the live blocks fill the card once. Blocks past the last
//     live split return at once;
//   * one producer warp walks the block table and copies the split's key
//     rows, kStageKeys consecutive positions per stage, into a ring in
//     shared memory (kDecodeStages / kVerifyStages deep: three decode
//     blocks or one verify block per SM, whichever measured faster; verify
//     at D = 256 takes 2 stages, what fits) with
//     cp.async.bulk (1-D TMA, no tensor map), completing on the stage's
//     "full" mbarrier; the consumers release a
//     stage on its "empty" mbarrier. Each run of the stage's keys that lies
//     in one page (a whole page where the stage covers it) is one copy into
//     unpadded rows. The ldmatrix reads then meet 8-way bank conflicts, but
//     one copy per key row into padded, conflict-free rows measured slower
//     on the H100 (tools/kernel_variants.py, paged/row_copy): 16x the
//     copies cost more;
//   * four consumer warps take 16-key chunks of each stage in turn. Scores
//     S = Q K^T run on mma.sync m16n8k16 (bf16 inputs, exact products, f32
//     sums): the R rows are padded to the m16 tile, so no shuffle per key;
//     the softmax is online per warp (a row's max is a 4-lane shuffle);
//     O += P V on mma.sync too, with P split into a bf16 hi and lo pair
//     (two products; |error| ~2^-17 of each weight), so the weights keep
//     their f32 precision and verify at S = 1 equals decode; the second
//     product costs nothing measurable in this memory-bound loop;
//   * the int8 mode (kInt8: the cache holds int8 mantissas and one f32
//     scale per (kv head, page), the reference's quantized=True) keeps all
//     of the above. Its pages land in the ring as int8, half the bytes. The
//     producer also writes each stage key's two scales (looked up through
//     the block table) into shared memory beside the stage. Each consumer
//     warp widens its own 16-key chunk of K and V to bf16 in a private,
//     padded tile (exact: |q| <= 127) and runs the bf16 products on it; the
//     k scale multiplies the chunk's score columns in f32 before the score
//     scale and softcap, and the v scale multiplies the softmax weights
//     before their hi / lo split (the softmax sum takes them unscaled), so
//     each page's scale applies to its own keys however a stage spans pages;
//   * the four warps' states are merged through shared memory in warp
//     order. A (pair, tile) with one live split writes bf16 directly;
//     otherwise each split writes its f32 partial (running max, sum,
//     unnormalised accumulator), takes a ticket from an int32 counter, and
//     the last to arrive merges the partials in split order, writes bf16
//     and resets the counter for the next call. The order is fixed, so two
//     calls on the same inputs give bitwise-equal outputs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace paged {

constexpr int kConsumers = 4;                     // consumer warps
constexpr int kThreads = 32 * (kConsumers + 1);   // and one producer warp
constexpr int kRows = 16;                         // query rows per tile (one mma m16 tile)
constexpr int kStageKeys = 64;                    // key positions per ring stage
constexpr int kDecodeStages = 2;                  // ring depth of the decode kernel
constexpr int kVerifyStages = 4;                  // ... and of the verify kernel
constexpr int kBlocksPerSM = 4;                   // split target, if every split were live
constexpr int kMinSplitKeys = 64;                 // shortest split
constexpr int kMaxDevices = 64;
static_assert(kStageKeys % 16 == 0, "a stage is whole 16-key chunks");

struct Params {
  const __nv_bfloat16* q;        // [B, S, Hkv * G, D]
  const void* k_cache;           // [Hkv, num_blocks, block_size, D] bf16 (int8 in the int8 mode)
  const void* v_cache;
  const float* k_scales;         // int8 mode: [Hkv, num_blocks] f32; else null
  const float* v_scales;
  const int* tables;             // [B, max_blocks]
  const int* lens;               // decode: context_lens [B]; verify: positions [B, S]
  __nv_bfloat16* out;            // like q
  float* part_acc;               // [B * Hkv, T, NS, kRows, D]
  float* part_ml;                // [B * Hkv, T, NS, kRows, 2] (max, sum)
  int* tickets;                  // [B * Hkv, T], zero between calls
  int S, G, Hkv, num_blocks, block_size, max_blocks, num_splits;
  int slots;                     // blocks of this kernel resident on the card at once
  float scale, softcap;
  int window;
};

template <int D>
__host__ __device__ constexpr int row_stride() {  // bf16 elements per shared K/V/Q row
  return D;  // unpadded: page runs land as they lie in the cache
}

// verify's deeper ring does not fit the shared memory at D = 256: two stages
template <int D, bool kDecode>
__host__ __device__ constexpr int ring_stages() {
  return kDecode ? kDecodeStages : (D > 128 ? 2 : kVerifyStages);
}

template <int D, bool kDecode, bool kInt8>
__host__ __device__ constexpr size_t ring_bytes() {
  return (size_t)ring_stages<D, kDecode>() * 2 * kStageKeys * row_stride<D>() * (kInt8 ? 1 : 2);
}

// int8 mode: each consumer warp's bf16 K and V tiles of its 16-key chunk,
// rows padded by 16 bytes (ldmatrix reads them without bank conflicts)
template <int D>
__host__ __device__ constexpr int private_stride() {
  return D + 8;
}

template <int D, bool kDecode, bool kInt8>
__host__ __device__ constexpr size_t stage_area_bytes() {
  // the ring, then (int8 mode) the private tiles and each stage's K and V
  // scales per key
  return ring_bytes<D, kDecode, kInt8>() +
         (kInt8 ? (size_t)kConsumers * 2 * 16 * private_stride<D>() * 2 +
                      (size_t)ring_stages<D, kDecode>() * 2 * kStageKeys * 4
                : 0);
}

template <int D, bool kDecode, bool kInt8>
__host__ __device__ constexpr size_t smem_bytes() {
  // barriers, the Q tile, then the stage area (reused by the warps' merge)
  constexpr size_t area = stage_area_bytes<D, kDecode, kInt8>();
  constexpr size_t merge = (size_t)kConsumers * kRows * D * 4;
  return 128 + (size_t)kRows * row_stride<D>() * 2 + (area > merge ? area : merge);
}

__device__ __forceinline__ void consumers_sync() {  // the consumer warps only
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 32) : "memory");
}

// four consecutive outputs v / l (0 where the row saw no key) as bf16
__device__ __forceinline__ void store_out4(__nv_bfloat16* dst, const float4& v, float l) {
  if (l == 0.f) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
    return;
  }
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(pack_bf16(v.x / l, v.y / l), pack_bf16(v.z / l, v.w / l));
}

__device__ __forceinline__ void fma4(float4& acc, const float4& x, float f) {
  acc.x = fmaf(x.x, f, acc.x);
  acc.y = fmaf(x.y, f, acc.y);
  acc.z = fmaf(x.z, f, acc.z);
  acc.w = fmaf(x.w, f, acc.w);
}

// (lo, hi) minus their bf16 roundings `hi`, as one bf16 pair
__device__ __forceinline__ uint32_t bf16_residual(float a, float b, uint32_t hi) {
  const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  return pack_bf16(a - r.x, b - r.y);
}

template <int D, bool kDecode, bool kInt8>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(const Params p) {
  constexpr int kS = row_stride<D>();
  constexpr int kStages = ring_stages<D, kDecode>();
  constexpr int kEB = kInt8 ? 1 : 2;  // bytes per cached element
  constexpr int kRowB = D * kEB;      // bytes per cached K / V row
  constexpr int kVec = D / 8;         // 16-byte pieces per bf16 row
  constexpr int kPS = private_stride<D>();
  constexpr bool kQRegs = D <= 128;  // Q fragments in registers (else reloaded per chunk)
  const int pair = blockIdx.x;  // splits outermost: the blocks of split 0 start first
  const int tile = blockIdx.y;
  const int split = blockIdx.z;
  const int b = pair / p.Hkv;
  const int h = pair % p.Hkv;
  const int G = p.G;
  const int R = p.S * G;
  const int row_first = tile * kRows;
  const int rows = min(kRows, R - row_first);

  // the lane's first query position and one past its last
  int base, ctx;
  if constexpr (kDecode) {
    ctx = p.lens[b];
    base = ctx - 1;
  } else {
    base = p.lens[(size_t)b * p.S];
    ctx = p.lens[(size_t)b * p.S + p.S - 1] + 1;
  }
  // positions past the table's reach do not exist (the plain version's
  // gather window is max_blocks * block_size keys wide)
  const int table_keys = p.max_blocks * p.block_size;
  const int reach = min(ctx, table_keys);
  const int last_page = max(0, min((ctx - 1) / p.block_size, p.max_blocks - 1));
  const int pos_first = base + row_first / G;
  const int pos_last = base + (row_first + rows - 1) / G;
  // keys some row of the tile can see: [k_lo, k_hi)
  const int k_lo = p.window > 0 ? max(pos_first - p.window + 1, 0) : 0;
  const int k_hi = min(pos_last + 1, reach);
  const int n_keys = max(k_hi - k_lo, 0);
  // past what even the shortest splits need: nothing live here, and no
  // need for the block-wide sum below
  if (split > 0 && split * kMinSplitKeys >= n_keys) return;
  // Split length: the call's live keys over the card's resident blocks, so
  // that long contexts get more splits than short ones and the live blocks
  // fill the card once, not once and a bit (a split holds at least `fair`
  // keys) -- or shorter if this (pair, tile) has more keys than num_splits
  // such pieces hold. Every block computes the same total.
  __shared__ long long s_total;
  const int tid = threadIdx.x;
  if (tid < 32) {
    const int B = gridDim.x / p.Hkv;
    long long sum = 0;
    for (int i = tid; i < B; i += 32) {
      const int c = kDecode ? p.lens[i] : p.lens[(size_t)i * p.S + p.S - 1] + 1;
      int n = min(c, table_keys);
      if (p.window > 0) n = min(n, p.window + p.S);
      sum += max(n, 0);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (tid == 0) s_total = sum * p.Hkv * gridDim.y;
  }
  __syncthreads();
  const long long fair = max(1LL, (s_total + p.slots - 1) / p.slots);
  const int want = (int)max(1LL, min((long long)p.num_splits, n_keys / fair));
  const int per = (n_keys + want - 1) / want;
  const int chunk = max(kMinSplitKeys, (per + 15) & ~15);
  const int n_live = max(1, (n_keys + chunk - 1) / chunk);
  if (split >= n_live) return;  // nothing live here
  const int lo = k_lo + split * chunk;
  const int hi = min(k_hi, lo + chunk);
  const int n_stages = hi > lo ? (hi - lo + kStageKeys - 1) / kStageKeys : 0;

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + 128);  // [kRows][kS]
  // per stage: K [kStageKeys][D], V [kStageKeys][D] as cached (bf16 or int8)
  unsigned char* ring = smem + 128 + kRows * kS * 2;
  // int8 mode: the consumer warps' private bf16 tiles, then the scales
  __nv_bfloat16* priv = reinterpret_cast<__nv_bfloat16*>(ring + ring_bytes<D, kDecode, kInt8>());
  float* s_scale = reinterpret_cast<float*>(priv + (kInt8 ? kConsumers * 2 * 16 * kPS : 0));
  // stage st's K scales at s_scale[st * 2 * kStageKeys], its V scales after them
  __shared__ float s_m[kConsumers][kRows];
  __shared__ float s_l[kConsumers][kRows];
  __shared__ int s_last;

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int Hq = p.Hkv * G;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  float o[D / 8][4];
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // per-thread partial sums, reduced below
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  if (warp == kConsumers) {
    // ---- producer: the split's key rows, stage by stage, ahead of the consumers
    const int bs = p.block_size;
    const int* table = p.tables + (size_t)b * p.max_blocks;
    const size_t head_row0 = (size_t)h * p.num_blocks * bs;  // this head's first cache row
    const unsigned char* kc = static_cast<const unsigned char*>(p.k_cache);
    const unsigned char* vc = static_cast<const unsigned char*>(p.v_cache);
    for (int j = 0; j < n_stages; ++j) {
      const int st = j % kStages;
      if (j >= kStages) mbar_wait(&empty[st], ((j / kStages) - 1) & 1);
      const int a = lo + j * kStageKeys;
      const int n = min(hi - a, kStageKeys);
      unsigned char* dk = ring + (size_t)st * 2 * kStageKeys * kRowB;
      unsigned char* dv = dk + kStageKeys * kRowB;
      // one copy per run of the stage's rows that lies in one page
      const int pg0 = a / bs;
      const int n_runs = (a + n - 1) / bs - pg0 + 1;
      if (n < kStageKeys) {
        // the split's last stage: its dead V rows read as zeros (a weight of
        // 0 times stale bits could still be NaN on the tensor cores)
        constexpr int kPieces = kRowB / 16;
        for (int i = n * kPieces + lane; i < kStageKeys * kPieces; i += 32)
          *reinterpret_cast<uint4*>(dv + i * 16) = make_uint4(0u, 0u, 0u, 0u);
        fence_proxy_async();
      }
      if constexpr (kInt8) {
        // each live key's k and v scale (its page's), dead keys' 0: written
        // before the arrival below, which releases them to the consumers
        float* sk = s_scale + st * 2 * kStageKeys;
        for (int i = n + lane; i < kStageKeys; i += 32) sk[i] = sk[kStageKeys + i] = 0.f;
        for (int i = lane; i < n_runs; i += 32) {
          const int pg = pg0 + i;
          const int page = table[min(pg, last_page)];
          const float ks = p.k_scales[(size_t)h * p.num_blocks + page];
          const float vs = p.v_scales[(size_t)h * p.num_blocks + page];
          for (int r = max(a, pg * bs); r < min(a + n, (pg + 1) * bs); ++r) {
            sk[r - a] = ks;
            sk[kStageKeys + r - a] = vs;
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_expect_tx(&full[st], (uint32_t)n * kRowB * 2);
      __syncwarp();
      for (int i = lane; i < n_runs; i += 32) {
        const int pg = pg0 + i;
        const int s0 = max(a, pg * bs);
        const int s1 = min(a + n, (pg + 1) * bs);
        const int page = table[min(pg, last_page)];
        const size_t src = (head_row0 + (size_t)page * bs + (s0 - pg * bs)) * kRowB;
        bulk_load(dk + (s0 - a) * kRowB, kc + src, (s1 - s0) * kRowB, &full[st]);
        bulk_load(dv + (s0 - a) * kRowB, vc + src, (s1 - s0) * kRowB, &full[st]);
      }
    }
  } else {
    // ---- consumers: 16-key chunks of each stage, warp w takes chunks w, w + 4, ...
    const int gid = lane >> 2;
    const int tig = lane & 3;
    const int mat = lane >> 3;
    int qpos[2];
    bool row_ok[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = gid + 8 * rr;
      row_ok[rr] = r < rows;
      qpos[rr] = base + (row_first + r) / G;
    }
    // the Q tile (rows past R are zero), loaded while the first stage flies
    for (int i = tid; i < kRows * kVec; i += kConsumers * 32) {
      const int r = i / kVec;
      const int c = (i % kVec) * 8;
      const int gr = row_first + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows)
        v = *reinterpret_cast<const uint4*>(
            p.q + (((size_t)b * p.S + gr / G) * Hq + h * G + gr % G) * D + c);
      *reinterpret_cast<uint4*>(sQ + r * kS + c) = v;
    }
    consumers_sync();
    uint32_t qa[kQRegs ? D / 16 : 1][4];
    const __nv_bfloat16* qrow = sQ + ((mat & 1) * 8 + (lane & 7)) * kS + (mat >> 1) * 8;
    if constexpr (kQRegs) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(qa[kk], qrow + kk * 16);
    }
    __nv_bfloat16* pk = priv + warp * 2 * 16 * kPS;  // int8 mode: this warp's K tile
    __nv_bfloat16* pv = pk + 16 * kPS;               // ... and V tile
    for (int j = 0; j < n_stages; ++j) {
      const int st = j % kStages;
      mbar_wait(&full[st], (j / kStages) & 1);
      const int a = lo + j * kStageKeys;
      const int n = min(hi - a, kStageKeys);
      const unsigned char* sk = ring + (size_t)st * 2 * kStageKeys * kRowB;
      const unsigned char* sv = sk + kStageKeys * kRowB;
      for (int c = warp; c * 16 < n; c += kConsumers) {
        // the chunk's bf16 K and V rows: in the ring (bf16 mode), or widened
        // from it into this warp's tiles (int8 mode)
        const __nv_bfloat16* ck;
        const __nv_bfloat16* cv;
        int rs;  // their row stride in elements
        if constexpr (kInt8) {
          __syncwarp();  // the previous chunk's ldmatrix reads are done
          constexpr int kPieces = D / 16;  // 16-int8 pieces per row
#pragma unroll
          for (int i = lane; i < 16 * kPieces; i += 32) {
            const int r = i / kPieces;
            const int col = (i % kPieces) * 16;
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              const uint4 w = *reinterpret_cast<const uint4*>((m ? sv : sk) + (c * 16 + r) * D + col);
              uint4* dst = reinterpret_cast<uint4*>((m ? pv : pk) + r * kPS + col);
              i8x16_to_bf16x16(w, dst[0], dst[1]);
            }
          }
          __syncwarp();
          ck = pk;
          cv = pv;
          rs = kPS;
        } else {
          ck = reinterpret_cast<const __nv_bfloat16*>(sk) + c * 16 * kS;
          cv = reinterpret_cast<const __nv_bfloat16*>(sv) + c * 16 * kS;
          rs = kS;
        }
        // S = Q K^T: 16 rows x 16 keys, two n8 tiles
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        const __nv_bfloat16* kr = ck + ((mat >> 1) * 8 + (lane & 7)) * rs + (mat & 1) * 8;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t qf[4];
          if constexpr (kQRegs) {
            qf[0] = qa[kk][0];
            qf[1] = qa[kk][1];
            qf[2] = qa[kk][2];
            qf[3] = qa[kk][3];
          } else {
            ldsm_x4(qf, qrow + kk * 16);
          }
          uint32_t bf[4];
          ldsm_x4(bf, kr + kk * 16);
          mma_16816(s[0], qf, bf[0], bf[1]);
          mma_16816(s[1], qf, bf[2], bf[3]);
        }
        // (the int8 mode's k scales,) scale, softcap, causal / window / live
        // mask; the new row maxima
        const int key0 = a + c * 16;
        float2 kscl[2], vscl[2];  // this thread's keys' page scales
        if constexpr (kInt8) {
          const float* sc = s_scale + st * 2 * kStageKeys + c * 16 + tig * 2;
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            kscl[t] = *reinterpret_cast<const float2*>(sc + t * 8);
            vscl[t] = *reinterpret_cast<const float2*>(sc + kStageKeys + t * 8);
          }
        }
        float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
        for (int t = 0; t < 2; ++t) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = e >> 1;
            const int kpos = key0 + t * 8 + tig * 2 + (e & 1);
            float x = s[t][e];
            if constexpr (kInt8) x *= (e & 1) ? kscl[t].y : kscl[t].x;
            x *= p.scale;
            if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
            const bool ok = row_ok[rr] && kpos < hi && kpos <= qpos[rr] &&
                            (p.window <= 0 || qpos[rr] - kpos < p.window);
            x = ok ? x : -INFINITY;
            s[t][e] = x;
            mx[rr] = fmaxf(mx[rr], x);
          }
        }
        float alpha[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
          mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
          alpha[rr] = mx[rr] == -INFINITY ? 1.f : expf(m_run[rr] - mx[rr]);
          m_run[rr] = mx[rr];
          l_run[rr] *= alpha[rr];
        }
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          o[n][0] *= alpha[0];
          o[n][1] *= alpha[0];
          o[n][2] *= alpha[1];
          o[n][3] *= alpha[1];
        }
#pragma unroll
        for (int t = 0; t < 2; ++t) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = e >> 1;
            // masked keys contribute exactly 0
            const float w = s[t][e] == -INFINITY ? 0.f : expf(s[t][e] - m_run[rr]);
            l_run[rr] += w;
            // the int8 mode's v scale rides the weight into P V
            if constexpr (kInt8)
              s[t][e] = w * ((e & 1) ? vscl[t].y : vscl[t].x);
            else
              s[t][e] = w;
          }
        }
        // O += P V: the two n8 score tiles form one 16-key A fragment, P
        // as a bf16 hi part and the bf16 rounding of what hi leaves
        const uint32_t ph[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                                pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
        const uint32_t pl[4] = {bf16_residual(s[0][0], s[0][1], ph[0]),
                                bf16_residual(s[0][2], s[0][3], ph[1]),
                                bf16_residual(s[1][0], s[1][1], ph[2]),
                                bf16_residual(s[1][2], s[1][3], ph[3])};
        const __nv_bfloat16* vr = cv + ((mat & 1) * 8 + (lane & 7)) * rs + (mat >> 1) * 8;
#pragma unroll
        for (int n = 0; n < D / 8; n += 2) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, vr + n * 8);
          mma_16816(o[n], ph, bf[0], bf[1]);
          mma_16816(o[n + 1], ph, bf[2], bf[3]);
          mma_16816(o[n], pl, bf[0], bf[1]);
          mma_16816(o[n + 1], pl, bf[2], bf[3]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      l_run[rr] += __shfl_xor_sync(0xffffffffu, l_run[rr], 1);
      l_run[rr] += __shfl_xor_sync(0xffffffffu, l_run[rr], 2);
    }
  }

  // ---- merge the consumer warps' states, in warp order
  __syncthreads();  // every stage has landed and been read: the ring is free
  float* s_acc = reinterpret_cast<float*>(ring);  // [kConsumers][kRows][D]
  if (warp < kConsumers) {
    const int gid = lane >> 2;
    const int tig = lane & 3;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      float* r0 = s_acc + ((size_t)warp * kRows + gid) * D + n * 8 + tig * 2;
      *reinterpret_cast<float2*>(r0) = make_float2(o[n][0], o[n][1]);
      *reinterpret_cast<float2*>(r0 + 8 * D) = make_float2(o[n][2], o[n][3]);
    }
    if (tig == 0) {
      s_m[warp][gid] = m_run[0];
      s_m[warp][gid + 8] = m_run[1];
      s_l[warp][gid] = l_run[0];
      s_l[warp][gid + 8] = l_run[1];
    }
  }
  __shared__ float s_f[kConsumers][kRows];  // each warp's weight per row
  __shared__ float s_rm[kRows];              // the block's running max per row
  __shared__ float s_rl[kRows];              // ... and sum
  __syncthreads();
  if (tid < kRows) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) mx = fmaxf(mx, s_m[w][tid]);
    float lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) {
      const float mw = s_m[w][tid];
      const float f = mw == -INFINITY ? 0.f : expf(mw - mx);
      s_f[w][tid] = f;
      lsum = fmaf(s_l[w][tid], f, lsum);
    }
    s_rm[tid] = mx;
    s_rl[tid] = lsum;
  }
  __syncthreads();
  constexpr int kRow4 = D / 4;  // float4s per row
  const int n4 = rows * kRow4;
  const size_t tix = (size_t)pair * gridDim.y + tile;  // this (pair, tile)
  const size_t part = tix * p.num_splits + split;
  auto out_at = [&](int v) {  // the output of float4 v of the tile
    const int gr = row_first + v / kRow4;
    return p.out + (((size_t)b * p.S + gr / G) * Hq + h * G + gr % G) * D + (v % kRow4) * 4;
  };
  for (int v = tid; v < n4; v += kThreads) {
    const int row = v / kRow4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kConsumers; ++w)
      fma4(acc, reinterpret_cast<const float4*>(s_acc + (size_t)w * kRows * D)[v], s_f[w][row]);
    if (n_live == 1)
      store_out4(out_at(v), acc, s_rl[row]);
    else
      reinterpret_cast<float4*>(p.part_acc + part * kRows * D)[v] = acc;
  }
  if (n_live == 1) return;
  if (tid < rows) {
    p.part_ml[(part * kRows + tid) * 2] = s_rm[tid];
    p.part_ml[(part * kRows + tid) * 2 + 1] = s_rl[tid];
  }

  // ---- the last split of this (pair, tile) to finish merges them all
  __syncthreads();  // the block's partial is written (CTA scope) ...
  if (tid == 0) {
    __threadfence();  // ... and visible to the card before the ticket
    s_last = atomicAdd(&p.tickets[tix], 1) == n_live - 1;
    if (s_last) __threadfence();  // the other splits' partials before they are read
  }
  __syncthreads();
  if (!s_last) return;
  const float* pml = p.part_ml + tix * p.num_splits * kRows * 2;
  const float4* pacc = reinterpret_cast<const float4*>(p.part_acc + tix * p.num_splits * kRows * D);
  // every split's (max, sum) per row into shared memory (the ring is free),
  // then one weight per (split, row); each thread then keeps all of its
  // float4 loads of two splits in flight at once
  float* sw = s_acc;                   // [n_live][kRows]: max, then weight
  float* sl = sw + n_live * kRows;     // [n_live][kRows]: sum
  float* s_sum = sl + n_live * kRows;  // [kRows]
  for (int i = tid; i < n_live * kRows; i += kThreads) {
    sw[i] = __ldcg(pml + 2 * i);
    sl[i] = __ldcg(pml + 2 * i + 1);
  }
  __syncthreads();
  if (tid < rows) {
    float mx = -INFINITY;
    for (int s = 0; s < n_live; ++s) mx = fmaxf(mx, sw[s * kRows + tid]);
    float lsum = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const float ms = sw[s * kRows + tid];
      const float f = ms == -INFINITY ? 0.f : expf(ms - mx);
      lsum = fmaf(sl[s * kRows + tid], f, lsum);
      sw[s * kRows + tid] = f;
    }
    s_sum[tid] = lsum;
  }
  __syncthreads();
  constexpr int kPer = (kRows * kRow4 + kThreads - 1) / kThreads;
  float4 acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
  for (int s = 0; s < n_live; ++s) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int v = tid + k * kThreads;
      if (v < n4) fma4(acc[k], __ldcg(pacc + (size_t)s * kRows * kRow4 + v), sw[s * kRows + v / kRow4]);
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int v = tid + k * kThreads;
    if (v < n4) store_out4(out_at(v), acc[k], s_sum[v / kRow4]);
  }
  if (tid == 0) p.tickets[tix] = 0;  // ready for the next call
}

// The kernel's parameters from the C entry points' arguments (slots is set
// by launch).
inline Params make_params(const void* q, const void* k_cache, const void* v_cache,
                          const float* k_scales, const float* v_scales, const int* tables,
                          const int* lens, void* out, float* part_acc, float* part_ml,
                          int* tickets, int S, int G, int Hkv, int num_blocks, int block_size,
                          int max_blocks, int num_splits, float scale, float softcap,
                          int window) {
  Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k_cache = k_cache;
  p.v_cache = v_cache;
  p.k_scales = k_scales;
  p.v_scales = v_scales;
  p.tables = tables;
  p.lens = lens;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.part_acc = part_acc;
  p.part_ml = part_ml;
  p.tickets = tickets;
  p.S = S;
  p.G = G;
  p.Hkv = Hkv;
  p.num_blocks = num_blocks;
  p.block_size = block_size;
  p.max_blocks = max_blocks;
  p.num_splits = num_splits;
  p.scale = scale;
  p.softcap = softcap;
  p.window = window;
  return p;
}

// Splits per (pair, tile), from host-known values only: about kBlocksPerSM
// blocks per SM if every split were live, and no more splits than the
// table's reach holds kMinSplitKeys-key pieces. The wrappers size the
// partial buffers with it.
inline int num_splits(int B, int Hkv, int tiles, int max_blocks, int block_size) {
  static int sms[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  int n = dev < kMaxDevices ? sms[dev] : 0;
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
      n = 132;
    if (dev < kMaxDevices) sms[dev] = n;
  }
  const long long work = (long long)B * Hkv * tiles;
  if (work <= 0) return 1;
  const long long want = ((long long)kBlocksPerSM * n + work - 1) / work;
  const long long most = ((long long)max_blocks * block_size + kMinSplitKeys - 1) / kMinSplitKeys;
  return (int)std::max(1LL, std::min(want, most));
}

template <int D, bool kDecode, bool kInt8 = false>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t kSmem = smem_bytes<D, kDecode, kInt8>();
  static_assert(kSmem <= 232448, "the ring does not fit in shared memory");
  // the attribute belongs to the device's context: set once per device
  static bool attr_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !attr_set[dev]) {
    err = cudaFuncSetAttribute(paged_attention_kernel<D, kDecode, kInt8>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return err;
    // all of the SM's unified memory as shared: two blocks on every SM
    err = cudaFuncSetAttribute(paged_attention_kernel<D, kDecode, kInt8>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) attr_set[dev] = true;
  }
  static int slots[kMaxDevices];
  int n = dev < kMaxDevices ? slots[dev] : 0;
  if (n == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, paged_attention_kernel<D, kDecode, kInt8>,
                                                        kThreads, kSmem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    n = std::max(1, per_sm * sms);
    if (dev < kMaxDevices) slots[dev] = n;
  }
  Params q = p;
  q.slots = n;
  const int tiles = (p.S * p.G + kRows - 1) / kRows;
  paged_attention_kernel<D, kDecode, kInt8>
      <<<dim3(B * p.Hkv, tiles, p.num_splits), kThreads, kSmem, stream>>>(q);
  return cudaGetLastError();
}

}  // namespace paged
