// Paged attention for the speculative-decoding verify pass, for Hopper
// (sm_90a): bf16 cache and queries, bf16 tensor-core products
// (mma.sync m16n8k16), f32 softmax weights and accumulation.
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
// entries 0 past its last block) never reads past its table.
//
// What bounds it on an H100: bytes. A (lane, kv head) pair reads ctx_len * D
// * 2 bytes of K and as many of V, and does 4 * S * G * D flops per key --
// 64 flops per 512 bytes at S = 4, G = 4, D = 128, far under the card's
// ~295 flop/byte ridge.
//
// Design: the page-streaming template of paged_attention.cuh with R = S * G
// rows in 16-row tiles (one tile at spec_k 3, G 4; any G): a producer warp
// bulk-copies each live key row once into a 4-stage shared ring (2 stages
// at D = 256) for all
// rows of the tile, four consumer warps run S = Q K^T and O += P V on
// mma.sync with the causal mask per row, P split into a bf16 hi and lo
// pair for the second product; the splits are merged by the last split to finish, in the same
// launch. Keys below the tile's window start or above its last position are
// neither read nor computed. The int8-resident cache's mode is the second
// entry point below.
#include "paged_attention.cuh"

// Splits per (lane, kv head, 16-row tile): the wrapper sizes the partial
// buffers part_acc [B * Hkv, T, splits, 16, D] and part_ml
// [B * Hkv, T, splits, 16, 2] with it (T = ceil(S * G / 16)).
extern "C" int paged_verify_num_splits(int B, int S, int Hq, int Hkv, int max_blocks,
                                       int block_size) {
  if (Hkv <= 0) return 1;
  const int tiles = (S * (Hq / Hkv) + paged::kRows - 1) / paged::kRows;
  return paged::num_splits(B, Hkv, tiles, max_blocks, block_size);
}

// C entry point bound with ctypes. softcap <= 0 and window <= 0 mean "off".
// tickets: B * Hkv * T int32 counters, zero on entry and left zero. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int paged_verify_attention_bf16(const void* q, const void* k_cache,
                                           const void* v_cache, const int* block_tables,
                                           const int* positions, void* out, float* part_acc,
                                           float* part_ml, int* tickets, int B, int S, int Hq,
                                           int Hkv, int D, int num_blocks, int block_size,
                                           int max_blocks, int num_splits, float scale,
                                           float softcap, int window, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || num_splits <= 0) return cudaErrorInvalidValue;
  const paged::Params p = paged::make_params(
      q, k_cache, v_cache, nullptr, nullptr, block_tables, positions, out, part_acc, part_ml,
      tickets, S, Hq / Hkv, Hkv, num_blocks, block_size, max_blocks, num_splits, scale, softcap,
      window);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return paged::launch<64, false>(p, B, s);
    case 128: return paged::launch<128, false>(p, B, s);
    case 256: return paged::launch<256, false>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// The int8 mode, over the int8-resident KV cache: int8 pages with one
// f32 scale per (kv head, page), bf16 queries and output, f32 softmax.
//
// Replaces: the int8 mode of dynamo_tpu/ops/pallas_attention.py::
// paged_verify_attention_pallas (quantized=True, :323, :342, :401): the S
// draft rows of each lane attend over its pages with the causal mask
// kpos <= base + row / G, each page's k / v scale applied to its keys.
//
// What bounds it on an H100: bytes, half of the bf16 mode's: ctx_len * D
// bytes of K mantissas and as many of V per (lane, kv head) pair, plus a
// scale per page, for 4 * S * G * D flops per key.
//
// Design: the bf16 mode's template instantiation with kInt8
// (paged_attention.cuh): int8 page runs bulk-copied into the ring, the
// stage's page scales beside them, each consumer warp's 16-key chunk
// widened to bf16 in a private tile, the k scale on the score columns and
// the v scale on the softmax weights in f32.
//
// C entry point bound with ctypes: paged_verify_attention_bf16's arguments
// with int8 caches and their f32 scale planes k_scales / v_scales
// [Hkv, num_blocks]. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int paged_verify_attention_int8(const void* q, const void* k_cache, const void* v_cache,
                                           const float* k_scales, const float* v_scales,
                                           const int* block_tables, const int* positions,
                                           void* out, float* part_acc, float* part_ml,
                                           int* tickets, int B, int S, int Hq, int Hkv, int D,
                                           int num_blocks, int block_size, int max_blocks,
                                           int num_splits, float scale, float softcap, int window,
                                           void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || num_splits <= 0 || !k_scales || !v_scales)
    return cudaErrorInvalidValue;
  const paged::Params p = paged::make_params(
      q, k_cache, v_cache, k_scales, v_scales, block_tables, positions, out, part_acc, part_ml,
      tickets, S, Hq / Hkv, Hkv, num_blocks, block_size, max_blocks, num_splits, scale, softcap,
      window);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return paged::launch<64, false, true>(p, B, s);
    case 128: return paged::launch<128, false, true>(p, B, s);
    case 256: return paged::launch<256, false, true>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}
