// Paged decode attention for Hopper (sm_90a), bf16 cache, f32 softmax.
//
// Replaces: dynamo_tpu/ops/pallas_attention.py::paged_decode_attention_pallas
// (kernel body _decode_kernel). One new query token per sequence attends over
// its paged, head-major KV cache [Hkv, num_blocks, block_size, D], addressed
// through the sequence's block table, up to context_lens[b] (which includes
// the token just written).
//
// What bounds it on an H100: bytes. A (sequence, kv head) pair reads
// ctx_len * D * 2 bytes of K and as many of V and does 4 * G * D flops per
// key, about 8 flops per byte for G = 4 -- far under the card's ~295
// flop/byte ridge.
//
// Design: the page-streaming template of paged_attention.cuh with R = G rows
// at the single position context_lens[b] - 1: a producer warp bulk-copies
// the live key rows into a 2-stage shared ring, four consumer warps score
// them on mma.sync (the G rows in 16-row m16 tiles, the last one padded;
// a group of more than 16 streams its keys once per tile) and fold P V in with
// P split into a bf16 hi and lo pair, so the softmax weights keep f32
// precision; the splits of a long context are merged by the last split to
// finish, in the same launch. Keys outside [ctx_len - window, ctx_len) are
// never read. The int8-resident cache's mode is the second entry point below.
#include "paged_attention.cuh"

// Splits per (sequence, kv head, 16-row tile): the wrapper sizes the partial
// buffers part_acc [B * Hkv, T, splits, 16, D] and part_ml
// [B * Hkv, T, splits, 16, 2] with it (T = ceil(G / 16) tiles of the group).
extern "C" int paged_decode_num_splits(int B, int Hq, int Hkv, int max_blocks, int block_size) {
  if (Hkv <= 0) return 1;
  const int tiles = (Hq / Hkv + paged::kRows - 1) / paged::kRows;
  return paged::num_splits(B, Hkv, tiles, max_blocks, block_size);
}

// C entry point bound with ctypes. softcap <= 0 and window <= 0 mean "off".
// Any GQA group G = Hq / Hkv. tickets: B * Hkv * T int32 counters, zero on
// entry and left zero. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int paged_decode_attention_bf16(const void* q, const void* k_cache,
                                           const void* v_cache, const int* block_tables,
                                           const int* context_lens, void* out,
                                           float* part_acc, float* part_ml, int* tickets, int B,
                                           int Hq, int Hkv, int D, int num_blocks, int block_size,
                                           int max_blocks, int num_splits, float scale,
                                           float softcap, int window, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || num_splits <= 0) return cudaErrorInvalidValue;
  const paged::Params p = paged::make_params(
      q, k_cache, v_cache, nullptr, nullptr, block_tables, context_lens, out, part_acc, part_ml,
      tickets, /*S=*/1, Hq / Hkv, Hkv, num_blocks, block_size, max_blocks, num_splits, scale,
      softcap, window);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return paged::launch<64, true>(p, B, s);
    case 128: return paged::launch<128, true>(p, B, s);
    case 256: return paged::launch<256, true>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// The int8 mode, over the int8-resident KV cache: int8 pages with one
// f32 scale per (kv head, page), bf16 queries and output, f32 softmax.
//
// Replaces: the int8 mode of dynamo_tpu/ops/pallas_attention.py::
// paged_decode_attention_pallas (quantized=True: the scalar-prefetched
// k_scales / v_scales planes [Hkv, num_blocks], each page's scale
// multiplying its f32 tile inside the online softmax). It computes what the
// reference's dequantize-after-gather path computes (ops/attention.py
// :312-320): attention over K = q_k * s_k and V = q_v * s_v per page.
//
// What bounds it on an H100: bytes, half of the bf16 mode's. A (sequence,
// kv head) pair reads ctx_len * D bytes of K mantissas and as many of V,
// plus a scale per page, for 4 * G * D flops per key.
//
// Design: the bf16 kernel's page-streaming template (paged_attention.cuh)
// instantiated with kInt8: the producer bulk-copies int8 page runs (half
// the bytes per stage) and stages each key's page scales beside them; each
// consumer warp widens its 16-key chunk to bf16 (exact) in a private padded
// tile and runs the same mma.sync products, the k scale on its score
// columns and the v scale on its softmax weights, both in f32.
//
// C entry point bound with ctypes: paged_decode_attention_bf16's arguments
// with int8 caches and their f32 scale planes k_scales / v_scales
// [Hkv, num_blocks]. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int paged_decode_attention_int8(const void* q, const void* k_cache, const void* v_cache,
                                           const float* k_scales, const float* v_scales,
                                           const int* block_tables, const int* context_lens,
                                           void* out, float* part_acc, float* part_ml,
                                           int* tickets, int B, int Hq, int Hkv, int D,
                                           int num_blocks, int block_size, int max_blocks,
                                           int num_splits, float scale, float softcap, int window,
                                           void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || num_splits <= 0 || !k_scales || !v_scales)
    return cudaErrorInvalidValue;
  const paged::Params p = paged::make_params(
      q, k_cache, v_cache, k_scales, v_scales, block_tables, context_lens, out, part_acc, part_ml,
      tickets, /*S=*/1, Hq / Hkv, Hkv, num_blocks, block_size, max_blocks, num_splits, scale,
      softcap, window);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return paged::launch<64, true, true>(p, B, s);
    case 128: return paged::launch<128, true, true>(p, B, s);
    case 256: return paged::launch<256, true, true>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}
