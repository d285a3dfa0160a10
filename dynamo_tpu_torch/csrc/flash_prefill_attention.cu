// Causal flash attention over one padded prompt for Hopper (sm_90a):
// bf16 q/k/v, warpgroup tensor-core products (wgmma) fed by TMA, f32 softmax
// and accumulation.
//
// Replaces: dynamo_tpu/ops/pallas_attention.py::flash_prefill_attention_pallas
// (kernel body kernel_body). q [P, Hkv*G, D] attends causally to k/v
// [P, Hkv, D]; keys at or past valid_len are masked, as are keys outside the
// sliding window (qpos - kpos >= window). Custom scale and softcap
// (cap * tanh(s / cap)) are applied before the running max.
//
// What bounds it on an H100: operations. A prompt of P tokens costs about
// 2 * P^2 * Hq * D flops (half of the P^2 pairs are causal) on
// 2 * P * (Hq + 2 * Hkv) * D bytes, hundreds of flops per byte at
// P >= 512 -- above the card's ~295 flop/byte ridge, so the tensor cores are
// the limit, and only wgmma reaches their full rate.
//
// Design (warp-specialised, one block per (query tile, kv head)):
//   * a query tile is 128 group-expanded rows -- bq = floor(128 / G)
//     positions times the G query heads of the kv head's GQA group, row
//     r = (position p0 + r / G, head h*G + r % G), the TPU kernel's
//     [bq * G, D] slab -- so each K/V tile is read once for the whole group.
//     TMA brings it as one 3-D box (64, G, bq) of q viewed as [P, Hq, D] per
//     64 columns. Any G up to 128: where G does not divide 128 the last
//     128 mod G rows are idle (their scores are computed, never stored);
//   * a producer warpgroup (one issuing thread; setmaxnreg gives its
//     registers to the consumers) keeps 2-stage rings of K and V tiles --
//     128 keys each, 64 at D = 256 so that Q and the rings fit the shared
//     memory -- in flight by TMA; full / empty mbarriers per stage replace
//     __syncthreads.
//     K and V have their own barriers: S can start before V lands, and K's
//     stage is refilled as soon as S is done. TMA zero-fills past P, and the
//     K/V tensor maps end at valid_len, so the ragged edge and the prompt's
//     padding read as zeros;
//   * two consumer warpgroups own 64 rows each (one wgmma m64 tile):
//     S = Q K^T is wgmma m64n128k16 (m64n64k16 at D = 256) with Q and K both from shared memory
//     (K-major, 128-byte swizzle); the online softmax runs in registers
//     with exp2 (scale premultiplied by log2 e); O += P V is wgmma
//     m64n(D)k16 with P from registers (the S accumulator layout packs to
//     the A fragment with no shuffle; P rounded to bf16) and V from shared
//     memory, N-major (transposed B);
//   * the softmax is the bottleneck beside the products (exp2 runs at 16
//     per clock per SM), so it is hidden behind them: a warpgroup issues
//     S_t together with P_{t-1} V_{t-1} and runs the softmax of S_t while
//     the second product is still on the tensor cores; the two warpgroups
//     take turns to issue (named barriers), so one's softmax runs while the
//     other's products keep the tensor cores busy;
//   * setmaxnreg moves registers from the producer to the consumers: with
//     S, O and P live at once (64 + 64 + 32 at D = 128; 32 + 128 + 16 at
//     D = 256) they need ~200, and at ~168 ptxas spills and
//     serialises every wgmma (C7512). Nothing between a wgmma's issue and
//     its wait touches its registers, and the loop has one static shape
//     (tile 0 peeled), or ptxas serialises them too (C7514, C7520);
//   * the key loop visits tiles only from the window's first key to
//     min(last causal key, valid_len) -- acausal, padded and out-of-window
//     tiles are neither loaded nor computed. Only tiles that cross the
//     diagonal, the valid_len edge or the window edge take the per-element
//     mask. Query tiles wholly at or past valid_len are written as zeros
//     without touching K/V;
//   * blocks are ordered heaviest (most causal keys) first: a shorter tail.
// Not yet (later work): a persistent grid (the next tile's loads under this
// tile's epilogue), a TMA store of the output.
#include <math.h>

#include "hopper_common.cuh"

namespace {

constexpr int kRows = 128;                  // group-expanded query rows per block
constexpr int kConsumers = 256;             // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
// registers per thread after setmaxnreg: the consumers hold S, O and P at
// once (64 + 64 + 32 at D = 128, 32 + 128 + 16 at D = 256);
// 2 x 128 x 232 + 128 x 40 = 64512 of the SM's 65536
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kStages = 2;
constexpr int kBox = 128 * 128;             // one 128-row x 64-column bf16 box of Q, bytes
constexpr float kLog2e = 1.4426950408889634f;

// keys per K/V tile: 128, or 64 at D = 256, where the Q tile and two stages
// of K and V then fit the shared memory and O's 128 registers per thread
// leave room for S and P
template <int D>
__host__ __device__ constexpr int keys_per_tile() {
  return D > 128 ? 64 : 128;
}

// shared memory, byte offsets from a 1024-aligned base (the 128-byte swizzle
// repeats every 1024 bytes; wgmma descriptors assume tiles start on it)
template <int D>
struct Layout {
  static constexpr int kBK = keys_per_tile<D>();
  static constexpr int kQTile = (D / 64) * kBox;    // the Q tile: D / 64 boxes of 128 rows
  static constexpr int kKVBox = kBK * 128;          // one kBK-row x 64-column box of K or V
  static constexpr int kKVTile = (D / 64) * kKVBox;
  static constexpr int kQ = 0;
  static constexpr int kK = kQTile;
  static constexpr int kV = kK + kStages * kKVTile;
  static constexpr int kBar = kV + kStages * kKVTile;
  static constexpr int kBytes = kBar + (1 + 4 * kStages) * 8 + 1024;  // barriers, alignment slack
  static_assert(kBytes <= 232448, "the tiles do not fit in shared memory");
};

// wgmma shared-memory descriptor, 128-byte swizzle. K-major operands: sbo =
// 1024 (8 rows of 128 bytes), lbo unused. N-major operands: lbo = the
// stride between 64-wide column boxes, sbo = 1024 (8 k-rows).
__device__ __forceinline__ uint64_t desc128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pin registers that an asynchronous wgmma reads or writes: the compiler
// may not move their uses across this point
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// named barriers 1 and 2 give the two consumer warpgroups turns to issue
// their products: bar.sync waits for `count` threads, bar.arrive counts
// without waiting
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D (64 x 128, f32) (+)= A (64 x 16, smem) * B (16 x 128, smem), both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}
// D (64 x 64, f32) (+)= A (64 x 16, smem) * B (16 x 64, smem), both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
// D (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// D (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256, f32) += A (64 x 16, bf16 registers) * B (16 x 256, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S = Q K^T into the accumulators of one key tile: N = 128 or 64 keys
template <int BK>
__device__ __forceinline__ void wgmma_s(float (&d)[BK / 2], uint64_t da, uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void wgmma_s<128>(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  wgmma_ss_n128(d, da, db, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_s<64>(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  wgmma_ss_n64(d, da, db, scale_d);
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<256>(float (&o)[128], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n256(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n128(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n64(o, a, db);
}

// Online-softmax state of one thread's two rows (ra and ra + 8): running
// max in raw score units, per-thread partial row sums (reduced at the end),
// and the last tile's rescale factors.
struct RowState {
  float m_a = -INFINITY, m_b = -INFINITY;
  float l_a = 0.f, l_b = 0.f;
  float alpha_a = 1.f, alpha_b = 1.f;
};

// What the mask and the softmax of a tile need to know about this thread's
// rows and the call.
struct RowGeom {
  int qa, qb;               // positions of rows ra and ra + 8
  int c0;                   // first of this thread's two columns in each 8-group
  int wq_first, wq_last;    // the warpgroup's first and last live position
  int valid_len, window;
  float mult, cap_in, cap_out;
};

// S = Q K^T for one warpgroup: 64 rows x kBK keys, D / 16 k-steps
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[keys_per_tile<D>() / 2], uint32_t sq,
                                        uint32_t sk) {
  using L = Layout<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;  // 16 columns of a 64-column box, bytes
    wgmma_s<L::kBK>(s, desc128(sq + (kk >> 2) * kBox + col, 16, 1024),
                    desc128(sk + (kk >> 2) * L::kKVBox + col, 16, 1024), kk > 0);
  }
}

// O += P V over the tile's kBK keys, kBK / 16 k-steps
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[keys_per_tile<D>() / 16][4],
                                         uint32_t sv) {
  using L = Layout<D>;
#pragma unroll
  for (int kk = 0; kk < L::kBK / 16; ++kk)
    wgmma_pv<D>(o, pa[kk], desc128(sv + kk * 16 * 128, L::kKVBox, 1024));
}

// softcap, mask, running max, exp2 and row sums of one S tile, in place
template <int kBK>
__device__ __forceinline__ void softmax_tile(float (&s)[kBK / 2], RowState& row, const RowGeom& g,
                                             int k0) {
  if (g.cap_out > 0.f) {
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] = g.cap_out * tanhf(s[i] * g.cap_in);
  }
  // a tile wholly inside every row's causal / valid / window range needs no
  // mask (warpgroup-uniform test)
  const bool interior = k0 + kBK - 1 <= g.wq_first && k0 + kBK <= g.valid_len &&
                        (g.window <= 0 || g.wq_last - k0 < g.window);
  if (!interior) {
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const int qp = (i & 2) ? g.qb : g.qa;
      const int kp = k0 + 8 * (i >> 2) + g.c0 + (i & 1);
      if (!(kp <= qp && kp < g.valid_len && (g.window <= 0 || qp - kp < g.window))) s[i] = -INFINITY;
    }
  }
  // row max over the quad that shares a row
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    mx_a = fmaxf(mx_a, fmaxf(s[4 * j + 0], s[4 * j + 1]));
    mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
  const float mn_a = fmaxf(row.m_a, mx_a), mn_b = fmaxf(row.m_b, mx_b);
  // exp2 of (x - m) * scale * log2(e); a row that has seen no key keeps
  // alpha 1 and weights 0
  row.alpha_a = mn_a == -INFINITY ? 1.f : ex2((row.m_a - mn_a) * g.mult);
  row.alpha_b = mn_b == -INFINITY ? 1.f : ex2((row.m_b - mn_b) * g.mult);
  row.m_a = mn_a;
  row.m_b = mn_b;
  const float base_a = mn_a == -INFINITY ? 0.f : mn_a * g.mult;
  const float base_b = mn_b == -INFINITY ? 0.f : mn_b * g.mult;
  float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    s[4 * j + 0] = ex2(fmaf(s[4 * j + 0], g.mult, -base_a));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], g.mult, -base_a));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], g.mult, -base_b));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], g.mult, -base_b));
    rs_a += s[4 * j + 0] + s[4 * j + 1];
    rs_b += s[4 * j + 2] + s[4 * j + 3];
  }
  row.l_a = row.l_a * row.alpha_a + rs_a;
  row.l_b = row.l_b * row.alpha_b + rs_b;
}

template <int D>
__device__ __forceinline__ void rescale_o(float (&o)[D / 2], const RowState& row) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j + 0] *= row.alpha_a;
    o[4 * j + 1] *= row.alpha_a;
    o[4 * j + 2] *= row.alpha_b;
    o[4 * j + 3] *= row.alpha_b;
  }
}

// P as bf16 A fragments: the accumulators of key groups 2kk and 2kk + 1
// are the k16 fragment of step kk
template <int kBK>
__device__ __forceinline__ void pack_p(const float (&s)[kBK / 2], uint32_t (&pa)[kBK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap tm_q,  // q [P, Hq, D], box (64, G, 128/G)
                     const __grid_constant__ CUtensorMap tm_k,  // k [valid_len, Hkv, D], box (64, 1, kBK)
                     const __grid_constant__ CUtensorMap tm_v,  // v, as k
                     __nv_bfloat16* __restrict__ out,           // [P, Hq, D]
                     int P, int Hkv, int G, int valid_len, float mult, float cap_in,
                     float cap_out, int window) {
  using L = Layout<D>;
  constexpr int kBK = L::kBK;
  constexpr int kHalves = D / 64;
  const int bq = kRows / G;       // query positions per block
  const int live_rows = bq * G;   // rows past it are idle: masked, never stored
  const int n_qt = (P + bq - 1) / bq;
  const int h = blockIdx.x % Hkv;
  const int p0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / Hkv) * bq;  // heaviest first
  const int Hq = Hkv * G;
  const int tid = threadIdx.x;

  if (p0 >= valid_len) {
    // padding of the prompt's bucket: nothing valid to attend from here
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < live_rows * (D / 8); i += kThreads) {
      const int r = i / (D / 8);
      const int pos = p0 + r / G;
      if (pos < P)
        *reinterpret_cast<uint4*>(out + ((size_t)pos * Hq + h * G + r % G) * D +
                                  (i % (D / 8)) * 8) = zero;
    }
    return;
  }

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full_k = full_q + 1;  // [kStages] each
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;
  uint64_t* empty_v = empty_k + kStages;
  if (tid == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty_k + s, kConsumers / 32);  // one arrival per consumer warp
      mbar_init(empty_v + s, kConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int last_q = min(p0 + bq, P) - 1;
  const int k_end = min(last_q + 1, valid_len);  // exclusive bound on live keys
  const int k_first = window > 0 ? max(p0 - (window - 1), 0) : 0;
  const int k_begin = (k_first / kBK) * kBK;
  const int n_tiles = (k_end - k_begin + kBK - 1) / kBK;  // >= 1: p0 < valid_len

  // the warpgroup index, warp-uniform to the compiler too (a test of
  // threadIdx.x would make the consumers' path divergent, and ptxas would
  // serialise their wgmmas)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (wg == kConsumers / 128) {
    reg_dealloc<kProducerRegs>();
    // ---- producer warpgroup: one thread issues every TMA load of the
    // block. K and V have their own release barriers: K of tile t is free
    // once S_t is done, V only once P_t V_t is, an iteration later
    if (tid == kConsumers) {
      // the Q box holds live_rows rows (TMA counts the whole box)
      mbar_expect_tx(full_q, kHalves * live_rows * 128);
      for (int hf = 0; hf < kHalves; ++hf)
        tma_load_3d(smem + L::kQ + hf * kBox, &tm_q, full_q, hf * 64, h * G, p0);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        const uint32_t free_ph = ((t / kStages) & 1) ^ 1;  // the first round passes at once
        const int k0 = k_begin + t * kBK;
        mbar_wait(empty_k + st, free_ph);
        mbar_expect_tx(full_k + st, L::kKVTile);
        for (int hf = 0; hf < kHalves; ++hf)
          tma_load_3d(smem + L::kK + st * L::kKVTile + hf * L::kKVBox, &tm_k, full_k + st, hf * 64,
                      h, k0);
        mbar_wait(empty_v + st, free_ph);
        mbar_expect_tx(full_v + st, L::kKVTile);
        for (int hf = 0; hf < kHalves; ++hf)
          tma_load_3d(smem + L::kV + st * L::kKVTile + hf * L::kKVBox, &tm_v, full_v + st, hf * 64,
                      h, k0);
      }
    }
    return;
  }

  // ---- consumer warpgroups (no path back to the producer's: setmaxnreg
  // needs the two roles to stay apart). Iteration t issues S_t = Q K_t^T and
  // O += P_{t-1} V_{t-1} together, then runs the softmax of S_t while the
  // second product is still on the tensor cores.
  reg_alloc<kConsumerRegs>();
  const int lane = tid & 31;
  const int ra = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);  // rows ra and ra + 8
  const int rb = ra + 8;
  const int qa = p0 + ra / G;
  const int qb = p0 + rb / G;
  const int c0 = 2 * (lane & 3);  // first of this thread's two columns in each 8-group
  const int wq_first = p0 + (wg * 64) / G;
  const int wq_last = min(p0 + (wg * 64 + 63) / G, last_q);

  const uint32_t sq = smem_u32(smem + L::kQ) + wg * 64 * 128;
  const uint32_t sk = smem_u32(smem + L::kK);
  const uint32_t sv = smem_u32(smem + L::kV);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float s[kBK / 2];                // S_t, then its softmax weights in f32
  uint32_t pa[kBK / 16][4];        // P_t as bf16 A fragments
  RowState row;
  const RowGeom geo{qa, qb, c0, wq_first, wq_last, valid_len, window, mult, cap_in, cap_out};
  mbar_wait(full_q, 0);
  __syncwarp();  // the warpgroup's wgmma needs its warps converged
  if (wg == 1) bar_arrive(1, kConsumers);  // warpgroup 0 issues first

  // ---- tile 0: S_0 alone. The loop below then has one static shape --
  // S_t and P_{t-1} V_{t-1} in flight together -- which ptxas can pipeline
  // (a branch on t around a wgmma or its wait serialises every wgmma)
  mbar_wait(full_k, 0);
  __syncwarp();
  bar_sync(1 + wg, kConsumers);
  wgmma_fence();
  issue_s<D>(s, sq, sk);
  wgmma_commit();
  // the other warpgroup's turn; warpgroup 1 leaves out its last arrival so
  // that every bar.sync has exactly one bar.arrive
  if (!(wg == 1 && n_tiles == 1)) bar_arrive(2 - wg, kConsumers);
  wgmma_wait<0>();
  fence_regs(s);
  __syncwarp();
  if (lane == 0) mbar_arrive(empty_k);
  softmax_tile<kBK>(s, row, geo, k_begin);
  pack_p<kBK>(s, pa);

  for (int t = 1; t < n_tiles; ++t) {
    const int st = t % kStages;
    const int pv = (t - 1) % kStages;
    mbar_wait(full_k + st, (t / kStages) & 1);
    __syncwarp();
    bar_sync(1 + wg, kConsumers);
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
    issue_s<D>(s, sq, sk + st * L::kKVTile);
    wgmma_commit();
    mbar_wait(full_v + pv, ((t - 1) / kStages) & 1);
    __syncwarp();
    issue_pv<D>(o, pa, sv + pv * L::kKVTile);
    wgmma_commit();
    if (!(wg == 1 && t == n_tiles - 1)) bar_arrive(2 - wg, kConsumers);
    wgmma_wait<1>();  // S_t is done; P_{t-1} V_{t-1} may still run
    fence_regs(s);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_k + st);  // this warp is done with K_t
    softmax_tile<kBK>(s, row, geo, k_begin + t * kBK);
    wgmma_wait<0>();  // P_{t-1} V_{t-1} is done: O and P's registers are free
    fence_regs(o);
    fence_regs(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_v + pv);
    rescale_o<D>(o, row);
    pack_p<kBK>(s, pa);
  }
  // ---- the last tile's O += P V
  {
    const int pv = (n_tiles - 1) % kStages;
    mbar_wait(full_v + pv, ((n_tiles - 1) / kStages) & 1);
    __syncwarp();
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
    issue_pv<D>(o, pa, sv + pv * L::kKVTile);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }
  float l_a = row.l_a, l_b = row.l_b;

  // ---- normalise and store (a row that saw no key writes 0; idle rows
  // past live_rows are never stored)
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float inv_a = l_a == 0.f ? 0.f : 1.f / l_a;
  const float inv_b = l_b == 0.f ? 0.f : 1.f / l_b;
  const bool st_a = ra < live_rows && qa < P;
  const bool st_b = rb < live_rows && qb < P;
  __nv_bfloat16* out_a = out + ((size_t)qa * Hq + h * G + ra % G) * D + c0;
  __nv_bfloat16* out_b = out + ((size_t)qb * Hq + h * G + rb % G) * D + c0;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (st_a)
      *reinterpret_cast<__nv_bfloat162*>(out_a + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 0] * inv_a, o[4 * j + 1] * inv_a);
    if (st_b)
      *reinterpret_cast<__nv_bfloat162*>(out_b + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int P, int Hkv,
                   int G, int valid_len, float scale, float softcap, int window,
                   cudaStream_t stream) {
  using L = Layout<D>;
  const int Hq = Hkv * G;
  const int bq = kRows / G;  // query positions per block
  // the tensor maps carry the pointers and P, so they are built per call
  CUtensorMap tq, tk, tv;
  const cuuint64_t dq[3] = {(cuuint64_t)D, (cuuint64_t)Hq, (cuuint64_t)P};
  const cuuint64_t sq[2] = {(cuuint64_t)D * 2, (cuuint64_t)Hq * D * 2};
  const cuuint32_t bxq[3] = {64, (cuuint32_t)G, (cuuint32_t)bq};
  // keys at or past valid_len are never attended: the K/V maps end there
  const cuuint64_t dk[3] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)(valid_len > 0 ? valid_len : 1)};
  const cuuint64_t sk[2] = {(cuuint64_t)D * 2, (cuuint64_t)Hkv * D * 2};
  const cuuint32_t bk[3] = {64, 1, (cuuint32_t)L::kBK};
  int err = make_tensor_map_bf16(&tq, q, 3, dq, sq, bxq);
  if (!err) err = make_tensor_map_bf16(&tk, k, 3, dk, sk, bk);
  if (!err) err = make_tensor_map_bf16(&tv, v, 3, dk, sk, bk);
  if (err) return static_cast<cudaError_t>(err);
  // set on every launch: the attribute belongs to the current device, and a
  // host-side "done" flag would be neither per device nor thread-safe
  const cudaError_t e = cudaFuncSetAttribute(
      flash_prefill_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (e != cudaSuccess) return e;
  // softcap: x -> cap * tanh(x * scale / cap), then exp2 of (x - m) * log2 e;
  // without: exp2 of (x - m) * scale * log2 e
  const bool capped = softcap > 0.f;
  const float mult = capped ? kLog2e : scale * kLog2e;
  const float cap_in = capped ? scale / softcap : 0.f;
  const float cap_out = capped ? softcap : 0.f;
  const int n_qt = (P + bq - 1) / bq;
  flash_prefill_kernel<D><<<n_qt * Hkv, kThreads, L::kBytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), P, Hkv, G, valid_len, mult, cap_in, cap_out,
      window);
  return cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes. Any GQA group G = Hq / Hkv up to 128 (one
// query position per 128-row tile at most); D 64, 128 or 256. softcap <= 0
// and window <= 0 mean "off". Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int flash_prefill_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                            int P, int Hq, int Hkv, int D, int valid_len,
                                            float scale, float softcap, int window,
                                            void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kRows) return cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(q, k, v, out, P, Hkv, G, valid_len, scale, softcap, window, s);
    case 128: return launch<128>(q, k, v, out, P, Hkv, G, valid_len, scale, softcap, window, s);
    case 256: return launch<256>(q, k, v, out, P, Hkv, G, valid_len, scale, softcap, window, s);
    default: return cudaErrorInvalidValue;
  }
}
