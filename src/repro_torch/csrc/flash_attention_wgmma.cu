// Forward attention with a streaming softmax for Hopper (sm_90a), tensor-core
// route: bf16 q, k, v at head dim 32, 64, 128, 192 or 256 -- every serving
// path (192: MLA's q/k head dim 128 + 64, v zero-padded to it by the caller).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:_kernel
// (entry flash_attention_pallas) and computes what the SIMT route
// (flash_attention.cu) computes, with the same mask, softcap, online softmax
// in f32, rounding of p to bf16 before the p.v product, l floored at 1e-30,
// tile skipping and NaN rule (flash_common.cuh); see the note there.
//
// What bounds it: operations.  4 * B * H * hd operations per unmasked
// (query, key) pair against q, k, v read once and out written once: at the
// gemma2-9b prefill (T = S = 6144, hd 256) ~1.2e3 operations per byte, far
// above the card's ~295.  So both products run on the tensor cores, and the
// loads hide behind them:
//
//   * S = Q.K^T and O += P.V are wgmma (m64, bf16 in, f32 accumulators).  Q
//     and K are read from shared memory (K-major); P stays in registers,
//     rounded to bf16, in the A-fragment layout that the S accumulator
//     already has; V is read from shared memory as an MN-major operand.
//     The bf16 products are exact in f32, as in the plain version.
//   * A block is one producer warpgroup and NC consumer warpgroups of 64
//     query rows each (NC = 2: 128 rows, K/V tiles shared by both; NC = 1
//     for short prompts, where 128-row tiles would leave most SMs idle; the
//     wrapper picks NC from the grid size).  One producer thread issues TMA
//     loads: the Q tile once, then 64-key tiles of K and V into a ring of 2
//     stages, each completing on an mbarrier; consumers release a stage's K
//     and its V on two more, so K arrives while the last V is still read.
//   * Each consumer issues tile j's Q.K^T together with tile j-1's P.V and
//     runs tile j's softmax while that P.V is on the tensor cores; the two
//     warpgroups interleave as well.
//   * Tiles sit in shared memory as panels of 64 head dims (128-byte rows;
//     32 dims and 64-byte rows at hd 32) with the TMA's 128-byte (64-byte)
//     swizzle, which the wgmma descriptors name.  At hd 256, NC = 2:
//     Q 64 KB + 2 x (K 32 KB + V 32 KB) = 192 KB.  At hd 192 (3 panels):
//     1024 + Q 48 KiB + 2 x (K 24 KiB + V 24 KiB) + 72 = 148,552 bytes at
//     NC = 2, 123,976 at NC = 1, under the 232,448 a block may use; P.V is
//     one m64n192k16 per 16 keys, its V operand spanning 3 panels as it
//     spans 4 at hd 256.
//   * setmaxnreg gives the consumers 240 registers (O alone is 128 f32 per
//     thread at hd 256, 96 at hd 192) and the producer 24.
//   * The tensor maps read q, k, v in the model's (B, T, H, hd) layout
//     through their strides as 4-d (hd, heads, positions, batch) maps: no
//     transposed copies.  Rows past T and keys past S are zero-filled by the
//     TMA; keys past S get -inf (weight 0).  The output goes back through
//     the Q tile's shared memory and a TMA store, which clips rows past T.
//   * Softmax in base 2: the scores are taken times log2 e (folded into the
//     scale), so p = 2^(s - m) is one subtraction and one MUFU ex2.  The
//     mask assigns -1e30 (NEG_INF) itself, so a row whose keys so far are
//     all masked has s = m = -1e30 and gets p = 1 exactly, as in the
//     reference.  The softcap's tanh is 1 - 2 / (2^(2y log2 e) + 1)
//     (ex2.approx and rcp.approx, absolute error ~1e-7; tanh.approx.f32's
//     2^-11 relative error would move p by several bf16 ulps at softcap
//     50).  Scale, softcap, mask, max and exp are each a branch-free loop
//     over a thread's 32 scores: a branch per score kept ptxas from
//     overlapping their MUFU latencies, which made the softmax take 4x
//     the time of both products.  Row maxima and sums reduce over the 4
//     lanes of a quad.
//   * Grid (query tiles, H, B), heaviest query tile first.  The kernel is a
//     programmatic dependent of the pre-pass (flash_attention.cu), which
//     runs beside it; it waits for the pre-pass only in its epilogue.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "flash_common.cuh"

namespace {

using flash::kKvBlk;
using flash::kNegInf;

constexpr int kStages = 2;                  // K/V ring depth

template <int HD, int NC>
struct Cfg {
  static constexpr int kPW = HD < 64 ? HD : 64;      // panel width, elements
  static constexpr int kSW = 2 * kPW;                // panel row = swizzle span
  static constexpr int kPanels = HD / kPW;
  static constexpr int kQRows = 64 * NC;
  static constexpr int kQBytes = kQRows * HD * 2;
  static constexpr int kTileBytes = kKvBlk * HD * 2;  // one K or V tile
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr uint64_t kLayout = kSW == 128 ? 1 : 2;  // 128B / 64B
  // 1024 for aligning the base to the swizzle atom, then the tiles and
  // 9 mbarriers
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kTileBytes + 8 * (1 + 4 * kStages);
  static_assert(HD % kPW == 0 && kSmem <= 232448,
                "head dim not whole panels, or too much shared memory");
};

struct Params {
  int T, S, H, KV, G;
  int causal, window;
  float softcap;                            // <= 0: none
  float scale2;                             // log2 e / sqrt(hd)
  float tanh_in;                            // 2 / (sqrt(hd) softcap) log2 e
  float cap2, cap2_neg2;                    // softcap log2 e, its -2 x
  int B, nt;                                // nt = ceil(S / kKvBlk)
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The TMA's swizzle of a byte offset inside a panel (its base aligned to
// the swizzle atom): the 16-byte chunk index, bits 4 and up, XOR the 128-byte
// row index, bits 7 and up, over as many bits as a panel row has chunks.
template <class C>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & (C::kSW / 16 - 1)) << 4);
}

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout (1: 128B, 2: 64B)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// K-major operand (rows x 16 head dims, k-step kk) of a tile of `rows`
// rows stored as panels: 8-row swizzle atoms 8 * kSW bytes apart; the
// k-step's 32 bytes are an offset inside the 128-byte (64-byte) row
template <class C>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows,
                                                int row0, int kk) {
  const int col = kk * 16;
  const uint32_t addr = tile + (col / C::kPW) * rows * C::kSW +
                        row0 * C::kSW + (col % C::kPW) * 2;
  return make_desc(addr, 16, 8 * C::kSW, C::kLayout);
}

// MN-major V operand (16 keys x HD, k-step kk): 8-key groups 8 * kSW bytes
// apart, panels of kPW head dims kKvBlk * kSW bytes apart
template <class C>
__device__ __forceinline__ uint64_t v_desc(uint32_t tile, int kk) {
  return make_desc(tile + kk * 16 * C::kSW, kKvBlk * C::kSW, 8 * C::kSW,
                   C::kLayout);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Registers that an in-flight wgmma reads or writes (accumulators, A
// fragments): pinned after the wait, so the compiler neither reads the
// accumulators early nor reuses the fragments' registers before it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (+)= A.B^T, A (64 x 16) and B (n64 x 16) K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A.B, A (64 x 16) bf16 in registers, B (16 x n32) MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d += A.B, A (64 x 16) bf16 in registers, B (16 x n64) MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d += A.B, A (64 x 16) bf16 in registers, B (16 x n128) MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d += A.B, A (64 x 16) bf16 in registers, B (16 x n192) MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d += A.B, A (64 x 16) bf16 in registers, B (16 x n256) MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// o += P.V for the 16 keys of k-step kk: p's fragment is a[4 kk .. 4 kk + 3]
template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const uint32_t (&a)[16], int kk,
                                         uint64_t db) {
  const uint32_t a0 = a[4 * kk], a1 = a[4 * kk + 1], a2 = a[4 * kk + 2],
                 a3 = a[4 * kk + 3];
  static_assert(HD == 32 || HD == 64 || HD == 128 || HD == 192 || HD == 256,
                "no P.V wgmma at this head dim");
  if constexpr (HD == 32) wgmma_rs_n32(o, a0, a1, a2, a3, db);
  else if constexpr (HD == 64) wgmma_rs_n64(o, a0, a1, a2, a3, db);
  else if constexpr (HD == 128) wgmma_rs_n128(o, a0, a1, a2, a3, db);
  else if constexpr (HD == 192) wgmma_rs_n192(o, a0, a1, a2, a3, db);
  else wgmma_rs_n256(o, a0, a1, a2, a3, db);
}

// 2^x and 1/x on the MUFU, flushing subnormals to 0: p below 2^-126 adds
// nothing next to l >= 1, and 1 / (e^(2y) + 1) never sees one
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// does a 64-key tile from k0 hold a key that is masked, or past S, for some
// query row in [qlo, qhi]?
__device__ __forceinline__ bool tile_needs_mask(int k0, int qlo, int qhi,
                                                const Params& p) {
  const int khi = k0 + kKvBlk - 1;
  if (khi >= p.S) return true;
  if (p.causal && khi > qlo) return true;
  if (p.window > 0) {
    if (qhi - k0 >= p.window) return true;
    if (!p.causal && khi - qlo >= p.window) return true;
  }
  return false;
}

// the query rows a consumer thread holds, and its warpgroup's row range
struct Rows {
  int qpos[2];          // rows r0 and r0 + 8
  int lo, hi;           // the warpgroup's 64 rows
  int quad;             // lane % 4: the thread's key columns 2 quad + {0, 1}
};

// S = Q.K^T for one 64-key tile (issued and committed, not waited)
template <class C>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t sQ,
                                         uint32_t sK, int wg) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C::kPanels * C::kPW / 16; ++kk)
    wgmma_ss_n64(s, kmajor_desc<C>(sQ, C::kQRows, wg * 64, kk),
                 kmajor_desc<C>(sK, kKvBlk, 0, kk), kk > 0);
  wgmma_commit();
}

// The descriptors of O += P.V for one 64-key tile, made before any wgmma
// of the step is issued (see issue_pv)
template <class C>
__device__ __forceinline__ void pv_descs(uint64_t (&dv)[kKvBlk / 16],
                                         uint32_t sV) {
#pragma unroll
  for (int kk = 0; kk < kKvBlk / 16; ++kk) {
    dv[kk] = v_desc<C>(sV, kk);
    asm volatile("" : "+l"(dv[kk]));
  }
}

// O += P.V for one 64-key tile (issued and committed, not waited), its
// descriptors dv made by pv_descs before the step's first wgmma.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&a)[16],
                                         const uint64_t (&dv)[kKvBlk / 16]) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKvBlk / 16; ++kk) wgmma_pv<HD>(o, a, kk, dv[kk]);
  wgmma_commit();
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The online softmax of one tile of scores s[4 j + 2 r + e] (row r of the
// thread's two, key k0 + 8 j + 2 quad + e), in base 2: the scores times
// log2 e (scaled, softcapped), masked, the new row maxima m (reduced over
// the quad), corr = 2^(m_old - m), l = l corr + the thread's sum of p, and
// p = 2^(s - m) itself, in f32, in place of s.  Each step is a branch-free
// loop over the 32 scores, so their MUFU latencies overlap.
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int k0, const Rows& rows,
                                             const Params& p) {
  if (p.softcap > 0.0f) {
    // softcap tanh(x / softcap) log2 e, tanh(y) = 1 - 2 / (e^(2y) + 1)
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = fmaf(p.cap2_neg2, rcp(ex2(s[i] * p.tanh_in) + 1.0f), p.cap2);
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= p.scale2;
  }
  if (tile_needs_mask(k0, rows.lo, rows.hi, p)) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = k0 + 8 * (i >> 2) + 2 * rows.quad + (i & 1);
      const bool ok = flash::allowed(rows.qpos[(i >> 1) & 1], key, p.causal,
                                     p.window);
      // past the keys: -inf, weight 0; masked: NEG_INF
      s[i] = key >= p.S ? -INFINITY : (ok ? s[i] : kNegInf);
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = ex2(m[r] - mx[r]);
    m[r] = mx[r];
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = ex2(s[i] - m[(i >> 1) & 1]);
    sum[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
}

// p rounded to bf16 into the A fragments of the four 16-key steps:
// a[4 kk + 2 jj + r] holds keys 16 kk + 8 jj + 2 quad + {0, 1} of row r,
// which is p[4 j + 2 r + {0, 1}] with j = 2 kk + jj
__device__ __forceinline__ void pack_p(const float (&p)[32],
                                       uint32_t (&a)[16]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      a[2 * j + r] = pack_bf16(p[4 * j + 2 * r], p[4 * j + 2 * r + 1]);
}

template <int HD, int NC>
__global__ void __launch_bounds__(Cfg<HD, NC>::kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_o,
                   const int* __restrict__ tiles, const Params p) {
  using C = Cfg<HD, NC>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + C::kQBytes;               // kStages tiles
  const uint32_t sV = sK + kStages * C::kTileBytes;  // kStages tiles
  const uint32_t q_full = sV + kStages * C::kTileBytes;
  const uint32_t k_full = q_full + 8;                // [stage] at + 8 * stage
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty_k = v_full + 8 * kStages;     // K of a stage read
  const uint32_t empty_v = empty_k + 8 * kStages;    // V of a stage read

  const int qt = gridDim.x - 1 - blockIdx.x;        // heaviest tile first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.G;
  const int q0 = qt * C::kQRows;
  const int qlast = min(q0 + C::kQRows, p.T) - 1;
  int kt_lo, kt_hi;
  flash::visited_tiles(q0, qlast, p.S, p.causal, p.window, &kt_lo, &kt_hi);
  const int n_tiles = kt_hi - kt_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty_k + 8 * s, NC * 128);
      mbar_init(empty_v + 8 * s, NC * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every load
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      prefetch_map(&tm_o);
      mbar_expect_tx(q_full, C::kQBytes);
      for (int pn = 0; pn < C::kPanels; ++pn)
        tma_load_4d(sQ + pn * C::kQRows * C::kSW, &tm_q, q_full, pn * C::kPW,
                    h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        const uint32_t released = ((it / kStages) - 1) & 1;
        const int k0 = (kt_lo + it) * kKvBlk;
        const uint32_t dk = sK + st * C::kTileBytes;
        const uint32_t dv = sV + st * C::kTileBytes;
        // each stage's K and V are refilled once the consumers have read
        // them (their Q.K^T, their P.V)
        if (it >= kStages) mbar_wait(empty_k + 8 * st, released);
        mbar_expect_tx(k_full + 8 * st, C::kTileBytes);
        for (int pn = 0; pn < C::kPanels; ++pn)
          tma_load_4d(dk + pn * kKvBlk * C::kSW, &tm_k, k_full + 8 * st,
                      pn * C::kPW, kvh, k0, b);
        if (it >= kStages) mbar_wait(empty_v + 8 * st, released);
        mbar_expect_tx(v_full + 8 * st, C::kTileBytes);
        for (int pn = 0; pn < C::kPanels; ++pn)
          tma_load_4d(dv + pn * kKvBlk * C::kSW, &tm_v, v_full + 8 * st,
                      pn * C::kPW, kvh, k0, b);
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64 wg .. + 63; this thread holds
  // rows r0 and r0 + 8, columns 8 j + 2 quad + {0, 1} of each accumulator
  if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wg = threadIdx.x / 128 - 1;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int quad = lane & 3;
  const int r0 = wg * 64 + warp * 16 + (lane >> 2);
  const Rows rows{{q0 + r0, q0 + r0 + 8}, q0 + wg * 64, q0 + wg * 64 + 63,
                  quad};

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  uint32_t a[16];       // p of the tile whose P.V is next or in flight
  float corr[2];

  // Tile it's Q.K^T is issued with tile it-1's P.V, and the softmax of
  // tile it runs while that P.V is on the tensor cores.  Registers that a
  // wgmma reads (a, o, the descriptors) are written only while no wgmma is
  // in flight: ptxas serializes every wgmma of the kernel otherwise.
  mbar_wait(q_full, 0);
  {
    float s[32];
    mbar_wait(k_full, 0);
    issue_qk<C>(s, sQ, sK, wg);
    wgmma_wait<0>();
    pin(s);
    mbar_arrive(empty_k);
    softmax_tile(s, m, l, corr, kt_lo * kKvBlk, rows, p);   // o is 0
    pack_p(s, a);
  }
  for (int it = 1; it < n_tiles; ++it) {
    const int st = it % kStages, prev = (it - 1) % kStages;
    float s[32];
    uint64_t dv[kKvBlk / 16];
    mbar_wait(k_full + 8 * st, (it / kStages) & 1);
    mbar_wait(v_full + 8 * prev, ((it - 1) / kStages) & 1);
    pv_descs<C>(dv, sV + prev * C::kTileBytes);
    issue_qk<C>(s, sQ, sK + st * C::kTileBytes, wg);
    issue_pv<HD>(o, a, dv);
    wgmma_wait<1>();                    // Q.K^T of tile it is done
    pin(s);
    mbar_arrive(empty_k + 8 * st);
    softmax_tile(s, m, l, corr, (kt_lo + it) * kKvBlk, rows, p);
    wgmma_wait<0>();                    // P.V of tile it-1 is done
    pin(o);
    pin(a);
    mbar_arrive(empty_v + 8 * prev);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    pack_p(s, a);
  }
  {
    const int last = (n_tiles - 1) % kStages;
    uint64_t dv[kKvBlk / 16];
    mbar_wait(v_full + 8 * last, ((n_tiles - 1) / kStages) & 1);
    pv_descs<C>(dv, sV + last * C::kTileBytes);
    issue_pv<HD>(o, a, dv);
    wgmma_wait<0>();
    pin(o);
    pin(a);
  }
  const int qpos[2] = {rows.qpos[0], rows.qpos[1]};

  // epilogue: l summed over the quad (each lane summed its own keys), the
  // NaN rule for non-finite v in skipped tiles; the warpgroup's 64 rows in
  // bf16 into its own rows of the Q tile (read by no wgmma any more), in
  // the same swizzled panels, then out by one TMA store per panel (rows
  // past T are clipped by the TMA)
  uint32_t bad[HD / 32];   // word j / 4 holds the dims 8 j + 2 quad + e
  flash::skipped_nonfinite<HD / 32>(tiles, p.nt, p.B * p.KV, b * p.KV + kvh,
                                    HD / 32, kt_lo, kt_hi, bad);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
    const uint32_t row = r0 + 8 * r;          // in the block's Q tile
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int d = 8 * j + 2 * quad;
      const uint32_t nan2 = bad[j / 4] >> (d & 31);
      float x0 = o[4 * j + 2 * r] * inv, x1 = o[4 * j + 2 * r + 1] * inv;
      if (nan2 & 1u) x0 = NAN;
      if (nan2 & 2u) x1 = NAN;
      const uint32_t dst = sQ + (d / C::kPW) * C::kQRows * C::kSW +
                           swizzle<C>(row * C::kSW + (d % C::kPW) * 2);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst),
                   "r"(pack_bf16(x0, x1))
                   : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  if (threadIdx.x % 128 == 0) {
    for (int pn = 0; pn < C::kPanels; ++pn)
      tma_store_4d(&tm_o,
                   sQ + pn * C::kQRows * C::kSW + wg * 64 * C::kSW,
                   pn * C::kPW, h, q0 + wg * 64, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    // the block's shared memory must outlive the stores' reads
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-d map (hd, heads, positions, batch) over a bf16 tensor with element
// strides (s_h, s_t, s_b), boxes of `box_w` head dims x `box_rows`
// positions of one head and batch row.
bool make_map(CUtensorMap* map, const void* ptr, int64_t hd, int64_t heads,
              int64_t len, int64_t batch, int64_t s_h, int64_t s_t,
              int64_t s_b, int box_w, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_h) * 2,
                                 static_cast<cuuint64_t>(s_t) * 2,
                                 static_cast<cuuint64_t>(s_b) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_w), 1,
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_w == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

struct Args {
  const void *q, *k, *v;
  void* out;
  const int* tiles;
  int64_t B, T, S, H, KV;
  int64_t q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
};

template <int HD, int NC>
int launch(const Args& a, const Params& p, cudaStream_t stream) {
  using C = Cfg<HD, NC>;
  CUtensorMap mq, mk, mv, mo;
  if (!make_map(&mq, a.q, HD, a.H, a.T, a.B, a.q_sh, a.q_st, a.q_sb, C::kPW,
                C::kQRows) ||
      !make_map(&mo, a.out, HD, a.H, a.T, a.B, HD, a.H * HD, a.T * a.H * HD,
                C::kPW, 64) ||
      !make_map(&mk, a.k, HD, a.KV, a.S, a.B, a.k_sh, a.k_st, a.k_sb, C::kPW,
                kKvBlk) ||
      !make_map(&mv, a.v, HD, a.KV, a.S, a.B, a.v_sh, a.v_st, a.v_sb, C::kPW,
                kKvBlk))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_wgmma_kernel<HD, NC>;
  // opt into more than 48 KB of shared memory once per device (so a launch
  // inside a CUDA graph capture makes no further attribute call)
  static uint64_t configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if (!(configured & bit)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured |= bit;
  }
  const dim3 grid(static_cast<unsigned>((a.T + C::kQRows - 1) / C::kQRows),
                  static_cast<unsigned>(a.H), static_cast<unsigned>(a.B));
  // a programmatic dependent of the pre-pass: it may start while the
  // pre-pass runs, and waits for it only in its epilogue
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, mq, mk, mv, mo, a.tiles, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_nc(const Args& a, const Params& p, int nc, cudaStream_t s) {
  return nc == 2 ? launch<HD, 2>(a, p, s) : launch<HD, 1>(a, p, s);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// q (B, T, H, hd), k and v (B, S, KV, hd): bf16 device pointers with the
// given element strides (last dim contiguous, 16-byte aligned bases, every
// other stride a multiple of 8 elements: what the TMA takes); hd 32, 64,
// 128, 192 or 256 (any other is refused); out: contiguous bf16 (B, T, H,
// hd); tiles: the pre-pass's output for this v (flash_attention.cu),
// launched just before on the same stream;
// nc: consumer warpgroups per block (1 or 2).  window <= 0 means none, softcap <= 0 means none.  Launches on
// `stream` without synchronising; returns the CUDA error of the attribute
// call or the launch (0 on success), cudaErrorInvalidValue for arguments
// the kernel does not take or a tensor map that cuTensorMapEncodeTiled
// refuses.
extern "C" int flash_wgmma_launch(
    const void* q, const void* k, const void* v, void* out, const void* tiles,
    int64_t B, int64_t T, int64_t S, int64_t H, int64_t KV, int64_t hd,
    int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb, int64_t k_st,
    int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh, int causal,
    int64_t window, double softcap, int nc, void* stream) {
  const int64_t kMax = int64_t{1} << 30;
  bool ok = B >= 1 && B <= 65535 && T >= 1 && T < kMax && S >= 1 &&
            S < kMax && KV >= 1 && H >= KV && H <= 65535 && H % KV == 0 &&
            (hd == 32 || hd == 64 || hd == 128 || hd == 192 || hd == 256) &&
            window < kMax && (S / kKvBlk + 1) * B * KV * 9 < kMax &&
            (nc == 1 || nc == 2) &&
            aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out);
  for (int64_t st : {q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh})
    ok = ok && st > 0 && st % 8 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.T = static_cast<int>(T);
  p.S = static_cast<int>(S);
  p.H = static_cast<int>(H);
  p.KV = static_cast<int>(KV);
  p.G = static_cast<int>(H / KV);
  p.causal = causal != 0;
  p.window = window > 0 ? static_cast<int>(window) : 0;
  const double log2e = 1.4426950408889634, scale = 1.0 / sqrt(double(hd));
  p.softcap = softcap > 0.0 ? static_cast<float>(softcap) : 0.0f;
  p.scale2 = static_cast<float>(scale * log2e);
  p.tanh_in = softcap > 0.0 ? static_cast<float>(2.0 * scale / softcap * log2e)
                            : 0.0f;
  p.cap2 = static_cast<float>(softcap * log2e);
  p.cap2_neg2 = -2.0f * p.cap2;
  p.B = static_cast<int>(B);
  p.nt = static_cast<int>((S + kKvBlk - 1) / kKvBlk);
  const Args a{q,    k,    v,    out,  static_cast<const int*>(tiles),
               B,    T,    S,    H,    KV,
               q_sb, q_st, q_sh, k_sb, k_st,
               k_sh, v_sb, v_st, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_nc<32>(a, p, nc, s);
    case 64: return launch_nc<64>(a, p, nc, s);
    case 128: return launch_nc<128>(a, p, nc, s);
    case 192: return launch_nc<192>(a, p, nc, s);
    case 256: return launch_nc<256>(a, p, nc, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
