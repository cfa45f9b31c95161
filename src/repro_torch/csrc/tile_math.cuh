// Per-element, warp-wide and block-wide helpers shared by the port's tile
// kernels (quantize_tiles.cu, quantize_ef.cu, topk_mask.cu).
//
// Every operation that rounds is written as an explicit IEEE intrinsic
// (__fdiv_rn, __fmul_rn, __fadd_rn, __fsub_rn), so nvcc can neither fuse a
// multiply and an add into one FMA nor turn a division into a reciprocal
// multiply: each kernel then rounds exactly where the reference
// (src/repro/kernels/ref.py) does, and is bit-equal to its plain PyTorch
// version.  Build without --use_fast_math.
//
// Max rule: nan_max propagates a NaN the way jnp.max does (fmaxf would drop
// it), so a tile that holds a NaN gets a NaN scale or threshold.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxThreads = 256;

static __device__ __forceinline__ float to_f32(float v) { return v; }
static __device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// max(a, b) that returns NaN when either operand is NaN.
static __device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

// jnp.clip(round_half_even((v / s) * 127), -127, 127) in f32; a NaN stays NaN.
static __device__ __forceinline__ float quantize_float(float v, float s) {
  float q = rintf(__fmul_rn(__fdiv_rn(v, s), 127.0f));
  return q < -127.0f ? -127.0f : (q > 127.0f ? 127.0f : q);
}

// The int8 store of a quantized value: NaN becomes 0, as XLA converts it.
static __device__ __forceinline__ int8_t to_int8(float q) {
  return isnan(q) ? int8_t{0} : static_cast<int8_t>(q);
}

static __device__ __forceinline__ int8_t quantize_one(float v, float s) {
  return to_int8(quantize_float(v, s));
}

// Block-wide NaN-propagating max of non-negative values.  Every thread of
// the block must call it (blockDim.x a multiple of 32, at most kMaxThreads);
// every thread gets the result.  `buf` holds kMaxThreads / 32 floats of
// shared memory and may be reused after the call returns.
static __device__ __forceinline__ float block_max(float m, float* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) buf[warp] = m;
  __syncthreads();
  m = lane < nwarps ? buf[lane] : 0.0f;
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  __syncthreads();
  return m;
}

// Block-wide integer sum, with the same calling rules as block_max.
static __device__ __forceinline__ int block_sum(int c, int* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    c += __shfl_xor_sync(0xffffffffu, c, off);
  if (lane == 0) buf[warp] = c;
  __syncthreads();
  c = lane < nwarps ? buf[lane] : 0;
  for (int off = 16; off > 0; off >>= 1)
    c += __shfl_xor_sync(0xffffffffu, c, off);
  __syncthreads();
  return c;
}

// Threads for one block per tile: the tile rounded up to whole warps, at
// most kMaxThreads, so no partial warp joins a full-mask shuffle.
static inline int tile_threads(int64_t tile) {
  const int64_t rounded = (tile + 31) / 32 * 32;
  return static_cast<int>(rounded < kMaxThreads ? rounded : kMaxThreads);
}

// ---------------------------------------------------------------------------
// The warp route: one warp per tile of up to kWarpMaxTile elements, the tile
// held in registers (P values a lane), kWarpsPerBlock tiles per block, no
// shared memory and no block barrier.
// ---------------------------------------------------------------------------

constexpr int kWarpMaxTile = 1024;
constexpr int kWarpsPerBlock = 8;

// Values a lane holds for a tile of `tile` (1 .. kWarpMaxTile) elements:
// tile / 32 rounded up to 1, 2, 4, 8, 16 or 32.
static inline int values_per_lane(int64_t tile) {
  int p = 1;
  while (32 * p < tile) p *= 2;
  return p;
}

// Blocks of kWarpsPerBlock warps for one warp per tile.
static inline unsigned warp_route_blocks(int64_t ntiles) {
  return static_cast<unsigned>((ntiles + kWarpsPerBlock - 1) /
                               kWarpsPerBlock);
}

// This warp's tile (the same for all its lanes).
static __device__ __forceinline__ int64_t warp_tile_index() {
  return static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
         (threadIdx.x >> 5);
}

// Warp-wide NaN-propagating max of non-negative values; every lane gets it.
static __device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

static __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The f32 values of one 16-byte vector of T (4 f32 or 8 bf16; bf16 -> f32
// is exact: the bf16 bits are the high half of the f32).
template <typename T>
static __device__ __forceinline__ void unpack16(const uint4& r,
                                                float (&v)[16 / sizeof(T)]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = __uint_as_float(w[u]);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      v[2 * u] = __uint_as_float(w[u] << 16);
      v[2 * u + 1] = __uint_as_float(w[u] & 0xffff0000u);
    }
  }
}
