// Per-tile symmetric int8 quantization for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/quantize_ef.py:_q_kernel
// (entry point quantize_pallas).  For every tile of `tile` consecutive
// elements of the flat input x:
//
//     s = max(max_i |x_i|, 1e-30)
//     q = clip(round_half_even((x / s) * 127), -127, 127)   as int8
//
// and s is stored as the tile's f32 scale.  The op order is the reference's
// (src/repro/kernels/ref.py:quantize_tiles_ref): an IEEE division, then an
// IEEE multiplication by 127, then round-half-to-even, so the kernel is
// bit-equal to the plain PyTorch version.  Build without --use_fast_math.
//
// What bounds it: memory.  It reads n*4 (f32) or n*2 (bf16) bytes and writes
// n + 4*ceil(n/tile) bytes, with a handful of operations per element.  At
// the serving decode shape (one 256-element tile per cached token, ~18k
// elements per write) it is bound by launch latency instead.
//
// Design (simple and correct first): one thread block per tile, with
// min(round_up(tile, 32), 256) threads striding over the tile.  Pass 1 takes
// max|x| per thread, then across the warp with __shfl_xor_sync, then across
// warps in shared memory.  Pass 2 re-reads the tile (from L1/L2) and writes q.
// A ragged last tile masks i >= n, which gives the reference's zero-padding
// result: zeros cannot raise a max of absolute values.
//
// NaN: the max propagates a NaN as jnp.max does (nan_max in tile_math.cuh,
// not fmaxf, which drops it), so a tile holding a NaN gets a NaN scale; its
// q entries are then NaN before the int8 store, which writes 0 for them as
// XLA's float-to-int8 conversion does.

#include "tile_math.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
quantize_tiles_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                      float* __restrict__ scales, int64_t n, int tile) {
  __shared__ float warp_max[kMaxThreads / 32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;

  float m = 0.0f;
  for (int j = threadIdx.x; j < tile; j += blockDim.x) {
    const int64_t i = base + j;
    if (i < n) m = nan_max(m, fabsf(to_f32(x[i])));
  }
  const float s = nan_max(block_max(m, warp_max), 1e-30f);

  for (int j = threadIdx.x; j < tile; j += blockDim.x) {
    const int64_t i = base + j;
    if (i < n) q[i] = quantize_one(to_f32(x[i]), s);
  }
  if (threadIdx.x == 0) scales[blockIdx.x] = s;
}

}  // namespace

// x: n elements (f32, or bf16 when x_is_bf16), q: n int8, scales:
// ceil(n/tile) f32, all device pointers.  Launches on `stream` without
// synchronising; returns cudaGetLastError() (0 on success).
extern "C" int quantize_tiles_launch(const void* x, void* q, void* scales,
                                     int64_t n, int64_t tile, int x_is_bf16,
                                     void* stream) {
  if (n <= 0 || tile <= 0 || tile > (int64_t{1} << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ntiles = (n + tile - 1) / tile;
  if (ntiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = tile_threads(tile);
  const dim3 grid(static_cast<unsigned>(ntiles));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    quantize_tiles_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scales), n, static_cast<int>(tile));
  } else {
    quantize_tiles_kernel<float><<<grid, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scales), n, static_cast<int>(tile));
  }
  return static_cast<int>(cudaGetLastError());
}
