// Per-tile bisection top-k, with and without error feedback, for Hopper
// (sm_90a).  topk_ef is the topk_fused wire of the training step.
//
// topk_ef replaces the Pallas TPU kernel
// src/repro/kernels/topk_mask.py:_ef_kernel (entry topk_ef_pallas);
// topk_mask replaces src/repro/kernels/topk_mask.py:_kernel (entry
// topk_mask_pallas).  Both share the bisection of _bisect_threshold: for a
// tile of values c (c = g + decay * e for topk_ef, c = x for topk_mask),
//
//     hi = max |c| (NaN propagates), lo = 0
//     `iters` times: mid = 0.5 * (lo + hi)
//                    cnt = #{ |c_i| >= mid } over the zero-padded tile
//                    cnt > k ? lo = mid : hi = mid
//     keep = |c| >= hi
//
// then topk_ef writes y = keep ? c : 0 and e_new = keep ? 0 : c, and
// topk_mask writes keep ? x : 0 in x's type.  k = max(1, int(tile * ratio))
// is computed by the caller as the reference does.
//
// Op order: only comparisons, the two roundings of c (explicit intrinsics)
// and mid = 0.5 * (lo + hi) (written as __fadd_rn then __fmul_rn), so the
// kernels are bit-equal to the plain PyTorch versions in
// src/repro_torch/kernels/ref.py.  A NaN in a tile makes hi NaN, every
// comparison false, and so nothing kept, as in the reference.
//
// What bounds them: memory.  topk_ef reads 8 bytes and writes 8 per element
// (16 B/elt); topk_mask reads and writes one element each.  The bisection
// makes `iters` passes over the tile, but over shared memory, not device
// memory: about 2 * iters operations per element.
//
// Design (simple and correct first): one thread block per tile, with
// min(round_up(tile, 32), 256) threads striding over it.  The tile's c lives
// in dynamic shared memory, so device memory is read once and written once;
// topk_ef's e_new may be e itself (the executor passes the EF state's
// buffer), since every e[i] is read before the block's first barrier and
// written after it, so those two pointers carry no __restrict__.
// Each round counts per thread, then across the block with warp shuffles
// and one shared pass (block_sum), so every thread holds the same lo and hi
// and the loop is uniform.  A ragged last tile masks i >= n and adds the
// padding's zeros to the count by hand (0 >= mid holds only when mid is 0),
// which gives exactly the reference's zero-padding result.  Indices are
// int64.

#include "tile_math.cuh"

namespace {

constexpr int64_t kMaxTile = 8192;        // 32 KB of f32 in shared memory

// The bisection threshold over this block's tile: `c_buf` holds the tile's
// first `valid` values (the rest of the tile is zero padding).  Called by
// every thread; returns the same hi to all.
__device__ float bisect_threshold(const float* c_buf, int tile, int valid,
                                  int k, int iters, float* fbuf, int* ibuf) {
  float m = 0.0f;
  for (int j = threadIdx.x; j < valid; j += blockDim.x)
    m = nan_max(m, fabsf(c_buf[j]));
  float hi = block_max(m, fbuf);
  float lo = 0.0f;
  const int pad = tile - valid;
  for (int it = 0; it < iters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    int c = 0;
    for (int j = threadIdx.x; j < valid; j += blockDim.x)
      c += fabsf(c_buf[j]) >= mid;
    const int cnt = block_sum(c, ibuf) + (0.0f >= mid ? pad : 0);
    if (cnt > k) lo = mid; else hi = mid;
  }
  return hi;
}

__global__ void __launch_bounds__(kMaxThreads)
topk_ef_kernel(const float* __restrict__ g, const float* e,
               float* __restrict__ y, float* e_new, int64_t n,
               int tile, int k, int iters, float decay) {
  extern __shared__ float c_buf[];
  __shared__ float fbuf[kMaxThreads / 32];
  __shared__ int ibuf[kMaxThreads / 32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  const int valid = static_cast<int>(n - base < tile ? n - base : tile);
  for (int j = threadIdx.x; j < valid; j += blockDim.x)
    c_buf[j] = __fadd_rn(g[base + j], __fmul_rn(decay, e[base + j]));
  __syncthreads();
  const float hi = bisect_threshold(c_buf, tile, valid, k, iters, fbuf, ibuf);
  for (int j = threadIdx.x; j < valid; j += blockDim.x) {
    const float c = c_buf[j];
    const bool keep = fabsf(c) >= hi;
    y[base + j] = keep ? c : 0.0f;
    e_new[base + j] = keep ? 0.0f : c;
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
topk_mask_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n,
                 int tile, int k, int iters) {
  extern __shared__ float c_buf[];
  __shared__ float fbuf[kMaxThreads / 32];
  __shared__ int ibuf[kMaxThreads / 32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  const int valid = static_cast<int>(n - base < tile ? n - base : tile);
  for (int j = threadIdx.x; j < valid; j += blockDim.x)
    c_buf[j] = to_f32(x[base + j]);
  __syncthreads();
  const float hi = bisect_threshold(c_buf, tile, valid, k, iters, fbuf, ibuf);
  for (int j = threadIdx.x; j < valid; j += blockDim.x) {
    const T v = x[base + j];
    y[base + j] = fabsf(c_buf[j]) >= hi ? v : T(0.0f);
  }
}

bool bad_args(int64_t n, int64_t tile, int64_t k, int64_t iters) {
  return n <= 0 || tile <= 0 || tile > kMaxTile || k < 1 || iters < 0 ||
         iters > 64 || (n + tile - 1) / tile > 0x7fffffff;
}

}  // namespace

// g, e, y, e_new: n f32 device pointers (e_new may equal e).  Launches on
// `stream` without synchronising; returns cudaGetLastError() (0 on success).
extern "C" int topk_ef_launch(const void* g, const void* e, void* y,
                              void* e_new, int64_t n, int64_t tile,
                              int64_t k, int64_t iters, float decay,
                              void* stream) {
  if (bad_args(n, tile, k, iters))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ntiles = (n + tile - 1) / tile;
  topk_ef_kernel<<<dim3(static_cast<unsigned>(ntiles)), tile_threads(tile),
                   static_cast<size_t>(tile) * sizeof(float),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(e),
      static_cast<float*>(y), static_cast<float*>(e_new), n,
      static_cast<int>(tile), static_cast<int>(k), static_cast<int>(iters),
      decay);
  return static_cast<int>(cudaGetLastError());
}

// x, y: n elements (f32, or bf16 when x_is_bf16) on the device.
extern "C" int topk_mask_launch(const void* x, void* y, int64_t n,
                                int64_t tile, int64_t k, int64_t iters,
                                int x_is_bf16, void* stream) {
  if (bad_args(n, tile, k, iters))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ntiles = (n + tile - 1) / tile;
  const dim3 grid(static_cast<unsigned>(ntiles));
  const size_t smem = static_cast<size_t>(tile) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    topk_mask_kernel<__nv_bfloat16><<<grid, tile_threads(tile), smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        n, static_cast<int>(tile), static_cast<int>(k),
        static_cast<int>(iters));
  } else {
    topk_mask_kernel<float><<<grid, tile_threads(tile), smem, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n,
        static_cast<int>(tile), static_cast<int>(k), static_cast<int>(iters));
  }
  return static_cast<int>(cudaGetLastError());
}
