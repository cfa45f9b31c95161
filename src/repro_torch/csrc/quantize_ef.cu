// Fused error feedback + per-tile int8 quantization, and its decode, for
// Hopper (sm_90a).  The int8_fused wire of the training step.
//
// quantize_ef replaces the Pallas TPU kernel
// src/repro/kernels/quantize_ef.py:_kernel (entry quantize_ef_pallas).  For
// every tile of `tile` consecutive elements of the f32 bucket g and its EF
// residual e:
//
//     c     = g + decay * e                       (two roundings)
//     s     = max(max_i |c_i|, 1e-30)             (NaN propagates)
//     q     = clip(round_half_even((c / s) * 127), -127, 127)
//     e_new = c - q * (s / 127)                   (s / 127 once per tile)
//
// and stores q as int8, e_new as f32 and s as the tile's scale.
//
// dequant_accum replaces src/repro/kernels/quantize_ef.py:_accum_kernel
// (entry dequant_accum_pallas): out = sum over ranks r = 0 .. w-1, in that
// order, of q[r] * (s[r] / 127), the decode of the all-gathered payloads.
//
// Op order: every rounding is an explicit intrinsic (tile_math.cuh), so
// both kernels are bit-equal to the plain PyTorch versions in
// src/repro_torch/kernels/ref.py.
//
// What bounds them: memory.  quantize_ef reads 8 bytes and writes 5 per
// element (13 B/elt, plus 4 B per tile); dequant_accum reads w bytes and
// writes 4 per element.  Both do a few operations per byte, far below the
// card's ratio of operations to bandwidth.
//
// Design (simple and correct first): one thread block per tile, with
// min(round_up(tile, 32), 256) threads striding over it.  quantize_ef keeps
// the tile's c in dynamic shared memory, so g and e are read once: pass 1
// computes c and the block max (warp shuffles, then one shared pass), pass 2
// writes q and e_new.  dequant_accum forms the w per-tile factors s[r] / 127
// once in shared memory, then each thread walks the ranks for its elements
// (neighbouring threads read neighbouring bytes of each rank's payload).
// e_new may be e itself (the executor passes the EF state's buffer): each
// thread reads e[i] in pass 1 and writes e_new[i] in pass 2, so the two
// pointers carry no __restrict__.  A ragged last tile masks i >= n, which
// gives the reference's zero padding: zeros cannot raise a max of absolute
// values, and padded outputs are sliced away.  Indices are int64: one
// bucket at full width holds 6e8 elements.

#include "tile_math.cuh"

namespace {

constexpr int64_t kMaxTile = 8192;        // 32 KB of f32 in shared memory
constexpr int kMaxRanks = 1024;

__global__ void __launch_bounds__(kMaxThreads)
quantize_ef_kernel(const float* __restrict__ g, const float* e,
                   int8_t* __restrict__ q, float* e_new,
                   float* __restrict__ scales, int64_t n, int tile,
                   float decay) {
  extern __shared__ float c_buf[];
  __shared__ float warp_max[kMaxThreads / 32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;

  float m = 0.0f;
  for (int j = threadIdx.x; j < tile; j += blockDim.x) {
    const int64_t i = base + j;
    if (i < n) {
      const float c = __fadd_rn(g[i], __fmul_rn(decay, e[i]));
      c_buf[j] = c;
      m = nan_max(m, fabsf(c));
    }
  }
  const float s = nan_max(block_max(m, warp_max), 1e-30f);
  const float d = __fdiv_rn(s, 127.0f);

  // each thread reads back only the entries it wrote
  for (int j = threadIdx.x; j < tile; j += blockDim.x) {
    const int64_t i = base + j;
    if (i < n) {
      const float c = c_buf[j];
      const float qf = quantize_float(c, s);
      q[i] = to_int8(qf);
      e_new[i] = __fsub_rn(c, __fmul_rn(qf, d));
    }
  }
  if (threadIdx.x == 0) scales[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kMaxThreads)
dequant_accum_kernel(const int8_t* __restrict__ q,
                     const float* __restrict__ scales,
                     float* __restrict__ out, int64_t n, int w, int tile,
                     int64_t ntiles) {
  extern __shared__ float factor[];          // w entries: s[r] / 127
  for (int r = threadIdx.x; r < w; r += blockDim.x)
    factor[r] = __fdiv_rn(scales[static_cast<int64_t>(r) * ntiles +
                                 blockIdx.x], 127.0f);
  __syncthreads();
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  for (int j = threadIdx.x; j < tile; j += blockDim.x) {
    const int64_t i = base + j;
    if (i < n) {
      float acc = __fmul_rn(static_cast<float>(q[i]), factor[0]);
      for (int r = 1; r < w; ++r)
        acc = __fadd_rn(acc, __fmul_rn(
            static_cast<float>(q[static_cast<int64_t>(r) * n + i]),
            factor[r]));
      out[i] = acc;
    }
  }
}

bool bad_grid(int64_t n, int64_t tile) {
  return n <= 0 || tile <= 0 || tile > kMaxTile ||
         (n + tile - 1) / tile > 0x7fffffff;
}

}  // namespace

// g, e, e_new: n f32 (e_new may equal e); q: n int8; scales: ceil(n/tile)
// f32; all device pointers.  Launches on `stream` without synchronising; returns
// cudaGetLastError() (0 on success).
extern "C" int quantize_ef_launch(const void* g, const void* e, void* q,
                                  void* e_new, void* scales, int64_t n,
                                  int64_t tile, float decay, void* stream) {
  if (bad_grid(n, tile)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ntiles = (n + tile - 1) / tile;
  const size_t smem = static_cast<size_t>(tile) * sizeof(float);
  quantize_ef_kernel<<<dim3(static_cast<unsigned>(ntiles)),
                       tile_threads(tile), smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(e),
      static_cast<int8_t*>(q), static_cast<float*>(e_new),
      static_cast<float*>(scales), n, static_cast<int>(tile), decay);
  return static_cast<int>(cudaGetLastError());
}

// q: (w, n) int8 row-major; scales: (w, ceil(n/tile)) f32; out: n f32.
extern "C" int dequant_accum_launch(const void* q, const void* scales,
                                    void* out, int64_t n, int64_t w,
                                    int64_t tile, void* stream) {
  if (bad_grid(n, tile) || w <= 0 || w > kMaxRanks)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ntiles = (n + tile - 1) / tile;
  const size_t smem = static_cast<size_t>(w) * sizeof(float);
  dequant_accum_kernel<<<dim3(static_cast<unsigned>(ntiles)),
                         tile_threads(tile), smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<float*>(out), n, static_cast<int>(w),
      static_cast<int>(tile), ntiles);
  return static_cast<int>(cudaGetLastError());
}
