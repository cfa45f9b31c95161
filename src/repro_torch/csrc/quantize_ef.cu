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
// quantize_ef: one thread block per tile, with min(round_up(tile, 32), 256)
// threads striding over it.  It keeps the tile's c in dynamic shared
// memory, so g and e are read once: pass 1 computes c and the block max
// (warp shuffles, then one shared pass), pass 2 writes q and e_new.  e_new
// may be e itself (the executor passes the EF state's buffer): each thread
// reads e[i] in pass 1 and writes e_new[i] in pass 2, so the two pointers
// carry no __restrict__.
//
// dequant_accum has two designs, chosen by the caller from the tile alone
// (kernels/dispatch.py:tile_route):
//
// * warp route, tiles of up to kWarpMaxTile (1024) elements (the wire's
//   tile): one warp per tile, kWarpsPerBlock tiles per block, no shared
//   memory and no block barrier.  Each lane keeps P = tile / 32 (rounded
//   up to a power of two) f32 sums in registers.  For each rank in order
//   the lane forms the factor s[r] / 127 in a register and reads its codes
//   as 4-byte words (P / 4 loads a lane a rank, all issued before their
//   first use; rank r+1's loads issued before rank r is added in); the
//   sums leave as float4 stores.  Word v = j * 32 + lane holds 4 codes, so
//   a warp's load covers 128 contiguous bytes and its store 512: with
//   16-byte code loads a lane would own 64 contiguous bytes of output and
//   each float4 store would write 16 bytes at a 64-byte stride (measured
//   slower, PERF.md).  A tile takes that vector path when it is whole, a
//   whole number of words, 4-byte aligned in every rank's row (so
//   n % 4 == 0 when w > 1) and its output 16-byte aligned, and P >= 4; any
//   other tile (the ragged last one, odd n, a misaligned view, tiles of up
//   to 64) takes scalar loads inside the same kernel.  Register arrays are
//   indexed only in fully unrolled loops.
// * block route, tiles of 1025 to kMaxTile elements: one thread block per
//   tile; the w factors are formed once in shared memory, then each thread
//   walks the ranks for its elements (neighbouring threads read
//   neighbouring bytes of each rank's payload).
//
// Both routes add in the reference's order: acc = q[0] * f[0], then
// acc = acc + q[r] * f[r] for r = 1 .. w-1.  A ragged last tile masks
// i >= n, which gives the reference's zero padding: zeros cannot raise a
// max of absolute values, and padded outputs are sliced away.  Indices are
// int64: one bucket at full width holds 6e8 elements.

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

// Code b (0 .. 3, little-endian) of a word of four int8 codes, as f32
// (exact).
__device__ __forceinline__ float code_of(uint32_t word, int b) {
  return static_cast<float>(
      static_cast<int8_t>(static_cast<uint8_t>(word >> (8 * b))));
}

// acc = q * f on the first rank, acc + q * f after it.
__device__ __forceinline__ float accumulate(float acc, float q, float f,
                                            bool first) {
  const float term = __fmul_rn(q, f);
  return first ? term : __fadd_rn(acc, term);
}

// One warp per tile (tile <= 32 * P).  Vector layout: code word number
// v = j * 32 + lane of a rank's tile (4 int8 codes) holds elements
// 4v .. 4v + 3 (lane values 4j .. 4j + 3), so one load instruction of the
// warp reads 128 contiguous bytes of codes and one float4 store writes 512
// contiguous bytes of sums; scalar layout: element j * 32 + lane (lane
// value j).
template <int P>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
dequant_accum_warp_kernel(const int8_t* __restrict__ q,
                          const float* __restrict__ scales,
                          float* __restrict__ out, int64_t n, int w,
                          int tile, int64_t ntiles) {
  constexpr int NV = P / 4;                 // code words a lane a rank
  const int64_t t = warp_tile_index();
  if (t >= ntiles) return;                  // the whole warp leaves
  const int lane = threadIdx.x & 31;
  const int64_t base = t * tile;
  const int valid = static_cast<int>(n - base < tile ? n - base : tile);
  q += base;
  out += base;
  scales += t;                              // rank r's scale: r * ntiles
  float acc[P];
#pragma unroll
  for (int j = 0; j < P; ++j) acc[j] = 0.0f;
  if constexpr (NV > 0) {
    const bool vec = valid == tile && tile % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(q) & 3u) == 0 &&
                     (w == 1 || n % 4 == 0) && aligned16(out);
    if (vec) {
      uint32_t cur[NV], nxt[NV];
      auto load_rank = [&](const int8_t* row, uint32_t (&dst)[NV]) {
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int i = 4 * (j * 32 + lane);
          dst[j] = i < tile ? *reinterpret_cast<const uint32_t*>(row + i)
                            : 0u;
        }
      };
      load_rank(q, cur);
      float s_cur = scales[0];
      for (int r = 0; r < w; ++r) {
        float s_nxt = 0.0f;
        if (r + 1 < w) {                    // the next rank's loads first
          load_rank(q + static_cast<int64_t>(r + 1) * n, nxt);
          s_nxt = scales[static_cast<int64_t>(r + 1) * ntiles];
        }
        const float f = __fdiv_rn(s_cur, 127.0f);
#pragma unroll
        for (int j = 0; j < NV; ++j) {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            acc[4 * j + b] = accumulate(acc[4 * j + b], code_of(cur[j], b),
                                        f, r == 0);
        }
#pragma unroll
        for (int j = 0; j < NV; ++j) cur[j] = nxt[j];
        s_cur = s_nxt;
      }
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int i = 4 * (j * 32 + lane);
        if (i < tile)
          *reinterpret_cast<float4*>(out + i) = make_float4(
              acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
      }
      return;
    }
  }
  for (int r = 0; r < w; ++r) {
    const int8_t* row = q + static_cast<int64_t>(r) * n;
    const float f =
        __fdiv_rn(scales[static_cast<int64_t>(r) * ntiles], 127.0f);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int i = j * 32 + lane;
      if (i < valid)
        acc[j] = accumulate(acc[j], static_cast<float>(row[i]), f, r == 0);
    }
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int i = j * 32 + lane;
    if (i < valid) out[i] = acc[j];
  }
}

__global__ void __launch_bounds__(kMaxThreads)
dequant_accum_block_kernel(const int8_t* __restrict__ q,
                           const float* __restrict__ scales,
                           float* __restrict__ out, int64_t n, int w,
                           int tile, int64_t ntiles) {
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

template <int P>
void dequant_accum_warp(const void* q, const void* scales, void* out,
                        int64_t n, int w, int tile, int64_t ntiles,
                        cudaStream_t s) {
  dequant_accum_warp_kernel<P><<<warp_route_blocks(ntiles),
                                 kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<float*>(out), n, w, tile, ntiles);
}

// dequant_accum on the warp route (tile <= kWarpMaxTile).  q: (w, n) int8
// row-major; scales: (w, ceil(n/tile)) f32; out: n f32; all device
// pointers.  Launches on `stream` without synchronising; returns
// cudaGetLastError() (0 on success).
extern "C" int dequant_accum_warp_launch(const void* q, const void* scales,
                                         void* out, int64_t n, int64_t w,
                                         int64_t tile, void* stream) {
  if (bad_grid(n, tile) || w <= 0 || w > kMaxRanks || tile > kWarpMaxTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ntiles = (n + tile - 1) / tile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ww = static_cast<int>(w), t = static_cast<int>(tile);
  switch (values_per_lane(tile)) {
    case 1: dequant_accum_warp<1>(q, scales, out, n, ww, t, ntiles, s); break;
    case 2: dequant_accum_warp<2>(q, scales, out, n, ww, t, ntiles, s); break;
    case 4: dequant_accum_warp<4>(q, scales, out, n, ww, t, ntiles, s); break;
    case 8: dequant_accum_warp<8>(q, scales, out, n, ww, t, ntiles, s); break;
    case 16: dequant_accum_warp<16>(q, scales, out, n, ww, t, ntiles, s);
      break;
    default: dequant_accum_warp<32>(q, scales, out, n, ww, t, ntiles, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// dequant_accum on the block route (kWarpMaxTile < tile <= kMaxTile); the
// same arguments as dequant_accum_warp_launch.
extern "C" int dequant_accum_block_launch(const void* q, const void* scales,
                                          void* out, int64_t n, int64_t w,
                                          int64_t tile, void* stream) {
  if (bad_grid(n, tile) || w <= 0 || w > kMaxRanks || tile <= kWarpMaxTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ntiles = (n + tile - 1) / tile;
  const size_t smem = static_cast<size_t>(w) * sizeof(float);
  dequant_accum_block_kernel<<<dim3(static_cast<unsigned>(ntiles)),
                               tile_threads(tile), smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<float*>(out), n, static_cast<int>(w),
      static_cast<int>(tile), ntiles);
  return static_cast<int>(cudaGetLastError());
}
