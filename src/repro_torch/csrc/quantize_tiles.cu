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
// Two designs, chosen by the caller from the tile alone
// (kernels/dispatch.py:tile_route):
//
// * warp route, tiles of up to kWarpMaxTile (1024) elements (every serving
//   write: the tile is head_dim): one warp per tile, kWarpsPerBlock tiles
//   per block, no shared memory and no block barrier.  Each lane holds
//   P = tile / 32 values (rounded up to a power of two) in registers.  A
//   tile whose first element is 16-byte aligned (and its first code aligned
//   to the codes of one vector), that is a whole number of 16-byte vectors
//   and is not the ragged last tile, is read with one 16-byte load per
//   vector (8 bf16 or 4 f32) and its codes written with one 8- or 4-byte
//   store per vector; any other tile takes scalar loads and stores inside
//   the same kernel.  max|x| runs over the lane's values, then over the
//   warp in 5 shuffles; the values are quantized from registers (x is read
//   once), and lane 0 writes the scale.
// * block route, tiles of 1025 to 2^30 elements (no serving path uses
//   one): one thread block per tile, with 256 threads striding over the
//   tile.  Pass 1 takes max|x| per thread, then across the warp with
//   __shfl_xor_sync, then across warps in shared memory; pass 2 re-reads
//   the tile (from L1/L2) and writes q.
//
// A ragged last tile masks i >= n, which gives the reference's zero-padding
// result: zeros cannot raise a max of absolute values.
//
// NaN: the max propagates a NaN as jnp.max does (nan_max in tile_math.cuh,
// not fmaxf, which drops it), so a tile holding a NaN gets a NaN scale; its
// q entries are then NaN before the int8 store, which writes 0 for them as
// XLA's float-to-int8 conversion does.

#include "tile_math.cuh"

namespace {

constexpr int64_t kMaxTile = int64_t{1} << 30;

// Four int8 codes packed little-endian into one word.
__device__ __forceinline__ uint32_t pack4(int8_t a, int8_t b, int8_t c,
                                          int8_t d) {
  return static_cast<uint32_t>(static_cast<uint8_t>(a)) |
         static_cast<uint32_t>(static_cast<uint8_t>(b)) << 8 |
         static_cast<uint32_t>(static_cast<uint8_t>(c)) << 16 |
         static_cast<uint32_t>(static_cast<uint8_t>(d)) << 24;
}

// One warp per tile (tile <= 32 * P).  Vector layout: 16-byte vector number
// v = j * 32 + lane of the tile holds elements V*v .. V*v + V-1 (lane values
// V*j .. V*j + V-1); scalar layout: element j * 32 + lane (lane value j).
template <typename T, int P>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
quantize_tiles_warp_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                           float* __restrict__ scales, int64_t n,
                           int64_t ntiles, int tile) {
  constexpr int V = 16 / sizeof(T);         // elements of a 16-byte vector
  constexpr int NV = P / V;                 // vectors a lane
  const int64_t t = warp_tile_index();
  if (t >= ntiles) return;                  // the whole warp leaves
  const int lane = threadIdx.x & 31;
  const int64_t base = t * tile;
  const int valid = static_cast<int>(n - base < tile ? n - base : tile);
  x += base;
  q += base;
  const bool vec = NV > 0 && valid == tile && tile % V == 0 &&
                   aligned16(x) &&
                   (reinterpret_cast<uintptr_t>(q) & (V - 1)) == 0;
  float v[P];
  if (vec) {
    uint4 raw[NV > 0 ? NV : 1];
#pragma unroll
    for (int j = 0; j < NV; ++j) {          // every load before any use
      const int i = V * (j * 32 + lane);
      raw[j] = i < tile ? *reinterpret_cast<const uint4*>(x + i)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float u[V];
      unpack16<T>(raw[j], u);
#pragma unroll
      for (int w = 0; w < V; ++w) v[V * j + w] = u[w];
    }
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int i = j * 32 + lane;
      v[j] = i < valid ? to_f32(x[i]) : 0.0f;
    }
  }
  float m = 0.0f;
#pragma unroll
  for (int j = 0; j < P; ++j) m = nan_max(m, fabsf(v[j]));
  const float s = nan_max(warp_max(m), 1e-30f);
  if (vec) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = V * (j * 32 + lane);
      if (i < tile) {
        uint32_t word[V / 4];
#pragma unroll
        for (int w = 0; w < V / 4; ++w)
          word[w] = pack4(quantize_one(v[V * j + 4 * w], s),
                          quantize_one(v[V * j + 4 * w + 1], s),
                          quantize_one(v[V * j + 4 * w + 2], s),
                          quantize_one(v[V * j + 4 * w + 3], s));
        if constexpr (V == 8)
          *reinterpret_cast<uint2*>(q + i) = make_uint2(word[0], word[1]);
        else
          *reinterpret_cast<uint32_t*>(q + i) = word[0];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int i = j * 32 + lane;
      if (i < valid) q[i] = quantize_one(v[j], s);
    }
  }
  if (lane == 0) scales[t] = s;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
quantize_tiles_block_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                            float* __restrict__ scales, int64_t n,
                            int tile) {
  __shared__ float warp_max_buf[kMaxThreads / 32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;

  float m = 0.0f;
  for (int j = threadIdx.x; j < tile; j += blockDim.x) {
    const int64_t i = base + j;
    if (i < n) m = nan_max(m, fabsf(to_f32(x[i])));
  }
  const float s = nan_max(block_max(m, warp_max_buf), 1e-30f);

  for (int j = threadIdx.x; j < tile; j += blockDim.x) {
    const int64_t i = base + j;
    if (i < n) q[i] = quantize_one(to_f32(x[i]), s);
  }
  if (threadIdx.x == 0) scales[blockIdx.x] = s;
}

template <typename T, int P>
void quantize_warp(const void* x, void* q, void* scales, int64_t n,
                   int64_t ntiles, int tile, cudaStream_t s) {
  quantize_tiles_warp_kernel<T, P><<<warp_route_blocks(ntiles),
                                     kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scales), n, ntiles, tile);
}

template <typename T>
void quantize_warp_of(const void* x, void* q, void* scales, int64_t n,
                      int64_t ntiles, int tile, cudaStream_t s) {
  switch (values_per_lane(tile)) {
    case 1: quantize_warp<T, 1>(x, q, scales, n, ntiles, tile, s); break;
    case 2: quantize_warp<T, 2>(x, q, scales, n, ntiles, tile, s); break;
    case 4: quantize_warp<T, 4>(x, q, scales, n, ntiles, tile, s); break;
    case 8: quantize_warp<T, 8>(x, q, scales, n, ntiles, tile, s); break;
    case 16: quantize_warp<T, 16>(x, q, scales, n, ntiles, tile, s); break;
    default: quantize_warp<T, 32>(x, q, scales, n, ntiles, tile, s);
  }
}

// The number of tiles, or -1 for arguments no route takes.
int64_t tile_count(int64_t n, int64_t tile) {
  if (n <= 0 || tile <= 0 || tile > kMaxTile) return -1;
  const int64_t ntiles = (n + tile - 1) / tile;
  return ntiles > 0x7fffffff ? -1 : ntiles;
}

}  // namespace

// The warp route (tile <= kWarpMaxTile).  x: n elements (f32, or bf16 when
// x_is_bf16), q: n int8, scales: ceil(n/tile) f32, all device pointers.
// Launches on `stream` without synchronising; returns cudaGetLastError()
// (0 on success).
extern "C" int quantize_tiles_warp_launch(const void* x, void* q,
                                          void* scales, int64_t n,
                                          int64_t tile, int x_is_bf16,
                                          void* stream) {
  const int64_t ntiles = tile_count(n, tile);
  if (ntiles < 0 || tile > kWarpMaxTile)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    quantize_warp_of<__nv_bfloat16>(x, q, scales, n, ntiles,
                                    static_cast<int>(tile), s);
  else
    quantize_warp_of<float>(x, q, scales, n, ntiles, static_cast<int>(tile),
                            s);
  return static_cast<int>(cudaGetLastError());
}

// The block route (kWarpMaxTile < tile <= 2^30); the same arguments as
// quantize_tiles_warp_launch.
extern "C" int quantize_tiles_block_launch(const void* x, void* q,
                                           void* scales, int64_t n,
                                           int64_t tile, int x_is_bf16,
                                           void* stream) {
  const int64_t ntiles = tile_count(n, tile);
  if (ntiles < 0 || tile <= kWarpMaxTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = tile_threads(tile);
  const dim3 grid(static_cast<unsigned>(ntiles));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    quantize_tiles_block_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scales), n, static_cast<int>(tile));
  } else {
    quantize_tiles_block_kernel<float><<<grid, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scales), n, static_cast<int>(tile));
  }
  return static_cast<int>(cudaGetLastError());
}
