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
// makes `iters` counting passes over the tile, but over values held on
// chip, not over device memory: about 2 * iters operations per element,
// which bound topk_mask in bf16 (4 bytes moved per element) instead.
//
// Two designs, chosen by the caller from the tile alone
// (kernels/dispatch.py:tile_route):
//
// * warp route, tiles of up to kWarpMaxTile (1024) elements (the wire's
//   tile): one warp per tile, kWarpsPerBlock tiles per block, no shared
//   memory and no block barrier.  Each lane holds P = tile / 32 values
//   (rounded up to a power of two) in registers.  A tile whose first
//   element is 16-byte aligned in every array it reads and writes, that is
//   a whole number of 16-byte vectors (4 f32 or 8 bf16) and is not the
//   ragged last tile, is loaded with 16-byte loads (every load issued
//   before the first use: 2 x P / 4 of 16 bytes in flight per lane for
//   topk_ef, P / 4 or P / 8 for topk_mask) and stored with 16-byte stores;
//   any other tile takes scalar loads inside the same kernel.  topk_mask
//   writes x's own bits where it keeps and +0 elsewhere.  The bisection
//   (warp_bisect_threshold, shared by both kernels) counts per lane and
//   totals with __reduce_add_sync, so every lane holds the same lo and hi
//   and the loop is uniform.  Register arrays are indexed only at
//   compile-time indices in fully unrolled loops, so they stay in
//   registers.
// * block route, tiles of 1025 to kMaxTile elements: one thread block per
//   tile, with min(round_up(tile, 32), 256) threads striding over it.  The
//   tile's c lives in dynamic shared memory; each round counts per thread,
//   then across the block with warp shuffles and one shared pass
//   (block_sum).
//
// On both routes topk_ef's e_new may be e itself (the executor passes the
// EF state's buffer): every e[i] is read, by the lane or thread that later
// writes e_new[i], before any write, so those two pointers carry no
// __restrict__.  Padding: a slot inside the tile whose global index is
// >= n is the reference's zero padding and counts as |0| in every round
// (so only when mid is 0); a slot past the tile's end is not part of it
// and never counts.  Indices are int64.

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

// The bisection threshold of one warp's tile: each lane holds its P values
// of c; the tile's zero padding holds 0 (and counts as |0|), and so do the
// `outside` slots of the warp that lie past the tile's end, which are taken
// back out of every count.  Called by every lane of the warp (no other
// synchronisation); returns the same hi to all.
template <int P>
__device__ __forceinline__ float warp_bisect_threshold(const float (&c)[P],
                                                       int outside, int k,
                                                       int iters) {
  float m = 0.0f;
#pragma unroll
  for (int j = 0; j < P; ++j) m = nan_max(m, fabsf(c[j]));
  float hi = warp_max(m);
  float lo = 0.0f;
  for (int it = 0; it < iters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    int own = 0;
#pragma unroll
    for (int j = 0; j < P; ++j) own += fabsf(c[j]) >= mid;
    const int cnt =
        static_cast<int>(__reduce_add_sync(0xffffffffu,
                                           static_cast<unsigned>(own))) -
        (0.0f >= mid ? outside : 0);
    if (cnt > k) lo = mid; else hi = mid;
  }
  return hi;
}

// y and e_new of one value c against the threshold hi.
__device__ __forceinline__ void ef_split(float c, float hi, float& y,
                                         float& e_new) {
  const bool keep = fabsf(c) >= hi;
  y = keep ? c : 0.0f;
  e_new = keep ? 0.0f : c;
}

__device__ __forceinline__ float ef_add(float g, float e, float decay) {
  return __fadd_rn(g, __fmul_rn(decay, e));
}

// One warp per tile (tile <= 32 * P).  Vector layout: float4 number
// v = j * 32 + lane of the tile holds elements 4v .. 4v + 3 (lane values
// 4j .. 4j + 3); scalar layout: element j * 32 + lane (lane value j).
template <int P>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
topk_ef_warp_kernel(const float* __restrict__ g, const float* e,
                    float* __restrict__ y, float* e_new, int64_t n,
                    int64_t ntiles, int tile, int k, int iters, float decay) {
  constexpr int NV = P / 4;                 // float4 vectors a lane
  const int64_t t = warp_tile_index();
  if (t >= ntiles) return;                  // the whole warp leaves
  const int lane = threadIdx.x & 31;
  const int64_t base = t * tile;
  const int valid = static_cast<int>(n - base < tile ? n - base : tile);
  g += base;
  e += base;
  y += base;
  e_new += base;
  const bool vec = NV > 0 && valid == tile && tile % 4 == 0 &&
                   aligned16(g) && aligned16(e) && aligned16(y) &&
                   aligned16(e_new);
  float c[P];
  if (vec) {
    float4 gv[NV > 0 ? NV : 1], ev[NV > 0 ? NV : 1];
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < NV; ++j) {          // every load before any use
      const int i = 4 * (j * 32 + lane);
      gv[j] = i < tile ? *reinterpret_cast<const float4*>(g + i) : zero;
      ev[j] = i < tile ? *reinterpret_cast<const float4*>(e + i) : zero;
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      c[4 * j + 0] = ef_add(gv[j].x, ev[j].x, decay);
      c[4 * j + 1] = ef_add(gv[j].y, ev[j].y, decay);
      c[4 * j + 2] = ef_add(gv[j].z, ev[j].z, decay);
      c[4 * j + 3] = ef_add(gv[j].w, ev[j].w, decay);
    }
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int i = j * 32 + lane;
      c[j] = i < valid ? ef_add(g[i], e[i], decay) : 0.0f;
    }
  }
  const float hi = warp_bisect_threshold<P>(c, 32 * P - tile, k, iters);
  if (vec) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = 4 * (j * 32 + lane);
      if (i < tile) {
        float4 yv, rv;
        ef_split(c[4 * j + 0], hi, yv.x, rv.x);
        ef_split(c[4 * j + 1], hi, yv.y, rv.y);
        ef_split(c[4 * j + 2], hi, yv.z, rv.z);
        ef_split(c[4 * j + 3], hi, yv.w, rv.w);
        *reinterpret_cast<float4*>(y + i) = yv;
        *reinterpret_cast<float4*>(e_new + i) = rv;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int i = j * 32 + lane;
      if (i < valid) ef_split(c[j], hi, y[i], e_new[i]);
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
topk_ef_block_kernel(const float* __restrict__ g, const float* e,
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

// The 16-byte vector of T holding v's bits where |v| >= hi and +0
// elsewhere (v: the f32 values unpack16<T> gave, so a kept value's f32
// bits hold its T bits: all 32 for f32, the high 16 for bf16).
template <typename T>
__device__ __forceinline__ uint4 pack16_kept(const float (&v)[16 / sizeof(T)],
                                             float hi) {
  uint32_t w[4];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      w[u] = fabsf(v[u]) >= hi ? __float_as_uint(v[u]) : 0u;
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      w[u] = (fabsf(v[2 * u]) >= hi ? __float_as_uint(v[2 * u]) >> 16 : 0u) |
             (fabsf(v[2 * u + 1]) >= hi
                  ? __float_as_uint(v[2 * u + 1]) & 0xffff0000u : 0u);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One warp per tile (tile <= 32 * P).  Vector layout: 16-byte vector number
// v = j * 32 + lane of the tile holds elements V*v .. V*v + V-1 (lane values
// V*j .. V*j + V-1); scalar layout: element j * 32 + lane (lane value j).
template <typename T, int P>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
topk_mask_warp_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n,
                      int64_t ntiles, int tile, int k, int iters) {
  constexpr int V = 16 / sizeof(T);         // elements of a 16-byte vector
  constexpr int NV = P / V;                 // vectors a lane
  const int64_t t = warp_tile_index();
  if (t >= ntiles) return;                  // the whole warp leaves
  const int lane = threadIdx.x & 31;
  const int64_t base = t * tile;
  const int valid = static_cast<int>(n - base < tile ? n - base : tile);
  x += base;
  y += base;
  const bool vec = NV > 0 && valid == tile && tile % V == 0 &&
                   aligned16(x) && aligned16(y);
  float c[P];
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
      for (int w = 0; w < V; ++w) c[V * j + w] = u[w];
    }
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int i = j * 32 + lane;
      c[j] = i < valid ? to_f32(x[i]) : 0.0f;
    }
  }
  const float hi = warp_bisect_threshold<P>(c, 32 * P - tile, k, iters);
  if (vec) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = V * (j * 32 + lane);
      if (i < tile) {
        float u[V];
#pragma unroll
        for (int w = 0; w < V; ++w) u[w] = c[V * j + w];
        *reinterpret_cast<uint4*>(y + i) = pack16_kept<T>(u, hi);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int i = j * 32 + lane;
      if (i < valid) y[i] = fabsf(c[j]) >= hi ? x[i] : T(0.0f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
topk_mask_block_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n,
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

template <int P>
void topk_ef_warp(const void* g, const void* e, void* y, void* e_new,
                  int64_t n, int64_t ntiles, int tile, int k, int iters,
                  float decay, cudaStream_t s) {
  topk_ef_warp_kernel<P><<<warp_route_blocks(ntiles), kWarpsPerBlock * 32,
                           0, s>>>(
      static_cast<const float*>(g), static_cast<const float*>(e),
      static_cast<float*>(y), static_cast<float*>(e_new), n, ntiles, tile, k,
      iters, decay);
}

template <typename T, int P>
void topk_mask_warp(const void* x, void* y, int64_t n, int64_t ntiles,
                    int tile, int k, int iters, cudaStream_t s) {
  topk_mask_warp_kernel<T, P><<<warp_route_blocks(ntiles),
                                kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, ntiles, tile, k,
      iters);
}

template <typename T>
void topk_mask_warp_of(const void* x, void* y, int64_t n, int64_t ntiles,
                       int tile, int k, int iters, cudaStream_t s) {
  switch (values_per_lane(tile)) {
    case 1: topk_mask_warp<T, 1>(x, y, n, ntiles, tile, k, iters, s); break;
    case 2: topk_mask_warp<T, 2>(x, y, n, ntiles, tile, k, iters, s); break;
    case 4: topk_mask_warp<T, 4>(x, y, n, ntiles, tile, k, iters, s); break;
    case 8: topk_mask_warp<T, 8>(x, y, n, ntiles, tile, k, iters, s); break;
    case 16: topk_mask_warp<T, 16>(x, y, n, ntiles, tile, k, iters, s);
      break;
    default: topk_mask_warp<T, 32>(x, y, n, ntiles, tile, k, iters, s);
  }
}

}  // namespace

// topk_ef on the warp route (tile <= kWarpMaxTile).  g, e, y, e_new: n f32
// device pointers (e_new may equal e).  Launches on `stream` without
// synchronising; returns cudaGetLastError() (0 on success).
extern "C" int topk_ef_warp_launch(const void* g, const void* e, void* y,
                                   void* e_new, int64_t n, int64_t tile,
                                   int64_t k, int64_t iters, float decay,
                                   void* stream) {
  if (bad_args(n, tile, k, iters) || tile > kWarpMaxTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ntiles = (n + tile - 1) / tile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int t = static_cast<int>(tile), kk = static_cast<int>(k),
            it = static_cast<int>(iters);
  switch (values_per_lane(tile)) {
    case 1: topk_ef_warp<1>(g, e, y, e_new, n, ntiles, t, kk, it, decay, s);
      break;
    case 2: topk_ef_warp<2>(g, e, y, e_new, n, ntiles, t, kk, it, decay, s);
      break;
    case 4: topk_ef_warp<4>(g, e, y, e_new, n, ntiles, t, kk, it, decay, s);
      break;
    case 8: topk_ef_warp<8>(g, e, y, e_new, n, ntiles, t, kk, it, decay, s);
      break;
    case 16: topk_ef_warp<16>(g, e, y, e_new, n, ntiles, t, kk, it, decay, s);
      break;
    default: topk_ef_warp<32>(g, e, y, e_new, n, ntiles, t, kk, it, decay, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// topk_ef on the block route (kWarpMaxTile < tile <= kMaxTile); the same
// arguments as topk_ef_warp_launch.
extern "C" int topk_ef_block_launch(const void* g, const void* e, void* y,
                                    void* e_new, int64_t n, int64_t tile,
                                    int64_t k, int64_t iters, float decay,
                                    void* stream) {
  if (bad_args(n, tile, k, iters) || tile <= kWarpMaxTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ntiles = (n + tile - 1) / tile;
  topk_ef_block_kernel<<<dim3(static_cast<unsigned>(ntiles)),
                         tile_threads(tile),
                         static_cast<size_t>(tile) * sizeof(float),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(e),
      static_cast<float*>(y), static_cast<float*>(e_new), n,
      static_cast<int>(tile), static_cast<int>(k), static_cast<int>(iters),
      decay);
  return static_cast<int>(cudaGetLastError());
}

// topk_mask on the warp route (tile <= kWarpMaxTile).  x, y: n elements
// (f32, or bf16 when x_is_bf16) on the device.  Launches on `stream`
// without synchronising; returns cudaGetLastError() (0 on success).
extern "C" int topk_mask_warp_launch(const void* x, void* y, int64_t n,
                                     int64_t tile, int64_t k, int64_t iters,
                                     int x_is_bf16, void* stream) {
  if (bad_args(n, tile, k, iters) || tile > kWarpMaxTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ntiles = (n + tile - 1) / tile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int t = static_cast<int>(tile), kk = static_cast<int>(k),
            it = static_cast<int>(iters);
  if (x_is_bf16)
    topk_mask_warp_of<__nv_bfloat16>(x, y, n, ntiles, t, kk, it, s);
  else
    topk_mask_warp_of<float>(x, y, n, ntiles, t, kk, it, s);
  return static_cast<int>(cudaGetLastError());
}

// topk_mask on the block route (kWarpMaxTile < tile <= kMaxTile); the same
// arguments as topk_mask_warp_launch.
extern "C" int topk_mask_block_launch(const void* x, void* y, int64_t n,
                                      int64_t tile, int64_t k, int64_t iters,
                                      int x_is_bf16, void* stream) {
  if (bad_args(n, tile, k, iters) || tile <= kWarpMaxTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ntiles = (n + tile - 1) / tile;
  const dim3 grid(static_cast<unsigned>(ntiles));
  const size_t smem = static_cast<size_t>(tile) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    topk_mask_block_kernel<__nv_bfloat16><<<grid, tile_threads(tile), smem,
                                            s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        n, static_cast<int>(tile), static_cast<int>(k),
        static_cast<int>(iters));
  } else {
    topk_mask_block_kernel<float><<<grid, tile_threads(tile), smem, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n,
        static_cast<int>(tile), static_cast<int>(k), static_cast<int>(iters));
  }
  return static_cast<int>(cudaGetLastError());
}
