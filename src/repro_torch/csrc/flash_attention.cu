// Forward attention with a streaming softmax for Hopper (sm_90a), SIMT
// route: f32 inputs, and bf16 at a head dim that the tensor-core kernel
// (flash_attention_wgmma.cu) does not take.  Also the pre-pass that both
// routes run first (nonfinite_tiles_kernel, below).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:_kernel
// (entry flash_attention_pallas).  For q (B, T, H, hd) and k, v (B, S, KV, hd)
// with H = KV * G, query head h reads KV head h / G (the reference's
// (KV, G) head split), and for every query row:
//
//     s   = (q . k) * (1 / sqrt(hd))              inputs widened to f32
//     s   = softcap * tanh(s / softcap)           optional
//     s   = -1e30 where masked                    (NEG_INF, not -inf)
//             causal: key <= query;  window w: query - key < w,
//             and, when not causal, key - query < w
//     online softmax over key tiles, in f32:
//       m' = max(m, max s);  p = exp(s - m');  corr = exp(m - m')
//       l  = l * corr + sum p
//       acc = acc * corr + round_to_v_type(p) . v
//     out = acc / max(l, 1e-30), cast to q's type.
//
// p is rounded to v's storage type before the p.v product, as the pure-jnp
// twin on the JAX model path does (src/repro/models/attention.py,
// _flash_fwd_impl); the Pallas kernel widens v to f32 first, so its cast is
// a no-op there.  For f32 inputs the two are the same.
//
// What bounds it: operations.  4 * B * H * hd operations per unmasked
// (query, key) pair against q, k, v read once and out written once.  With
// f32 inputs the products run as f32 FMAs on the CUDA cores (67 TFLOP/s):
// TF32 on the tensor cores would break the f32 tolerance.  This kernel uses
// expf / tanhf, not the fast intrinsics.
//
// Design (simple and correct first):
//   * one block of 256 threads per (64-row query tile, head, batch row);
//     tiles are walked heaviest first (the last query tile first) so the
//     causal tail does not end the grid alone;
//   * the query tile and one 64-key tile of K and of V are staged in dynamic
//     shared memory as f32 (bf16 is widened on load; exact), with rows
//     padded to 32 * NJ + 4 floats so the 16-byte reads of K rows by
//     neighbouring lanes fall in distinct banks: 217,088 bytes at hd 256,
//     opted into with cudaFuncSetAttribute;
//   * warp w owns query rows 8w .. 8w+7 for the whole tile: it computes
//     their 8 x 64 scores (lane: keys lane and lane + 32), the online
//     softmax with warp shuffles, writes p to its own rows of a shared
//     64 x 68 buffer, and accumulates p.v into registers (lane: dims
//     lane + 32 j), so only the K/V loads need the whole block in step;
//   * (m, l, acc) live in registers in f32 across the key tiles;
//   * q, k, v are read in the model's (B, T, H, hd) layout through their
//     strides (last dim contiguous): no transposed copies; out is
//     contiguous (B, T, H, hd).  Ragged last query and key tiles are
//     masked: rows past T are not stored, keys past S get -inf (weight 0,
//     as if absent) and are not part of the softmax.
//
// Key tiles that the mask empties for every row of the query tile are
// skipped (flash_common.cuh: visited_tiles): those past the causal diagonal
// or the forward window, and those before the backward window.  For finite
// v that is exact: past the diagonal p = exp(-1e30 - m) = 0, and before a
// row's first valid tile the reference adds exp(0) * v and then wipes it
// with corr = 0.  For an inf or a NaN in a skipped tile of v the reference
// gives NaN (0 * inf, or inf * 0), so the epilogue writes NaN at the head
// dims where the pre-pass found a non-finite v in a skipped tile
// (flash_common.cuh: skipped_nonfinite).  The kernel is launched as a
// programmatic dependent of the pre-pass and waits for it only there.  A
// query tile holding a row with no valid key at all (T > S with a window)
// visits every key tile, so that row gets the reference's mean of v.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::kKvBlk;
using flash::kNegInf;

constexpr int kQBlk = 64;                           // query rows per block
constexpr int kThreads = 256;                       // 8 warps
constexpr int kRows = kQBlk / (kThreads / 32);      // query rows per warp
constexpr int kLdP = kKvBlk + 4;                    // row stride of p

struct Params {
  int64_t q_sb, q_st, q_sh;     // element strides of q (B, T, H, hd)
  int64_t k_sb, k_st, k_sh;     // of k (B, S, KV, hd)
  int64_t v_sb, v_st, v_sh;     // of v
  int B, T, S, H, KV, G, hd;
  int nt;                       // key tiles: ceil(S / kKvBlk)
  int causal;
  int window;                   // <= 0: no window
  float softcap;                // <= 0: no softcap
  float scale;                  // 1 / sqrt(hd) in f32
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// p rounded to the storage type of v (round to nearest even; no-op for f32).
__device__ __forceinline__ float round_to(float p, const float*) { return p; }
__device__ __forceinline__ float round_to(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Stage `rows_valid` rows of `hd` elements (row stride `s_row`) into a
// 64 x W f32 tile of row stride LD, zero-filling the rest.
template <typename T, int W, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t s_row, int rows_valid,
                                          int hd) {
  for (int i = threadIdx.x; i < kQBlk * W; i += kThreads) {
    const int r = i / W, d = i - r * W;
    float x = 0.0f;
    if (r < rows_valid && d < hd) x = to_f32(src[r * s_row + d]);
    dst[r * LD + d] = x;
  }
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 const int* __restrict__ tiles, Params p) {
  constexpr int W = 32 * NJ;        // head dim padded to whole warps
  constexpr int LD = W + 4;         // shared row stride in floats
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kQBlk * LD;
  float* sV = sK + kKvBlk * LD;
  float* sP = sV + kKvBlk * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;       // heaviest tile first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.G;
  const int q0 = qt * kQBlk;
  const int q_rows = min(kQBlk, p.T - q0);
  const int qlast = q0 + q_rows - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * kRows;
  const int hd4 = (p.hd + 3) & ~3;

  int kt_lo, kt_hi;
  flash::visited_tiles(q0, qlast, p.S, p.causal, p.window, &kt_lo, &kt_hi);

  load_tile<T, W, LD>(sQ, q + b * p.q_sb + q0 * p.q_st + h * p.q_sh, p.q_st,
                      q_rows, p.hd);

  float m[kRows], l[kRows], acc[kRows][NJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kKvBlk;
    const int k_rows = min(kKvBlk, p.S - k0);
    __syncthreads();                // every warp is done with the last tile
    load_tile<T, W, LD>(sK, k + b * p.k_sb + k0 * p.k_st + kvh * p.k_sh,
                        p.k_st, k_rows, p.hd);
    load_tile<T, W, LD>(sV, v + b * p.v_sb + k0 * p.v_st + kvh * p.v_sh,
                        p.v_st, k_rows, p.hd);
    __syncthreads();

    // scores of rows row0 .. row0+7 against keys lane and lane + 32
    float s[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i][0] = s[i][1] = 0.0f;
    const float* k_a = sK + lane * LD;
    const float* k_b = sK + (lane + 32) * LD;
    const float* q_r = sQ + row0 * LD;
#pragma unroll 2
    for (int d = 0; d < hd4; d += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(k_a + d);
      const float4 kb = *reinterpret_cast<const float4*>(k_b + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(q_r + i * LD + d);
        s[i][0] = fmaf(qv.x, ka.x, s[i][0]);
        s[i][0] = fmaf(qv.y, ka.y, s[i][0]);
        s[i][0] = fmaf(qv.z, ka.z, s[i][0]);
        s[i][0] = fmaf(qv.w, ka.w, s[i][0]);
        s[i][1] = fmaf(qv.x, kb.x, s[i][1]);
        s[i][1] = fmaf(qv.y, kb.y, s[i][1]);
        s[i][1] = fmaf(qv.z, kb.z, s[i][1]);
        s[i][1] = fmaf(qv.w, kb.w, s[i][1]);
      }
    }

    // online softmax, one row at a time across the warp
    float corr[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + row0 + i;
      float x[2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int kpos = k0 + lane + 32 * jj;
        float t = s[i][jj] * p.scale;
        if (p.softcap > 0.0f) t = p.softcap * tanhf(t / p.softcap);
        if (kpos >= p.S) {
          t = -INFINITY;            // past the keys: absent, weight 0
        } else if (!flash::allowed(qpos, kpos, p.causal, p.window)) {
          t = kNegInf;
        }
        x[jj] = t;
      }
      const float m_new = fmaxf(m[i], warp_max(fmaxf(x[0], x[1])));
      const float p0 = expf(x[0] - m_new);
      const float p1 = expf(x[1] - m_new);
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + warp_sum(p0 + p1);
      m[i] = m_new;
      sP[(row0 + i) * kLdP + lane] = round_to(p0, v);
      sP[(row0 + i) * kLdP + lane + 32] = round_to(p1, v);
    }
    __syncwarp();

#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr[i];

    // acc[i][j] += sum_c p[row0 + i][c] * v[c][lane + 32 j]
    const float* p_r = sP + row0 * kLdP;
#pragma unroll 2
    for (int c = 0; c < kKvBlk; c += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = *reinterpret_cast<const float4*>(p_r + i * kLdP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* v_r = sV + (c + cc) * LD + lane;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float vv = v_r[32 * j];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            acc[i][j] = fmaf((&pv[i].x)[cc], vv, acc[i][j]);
        }
      }
    }
    __syncwarp();                   // p rows are rewritten by the next tile
  }

  // the NaN rule for non-finite v in the skipped tiles (word j: the dims
  // lane + 32 j' of warps' lanes, bit lane)
  uint32_t bad[NJ];
  flash::skipped_nonfinite<NJ>(tiles, p.nt, p.B * p.KV, b * p.KV + kvh,
                               (p.hd + 31) / 32, kt_lo, kt_hi, bad);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + row0 + i;
    if (qpos >= p.T) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + ((static_cast<int64_t>(b) * p.T + qpos) * p.H + h) * p.hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + 32 * j;
      if (d < p.hd)
        store(o + d, (bad[j] >> lane) & 1u ? NAN : acc[i][j] / denom);
    }
  }
}

template <typename T, int NJ>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 const int* tiles, const Params& p, cudaStream_t stream) {
  constexpr int LD = 32 * NJ + 4;
  const size_t smem = sizeof(float) * (static_cast<size_t>(kQBlk) * LD +
                                       2 * static_cast<size_t>(kKvBlk) * LD +
                                       static_cast<size_t>(kQBlk) * kLdP);
  auto kernel = flash_fwd_kernel<T, NJ>;
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
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured |= bit;
  }
  const dim3 grid(static_cast<unsigned>((p.T + kQBlk - 1) / kQBlk),
                  static_cast<unsigned>(p.H), static_cast<unsigned>(p.B));
  // a programmatic dependent of the pre-pass: it may start while the
  // pre-pass runs, and waits for it only in its epilogue
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q),
                           static_cast<const T*>(k), static_cast<const T*>(v),
                           static_cast<T*>(out), tiles, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out,
              const int* tiles, const Params& p, cudaStream_t s) {
  if (p.hd <= 32) return launch_typed<T, 1>(q, k, v, out, tiles, p, s);
  if (p.hd <= 64) return launch_typed<T, 2>(q, k, v, out, tiles, p, s);
  if (p.hd <= 128) return launch_typed<T, 4>(q, k, v, out, tiles, p, s);
  return launch_typed<T, 8>(q, k, v, out, tiles, p, s);
}

// Pre-pass of both routes: which key tiles of v hold a non-finite value,
// and at which head dims (the layout in flash_common.cuh).  One read of v,
// bound by bytes.  One block per (key tile, b * KV + kv head), one thread
// per head dim: it reads its dim of the tile's 64 positions; a warp ballot
// gives the tile's word of 32 dims, a block vote its flag.  Every entry is
// written, so the buffer needs no clearing.  It lets its dependents (the
// attention kernels, launched programmatically after it) start at once.
template <typename T>
__global__ void __launch_bounds__(256)
nonfinite_tiles_kernel(const T* __restrict__ v, int* __restrict__ tiles,
                       int S, int KV, int hd, int64_t v_sb, int64_t v_st,
                       int64_t v_sh) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int c = blockIdx.x, bk = blockIdx.y;
  const int bkv = gridDim.y, nw = blockDim.x / 32;
  const int b = bk / KV, kvh = bk - b * KV;
  const int d = threadIdx.x;
  const int s0 = c * kKvBlk, rows = min(kKvBlk, S - s0);
  bool bad = false;
  if (d < hd) {
    const T* src = v + b * v_sb + kvh * v_sh + s0 * v_st + d;
#pragma unroll 16
    for (int r = 0; r < rows; ++r) bad |= !isfinite(to_f32(src[r * v_st]));
  }
  const uint32_t word = __ballot_sync(0xffffffffu, bad);
  const int any = __syncthreads_or(bad);
  uint32_t* words = reinterpret_cast<uint32_t*>(tiles + gridDim.x * bkv);
  if ((threadIdx.x & 31) == 0)
    words[(c * bkv + bk) * nw + threadIdx.x / 32] = word;
  if (threadIdx.x == 0) tiles[c * bkv + bk] = any != 0;
}

template <typename T>
int tiles_typed(const void* v, int* tiles, int B, int S, int KV, int hd,
                int64_t v_sb, int64_t v_st, int64_t v_sh, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((S + kKvBlk - 1) / kKvBlk),
                  static_cast<unsigned>(B * KV));
  nonfinite_tiles_kernel<T><<<grid, 32 * ((hd + 31) / 32), 0, s>>>(
      static_cast<const T*>(v), tiles, S, KV, hd, v_sb, v_st, v_sh);
  return static_cast<int>(cudaGetLastError());
}

// the pre-pass's output: int32 entries for v (B, S, KV, hd)
int64_t tiles_entries(int64_t B, int64_t S, int64_t KV, int64_t hd) {
  return (S + kKvBlk - 1) / kKvBlk * B * KV * (1 + (hd + 31) / 32);
}

}  // namespace

// v (B, S, KV, hd) with the given element strides (last dim contiguous), f32
// or bf16 (is_bf16); tiles: an int32 buffer of
// ceil(S / 64) * B * KV * (1 + ceil(hd / 32)) entries (flash_common.cuh),
// all of which this writes.  Launches on `stream`; returns the CUDA error
// of the launch (0 on success).
extern "C" int nonfinite_tiles_launch(const void* v, void* tiles, int64_t B,
                                      int64_t S, int64_t KV, int64_t hd,
                                      int64_t v_sb, int64_t v_st,
                                      int64_t v_sh, int is_bf16,
                                      void* stream) {
  if (B < 1 || S < 1 || KV < 1 || hd < 1 || hd > 256 || B * KV > 65535 ||
      S >= (int64_t{1} << 30) ||
      tiles_entries(B, S, KV, hd) >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* out = static_cast<int*>(tiles);
  const int b = static_cast<int>(B), kv = static_cast<int>(KV);
  const int sl = static_cast<int>(S), d = static_cast<int>(hd);
  return is_bf16 ? tiles_typed<__nv_bfloat16>(v, out, b, sl, kv, d, v_sb,
                                              v_st, v_sh, s)
                 : tiles_typed<float>(v, out, b, sl, kv, d, v_sb, v_st, v_sh,
                                      s);
}

// q (B, T, H, hd), k and v (B, S, KV, hd): device pointers with the given
// element strides (the last dim contiguous), all f32 or all bf16 (is_bf16);
// out: contiguous (B, T, H, hd) of the same type; tiles: the pre-pass's
// output for this v, launched just before on the same stream.  window <= 0 means none, softcap <= 0 means none.
// Launches on `stream` without synchronising; returns the CUDA error of the
// attribute call or the launch (0 on success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, const void* tiles,
    int64_t B, int64_t T, int64_t S, int64_t H, int64_t KV, int64_t hd,
    int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb, int64_t k_st,
    int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh, int causal,
    int64_t window, double softcap, int is_bf16, void* stream) {
  const int64_t kMax = int64_t{1} << 30;
  if (B < 1 || B > 65535 || T < 1 || T >= kMax || S < 1 || S >= kMax ||
      KV < 1 || H < KV || H > 65535 || H % KV != 0 || hd < 1 || hd > 256 ||
      window >= kMax || tiles_entries(B, S, KV, hd) >= kMax)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
  p.B = static_cast<int>(B);
  p.T = static_cast<int>(T);
  p.S = static_cast<int>(S);
  p.H = static_cast<int>(H);
  p.KV = static_cast<int>(KV);
  p.G = static_cast<int>(H / KV);
  p.hd = static_cast<int>(hd);
  p.nt = static_cast<int>((S + kKvBlk - 1) / kKvBlk);
  p.causal = causal != 0;
  p.window = window > 0 ? static_cast<int>(window) : 0;
  p.softcap = softcap > 0.0 ? static_cast<float>(softcap) : 0.0f;
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tiles);
  return is_bf16 ? launch_hd<__nv_bfloat16>(q, k, v, out, t, p, s)
                 : launch_hd<float>(q, k, v, out, t, p, s);
}
