// What the two forward attention kernels (flash_attention.cu, the SIMT
// route, and flash_attention_wgmma.cu, the tensor-core route) share: the
// mask, the range of key tiles a query tile visits, and the rule that keeps
// skipping those tiles exact for a v that holds an inf or a NaN.
#pragma once

#include <stdint.h>

namespace flash {

constexpr int kKvBlk = 64;                  // keys per tile, both routes
constexpr float kNegInf = -1e30f;           // the reference's NEG_INF

// May key position `kpos` be attended from query position `qpos`?
// causal: key <= query; window w: query - key < w, and, when not causal,
// key - query < w.
__device__ __forceinline__ bool allowed(int qpos, int kpos, int causal,
                                        int window) {
  if (causal && kpos > qpos) return false;
  if (window > 0) {
    if (qpos - kpos >= window) return false;
    if (!causal && kpos - qpos >= window) return false;
  }
  return true;
}

// The key tiles [*kt_lo, *kt_hi] that query rows q0 .. qlast visit: every
// tile holding a key that some row of them may attend.  A tile outside the
// range is masked for every one of these rows.  When a row has no valid key
// at all (T > S with a window), every tile is visited, so that row gets the
// reference's mean of v.
__device__ __forceinline__ void visited_tiles(int q0, int qlast, int S,
                                              int causal, int window,
                                              int* kt_lo, int* kt_hi) {
  int lo = 0, hi = S - 1;
  if (causal) hi = min(hi, qlast);
  if (window > 0) {
    lo = max(lo, q0 - window + 1);
    if (!causal) hi = min(hi, qlast + window - 1);
    if (static_cast<int64_t>(qlast) >= static_cast<int64_t>(S) + window - 1) {
      lo = 0;
      hi = S - 1;
    }
  }
  *kt_lo = lo / kKvBlk;
  *kt_hi = hi / kKvBlk;
}

// The pre-pass's output (nonfinite_tiles_kernel, flash_attention.cu), for
// v (B, S, KV, hd), nt = ceil(S / kKvBlk) key tiles, bkv = B * KV, nw =
// ceil(hd / 32), as int32:
//   flags[c * bkv + bk]              1 if key tile c of (b, kv head) bk
//                                    holds a non-finite v, else 0
//   words[(c * bkv + bk) * nw + w]   after the flags: bit i set if v at
//                                    head dim 32 w + i is non-finite there
//
// The NaN rule, which the reference gives by visiting every key tile:
// out[b, t, h, d] is NaN when some key masked for row t has a non-finite
// v[b, s, h / G, d] (0 * inf, or the corr = 0 wipe of an inf added before
// the row's first valid key).  Visited tiles give it by themselves; this
// collects, into bad[], the head dims with a non-finite v in a tile
// outside [kt_lo, kt_hi], which every row of the query tile masks.
//
// The attention kernels are launched as programmatic dependents of the
// pre-pass, so they may start before it ends: this waits for it first.
// Every lane of a warp calls it (the lanes share the scan of the flags).
template <int W>
__device__ __forceinline__ void skipped_nonfinite(const int* __restrict__ tiles,
                                                  int nt, int bkv, int bk,
                                                  int nw, int kt_lo,
                                                  int kt_hi, uint32_t (&bad)[W]) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
#pragma unroll
  for (int w = 0; w < W; ++w) bad[w] = 0;
  bool any = false;
  for (int c = threadIdx.x & 31; c < nt; c += 32)
    any |= (c < kt_lo || c > kt_hi) && tiles[c * bkv + bk] != 0;
  if (!__any_sync(0xffffffffu, any)) return;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(tiles + nt * bkv);
  for (int c = 0; c < nt; ++c) {
    if ((c >= kt_lo && c <= kt_hi) || tiles[c * bkv + bk] == 0) continue;
#pragma unroll
    for (int w = 0; w < W; ++w)
      if (w < nw) bad[w] |= words[(c * bkv + bk) * nw + w];
  }
}

}  // namespace flash
