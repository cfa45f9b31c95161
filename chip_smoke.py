#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

  1. device: needs CUDA; prints the card's name and power limit
     (``nvidia-smi``); TF32 off for f32 matmuls and convolutions;
  2. build: the twelve CUDA kernels of the port from the five sources in
     the checkout (``nvcc``, one process per source, started together),
     with each kernel's registers and spills from ``-Xptxas -v``: no
     spill and no stack frame in the wgmma, quantize_tiles, quantize_ef
     and top-k libraries;
  3. kernels vs plain versions on the card.  ``quantize_tiles``,
     ``quantize_ef``, ``dequant_accum``, ``topk_ef`` and ``topk_mask`` are
     held BIT-EQUAL (NaN for NaN): quantize_tiles over a sweep of tiles
     (64 to 1024 on its warp route, 4096 on its block route), lengths,
     input types and a NaN tile, including every length the gemma-2b and
     gemma2-9b serving runs write (and dequantize must round-trip within
     s/254), the training wire over the CPU tests' cases (ragged lengths,
     decays, ratios, rank counts 1, 2, 4 and 8 at lengths that are and
     are not multiples of 16, zero tiles, exact halves, NaN tiles, f32
     and bf16 for topk_mask; dequant_accum and the top-k kernels at tile
     1024, their warp routes, and 2048, their block routes) and at every
     bucket length of the training path, called as the path calls them
     (the residual written in place; quantize_tiles and topk_mask as the
     encode without error feedback).  ``flash_attention`` is held within a stated tolerance,
     element by element (f32: rtol = atol = 1e-5; bf16: 2 bf16 ulps of
     the element plus 2 of its row's largest magnitude) over the JAX
     kernel tests' shapes and more (hd 32 to 256, G 1 to 68, ragged T,
     grids of one and two consumer warpgroups) x f32 (the SIMT route) /
     bf16 (the wgmma route) x window, softcap, window+softcap, non-causal
     and non-causal+window, rows with no valid key, and at the prefill
     shapes of gemma2-9b (global and local layers, softcap 50) and gemma-2b
     in both f32 and bf16; its pre-pass ``nonfinite_tiles`` is held
     bit-equal, and the NaN rule (NaN exactly where the plain version has
     NaN, for an inf or NaN of v in a skipped key tile) on both routes.
     Then kernel, plain-version, bound and library times at the serving
     and training paths' shapes, the library being one PyTorch call that
     computes the same function where there is one (SDPA; flex_attention
     compiled, for the softcap shapes); flash on both routes (the SIMT
     kernel on the same bf16 inputs), and gates: the wgmma route, pre-pass
     included, no slower than the library call and 5x faster than the
     SIMT kernel's recorded time at the gemma2-9b prefill; the warp
     routes faster than the block kernels' recorded times: topk_ef 2x,
     topk_mask 3x (f32) and dequant_accum 1.4x (one rank) at the largest
     bucket, and quantize_tiles 3x at the gemma2-9b prefill writes;
  4. small references: the reduced gemma-2b, gemma2-9b and gemma3-4b in
     f32 on the card (prefill through the flash kernel) agree with the
     port's CPU path (plain versions) for prefill logits and four
     vector-position decode steps, the two new ones past their window's
     ring wrap; and gemma-2b for two int8_fused training steps (all held
     against the JAX package by the tests);
  5. the serving path at full width: ``repro_torch.launch.serve`` with
     gemma-2b (18 layers, d_model 2048, vocab 256000, bf16, random
     weights from seed 0), int8 paged KV, continuous batching, 8 requests
     of 128 prompt + 64 new tokens through 4 slots;
  6. information only: the share of tokens at temperature 0 that the
     engine shares with ``run_static`` and ``generate``, and a profile of
     ten decode ticks (device-busy share, top kernels);
  7. gemma2-9b served at full width (42 layers alternating a 4096 window
     and global attention, GQA 16/8 heads, softcaps 50 and 30, untied
     head, 10.2 B parameters in bf16, random weights from seed 0), int8
     paged KV in two length groups, 4 requests of 6144 prompt + 32 new
     tokens through 4 slots: the prompts outrun the window, so the window
     mask, the kernel's tile skipping and the ring caches' wrap all run;
     the prefill time of one admission, and a profile of five decode
     ticks;
  8. the training path at full width: ``repro_torch.launch.train`` with
     gemma-2b, Adam, batch 4 x seq 512, 3 steps on an NCCL group of world
     1, once each with ``--sync comm --compressor int8_fused``, ``--sync
     comm --compressor topk_fused``, both of them again with
     ``--no-error-feedback``, and ``--sync vanilla``; step time, tokens/s,
     peak memory and a ``torch.profiler`` view of one more step per run;
  9. the explicit collectives at world 4 on the one card: 4 spawned
     processes on a gloo group (NCCL refuses two ranks on one device), card
     tensors staged through pinned host memory.  ``PlanExecutor`` runs
     int8_fused with error feedback on ``ring_fused`` for 3 rounds over
     the wire's first and largest buckets (73728 and 603979776 f32, each
     rank's gradients drawn on the card from seed + rank): every rank's
     result bit-equal (a digest of the bits), quantize_ef once and
     quantize_tiles 2·p = 8 times per bucket and round, all on the warp
     route; int8_fused (the gather wire, dequant_accum at w = 4) and
     topk_fused on ``ring`` at the 9437184 bucket, each bit-equal across
     ranks and to the same executor on the CPU (gloo, plain versions),
     one launch per bucket; every algorithm on a (2, 2) mesh, bit-equal
     across ranks and to its CPU schedule; seconds per round, staged
     bytes, a profiled round split into kernels, plain ops, staging copies
     and host; quantize_tiles on every row of the (4, m) hop buffers at
     both buckets' chunk lengths (m = 9216 and 75497472 f32) and
     dequant_accum at w = 4, each held bit-equal to its plain version,
     then timed by graph replay;
 10. the rounds axis: (a) ``repro_torch.launch.train`` at phase 8's full
     width, 4 steps each, with ``--local-sgd 2 --sync comm --compressor
     int8_fused`` (2 parameter rounds, each through the int8_fused wire
     on the params-minus-anchor delta), ``--lag 4`` with int8_fused (a
     probe every step, at least one sync and one reuse) and
     ``--push-pull 2 2`` with topk_fused (2 pushes, 2 dense fetches):
     round counts, step times, peak memory (against the reckoning of 26
     bytes a parameter, checked before the first run) and one profiled
     step with a round split into wire kernels, other device work and
     host; (b) reduced gemma-2b in f32: 4 local-SGD steps with int8_fused
     rounds and 4 LAG steps at θ = 4 (a sync, then reuse steps) agree
     between the card and the CPU (phase 4's tolerance, the same round
     counts, gated as in (a)), and a checkpoint — 2 steps, save,
     load into a fresh session, 2 steps — is bit-equal to the
     uninterrupted 4-step run on the card and restores on the CPU bit for
     bit; (c) 4 spawned ranks (``launch/dist.py:spawn``) on a gloo group on
     the one card, gemma-2b at full width with 1 layer, SGD, local SGD
     τ = 2 with int8_fused rounds on psum (the gather wire,
     dequant_accum at w = 4), global batch 4 x seq 128, 4 steps: before
     each round the ranks' parameters differ and after it they are
     bit-equal (digests of the bits); then, with the card free again,
     quantize_ef (residual written in place) and dequant_accum on a
     (4, n) stack of payloads, at every delta-bucket length of that run,
     each held bit-equal to its plain version;
 11. the communication planner: (a) ``repro_torch.launch.train --sync
     auto --topology commodity_cluster`` at phase 8's full width (Adam,
     batch 4 x seq 512, 3 steps, NCCL world 1): the backward measured on
     the card (``profile_backward``), the search's host time, the winner
     (one of the priced arms) and every bucket, step times, peak memory and
     a profiled step split into wire kernels, other device work and host;
     the executor's plan is the planned one bucket for bucket; (b) 4
     spawned ranks on a gloo group on the one card, gemma-2b at full width
     with 1 layer, SGD, ``plan_auto`` with local SGD τ = 2 on
     ``device:4@fast_ici`` at a pinned 30 ms backward, global batch 4 x seq
     128, 4 steps: every rank's plan digest equal and the plan the port's
     planner makes on the CPU from the same inputs (printed beside it), the
     ranks' parameters different before each round and bit-equal after it;
     then the kernels of each run at its plan's packed bucket lengths (and,
     at world 4, every row of the ring_fused hop buffers), each held
     bit-equal to its plain version.

Every main-path run (5, 7, each of 8, each of 9 on every rank, each of
10 (a) and (c), and each of 11 on every rank) sets every kernel launch
counter
to 0 just before it and reads them just after: each kernel of that run
must have launched exactly as often as the run's structure says, and
every other kernel 0 times.  Serving: quantize_tiles = paged leaves x
(admissions + decode ticks), all on the warp route; flash_attention and
its pre-pass = attention layers x admissions, all of them on the wgmma
route and none on the SIMT one; training: the wire's kernels = buckets x
steps, all on their warp routes (int8_fused: quantize_ef and
dequant_accum; topk_fused: topk_ef; without error feedback, int8_fused:
quantize_tiles and dequant_accum, topk_fused: topk_mask), flash 0 (the
training path keeps the differentiable chunked attention); world 4: as
stated in 9; the rounds axis: the wire's kernels = buckets x the ROUNDS
that run the wire, not x steps — parameter rounds for local SGD
(quantize_ef and dequant_accum on the delta buckets, at world 4 on every
rank), gradient syncs for LAG (quantize_ef and dequant_accum) and
push/pull (topk_ef, push steps only), all on the warp route, and 0 for
every other kernel; the planner: what the executed plan derives bucket by
bucket (``plan_launches``: topk_ef per topk_fused bucket and gradient
sync; per int8_fused bucket and parameter round, quantize_ef once and,
on ring_fused at world 4, quantize_tiles 2·p = 8 times), all on the warp
route, 0 for every other kernel.  Launches made in phases 3, 4, 6 and 10 (b), and by
9's checks and timings, are
not counted.  It prints a ``{"kernels": [...]}``
JSON line with all twelve kernels (launches per run and per route) and,
last, ``{"ok": true, "device": {...}}``.  It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12         # H100 SXM bf16 tensor cores, dense
QUANT_TILES = (64, 256, 1024, 4096)       # 4096: quantize_tiles' block route
QUANT_OPS_PER_ELEMENT = 7       # abs, max, div, mul, round, 2 clamps

SLOTS, MAX_LEN, PAGE = 4, 256, 16
SERVE_ARGS = ["--arch", "gemma-2b", "--no-reduced", "--quantize", "int8",
              "--engine", "continuous", "--batch", str(SLOTS),
              "--requests", "8", "--prompt-len", "128", "--gen", "64",
              "--max-len", str(MAX_LEN), "--page-size", str(PAGE),
              "--seed", "0"]

GEMMA2_SLOTS, GEMMA2_PROMPT, GEMMA2_MAX_LEN = 4, 6144, 8192
GEMMA2_SERVE_ARGS = ["--arch", "gemma2-9b", "--no-reduced", "--quantize",
                     "int8", "--engine", "continuous", "--batch",
                     str(GEMMA2_SLOTS), "--requests", "4", "--prompt-len",
                     str(GEMMA2_PROMPT), "--gen", "32", "--max-len",
                     str(GEMMA2_MAX_LEN), "--page-size", str(PAGE),
                     "--seed", "0"]

# flash attention sweep: the JAX kernel tests' (B, T, H, KV, hd), ragged T,
# hd 256 at G = 2 and 8, grids of 128-row blocks (two consumer warpgroups
# on the wgmma route: B x H x ceil(T / 128) >= the SM count) with ragged T,
# and the variants; then the prefill shapes of the serving path
FLASH_SHAPES = ((1, 128, 2, 2, 32), (2, 256, 4, 2, 64), (1, 128, 8, 1, 32),
                (2, 128, 4, 4, 128), (1, 200, 4, 2, 64), (2, 11, 4, 1, 32),
                (1, 192, 4, 2, 256), (1, 128, 8, 1, 256),
                (1, 1000, 136, 2, 64), (2, 300, 34, 2, 128),
                (1, 520, 48, 8, 256))
FLASH_VARIANTS = ({}, {"window": 64}, {"softcap": 30.0},
                  {"window": 64, "softcap": 20.0}, {"causal": False},
                  {"causal": False, "window": 64})
FLASH_PATH_SHAPES = {   # name: (B, T, H, KV, hd, kwargs)
    "gemma2_9b_prefill_global": (1, GEMMA2_PROMPT, 16, 8, 256,
                                 {"softcap": 50.0}),
    "gemma2_9b_prefill_local": (1, GEMMA2_PROMPT, 16, 8, 256,
                                {"softcap": 50.0, "window": 4096}),
    "gemma_2b_prefill": (1, 128, 8, 1, 256, {}),
}

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 3
TRAIN_ARGS = ["--arch", "gemma-2b", "--no-reduced", "--optimizer", "adam",
              "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
              "--steps", str(TRAIN_STEPS), "--seed", "0", "--log-every", "1"]
NO_EF = ["--no-error-feedback"]
TRAIN_RUNS = {   # run name: (extra CLI flags, kernels each bucket launches)
    "int8_fused": (["--sync", "comm", "--compressor", "int8_fused"],
                   ("quantize_ef", "dequant_accum", "dequant_accum[warp]")),
    "topk_fused": (["--sync", "comm", "--compressor", "topk_fused"],
                   ("topk_ef", "topk_ef[warp]")),
    "int8_fused_no_ef": (["--sync", "comm", "--compressor", "int8_fused",
                          *NO_EF],
                         ("quantize_tiles", "quantize_tiles[warp]",
                          "dequant_accum", "dequant_accum[warp]")),
    "topk_fused_no_ef": (["--sync", "comm", "--compressor", "topk_fused",
                          *NO_EF], ("topk_mask", "topk_mask[warp]")),
    "vanilla": (["--sync", "vanilla"], ()),
}
TILE = 1024
BLOCK_TILE = 2048   # the training wire sweeps' tile on the block routes
EF_SIZES = (1024, 1000, 2065, 4096)
RATIOS = (0.01, 0.05, 0.25)
ITERS = 16
# operations per element, for the bounds (f32, outside the tensor cores)
QEF_OPS = 10          # g + decay*e (2), abs, max, div, mul, round, clamp (2),
#                       residual (2): rounded to 10
TOPK_OPS = 3 + 2 * ITERS      # EF add (2), abs; per round a compare and an add
KERNEL_SOURCES = {
    # the wgmma route, which every serving path takes (bf16, hd 256)
    "flash_attention": ("src/repro_torch/csrc/flash_attention_wgmma.cu",
                        "src/repro/kernels/flash_attention.py:79",
                        "flash_attention_pallas"),
    # the SIMT route (f32; bf16 at other head dims)
    "flash_attention_simt": ("src/repro_torch/csrc/flash_attention.cu",
                             "src/repro/kernels/flash_attention.py:79",
                             "flash_attention_pallas"),
    # the pre-pass of both routes: it stands in for the Pallas kernel's
    # visit of every key tile (the NaN rule), so it replaces a part of it
    "nonfinite_tiles": ("src/repro_torch/csrc/flash_attention.cu",
                       "src/repro/kernels/flash_attention.py:79",
                       "flash_attention_pallas"),
    # the warp route, which every serving write takes (tiles <= 1024)
    "quantize_tiles": ("src/repro_torch/csrc/quantize_tiles.cu",
                       "src/repro/kernels/quantize_ef.py:99",
                       "quantize_pallas"),
    # the block route (tiles > 1024)
    "quantize_tiles_block": ("src/repro_torch/csrc/quantize_tiles.cu",
                             "src/repro/kernels/quantize_ef.py:99",
                             "quantize_pallas"),
    "quantize_ef": ("src/repro_torch/csrc/quantize_ef.cu",
                    "src/repro/kernels/quantize_ef.py:63",
                    "quantize_ef_pallas"),
    # the warp route, which the int8_fused wire takes (tile 1024)
    "dequant_accum": ("src/repro_torch/csrc/quantize_ef.cu",
                      "src/repro/kernels/quantize_ef.py:126",
                      "dequant_accum_pallas"),
    # the block route (tiles 1025 to 8192)
    "dequant_accum_block": ("src/repro_torch/csrc/quantize_ef.cu",
                            "src/repro/kernels/quantize_ef.py:126",
                            "dequant_accum_pallas"),
    # the warp route, which the topk_fused wire takes (tile 1024)
    "topk_ef": ("src/repro_torch/csrc/topk_mask.cu",
                "src/repro/kernels/topk_mask.py:99", "topk_ef_pallas"),
    # the block route (tiles 1025 to 8192)
    "topk_ef_block": ("src/repro_torch/csrc/topk_mask.cu",
                      "src/repro/kernels/topk_mask.py:99", "topk_ef_pallas"),
    # the warp route, which the topk_fused wire without error feedback
    # takes (tile 1024)
    "topk_mask": ("src/repro_torch/csrc/topk_mask.cu",
                  "src/repro/kernels/topk_mask.py:65", "topk_mask_pallas"),
    # the block route (tiles 1025 to 8192)
    "topk_mask_block": ("src/repro_torch/csrc/topk_mask.cu",
                        "src/repro/kernels/topk_mask.py:65",
                        "topk_mask_pallas"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def sweep_input(torch, n: int, tile: int, dtype, device):
    """Gaussian values, an all-zero first tile (when there are two or more
    tiles) and exact-half rounding values in the last tile."""
    g = torch.Generator(device).manual_seed(n * 31 + tile)
    x = torch.randn(n, generator=g, device=device) * 3.0
    if n >= 2 * tile:
        x[:tile] = 0.0
    start = (n - 1) // tile * tile
    k = min(n - start, 64)
    if k >= 2:
        x[start] = 127.0
        x[start + 1:start + k] = torch.arange(1, k, device=device) - 32 + 0.5
    return x.to(dtype)


def same(torch, a, b) -> bool:
    """Equal shapes, types and values, with NaN equal to NaN at the same
    places (the payload bits of a NaN may differ between devices)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


def max_err(torch, a, b) -> float:
    """max |a - b| over entries that are not NaN on both sides."""
    d = (a.double() - b.double()).abs()
    d = d[~(torch.isnan(a) & torch.isnan(b))]
    return float(d.max().item()) if d.numel() else 0.0


def ef_inputs(torch, n: int, seed: int, nan: bool, device):
    """g: Gaussian with an all-zero first tile and exact halves in the
    last (as sweep_input); e: a smaller Gaussian, zero on those tiles; a
    NaN in the second tile when ``nan``."""
    gen = torch.Generator(device).manual_seed(seed)
    g = sweep_input(torch, n, TILE, torch.float32, device)
    e = torch.randn(n, generator=gen, device=device) * 0.5
    if n >= 2 * TILE:
        e[:TILE] = 0.0
    e[(n - 1) // TILE * TILE:] = 0.0
    if nan:
        g[TILE + 5] = float("nan")
    return g, e


def _median_ms(torch, run, reps: int, inner: int) -> float:
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    times.sort()
    return times[len(times) // 2]


def call_ms(torch, fn, reps: int = 25, inner: int = 20) -> float:
    """Per-call time of ``inner`` back-to-back eager calls (median of
    ``reps``, CUDA events, after a warm-up): includes the host's launch
    cost whenever the host is slower than the device."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(inner):
            fn()
    return _median_ms(torch, run, reps, inner)


def events_ms(torch, fn, reps: int = 5) -> float:
    """Device time per call of a long-running call (milliseconds each, at
    the largest bucket): CUDA events around single eager calls, median of
    ``reps`` after a warm-up; the host's launch cost is hidden by the
    call's length."""
    fn()
    torch.cuda.synchronize()
    return _median_ms(torch, fn, reps, 1)


def loop_ms(torch, fn) -> float:
    """Device time per call of a call of a millisecond or more, whose host
    work (allocation, tensor maps, launches) would show in the time of a
    single eager call: CUDA events around 5 back-to-back calls, median of
    5 after a warm-up."""
    return call_ms(torch, fn, reps=5, inner=5)


def device_ms(torch, fn, reps: int = 25, inner: int = 20) -> float:
    """Device time per call: ``inner`` calls captured in one CUDA graph and
    replayed (median of ``reps``), so no host launch cost is counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _median_ms(torch, graph.replay, reps, inner)


def quantize_bound_ms(n: int, tile: int, in_bytes: int):
    """Least time for the quantize on the card: bytes moved (input read
    once, q and scales written once) over the HBM rate, or operations over
    the f32 rate, whichever is larger."""
    nbytes = n * in_bytes + n + 4 * (-(-n // tile))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n * QUANT_OPS_PER_ELEMENT / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def quantize_timing(torch, ref, quantize_tiles_cuda, n: int, tile: int):
    """Kernel, plain-version and bound times of quantize_tiles on n bf16
    values, in turns (plain, kernel, kernel, plain) within this call; the
    kernel through its wrapper, which allocates q and scales per call;
    10^8 elements and more with CUDA events around single calls, the rest
    in CUDA graphs."""
    x = torch.randn(n, device="cuda").to(torch.bfloat16)

    def kern():
        return quantize_tiles_cuda(x, tile)

    def plain():
        return ref.quantize_tiles_ref(x, tile=tile)
    timer = events_ms if n >= 1 << 26 else device_ms
    p0, k0 = timer(torch, plain), timer(torch, kern)
    k1, p1 = timer(torch, kern), timer(torch, plain)
    b_ms, by = quantize_bound_ms(n, tile, 2)
    out = {"n": n, "tile": tile, "dtype": "bfloat16",
           "ms": min(k0, k1), "plain_ms": min(p0, p1),
           "call_ms": call_ms(torch, kern),
           "plain_call_ms": call_ms(torch, plain),
           "bound_ms": b_ms, "bound_by": by, "library_ms": None,
           "timer": ("cuda events, eager" if timer is events_ms
                     else "cuda graph")}
    del x
    torch.cuda.empty_cache()
    return out


def phase_kernels(torch, ops, ref, quantize_tiles_cuda, path_shapes):
    """quantize_tiles against its plain version, bit-equal, over the sweep
    (QUANT_TILES, both routes) and every length the serving pools write,
    each launch on the route of its tile; then times at the path shapes
    (the warp route) and, at the gemma2-9b ring write's length, of the
    block route at tile 4096.  Returns (worst |kernel - plain|, warp-route
    timings, block-route timings)."""
    from repro_torch.kernels.dispatch import tile_route
    dev = torch.device("cuda")
    worst = 0.0
    cases = 0
    for tile in QUANT_TILES:
        route = tile_route(tile)
        sizes = {tile, 3 * tile + 17, 18 * 4 * 256, 18 * 128 * 256}
        sizes |= {n for n, t in path_shapes.values() if t == tile}
        for n in sorted(sizes):
            for dtype in (torch.float32, torch.bfloat16):
                for nan in ((False, True) if n >= 3 * tile else (False,)):
                    x = sweep_input(torch, n, tile, dtype, dev)
                    if nan:       # a NaN tile: NaN scale, int8 codes 0
                        x[tile + 3] = float("nan")
                    r0 = ops.route_counts()["quantize_tiles"][route]
                    qk, sk = ops.quantize_tiles(x, tile=tile)
                    qp, sp = ref.quantize_tiles_ref(x, tile=tile)
                    torch.cuda.synchronize()
                    if ops.route_counts()["quantize_tiles"][route] != r0 + 1:
                        fail(f"quantize_tiles at tile {tile} did not take "
                             f"the {route} route")
                    err = max(max_err(torch, qk, qp), max_err(torch, sk, sp))
                    worst = max(worst, err)
                    if not (same(torch, qk, qp) and same(torch, sk, sp)):
                        fail(f"quantize_tiles differs from the plain version "
                             f"at n={n} tile={tile} {dtype} nan={nan}: max "
                             f"err {err}")
                    cases += 1
                    if nan:
                        if not (torch.isnan(sk[1]) and
                                not qk[tile:2 * tile].any()):
                            fail("quantize_tiles: the NaN tile's scale is "
                                 "not NaN or its codes are not 0")
                        continue
                    deq = ops.dequantize(qk, sk, tile=tile)
                    # s/254 from rounding to nearest, plus f32 rounding of
                    # (x / s) * 127 and of q * (s / 127): a few ulp of s
                    srep = torch.repeat_interleave(sk, tile)[:n]
                    bound = srep / 254.0 + srep * 2.0 ** -20
                    if not (x.float() - deq).abs().le(bound).all():
                        fail(f"dequantize round trip beyond s/254 at n={n} "
                             f"tile={tile} {dtype}")
    print(f"kernels: quantize_tiles bit-equal to the plain version in "
          f"{cases} cases (tiles {QUANT_TILES}: the warp route up to 1024, "
          f"the block route above; f32 and bf16, zero tiles, exact halves, "
          f"NaN tiles), each on its tile's route; dequantize within s/254",
          flush=True)
    timings = {name: quantize_timing(torch, ref, quantize_tiles_cuda, n,
                                     tile)
               for name, (n, tile) in path_shapes.items()}
    ring = "gemma2_9b_prefill_write_4096"
    block = {f"{ring}_tile4096": quantize_timing(
        torch, ref, quantize_tiles_cuda, path_shapes[ring][0], 4096)}
    return worst, timings, block


def quantize_path_shapes(arch: str, slots: int, max_len: int,
                         page: int) -> dict:
    """{name: (n, tile)}: the flat lengths that the int8 pool of ``arch``'s
    serving run (``slots`` x ``max_len``, pages of ``page``) hands
    ``quantize_tiles``, from the pool's own leaf layout.  An admission
    writes one slot's whole row of each paged leaf (repeats x length x KV
    x hd), a decode tick one entry per slot (repeats x slots x KV x hd);
    the tile is hd.  Leaves of equal lengths share a name."""
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.transformer import CacheLeafMeta
    from repro_torch.serve.kv_cache import PagedDecodeCache
    cache = PagedDecodeCache(Model(get_config(arch)), slots, max_len, page,
                             quantize="int8", build_pool=False)
    leaves = []
    tree_map(lambda m, s: leaves.append((m, s.shape)), cache.meta,
             cache.specs, is_leaf=lambda x: isinstance(x, CacheLeafMeta))
    paged = [(m, shape) for m, shape in leaves if m.kind == "paged"]
    lengths = sorted({m.length for m, _ in paged})
    tag = arch.replace("-", "_")
    out = {}
    for m, shape in paged:
        numel, tile = math.prod(shape), shape[-1]
        out[f"{tag}_decode_write"] = (numel // m.length, tile)
        name = f"{tag}_prefill_write"
        if len(lengths) > 1:
            name += f"_{m.length}"
        out[name] = (numel // slots, tile)
    return out


def phase_train_kernels(torch, ops, ref) -> dict:
    """The training wire's four kernels against their plain versions on
    the card, bit-equal (NaN for NaN) over the CPU tests' cases plus the
    largest bucket's length rounded to a ragged size; dequant_accum and
    the top-k kernels at tile 1024 and at BLOCK_TILE, each launch checked
    on the route of its tile.  Returns the worst |kernel - plain| per
    kernel (0.0 when every case is bit-equal)."""
    from repro_torch.kernels.dispatch import tile_route
    dev = torch.device("cuda")
    worst = {k: 0.0 for k in ("quantize_ef", "dequant_accum", "topk_ef",
                              "topk_mask")}
    cases = {k: 0 for k in worst}

    def check(name, got, want, what):
        err = max(max_err(torch, a, b) for a, b in zip(got, want))
        worst[name] = max(worst[name], err)
        cases[name] += 1
        if not all(same(torch, a, b) for a, b in zip(got, want)):
            fail(f"{name} differs from the plain version at {what}: max err "
                 f"{err}")

    def routed(name, tile, call):
        """``call()``, which must launch ``name`` once on tile's route."""
        route = tile_route(tile)
        r0 = ops.route_counts()[name][route]
        out = call()
        if ops.route_counts()[name][route] != r0 + 1:
            fail(f"{name} at tile {tile} did not take the {route} route")
        return out

    for n in EF_SIZES + (3 * 2**20 + 17,):
        for nan in ((False, True) if n >= 2 * TILE else (False,)):
            g, e = ef_inputs(torch, n, seed=n, nan=nan, device=dev)
            for decay in (1.0, 0.9):
                what = f"n={n} decay={decay} nan={nan}"
                got = ops.quantize_ef(g, e, decay=decay, tile=TILE)
                want = ref.quantize_ef_ref(g, e, decay=decay, tile=TILE)
                torch.cuda.synchronize()
                check("quantize_ef", got, want, what)
                for tile in (TILE, BLOCK_TILE):
                    q, _, sc = ref.quantize_ef_ref(g, e, decay=decay,
                                                   tile=tile)
                    for w in (1, 2, 4, 8):
                        qw = torch.stack([q.roll(r) for r in range(w)])
                        sw = torch.stack([sc * (1 + r) for r in range(w)])
                        got = (routed("dequant_accum", tile,
                                      lambda: ops.dequant_accum(
                                          qw, sw, tile=tile)),)
                        want = (ref.dequant_accum_ref(qw, sw, tile=tile),)
                        torch.cuda.synchronize()
                        check("dequant_accum", got, want,
                              f"{what} w={w} tile={tile}")
                for ratio in RATIOS:
                    for tile in (TILE, BLOCK_TILE):
                        got = routed("topk_ef", tile, lambda: ops.topk_ef(
                            g, e, ratio=ratio, tile=tile, iters=ITERS,
                            decay=decay))
                        want = ref.topk_ef_ref(g, e, ratio=ratio, tile=tile,
                                               iters=ITERS, decay=decay)
                        torch.cuda.synchronize()
                        check("topk_ef", got, want,
                              f"{what} ratio={ratio} tile={tile}")
            for ratio in RATIOS:
                for dtype in (torch.float32, torch.bfloat16):
                    for tile in (TILE, BLOCK_TILE):
                        x = g.to(dtype)
                        got = (routed("topk_mask", tile, lambda: ops.topk_mask(
                            x, ratio=ratio, tile=tile, iters=ITERS)),)
                        want = (ref.topk_mask_bisect_ref(
                            x, ratio=ratio, tile=tile, iters=ITERS),)
                        torch.cuda.synchronize()
                        check("topk_mask", got, want,
                              f"n={n} nan={nan} ratio={ratio} {dtype} "
                              f"tile={tile}")
    print(f"kernels: training wire bit-equal to the plain versions "
          f"(NaN for NaN) in {cases} cases (lengths {EF_SIZES} and "
          f"{3 * 2**20 + 17}, decays 1.0/0.9, ratios {RATIOS}, ranks "
          f"1/2/4/8, zero tiles, exact halves, NaN tiles, topk_mask f32 and "
          f"bf16; dequant_accum and top-k at tiles {TILE} and {BLOCK_TILE}: "
          f"their warp and block routes)", flush=True)
    return worst


def train_bucket_sizes(cfg):
    """Element counts of the training path's buckets (the 32 MiB fusion
    rule over gemma-2b's parameter leaves), in sync order."""
    from repro_torch.core.schedule.planner import form_bucket_indices
    from repro_torch.models import Model
    from repro_torch.models.layers import desc_leaves
    sizes = [math.prod(d.shape) for d in desc_leaves(Model(cfg).param_desc())]
    return [sum(sizes[i] for i in b)
            for b in form_bucket_indices([4 * s for s in sizes], 32 * 2**20)]


def bound(nbytes: float, ops_: float):
    """(least time in ms, what bounds it) for moving ``nbytes`` at the HBM
    rate and doing ``ops_`` f32 operations at the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def train_path_kernels(torch, ops, ref, buckets, timed) -> dict:
    """The training-wire kernels at every bucket length of the training
    path, called through their wrappers as the path calls them:
    quantize_ef and topk_ef (ratio 0.01, decay 1.0) write the new residual
    into e's buffer, dequant_accum decodes one rank's quantize_ef payload
    (world 1), and quantize_tiles and topk_mask encode the same bucket
    without error feedback.  Each result is held bit-equal (NaN for NaN)
    to the plain version on the same inputs.  Then, at the lengths named
    in ``timed``, kernel, plain-version and bound times in turns (plain,
    kernel, kernel, plain): long calls with CUDA events, short ones by
    CUDA-graph replay; the routes at their tiles (1024: warp, BLOCK_TILE:
    block), dequant_accum also at 4 ranks and topk_mask also in bf16.
    Returns {kernel: {shape name: timing dict}}."""
    from repro_torch.kernels.quantize import quantize_tiles_cuda
    from repro_torch.kernels.quantize_ef import (dequant_accum_cuda,
                                                 quantize_ef_cuda)
    from repro_torch.kernels.topk_mask import topk_ef_cuda, topk_mask_cuda
    dev = torch.device("cuda")
    k = max(1, int(TILE * 0.01))
    k_block = max(1, int(BLOCK_TILE * 0.01))
    out = {name: {} for name in (
        "quantize_tiles", "quantize_ef", "dequant_accum",
        "dequant_accum_block", "topk_ef", "topk_ef_block", "topk_mask",
        "topk_mask_block")}
    shape_of = {n: name for name, n in timed.items()}

    def check(name, got, want, n):
        torch.cuda.synchronize()
        if not all(same(torch, a, b) for a, b in zip(got, want)):
            err = max(max_err(torch, a, b) for a, b in zip(got, want))
            fail(f"{name} differs from the plain version at the training "
                 f"path's bucket length n={n}: max err {err}")

    for n in sorted(set(buckets)):
        gen = torch.Generator(dev).manual_seed(n)
        g = torch.randn(n, generator=gen, device=dev)
        e = torch.randn(n, generator=gen, device=dev) * 0.1
        buf = e.clone()
        want = ref.quantize_ef_ref(g, e, tile=TILE)
        got = ops.quantize_ef(g, buf, tile=TILE, e_out=buf)
        check("quantize_ef", got, want, n)
        q1, s1 = got[0][None], got[2][None]
        del want, got
        check("dequant_accum", (ops.dequant_accum(q1, s1, tile=TILE),),
              (ref.dequant_accum_ref(q1, s1, tile=TILE),), n)
        buf.copy_(e)
        want = ref.topk_ef_ref(g, e, tile=TILE)
        got = ops.topk_ef(g, buf, tile=TILE, e_out=buf)
        check("topk_ef", got, want, n)
        del want, got
        check("quantize_tiles", ops.quantize_tiles(g, tile=TILE),
              ref.quantize_tiles_ref(g, tile=TILE), n)
        check("topk_mask", (ops.topk_mask(g, tile=TILE),),
              (ref.topk_mask_bisect_ref(g, tile=TILE),), n)
        shape = shape_of.get(n)
        if shape is None:
            del g, e, buf, q1, s1
            torch.cuda.empty_cache()
            continue
        nt, ntb = -(-n // TILE), -(-n // BLOCK_TILE)
        g16 = g.to(torch.bfloat16)
        q4 = q1.repeat(4, 1)
        s4 = torch.cat([s1 * (1 + r) for r in range(4)])
        qb, sb = quantize_tiles_cuda(g, BLOCK_TILE)
        q1b, s1b = qb[None], sb[None]
        q4b = q1b.repeat(4, 1)
        s4b = torch.cat([s1b * (1 + r) for r in range(4)])
        del qb, sb

        def accum_bound(w, ntiles):
            return bound(w * n + 4 * w * ntiles + 4 * n, 2 * w * n)

        # (kernel, shape, tile, dtype, kernel call, plain call, bound)
        cases = [
            ("quantize_tiles", shape, TILE, "float32",
             lambda: quantize_tiles_cuda(g, TILE),
             lambda: ref.quantize_tiles_ref(g, tile=TILE),
             bound(5 * n + 4 * nt, QUANT_OPS_PER_ELEMENT * n)),
            ("quantize_ef", shape, TILE, "float32",
             lambda: quantize_ef_cuda(g, buf, 1.0, TILE, buf),
             lambda: ref.quantize_ef_ref(g, e, tile=TILE),
             bound(13 * n + 4 * nt, QEF_OPS * n)),
            ("dequant_accum", shape, TILE, "float32",
             lambda: dequant_accum_cuda(q1, s1, TILE),
             lambda: ref.dequant_accum_ref(q1, s1, tile=TILE),
             accum_bound(1, nt)),
            ("dequant_accum", f"{shape}_w4", TILE, "float32",
             lambda: dequant_accum_cuda(q4, s4, TILE),
             lambda: ref.dequant_accum_ref(q4, s4, tile=TILE),
             accum_bound(4, nt)),
            ("dequant_accum_block", shape, BLOCK_TILE, "float32",
             lambda: dequant_accum_cuda(q1b, s1b, BLOCK_TILE),
             lambda: ref.dequant_accum_ref(q1b, s1b, tile=BLOCK_TILE),
             accum_bound(1, ntb)),
            ("dequant_accum_block", f"{shape}_w4", BLOCK_TILE, "float32",
             lambda: dequant_accum_cuda(q4b, s4b, BLOCK_TILE),
             lambda: ref.dequant_accum_ref(q4b, s4b, tile=BLOCK_TILE),
             accum_bound(4, ntb)),
            ("topk_ef", shape, TILE, "float32",
             lambda: topk_ef_cuda(g, buf, k, TILE, ITERS, 1.0, buf),
             lambda: ref.topk_ef_ref(g, e, tile=TILE),
             bound(16 * n, TOPK_OPS * n)),
            ("topk_ef_block", shape, BLOCK_TILE, "float32",
             lambda: topk_ef_cuda(g, buf, k_block, BLOCK_TILE, ITERS, 1.0,
                                  buf),
             lambda: ref.topk_ef_ref(g, e, tile=BLOCK_TILE),
             bound(16 * n, TOPK_OPS * n)),
        ]
        for x, suffix in ((g, ""), (g16, "_bf16")):
            nbytes = 2 * x.element_size() * n
            cases += [
                ("topk_mask", shape + suffix, TILE, str(x.dtype)[6:],
                 lambda x=x: topk_mask_cuda(x, k, TILE, ITERS),
                 lambda x=x: ref.topk_mask_bisect_ref(x, tile=TILE),
                 bound(nbytes, (1 + 2 * ITERS) * n)),
                ("topk_mask_block", shape + suffix, BLOCK_TILE,
                 str(x.dtype)[6:],
                 lambda x=x: topk_mask_cuda(x, k_block, BLOCK_TILE, ITERS),
                 lambda x=x: ref.topk_mask_bisect_ref(x, tile=BLOCK_TILE),
                 bound(nbytes, (1 + 2 * ITERS) * n))]
        big = n > 2**24
        timer = events_ms if big else device_ms
        for name, key, tile, dtype, kern, plain, (b_ms, by) in cases:
            p0, k0 = timer(torch, plain), timer(torch, kern)
            k1, p1 = timer(torch, kern), timer(torch, plain)
            out[name][key] = {
                "n": n, "dtype": dtype, "tile": tile,
                "ms": min(k0, k1), "plain_ms": min(p0, p1),
                "bound_ms": b_ms, "bound_by": by, "library_ms": None,
                "timer": "cuda events, eager" if big else "cuda graph"}
            torch.cuda.synchronize()
        del g, e, buf, q1, s1, g16, q4, s4, q1b, s1b, q4b, s4b, cases
        torch.cuda.empty_cache()
    print(f"kernels: training wire bit-equal to the plain versions at every "
          f"bucket length of the training path {sorted(set(buckets))} "
          f"(residual written in place, dequant_accum at w=1, "
          f"quantize_tiles and topk_mask as the encode without error "
          f"feedback)", flush=True)
    return out


def bf16_ulp(torch, x):
    """The bfloat16 ulp at |x|, 2^(floor(log2 |x|) - 7), and 0 at 0."""
    _, e = torch.frexp(x.abs())
    return torch.where(x != 0, torch.exp2((e - 8).float()), 0.0)


def flash_close(torch, got, want):
    """(ok, max |got - want|, worst |got - want| / tolerance) of the flash
    kernel against its plain version, element by element.  f32: rtol =
    atol = 1e-5 (the same sums in another order).  bf16: 2 bf16 ulps of
    the element plus 2 of its row's largest magnitude (the row is one
    query and head over hd): p is rounded to bf16 at another running max,
    which moves an output by a few 2^-9 of the row's weighted |v|, and the
    output's own rounding can flip by an ulp."""
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        return False, float("inf"), float("inf")
    if not bool(torch.isfinite(g).all()):
        return False, float("inf"), float("inf")
    d = (g - w).abs()
    if got.dtype == torch.float32:
        tol = 1e-5 + 1e-5 * w.abs()
    else:
        row = w.abs().amax(dim=-1, keepdim=True)
        tol = 2 * bf16_ulp(torch, w) + 2 * bf16_ulp(torch, row)
    share = torch.where(d > 0, d / tol, 0.0).max().item()
    return share <= 1.0, d.max().item(), share


def attention_pairs(T: int, S: int, causal: bool, window) -> int:
    """Unmasked (query, key) pairs of one head and batch row: the work the
    mask leaves (queries and keys at positions 0 … T-1 and 0 … S-1)."""
    qp = np.arange(T, dtype=np.int64)
    lo = np.maximum(0, qp - window + 1) if window else np.zeros_like(qp)
    if causal:
        hi = np.minimum(S - 1, qp)
    elif window:
        hi = np.minimum(S - 1, qp + window - 1)
    else:
        hi = np.full_like(qp, S - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_bound(B, T, S, H, KV, hd, elt_bytes, kw):
    """(least time in ms, what bounds it, operations, bytes): q, k, v read
    once and out written once at the HBM rate, against 4·B·H·hd
    operations per unmasked pair (two products) at the bf16 tensor-core
    rate for bf16 inputs (their products are exact in f32) or the f32
    rate."""
    nbytes = elt_bytes * (2 * B * T * H * hd + 2 * B * S * KV * hd)
    n_ops = 4 * B * H * hd * attention_pairs(T, S, kw.get("causal", True),
                                             kw.get("window"))
    rate = BF16_OPS_PER_S if elt_bytes == 2 else F32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / rate * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, n_ops, nbytes


def flex_library(torch, q, k, v, window, softcap):
    """One PyTorch call computing the flash kernel's causal function with
    a logit softcap: ``flex_attention`` compiled by ``torch.compile``,
    with the softcap as its ``score_mod``, the causal (and window) mask as
    its block mask, and GQA.  Timed here only; the port never calls it."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    T, S = q.shape[1], k.shape[1]

    def mask_mod(b, h, qi, ki):
        keep = ki <= qi
        return keep if window is None else keep & (qi - ki < window)

    def score_mod(score, b, h, qi, ki):
        return softcap * torch.tanh(score / softcap)
    mask = create_block_mask(mask_mod, None, None, T, S, device=q.device)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    compiled = torch.compile(flex_attention, dynamic=False)

    def library():
        return compiled(qt, kt, vt, score_mod=score_mod, block_mask=mask,
                        enable_gqa=True).transpose(1, 2)
    return library


def flash_inputs(torch, B, T, S, H, KV, hd, dtype, seed):
    """Gaussian q (B, T, H, hd), k and v (B, S, KV, hd) on the card."""
    gen = torch.Generator("cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype)
                 for shape in ((B, T, H, hd), (B, S, KV, hd),
                               (B, S, KV, hd)))


def nan_rule_check(torch, ops, ref, flash_cuda, tiles_cuda):
    """The NaN rule on the card, both routes (f32 and bf16 through the
    wrapper, and bf16 forced onto the SIMT kernel): v holds an inf, a NaN
    and a -inf at keys that query tiles skip; the kernel's NaN places must
    be the plain version's, and the rest within :func:`flash_close`.  The
    pre-pass is held bit-equal to its plain version on the same v.
    Returns the number of cases."""
    cases = 0
    for dtype, kernel in ((torch.float32, "simt"),
                          (torch.bfloat16, "wgmma"),
                          (torch.bfloat16, "simt")):
        for kw in ({"window": 64}, {}, {"causal": False, "window": 64},
                   {"window": 64, "softcap": 30.0}):
            q, k, v = flash_inputs(torch, 1, 330, 330, 4, 2, 64, dtype, 3)
            v[0, 0, 0, 1] = float("inf")       # skipped from row 128 on
            v[0, 250, 1, 5] = float("nan")     # skipped by rows < 192
            v[0, 70, 0, 7] = float("-inf")
            tiles = tiles_cuda(v)
            want_tiles = ref.nonfinite_tiles_ref(v)
            got = flash_cuda(q, k, v, tiles, kw.get("causal", True),
                             kw.get("window"), kw.get("softcap"), kernel)
            want = ref.flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            what = f"{dtype} {kernel} {kw}"
            if not torch.equal(tiles, want_tiles):
                fail(f"nonfinite_tiles differs from the plain version at "
                     f"{what}")
            nan, inf = torch.isnan(want), torch.isinf(want)
            if not (nan.any() and torch.equal(torch.isnan(got), nan)
                    and torch.equal(got[inf], want[inf])):
                fail(f"flash_attention NaN rule broken at {what}: "
                     f"{int(torch.isnan(got).sum())} NaN, plain "
                     f"{int(nan.sum())}")
            ok, err, share = flash_close(torch, got.masked_fill(nan | inf, 0),
                                         want.masked_fill(nan | inf, 0))
            if not ok:
                fail(f"flash_attention differs from the plain version off "
                     f"the non-finite places at {what}: max err {err}, "
                     f"{share:.3f} of the tolerance")
            cases += 1
    return cases


def time_turns(torch, timer, plain, kerns):
    """Plain and kernel times in turns (plain, kernels, kernels reversed,
    plain) within this call: (min plain ms, [min ms of each kernel])."""
    p0 = timer(torch, plain)
    first = [timer(torch, k) for k in kerns]
    second = [timer(torch, k) for k in reversed(kerns)][::-1]
    p1 = timer(torch, plain)
    return min(p0, p1), [min(a, b) for a, b in zip(first, second)]


# the SIMT flash kernel (bf16) at the gemma2-9b prefill when it was the only
# route, ms on an H100 80GB HBM3 at 700 W (PERF.md, kernel table): the wgmma
# route must be 5x faster
SIMT_RECORDED_MS = {"gemma2_9b_prefill_global": 17.812799,
                 "gemma2_9b_prefill_local": 14.631296}


def check_flash_gates(timings) -> None:
    """The wgmma route (pre-pass included) is no slower than the library
    call at every path shape that has one, and at least 5x faster than
    the SIMT kernel's recorded time at the gemma2-9b prefill."""
    for name, t in timings.items():
        lib = t["library_ms"]
        if lib is not None and t["ms"] > lib:
            fail(f"flash_attention wgmma at {name}: {t['ms']:.4f} ms, slower "
                 f"than the library call ({lib:.4f} ms)")
        if name in SIMT_RECORDED_MS and 5 * t["ms"] > SIMT_RECORDED_MS[name]:
            fail(f"flash_attention wgmma at {name}: {t['ms']:.4f} ms, not 5x "
                 f"faster than the SIMT kernel's recorded "
                 f"{SIMT_RECORDED_MS[name]} ms")
    print("flash gates: the wgmma route is no slower than the library call "
          "at " + ", ".join(f"{n} ({t['ms'] * 1e3:.3f} vs "
                            f"{t['library_ms'] * 1e3:.3f} us)"
                            for n, t in timings.items()
                            if t["library_ms"] is not None)
          + "; at least 5x faster than the SIMT kernel's recorded time at "
          + ", ".join(
              f"{n} ({SIMT_RECORDED_MS[n] / timings[n]['ms']:.2f}x)"
              for n in SIMT_RECORDED_MS), flush=True)


# the one-block-per-tile kernels at the shapes that the warp route now
# takes, when they were the only route, ms on an H100 80GB HBM3 at 700 W
# (PERF.md, kernel table): (recorded ms, the factor by which the warp
# route must be faster)
BLOCK_RECORDED_MS = {
    ("topk_ef", "largest_bucket"): (8.224832, 2.0),
    ("topk_mask", "largest_bucket"): (8.143840, 3.0),
    ("dequant_accum", "largest_bucket"): (1.802720, 1.4),
    ("quantize_tiles", "gemma2_9b_prefill_write_4096"): (1.186592, 3.0),
    ("quantize_tiles", "gemma2_9b_prefill_write_8192"): (2.311680, 3.0)}


def check_tile_gates(timings) -> None:
    """The warp routes of the tile kernels against the block kernels'
    recorded times (``BLOCK_RECORDED_MS``); ``timings`` maps kernel ->
    shape -> timing dict."""
    for (kernel, shape), (recorded, factor) in BLOCK_RECORDED_MS.items():
        ms = timings[kernel][shape]["ms"]
        if factor * ms > recorded:
            fail(f"{kernel} warp route at {shape}: {ms:.6f} ms, not "
                 f"{factor}x faster than the block kernel's recorded "
                 f"{recorded} ms")
    print("tile gates: the warp route is faster than the block kernel's "
          "recorded time by " + ", ".join(
              f"{recorded / timings[k][sh]['ms']:.2f}x (at least {f}x) for "
              f"{k} at {sh}"
              for (k, sh), (recorded, f) in BLOCK_RECORDED_MS.items()),
          flush=True)


def phase_flash(torch, ops, ref, flash_cuda, tiles_cuda):
    """The flash kernels against their plain version on the card, within
    :func:`flash_close`, over FLASH_SHAPES x f32/bf16 x FLASH_VARIANTS
    (bf16 takes the wgmma route, f32 the SIMT one), rows with no valid key
    in both, the NaN rule, and the path shapes in f32 and bf16; then times
    at the path shapes (bf16, in turns): the wgmma route through its
    wrapper call (pre-pass included), the SIMT kernel on the same inputs,
    the pre-pass alone, the plain version and the library call.  Returns
    (worst |kernel - plain|, {route: timings}, pre-pass timings)."""
    import torch.nn.functional as F
    worst = {torch.float32: (0.0, 0.0), torch.bfloat16: (0.0, 0.0)}
    cases = 0
    ops.reset_launch_counts()

    def check(q, k, v, kw, what):
        nonlocal cases
        got = ops.flash_attention(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        ok, err, share = flash_close(torch, got, want)
        e0, s0 = worst[q.dtype]
        worst[q.dtype] = (max(e0, err), max(s0, share))
        cases += 1
        if not ok:
            fail(f"flash_attention differs from the plain version at {what}: "
                 f"max err {err}, {share:.3f} of the tolerance")
        return err, share

    for i, (B, T, H, KV, hd) in enumerate(FLASH_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            for j, kw in enumerate(FLASH_VARIANTS):
                q, k, v = flash_inputs(torch, B, T, T, H, KV, hd, dtype,
                                       100 * i + j)
                check(q, k, v, kw, f"{(B, T, H, KV, hd)} {dtype} {kw}")
    for dtype in (torch.float32, torch.bfloat16):   # rows with no key
        for causal in (True, False):
            kw = {"causal": causal, "window": 20}
            q, k, v = flash_inputs(torch, 1, 150, 40, 2, 1, 32, dtype, 7)
            check(q, k, v, kw, f"T=150 S=40 {dtype} {kw}")
    routes = ops.route_counts()["flash_attention"]
    n_bf16 = (len(FLASH_SHAPES) * len(FLASH_VARIANTS) + 2)
    if routes != {"wgmma": n_bf16, "simt": cases - n_bf16}:
        fail(f"flash routes {routes}: bf16 cases must take the wgmma "
             f"kernel ({n_bf16}) and f32 ones the SIMT kernel "
             f"({cases - n_bf16})")
    nan_cases = nan_rule_check(torch, ops, ref, flash_cuda, tiles_cuda)
    print(f"kernels: flash NaN rule held on both routes in {nan_cases} cases "
          f"(NaN exactly where the plain version has NaN; pre-pass "
          f"bit-equal)", flush=True)

    timings = {"wgmma": {}, "simt": {}}
    tiles_timings = {}
    for name, (B, T, H, KV, hd, kw) in FLASH_PATH_SHAPES.items():
        held = {}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(torch, B, T, T, H, KV, hd, dtype, T + H)
            held[str(dtype).split(".")[-1]] = check(
                q, k, v, kw, f"the path shape {name} {dtype}")
        print(f"flash_attention {name} {[B, T, H, KV, hd]} {kw}: max |Δ| "
              f"{held['float32'][0]:.3e} in f32 ({held['float32'][1]:.4f} of "
              f"its tolerance), {held['bfloat16'][0]:.3e} in bf16 "
              f"({held['bfloat16'][1]:.4f} of its tolerance)", flush=True)
        causal, window = kw.get("causal", True), kw.get("window")
        softcap = kw.get("softcap")
        # q, k, v: the bf16 inputs, timed from here
        simt_ok = flash_close(torch, flash_cuda(q, k, v, tiles_cuda(v), causal,
                                                window, softcap, "simt"),
                              ref.flash_attention_ref(q, k, v, **kw))
        if not simt_ok[0]:
            fail(f"the SIMT kernel differs from the plain version at {name} "
                 f"bf16: max err {simt_ok[1]}")
        if not torch.equal(tiles_cuda(v), ref.nonfinite_tiles_ref(v)):
            fail(f"nonfinite_tiles differs from the plain version at {name}")

        def wgmma():          # the wrapper's call: pre-pass + kernel
            return flash_cuda(q, k, v, tiles_cuda(v), causal, window,
                              softcap, "wgmma")

        def simt():
            return flash_cuda(q, k, v, tiles_cuda(v), causal, window,
                              softcap, "simt")

        # the pre-pass reads a v that is not in L2, as after the prefill's
        # projections of other layers: 4 copies of v, one per launch in
        # turn (4 x 25 MB at gemma2-9b, twice the 50 MB L2)
        v_turns = [v.clone() for _ in range(4)]
        turn = [0]

        def tiles_only():
            turn[0] = (turn[0] + 1) % len(v_turns)
            return tiles_cuda(v_turns[turn[0]])

        def plain():
            return ref.flash_attention_ref(q, k, v, **kw)

        def tiles_plain():
            return ref.nonfinite_tiles_ref(v)
        if softcap is not None:      # every path shape is causal
            library = flex_library(torch, q, k, v, window, softcap)
            note = ("torch.compile(flex_attention)(score_mod=softcap, "
                    "block_mask=causal/window, enable_gqa=True)")
        elif window is None:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal,
                    enable_gqa=True).transpose(1, 2)
            note = "F.scaled_dot_product_attention(is_causal, enable_gqa)"
        else:
            library, note = None, "n/a"
        timer = loop_ms if T > 1024 else device_ms
        plain_ms, (w_ms, s_ms) = time_turns(torch, timer, plain,
                                            [wgmma, simt])
        lib_ms = lib_err = None
        if library is not None:
            lib_ms = min(timer(torch, library), timer(torch, library))
            lib_err = (library().float() - plain().float()).abs().max().item()
        tiles_timer = device_ms
        sp_plain, (sp_ms,) = time_turns(torch, tiles_timer, tiles_plain,
                                        [tiles_only])
        b_ms, by, n_ops, nbytes = flash_bound(B, T, T, H, KV, hd, 2, kw)
        v_bytes = v.numel() * v.element_size()
        tiles_bytes = 4 * (-(-T // 64)) * B * KV * (1 + -(-hd // 32))
        sb_ms = (v_bytes + tiles_bytes) / HBM_BYTES_PER_S * 1e3
        tiles_timings[name] = {
            "shape": [B, T, KV, hd], "dtype": "bfloat16", "ms": sp_ms,
            "plain_ms": sp_plain, "bound_ms": sb_ms, "bound_by": "bytes",
            "library_ms": None, "timer": "cuda graph, v not in L2"}
        del v_turns
        for route, ms in (("wgmma", w_ms), ("simt", s_ms)):
            timings[route][name] = {
                "shape": [B, T, H, KV, hd], "dtype": "bfloat16", **kw,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": by, "ops": n_ops, "bytes": nbytes,
                "tflops": n_ops / ms / 1e9, "library_ms": lib_ms,
                "library_note": note, "library_max_abs_err": lib_err,
                "max_abs_err_f32": held["float32"][0],
                "share_of_tolerance_f32": held["float32"][1],
                "max_abs_err_bf16": (held["bfloat16"][0] if route == "wgmma"
                                     else simt_ok[1]),
                "share_of_tolerance_bf16": (held["bfloat16"][1]
                                            if route == "wgmma"
                                            else simt_ok[2]),
                "includes_prepass": True,
                "timer": ("cuda events, 5 eager calls back to back"
                          if T > 1024 else "cuda graph")}
        del q, k, v, library
        torch.cuda.empty_cache()
    (e32, s32), (e16, s16) = worst[torch.float32], worst[torch.bfloat16]
    print(f"kernels: flash_attention within tolerance of the plain version "
          f"in {cases} cases (shapes {FLASH_SHAPES}, f32 (SIMT) and bf16 "
          f"(wgmma), variants {FLASH_VARIANTS}, rows with no valid key, the "
          f"path shapes {list(FLASH_PATH_SHAPES)} in f32 and bf16); worst "
          f"|Δ| {e32:.3e} in f32 ({s32:.4f} of the tolerance), {e16:.3e} in "
          f"bf16 ({s16:.4f} of the tolerance)", flush=True)
    return max(e32, e16), timings, tiles_timings


SMALL_REFS = {   # arch: (config overrides, prompt length, max_len)
    "gemma-2b": ({}, 16, 24),
    # G = 2 as in the full configs; gemma3-4b keeps two segments (2
    # repeats of its 6-layer period and a 4-layer tail, as the full 5 x 6
    # + 4); prompts longer than the reduced window (32)
    "gemma2-9b": ({"num_kv_heads": 2}, 40, 48),
    "gemma3-4b": ({"num_kv_heads": 2, "num_layers": 16}, 40, 48),
}


def phase_small_reference(torch, arch: str):
    """A reduced config (``SMALL_REFS``) in f32: the card's logits (prefill
    through the flash kernel) against the CPU path's (plain versions) on
    the same weights and tokens, for the prefill and four vector-position
    decode steps (max|Δ| <= 1e-4 · max|logit|; TF32 is off, so the
    difference is summation order only)."""
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import Model
    over, T, max_len = SMALL_REFS[arch]
    cfg = dataclasses.replace(reduced(get_config(arch)), **over)
    model = Model(cfg)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    params_gpu = tree_map(lambda t: t.to("cuda"), params)
    g = torch.Generator("cpu").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, T), generator=g)
    forced = torch.randint(0, cfg.vocab_size, (4, 2, 1), generator=g)
    out = {}
    for dev, p in (("cpu", params), ("cuda", params_gpu)):
        logits, cache = model.prefill(p, {"tokens": tokens.to(dev)},
                                      max_len=max_len)
        seq = [logits.float().cpu()]
        for i in range(4):
            pos = torch.tensor([T + i, T - 3 + i], device=dev)
            logits, cache = model.decode_step(p, forced[i].to(dev), cache,
                                              pos)
            seq.append(logits.float().cpu())
        out[dev] = torch.stack(seq)
    err = (out["cuda"] - out["cpu"]).abs().max().item()
    scale = out["cpu"].abs().max().item()
    if not (torch.isfinite(out["cuda"]).all() and err <= 1e-4 * scale):
        fail(f"reduced {arch} on the card disagrees with the CPU path: "
             f"max|Δ|={err} vs 1e-4·{scale}")
    print(f"small reference: reduced {arch} f32 ({cfg.num_layers} layers, "
          f"window {cfg.window_size}, G {cfg.num_heads // cfg.num_kv_heads}"
          f", qk_norm {cfg.qk_norm}), prefill of {T} tokens + 4 vector-pos "
          f"decode steps, card vs CPU max|Δlogit|={err:.3e} "
          f"(max|logit|={scale:.3e})", flush=True)


def phase_small_train_reference(torch):
    """Reduced gemma-2b in f32, two int8_fused steps on the card against
    the port's CPU path from the same weights and data (TF32 is off, so
    the two differ by summation order only).  The step-1 loss must agree
    to 1e-5 relative and the step-2 loss to 1e-4 (an int8 code that flips
    between the devices moves a synced entry by s/127)."""
    import torch.distributed as dist
    from repro_torch._tree import tree_leaves
    from repro_torch.api import SessionConfig, TrainSession
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import SyncConfig, make_strategy
    from repro_torch.models import Model
    cfg = reduced(get_config("gemma-2b"))
    params = Model(cfg).init(torch.Generator("cpu").manual_seed(0))
    kw = dict(arch="gemma-2b", reduced=True, steps=2, batch=4, seq=64,
              lr=3e-3, warmup=1)
    out = {}
    for dev in ("cuda", "cpu"):
        # the card's session makes the default NCCL group; the CPU session
        # syncs over a gloo group of the same single rank
        group = dist.new_group(ranks=[0], backend="gloo") \
            if dev == "cpu" else None
        sess = TrainSession(SessionConfig(device=dev, **kw),
                            strategy=make_strategy(
                                "every_step", group=group,
                                sync=SyncConfig(compressor="int8_fused")),
                            params=params, group=group)
        losses = sess.run(2)
        out[dev] = (losses, [p.detach().float().cpu()
                             for p in tree_leaves(sess.params)])
    (lc, pc), (lh, ph) = out["cuda"], out["cpu"]
    rel = [abs(a - b) / abs(b) for a, b in zip(lc, lh)]
    dparam = max((a - b).abs().max().item() for a, b in zip(pc, ph))
    if not (all(math.isfinite(x) for x in lc) and rel[0] <= 1e-5
            and rel[1] <= 1e-4):
        fail(f"reduced gemma-2b training on the card disagrees with the CPU "
             f"path: losses {lc} vs {lh}")
    print(f"small reference: reduced gemma-2b f32, 2 int8_fused steps, card "
          f"vs CPU: losses {lc} vs {lh} (max rel diff {max(rel):.3e}), max "
          f"|Δparam| {dparam:.3e}", flush=True)


# the training wire's kernels, by their names in the profiler's events
WIRE_KERNELS = ("quantize_ef_kernel", "quantize_tiles_warp_kernel",
                "quantize_tiles_block_kernel", "dequant_accum_warp_kernel",
                "dequant_accum_block_kernel", "topk_ef_warp_kernel",
                "topk_ef_block_kernel", "topk_mask_warp_kernel",
                "topk_mask_block_kernel")


def profile_step(torch, session, card, name: str) -> dict:
    """One more training step under ``torch.profiler``: its wall time,
    device-busy share, the compression kernels' share of device time and
    the top device kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        session.step_once()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"profile {name}: the profiler recorded no device events "
              f"(device time not measured) [{card}]", flush=True)
        return {"wall_ms": wall * 1e3, "busy_share": None}
    by_name = {}
    for e in kernels:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_us = sum(us for us, _ in by_name.values())
    wire_us = sum(us for k, (us, _) in by_name.items()
                  if any(w in k for w in WIRE_KERNELS))
    res = {"wall_ms": wall * 1e3, "busy_ms": busy_us / 1e3,
           "busy_share": busy_us / (wall * 1e6),
           "wire_kernel_ms": wire_us / 1e3,
           "wire_kernel_share": wire_us / busy_us,
           "device_launches": len(kernels)}
    print(f"profile {name} [{card}]: one step {wall * 1e3:.3f} ms profiled, "
          f"device busy {busy_us / 1e3:.3f} ms = {res['busy_share']:.4f} of "
          f"it, {len(kernels)} kernel launches; compression kernels "
          f"{wire_us / 1e3:.3f} ms = {res['wire_kernel_share']:.4f} of device "
          f"time", flush=True)
    for kname, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"  {us / 1e3:9.3f} ms {n:5d} launches {kname[:100]}",
              flush=True)
    return res


def run_training(torch, ops, train, card) -> dict:
    """The training path at full width, once per entry of TRAIN_RUNS, each
    with every kernel counter set to 0 just before and read just after;
    then one profiled step.  Each run's state is freed before the next."""
    results = {}
    for name, (flags, wire) in TRAIN_RUNS.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        session = train.main(TRAIN_ARGS + flags)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = path_counts(ops)
        peak = torch.cuda.max_memory_allocated()
        if session.device.type != "cuda":
            fail(f"training {name} ran on {session.device}, not on the card")
        losses = list(session.losses)
        if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
            fail(f"training {name}: losses {losses}")
        n_buckets = (session.synchronizer.plan.n_buckets
                     if session.synchronizer is not None else 0)
        for kname, count in launches.items():
            want = n_buckets * TRAIN_STEPS if kname in wire else 0
            if count != want or (kname in wire and want <= 0):
                fail(f"training {name}: kernel {kname} launched {count} "
                     f"times, expected {want} (= {n_buckets} buckets x "
                     f"{TRAIN_STEPS} steps for the run's wire kernels, 0 for "
                     f"the others)")
        times = session.step_times
        step_ms = statistics.median(times[1:]) * 1e3
        tokens = TRAIN_BATCH * TRAIN_SEQ
        res = {"losses": losses, "step_ms": step_ms,
               "step_ms_all": [t * 1e3 for t in times],
               "tokens_per_s": tokens / (step_ms / 1e3),
               "peak_bytes": peak, "n_buckets": n_buckets,
               "launches": launches, "run_s": seconds,
               "params": session.num_params()}
        print(f"training {name} [{card}]: {session.model_cfg.name} "
              f"{res['params']} params bf16, batch {TRAIN_BATCH} x seq "
              f"{TRAIN_SEQ}, {TRAIN_STEPS} steps, losses "
              f"{[round(x, 4) for x in losses]}; step time (median of steps "
              f"2-{TRAIN_STEPS}) {step_ms:.3f} ms, all steps "
              f"{[round(t, 1) for t in res['step_ms_all']]} ms; tokens/s "
              f"{res['tokens_per_s']:.1f}; peak memory "
              f"{peak / 2**30:.3f} GiB; {n_buckets} buckets; launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        res["profile"] = profile_step(torch, session, card, name)
        results[name] = res
        del session
        gc.collect()
        torch.cuda.empty_cache()
    return results


def path_counts(ops) -> dict:
    """Every wrapper's launch count, and per route of the wrappers that
    have routes (``flash_attention[wgmma]``, ``quantize_tiles[warp]``,
    ``topk_ef[block]``, ...)."""
    return {**ops.launch_counts(),
            **{f"{kernel}[{r}]": n
               for kernel, routes in ops.route_counts().items()
               for r, n in routes.items()}}


def check_main_path(torch, run, launches, card) -> None:
    """A serving run's results: every request complete with valid tokens,
    no page leaked, the quantize kernel launched once per paged leaf per
    admission and per decode tick, all on the warp route, the flash
    kernel and its pre-pass once per attention layer per admission, every
    flash launch on the wgmma route and none on the SIMT one, no
    training-wire kernel, finite full-width prefill logits."""
    eng, cfg = run.engines[0], run.cfg
    n_req, n_new = len(run.requests), run.requests[0].max_new
    if len(run.completions) != n_req:
        fail(f"{len(run.completions)} of {n_req} requests completed")
    for c in run.completions:
        if len(c.tokens) != n_new or not ((c.tokens >= 0)
                                          & (c.tokens < cfg.vocab_size)).all():
            fail(f"request {c.rid}: bad tokens {c.tokens[:8]}...")
    eng.cache.check()
    live = sum(len(a.live_pages()) for a in eng.cache.allocators.values())
    if live:
        fail(f"{live} pages still live after draining")
    leaves = eng.cache.paged_leaves()
    flash = cfg.num_layers * eng.prefills
    quant = leaves * (eng.prefills + eng.decode_ticks)
    expected = {"quantize_tiles": quant, "quantize_tiles[warp]": quant,
                "flash_attention": flash, "nonfinite_tiles": flash,
                "flash_attention[wgmma]": flash}
    for name, n in launches.items():
        want = expected.get(name, 0)
        if n != want or (name in expected and want <= 0):
            fail(f"{cfg.name} serving: kernel {name} launched {n} times, "
                 f"expected {want} (quantize_tiles = {leaves} paged leaves "
                 f"x ({eng.prefills} admissions + {eng.decode_ticks} decode "
                 f"ticks), all on the warp route, flash_attention and "
                 f"nonfinite_tiles = {cfg.num_layers} layers x "
                 f"{eng.prefills} admissions, all on the wgmma route, 0 on "
                 f"the block and SIMT routes and for the training wire)")
    prompt = torch.as_tensor(run.requests[0].prompt, device=eng.device)
    logits, _ = run.model.prefill(run.params, {"tokens": prompt.long()[None]},
                                  max_len=eng.cfg.max_len)
    if tuple(logits.shape) != (1, 1, cfg.padded_vocab) or \
            not torch.isfinite(logits.float()).all():
        fail(f"prefill logits: shape {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits.float()).all())}")
    s = run.summary
    print(f"main path: {cfg.name} d_model {cfg.d_model} x {cfg.num_layers} "
          f"layers, {cfg.param_dtype}, int8 paged KV, {n_req} requests, "
          f"{s['tokens']} tokens, {eng.prefills} admissions, "
          f"{eng.decode_ticks} decode ticks, quantize_tiles launches "
          f"{launches['quantize_tiles']} (= {leaves} x ({eng.prefills} + "
          f"{eng.decode_ticks}); warp route "
          f"{launches['quantize_tiles[warp]']}, block route "
          f"{launches['quantize_tiles[block]']}), flash_attention launches "
          f"{launches['flash_attention']} (= {cfg.num_layers} x "
          f"{eng.prefills}; wgmma route {launches['flash_attention[wgmma]']},"
          f" SIMT route {launches['flash_attention[simt]']}), nonfinite_tiles "
          f"{launches['nonfinite_tiles']}", flush=True)
    print(f"serving [{card}]: tokens/s={s['tokens_per_s']:.2f} "
          f"p50 per-token latency={s['p50_s'] * 1e3:.3f} ms "
          f"p99={s['p99_s'] * 1e3:.3f} ms mean TTFT="
          f"{s['mean_ttft_s'] * 1e3:.3f} ms makespan={s['makespan_s']:.3f} s "
          f"(serve run {run.seconds:.2f} s)", flush=True)


def compare_static(torch, run, card) -> None:
    """Information only: the share of tokens at temperature 0 that the
    unquantized engine shares with run_static and with generate (batch
    size and position-vector changes may move bf16 sums on the card), and
    that the int8 engine shares with the unquantized one."""
    from repro_torch.launch import serve
    from repro_torch.serve import Engine, run_static
    eng, reqs = run.engines[0], run.requests
    n_new = reqs[0].max_new
    prompts = torch.as_tensor(np.stack([r.prompt for r in reqs]),
                              device=eng.device).long()
    eng_none = Engine(run.model, run.params,
                      dataclasses.replace(eng.cfg, quantize=None))
    cont = {c.rid: c.tokens for c in eng_none.run(reqs)}
    stat = {c.rid: c.tokens for c in run_static(
        run.model, run.params, reqs, eng.cfg.max_batch, eng.cfg.max_len)}
    gen = serve.generate(run.model, run.params, prompts, gen=n_new,
                         max_len=eng.cfg.max_len).cpu().numpy()
    q8 = {c.rid: c.tokens for c in run.completions}
    total = n_new * len(reqs)

    def share(other):
        return sum(int((cont[r.rid] == other[r.rid]).sum())
                   for r in reqs) / total
    # row 0's prefill logits alone (the engine's batch 1) and inside the
    # batch of all prompts (generate's batch): tokens can agree while the
    # bits differ, e.g. when random weights make greedy decoding repeat one
    # token
    one, _ = run.model.prefill(run.params, {"tokens": prompts[:1]},
                               max_len=eng.cfg.max_len)
    many, _ = run.model.prefill(run.params, {"tokens": prompts},
                                max_len=eng.cfg.max_len)
    dlog = (one[0].float() - many[0].float()).abs().max().item()
    distinct = len({int(t) for c in cont.values() for t in c})
    print(f"prefill logits of one prompt at batch 1 vs batch {len(reqs)}: "
          f"max|Δ|={dlog:.3e} (bit-equal: {dlog == 0.0}); {distinct} "
          f"distinct tokens in the unquantized engine's output", flush=True)
    print(f"bit-identity (information): unquantized engine vs run_static "
          f"{share(stat):.4f}, vs generate {share(gen):.4f}; int8 engine vs "
          f"unquantized engine {share(q8):.4f} of tokens equal [{card}]",
          flush=True)


def profile_ticks(torch, model, params, scfg, requests, card,
                  ticks: int = 10) -> dict:
    """Information only: where a decode tick's time goes.  Four requests
    are admitted into a fresh int8 engine, then ``ticks`` pure decode ticks
    are timed bare and again under ``torch.profiler``; prints the wall
    time per tick, the device-busy share and the top device kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import Engine
    eng = Engine(model, params, scfg)
    for r in requests[:4]:
        eng.submit(r)
    for _ in range(4):                      # one admission per tick
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        eng.step()
    torch.cuda.synchronize()
    bare = (time.perf_counter() - t0) / ticks
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"profile: bare decode tick {bare * 1e3:.3f} ms; the profiler "
              f"recorded no device events (device time not measured) "
              f"[{card}]", flush=True)
        return {"tick_ms": bare * 1e3, "busy_share": None}
    by_name = {}
    for e in kernels:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_us = sum(us for us, _ in by_name.values())
    print(f"profile [{card}]: decode tick at batch 4 {bare * 1e3:.3f} ms "
          f"bare, {wall / ticks * 1e3:.3f} ms profiled; device busy "
          f"{busy_us / ticks / 1e3:.3f} ms per tick = "
          f"{busy_us / ticks / (bare * 1e6):.4f} of a bare tick, "
          f"{busy_us / (wall * 1e6):.4f} of a profiled one; "
          f"{len(kernels) / ticks:.1f} kernel launches per tick", flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (us, n) in top:
        print(f"  {us / ticks:9.2f} us/tick {n / ticks:6.1f} launches/tick "
              f"{name[:100]}", flush=True)
    return {"tick_ms": bare * 1e3, "busy_ms": busy_us / ticks / 1e3,
            "busy_share": busy_us / ticks / (bare * 1e6)}


def run_gemma2_serving(torch, ops, serve, card) -> dict:
    """gemma2-9b served at full width (GEMMA2_SERVE_ARGS), with every
    kernel counter set to 0 just before and read just after, checked as
    the main path; then the prefill of one 6144-token admission timed
    alone (host clock around synchronised calls, median of 3) and a
    profile of five decode ticks.  Everything is freed before it
    returns."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    run = serve.main(GEMMA2_SERVE_ARGS)
    torch.cuda.synchronize()
    launches = path_counts(ops)
    if run.engines[0].device.type != "cuda":
        fail(f"the engine ran on {run.engines[0].device}, not on the card")
    check_main_path(torch, run, launches, card)
    peak = torch.cuda.max_memory_allocated()
    eng = run.engines[0]
    prompt = torch.as_tensor(run.requests[0].prompt,
                             device=eng.device).long()[None]
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.model.prefill(run.params, {"tokens": prompt},
                          max_len=eng.cfg.max_len)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    res = {"summary": run.summary, "seconds": run.seconds,
           "admissions": eng.prefills, "decode_ticks": eng.decode_ticks,
           "launches": launches, "peak_bytes": peak,
           "prefill_s": statistics.median(times), "prefill_s_all": times,
           "params": run.cfg.num_params()}
    print(f"gemma2-9b serving [{card}]: {res['params']} params bf16; "
          f"prefill of one {prompt.shape[1]}-token admission "
          f"{res['prefill_s'] * 1e3:.3f} ms (median of "
          f"{[round(t * 1e3, 1) for t in times]}); peak memory "
          f"{peak / 2**30:.3f} GiB", flush=True)
    model, params, scfg, reqs = run.model, run.params, eng.cfg, run.requests
    del run, eng
    gc.collect()
    torch.cuda.empty_cache()
    res["profile"] = profile_ticks(torch, model, params, scfg, reqs, card,
                                   ticks=5)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# 9. the explicit collectives at world 4 on the one card
# ---------------------------------------------------------------------------

W4 = 4
W4_ROUNDS = 3
W4_SEED = 0
W4_SMALL = 10007    # the (2, 2) mesh's buffer: chunk rows off 16 bytes
W4_TIMEOUT_S = 600
RING_FUSED_STREAMS = 2   # ring_fused's encodes: streams x p per axis


def ring_fused_hops(n: int) -> list:
    """The chunk lengths ceil(part/p) at which ring_fused at world 4 hands
    quantize_tiles the rows of its (p, m) hop buffers, for a bucket of n
    (split into streams at round(n·i/streams), as ring_fused does)."""
    b = [round(n * i / RING_FUSED_STREAMS)
         for i in range(RING_FUSED_STREAMS + 1)]
    return sorted({-(-(hi - lo) // W4) for lo, hi in zip(b, b[1:]) if hi > lo})


def digest(torch, x):
    """Two order-free checksums of a tensor's bits (f32 or bf16; int64
    sums, wrapping, of the bits and of the bits times a position weight),
    so that ranks compare a 2.4 GB result without moving it."""
    bits = x.detach().reshape(-1).view({2: torch.int16,
                                        4: torch.int32}[x.element_size()])
    sums = torch.zeros(2, dtype=torch.int64, device=x.device)
    for off in range(0, bits.numel(), 1 << 24):
        b = bits[off:off + (1 << 24)].to(torch.int64)
        w = torch.arange(off, off + b.numel(), device=b.device) % 65521 + 1
        sums += torch.stack([b.sum(), (b * w).sum()])
    return sums.cpu()


def w4_gate(ok: bool, msg: str) -> None:
    if not ok:
        fail(f"world-4 phase, rank {os.environ.get('RANK', '?')}: {msg}")


def w4_launch_gate(counts, want: dict, what: str) -> None:
    """Every wrapper's count in ``counts`` (``path_counts``) equals
    ``want`` (0 where it names none)."""
    got = {k: v for k, v in counts.items() if v}
    w4_gate(got == {k: v for k, v in want.items() if v},
            f"{what}: launches {got}, expected {want}")


def world4_child(rank: int, world: int, store: str, out_dir: str,
                 sizes: dict) -> None:
    """One rank of the world-4 phase: a gloo group of 4 processes on the
    one card (NCCL refuses two ranks on one device), card tensors staged
    through pinned host memory for every transfer.  Writes its results to
    ``out_dir/rank<r>.json``; any failed gate exits non-zero."""
    os.environ["RANK"] = str(rank)
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import GradientSynchronizer, SyncConfig
    from repro_torch.core import PlanExecutor
    from repro_torch.core.collectives import ALGOS, all_gather, allreduce
    from repro_torch.core.collectives import p2p
    from repro_torch.core.schedule.planner import BucketPlan, CommPlan
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.quantize import quantize_tiles_cuda
    from repro_torch.kernels.quantize_ef import (dequant_accum_cuda,
                                                 quantize_ef_cuda)
    from repro_torch.launch.dist import init_group, mesh_axes
    torch.set_num_threads(2)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    init_group(torch.device("cpu"), world_size=W4, rank=rank,
               store_path=store)
    dev = torch.device("cuda")
    res = {"rank": rank}

    def same_on_all_ranks(x) -> bool:
        """x's bits (its digest above 4M elements) equal on every rank."""
        mine = (x.reshape(-1).view(torch.int32) if x.numel() <= 1 << 22
                else digest(torch, x))
        rows = all_gather(mine)
        return all(torch.equal(rows[r], rows[0]) for r in range(W4))

    # -- 9.1 int8_fused with EF on ring_fused, the wire's real buckets -----
    first, largest = sizes["first"], sizes["largest"]
    plan = CommPlan(buckets=(
        BucketPlan(leaves=(1,), compressor="int8_fused", algo="ring_fused",
                   bucket_bytes=4 * first),
        BucketPlan(leaves=(0,), compressor="int8_fused", algo="ring_fused",
                   bucket_bytes=4 * largest)))
    ex = PlanExecutor(plan)
    gen = torch.Generator(dev).manual_seed(W4_SEED + rank)
    grads = {"a": torch.randn(largest, generator=gen, device=dev),
             "b": torch.randn(first, generator=gen, device=dev)}
    state = ex.init_state(grads)
    torch.cuda.synchronize()
    dist.barrier()
    ops.reset_launch_counts()
    p2p.reset_staged_bytes()
    round_s = []
    for _ in range(W4_ROUNDS):
        t0 = time.perf_counter()
        synced, state = ex(grads, state)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        for k, v in synced.items():
            w4_gate(torch.isfinite(v).all().item(), f"ring_fused {k} "
                    f"not finite")
            w4_gate(same_on_all_ranks(v), f"ring_fused result {k} "
                    f"({v.numel()} f32) differs between ranks")
        del synced
    counts = path_counts(ops)
    staged = p2p.staged_bytes()
    per = len(plan.buckets) * W4_ROUNDS
    hops = RING_FUSED_STREAMS * W4 * per         # 2p per bucket and round
    w4_launch_gate(counts, {"quantize_ef": per, "quantize_tiles": hops,
                            "quantize_tiles[warp]": hops},
                   "int8_fused on ring_fused")
    peak = torch.cuda.max_memory_allocated()
    res["ring_fused"] = {"round_s": round_s, "staged_bytes": staged,
                         "launches": counts, "peak_bytes": peak,
                         "buckets": [first, largest]}

    # one more round under the profiler (rank 0 records; all take part)
    if rank == 0:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            synced, state = ex(grads, state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        res["profile"] = w4_breakdown(prof, wall)
    else:
        synced, state = ex(grads, state)
        torch.cuda.synchronize()
    del synced, state, grads, ex
    torch.cuda.empty_cache()

    # -- 9.2 the gather wire and the exact ring at the 9437184 bucket -------
    mid = sizes["mid"]
    gen = torch.Generator(dev).manual_seed(W4_SEED + 100 + rank)
    g2 = {"g": torch.randn(mid, generator=gen, device=dev)}
    wires = {"int8_fused_ring": ("int8_fused", {"quantize_ef": 1,
                                                "dequant_accum": 1,
                                                "dequant_accum[warp]": 1}),
             "topk_fused_ring": ("topk_fused", {"topk_ef": 1,
                                                "topk_ef[warp]": 1})}
    for name, (comp, want) in wires.items():
        cfg = SyncConfig(compressor=comp, algo="ring")
        card = GradientSynchronizer(cfg)
        st = card.init_state(g2)
        dist.barrier()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out, st = card(g2, st)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = path_counts(ops)
        w4_launch_gate(counts, want, name)
        w4_gate(same_on_all_ranks(out["g"]), f"{name} differs between ranks")
        cpu = GradientSynchronizer(cfg)
        gc_ = {"g": g2["g"].cpu()}
        out_c, st_c = cpu(gc_, cpu.init_state(gc_))
        flips = int((out["g"].cpu() != out_c["g"]).sum())
        e_flips = int((st["error"][0].cpu() != st_c["error"][0]).sum())
        w4_gate(flips == 0 and e_flips == 0,
                f"{name}: the card differs from the same executor on the CPU "
                f"(gloo, plain versions) at {flips} synced entries and "
                f"{e_flips} residual entries")
        res[name] = {"seconds": secs, "launches": counts}
        if comp == "int8_fused":
            # dequant_accum at w = 4 on this bucket's gathered payloads,
            # timed on rank 0 while the others wait at the next barrier
            q, _, sc = quantize_ef_cuda(g2["g"], torch.zeros_like(g2["g"]),
                                        1.0, TILE, None)
            qg, sg = all_gather(q), all_gather(sc)
            if rank == 0:
                w4_gate(same(torch, dequant_accum_cuda(qg, sg, TILE),
                             ref.dequant_accum_ref(qg, sg, tile=TILE)),
                        f"dequant_accum at w = {W4}, n={mid} differs from "
                        f"the plain version")
                res["dequant_accum_w4"] = w4_time(
                    torch, lambda: dequant_accum_cuda(qg, sg, TILE),
                    lambda: ref.dequant_accum_ref(qg, sg), mid,
                    bound(W4 * mid + 4 * W4 * -(-mid // TILE) + 4 * mid,
                          2 * W4 * mid))
            del q, sc, qg, sg
        del out, st, out_c, st_c
    del g2
    torch.cuda.empty_cache()

    # -- 9.3 every algorithm on a (2, 2) mesh ------------------------------
    axes = mesh_axes((2, 2))
    gen = torch.Generator(dev).manual_seed(W4_SEED + 200 + rank)
    x = torch.randn(W4_SMALL, generator=gen, device=dev)
    exact = all_gather(x.double()).sum(0).cpu()
    res["algos"] = {}
    for algo in ALGOS:
        dist.barrier()
        ops.reset_launch_counts()
        got = allreduce(x.clone(), algo, axes)
        torch.cuda.synchronize()
        counts = path_counts(ops)
        # ring_fused: streams x p encodes on each of the 2 axes of size 2
        n_q = 2 * RING_FUSED_STREAMS * 2 if algo == "ring_fused" else 0
        w4_launch_gate(counts, {"quantize_tiles": n_q,
                                "quantize_tiles[warp]": n_q}, algo)
        want = allreduce(x.cpu(), algo, axes)
        w4_gate(torch.equal(got.cpu().view(torch.int32),
                            want.view(torch.int32)),
                f"{algo} on the (2, 2) mesh: the card differs from the same "
                f"schedule on the CPU (plain versions)")
        w4_gate(same_on_all_ranks(got), f"{algo} differs between ranks")
        err = float((got.cpu().double() - exact).abs().max())
        # the reference's check_collectives: ring_fused within 5% of the
        # largest sum, the exact schedules within 1e-4
        limit = (0.05 * float(exact.abs().max()) if algo == "ring_fused"
                 else 1e-4)
        w4_gate(err <= limit, f"{algo}: max |error| {err} > {limit}")
        res["algos"][algo] = {"max_abs_err": err, "launches": counts}

    # -- 9.4 quantize_tiles at the ring_fused hops' lengths (rank 0) -------
    # 9.1 holds the ranks to each other only, so here every row of a
    # (p, m) hop buffer, at each bucket's chunk length m, is held bit-equal
    # to the plain version on the same row; then the largest hop is timed
    if rank == 0:
        for n_bucket in (first, largest):
            for m in ring_fused_hops(n_bucket):
                a = torch.randn(W4, m, generator=gen, device=dev)
                for r in range(W4):
                    got = quantize_tiles_cuda(a[r], TILE)
                    want = ref.quantize_tiles_ref(a[r], tile=TILE)
                    w4_gate(all(same(torch, g_, w_)
                                for g_, w_ in zip(got, want)),
                            f"quantize_tiles on row {r} of the ({W4}, {m}) "
                            f"ring_fused hop buffer of the {n_bucket} bucket "
                            f"differs from the plain version")
                    del got, want
        # a is now the largest bucket's hop buffer: time one of its rows
        m = a.shape[1]
        xh = a[1]
        res["quantize_tiles_hop"] = w4_time(
            torch, lambda: quantize_tiles_cuda(xh, TILE),
            lambda: ref.quantize_tiles_ref(xh, tile=TILE), m,
            bound(5 * m + 4 * -(-m // TILE), QUANT_OPS_PER_ELEMENT * m))
        del a, xh
        torch.cuda.empty_cache()
    dist.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def w4_time(torch, kern, plain, n, bound_) -> dict:
    """Kernel and plain-version device times in turns (plain, kernel,
    kernel, plain), by CUDA-graph replay: the calls last 0.1-0.2 ms, so
    CUDA events around eager calls would count the host's launch work."""
    p0, k0 = device_ms(torch, plain), device_ms(torch, kern)
    k1, p1 = device_ms(torch, kern), device_ms(torch, plain)
    return {"n": n, "tile": TILE, "dtype": "float32", "ms": min(k0, k1),
            "plain_ms": min(p0, p1), "bound_ms": bound_[0],
            "bound_by": bound_[1], "library_ms": None,
            "timer": "cuda graph"}


def w4_breakdown(prof, wall: float) -> dict:
    """One profiled ring_fused round on rank 0, split by device time:
    the port's kernels, the host staging copies (memcpy to and from
    pinned memory), the plain PyTorch ops (dequantize, add, pad, cast,
    division); the rest of the wall time is the host (gloo transfers,
    Python, launches)."""
    from torch.autograd import DeviceType
    split = {"kernels_ms": 0.0, "staging_copies_ms": 0.0, "plain_ops_ms": 0.0}
    n = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        n += 1
        ms = e.time_range.elapsed_us() / 1e3
        if any(k in e.name for k in WIRE_KERNELS):
            split["kernels_ms"] += ms
        elif "Memcpy" in e.name or "memcpy" in e.name:
            split["staging_copies_ms"] += ms
        else:
            split["plain_ops_ms"] += ms
    busy = sum(split.values())
    return {**split, "device_events": n, "wall_ms": wall * 1e3,
            "device_busy_ms": busy, "host_ms": wall * 1e3 - busy}


def phase_world4(torch, card, sizes: dict) -> dict:
    """Four spawned ranks on the one card (``world4_child``, through
    ``launch/dist.py:spawn``); every library is built already (phase 2),
    so no rank runs ``nvcc``.  A rank that fails fails the run; the others
    are stopped."""
    import shutil
    from repro_torch.launch.dist import spawn
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = ROOT / "build" / "world4"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    try:
        spawn(world4_child, W4, args=(str(out_dir), sizes),
              timeout=W4_TIMEOUT_S)
    except RuntimeError as e:
        fail(f"world-4 phase: {e}")
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(W4)]
    for name in ("ring_fused", "int8_fused_ring", "topk_fused_ring"):
        if any(r[name]["launches"] != ranks[0][name]["launches"]
               for r in ranks):
            fail(f"world-4 phase {name}: ranks launched differently")
    r0 = ranks[0]
    rf = r0["ring_fused"]
    print(f"world 4 on one card over gloo [{card}]: int8_fused with EF on "
          f"ring_fused, buckets {rf['buckets']}, {W4_ROUNDS} rounds: "
          f"seconds per round by rank "
          f"{[[round(s, 4) for s in r['ring_fused']['round_s']] for r in ranks]}"
          f"; staged bytes per rank {[r['ring_fused']['staged_bytes'] for r in ranks]}"
          f"; peak memory per rank "
          f"{[round(r['ring_fused']['peak_bytes'] / 2**30, 3) for r in ranks]}"
          f" GiB; launches {dict((k, v) for k, v in rf['launches'].items() if v)}"
          f"; all ranks bit-equal", flush=True)
    pr = r0["profile"]
    print(f"world 4 ring_fused round profiled on rank 0 [{card}]: wall "
          f"{pr['wall_ms']:.3f} ms; device busy {pr['device_busy_ms']:.3f} ms"
          f" = kernels {pr['kernels_ms']:.3f} + plain ops (dequantize, add, "
          f"pad, cast, divide) {pr['plain_ops_ms']:.3f} + staging copies "
          f"{pr['staging_copies_ms']:.3f}; host (gloo transfers, Python) "
          f"{pr['host_ms']:.3f} ms", flush=True)
    for name in ("int8_fused_ring", "topk_fused_ring"):
        r = r0[name]
        print(f"world 4 {name} at the {sizes['mid']} bucket [{card}]: "
              f"{r['seconds'] * 1e3:.3f} ms on rank 0, bit-equal across "
              f"ranks and to the CPU executor (gloo, plain versions); "
              f"launches {dict((k, v) for k, v in r['launches'].items() if v)}",
              flush=True)
    print(f"world 4 on a (2, 2) mesh at n={W4_SMALL}: "
          f"{ {a: r['max_abs_err'] for a, r in r0['algos'].items()} } max "
          f"|error| to the exact sum; each bit-equal across ranks and to "
          f"its CPU schedule", flush=True)
    for key in ("quantize_tiles_hop", "dequant_accum_w4"):
        t = r0[key]
        print(f"world 4 {key} n={t['n']} tile={t['tile']} f32: device time "
              f"kernel {t['ms'] * 1e3:.3f} us, plain {t['plain_ms'] * 1e3:.3f}"
              f" us, bound {t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}), "
              f"{t['bound_ms'] / t['ms']:.3f} of the bound ({t['timer']}); "
              f"bit-equal to the plain version [{card}]", flush=True)
    return r0


# ---------------------------------------------------------------------------
# 10. the rounds axis: local SGD, LAG and push/pull
# ---------------------------------------------------------------------------

ROUNDS_STEPS = 4
ROUNDS_ARGS = ["--arch", "gemma-2b", "--no-reduced", "--optimizer", "adam",
               "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
               "--steps", str(ROUNDS_STEPS), "--seed", "0",
               "--log-every", "1"]
INT8_WIRE = ("quantize_ef", "dequant_accum", "dequant_accum[warp]")
ROUNDS_RUNS = {   # run name: (extra CLI flags, the wire's kernels per
    #               bucket, the rounds that run the wire)
    "local_sgd": (["--local-sgd", "2", "--sync", "comm", "--compressor",
                   "int8_fused"], INT8_WIRE, "param"),
    "lag": (["--lag", "4", "--sync", "comm", "--compressor", "int8_fused"],
            INT8_WIRE, "grad"),
    "push_pull": (["--push-pull", "2", "2", "--sync", "comm", "--compressor",
                   "topk_fused"], ("topk_ef", "topk_ef[warp]"), "grad"),
}
# (grad, param, control) rounds of 4 steps; LAG's are data-dependent
ROUNDS_EXPECT = {"local_sgd": (0, 2, 0), "push_pull": (2, 2, 0)}
# bytes held per parameter by the local-SGD run at its round: bf16 params
# (2), Adam's f32 moments (8), the f32 anchor (4) and parameter EF (4), the
# f32 delta (4) and its reduction (4)
LOCAL_SGD_BYTES_PER_PARAM = 26
W4_ROUNDS_SESSION = dict(arch="gemma-2b", layers=1, steps=ROUNDS_STEPS,
                         batch=4, seq=128, optimizer="sgd", lr=3e-3,
                         warmup=1, seed=0)


def round_step(session) -> bool:
    """Whether the session's next step runs a parameter round (local SGD
    and push/pull decide without a probe)."""
    sched = session.strategy.scheduler
    action, _ = sched.round(session.step, session._sched_state)
    return action.param_round


def profile_round(torch, session, card, name: str) -> dict:
    """One more step that holds a round (local SGD and push/pull: the next
    step with a parameter round, the steps before it run unprofiled; LAG:
    the next step, probe included) under ``torch.profiler``: its wall time
    split into the wire kernels, the other device work (the model, Adam,
    casts, packing, the probe's sums: plain ops) and the host; with the
    parameter round's own wall time where the step holds one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if session.strategy.scheduler.has_param_rounds:
        while not round_step(session):
            session.step_once()
    round_ms = []
    if session.strategy.scheduler.has_param_rounds:
        inner = session._param_round

        def timed(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = inner(*args)
            torch.cuda.synchronize()
            round_ms.append((time.perf_counter() - t) * 1e3)
            return out
        session._param_round = timed
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        session.step_once()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if round_ms:
        session._param_round = inner
    wire = other = 0.0
    n = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        n += 1
        ms = e.time_range.elapsed_us() / 1e3
        if any(k in e.name for k in WIRE_KERNELS):
            wire += ms
        else:
            other += ms
    res = {"wall_ms": wall * 1e3, "wire_kernels_ms": wire,
           "plain_ops_ms": other, "device_events": n,
           "host_ms": wall * 1e3 - wire - other,
           "param_round_ms": round_ms[0] if round_ms else None}
    what = ("parameter round" if round_ms else "probe and its round"
            if session.strategy.scheduler.needs_grad_probe
            else "gradient sync")
    print(f"profile rounds {name} [{card}]: one step with a {what} "
          f"{res['wall_ms']:.3f} ms = wire kernels {wire:.3f} + other device "
          f"work (model, Adam, casts, packing) {other:.3f} + host "
          f"{res['host_ms']:.3f} ms ({n} device events)"
          + (f"; its parameter round {round_ms[0]:.3f} ms" if round_ms
             else ""), flush=True)
    return res


def run_rounds(torch, ops, train, card) -> dict:
    """Phase 10 (a): the three schedulers at full width through the CLI,
    each with every kernel counter set to 0 just before and read just
    after: the wire's kernels launch once per bucket per ROUND that runs
    the wire (parameter rounds for local SGD, gradient syncs for LAG and
    push/pull), the rest 0."""
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    free, total = torch.cuda.mem_get_info()
    params = sum(math.prod(d.shape) for d in
                 tree_leaves(Model(get_config("gemma-2b")).param_desc()))
    need = LOCAL_SGD_BYTES_PER_PARAM * params
    print(f"rounds memory reckoning [{card}]: local SGD with int8_fused "
          f"rounds holds {LOCAL_SGD_BYTES_PER_PARAM} B per parameter at its "
          f"round = {need / 2**30:.2f} GiB for {params} parameters; the card "
          f"has {free / 2**30:.2f} GiB free of {total / 2**30:.2f} GiB",
          flush=True)
    if need > free:
        fail(f"the local-SGD run needs ~{need / 2**30:.2f} GiB, the card has "
             f"{free / 2**30:.2f} GiB free")
    results = {}
    for name, (flags, wire, carrier) in ROUNDS_RUNS.items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        session = train.main(ROUNDS_ARGS + flags)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = path_counts(ops)
        peak = torch.cuda.max_memory_allocated()
        if session.device.type != "cuda":
            fail(f"rounds {name} ran on {session.device}, not on the card")
        losses = list(session.losses)
        if len(losses) != ROUNDS_STEPS or not all(map(math.isfinite, losses)):
            fail(f"rounds {name}: losses {losses}")
        split = (session.grad_rounds, session.param_rounds,
                 session.control_rounds)
        if name in ROUNDS_EXPECT and split != ROUNDS_EXPECT[name]:
            fail(f"rounds {name}: (grad, param, control) rounds {split}, "
                 f"expected {ROUNDS_EXPECT[name]}")
        if name == "lag" and not (split[1] == 0
                                  and split[2] == ROUNDS_STEPS
                                  and 1 <= split[0] < ROUNDS_STEPS):
            fail(f"rounds lag: (grad, param, control) rounds {split}: "
                 f"needs a probe every step and both a sync and a reuse")
        reducer = (session.synchronizer if carrier == "grad"
                   else session.strategy.param_reducer)
        n_buckets = reducer.plan.n_buckets
        rounds = split[0] if carrier == "grad" else split[1]
        for kname, count in launches.items():
            want = n_buckets * rounds if kname in wire else 0
            if count != want or (kname in wire and want <= 0):
                fail(f"rounds {name}: kernel {kname} launched {count} "
                     f"times, expected {want} (= {n_buckets} buckets x "
                     f"{rounds} {carrier} rounds for the wire's kernels, 0 "
                     f"for the others)")
        times = [t * 1e3 for t in session.step_times]
        res = {"losses": losses, "step_ms_all": times,
               "step_ms": statistics.median(times[1:]),
               "grad_rounds": split[0], "param_rounds": split[1],
               "control_rounds": split[2], "comm_rounds":
               session.comm_rounds, "peak_bytes": peak,
               "n_buckets": n_buckets, "launches": launches,
               "run_s": seconds}
        print(f"rounds {name} [{card}]: {session.model_cfg.name} bf16, batch "
              f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, {ROUNDS_STEPS} steps, "
              f"losses {[round(x, 4) for x in losses]}; step times "
              f"{[round(t, 1) for t in times]} ms (median of steps 2-"
              f"{ROUNDS_STEPS} {res['step_ms']:.3f}); comm rounds "
              f"{session.comm_rounds} = grad {split[0]} + param {split[1]}, "
              f"control {split[2]}; peak memory {peak / 2**30:.3f} GiB; "
              f"{n_buckets} buckets; launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        res["profile"] = profile_round(torch, session, card, name)
        results[name] = res
        del session, reducer
        gc.collect()
        torch.cuda.empty_cache()
    return results


def phase_small_rounds_reference(torch, card) -> dict:
    """Phase 10 (b), reduced gemma-2b in f32: four local-SGD steps with
    int8_fused parameter rounds and four LAG steps with the int8_fused
    wire, on the card and on the port's CPU path (plain versions, a gloo
    group of the one rank), from the same weights and data: the same
    round counts, gated on both devices as in (a), step-1 losses within
    1e-5 and the others within 1e-4 relative (phase 4's training
    tolerance).  LAG's θ = 4 gives a sync and then reuse steps: at this
    size ||g - g_last||² / ||g||² stays near 1.6-2.1 after the first
    step (the CPU path's probes), so θ = 0.5 would sync on every step and
    never run the reuse program.  Then a checkpoint on the
    card: 2 steps, save, load into a fresh session, 2 more steps — losses
    and parameters bit-equal to an uninterrupted 4-step run; and the
    card's checkpoint loads on the CPU bit for bit."""
    import torch.distributed as dist
    from repro_torch._tree import tree_leaves
    from repro_torch.api import SessionConfig, TrainSession
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import SyncConfig, make_strategy
    from repro_torch.models import Model
    cfg = reduced(get_config("gemma-2b"))
    params = Model(cfg).init(torch.Generator("cpu").manual_seed(0))
    kw = dict(arch="gemma-2b", reduced=True, steps=ROUNDS_STEPS, batch=4,
              seq=64, lr=3e-3, warmup=1)
    gloo = dist.new_group(ranks=[0], backend="gloo")
    sync = SyncConfig(compressor="int8_fused")
    out = {}
    for name, skw in (("local_sgd", dict(period=2)),
                      ("lag", dict(threshold=4.0))):
        runs = {}
        for dev in ("cuda", "cpu"):
            group = gloo if dev == "cpu" else None
            sess = TrainSession(SessionConfig(device=dev, **kw),
                                strategy=make_strategy(name, group=group,
                                                       sync=sync, **skw),
                                params=params, group=group)
            losses = sess.run(ROUNDS_STEPS)
            runs[dev] = (losses, (sess.grad_rounds, sess.param_rounds,
                                  sess.control_rounds))
        (lc, rc), (lh, rh) = runs["cuda"], runs["cpu"]
        for split in (rc, rh):
            grad, param, control = split
            if name == "local_sgd" and split != ROUNDS_EXPECT[name]:
                fail(f"reduced gemma-2b local_sgd: (grad, param, control) "
                     f"rounds {split}, expected {ROUNDS_EXPECT[name]}")
            if name == "lag" and not (param == 0 and control == ROUNDS_STEPS
                                      and 1 <= grad < ROUNDS_STEPS):
                fail(f"reduced gemma-2b lag: (grad, param, control) rounds "
                     f"{split}: needs a probe every step and both a sync "
                     f"and a reuse")
        rel = [abs(a - b) / abs(b) for a, b in zip(lc, lh)]
        if rc != rh or not (all(map(math.isfinite, lc)) and rel[0] <= 1e-5
                            and max(rel) <= 1e-4):
            fail(f"reduced gemma-2b {name} on the card disagrees with the CPU"
                 f" path: losses {lc} vs {lh}, rounds {rc} vs {rh}")
        print(f"small reference rounds [{card}]: reduced gemma-2b f32, "
              f"{ROUNDS_STEPS} {name} steps ({skw}, int8_fused), card vs "
              f"CPU: losses "
              f"{lc} vs {lh} (max rel diff {max(rel):.3e}); (grad, param, "
              f"control) rounds {rc} on both", flush=True)
        out[name] = {"losses_card": lc, "losses_cpu": lh,
                     "max_rel_diff": max(rel), "rounds": rc}

    # the checkpoint: vanilla Adam on the card, resumed mid-run
    ckpt = str(ROOT / "build" / "rounds_checkpoint" / "ck")

    def card_session():
        return TrainSession(SessionConfig(device="cuda", **kw), params=params)

    whole = card_session()
    whole.run(ROUNDS_STEPS)
    first = card_session()
    first.run(2)
    first.save_checkpoint(ckpt)
    resumed = card_session()
    if resumed.load_checkpoint(ckpt) != 2:
        fail("checkpoint: the resumed session is not at step 2")
    later = resumed.run(ROUNDS_STEPS - 2)
    same_params = all(torch.equal(a, b) for a, b in
                      zip(tree_leaves(resumed.params),
                          tree_leaves(whole.params)))
    if first.losses + later != whole.losses or not same_params:
        fail(f"checkpoint: resumed losses {first.losses + later} vs "
             f"uninterrupted {whole.losses}, parameters bit-equal "
             f"{same_params}")
    host = TrainSession(SessionConfig(device="cpu", **kw), group=gloo)
    host.load_checkpoint(ckpt)
    on_cpu = all(torch.equal(a, b.cpu()) for a, b in
                 zip(tree_leaves(host.params), tree_leaves(first.params)))
    if not on_cpu:
        fail("checkpoint: the card's checkpoint restores differently on the "
             "CPU")
    print(f"checkpoint [{card}]: reduced gemma-2b, 2 steps + save + load + "
          f"2 steps on the card = the uninterrupted 4-step run bit for bit "
          f"(losses {whole.losses}); the card's checkpoint restores on the "
          f"CPU bit for bit", flush=True)
    out["checkpoint"] = {"losses": whole.losses, "bit_equal": True,
                         "cpu_restore_bit_equal": True}
    return out


def params_digest(torch, params):
    """(leaves, 2) int64: ``digest`` of every leaf."""
    from repro_torch._tree import tree_leaves
    return torch.stack([digest(torch, p) for p in tree_leaves(params)])


def watch_param_rounds(torch, sess) -> list:
    """Wrap the built session's parameter round so that each round appends
    (digest of the parameters before it, after it, its seconds) to the
    returned list."""
    inner = sess._param_round
    rounds = []

    def watched(params, anchor, red_state, rng):
        pre = params_digest(torch, params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(params, anchor, red_state, rng)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rounds.append((pre, params_digest(torch, out[0]), secs))
        return out

    sess._param_round = watched
    return rounds


def gate_rounds_differ_then_agree(torch, rounds, world: int) -> None:
    """Before each round the ranks' parameters differ; after it they are
    bit-equal (digests gathered over the default group)."""
    from repro_torch.core.collectives import all_gather
    for i, (pre, post, _) in enumerate(rounds):
        pres, posts = all_gather(pre), all_gather(post)
        w4_gate(not all(torch.equal(pres[r], pres[0]) for r in range(world)),
                f"round {i}: the ranks' parameters are equal before it")
        w4_gate(all(torch.equal(posts[r], posts[0]) for r in range(world)),
                f"round {i}: the ranks' parameters differ after it")


def spawn_world4(torch, child, name: str, args: tuple) -> list:
    """Four spawned ranks of ``child`` on the one card
    (``launch/dist.py:spawn``), each writing ``rank{r}.json`` under
    ``build/<name>``; a rank that fails fails the run, and so do ranks
    whose launch counts differ.  The ranks share the card's memory, so
    their allocators map segments on demand (expandable segments) rather
    than keep fragments reserved.  Returns (ranks' results, seconds)."""
    import shutil
    from repro_torch.launch.dist import spawn
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = ROOT / "build" / name
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        spawn(child, W4, args=(str(out_dir), *args), timeout=W4_TIMEOUT_S)
    except RuntimeError as e:
        fail(f"{name} phase: {e}")
    finally:
        if alloc is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    seconds = time.perf_counter() - t0
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(W4)]
    if any(r["launches"] != ranks[0]["launches"] for r in ranks):
        fail(f"{name} phase: ranks launched differently")
    return ranks, seconds


def rounds_w4_child(rank: int, world: int, store: str, out_dir: str) -> None:
    """Phase 10 (c), one rank: gemma-2b at full width with 1 layer, SGD,
    local SGD τ = 2 with int8_fused parameter rounds on psum (the gather
    wire: dequant_accum at w = 4), a gloo group of 4 processes on the one
    card.  Before each round the ranks' parameters differ, after it they
    are bit-equal (digests of the bits, gathered); quantize_ef and
    dequant_accum launch once per delta bucket per round."""
    os.environ["RANK"] = str(rank)
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch._tree import tree_leaves
    from repro_torch.api import SessionConfig, TrainSession
    from repro_torch.core import SyncConfig, make_strategy
    from repro_torch.core.collectives import p2p
    from repro_torch.kernels import ops
    from repro_torch.launch.dist import init_group
    torch.set_num_threads(2)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    init_group(torch.device("cpu"), world_size=world, rank=rank,
               store_path=store)
    group = dist.group.WORLD
    sess = TrainSession(
        SessionConfig(device="cuda", **W4_ROUNDS_SESSION),
        strategy=make_strategy("local_sgd", group=group, period=2,
                               sync=SyncConfig(compressor="int8_fused")),
        group=group)
    sess._build()
    rounds = watch_param_rounds(torch, sess)
    torch.cuda.synchronize()
    dist.barrier()
    ops.reset_launch_counts()
    p2p.reset_staged_bytes()
    losses = sess.run(ROUNDS_STEPS)
    torch.cuda.synchronize()
    counts = path_counts(ops)
    staged = p2p.staged_bytes()
    plan = sess.strategy.param_reducer.plan
    n_buckets = plan.n_buckets
    sizes = [p.numel() for p in tree_leaves(sess.params)]
    w4_gate(all(map(math.isfinite, losses)), f"losses {losses}")
    w4_gate((sess.grad_rounds, sess.param_rounds) == (0, 2) and
            len(rounds) == 2, f"rounds (grad, param) = "
            f"{(sess.grad_rounds, sess.param_rounds)}, expected (0, 2)")
    per = n_buckets * len(rounds)
    w4_launch_gate(counts, {"quantize_ef": per, "dequant_accum": per,
                            "dequant_accum[warp]": per},
                   "local SGD int8_fused rounds")
    gate_rounds_differ_then_agree(torch, rounds, world)
    res = {"rank": rank, "losses": losses,
           "step_ms_all": [t * 1e3 for t in sess.step_times],
           "round_s": [r[2] for r in rounds], "staged_bytes": staged,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "n_buckets": n_buckets, "launches": counts,
           "bucket_lengths": [sum(sizes[i] for i in b.leaves)
                              for b in plan.buckets],
           "params": sess.num_params()}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def phase_rounds_world4(torch, card) -> dict:
    """Four spawned ranks of ``rounds_w4_child`` on the one card."""
    ranks, seconds = spawn_world4(torch, rounds_w4_child, "rounds_world4",
                                  ())
    r0 = ranks[0]
    print(f"rounds world 4 on one card over gloo [{card}]: gemma-2b d_model "
          f"2048 x 1 layer ({r0['params']} params bf16), SGD, local SGD "
          f"τ=2 with int8_fused rounds on psum, global batch 4 x seq 128, "
          f"{ROUNDS_STEPS} steps: losses {r0['losses']}; round seconds by "
          f"rank {[[round(s, 4) for s in r['round_s']] for r in ranks]}; "
          f"step ms by rank "
          f"{[[round(t, 1) for t in r['step_ms_all']] for r in ranks]}; "
          f"staged bytes per rank {[r['staged_bytes'] for r in ranks]}; "
          f"peak memory per rank "
          f"{[round(r['peak_bytes'] / 2**30, 3) for r in ranks]} GiB; "
          f"{r0['n_buckets']} buckets; launches "
          f"{ {k: v for k, v in r0['launches'].items() if v} }; ranks differ"
          f" before each round and are bit-equal after it ({seconds:.1f} s)",
          flush=True)
    return {**r0, "round_s_by_rank": [r["round_s"] for r in ranks],
            "peak_bytes_by_rank": [r["peak_bytes"] for r in ranks],
            "seconds": seconds}


def check_rounds_w4_kernels(torch, ops, ref, lengths, card) -> None:
    """The int8_fused wire's kernels at every delta-bucket length of the
    world-4 run, with the card free again: quantize_ef writing the new
    residual into e's buffer, as the round calls it, and dequant_accum on
    a (4, n) stack of four ranks' payloads (the gathered shape of that
    run; 4 n comes near 2**31 at the embedding's bucket), each held
    bit-equal (NaN for NaN) to its plain version on the same inputs.  The
    gates of (c) compare the ranks with each other, which a deterministic
    wrong kernel passes."""
    dev = torch.device("cuda")
    for n in sorted(set(lengths)):
        gen = torch.Generator(dev).manual_seed(W4_SEED + 300 + n % 65521)
        g = torch.randn(n, generator=gen, device=dev)
        e = torch.randn(n, generator=gen, device=dev) * 0.1
        buf = e.clone()
        want = ref.quantize_ef_ref(g, e, tile=TILE)
        got = ops.quantize_ef(g, buf, tile=TILE, e_out=buf)
        torch.cuda.synchronize()
        if got[1].data_ptr() != buf.data_ptr() or not all(
                same(torch, a, b) for a, b in zip(got, want)):
            fail(f"rounds world-4 kernels: quantize_ef at the delta bucket "
                 f"length n={n} differs from the plain version or did not "
                 f"write the residual in place")
        q, sc = got[0], got[2]
        del g, e, buf, want, got
        torch.cuda.empty_cache()
        q4 = torch.stack([q.roll(r * 997) for r in range(W4)])
        s4 = torch.stack([sc * (1 + r) for r in range(W4)])
        del q, sc
        got = ops.dequant_accum(q4, s4, tile=TILE)
        torch.cuda.synchronize()
        ok = same(torch, got, ref.dequant_accum_ref(q4, s4, tile=TILE))
        del q4, s4, got
        torch.cuda.empty_cache()
        if not ok:
            fail(f"rounds world-4 kernels: dequant_accum at w = {W4}, n={n} "
                 f"differs from the plain version")
    print(f"rounds world-4 kernels [{card}]: quantize_ef (residual in place) "
          f"and dequant_accum at w = {W4} bit-equal to their plain versions "
          f"at every delta-bucket length {sorted(set(lengths))}", flush=True)


def phase_rounds(torch, ops, ref, train, card) -> dict:
    """Phase 10: (a) the three schedulers at full width, (b) the reduced
    card-vs-CPU runs and the checkpoint, (c) local SGD at world 4, then
    its kernels at its bucket lengths against their plain versions."""
    full = run_rounds(torch, ops, train, card)
    small = phase_small_rounds_reference(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    world4 = phase_rounds_world4(torch, card)
    check_rounds_w4_kernels(torch, ops, ref, world4["bucket_lengths"], card)
    return {"full_width": full, "small_reference": small, "world4": world4}

# ---------------------------------------------------------------------------
# 11. the communication planner: --sync auto at world 1 and at world 4
# ---------------------------------------------------------------------------

AUTO_ARGS = TRAIN_ARGS + ["--sync", "auto", "--topology",
                          "commodity_cluster"]
AUTO_W4_TOPOLOGY = "device:4@fast_ici"
AUTO_W4_T_BWD_S = 0.030
AUTO_W4_STEPS = 4
AUTO_W4_PERIOD = 2
AUTO_W4_SESSION = dict(arch="gemma-2b", layers=1, steps=AUTO_W4_STEPS,
                       batch=4, seq=128, optimizer="sgd", lr=3e-3, warmup=1,
                       seed=0)


def plan_launches(plan, rounds: int, world: int) -> dict:
    """The wire-kernel launches a plan makes in ``rounds`` rounds over one
    data axis of ``world`` ranks, derived bucket by bucket: topk_fused
    launches topk_ef (with error feedback) or topk_mask once per bucket
    and round; int8_fused quantize_ef (with error feedback) or
    quantize_tiles once, then dequant_accum once on the gather wire, or,
    on ring_fused at world > 1, quantize_tiles once per stream and hop
    (2·p); every other compressor runs plain ops.  All on the warp route
    (tile 1024)."""
    want: dict = {}

    def add(kernel, n):
        for k in (kernel, f"{kernel}[warp]"):
            want[k] = want.get(k, 0) + n
        if kernel == "quantize_ef":          # a wrapper without routes
            del want["quantize_ef[warp]"]

    for b in plan.buckets:
        ef = b.error_feedback and b.compressor != "none"
        if b.compressor == "topk_fused":
            add("topk_ef" if ef and b.fused else "topk_mask", rounds)
        elif b.compressor == "int8_fused":
            add("quantize_ef" if ef and b.fused else "quantize_tiles", rounds)
            if b.algo == "ring_fused":
                if world > 1:
                    add("quantize_tiles", RING_FUSED_STREAMS * world * rounds)
            elif b.fused:
                add("dequant_accum", rounds)
    return want


def bucket_lengths(plan, params) -> list:
    """Each bucket's packed length (elements), from the leaves it packs."""
    from repro_torch._tree import tree_leaves
    sizes = [math.prod(p.shape) for p in tree_leaves(params)]
    return [sum(sizes[i] for i in b.leaves) for b in plan.buckets]


def describe_buckets(plan, lengths) -> str:
    return "; ".join(
        f"{j}: {b.algo}/{b.compressor} leaves {list(b.leaves)} n={n} "
        f"({b.bucket_bytes} B priced)"
        for j, (b, n) in enumerate(zip(plan.buckets, lengths)))


def run_auto(torch, ops, train, card) -> dict:
    """Phase 11 (a): ``--sync auto --topology commodity_cluster`` through
    the CLI at phase 8's full width, NCCL world 1, every kernel counter
    set to 0 just before and read just after: the backward measured on
    the card, the executed plan the planned one bucket for bucket, the
    winner one of the priced arms, the wire kernels exactly as the plan
    derives them (``plan_launches``), losses finite; then a profiled
    step."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    session = train.main(AUTO_ARGS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = path_counts(ops)
    peak = torch.cuda.max_memory_allocated()
    if session.device.type != "cuda":
        fail(f"auto ran on {session.device}, not on the card")
    planned = session.planned
    sp, executed = planned["strategy_plan"], planned["executed"]
    if sp.key not in planned["arms"] or planned["arms"][sp.key] is not sp:
        fail(f"auto: the winner {sp.key} is not one of the priced arms "
             f"{sorted(planned['arms'])}")
    if executed is not sp:
        fail(f"auto: the winner {sp.key} did not run ({executed.key} did)")
    st = session.strategy
    reducer = st.param_reducer if sp.schedule.kind == "local_sgd" \
        else st.grad_reducer
    if reducer is None or reducer.plan.buckets != sp.comm.buckets:
        fail(f"auto: the executor's plan is not the planned one: "
             f"{None if reducer is None else reducer.plan.describe()} vs "
             f"{sp.comm.describe()}")
    losses = list(session.losses)
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"auto: losses {losses}")
    rounds = (session.param_rounds if sp.schedule.kind == "local_sgd"
              else session.grad_rounds)
    want = plan_launches(reducer.plan, rounds, session.world)
    if not any(want.values()):
        fail(f"auto: the plan {sp.key} runs no kernel of the port")
    for kname, count in launches.items():
        if count != want.get(kname, 0):
            fail(f"auto: kernel {kname} launched {count} times, expected "
                 f"{want.get(kname, 0)} (derived from the plan: "
                 f"{ {k: v for k, v in want.items() if v} } over {rounds} "
                 f"rounds)")
    lengths = bucket_lengths(reducer.plan, session.params)
    times = [t * 1e3 for t in session.step_times]
    res = {"t_backward_s": planned["t_backward_s"],
           "search_s": planned["search_s"], "winner": sp.key,
           "modeled_step_s": sp.modeled_step_s,
           "arms": sorted(planned["arms"]), "digest": planned["digest"],
           "buckets": [[b.algo, b.compressor, list(b.leaves), n,
                        b.bucket_bytes]
                       for b, n in zip(reducer.plan.buckets, lengths)],
           "losses": losses, "step_ms_all": times,
           "step_ms": statistics.median(times[1:]), "peak_bytes": peak,
           "launches": launches, "run_s": seconds,
           "rounds": rounds}
    print(f"auto world 1 [{card}]: {session.model_cfg.name} bf16, batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, {TRAIN_STEPS} steps on "
          f"commodity_cluster (world 256, a planning model): backward "
          f"measured {planned['t_backward_s'] * 1e3:.3f} ms, the search "
          f"{planned['search_s']:.3f} s of host time, winner {sp.key} "
          f"(modeled {sp.modeled_step_s * 1e3:.3f} ms/step, "
          f"{len(planned['arms'])} arms); buckets "
          f"{describe_buckets(reducer.plan, lengths)}; losses "
          f"{[round(x, 4) for x in losses]}; step times "
          f"{[round(t, 1) for t in times]} ms (median of steps 2-"
          f"{TRAIN_STEPS} {res['step_ms']:.3f}); peak memory "
          f"{peak / 2**30:.3f} GiB; launches "
          f"{ {k: v for k, v in launches.items() if v} } (= the plan's "
          f"{ {k: v for k, v in want.items() if v} }); run {seconds:.1f} s",
          flush=True)
    res["profile"] = profile_round(torch, session, card, "auto")
    res["wire"] = [(b.compressor, dict(b.compressor_args), n)
                   for b, n in zip(reducer.plan.buckets, lengths)]
    del session, reducer, st
    gc.collect()
    torch.cuda.empty_cache()
    return res


def check_auto_kernels(torch, ops, ref, wire, world: int, what: str,
                       card) -> None:
    """The kernels of an executed plan at every packed bucket length it
    runs them at, each bit-equal (NaN for NaN) to its plain version on
    the same inputs, called as the path calls them: topk_ef and
    quantize_ef write the residual into e's buffer; dequant_accum decodes
    the bucket's payload at ``world`` ranks (the gather wire at world 1);
    on ring_fused at world > 1, quantize_tiles on every row of the
    (p, m) hop buffers at the bucket's chunk lengths."""
    dev = torch.device("cuda")
    done = []
    for comp, args, n in wire:
        if comp not in ("topk_fused", "int8_fused"):
            continue
        gen = torch.Generator(dev).manual_seed(W4_SEED + 500 + n % 65521)
        g = torch.randn(n, generator=gen, device=dev)
        e = torch.randn(n, generator=gen, device=dev) * 0.1
        buf = e.clone()
        if comp == "topk_fused":
            ratio = float(args.get("ratio", 0.01))
            want = ref.topk_ef_ref(g, e, ratio=ratio, tile=TILE)
            got = ops.topk_ef(g, buf, ratio=ratio, tile=TILE, e_out=buf)
            name = "topk_ef"
        else:
            want = ref.quantize_ef_ref(g, e, tile=TILE)
            got = ops.quantize_ef(g, buf, tile=TILE, e_out=buf)
            name = "quantize_ef"
        torch.cuda.synchronize()
        if got[1].data_ptr() != buf.data_ptr() or not all(
                same(torch, a, b) for a, b in zip(got, want)):
            fail(f"{what}: {name} at the planned bucket length n={n} "
                 f"differs from the plain version or did not write the "
                 f"residual in place")
        done.append((name, n))
        if comp == "int8_fused" and world == 1:
            q1, s1 = got[0][None], got[2][None]
            if not same(torch, ops.dequant_accum(q1, s1, tile=TILE),
                        ref.dequant_accum_ref(q1, s1, tile=TILE)):
                fail(f"{what}: dequant_accum at n={n} differs from the "
                     f"plain version")
            done.append(("dequant_accum", n))
            del q1, s1
        del g, e, buf, want, got
        torch.cuda.empty_cache()
        if comp == "int8_fused" and world > 1:
            for m in ring_fused_hops(n):
                a = torch.randn(world, m, generator=gen, device=dev)
                for r in range(world):
                    got = ops.quantize_tiles(a[r], tile=TILE)
                    want = ref.quantize_tiles_ref(a[r], tile=TILE)
                    if not all(same(torch, x, y) for x, y in zip(got, want)):
                        fail(f"{what}: quantize_tiles on row {r} of the "
                             f"({world}, {m}) ring_fused hop buffer of the "
                             f"n={n} bucket differs from the plain version")
                    del got, want
                done.append(("quantize_tiles", m))
                del a
                torch.cuda.empty_cache()
    print(f"{what} kernels [{card}]: bit-equal to their plain versions at "
          f"the planned lengths {done}", flush=True)


def auto_w4_child(rank: int, world: int, store: str, out_dir: str,
                  expect: dict) -> None:
    """Phase 11 (b), one rank: gemma-2b at full width with 1 layer, SGD,
    ``plan_auto`` with a pinned local-SGD scheduler (τ = 2) on
    ``device:4@fast_ici`` at a pinned backward of 30 ms, a gloo group of
    4 processes on the one card.  Gates: the rank's plan is ``expect``
    (the port's planner on the CPU, same inputs) and every rank's digest
    is equal; 2 parameter rounds, before each the ranks differ and after
    it they are bit-equal; the wire kernels as ``plan_launches`` derives
    them from the plan."""
    os.environ["RANK"] = str(rank)
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import (SessionConfig, TrainSession, plan_decision,
                                 plan_digest)
    from repro_torch.core import get_scheduler
    from repro_torch.core.collectives import all_gather, p2p
    from repro_torch.kernels import ops
    from repro_torch.launch.dist import init_group
    from repro_torch.launch.report import render_strategy_plan
    torch.set_num_threads(2)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    init_group(torch.device("cpu"), world_size=world, rank=rank,
               store_path=store)
    group = dist.group.WORLD
    sess = TrainSession(SessionConfig(device="cuda", **AUTO_W4_SESSION),
                        group=group)
    torch.cuda.synchronize()
    dist.barrier()
    ops.reset_launch_counts()
    p2p.reset_staged_bytes()
    t0 = time.perf_counter()
    sp = sess.plan_auto(topology=AUTO_W4_TOPOLOGY,
                        t_backward_s=AUTO_W4_T_BWD_S,
                        scheduler=get_scheduler("local_sgd",
                                                period=AUTO_W4_PERIOD))
    plan_s = time.perf_counter() - t0
    if rank == 0:
        print(render_strategy_plan(
            sp, arms=sess.planned["arms"],
            baselines=sess.planned["baselines"],
            t_backward_s=sess.planned["t_backward_s"]), flush=True)
    mine = torch.tensor(list(bytes.fromhex(plan_digest(sp))),
                        dtype=torch.int64)
    every = all_gather(mine, group)
    w4_gate(all(torch.equal(every[r], every[0]) for r in range(world)),
            "the ranks' plan digests differ")
    w4_gate(plan_decision(sp) == expect,
            f"the plan {plan_decision(sp)} is not the port's CPU plan "
            f"{expect}")
    sess._build()
    rounds = watch_param_rounds(torch, sess)
    losses = sess.run(AUTO_W4_STEPS)
    torch.cuda.synchronize()
    counts = path_counts(ops)
    staged = p2p.staged_bytes()
    plan = sess.strategy.param_reducer.plan
    w4_gate(plan.buckets == sp.comm.buckets,
            "the executor's plan is not the planned one")
    w4_gate(all(map(math.isfinite, losses)), f"losses {losses}")
    n_rounds = AUTO_W4_STEPS // AUTO_W4_PERIOD
    w4_gate((sess.grad_rounds, sess.param_rounds) == (0, n_rounds) and
            len(rounds) == n_rounds,
            f"rounds (grad, param) = {(sess.grad_rounds, sess.param_rounds)}"
            f", expected (0, {n_rounds})")
    want = plan_launches(plan, n_rounds, world)
    w4_gate(any(want.values()), "the plan runs no kernel of the port")
    w4_launch_gate(counts, want, "auto local SGD rounds")
    gate_rounds_differ_then_agree(torch, rounds, world)
    lengths = bucket_lengths(plan, sess.params)
    res = {"rank": rank, "losses": losses, "plan_s": plan_s,
           "winner": sp.key, "digest": sess.planned["digest"],
           "step_ms_all": [t * 1e3 for t in sess.step_times],
           "round_s": [r[2] for r in rounds], "staged_bytes": staged,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "n_buckets": plan.n_buckets, "launches": counts,
           "buckets": describe_buckets(plan, lengths),
           "wire": [(b.compressor, dict(b.compressor_args), n)
                    for b, n in zip(plan.buckets, lengths)],
           "params": sess.num_params()}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def auto_w4_expected() -> dict:
    """The world-4 run's plan as the port's planner makes it on the CPU,
    from the same leaf sizes (``param_desc``: nothing allocated), backward
    time, topology and scheduler."""
    from repro_torch.api import plan_decision
    from repro_torch.configs import get_config
    from repro_torch.core.schedule import (Topology, profiles_from_grads,
                                           serial_round_plan)
    from repro_torch.core.schedule.planner import local_sgd_arm
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config(AUTO_W4_SESSION["arch"]),
                              num_layers=AUTO_W4_SESSION["layers"])
    profiles = profiles_from_grads(Model(cfg).param_desc(), AUTO_W4_T_BWD_S)
    topo = Topology.from_spec(AUTO_W4_TOPOLOGY)
    rp = serial_round_plan(profiles, topo, topo.world)
    return plan_decision(local_sgd_arm(rp, AUTO_W4_T_BWD_S, AUTO_W4_PERIOD))


def phase_auto_world4(torch, card) -> dict:
    """Four spawned ranks of ``auto_w4_child`` on the one card, after the
    port's planner made the same plan on the CPU."""
    expect = auto_w4_expected()
    wires = sorted({(b[1], b[2]) for b in expect["buckets"]})
    print(f"auto world 4: the port's planner on the CPU plans "
          f"{expect['key']} with {len(expect['buckets'])} buckets {wires} "
          f"for {AUTO_W4_TOPOLOGY} at a backward of "
          f"{AUTO_W4_T_BWD_S * 1e3:.0f} ms", flush=True)
    ranks, seconds = spawn_world4(torch, auto_w4_child, "auto_world4",
                                  (expect,))
    r0 = ranks[0]
    print(f"auto world 4 on one card over gloo [{card}]: gemma-2b d_model "
          f"2048 x 1 layer ({r0['params']} params bf16), SGD, --sync auto "
          f"--local-sgd {AUTO_W4_PERIOD} --topology {AUTO_W4_TOPOLOGY} "
          f"--plan-backward-ms {AUTO_W4_T_BWD_S * 1e3:.0f}, global batch "
          f"4 x seq 128, {AUTO_W4_STEPS} steps: the plan {r0['winner']} "
          f"(digest {r0['digest'][:16]}, equal on every rank, = the CPU "
          f"planner's) planned in {[round(r['plan_s'], 3) for r in ranks]} "
          f"s; buckets {r0['buckets']}; losses {r0['losses']}; round "
          f"seconds by rank {[[round(s, 4) for s in r['round_s']] for r in ranks]}"
          f"; step ms by rank "
          f"{[[round(t, 1) for t in r['step_ms_all']] for r in ranks]}; "
          f"staged bytes per rank {[r['staged_bytes'] for r in ranks]}; peak "
          f"memory per rank "
          f"{[round(r['peak_bytes'] / 2**30, 3) for r in ranks]} GiB; "
          f"launches { {k: v for k, v in r0['launches'].items() if v} }; "
          f"ranks differ before each round and are bit-equal after it "
          f"({seconds:.1f} s)", flush=True)
    return {**r0, "expect": expect,
            "round_s_by_rank": [r["round_s"] for r in ranks],
            "peak_bytes_by_rank": [r["peak_bytes"] for r in ranks],
            "seconds": seconds}


def phase_auto(torch, ops, ref, train, card) -> dict:
    """Phase 11: (a) ``--sync auto`` at world 1 at full width, then its
    kernels at its bucket lengths; (b) the planned local-SGD rounds at
    world 4, then their kernels at that plan's bucket and hop lengths."""
    from repro_torch.launch.dist import destroy_group
    world1 = run_auto(torch, ops, train, card)
    destroy_group()
    check_auto_kernels(torch, ops, ref, world1["wire"], 1, "auto world 1",
                       card)
    world4 = phase_auto_world4(torch, card)
    check_auto_kernels(torch, ops, ref, world4["wire"], W4, "auto world 4",
                       card)
    return {"world1": world1, "world4": world4}



def kernel_name(mangled: str) -> str:
    """A short name of a mangled kernel template: its name, then its
    element type and integer template arguments."""
    m = re.search(r"([a-z_]+_kernel)I(.*?)EEv", mangled)
    if not m:
        m = re.search(r"([a-z_]+_kernel)", mangled)
        return m.group(1) if m else mangled[:60]
    args = m.group(2)
    kind = ["bf16"] if "bfloat16" in args else ["f32"] if args[:1] == "f" \
        else []
    return f"{m.group(1)}<{', '.join(kind + re.findall(r'Li(\d+)E', args + 'E'))}>"


# libraries whose every kernel must compile with no spill and no stack
# frame (register arrays indexed at run time would land in a stack frame),
# and, for the tensor-core attention kernel, no serialized wgmma pipeline
PTXAS_STRICT = ("flash_attention_wgmma", "quantize_tiles", "quantize_ef",
                "topk_mask")
PTXAS_CLEAN = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"


def check_ptxas(name: str, log: str) -> None:
    """Print each kernel's registers and spills from the ``-Xptxas -v``
    report of library ``name``; fail, for the libraries of
    ``PTXAS_STRICT``, on a spill, a stack frame or a serialized wgmma."""
    kernel = "?"
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            kernel = kernel_name(line.split("'")[1])
        elif "registers" in line or "spill" in line:
            print(f"  ptxas {name} {kernel}: {line}")
        if name in PTXAS_STRICT and (
                "Performance Loss" in line or
                ("spill" in line and not line.startswith(PTXAS_CLEAN))):
            fail(f"ptxas: {name} {kernel}: {line}")


def kernel_line(name, launches, max_err_, timings, main_shape,
                routes=None) -> dict:
    """One entry of the ``{"kernels": [...]}`` line; ``launches`` maps each
    main-path run to the kernel's count there, and ``routes`` (for a
    wrapper with routes) maps each of its routes to such a map."""
    source, replaces, tpu_fn = KERNEL_SOURCES[name]
    t = timings[main_shape]
    total = sum(launches.values())
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "tpu_function": tpu_fn, "checked": True,
        "launches": total, "launches_on_path": total,
        "launches_by_run": launches, "launches_by_route": routes,
        "max_abs_err": max_err_,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t.get("library_ms"),
        "library_note": t.get("library_note") or
        "no single PyTorch call computes this function",
        "main_shape": main_shape, "shapes": timings}


def main() -> None:
    # torch.compile (the flex_attention library timing) keeps its caches
    # under build/, beside the port's kernels
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          str(ROOT / "build" / "torchinductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import get_config
        from repro_torch.kernels import build, ops, ref
        from repro_torch.kernels.flash_attention import (
            flash_attention_cuda, nonfinite_tiles_cuda)
        from repro_torch.kernels.quantize import quantize_tiles_cuda
        from repro_torch.launch import serve, train
        from repro_torch.launch.dist import destroy_group
    except ImportError as e:
        fail(f"the port (src/repro_torch) is not beside this script: {e}")

    # -- 1. device --------------------------------------------------------
    # the CPU side of the small training reference runs a gloo group of one
    # rank; loopback spares gloo a lookup of the host's name
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"device: {kind} x{count}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    try:
        libs = build.build_all()
    except RuntimeError as e:
        fail(str(e))
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.2f}s",
          flush=True)
    for name in libs:
        check_ptxas(name, build.build_log(name))

    # -- 3. kernels vs plain versions ---------------------------------------
    flash_err, flash_timings, tiles_timings = phase_flash(
        torch, ops, ref, flash_attention_cuda, nonfinite_tiles_cuda)
    for route, per_shape in flash_timings.items():
        for name, t in per_shape.items():
            lib = t["library_note"]
            if t["library_ms"] is not None:
                lib = (f"{t['library_ms'] * 1e3:.3f} us, max |Δ| "
                       f"{t['library_max_abs_err']:.3e} to the plain version, "
                       f"by {lib}")
            print(f"flash_attention {route} route {name} {t['shape']} bf16: "
                  f"device time kernel with its pre-pass "
                  f"{t['ms'] * 1e3:.3f} us ({t['tflops']:.2f} TFLOP/s), "
                  f"plain {t['plain_ms'] * 1e3:.3f} us, bound "
                  f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}), "
                  f"{t['bound_ms'] / t['ms']:.4f} of the bound, library {lib} "
                  f"({t['timer']}) [{card}]", flush=True)
    for name, t in tiles_timings.items():
        print(f"nonfinite_tiles {name} v {t['shape']} bf16: device time "
              f"{t['ms'] * 1e3:.3f} us, plain {t['plain_ms'] * 1e3:.3f} us, "
              f"bound {t['bound_ms'] * 1e3:.3f} us (bytes), "
              f"{t['bound_ms'] / t['ms']:.4f} of the bound ({t['timer']}) "
              f"[{card}]", flush=True)
    check_flash_gates(flash_timings["wgmma"])
    # the serving paths' shapes: one tile (head_dim) per cached entry, for
    # all stacked layers of a leaf at once
    cfg = get_config("gemma-2b")
    path_shapes = {**quantize_path_shapes("gemma-2b", SLOTS, MAX_LEN, PAGE),
                   **quantize_path_shapes("gemma2-9b", GEMMA2_SLOTS,
                                          GEMMA2_MAX_LEN, PAGE)}
    q_err, timings, q_block = phase_kernels(torch, ops, ref,
                                            quantize_tiles_cuda, path_shapes)
    for name, t in [*timings.items(), *q_block.items()]:
        route = "block" if name in q_block else "warp"
        print(f"quantize_tiles {route} route {name} n={t['n']} "
              f"tile={t['tile']} bf16: "
              f"device time kernel {t['ms'] * 1e3:.3f} us, plain "
              f"{t['plain_ms'] * 1e3:.3f} us, bound {t['bound_ms'] * 1e3:.3f}"
              f" us ({t['bound_by']}); eager call kernel "
              f"{t['call_ms'] * 1e3:.3f} us, plain "
              f"{t['plain_call_ms'] * 1e3:.3f} us ({t['timer']}) [{card}]",
              flush=True)
    train_err = phase_train_kernels(torch, ops, ref)
    buckets = train_bucket_sizes(cfg)
    train_shapes = {"largest_bucket": max(buckets), "first_bucket": buckets[0]}
    train_timings = train_path_kernels(torch, ops, ref, buckets, train_shapes)
    for name, per_shape in train_timings.items():
        for shape, t in per_shape.items():
            print(f"{name} {shape} n={t['n']} tile={t['tile']} "
                  f"{t['dtype']}: device time kernel "
                  f"{t['ms'] * 1e3:.3f} us, plain {t['plain_ms'] * 1e3:.3f} "
                  f"us, bound {t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}),"
                  f" {t['bound_ms'] / t['ms']:.3f} of the bound "
                  f"({t['timer']}) [{card}]", flush=True)
    check_tile_gates({"quantize_tiles": timings,
                      **{k: train_timings[k]
                         for k in ("topk_ef", "topk_mask",
                                   "dequant_accum")}})

    # -- 4. small references ----------------------------------------------
    for arch in SMALL_REFS:
        phase_small_reference(torch, arch)
    phase_small_train_reference(torch)

    # -- 5. the serving path at full width ----------------------------------
    ops.reset_launch_counts()
    run = serve.main(SERVE_ARGS)
    torch.cuda.synchronize()
    launches = path_counts(ops)
    if run.engines[0].device.type != "cuda":
        fail(f"the engine ran on {run.engines[0].device}, not on the card")
    check_main_path(torch, run, launches, card)

    # -- 6. static vs continuous, and a profile (information only) --------
    compare_static(torch, run, card)
    profile_ticks(torch, run.model, run.params, run.engines[0].cfg,
                  run.requests, card)
    del run
    gc.collect()
    torch.cuda.empty_cache()

    # -- 7. gemma2-9b served at full width -----------------------------------
    gemma2 = run_gemma2_serving(torch, ops, serve, card)
    s = gemma2["summary"]
    print(f"serving gemma2-9b [{card}]: tokens/s={s['tokens_per_s']:.3f} "
          f"p50 per-token latency={s['p50_s'] * 1e3:.3f} ms "
          f"p99={s['p99_s'] * 1e3:.3f} ms mean TTFT="
          f"{s['mean_ttft_s'] * 1e3:.3f} ms makespan={s['makespan_s']:.3f} s "
          f"(serve run {gemma2['seconds']:.2f} s)", flush=True)

    # -- 8. the training path at full width ---------------------------------
    trained = run_training(torch, ops, train, card)
    destroy_group()

    # -- 9. the explicit collectives at world 4 on the one card -------------
    world4 = phase_world4(torch, card, {"first": buckets[0],
                                        "mid": buckets[1],
                                        "largest": max(buckets)})

    # -- 10. the rounds axis -------------------------------------------------
    rounds = phase_rounds(torch, ops, ref, train, card)
    destroy_group()

    # -- 11. the communication planner ----------------------------------------
    auto = phase_auto(torch, ops, ref, train, card)

    serving = {"gemma-2b": launches, "gemma2-9b": gemma2["launches"]}

    def runs_of(name, runs):
        return {run_name: r[name] for run_name, r in runs.items()}

    def routes_of(kernel, runs):
        return {route: runs_of(f"{kernel}[{route}]", runs)
                for route in ops.KERNEL_ROUTES[kernel]}

    train_runs = {k: r["launches"] for k, r in trained.items()}
    # rank 0's counts (every rank's are gated equal)
    train_runs.update({f"world4_{k}": world4[k]["launches"] for k in
                       ("ring_fused", "int8_fused_ring", "topk_fused_ring")})
    train_runs.update({f"world4_mesh_{a}": r["launches"]
                       for a, r in world4["algos"].items()})
    train_runs.update({f"rounds_{k}": r["launches"]
                       for k, r in rounds["full_width"].items()})
    train_runs["rounds_world4_local_sgd"] = rounds["world4"]["launches"]
    train_runs["auto_world1"] = auto["world1"]["launches"]
    train_runs["auto_world4_local_sgd"] = auto["world4"]["launches"]
    flash_routes = routes_of("flash_attention", serving)
    quant_routes = routes_of("quantize_tiles", {**serving, **train_runs})
    quant_shapes = {**timings, **{f"train_{k}": t for k, t in
                                  train_timings["quantize_tiles"].items()},
                    "world4_ring_fused_hop": world4["quantize_tiles_hop"]}
    train_timings["dequant_accum"]["world4_mid_bucket_w4"] = \
        world4["dequant_accum_w4"]
    kernels = [
        kernel_line("flash_attention", flash_routes["wgmma"], flash_err,
                    flash_timings["wgmma"], "gemma2_9b_prefill_global",
                    flash_routes),
        kernel_line("flash_attention_simt", flash_routes["simt"], flash_err,
                    flash_timings["simt"], "gemma2_9b_prefill_global",
                    flash_routes),
        kernel_line("nonfinite_tiles", runs_of("nonfinite_tiles", serving),
                    0.0, tiles_timings, "gemma2_9b_prefill_global"),
        kernel_line("quantize_tiles", quant_routes["warp"], q_err,
                    quant_shapes, "gemma2_9b_prefill_write_8192",
                    quant_routes),
        kernel_line("quantize_tiles_block", quant_routes["block"], q_err,
                    q_block, "gemma2_9b_prefill_write_4096_tile4096",
                    quant_routes)]
    kernels.append(kernel_line("quantize_ef",
                               runs_of("quantize_ef", train_runs),
                               train_err["quantize_ef"],
                               train_timings["quantize_ef"],
                               "largest_bucket"))
    for kernel in ("dequant_accum", "topk_ef", "topk_mask"):
        routes = routes_of(kernel, train_runs)
        for name, route in ((kernel, "warp"), (f"{kernel}_block", "block")):
            kernels.append(kernel_line(name, routes[route], train_err[kernel],
                                       train_timings[name], "largest_bucket",
                                       routes))
    training = {k: {f: v for f, v in r.items() if f != "params"}
                for k, r in trained.items()}
    print(json.dumps({"training": training, "card": card}))
    print(json.dumps({"world4": world4, "card": card}))
    print(json.dumps({"rounds": rounds, "card": card}))
    print(json.dumps({"auto": auto, "card": card}))
    print(json.dumps({"serving_gemma2_9b": gemma2, "card": card}))
    print(json.dumps({"kernels": kernels, "card": card}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
