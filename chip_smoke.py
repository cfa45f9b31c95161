#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

  1. device: needs CUDA; prints the card's name and power limit
     (``nvidia-smi``); TF32 off for f32 matmuls and convolutions;
  2. build: every CUDA kernel of the port from the sources in the checkout
     (``nvcc``, one process per source, started together);
  3. kernels vs plain versions on the card, all held BIT-EQUAL (NaN for
     NaN): ``quantize_tiles`` over a sweep of tiles, lengths, input types
     and a NaN tile (and dequantize must round-trip within s/254);
     ``quantize_ef``, ``dequant_accum``, ``topk_ef`` and ``topk_mask`` over
     the CPU tests' cases (ragged lengths, decays, ratios, rank counts,
     zero tiles, exact halves, NaN tiles, bf16 for topk_mask) and at every
     bucket length of the training path, called as the path calls them
     (the residual written in place); then kernel, plain-version and bound
     times at the serving and training paths' shapes;
  4. small references: the reduced gemma-2b in f32 on the card agrees
     with the port's CPU path, for serving logits and for two int8_fused
     training steps (both held against the JAX package by the tests);
  5. the serving path at full width: ``repro_torch.launch.serve`` with
     gemma-2b (18 layers, d_model 2048, vocab 256000, bf16, random
     weights from seed 0), int8 paged KV, continuous batching, 8 requests
     of 128 prompt + 64 new tokens through 4 slots;
  6. information only: the share of tokens at temperature 0 that the
     engine shares with ``run_static`` and ``generate``, and a profile of
     ten decode ticks (device-busy share, top kernels);
  7. the training path at full width: ``repro_torch.launch.train`` with
     the same gemma-2b, Adam, batch 4 x seq 512, 3 steps on an NCCL group
     of world 1, once each with ``--sync comm --compressor int8_fused``,
     ``--sync comm --compressor topk_fused`` and ``--sync vanilla``;
     step time, tokens/s, peak memory and a ``torch.profiler`` view of one
     more step per run.

Every main-path run (5, and each of 7) sets every kernel launch counter to
0 just before it and reads them just after: each kernel of that run must
have launched, as often as the run's structure says.  Launches made in
phase 3 are not counted.  It prints a ``{"kernels": [...]}`` JSON line
and, last, ``{"ok": true, "device": {...}}``.  It imports nothing of JAX
or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
TILES = (64, 256, 1024)
QUANT_OPS_PER_ELEMENT = 7       # abs, max, div, mul, round, 2 clamps

SLOTS, MAX_LEN = 4, 256
SERVE_ARGS = ["--arch", "gemma-2b", "--no-reduced", "--quantize", "int8",
              "--engine", "continuous", "--batch", str(SLOTS),
              "--requests", "8", "--prompt-len", "128", "--gen", "64",
              "--max-len", str(MAX_LEN), "--page-size", "16", "--seed", "0"]

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 3
TRAIN_ARGS = ["--arch", "gemma-2b", "--no-reduced", "--optimizer", "adam",
              "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
              "--steps", str(TRAIN_STEPS), "--seed", "0", "--log-every", "1"]
TRAIN_RUNS = {   # run name: (extra CLI flags, kernels each bucket launches)
    "int8_fused": (["--sync", "comm", "--compressor", "int8_fused"],
                   ("quantize_ef", "dequant_accum")),
    "topk_fused": (["--sync", "comm", "--compressor", "topk_fused"],
                   ("topk_ef",)),
    "vanilla": (["--sync", "vanilla"], ()),
}
TILE = 1024
EF_SIZES = (1024, 1000, 2065, 4096)
RATIOS = (0.01, 0.05, 0.25)
ITERS = 16
# operations per element, for the bounds (f32, outside the tensor cores)
QEF_OPS = 10          # g + decay*e (2), abs, max, div, mul, round, clamp (2),
#                       residual (2): rounded to 10
TOPK_OPS = 3 + 2 * ITERS      # EF add (2), abs; per round a compare and an add
KERNEL_SOURCES = {
    "quantize_tiles": ("src/repro_torch/csrc/quantize_tiles.cu",
                       "src/repro/kernels/quantize_ef.py:99",
                       "quantize_pallas"),
    "quantize_ef": ("src/repro_torch/csrc/quantize_ef.cu",
                    "src/repro/kernels/quantize_ef.py:63",
                    "quantize_ef_pallas"),
    "dequant_accum": ("src/repro_torch/csrc/quantize_ef.cu",
                      "src/repro/kernels/quantize_ef.py:126",
                      "dequant_accum_pallas"),
    "topk_ef": ("src/repro_torch/csrc/topk_mask.cu",
                "src/repro/kernels/topk_mask.py:99", "topk_ef_pallas"),
    "topk_mask": ("src/repro_torch/csrc/topk_mask.cu",
                  "src/repro/kernels/topk_mask.py:65", "topk_mask_pallas"),
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


def phase_kernels(torch, ops, ref, quantize_tiles_cuda, path_shapes):
    dev = torch.device("cuda")
    worst = 0.0
    cases = 0
    for tile in TILES:
        sizes = {tile, 3 * tile + 17, 18 * 4 * 256, 18 * 128 * 256}
        sizes |= {n for n, t in path_shapes.values() if t == tile}
        for n in sorted(sizes):
            for dtype in (torch.float32, torch.bfloat16):
                for nan in ((False, True) if n >= 3 * tile else (False,)):
                    x = sweep_input(torch, n, tile, dtype, dev)
                    if nan:       # a NaN tile: NaN scale, int8 codes 0
                        x[tile + 3] = float("nan")
                    qk, sk = ops.quantize_tiles(x, tile=tile)
                    qp, sp = ref.quantize_tiles_ref(x, tile=tile)
                    torch.cuda.synchronize()
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
          f"{cases} cases (tiles {TILES}, f32 and bf16, zero tiles, "
          f"exact halves, NaN tiles); dequantize within s/254", flush=True)

    # timed in turns (plain, kernel, kernel, plain) within this call; the
    # kernel through its wrapper, which allocates q and scales per call
    timings = {}
    for name, (n, tile) in path_shapes.items():
        x = torch.randn(n, device=dev).to(torch.bfloat16)

        def kern():
            return quantize_tiles_cuda(x, tile)

        def plain():
            return ref.quantize_tiles_ref(x, tile=tile)
        p0, k0 = device_ms(torch, plain), device_ms(torch, kern)
        k1, p1 = device_ms(torch, kern), device_ms(torch, plain)
        b_ms, by = quantize_bound_ms(n, tile, 2)
        timings[name] = {
            "n": n, "tile": tile, "dtype": "bfloat16",
            "ms": min(k0, k1), "plain_ms": min(p0, p1),
            "call_ms": call_ms(torch, kern),
            "plain_call_ms": call_ms(torch, plain),
            "bound_ms": b_ms, "bound_by": by, "library_ms": None}
    return worst, timings


def phase_train_kernels(torch, ops, ref) -> dict:
    """The training wire's four kernels against their plain versions on
    the card, bit-equal (NaN for NaN) over the CPU tests' cases plus the
    largest bucket's length rounded to a ragged size.  Returns the worst
    |kernel - plain| per kernel (0.0 when every case is bit-equal)."""
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

    for n in EF_SIZES + (3 * 2**20 + 17,):
        for nan in ((False, True) if n >= 2 * TILE else (False,)):
            g, e = ef_inputs(torch, n, seed=n, nan=nan, device=dev)
            for decay in (1.0, 0.9):
                what = f"n={n} decay={decay} nan={nan}"
                got = ops.quantize_ef(g, e, decay=decay, tile=TILE)
                want = ref.quantize_ef_ref(g, e, decay=decay, tile=TILE)
                torch.cuda.synchronize()
                check("quantize_ef", got, want, what)
                q, _, sc = want
                for w in (1, 2, 8):
                    qw = torch.stack([q.roll(r) for r in range(w)])
                    sw = torch.stack([sc * (1 + r) for r in range(w)])
                    got = (ops.dequant_accum(qw, sw, tile=TILE),)
                    want = (ref.dequant_accum_ref(qw, sw, tile=TILE),)
                    torch.cuda.synchronize()
                    check("dequant_accum", got, want, f"{what} w={w}")
                for ratio in RATIOS:
                    got = ops.topk_ef(g, e, ratio=ratio, tile=TILE,
                                      iters=ITERS, decay=decay)
                    want = ref.topk_ef_ref(g, e, ratio=ratio, tile=TILE,
                                           iters=ITERS, decay=decay)
                    torch.cuda.synchronize()
                    check("topk_ef", got, want, f"{what} ratio={ratio}")
            for ratio in RATIOS:
                for dtype in (torch.float32, torch.bfloat16):
                    x = g.to(dtype)
                    got = (ops.topk_mask(x, ratio=ratio, tile=TILE,
                                         iters=ITERS),)
                    want = (ref.topk_mask_bisect_ref(x, ratio=ratio,
                                                     tile=TILE, iters=ITERS),)
                    torch.cuda.synchronize()
                    check("topk_mask", got, want,
                          f"n={n} nan={nan} ratio={ratio} {dtype}")
    print(f"kernels: training wire bit-equal to the plain versions "
          f"(NaN for NaN) in {cases} cases (lengths {EF_SIZES} and "
          f"{3 * 2**20 + 17}, decays 1.0/0.9, ratios {RATIOS}, ranks 1/2/8, "
          f"zero tiles, exact halves, NaN tiles, topk_mask f32 and bf16)",
          flush=True)
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
    """The four training-wire kernels at every bucket length of the
    training path, called through their wrappers as the path calls them:
    quantize_ef and topk_ef (ratio 0.01, decay 1.0) write the new residual
    into e's buffer, dequant_accum decodes one rank's quantize_ef payload
    (world 1), and topk_mask masks the same bucket.  Each result is held
    bit-equal (NaN for NaN) to the plain version on the same inputs.  Then,
    at the lengths named in ``timed``, kernel, plain-version and bound
    times in turns (plain, kernel, kernel, plain): long calls with CUDA
    events, short ones by CUDA-graph replay.  Returns {kernel: {shape name:
    timing dict}}."""
    from repro_torch.kernels.quantize_ef import (dequant_accum_cuda,
                                                 quantize_ef_cuda)
    from repro_torch.kernels.topk_mask import topk_ef_cuda, topk_mask_cuda
    dev = torch.device("cuda")
    k = max(1, int(TILE * 0.01))
    out = {name: {} for name in ("quantize_ef", "dequant_accum", "topk_ef",
                                 "topk_mask")}
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
        check("topk_mask", (ops.topk_mask(g, tile=TILE),),
              (ref.topk_mask_bisect_ref(g, tile=TILE),), n)
        shape = shape_of.get(n)
        if shape is None:
            del g, e, buf, q1, s1
            torch.cuda.empty_cache()
            continue
        nt = -(-n // TILE)
        cases = {
            "quantize_ef": (lambda: quantize_ef_cuda(g, buf, 1.0, TILE, buf),
                            lambda: ref.quantize_ef_ref(g, e, tile=TILE),
                            bound(13 * n + 4 * nt, QEF_OPS * n)),
            "dequant_accum": (lambda: dequant_accum_cuda(q1, s1, TILE),
                              lambda: ref.dequant_accum_ref(q1, s1,
                                                            tile=TILE),
                              bound(5 * n + 4 * nt, 2 * n)),
            "topk_ef": (lambda: topk_ef_cuda(g, buf, k, TILE, ITERS, 1.0,
                                             buf),
                        lambda: ref.topk_ef_ref(g, e, tile=TILE),
                        bound(16 * n, TOPK_OPS * n)),
            "topk_mask": (lambda: topk_mask_cuda(g, k, TILE, ITERS),
                          lambda: ref.topk_mask_bisect_ref(g, tile=TILE),
                          bound(8 * n, (1 + 2 * ITERS) * n)),
        }
        big = n > 2**24
        timer = events_ms if big else device_ms
        for name, (kern, plain, (b_ms, by)) in cases.items():
            p0, k0 = timer(torch, plain), timer(torch, kern)
            k1, p1 = timer(torch, kern), timer(torch, plain)
            out[name][shape] = {
                "n": n, "tile": TILE, "dtype": "float32",
                "ms": min(k0, k1), "plain_ms": min(p0, p1),
                "bound_ms": b_ms, "bound_by": by, "library_ms": None,
                "timer": "cuda events, eager" if big else "cuda graph"}
            torch.cuda.synchronize()
        del g, e, buf, q1, s1, cases
        torch.cuda.empty_cache()
    print(f"kernels: training wire bit-equal to the plain versions at every "
          f"bucket length of the training path {sorted(set(buckets))} "
          f"(residual written in place, dequant_accum at w=1)", flush=True)
    return out


def phase_small_reference(torch):
    """Reduced gemma-2b in f32: the card's logits against the CPU path's
    on the same weights and tokens (max|Δ| <= 1e-4 · max|logit|; TF32 is
    off, so the difference is summation order only)."""
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import Model
    cfg = reduced(get_config("gemma-2b"))
    model = Model(cfg)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    params_gpu = tree_map(lambda t: t.to("cuda"), params)
    g = torch.Generator("cpu").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    forced = torch.randint(0, cfg.vocab_size, (4, 2, 1), generator=g)
    out = {}
    for dev, p in (("cpu", params), ("cuda", params_gpu)):
        logits, cache = model.prefill(p, {"tokens": tokens.to(dev)},
                                      max_len=24)
        seq = [logits.float().cpu()]
        for i in range(4):
            pos = torch.tensor([16 + i, 13 + i], device=dev)
            logits, cache = model.decode_step(p, forced[i].to(dev), cache,
                                              pos)
            seq.append(logits.float().cpu())
        out[dev] = torch.stack(seq)
    err = (out["cuda"] - out["cpu"]).abs().max().item()
    scale = out["cpu"].abs().max().item()
    if not (torch.isfinite(out["cuda"]).all() and err <= 1e-4 * scale):
        fail(f"reduced gemma-2b on the card disagrees with the CPU path: "
             f"max|Δ|={err} vs 1e-4·{scale}")
    print(f"small reference: reduced gemma-2b f32, prefill + 4 vector-pos "
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
                  if any(w in k for w in ("quantize_ef_kernel",
                                          "dequant_accum_kernel",
                                          "topk_ef_kernel")))
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
        launches = ops.launch_counts()
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


def check_main_path(torch, run, launches, card) -> None:
    """The serving run's results: every request complete with valid
    tokens, no page leaked, the quantize kernel launched once per paged
    leaf per admission and per decode tick (and no other kernel), finite
    full-width logits."""
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
    expected = leaves * (eng.prefills + eng.decode_ticks)
    if launches["quantize_tiles"] != expected or expected <= 0:
        fail(f"quantize_tiles launched {launches['quantize_tiles']} times on "
             f"the main path, expected {expected} = {leaves} leaves x "
             f"({eng.prefills} admissions + {eng.decode_ticks} decode ticks)")
    for name, n in launches.items():
        if name != "quantize_tiles" and n != 0:
            fail(f"kernel {name} launched {n} times on the serving path, "
                 f"which runs none of the training wire's kernels")
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
          f"{eng.decode_ticks}))", flush=True)
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


def profile_ticks(torch, run, card, ticks: int = 10) -> None:
    """Information only: where a decode tick's time goes.  Four requests
    are admitted into a fresh int8 engine, then ``ticks`` pure decode ticks
    are timed bare and again under ``torch.profiler``; prints the wall
    time per tick, the device-busy share and the top device kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import Engine
    eng = Engine(run.model, run.params, run.engines[0].cfg)
    for r in run.requests[:4]:
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
        return
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


def kernel_line(name, launches, max_err_, timings, main_shape) -> dict:
    """One entry of the ``{"kernels": [...]}`` line."""
    source, replaces, tpu_fn = KERNEL_SOURCES[name]
    t = timings[main_shape]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "tpu_function": tpu_fn, "checked": True,
        "launches": launches, "launches_on_path": launches,
        "max_abs_err": max_err_,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "library_note": "no single PyTorch call computes this function",
        "main_shape": main_shape, "shapes": timings}


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import get_config
        from repro_torch.kernels import build, ops, ref
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
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # -- 3. kernels vs plain versions ---------------------------------------
    # the serving path's shapes: one tile (head_dim) per cached entry, for
    # all stacked layers at once: a decode tick writes one entry per slot,
    # an admission writes a slot's whole max_len row
    cfg = get_config("gemma-2b")
    entry = cfg.num_layers * cfg.num_kv_heads * cfg.hd
    path_shapes = {"decode_write": (entry * SLOTS, cfg.hd),
                   "prefill_write": (entry * MAX_LEN, cfg.hd)}
    q_err, timings = phase_kernels(torch, ops, ref, quantize_tiles_cuda,
                                   path_shapes)
    for name, t in timings.items():
        print(f"quantize_tiles {name} n={t['n']} tile={t['tile']} bf16: "
              f"device time kernel {t['ms'] * 1e3:.3f} us, plain "
              f"{t['plain_ms'] * 1e3:.3f} us, bound {t['bound_ms'] * 1e3:.3f}"
              f" us ({t['bound_by']}); eager call kernel "
              f"{t['call_ms'] * 1e3:.3f} us, plain "
              f"{t['plain_call_ms'] * 1e3:.3f} us [{card}]", flush=True)
    train_err = phase_train_kernels(torch, ops, ref)
    buckets = train_bucket_sizes(cfg)
    train_shapes = {"largest_bucket": max(buckets), "first_bucket": buckets[0]}
    train_timings = train_path_kernels(torch, ops, ref, buckets, train_shapes)
    for name, per_shape in train_timings.items():
        for shape, t in per_shape.items():
            print(f"{name} {shape} n={t['n']} f32: device time kernel "
                  f"{t['ms'] * 1e3:.3f} us, plain {t['plain_ms'] * 1e3:.3f} "
                  f"us, bound {t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}),"
                  f" {t['bound_ms'] / t['ms']:.3f} of the bound "
                  f"({t['timer']}) [{card}]", flush=True)

    # -- 4. small references ----------------------------------------------
    phase_small_reference(torch)
    phase_small_train_reference(torch)

    # -- 5. the serving path at full width ----------------------------------
    ops.reset_launch_counts()
    run = serve.main(SERVE_ARGS)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    if run.engines[0].device.type != "cuda":
        fail(f"the engine ran on {run.engines[0].device}, not on the card")
    check_main_path(torch, run, launches, card)

    # -- 6. static vs continuous, and a profile (information only) --------
    compare_static(torch, run, card)
    profile_ticks(torch, run, card)
    del run
    gc.collect()
    torch.cuda.empty_cache()

    # -- 7. the training path at full width ---------------------------------
    trained = run_training(torch, ops, train, card)
    destroy_group()

    def path_launches(name):
        return sum(r["launches"][name] for r in trained.values())

    kernels = [kernel_line("quantize_tiles", launches["quantize_tiles"],
                           q_err, timings, "decode_write")]
    for name in ("quantize_ef", "dequant_accum", "topk_ef", "topk_mask"):
        kernels.append(kernel_line(name, path_launches(name),
                                   train_err[name], train_timings[name],
                                   "largest_bucket"))
    training = {k: {f: v for f, v in r.items() if f != "params"}
                for k, r in trained.items()}
    print(json.dumps({"training": training, "card": card}))
    print(json.dumps({"kernels": kernels, "card": card}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
