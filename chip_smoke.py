#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

  1. device: needs CUDA; prints the card's name and power limit
     (``nvidia-smi``); TF32 off for f32 matmuls and convolutions;
  2. build: every CUDA kernel of the port from the sources in the checkout
     (``nvcc``, one process per source, started together);
  3. kernels vs plain versions on the card: ``quantize_tiles`` must be
     bit-equal to its plain PyTorch version over a sweep of tiles, lengths
     and input types, and dequantize must round-trip within s/254; then
     kernel, plain-version and bound times at the serving path's shapes;
  4. small reference: the reduced gemma-2b in f32 on the card agrees with
     the port's CPU path (held against the JAX package by the tests);
  5. the main path at full width: ``repro_torch.launch.serve`` with
     gemma-2b (18 layers, d_model 2048, vocab 256000, bf16, random
     weights from seed 0), int8 paged KV, continuous batching, 8 requests
     of 128 prompt + 64 new tokens through 4 slots; every kernel launch
     counter is set to 0 just before and read just after;
  6. information only: the share of tokens at temperature 0 that the
     engine shares with ``run_static`` and ``generate``, and a
     ``torch.profiler`` view of ten decode ticks (device-busy share, top
     kernels).

It prints a ``{"kernels": [...]}`` JSON line and, last, ``{"ok": true,
"device": {...}}``.  It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
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
                x = sweep_input(torch, n, tile, dtype, dev)
                qk, sk = ops.quantize_tiles(x, tile=tile)
                qp, sp = ref.quantize_tiles_ref(x, tile=tile)
                torch.cuda.synchronize()
                err = max((qk.int() - qp.int()).abs().max().item(),
                          (sk - sp).abs().max().item())
                worst = max(worst, float(err))
                if not (torch.equal(qk, qp) and torch.equal(sk, sp)):
                    fail(f"quantize_tiles differs from the plain version at "
                         f"n={n} tile={tile} {dtype}: max err {err}")
                deq = ops.dequantize(qk, sk, tile=tile)
                # s/254 from rounding to nearest, plus f32 rounding of
                # (x / s) * 127 and of q * (s / 127): a few ulp of s
                srep = torch.repeat_interleave(sk, tile)[:n]
                bound = srep / 254.0 + srep * 2.0 ** -20
                if not (x.float() - deq).abs().le(bound).all():
                    fail(f"dequantize round trip beyond s/254 at n={n} "
                         f"tile={tile} {dtype}")
                cases += 1
    print(f"kernels: quantize_tiles bit-equal to the plain version in "
          f"{cases} cases (tiles {TILES}, f32 and bf16, zero tiles, "
          f"exact halves); dequantize within s/254", flush=True)

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


def check_main_path(torch, run, launches, card) -> None:
    """The serving run's results: every request complete with valid
    tokens, no page leaked, the kernel launched once per paged leaf per
    admission and per decode tick, finite full-width logits."""
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
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
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


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import get_config
        from repro_torch.kernels import build, ops, ref
        from repro_torch.kernels.quantize import quantize_tiles_cuda
        from repro_torch.launch import serve
    except ImportError as e:
        fail(f"the port (src/repro_torch) is not beside this script: {e}")

    # -- 1. device --------------------------------------------------------
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
    max_err, timings = phase_kernels(torch, ops, ref, quantize_tiles_cuda,
                                     path_shapes)
    for name, t in timings.items():
        print(f"quantize_tiles {name} n={t['n']} tile={t['tile']} bf16: "
              f"device time kernel {t['ms'] * 1e3:.3f} us, plain "
              f"{t['plain_ms'] * 1e3:.3f} us, bound {t['bound_ms'] * 1e3:.3f}"
              f" us ({t['bound_by']}); eager call kernel "
              f"{t['call_ms'] * 1e3:.3f} us, plain "
              f"{t['plain_call_ms'] * 1e3:.3f} us [{card}]", flush=True)

    # -- 4. small reference -----------------------------------------------
    phase_small_reference(torch)

    # -- 5. the main path at full width -------------------------------------
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

    d = timings["decode_write"]
    kernels = [{
        "name": "quantize_tiles", "route": "cuda",
        "source": "src/repro_torch/csrc/quantize_tiles.cu",
        "replaces": "src/repro/kernels/quantize_ef.py:99",
        "tpu_function": "quantize_pallas",
        "checked": True,
        "launches": launches["quantize_tiles"],
        "launches_on_path": launches["quantize_tiles"],
        "max_abs_err": max_err,
        "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
        "bound_by": d["bound_by"], "library_ms": None,
        "kernel_us": d["ms"] * 1e3, "plain_us": d["plain_ms"] * 1e3,
        "bound_us": d["bound_ms"] * 1e3, "library_us": None,
        "shapes": timings,
    }]
    print(json.dumps({"kernels": kernels, "card": card}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
