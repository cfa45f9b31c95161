"""Serving launcher of the port — counterpart of ``repro/launch/serve.py``:
the CLI over the continuous-batching engine (paged KV cache, optional
int8 KV through the Hopper quantize kernel, optional multi-replica
routing), with static batching and one-shot ``generate`` as modes.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        --no-reduced --quantize int8 --engine continuous

``--arch`` offers the architectures the port registers
(``configs.ALL_ARCHS``: gemma-2b, gemma2-9b, gemma3-4b).  Every prefill
runs its attention through ``kernels/ops.flash_attention`` (the Hopper
kernel on CUDA).  Runs on CUDA unless ``--device`` names another device;
without CUDA and without ``--device`` it raises.  Weights are random,
drawn from a ``torch.Generator`` seeded with ``--seed`` on the device.
``--plan`` prints the planner's serving placement search
(``core/schedule/planner.plan_serving``: tp degree × tier × replicas on
``--topology``, optionally under ``--latency-budget-ms``) before serving.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, get_config, reduced
from repro_torch.device import DeviceLike, resolve_device, tensor_device
from repro_torch.models import Model
from repro_torch.serve.engine import sample_token


class GenerateSession:
    """One-shot batched generation for one model: prefill the prompts
    together, then decode in lockstep with the scalar-``pos`` cache."""

    def __init__(self, model: Model):
        self.model = model

    def generate(self, params, prompts, gen: int, max_len: int,
                 rng: Optional[torch.Generator] = None,
                 temperature: float = 0.0) -> torch.Tensor:
        """prompts: (B, P) int (tensor or numpy).  Returns (B, gen) sampled
        tokens on the device of ``params``.  ``rng`` draws the samples at
        temperature > 0."""
        dev = tensor_device(params)
        if not isinstance(prompts, torch.Tensor):
            prompts = torch.from_numpy(np.asarray(prompts))
        prompts = prompts.to(device=dev, dtype=torch.int64)
        B, Plen = prompts.shape
        logits, cache = self.model.prefill(params, {"tokens": prompts},
                                           max_len=max_len)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out = [tok]
        for i in range(gen - 1):
            logits, cache = self.model.decode_step(params, tok, cache,
                                                   Plen + i)
            if temperature > 0:
                tok = torch.tensor([[sample_token(row, temperature, rng)]
                                    for row in logits[:, -1]],
                                   dtype=torch.int64, device=dev)
            else:
                tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            out.append(tok)
        return torch.cat(out, dim=1)


def generate(model: Model, params, prompts, gen: int, max_len: int,
             rng: Optional[torch.Generator] = None,
             temperature: float = 0.0) -> torch.Tensor:
    """prompts: (B, P) int. Returns (B, gen) sampled tokens."""
    return GenerateSession(model).generate(params, prompts, gen, max_len,
                                           rng=rng, temperature=temperature)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="serve a config on the GPU: continuous batching "
                    "engine, static batching, or one-shot generate")
    ap.add_argument("--arch", choices=ALL_ARCHS, default="gemma-2b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced config (--no-reduced for the full one)")
    ap.add_argument("--batch", type=int, default=4,
                    help="decode batch (engine slot count)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--engine",
                    choices=("continuous", "static", "oneshot"),
                    default="continuous")
    ap.add_argument("--requests", type=int, default=0,
                    help="trace length (default: --batch requests)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate, req/s (0 = all at t=0)")
    ap.add_argument("--max-len", type=int, default=0,
                    help="KV length per slot (default prompt+gen)")
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--pages", type=int, default=0,
                    help="KV pool pages (0 = fully provisioned)")
    ap.add_argument("--quantize", choices=("none", "int8"), default="none",
                    help="int8 paged KV (lossy)")
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--plan", action="store_true",
                    help="print the tp x tier serving placement search")
    ap.add_argument("--topology", default="two_tier_pod",
                    help="topology preset or spec for --plan")
    ap.add_argument("--latency-budget-ms", type=float, default=0.0)
    return ap


def print_plan(cfg, args):
    """The serving placement search for ``cfg`` on ``--topology``
    (bf16 weights: 2 bytes a parameter), printed as the reference prints
    it; returns the chosen arm."""
    from repro_torch.core.schedule import (TOPOLOGY_PRESETS, Topology,
                                           plan_serving)
    from repro_torch.launch.report import render_serving_plan
    from repro_torch.models.model import count_params
    spec = TOPOLOGY_PRESETS.get(args.topology, args.topology)
    net = Topology.from_spec(spec)
    budget = (args.latency_budget_ms / 1e3
              if args.latency_budget_ms > 0 else None)
    best, arms = plan_serving(
        net, net.world, count_params(cfg) * 2.0, cfg.num_layers,
        cfg.d_model, batch=args.batch, latency_budget_s=budget)
    print(render_serving_plan(best, arms, arch=cfg.name, batch=args.batch,
                              latency_budget_s=budget), flush=True)
    return best


@dataclasses.dataclass
class ServeRun:
    """What one CLI run built and produced (for callers that drive the CLI
    from Python, such as chip_smoke.py)."""
    cfg: Any
    model: Model
    params: Any
    requests: List[Any]
    completions: List[Any]
    engines: List[Any]
    tokens: np.ndarray
    seconds: float
    summary: dict


def main(argv=None) -> ServeRun:
    from repro_torch.serve import (Engine, MultiReplicaServer, Request,
                                   ServeConfig, run_static)
    from repro_torch.serve.engine import latency_summary, poisson_trace

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.plan:
        print_plan(cfg, args)
    model = Model(cfg)
    gen_ = torch.Generator(device).manual_seed(args.seed)
    params = model.init(gen_)
    max_len = args.max_len or (args.prompt_len + args.gen)
    if args.engine == "continuous":
        # pages tile the slot exactly: round the KV length up to a page
        max_len = -(-max_len // args.page_size) * args.page_size
    n_req = args.requests or args.batch

    t0 = time.perf_counter()
    if args.engine == "oneshot":
        prompts = torch.randint(0, cfg.vocab_size,
                                (args.batch, args.prompt_len),
                                generator=gen_, device=device)
        toks = generate(model, params, prompts, args.gen, max_len,
                        rng=gen_, temperature=args.temperature)
        toks = toks.cpu().numpy()
        dt = time.perf_counter() - t0
        print(f"arch={cfg.name} engine=oneshot device={device} generated "
              f"{toks.shape} in {dt:.2f}s ({args.batch * args.gen / dt:.1f} "
              f"tok/s)")
        print("sample:", toks[0][:16])
        return ServeRun(cfg, model, params, [], [], [], toks, dt, {})

    if args.rate > 0:
        requests = poisson_trace(n_req, 1.0 / args.rate, args.prompt_len,
                                 [args.gen], cfg.vocab_size, seed=args.seed)
        for r in requests:
            r.temperature = args.temperature
    else:
        trng = np.random.default_rng(args.seed)
        requests = [Request(
            rid=i,
            prompt=trng.integers(0, cfg.vocab_size,
                                 size=(args.prompt_len,)).astype(np.int32),
            max_new=args.gen, arrival_s=0.0,
            temperature=args.temperature) for i in range(n_req)]

    engines: List[Any] = []
    if args.engine == "static":
        comps = run_static(model, params, requests, args.batch, max_len)
    else:
        scfg = ServeConfig(
            max_batch=args.batch, max_len=max_len,
            page_size=args.page_size, n_pages=args.pages or None,
            quantize=None if args.quantize == "none" else args.quantize,
            seed=args.seed)
        engines = [Engine(model, params, scfg) for _ in range(args.replicas)]
        if args.replicas > 1:
            comps = MultiReplicaServer(engines).run(requests)
        else:
            comps = engines[0].run(requests)
    dt = time.perf_counter() - t0
    s = latency_summary(comps)
    print(f"arch={cfg.name} engine={args.engine} device={device} "
          f"replicas={args.replicas} requests={len(comps)} "
          f"tokens={s['tokens']} in {dt:.2f}s")
    print(f"  tokens/s={s['tokens_per_s']:.1f} p50={s['p50_s'] * 1e3:.2f}ms "
          f"p99={s['p99_s'] * 1e3:.2f}ms "
          f"ttft={s['mean_ttft_s'] * 1e3:.2f}ms (trace time)")
    toks = np.stack([c.tokens for c in comps])
    print("sample:", toks[0][:16])
    return ServeRun(cfg, model, params, requests, comps, engines, toks, dt, s)


if __name__ == "__main__":
    main()
