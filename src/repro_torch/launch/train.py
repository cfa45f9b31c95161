"""Training launcher of the port — a thin CLI over
``repro_torch.api.TrainSession`` (counterpart of ``repro/launch/train.py``).
Every flag maps onto a ``SyncStrategy`` = round scheduler × per-round
reducer:

  * --sync vanilla               BSP data-parallel, dense gradients
                                 (baseline)
  * --sync comm                  every-step sync through --compressor /
                                 --algo / --bucket-mb / --no-error-feedback
  * --local-sgd TAU              periodic averaging (+ --post-local N);
                                 with --sync comm the averaging round
                                 itself is compressed (params minus anchor)
  * --lag THRESH                 lazily aggregated gradients (a skipped
                                 round costs only the two-scalar probe)
  * --push-pull N_PUSH N_FETCH   Dean-style asymmetric push/pull cadences
  * --checkpoint PATH            write params + optimizer state after the
                                 run (``PATH.npz`` + ``PATH.json``)
  * --data-parallel N            a world of N ranks, spawned here (one
                                 process per rank); without it, one
                                 process is a world of 1

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --no-reduced --local-sgd 2 --sync comm --compressor int8_fused

Runs on CUDA unless ``--device`` names another device; without CUDA and
without ``--device`` it raises.  Ranks meet through a file
(``launch/dist.py``: NCCL on the card, one card per rank; gloo on the
CPU; no network).  Weights are random, from a ``torch.Generator`` seeded
with ``--seed``.  Every compressor, collective algorithm and optimizer of
the reference is taken.  ``--sync auto`` (the planner) raises and names
its ROADMAP.md item.  Rank 0 prints the loss and wall time of every
``--log-every``-th step and the reference's final line.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional

import torch

from repro_torch.api import SessionConfig, TrainSession
from repro_torch.configs import ALL_ARCHS
from repro_torch.core import (SyncConfig, SyncStrategy, get_scheduler,
                              make_strategy)
from repro_torch.core.collectives import ALGOS
from repro_torch.device import resolve_device
from repro_torch.launch.dist import destroy_group, init_group, spawn


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="data-parallel training with compressed gradient sync "
                    "on the GPU")
    ap.add_argument("--arch", choices=ALL_ARCHS, default="gemma-2b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=False, help="CPU-sized variant of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--optimizer", default="adam",
                    help="adam | sgd | lamb | lars")
    ap.add_argument("--data-parallel", type=int, default=0, metavar="N",
                    help="spawn a world of N ranks (one card each on CUDA, "
                         "gloo on the CPU); 0 or 1: this process alone")
    ap.add_argument("--sync", default="vanilla",
                    help="vanilla | comm (auto is not ported yet)")
    ap.add_argument("--compressor", default="none",
                    help="none | sign | terngrad | qsgd | int8 | topk | "
                         "randomk | threshold | powersgd | svd | int8_fused "
                         "| topk_fused")
    ap.add_argument("--algo", default="psum", choices=ALGOS)
    ap.add_argument("--bucket-mb", type=float, default=32.0)
    ap.add_argument("--no-error-feedback", action="store_true")
    ap.add_argument("--local-sgd", type=int, default=0, metavar="TAU")
    ap.add_argument("--post-local", type=int, default=0)
    ap.add_argument("--lag", type=float, default=0.0, metavar="THRESH")
    ap.add_argument("--push-pull", type=int, nargs=2, default=None,
                    metavar=("N_PUSH", "N_FETCH"),
                    help="push gradients every N_PUSH steps, fetch (average) "
                         "parameters every N_FETCH steps")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, raising without one)")
    return ap


def scheduler_from_args(args):
    """The rounds axis a user pinned explicitly (None -> every step)."""
    picked = [f for f, on in (("--lag", args.lag > 0),
                              ("--local-sgd", args.local_sgd > 1),
                              ("--push-pull", args.push_pull is not None))
              if on]
    if len(picked) > 1:
        raise SystemExit(f"pick one rounds schedule, got {picked}")
    if args.lag > 0:
        return get_scheduler("lag", threshold=args.lag)
    if args.local_sgd > 1:
        return get_scheduler("local_sgd", period=args.local_sgd,
                             post_local_after=args.post_local)
    if args.push_pull is not None:
        return get_scheduler("push_pull", n_push=args.push_pull[0],
                             n_fetch=args.push_pull[1])
    return None


def strategy_from_args(args):
    """The strategy of the flags (None for vanilla BSP): ``--sync comm``
    composes the scheduler (every step by default) with the config's
    reducer; ``--sync vanilla`` with a scheduler takes dense reducers."""
    scheduler = scheduler_from_args(args)
    if args.sync == "auto":
        raise NotImplementedError(
            "--sync auto needs the communication planner, which is not "
            "ported yet (ROADMAP.md queue 1, item 7)")
    if args.sync == "comm":
        return make_strategy(
            scheduler if scheduler is not None else "every_step",
            sync=SyncConfig(compressor=args.compressor, algo=args.algo,
                            error_feedback=not args.no_error_feedback,
                            bucket_bytes=int(args.bucket_mb * 2**20)))
    if args.sync != "vanilla":
        raise ValueError(f"unknown --sync {args.sync!r}; known: vanilla, "
                         f"comm")
    return SyncStrategy(scheduler=scheduler) if scheduler is not None \
        else None


def _quiet(*_, **__) -> None:
    pass


def run(args, rank: int = 0) -> TrainSession:
    """Train as the parsed flags say on the default group (joined or made
    at world 1); rank 0 prints.  Returns the session."""
    log = print if rank == 0 else _quiet
    scfg = SessionConfig(
        arch=args.arch, reduced=args.reduced, steps=args.steps,
        batch=args.batch, seq=args.seq, lr=args.lr, warmup=args.warmup,
        optimizer=args.optimizer, seed=args.seed, device=args.device)
    strategy = strategy_from_args(args)
    session = TrainSession(scfg, strategy=strategy)
    if session.world > 1:
        log(f"data parallel: world {session.world} on "
            f"{session.device.type}", flush=True)
    if strategy is not None:
        log(f"strategy: {strategy.describe()}", flush=True)
    losses = session.run(args.steps, log_every=args.log_every, log=log)
    if args.checkpoint:
        session.save_checkpoint(args.checkpoint)
        log("checkpoint written:", args.checkpoint, flush=True)
    log(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}) "
        f"steps/s {args.steps / session.wall_s:.2f} | {session.summary()}",
        flush=True)
    return session


def _rank_main(rank: int, world: int, store: str, argv: list) -> None:
    """One spawned rank of ``--data-parallel``: its card (cuda:rank) or the
    CPU, the world's group, then :func:`run`."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", rank)
        args.device = str(device)
    else:
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    init_group(device, world_size=world, rank=rank, store_path=store)
    try:
        run(args, rank)
    finally:
        destroy_group()


def main(argv: Optional[list] = None) -> Optional[TrainSession]:
    """Run the CLI; returns the session (losses, step times, state), or
    None after a spawned ``--data-parallel`` world."""
    args = build_parser().parse_args(argv)
    scheduler_from_args(args)        # "pick one" exits before any spawn
    world = args.data_parallel
    if world <= 1:
        return run(args)
    device = resolve_device(args.device)
    if device.type == "cuda" and world > torch.cuda.device_count():
        raise SystemExit(
            f"--data-parallel {world} on CUDA needs one card per rank (NCCL "
            f"takes one rank per device); this machine has "
            f"{torch.cuda.device_count()}")
    spawn(_rank_main, world,
          args=(list(sys.argv[1:] if argv is None else argv),))
    return None


if __name__ == "__main__":
    main()
