"""Training launcher of the port — a thin CLI over
``repro_torch.api.TrainSession`` (counterpart of ``repro/launch/train.py``).

  * --sync vanilla   BSP data-parallel, dense gradients (baseline)
  * --sync comm      every-step sync through --compressor / --algo /
                     --bucket-mb / --no-error-feedback

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --no-reduced --sync comm --compressor int8_fused

Runs on CUDA unless ``--device`` names another device; without CUDA and
without ``--device`` it raises.  One process is a process group of world 1
(``launch/dist.py``: NCCL on the card, gloo on the CPU, rendezvous through
a file, no network).  Weights are random, from a ``torch.Generator``
seeded with ``--seed``.  Every compressor, collective algorithm and
optimizer of the reference is taken; at world 1 every algorithm but psum
is the identity, as in the reference.  ``--sync auto`` (the planner) raises
and names its ROADMAP.md item.  Prints the loss and wall time of
every ``--log-every``-th step and the reference's final line.
"""
from __future__ import annotations

import argparse
from typing import Optional

from repro_torch.api import SessionConfig, TrainSession
from repro_torch.configs import ALL_ARCHS
from repro_torch.core import SyncConfig, make_strategy
from repro_torch.core.collectives import ALGOS


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
    ap.add_argument("--sync", default="vanilla",
                    help="vanilla | comm (auto is not ported yet)")
    ap.add_argument("--compressor", default="none",
                    help="none | sign | terngrad | qsgd | int8 | topk | "
                         "randomk | threshold | powersgd | svd | int8_fused "
                         "| topk_fused")
    ap.add_argument("--algo", default="psum", choices=ALGOS)
    ap.add_argument("--bucket-mb", type=float, default=32.0)
    ap.add_argument("--no-error-feedback", action="store_true")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, raising without one)")
    return ap


def strategy_from_args(args):
    """The every-step strategy of ``--sync comm`` (None for vanilla)."""
    if args.sync == "vanilla":
        return None
    if args.sync == "auto":
        raise NotImplementedError(
            "--sync auto needs the communication planner, which is not "
            "ported yet (ROADMAP.md queue 1, item 7)")
    if args.sync != "comm":
        raise ValueError(f"unknown --sync {args.sync!r}; known: vanilla, "
                         f"comm")
    return make_strategy("every_step", sync=SyncConfig(
        compressor=args.compressor, algo=args.algo,
        error_feedback=not args.no_error_feedback,
        bucket_bytes=int(args.bucket_mb * 2**20)))


def main(argv: Optional[list] = None) -> TrainSession:
    """Run the CLI; returns the session (losses, step times, state)."""
    args = build_parser().parse_args(argv)
    scfg = SessionConfig(
        arch=args.arch, reduced=args.reduced, steps=args.steps,
        batch=args.batch, seq=args.seq, lr=args.lr, warmup=args.warmup,
        optimizer=args.optimizer, seed=args.seed, device=args.device)
    strategy = strategy_from_args(args)
    session = TrainSession(scfg, strategy=strategy)
    if strategy is not None:
        print(f"strategy: {strategy.describe()}", flush=True)
    losses = session.run(args.steps, log_every=args.log_every)
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}) "
          f"steps/s {args.steps / session.wall_s:.2f} | {session.summary()}",
          flush=True)
    return session


if __name__ == "__main__":
    main()
