"""Training launcher of the port — a thin CLI over
``repro_torch.api.TrainSession`` (counterpart of ``repro/launch/train.py``).
Every flag maps onto a ``SyncStrategy`` = round scheduler × per-round
reducer:

  * --sync vanilla               BSP data-parallel, dense gradients
                                 (baseline)
  * --sync comm                  every-step sync through --compressor /
                                 --algo / --bucket-mb / --no-error-feedback
  * --sync auto                  the communication planner: measure the
                                 backward (or --plan-backward-ms), search
                                 rounds schedule x per-bucket compressor x
                                 algo x fusion (x shard / pipeline / tp
                                 arms) on the --topology or --link α-β
                                 model, print the plan and the fixed
                                 baselines, write the plan record, run the
                                 winner (with --local-sgd / --lag /
                                 --push-pull: that schedule, its wire
                                 planned)
  * --topology SPEC              a tiered network ("node:2@commodity,
                                 device:2@fast_ici" or a preset); at the
                                 session's world and with 2+ tiers the
                                 collectives run on one group per tier
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
the reference is taken.  ``--calibrate``, ``--replan-drift-pct`` and
``--replan-every`` raise and name ROADMAP.md queue 1, item 11;
``--parallelism`` names items 8-10.  Rank 0 prints the loss and wall
time of every ``--log-every``-th step, the plan, and the reference's
final line; it alone writes the plan record
(``artifacts/comm_plans_torch/<arch>.json``).
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import torch

from repro_torch.api import SessionConfig, TrainSession
from repro_torch.configs import ALL_ARCHS
from repro_torch.core import (SyncConfig, SyncStrategy, get_scheduler,
                              make_strategy)
from repro_torch.core.collectives import ALGOS
from repro_torch.core.schedule import LINK_PRESETS
from repro_torch.device import resolve_device
from repro_torch.launch.dist import destroy_group, init_group, spawn
from repro_torch.launch.report import render_strategy_plan, save_strategy_plan


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
                    choices=["vanilla", "comm", "auto"])
    ap.add_argument("--compressor", default="none",
                    help="none | sign | terngrad | qsgd | int8 | topk | "
                         "randomk | threshold | powersgd | svd | int8_fused "
                         "| topk_fused")
    ap.add_argument("--algo", default="psum", choices=ALGOS)
    ap.add_argument("--bucket-mb", type=float, default=32.0)
    ap.add_argument("--no-error-feedback", action="store_true")
    ap.add_argument("--topology", default="",
                    help="tiered network model: a spec 'node:4@datacenter,"
                         "device:8@fast_ici' (outermost tier first, @link "
                         "a --link preset) or a TOPOLOGY_PRESETS name; the "
                         "planner prices every collective phase on the tier "
                         "it traverses, at the tier-size product's world.  "
                         "With 2+ tiers and this run's world, the "
                         "collectives run on one process group per tier")
    ap.add_argument("--link", default="fast_ici",
                    choices=sorted(LINK_PRESETS),
                    help="flat α-β regime --sync auto plans for (ignored "
                         "under --topology)")
    ap.add_argument("--alpha", type=float, default=None,
                    help="override the link latency α in seconds (--sync "
                         "auto; ignored under --topology)")
    ap.add_argument("--beta-gbps", type=float, default=None,
                    help="override the link bandwidth in GB/s (--sync "
                         "auto; ignored under --topology)")
    ap.add_argument("--plan-backward-ms", type=float, default=0.0,
                    help="plan for this per-step backward time instead of "
                         "measuring it (--sync auto)")
    ap.add_argument("--compression-costs", default="", metavar="PATH",
                    help="measured per-compressor encode/decode cost table "
                         "(the reference's JSON format); replaces the "
                         "analytic compression term of --sync auto's model")
    ap.add_argument("--memory-budget-gb", type=float, default=None,
                    help="per-worker optimizer-state budget for --sync "
                         "auto: arms that do not fit are dropped")
    ap.add_argument("--parallelism", default="", metavar="SPEC",
                    help="not ported yet (ROADMAP.md queue 1, items 8-10)")
    ap.add_argument("--calibrate", action="store_true",
                    help="not ported yet (ROADMAP.md queue 1, item 11)")
    ap.add_argument("--replan-drift-pct", type=float, default=0.0,
                    metavar="PCT",
                    help="not ported yet (ROADMAP.md queue 1, item 11)")
    ap.add_argument("--replan-every", type=int, default=None,
                    help="not ported yet (ROADMAP.md queue 1, item 11)")
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


def check_unported(args) -> None:
    """Raise for the flags whose machinery is not ported yet, naming the
    ROADMAP.md item that owns it."""
    if args.parallelism:
        raise NotImplementedError(
            "--parallelism (sharded state, pipeline, tensor and expert "
            "axes as executed modes) is not ported yet (ROADMAP.md queue "
            "1, items 8-10)")
    late = [f for f, on in (("--calibrate", args.calibrate),
                            ("--replan-drift-pct",
                             args.replan_drift_pct > 0),
                            ("--replan-every",
                             args.replan_every is not None)) if on]
    if late:
        raise NotImplementedError(
            f"{', '.join(late)}: calibration and re-planning are not ported "
            f"yet (ROADMAP.md queue 1, item 11)")


def plan_session(session: TrainSession, args, scheduler, log) -> None:
    """``--sync auto``: plan on the session, print the plan with the fixed
    baselines, write the record (rank 0), and hold the free search to
    the planner's guarantee (auto <= the best fixed baseline)."""
    ignored = [f for f, on in (("--compressor", args.compressor != "none"),
                               ("--algo", args.algo != "psum"),
                               ("--bucket-mb", args.bucket_mb != 32.0),
                               ("--no-error-feedback",
                                args.no_error_feedback)) if on]
    if ignored:
        log(f"warning: --sync auto chooses per-bucket strategies; "
            f"ignoring {', '.join(ignored)}", flush=True)
    t0 = time.perf_counter()
    sp = session.plan_auto(
        link=args.link, alpha=args.alpha, beta_gbps=args.beta_gbps,
        scheduler=scheduler,
        t_backward_s=(args.plan_backward_ms / 1e3
                      if args.plan_backward_ms > 0 else None),
        memory_budget_gb=args.memory_budget_gb,
        compression_costs=args.compression_costs or None)
    planned = session.planned
    log(render_strategy_plan(sp, arms=planned["arms"],
                             baselines=planned["baselines"],
                             t_backward_s=planned["t_backward_s"]),
        flush=True)
    log(f"planned in {time.perf_counter() - t0:.3f} s (the search "
        f"{planned['search_s']:.3f} s; backward "
        f"{planned['t_backward_s'] * 1e3:.3f} ms "
        f"{'pinned' if args.plan_backward_ms > 0 else 'measured'}); "
        f"running {planned['executed'].key}; plan digest "
        f"{planned['digest']}", flush=True)
    if session.rank == 0:
        log(f"plan record: {save_strategy_plan(sp, args.arch)}", flush=True)
    best_fixed = min(p.modeled_step_s
                     for p in planned["baselines"].values())
    unconstrained = scheduler is None and args.memory_budget_gb is None
    if unconstrained and sp.modeled_step_s > best_fixed + 1e-12:
        raise RuntimeError(
            f"planner regression: auto strategy modeled "
            f"{sp.modeled_step_s:.6f}s > best fixed baseline "
            f"{best_fixed:.6f}s")


def install_strategy(session: TrainSession, args, log) -> None:
    """The strategy of the flags, over the session's data axes (one group
    per tier after a tiered ``--topology``): ``--sync auto`` plans it;
    ``--sync comm`` composes the scheduler (every step by default) with
    the config's reducer; ``--sync vanilla`` with a scheduler takes dense
    reducers, and without one is vanilla BSP (no strategy)."""
    scheduler = scheduler_from_args(args)
    if args.sync == "auto":
        plan_session(session, args, scheduler, log)
    elif args.sync == "comm":
        session.strategy = make_strategy(
            scheduler if scheduler is not None else "every_step",
            group=session.axes,
            sync=SyncConfig(compressor=args.compressor, algo=args.algo,
                            error_feedback=not args.no_error_feedback,
                            bucket_bytes=int(args.bucket_mb * 2**20)))
    elif scheduler is not None:
        session.strategy = SyncStrategy(scheduler=scheduler)


def _quiet(*_, **__) -> None:
    pass


def run(args, rank: int = 0, group=None) -> TrainSession:
    """Train as the parsed flags say on ``group`` (the default group,
    joined or made at world 1, when None); rank 0 prints.  Returns the
    session."""
    log = print if rank == 0 else _quiet
    check_unported(args)
    scfg = SessionConfig(
        arch=args.arch, reduced=args.reduced, steps=args.steps,
        batch=args.batch, seq=args.seq, lr=args.lr, warmup=args.warmup,
        optimizer=args.optimizer, seed=args.seed, device=args.device)
    session = TrainSession(scfg, group=group)
    if session.world > 1:
        log(f"data parallel: world {session.world} on "
            f"{session.device.type}", flush=True)
    if args.topology:
        superseded = [f for f, on in (("--link", args.link != "fast_ici"),
                                      ("--alpha", args.alpha is not None),
                                      ("--beta-gbps",
                                       args.beta_gbps is not None)) if on]
        if superseded:
            log(f"warning: --topology models the network per tier; "
                f"ignoring flat link flags {', '.join(superseded)}",
                flush=True)
        topo = session.apply_topology(args.topology)
        if session.tiered_mesh:
            log(f"topology: {topo.spec()} (tiered mesh, one process group "
                f"per tier: {'x'.join(t.name for t in topo.tiers)})",
                flush=True)
        else:
            log(f"topology: {topo.spec()} (planning model; executing on "
                f"the flat {session.world}-rank group)", flush=True)
    install_strategy(session, args, log)
    if session.strategy is not None:
        log(f"strategy: {session.strategy.describe()}", flush=True)
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
    check_unported(args)
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
