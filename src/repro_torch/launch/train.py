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
  * --parallelism SPEC           'dp=D,shard': sharded data parallelism
                                 (gradients reduce-scatter per bucket, f32
                                 master params and optimizer moments
                                 partitioned 1/world, params gathered
                                 back); prints the per-worker memory line
                                 after training.  'pp=S,micro=M': the
                                 1F1B pipeline on a pipe(S) x data mesh,
                                 the gradient sync per layer row on the
                                 data axis ('micro=M' alone: micro-batched
                                 accumulation); prints the stage table
                                 after training.  'dp=D,tp=T' / 'dp=D,ep=E':
                                 tensor / expert parallelism as planning
                                 and record axes (the DP edge runs over
                                 the ranks, the spec rides in describe()
                                 and the plan record), as the reference.
                                 Under --sync auto it pins the planner's
                                 arms to the spec.  (--shard-state,
                                 --pipeline-stages, --micro-batches: the
                                 deprecated shims)
  * --calibrate                  time the collectives of this world (one
                                 process group per tier) and fit per-tier
                                 α/β; --sync auto prices every arm on the
                                 fitted fabric, and the record gains the
                                 calibration and drift blocks
  * --replan-drift-pct PCT       re-run the planner mid-training when the
                                 measured step drifts more than PCT% from
                                 the modeled wall step, checked every
                                 --replan-every steps (default 25)
  * --elastic                    the supervised fault-tolerant step loop
                                 (``elastic.ElasticRuntime``) on the
                                 --topology fleet: a kill or restore of
                                 --fault-trace reshards in process through
                                 the leaf-shaped checkpoint onto the
                                 surviving topology (a planning model, as
                                 in the reference), a slowdown demotes the
                                 rounds cadence; prints the events table.
                                 The checkpoints go to a ``mkdtemp``
                                 directory (``elastic_*``), made once
                                 before the ranks of --data-parallel
                                 spawn, and left there, as the reference
                                 leaves it
  * --fault-trace SPEC_OR_PATH   the deterministic fault schedule of
                                 --elastic ('kill:3@5,slow:1x4@3,
                                 restore:3@9' or a JSON trace file)
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
the reference is taken.
``--arch`` takes every model the port registers (``configs.ALL_ARCHS``:
gemma-2b, gemma2-9b, gemma3-4b, deepseek-67b, chameleon-34b,
qwen3-moe-30b-a3b, deepseek-v2-lite-16b).  Rank 0 prints the loss and
wall time of every ``--log-every``-th step (with the MoE drop share for
an MoE model), the plan, the ``moe capacity:`` line after an MoE run,
and the reference's final line; it alone writes the plan record
(``artifacts/comm_plans_torch/<arch>.json``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time
from typing import Optional

import torch

from repro_torch.api import SessionConfig, TrainSession
from repro_torch.configs import ALL_ARCHS
from repro_torch.core import (ParallelismSpec, SyncConfig, SyncStrategy,
                              get_scheduler, make_strategy)
from repro_torch.core.collectives import ALGOS
from repro_torch.core.schedule import LINK_PRESETS, Topology
from repro_torch.device import resolve_device
from repro_torch.elastic import ElasticConfig, ElasticRuntime, FaultSchedule
from repro_torch.launch.dist import destroy_group, init_group, spawn
from repro_torch.launch.report import (render_elastic_events,
                                       render_moe_drops,
                                       render_pipeline_stages,
                                       render_sharded_memory,
                                       render_drift_table,
                                       render_strategy_plan,
                                       save_strategy_plan)


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
                         "auto: arms that do not fit are dropped, which is "
                         "how the shard axis wins (it never wins on wall "
                         "clock)")
    ap.add_argument("--parallelism", default="", metavar="SPEC",
                    help="the parallelism axis in one spec, e.g. "
                         "'dp=4,shard': sharded data parallelism "
                         "(gradients reduce-scatter per bucket, f32 master "
                         "params and optimizer moments partitioned over "
                         "the ranks, params all-gathered back), "
                         "'pp=2,micro=8': the 1F1B pipeline (micro "
                         "defaults to 8 with pp > 1; 'micro=M' alone: "
                         "micro-batched accumulation); 'dp=2,tp=2' / "
                         "'dp=2,ep=2': tensor / expert parallelism as "
                         "planning and record axes; under --sync auto "
                         "only arms of the spec may win")
    ap.add_argument("--shard-state", action="store_true",
                    help="DEPRECATED shim for --parallelism '...,shard'")
    ap.add_argument("--pipeline-stages", type=int, default=1, metavar="S",
                    help="DEPRECATED shim for --parallelism 'pp=S'. "
                         "Pipeline parallelism (DESIGN.md §9): cut the "
                         "model into S stages on a pipe x data mesh and "
                         "run 1F1B micro-batching; the gradient sync "
                         "(--compressor/--algo, or the planner's pick "
                         "under --sync auto) runs on the data axis only, "
                         "per layer row")
    ap.add_argument("--micro-batches", type=int, default=0, metavar="M",
                    help="DEPRECATED shim for --parallelism 'micro=M'. "
                         "Micro-batches per step (default: 8 in pipeline "
                         "mode, 1 otherwise; bubble fraction "
                         "(S-1)/(S-1+M); the global batch must split into "
                         "data shards x M).  M > 1 with --pipeline-stages "
                         "1 runs micro-batched gradient accumulation "
                         "through the same step")
    ap.add_argument("--calibrate", action="store_true",
                    help="time real collectives on this world's process "
                         "groups before planning and fit per-tier α/β "
                         "(with confidence bounds) — --sync auto then "
                         "prices every arm on the FITTED fabric instead of "
                         "the presets, and the plan record gains "
                         "calibration + drift blocks")
    ap.add_argument("--replan-drift-pct", type=float, default=0.0,
                    metavar="PCT",
                    help="re-run the planner mid-training when the "
                         "measured step time drifts more than PCT%% from "
                         "the modeled wall step (checked every "
                         "--replan-every steps; 0 = off, the default)")
    ap.add_argument("--replan-every", type=int, default=25,
                    help="steps between drift checks for "
                         "--replan-drift-pct (default 25)")
    ap.add_argument("--local-sgd", type=int, default=0, metavar="TAU")
    ap.add_argument("--post-local", type=int, default=0)
    ap.add_argument("--lag", type=float, default=0.0, metavar="THRESH")
    ap.add_argument("--push-pull", type=int, nargs=2, default=None,
                    metavar=("N_PUSH", "N_FETCH"),
                    help="push gradients every N_PUSH steps, fetch (average) "
                         "parameters every N_FETCH steps")
    ap.add_argument("--elastic", action="store_true",
                    help="supervised fault-tolerant step loop (DESIGN.md "
                         "§15): survive worker preemption by resharding "
                         "through the portable checkpoint — no process "
                         "restart — and demote the sync cadence under "
                         "stragglers.  Requires --topology (its world is "
                         "the fleet the fault trace runs against); "
                         "composes with vanilla/comm/auto and pinned "
                         "rounds schedulers, not with pipeline stages")
    ap.add_argument("--fault-trace", default="", metavar="SPEC_OR_PATH",
                    help="deterministic fault schedule for --elastic: a "
                         "compact spec 'kill:3@5,slow:1x4@3,restore:3@9' "
                         "(kind:worker[xfactor]@step) or a path to a JSON "
                         "trace file (FaultSchedule.to_json).  Empty = "
                         "no faults (the supervised loop still runs)")
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


def resolve_cli_parallelism(args) -> ParallelismSpec:
    """Fold the CLI's parallelism surface — the ``--parallelism`` spec and
    the deprecated ``--shard-state`` / ``--pipeline-stages`` /
    ``--micro-batches`` shims — into one ``ParallelismSpec``, with the
    reference's pipeline default of 8 micro-batches when ``pp > 1``.
    Mixing the spec with a shim is a SystemExit; shims alone warn and
    build the equivalent spec.  ``tp`` and ``ep`` above 1 are planning
    and record axes, as in the reference's session."""
    legacy_used = [f for f, on in
                   (("--shard-state", args.shard_state),
                    ("--pipeline-stages", args.pipeline_stages != 1),
                    ("--micro-batches", args.micro_batches != 0)) if on]
    if args.parallelism:
        if legacy_used:
            raise SystemExit(
                f"--parallelism subsumes {', '.join(legacy_used)}; fold "
                f"them into the spec (e.g. 'dp=4,pp=2,micro=8,shard')")
        try:
            spec = ParallelismSpec.from_spec(args.parallelism)
        except ValueError as e:
            raise SystemExit(f"--parallelism: {e}")
        if spec.pp > 1 and not spec.micro_batches:
            # the executor's pipeline default (bubble (S-1)/(S-1+M))
            spec = dataclasses.replace(spec, micro_batches=8)
    else:
        if legacy_used:
            print(f"warning: {', '.join(legacy_used)} deprecated; use "
                  f"--parallelism (e.g. 'dp=4,pp=2,micro=8,shard')",
                  flush=True)
        pipe = args.pipeline_stages
        if pipe < 1:
            raise SystemExit(f"--pipeline-stages must be >= 1, got {pipe}")
        micro = args.micro_batches or (8 if pipe > 1 else 1)
        if pipe > 1 and args.shard_state:
            raise SystemExit("--pipeline-stages and --shard-state are "
                             "competing answers to the optimizer-memory "
                             "axis; pick one (DESIGN.md §9)")
        spec = ParallelismSpec.legacy(shard_state=args.shard_state,
                                      pipeline_stages=pipe,
                                      micro_batches=micro)
    return spec


def plan_session(session: TrainSession, args, scheduler, par_spec,
                 log) -> None:
    """``--sync auto``: calibrate the fabric first under ``--calibrate``,
    plan on the session (a ``--parallelism`` spec pins the free search's
    arms, ``--shard-state`` its shard axis), print the plan with the
    fixed baselines, write the record (rank 0), and hold the free search
    to the planner's guarantee (auto <= the best fixed baseline)."""
    ignored = [f for f, on in (("--compressor", args.compressor != "none"),
                               ("--algo", args.algo != "psum"),
                               ("--bucket-mb", args.bucket_mb != 32.0),
                               ("--no-error-feedback",
                                args.no_error_feedback)) if on]
    if ignored:
        log(f"warning: --sync auto chooses per-bucket strategies; "
            f"ignoring {', '.join(ignored)}", flush=True)
    cal = None
    if args.calibrate:
        cal = session.calibrate()
        log(cal.describe(), flush=True)
    if args.parallelism and scheduler is not None:
        raise SystemExit("--parallelism pins arms of --sync auto's free "
                         "search; a pinned rounds scheduler bypasses that "
                         "search — drop one")
    plan_kw = dict(
        link=args.link, alpha=args.alpha, beta_gbps=args.beta_gbps,
        t_backward_s=(args.plan_backward_ms / 1e3
                      if args.plan_backward_ms > 0 else None),
        memory_budget_gb=args.memory_budget_gb,
        compression_costs=args.compression_costs or None,
        calibration=cal)
    t0 = time.perf_counter()
    pipe, micro = par_spec.pp, max(par_spec.micro_batches, 1)
    if args.parallelism:
        sp = session.plan_auto(parallelism=par_spec, **plan_kw)
    else:
        sp = session.plan_auto(
            scheduler=scheduler,
            shard_state=True if par_spec.shard_state else None,
            pipeline_stages=pipe if pipe > 1 else None,
            micro_batches=micro if pipe > 1 else None, **plan_kw)
    if pipe <= 1 and micro > 1:
        # S = 1 accumulation rides the winning arm when it composes
        session.apply_micro_batching(micro)
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
    unconstrained = (scheduler is None and args.memory_budget_gb is None
                     and pipe <= 1 and par_spec.is_trivial)
    if unconstrained and sp.modeled_step_s > best_fixed + 1e-12:
        raise RuntimeError(
            f"planner regression: auto strategy modeled "
            f"{sp.modeled_step_s:.6f}s > best fixed baseline "
            f"{best_fixed:.6f}s")


def check_composition(scheduler, par_spec: ParallelismSpec) -> None:
    """The flags' refusals: a sharded or pipelined spec needs every-step
    gradient sync."""
    if par_spec.shard_state and scheduler is not None:
        raise SystemExit("shard_state partitions optimizer state, which "
                         "requires every-step gradient sync; drop "
                         "--local-sgd/--lag/--push-pull")
    if (par_spec.pp > 1 or par_spec.micro_batches > 1) and \
            scheduler is not None:
        raise SystemExit("pipeline stages / micro-batches require "
                         "every-step gradient sync; drop "
                         "--local-sgd/--lag/--push-pull")


def fixed_strategy(args, scheduler, par_spec: ParallelismSpec, axes):
    """The strategy of ``--sync comm`` / ``vanilla`` over ``axes``:
    ``comm`` composes the scheduler (every step by default) with the
    config's reducer and the ``--parallelism`` spec; ``vanilla`` with a
    scheduler or a sharded / pipelined spec takes dense reducers, and
    without either is vanilla BSP (None)."""
    if args.sync == "comm":
        return make_strategy(
            scheduler if scheduler is not None else "every_step",
            group=axes,
            sync=SyncConfig(compressor=args.compressor, algo=args.algo,
                            error_feedback=not args.no_error_feedback,
                            bucket_bytes=int(args.bucket_mb * 2**20)),
            parallelism=par_spec)
    if not par_spec.is_trivial:
        # vanilla + a parallelism spec: dense psum wires on the scatter
        # edge or the pipeline's DP edge
        return make_strategy("every_step", group=axes, parallelism=par_spec)
    if scheduler is not None:
        return SyncStrategy(scheduler=scheduler)
    return None


def _quiet(*_, **__) -> None:
    pass


def session_config(args) -> SessionConfig:
    """The flags' model, optimizer, data, seed and device."""
    return SessionConfig(
        arch=args.arch, reduced=args.reduced, steps=args.steps,
        batch=args.batch, seq=args.seq, lr=args.lr, warmup=args.warmup,
        optimizer=args.optimizer, seed=args.seed, device=args.device)


def elastic_schedule(args, par_spec: ParallelismSpec):
    """``--elastic``'s refusals, the reference's, and its fleet: the
    launch topology and the fault schedule against its world."""
    if not args.topology:
        raise SystemExit("--elastic needs --topology: the tier-size "
                         "product is the fleet the fault trace runs "
                         "against")
    if par_spec.pp > 1 or par_spec.micro_batches > 1:
        raise SystemExit("--elastic resharding composes with replicated "
                         "and sharded DP; pipeline/micro-batched builds "
                         "cannot restore mid-run (DESIGN.md §15)")
    topo = Topology.from_spec(args.topology)
    trace = args.fault_trace
    if trace and os.path.exists(trace):
        schedule = FaultSchedule.from_json(trace)
        if schedule.world != topo.world:
            raise SystemExit(
                f"fault trace {trace} is against world={schedule.world} "
                f"but --topology {topo.spec()!r} has world={topo.world}")
    else:
        schedule = FaultSchedule.from_spec(trace, world=topo.world)
    return topo, schedule


def run_elastic(args, rank: int = 0,
                par_spec: Optional[ParallelismSpec] = None,
                checkpoint_dir: Optional[str] = None) -> ElasticRuntime:
    """``--elastic``: drive the session through the supervised
    fault-tolerant loop instead of a bare :func:`run`.  Fresh sessions
    (and fresh scheduler instances — backpressure mutates scheduler
    config) come from a factory, by the strategy code :func:`run` uses, so
    resharding rebuilds from scratch every time.  ``checkpoint_dir`` is
    the directory every rank shares (made here when None, as the
    reference's ``mkdtemp``); rank 0 prints.  Returns the runtime (its
    ``session``, ``losses``, ``events`` and round counters)."""
    log = print if rank == 0 else _quiet
    if par_spec is None:
        par_spec = resolve_cli_parallelism(args)
    topo, schedule = elastic_schedule(args, par_spec)
    check_composition(scheduler_from_args(args), par_spec)
    scfg = session_config(args)

    def factory():
        s = TrainSession(dataclasses.replace(scfg))
        s.strategy = fixed_strategy(args, scheduler_from_args(args),
                                    par_spec, s.axes)
        return s

    cfg = ElasticConfig(
        topology=topo,
        checkpoint_dir=checkpoint_dir or tempfile.mkdtemp(prefix="elastic_"),
        plan=(args.sync == "auto"), link=args.link,
        t_backward_s=(args.plan_backward_ms / 1e3
                      if args.plan_backward_ms > 0 else 0.05))
    rt = ElasticRuntime(factory, schedule, cfg)
    losses = rt.run(args.steps)
    log(render_elastic_events(rt.events), flush=True)
    if args.checkpoint:
        rt.session.save_checkpoint(args.checkpoint)
        log("checkpoint written:", args.checkpoint, flush=True)
    log(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}) | "
        f"steps {rt.session.step}, comm rounds {rt.comm_rounds} "
        f"(grad {rt.grad_rounds}, param {rt.param_rounds}), "
        f"{len(rt.events)} elastic events", flush=True)
    return rt


def run(args, rank: int = 0, group=None,
        par_spec: Optional[ParallelismSpec] = None) -> TrainSession:
    """Train as the parsed flags say on ``group`` (the default group,
    joined or made at world 1, when None); rank 0 prints.  ``par_spec``
    is the flags' parallelism as :func:`main` resolved it before any
    spawn (resolved, and the flags checked, here when None).  Returns the
    session."""
    log = print if rank == 0 else _quiet
    if par_spec is None:
        par_spec = resolve_cli_parallelism(args)
    scheduler = scheduler_from_args(args)
    check_composition(scheduler, par_spec)
    scfg = session_config(args)
    strategy = None
    if (args.sync != "auto" and not args.topology
            and (par_spec.pp > 1 or par_spec.micro_batches > 1)):
        # a pipeline is built with the session: a stage makes only its
        # own rows and their moments
        strategy = fixed_strategy(args, scheduler, par_spec, group)
    session = TrainSession(scfg, strategy=strategy, group=group)
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
    if args.sync == "auto":
        plan_session(session, args, scheduler, par_spec, log)
    elif strategy is None:
        session.strategy = fixed_strategy(args, scheduler, par_spec,
                                          session.axes)
    if args.calibrate and args.sync != "auto":
        log("warning: --calibrate fits the link model --sync auto plans "
            "with; without --sync auto the fit is printed but unused",
            flush=True)
        log(session.calibrate().describe(), flush=True)
    if args.replan_drift_pct > 0:
        if args.sync != "auto" or scheduler is not None or \
                par_spec.pp > 1 or par_spec.micro_batches > 1 or \
                par_spec.shard_state:
            raise SystemExit("--replan-drift-pct re-runs the free planner "
                             "search; it requires --sync auto without a "
                             "pinned scheduler/pipeline/shard axis")
        session.enable_replan(args.replan_drift_pct,
                              check_every=args.replan_every)
    if session.strategy is not None:
        log(f"strategy: {session.strategy.describe()}", flush=True)
    losses = session.run(args.steps, log_every=args.log_every, log=log)
    drift = session.drift_report()
    if drift is not None and (args.calibrate or args.replan_drift_pct > 0):
        log(render_drift_table(drift), flush=True)
        if args.sync == "auto" and session.rank == 0:
            # the record again, with the post-run calibration and drift
            # blocks (the pre-run write keeps the base schema)
            path = save_strategy_plan(session.planned["strategy_plan"],
                                      args.arch,
                                      calibration=session.calibration,
                                      drift=drift)
            log(f"plan record (with drift): {path}", flush=True)
    if session.layout is not None:
        log(render_sharded_memory(session.layout, args.optimizer,
                                  moments=session.opt_moments), flush=True)
    if session.routed_tokens:
        log(render_moe_drops(session.dropped_tokens, session.routed_tokens,
                             session.model_cfg.capacity_factor), flush=True)
    if session.staged is not None:
        log(render_pipeline_stages(session.staged, session._params,
                                   session.strategy.micro_batches,
                                   moments=session.opt_moments), flush=True)
    if args.checkpoint:
        session.save_checkpoint(args.checkpoint)
        log("checkpoint written:", args.checkpoint, flush=True)
    log(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}) "
        f"steps/s {args.steps / session.wall_s:.2f} | {session.summary()}",
        flush=True)
    return session


def _rank_main(rank: int, world: int, store: str, argv: list,
               par_spec: ParallelismSpec,
               checkpoint_dir: Optional[str] = None) -> None:
    """One spawned rank of ``--data-parallel``: its card (cuda:rank) or the
    CPU, the world's group, then :func:`run` (:func:`run_elastic` under
    ``--elastic``, on the checkpoint directory all ranks share)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", rank)
        args.device = str(device)
    else:
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    init_group(device, world_size=world, rank=rank, store_path=store)
    try:
        if args.elastic:
            run_elastic(args, rank, par_spec, checkpoint_dir)
        else:
            run(args, rank, par_spec=par_spec)
    finally:
        destroy_group()


def main(argv: Optional[list] = None):
    """Run the CLI; returns the session (losses, step times, state), the
    :class:`ElasticRuntime` under ``--elastic``, or None after a spawned
    ``--data-parallel`` world."""
    args = build_parser().parse_args(argv)
    scheduler_from_args(args)        # "pick one" exits before any spawn
    par_spec = resolve_cli_parallelism(args)
    if args.elastic:
        elastic_schedule(args, par_spec)    # its refusals before any spawn
    elif args.fault_trace:
        raise SystemExit("--fault-trace only applies under --elastic")
    world = args.data_parallel
    if world <= 1:
        if args.elastic:
            return run_elastic(args, par_spec=par_spec)
        return run(args, par_spec=par_spec)
    device = resolve_device(args.device)
    if device.type == "cuda" and world > torch.cuda.device_count():
        raise SystemExit(
            f"--data-parallel {world} on CUDA needs one card per rank (NCCL "
            f"takes one rank per device); this machine has "
            f"{torch.cuda.device_count()}")
    # --elastic: one checkpoint directory for every rank, made before they
    # spawn (rank 0 writes, all ranks read)
    checkpoint_dir = (tempfile.mkdtemp(prefix="elastic_") if args.elastic
                      else None)
    spawn(_rank_main, world,
          args=(list(sys.argv[1:] if argv is None else argv), par_spec,
                checkpoint_dir))
    return None


if __name__ == "__main__":
    main()
