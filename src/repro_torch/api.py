"""TrainSession — the programmatic training surface of the port
(counterpart of ``repro/api.py``).

    from repro_torch.api import SessionConfig, TrainSession
    from repro_torch.core import SyncConfig, make_strategy

    sess = TrainSession(SessionConfig(arch="gemma-2b", reduced=True,
                                      device="cpu"),
                        strategy=make_strategy(
                            "local_sgd", period=4, sync=SyncConfig(
                                compressor="int8_fused")))
    losses = sess.run(steps=8, log_every=1)
    print(sess.comm_rounds, "communication rounds over", sess.step, "steps")

``strategy=None`` is the vanilla BSP step.  Otherwise the session holds
one step per strategy phase — the synced step, the purely local step, the
parameter round, LAG's probe / sync / reuse — and the strategy's round
scheduler dispatches between them on the host.  Communication rounds are
counted as they ran: ``grad_rounds`` (gradient syncs), ``param_rounds``
(parameter rounds) and ``control_rounds`` (LAG's two-scalar probes);
``comm_rounds = grad_rounds + param_rounds``, the survey's Table 2.

Or let the planner choose the whole composite (rounds × bits × overlap,
priced on a tiered topology):

    sess = TrainSession(SessionConfig(arch="gemma-2b", reduced=True,
                                      device="cpu"))
    sp = sess.plan_auto(topology="commodity_cluster")
    print(sp.describe()); sess.run(steps=8)

The session joins (or creates) the default process group
(``launch/dist.py``): a one-process run is a group of world 1, and each
rank of a larger world trains on its rows of the global batch.  One
process is one worker: under a scheduler whose workers diverge (local
SGD, push/pull) each rank's ``params`` and ``opt_state`` are its own
worker's (the reference carries them on a leading device axis and shows
worker 0's).  Every rank plans for itself, from one measured backward
time (the group's minimum), and the ranks check that their plans agree
before the first step.  ``save_checkpoint`` / ``load_checkpoint`` write
and read the reference's checkpoint format.

Sharded data parallelism (a strategy whose parallelism has ``shard``,
or the planner's ``every_step_sharded`` winner) partitions the f32
master parameters and the optimizer moments: ``self.opt_state`` becomes
this rank's rows (``{"master": [...], "opt": {...}}``, one row per plan
bucket, ``self.layout`` their geometry) and the replicated moments are
freed.  :meth:`full_opt_state` gathers them leaf-shaped, and checkpoints
store that form, so they restore at any world, sharded or replicated.

Pipeline parallelism (a strategy whose parallelism has ``pp > 1`` or
``micro > 1``, or the planner's pipeline winner) splits the world into a
``pipe(S) × data(world/S)`` mesh (``launch/dist.py:mesh_axes``): each
process holds the shared cells and its own stage's layer rows
(``self.staged``, ``launch/steps.py:make_pipeline_train_step``); given
at construction, such a strategy is built there, so that a stage never
holds another stage's rows or the whole model's moments; and
:attr:`params` merges the stages back (a gather over the pipe group when
S > 1, so every rank reads it).  Its checkpoints hold the merged,
leaf-shaped parameters and moments.

The elastic runtime (``repro_torch.elastic``, ``--elastic``) rebuilds a
session in process on every membership change of its fault schedule:
it saves the live session's leaf-shaped checkpoint, releases it, and
builds a fresh one whose :meth:`apply_topology` installs the surviving
topology (a planning model: the process group stays the same) before
:meth:`load_checkpoint` and, when planning, :meth:`plan_auto`; under a
straggler it calls the scheduler's ``backpressure`` or
:meth:`replan_now`.

Tensor and expert parallelism are planning and record axes of the
session, as in the reference: a tp or ep winner of :meth:`plan_auto`,
or a strategy whose spec has ``tp`` / ``ep`` above 1, runs its DP edge
over the session's data axes and carries the spec (``describe()``, the
plan record).  The model-level wire that executes them is
``models.layers.mlp_tp`` under ``models.sharding_ctx.tp_region`` and
``moe_ffn(ep_axis=...)``, on process groups the caller builds.

Calibration and drift re-planning: :meth:`calibrate` fits per-tier α/β
from timed collectives (``core/schedule/calibration.py``), which
:meth:`plan_auto` prices with (``calibration=``); :meth:`enable_replan`
arms a drift check every few steps that re-runs the planner's search on
a fresh backward profile, and :meth:`drift_report` sets the plan's
modeled step against the measured one.  Every re-planning decision is
taken from values all ranks share (the group's largest median step, its
smallest backward), and the new plan is checked for agreement before it
is installed.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import statistics
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import checkpoint
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.checkpoint.checkpoint import _flatten_with_paths
from repro_torch.configs import get_config, reduced
from repro_torch.core import (GradientSynchronizer, ParallelismSpec,
                              PlanExecutor, ShardLayout, SyncConfig,
                              SyncStrategy, get_scheduler,
                              sharded_plan_from_config)
from repro_torch.core.collectives import all_gather, as_axes
from repro_torch.core.collectives import axes_for_topology
from repro_torch.core.collectives.p2p import (axis_index, axis_size,
                                              process_group, to_wire)
from repro_torch.core.pipeline import StagedModel
from repro_torch.core.schedule import (LINK_PRESETS, CalibratedTopology,
                                       LinkParams, PipelineAxis,
                                       RoundSchedule, ExpertAxis,
                                       StrategyPlan, TensorAxis, Topology,
                                       calibrate_topology, drift_fraction,
                                       fixed_config_plan,
                                       modeled_wall_step_s, pipeline_arm,
                                       pipeline_placements, plan,
                                       plan_comm_error_s, plan_rounds,
                                       profiles_from_grads,
                                       resolve_calibration,
                                       resolve_cost_table, serial_round_plan)
from repro_torch.core.schedule.planner import FIXED_BASELINES, local_sgd_arm
from repro_torch.core.strategy import LocalSGDScheduler
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.dist import init_group, mesh_axes
from repro_torch.launch.steps import (_make_synced_train_step,
                                      loss_and_grads, make_lag_programs,
                                      make_local_train_step,
                                      make_param_round_step,
                                      make_pipeline_train_step,
                                      make_sharded_train_step,
                                      make_train_step, merge_opt_rows)
from repro_torch.models import Model
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import desc_leaves
from repro_torch.models.model import count_params
from repro_torch.optim import (make_optimizer, make_sharded_optimizer,
                               warmup_cosine)


@dataclasses.dataclass
class SessionConfig:
    """What to train (model/optimizer/data) and where; HOW to synchronize
    is the strategy, passed separately."""
    arch: str = "gemma-2b"
    reduced: bool = False
    steps: int = 100            # LR-schedule horizon and default run length
    batch: int = 8              # global batch, split over the ranks
    seq: int = 128
    lr: float = 3e-3
    warmup: int = 20
    optimizer: str = "adam"
    seed: int = 0
    device: Optional[str] = None   # None: CUDA, raising when there is none
    layers: int = 0             # > 0: cut the stack to this depth (widths
                                # stay), 0: the configuration's own


def strategy_from_plan(sp: StrategyPlan, axes=None) -> SyncStrategy:
    """The executable strategy a planner composite describes, over the
    data axes ``axes`` (process groups; None: the default group).  A tp
    or ep winner runs its DP edge (the arm's comm plan) and carries the
    spec as a record axis, as the reference does (the model axes run on
    the model-level wire, ``layers.mlp_tp`` / ``moe_ffn(ep_axis=)``); a
    sharded winner runs sharded data parallelism on the arm's plan; a
    pipeline winner runs the pipeline, its DP edge per layer row on the
    arm's dominant (compressor, algo) choice, as the reference's does."""
    if sp.schedule.kind == "local_sgd":
        return SyncStrategy(
            scheduler=get_scheduler("local_sgd", period=sp.schedule.period),
            param_reducer=PlanExecutor(sp.comm, axes))
    if sp.pipeline_stages > 1:
        # the arm's comm plan describes the DP edge of the modeled heavy
        # stage; the executor re-derives a per-row plan on the live stage
        # tree from the arm's dominant bucket (DESIGN.md §9)
        return SyncStrategy(scheduler=get_scheduler("every_step"),
                            grad_reducer=_per_row_reducer(sp.comm, axes),
                            parallelism=sp.parallelism)
    return SyncStrategy(scheduler=get_scheduler("every_step"),
                        grad_reducer=PlanExecutor(sp.comm, axes),
                        parallelism=sp.parallelism)


def _per_row_reducer(comm, axes) -> GradientSynchronizer:
    """A per-leaf ``GradientSynchronizer`` on the (compressor, algo) of the
    plan's largest bucket: plans are tied to the whole model's tree, the
    pipeline's DP edge syncs per layer row."""
    dom = max(comm.buckets, key=lambda b: b.bucket_bytes)
    return GradientSynchronizer(
        SyncConfig(compressor=dom.compressor,
                   compressor_args=dom.compressor_args, algo=dom.algo,
                   bucket_bytes=0), axes)


def plan_decision(sp: StrategyPlan) -> Dict[str, Any]:
    """What every rank must agree on before it runs a plan: the arm, the
    rounds schedule and every bucket's leaves, wire and packing."""
    return {"key": sp.key,
            "schedule": [sp.schedule.kind, sp.schedule.period],
            "buckets": [[list(b.leaves), b.algo, b.compressor,
                         [list(a) for a in b.compressor_args],
                         int(b.bucket_bytes), b.pack, b.fused,
                         b.error_feedback, b.ef_decay]
                        for b in sp.comm.buckets]}


def plan_digest(sp: StrategyPlan) -> str:
    """sha256 of :func:`plan_decision` (canonical JSON)."""
    return hashlib.sha256(json.dumps(plan_decision(sp), sort_keys=True)
                          .encode()).hexdigest()


def _leaf_shaped_keys(data: Dict[str, Any]) -> Dict[str, Any]:
    """Checkpoint keys in the leaf-shaped form.  The reference's pipeline
    sessions save their optimizer state in the stage tree's form
    (``opt/<buffer>/shared/...`` and ``opt/<buffer>/rows/<period>/...``
    with (R, ...) leaves); those keys become ``opt/<buffer>/...`` and
    ``opt/<buffer>/stack/0/<period>/...``."""
    out = {}
    for k, v in data.items():
        parts = k.split("/")
        if len(parts) > 3 and parts[0] == "opt" and parts[2] == "shared":
            k = "/".join(parts[:2] + parts[3:])
        elif len(parts) > 3 and parts[0] == "opt" and parts[2] == "rows":
            k = "/".join(parts[:2] + ["stack", "0"] + parts[3:])
        out[k] = v
    return out


class TrainSession:
    """One training run driven by a :class:`SyncStrategy` (or vanilla BSP).

    ``params`` seeds the run with a given parameter tree (tensors, moved to
    the session's device; e.g. ``convert.params_from_jax``), so that both
    packages can start from one tree; otherwise random weights are drawn
    from a ``torch.Generator`` seeded with ``cfg.seed`` on the device.
    ``group`` is the process group (default: the default group, created at
    world 1 if there is none).  ``self.params`` and ``self.opt_state`` are
    this rank's: under local SGD or push/pull, this worker's parameters
    (the reference's ``params`` is worker 0's view); in pipeline mode the
    merged tree of every stage (a collective when S > 1)."""

    def __init__(self, cfg: Optional[SessionConfig] = None,
                 strategy: Optional[SyncStrategy] = None, params=None,
                 group: Optional[dist.ProcessGroup] = None):
        self.cfg = cfg or SessionConfig()
        self.strategy = strategy
        c = self.cfg
        self.device = resolve_device(c.device)
        model_cfg = get_config(c.arch)
        if c.reduced:
            model_cfg = reduced(model_cfg)
        if c.layers:
            model_cfg = dataclasses.replace(model_cfg, num_layers=c.layers)
        self.model_cfg = model_cfg
        self.model = Model(model_cfg)
        if group is None:
            # the default group of any size (a spawned rank's world), or
            # a new one of world 1
            init_group(self.device, world_size=None)
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        # this rank's place on the data axis (the batch rows it trains on);
        # a pipeline build moves it to the data group of its pipe x data
        # mesh
        self.dp_rank, self.dp_world = self.rank, self.world
        if c.batch % self.world:
            raise ValueError(f"global batch {c.batch} does not split over "
                             f"{self.world} ranks")
        self._lr = warmup_cosine(c.lr, c.warmup, c.steps)
        self.optimizer = make_optimizer(c.optimizer, lr=self._lr)
        self.data = SyntheticPipeline(DataConfig(
            vocab_size=model_cfg.vocab_size, seq_len=c.seq,
            global_batch=c.batch,
            embedding_dim=model_cfg.d_model if model_cfg.embedding_inputs
            else 0))
        # a pipeline strategy is built here, before any moment exists: at
        # S > 1 the build draws only this stage's rows (``_build_pipeline``)
        pipelined = strategy is not None and (
            strategy.pipeline_stages > 1 or strategy.micro_batches > 1)
        if params is not None:
            params = tree_map(lambda t: t.detach().to(self.device).clone(),
                              params)
        elif not (pipelined and strategy.pipeline_stages > 1):
            params = self.model.init(torch.Generator(self.device).manual_seed(
                c.seed))
        self._params = params
        self.opt_state = None if pipelined else self.optimizer.init(params)
        # f32 moment buffers per parameter (sgd carries one, adam two),
        # counted on the optimizer's state for meta tensors of the model's
        # shapes: the planner's memory model
        meta = [torch.empty(d.shape, device="meta")
                for d in desc_leaves(self.model.param_desc())]
        self.opt_moments = (sum(int(x.numel()) for x in
                                tree_leaves(self.optimizer.init(meta)))
                            / max(sum(int(x.numel()) for x in meta), 1))
        # the data axes the planned reducers run over: the session's
        # group, or one group per tier after apply_topology
        self.axes: Tuple[Any, ...] = as_axes(group)
        self.topology: Optional[Topology] = None
        self.tiered_mesh = False
        self.planned: Optional[Dict[str, Any]] = None
        self.layout: Optional[ShardLayout] = None   # set by sharded builds
        self.staged: Optional[StagedModel] = None   # set by pipeline builds
        self.pipe_axis = None                        # the pipe group (S > 1)
        self._restore_opt: Optional[Dict[str, Any]] = None
        self.sync_state: Optional[Any] = None
        self.step = 0
        self.losses: List[float] = []
        self.grad_rounds = 0
        self.param_rounds = 0
        self.control_rounds = 0
        self.step_times: List[float] = []
        self.wall_s = float("nan")
        # calibration and drift re-planning
        self.calibration: Optional[CalibratedTopology] = None
        self.replans = 0
        self.replan_events: List[Dict[str, Any]] = []
        self._t_backward_spread_s = 0.0        # profile_backward's spread
        self._replan_drift_pct = 0.0           # 0 = re-planning off
        self._replan_every = 25
        self._max_replans = 1
        self._window: List[float] = []         # step times since the check
        self._replan_search = None         # plan_auto's free search
        # MoE capacity overflow must not vanish silently: the drop tap
        # counts the dropped token-choices of each step (on only while the
        # step runs, so no count outlives it in the process), drained once
        # per step
        self.dropped_tokens = 0.0
        self.routed_tokens = 0.0
        if model_cfg.num_experts:
            moe_mod.drain_drop_tap()      # no other run's counts
        self._engine = None
        self._built = False
        if pipelined:
            self._build()

    @property
    def params(self):
        """The parameter tree; in pipeline mode the stages merged back into
        the model's tree (at S > 1 a gather over the pipe group, which
        every rank of it must join)."""
        if self.staged is None:
            return self._params
        rows = self._params["rows"]
        if self.pipe_axis is not None:
            rows = tree_map(lambda x: all_gather(x, self.pipe_axis), rows)
        else:
            rows = tree_map(lambda x: x[None], rows)
        return self.staged.merge(self._params["shared"], rows)

    @params.setter
    def params(self, value) -> None:
        if self.staged is not None:
            raise RuntimeError("a pipeline session's params are its stages'")
        self._params = value

    @property
    def comm_rounds(self) -> int:
        """Collective rounds that actually ran (survey Table 2)."""
        return self.grad_rounds + self.param_rounds

    @property
    def synchronizer(self):
        """The gradient reducer the session built (None before the first
        step and for schedulers that never sync gradients)."""
        return self._engine

    def _build(self) -> None:
        if self._built:
            return
        self._anchor = None
        self._red_state = None
        if self.strategy is None or not self.strategy.shard_state:
            self._restore_opt = None     # the moments are in opt_state
        if self.strategy is None:
            self._base = make_train_step(self.model, self.optimizer,
                                         self.group)
            self._built = True
            return
        st = self.strategy
        if st.pipeline_stages > 1 or st.micro_batches > 1:
            # S = 1 with micro-batches is the degenerate pipe: the same
            # 1F1B step with no hop, plain gradient accumulation
            self._build_pipeline(st)
            self._built = True
            return
        if st.shard_state:
            self._build_sharded(st)
            self._built = True
            return
        sched = st.scheduler
        self._sched_state = sched.init_state(self._params)
        engine = st.grad_reducer
        if engine is None and "sync" in sched.computes:
            engine = GradientSynchronizer(SyncConfig(), self.group)
        self._engine = engine
        if sched.needs_grad_probe:
            self._probe, self._sync, self._reuse = make_lag_programs(
                self.model, self.optimizer, engine, self.group)
            self.sync_state = engine.init_state(self._params)
        elif "sync" in sched.computes:
            self._sync, _, init_sync_state = _make_synced_train_step(
                self.model, self.optimizer, engine, self.group)
            self.sync_state = init_sync_state(self._params)
        if "local" in sched.computes:
            self._local = make_local_train_step(self.model, self.optimizer,
                                                self.group)
        if sched.has_param_rounds:
            self._param_round = make_param_round_step(
                st.param_reducer, self.group, algo=st.param_algo)
            if st.param_reducer is not None:
                # the anchor: the parameters agreed at the last round (the
                # start), in f32, equal on every rank
                self._anchor = tree_map(
                    lambda p: p.detach().to(torch.float32, copy=True),
                    self._params)
                self._red_state = st.param_reducer.init_state(self._params)
        self._built = True

    def _build_sharded(self, st: SyncStrategy) -> None:
        """Sharded-DP programs (DESIGN.md §8): the every-step sync step is
        ``make_sharded_train_step`` and ``self.opt_state`` becomes this
        rank's {master, moments} rows; the replicated moments are freed
        first.  A ``GradientSynchronizer`` (or no reducer: dense psum)
        runs the packed plan of ``sharded_plan_from_config``."""
        sched = st.scheduler
        self._sched_state = sched.init_state(self._params)
        engine = st.grad_reducer
        if engine is None:
            engine = PlanExecutor(
                sharded_plan_from_config(SyncConfig(), self._params),
                self.axes)
        elif isinstance(engine, GradientSynchronizer):
            engine = PlanExecutor(
                sharded_plan_from_config(engine.cfg, self._params),
                engine.axes)
        self._engine = engine
        axes = engine.axes
        self.layout = ShardLayout.from_plan(
            engine.plan, self._params, tuple(axis_size(a) for a in axes))
        shopt = make_sharded_optimizer(self.cfg.optimizer, self.layout,
                                       axes, lr=self._lr)
        self._sync, init_opt_rows, init_sync_state = \
            make_sharded_train_step(self.model, engine, self.layout, shopt,
                                    self.group)
        self.opt_state = None      # the replicated moments go first
        if self._restore_opt is not None:
            # resharding restore (DESIGN.md §15): the checkpoint's
            # LEAF-SHAPED state becomes this layout's rows — the f32
            # master (from the restored params when the checkpoint came
            # from a replicated run) and each moment tree
            full, self._restore_opt = self._restore_opt, None
            master = full.pop("master", None)
            if master is None:
                master = tree_map(lambda p: p.detach().to(torch.float32),
                                  self._params)
            want = sorted(shopt.init([]))     # the optimizer's buffers
            if want != sorted(full):
                raise ValueError(
                    f"checkpoint optimizer buffers {sorted(full)} do not "
                    f"match {self.cfg.optimizer!r}'s {want}")
            self.opt_state = {
                "master": self.layout.my_rows(master, axes),
                "opt": {k: self.layout.my_rows(full[k], axes)
                        for k in want}}
            del master, full
        else:
            self.opt_state = init_opt_rows(self._params)
        self.sync_state = init_sync_state(self._params)

    def _build_pipeline(self, st: SyncStrategy) -> None:
        """Pipeline programs (DESIGN.md §9): the world becomes ``pipe(S) ×
        data(world/S)`` (``mesh_axes``; rank r is stage r // dp, data
        index r % dp), the parameters this stage's shared cells and rows
        (``self._params = {"shared": ..., "rows": (R/S, ...)}``), the
        optimizer and EF state per layer row, and the step
        ``make_pipeline_train_step``.  The DP edge runs a per-leaf
        ``GradientSynchronizer`` on the data group.  A strategy given at
        construction is built there, before any optimizer state exists,
        and at S > 1 from no parameters: the stage draws its own rows
        (``StagedModel.init_stage``); a planned winner splits the whole
        tree the session holds and frees its moments.  The reference's
        refusals: a scheduler other than every-step sync, a world not
        divisible by S, a batch that does not split into dp x M, a
        ``CommPlan`` reducer."""
        sched = st.scheduler
        if (sched.computes != frozenset({"sync"}) or sched.has_param_rounds
                or sched.needs_grad_probe or sched.diverges_params):
            raise ValueError(
                f"pipeline_stages requires an every-step gradient-sync "
                f"scheduler, got {sched.name!r}: local phases and gradient "
                f"reuse assume each worker holds the WHOLE model")
        S, M = st.pipeline_stages, st.micro_batches
        if self.world % S != 0:
            raise ValueError(f"{self.world} ranks do not factor into "
                             f"pipe({S}) x data")
        dp = self.world // S
        if self.cfg.batch % dp or (self.cfg.batch // dp) % M:
            raise ValueError(
                f"global batch {self.cfg.batch} must split into "
                f"{dp} DP shards x {M} micro-batches")
        engine = st.grad_reducer
        if engine is not None and not isinstance(engine,
                                                 GradientSynchronizer):
            raise ValueError(
                "pipeline mode takes a SyncConfig-backed reducer (a "
                "CommPlan is tied to the full-model pytree; the stage "
                "pytree is per-row)")
        staged = StagedModel(self.model, S)
        if S > 1:
            if self.world != dist.get_world_size():
                raise ValueError("a pipeline of S > 1 stages splits the "
                                 "default process group; this session "
                                 "runs on a subgroup")
            self.pipe_axis, data = mesh_axes((S, dp))
        else:
            data = self.group
        stage = axis_index(self.pipe_axis) if S > 1 else 0
        self.dp_rank, self.dp_world = axis_index(data), dp
        self.axes = (data,)
        cfg = engine.cfg if engine is not None else SyncConfig()
        # per-leaf buckets: the DP edge syncs per layer row, keeping the
        # compression granularity the same at every stage count
        engine = GradientSynchronizer(
            dataclasses.replace(cfg, bucket_bytes=0), data)
        self._engine = engine
        if self._params is None:
            # drawn as the whole tree is, this stage's rows kept
            shared, rows = staged.init_stage(
                torch.Generator(self.device).manual_seed(self.cfg.seed),
                stage)
        else:
            shared, rows = staged.split(self._params, stage=stage)
        self.opt_state = None        # a planned winner's moments go first
        self._params = {"shared": shared, "rows": rows}
        self.staged = staged
        self._sched_state = sched.init_state(self._params)
        del shared, rows
        self._sync, init_opt_state, init_sync_state = \
            make_pipeline_train_step(staged, self.optimizer, engine, M,
                                     self.pipe_axis, data)
        self.opt_state = init_opt_state(self._params)
        self.sync_state = init_sync_state(self._params)

    def _leaf_shaped(self, tree):
        """A stage tree ``{"shared", "rows": [per-row trees]}`` of this
        stage as the model's leaf-shaped tree (rows merged over the pipe
        group: a collective at S > 1)."""
        R = self.staged.layout.rows
        st = merge_opt_rows({"t": {"rows": tree["rows"]}}, R,
                            self.pipe_axis)["t"]["rows"]
        stack = st if R > 1 else tree_map(lambda x: x[0], st)
        return {**tree["shared"], "stack": [stack]}

    def full_opt_state(self):
        """Leaf-shaped view of the optimizer state: the replicated state
        as-is; in sharded mode the moments and the f32 master parameters
        gathered from every rank's rows; in pipeline mode the per-row
        moments of every stage merged into the model's leaves
        (``merge_opt_rows``).  A collective in both modes: every rank
        calls it (checkpoints and conformance tests)."""
        if self.staged is not None:
            return {k: self._leaf_shaped(v)
                    for k, v in self.opt_state.items()}
        if self.layout is None:
            return self.opt_state
        axes = self._engine.axes
        rows = self.opt_state
        full = {k: self.layout.gather_tree(v, self._params, axes)
                for k, v in rows["opt"].items()}
        full["master"] = self.layout.gather_tree(rows["master"], self._params,
                                                 axes)
        return full

    # -- auto planning (rounds × bits × overlap) -----------------------------

    def resolve_link(self, link="fast_ici", alpha=None,
                     beta_gbps=None) -> LinkParams:
        lp = LINK_PRESETS[link] if isinstance(link, str) else link
        a = lp.alpha_s if alpha is None else alpha
        b = lp.beta_s_per_byte if beta_gbps is None \
            else 1.0 / (beta_gbps * 1e9)
        return LinkParams(alpha_s=a, beta_s_per_byte=b)

    def apply_topology(self, topology) -> Topology:
        """Install a tiered network model (``--topology``, DESIGN.md §10):
        a :class:`Topology`, a spec string
        (``"node:4@datacenter,device:8@fast_ici"``) or a
        ``TOPOLOGY_PRESETS`` name.  The planner then prices every arm on
        it, at its world.  When it has more than one tier and its world is
        this session's (the default group's), the data axes become one
        process group per tier (``collectives.axes_for_topology``,
        innermost first), so the planned reducers run ``hierarchical``'s
        inner ring on the fast tier; otherwise the topology is a planning
        model only (a pod modeled from one card)."""
        if self._built:
            raise RuntimeError("apply_topology must run before the first "
                               "step")
        topo = Topology.from_spec(topology) if isinstance(topology, str) \
            else topology
        self.topology = topo
        self.tiered_mesh = (topo.n_tiers > 1 and topo.world == self.world
                            and self.world == dist.get_world_size())
        if self.tiered_mesh:
            self.axes = axes_for_topology(topo)
        return topo

    def profile_backward(self, repeats: int = 3) -> float:
        """Wall time of this rank's backward on its slice of the global
        batch (global / world rows, what one step computes per rank): one
        warm-up pass, then the min of ``repeats`` timed passes, each
        between ``torch.cuda.synchronize()`` calls on the card, × 2/3 (the
        backward's share of a grad step).  The reference's policy; the
        repeats' spread is kept as ``_t_backward_spread_s``, the backward's
        term of the drift report's error budget."""
        batch = self.batch(0)
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))

        def once() -> float:
            sync()
            t0 = time.perf_counter()
            _, grads = loss_and_grads(self.model, self._params, batch)
            sync()
            dt = time.perf_counter() - t0
            del grads
            return dt

        once()
        times = [once() for _ in range(max(repeats, 1))]
        self._t_backward_spread_s = (max(times) - min(times)) * (2.0 / 3.0)
        return min(times) * (2.0 / 3.0)

    def _group_min(self, value: float) -> float:
        """The smallest of every rank's ``value`` (one f64 all-reduce)."""
        return self._group_reduce(value, dist.ReduceOp.MIN)

    def _group_max(self, value: float) -> float:
        """The largest of every rank's ``value`` (one f64 all-reduce)."""
        return self._group_reduce(value, dist.ReduceOp.MAX)

    def _group_reduce(self, value: float, op) -> float:
        if self.world == 1:
            return value
        wire_dev = self.device if dist.get_backend(self.group) == "nccl" \
            else torch.device("cpu")
        buf = to_wire(torch.tensor([value], dtype=torch.float64,
                                   device=wire_dev), self.group)
        dist.all_reduce(buf, op=op, group=process_group(self.group))
        return float(buf.item())

    def calibrate(self, sizes=None, repeats=None,
                  timer=None) -> CalibratedTopology:
        """Measure THIS world's collective fabric and fit per-tier α/β
        with confidence bounds (``--calibrate``).  On a tiered mesh
        (``apply_topology`` matched the world) each tier's process group
        is timed separately; otherwise the flat fabric over all ranks is
        fitted — and if a planning-only topology was requested, the
        calibration measures the ranks that run, not the model, so say
        so.  Every rank calls it (the timed collectives run on every
        rank).  The result is stored as ``self.calibration`` and feeds
        :meth:`plan_auto` via ``calibration=``."""
        from repro_torch.core.schedule.calibration import (CAL_LINK_REPEATS,
                                                           CAL_LINK_SIZES)
        if self.topology is not None and not self.tiered_mesh:
            self._note(f"note: --calibrate times the HOST fabric "
                       f"({self.world} rank(s)), not the planning "
                       f"topology {self.topology.spec()}")
        topo = self.topology if self.tiered_mesh else None
        kw: Dict[str, Any] = {
            "sizes": sizes if sizes is not None else CAL_LINK_SIZES,
            "repeats": repeats if repeats is not None else CAL_LINK_REPEATS,
        }
        if timer is not None:
            kw["timer"] = timer
            if topo is None and self.topology is not None:
                topo = self.topology    # injected timer: no group needed
        else:
            if topo is None:
                topo = Topology.flat(self.world, LinkParams(), name="data")
                kw["axes"] = (self.group,)
            else:
                kw["axes"] = self.axes  # one group per tier
            kw["device"] = (self.device
                            if dist.get_backend(self.group) == "nccl"
                            else torch.device("cpu"))
        self.calibration = calibrate_topology(topo, **kw)
        return self.calibration

    def _check_plan_agreement(self, sp: StrategyPlan) -> str:
        """Gather every rank's :func:`plan_digest` and raise unless they
        are all equal: ranks that ran different collectives on one group
        would hang.  Returns the digest."""
        digest = plan_digest(sp)
        if self.world > 1:
            mine = torch.tensor(list(bytes.fromhex(digest)),
                                dtype=torch.int64, device=self.device)
            every = all_gather(mine, self.group)
            if not all(torch.equal(every[r], every[0])
                       for r in range(every.shape[0])):
                raise RuntimeError(
                    f"the ranks planned differently (rank {self.rank}: "
                    f"{sp.key}, digest {digest}); a shared plan is needed "
                    f"before the first step")
        return digest

    def _pipeline_executable(self, S: int, M: int) -> bool:
        """Can pipeline(S, M) run on THIS session's world and batch?  (The
        modeled plan may target a pod through its topology.)"""
        if S < 2 or self.world % S:
            return False
        dp = self.world // S
        if self.cfg.batch % dp or (self.cfg.batch // dp) % M:
            return False
        if self.world != dist.get_world_size():
            return False
        try:
            StagedModel(self.model, S)
        except ValueError:
            return False
        return True

    def _model_axes(self, pipe_axis: PipelineAxis
                    ) -> Tuple[TensorAxis, Optional[ExpertAxis]]:
        """The tp / ep pricing axes of this model (the reference's): tp
        pays 4 activation all-reduces per layer (Megatron's wire); ep
        exists only for MoE stacks, dispatching top-k activation rows per
        token, its ``expert_fraction`` from the parameter count."""
        mc = self.model_cfg
        tensor_axis = TensorAxis(
            global_tokens=pipe_axis.global_tokens,
            bytes_per_token=pipe_axis.bytes_per_token,
            n_layers=mc.num_layers)
        expert_axis = None
        if mc.num_experts:
            n_moe = sum(1 for i in range(mc.num_layers)
                        if mc.layer_spec(i).ffn == "moe")
            if n_moe:
                ffm = mc.moe_d_ff or mc.d_ff
                expert_params = n_moe * 3 * mc.num_experts * mc.d_model * ffm
                frac = min(0.99, expert_params / max(mc.num_params(), 1))
                expert_axis = ExpertAxis(
                    global_tokens=pipe_axis.global_tokens,
                    bytes_per_token=float(mc.top_k * mc.d_model * 4),
                    n_moe_layers=n_moe, expert_fraction=frac)
        return tensor_axis, expert_axis

    def _note(self, msg: str) -> None:
        if self.rank == 0:
            print(msg, flush=True)

    def plan_auto(self, link="fast_ici", *, alpha=None, beta_gbps=None,
                  tau_grid=None, candidates=None, scheduler=None,
                  t_backward_s: Optional[float] = None,
                  shard_state: Optional[bool] = None,
                  memory_budget_gb: Optional[float] = None,
                  topology=None, compression_costs=None,
                  parallelism=None, pipeline_stages: Optional[int] = None,
                  micro_batches: Optional[int] = None, calibration=None,
                  straggler_s: float = 0.0) -> StrategyPlan:
        """``--sync auto``: profile the backward, search (rounds schedule ×
        per-bucket strategy × shard axis × parallelism axis) and install
        the winning composite as this session's strategy.

        The three branches of the reference: the free search
        (``plan_rounds``); a pinned local-SGD ``scheduler``, whose round
        gets the serial per-bucket plan (``serial_round_plan``); and a
        pinned LAG / push-pull / every-step scheduler, whose gradient syncs
        get the overlap-planned per-bucket plan (``plan``).  ``topology``
        (or an earlier :meth:`apply_topology`) prices a tiered network at
        its world; without one, the flat ``link`` (with ``alpha`` /
        ``beta_gbps`` overrides) at this session's world.
        ``t_backward_s`` pins the backward time; left None it is measured
        (:meth:`profile_backward`) and every rank takes the group's
        minimum, so all ranks plan from one number.  ``shard_state`` /
        ``memory_budget_gb`` constrain the free search's shard axis, and
        ``parallelism`` (a ``ParallelismSpec`` or a spec string such as
        ``"dp=4,shard"``) pins the free search to that spec's arms.
        ``compression_costs`` (a ``CompressionCostTable`` or a path to the
        reference's JSON) replaces the analytic compression-compute term.
        ``pipeline_stages`` / ``micro_batches`` pin the arm to pipeline(S,
        M) (M defaults to 8): only its DP edge is planned, priced at the
        world if it factors into pipe(S) x data(>= 2), else at 2S.
        ``calibration`` (a ``CalibratedTopology`` from :meth:`calibrate` /
        ``--calibrate``, or a path to a saved one) replaces the preset
        links with the FITTED fabric: it becomes the pricing topology,
        unless a planning topology of another shape was given (then the
        presets stay, with a warning).  ``straggler_s`` (a measured
        worst-vs-median step skew) prices ``cost.straggler_penalty_s``
        into every arm of the free search.

        A pipeline winner runs the pipeline where this session's world and
        batch can stage it (:meth:`_pipeline_executable`); otherwise the
        best arm that can run here runs instead, with the reference's
        note.  A sharded winner (``every_step_sharded``) runs sharded data
        parallelism on its plan.  Before returning, every
        rank checks that all ranks planned alike.  The decision record is
        ``self.planned``: the reference's keys, plus the arm that runs
        (``executed``), the plan's ``digest`` and the search's host
        seconds (``search_s``)."""
        if self._built:
            raise RuntimeError("plan_auto must run before the first step "
                               "(a pipeline strategy given at construction "
                               "is built there)")
        if parallelism is not None:
            if (shard_state is not None or pipeline_stages is not None
                    or micro_batches is not None):
                raise ValueError(
                    "parallelism= subsumes shard_state/pipeline_stages/"
                    "micro_batches — fold them into the spec "
                    "(e.g. 'dp=4,pp=2,micro=8,shard')")
            if scheduler is not None:
                raise ValueError(
                    "parallelism= pins arms of the planner's FREE search; "
                    "a pinned rounds scheduler bypasses that search — "
                    "drop one")
        if topology is not None:
            self.apply_topology(topology)
        cal = resolve_calibration(calibration)
        if cal is not None:
            self.calibration = cal
            shape = [(t.name, t.size) for t in cal.topology.tiers]
            if self.topology is not None and \
                    [(t.name, t.size) for t in self.topology.tiers] != shape:
                self._note(f"warning: calibration measured "
                           f"{cal.topology.spec()} but the planning topology "
                           f"is {self.topology.spec()}; fitted links apply "
                           f"only to the fabric they were measured on — "
                           f"planning keeps the preset links")
            else:
                self.apply_topology(cal.topology)
        if scheduler is not None and shard_state:
            raise ValueError("shard_state composes only with the planner's "
                             "every-step arm, not a pinned rounds scheduler")
        if scheduler is not None and memory_budget_gb is not None:
            raise ValueError(
                "memory_budget_gb constrains the planner's FREE search "
                "over arms; a pinned rounds scheduler fixes the memory "
                "footprint, so the budget cannot be enforced — drop one")
        if pipeline_stages is not None and pipeline_stages > 1:
            if scheduler is not None or shard_state:
                raise ValueError("pipeline_stages composes with every-step "
                                 "replicated DP only (DESIGN.md §9)")
        if self.topology is not None:
            lp: Any = self.topology
            world = lp.world
        else:
            lp = self.resolve_link(link, alpha, beta_gbps)
            world = self.world
        if t_backward_s is None:
            t_backward_s = self._group_min(self.profile_backward())
        profiles = profiles_from_grads(self._params, t_backward_s)
        cost_table = resolve_cost_table(compression_costs)
        kw: Dict[str, Any] = {}
        if candidates is not None:
            kw["candidates"] = candidates
        if cost_table is not None:
            kw["cost_table"] = cost_table
        t_bwd = sum(p.t_backward_s for p in profiles)
        pipe_axis = PipelineAxis(
            global_tokens=float(self.cfg.batch * self.cfg.seq),
            bytes_per_token=float(self.model_cfg.d_model * 4))
        tensor_axis, expert_axis = self._model_axes(pipe_axis)
        mem_budget = (memory_budget_gb * 2**30
                      if memory_budget_gb is not None else None)

        def _search(sg):
            # the free search, kept for _replan / replan_now to re-run with
            # a fresh profile; a pinned scheduler keeps the FREE search
            # too (the pin is a user preference, not an execution
            # constraint)
            return functools.partial(
                plan_rounds, link=lp, world=world,
                opt_name=self.cfg.optimizer, shard_grid=sg,
                opt_moments=self.opt_moments,
                memory_budget_bytes=mem_budget, pipeline=pipe_axis,
                tensor=tensor_axis, expert=expert_axis,
                parallelism=parallelism, straggler_s=straggler_s,
                **kw, **({"tau_grid": tau_grid}
                         if tau_grid is not None else {}))

        self._replan_search = None
        arms: Dict[str, StrategyPlan]
        t_search = time.perf_counter()
        if pipeline_stages is not None and pipeline_stages > 1:
            # pinned pipeline(S, M): price that arm, plan only its DP edge
            S = pipeline_stages
            M = micro_batches or 8
            # price at the world when it factors into pipe(S) x data(>= 2);
            # otherwise at the smallest such world (a one-card run still
            # gets an honest modeled record)
            plan_w = world if (world % S == 0 and world // S >= 2) else 2 * S
            act = (pipe_axis.global_tokens / (plan_w // S) / M
                   * pipe_axis.bytes_per_token)
            net_p = lp
            if isinstance(lp, Topology) and (
                    plan_w != lp.world
                    or not pipeline_placements(lp, plan_w, S)):
                # the pinned S fits no tier (or the fallback world left
                # the topology behind): price flat on the outermost link
                self._note(f"note: pinned pipeline(S={S}) fits no tier of "
                           f"{lp.spec()}; pricing it flat on the outermost "
                           f"link")
                net_p = lp.outermost.link
            best = exec_best = pipeline_arm(
                profiles, net_p, plan_w, S, M, act,
                opt_name=self.cfg.optimizer,
                opt_moments=self.opt_moments, **kw)
            arms = {best.key: best}
            strategy = strategy_from_plan(best, self.axes)
        elif scheduler is None:
            shard_grid = ((False, True) if shard_state is None
                          else (bool(shard_state),))
            self._replan_search = _search(shard_grid)
            best, arms = self._replan_search(profiles)
            exec_best = best
            if best.pipeline_stages > 1 and not self._pipeline_executable(
                    best.pipeline_stages, best.micro_batches):
                # the modeled winner targets a pod this world cannot
                # stage: run the best arm that CAN execute, keep the record
                exec_best = min(
                    (a for a in arms.values() if a.pipeline_stages <= 1
                     or self._pipeline_executable(a.pipeline_stages,
                                                  a.micro_batches)),
                    key=lambda a: a.modeled_step_s)
                self._note(f"note: modeled winner {best.key} needs a "
                           f"pipe({best.pipeline_stages}) mesh this host "
                           f"cannot build; executing {exec_best.key} "
                           f"instead")
            strategy = strategy_from_plan(exec_best, self.axes)
        elif isinstance(scheduler, LocalSGDScheduler):
            self._replan_search = _search((False,))
            rp = serial_round_plan(profiles, lp, world, **kw)
            best = exec_best = local_sgd_arm(rp, t_bwd,
                                             scheduler.cfg.period)
            arms = {best.schedule.key: best}
            strategy = SyncStrategy(
                scheduler=scheduler,
                param_reducer=PlanExecutor(rp, self.axes))
        else:
            # LAG / push-pull / every-step: the gradient syncs get the
            # overlap-planned per-bucket plan; the round COUNT is the
            # scheduler's, so the every-step modeled time is an upper bound
            self._replan_search = _search((False,))
            cp = plan(profiles, lp, world, **kw)
            best = exec_best = StrategyPlan(
                schedule=RoundSchedule(kind=scheduler.name), comm=cp,
                modeled_step_s=cp.modeled_step_s,
                round_cost_s=cp.modeled_step_s, t_backward_s=t_bwd)
            arms = {best.schedule.key: best}
            strategy = SyncStrategy(
                scheduler=scheduler,
                grad_reducer=PlanExecutor(cp, self.axes))

        search_s = time.perf_counter() - t_search
        baselines = {
            name: fixed_config_plan(profiles, lp, world, comp, algo,
                                    compressor_args=cargs,
                                    cost_table=cost_table)
            for name, (comp, algo, cargs) in FIXED_BASELINES.items()}
        digest = self._check_plan_agreement(exec_best)
        self.strategy = strategy
        self.planned = {"strategy_plan": best, "arms": arms,
                        "baselines": baselines,
                        "t_backward_s": t_backward_s,
                        "cost_table": cost_table,
                        "executed": exec_best, "digest": digest,
                        "search_s": search_s}
        return best

    def apply_micro_batching(self, micro_batches: int) -> bool:
        """Attach S = 1 micro-batched accumulation (the degenerate pipe)
        to the installed strategy — the ``--sync auto --micro-batches M``
        composition.  Composes with every-step replicated arms only; for
        other winners (local SGD, sharded, a pipelined arm) the request is
        declined with a printed reason.  Returns True when micro-batching
        will run.  The reference's method."""
        M = int(micro_batches)
        st = self.strategy
        if M > 1 and st is not None and (st.pipeline_stages > 1
                                         or st.micro_batches > 1):
            return True                      # already micro-batched
        if self._built:
            raise RuntimeError("apply_micro_batching must run before the "
                               "first step")
        if M <= 1 or st is None:
            return M <= 1 and st is None
        sched = st.scheduler
        if (sched.computes != frozenset({"sync"}) or sched.has_param_rounds
                or sched.needs_grad_probe or st.shard_state):
            self._note(f"note: micro-batching composes with every-step "
                       f"replicated sync only; chosen arm "
                       f"({st.describe()}) runs without it")
            return False
        reducer = st.grad_reducer
        if isinstance(reducer, PlanExecutor):
            # plans are tied to the whole model's tree: a per-row reducer
            # from the plan's dominant bucket
            reducer = _per_row_reducer(reducer.plan, self.axes)
        self.strategy = SyncStrategy(
            scheduler=sched, grad_reducer=reducer,
            parallelism=ParallelismSpec(micro_batches=M))
        return True

    def batch(self, step: int):
        """This rank's rows of the global batch of ``step`` (data rank d
        of dp takes rows d·B/dp … (d+1)·B/dp, as the reference shards the
        batch over its data axis; every stage of a pipe takes its data
        rank's rows)."""
        data = self.data.batch(step)
        local = data["tokens"].shape[0] // self.dp_world
        rows = slice(self.dp_rank * local, (self.dp_rank + 1) * local)
        out = {"tokens": torch.from_numpy(np.ascontiguousarray(
            data["tokens"][rows])).to(self.device, torch.int64)}
        if "src" in data:      # the encoder-decoder's f32 frames
            out["src"] = torch.from_numpy(np.ascontiguousarray(
                data["src"][rows])).to(self.device)
        return out

    def step_once(self) -> float:
        """Run one training step under the strategy; returns the loss.  The
        order is the reference's: LAG's probe, the scheduler's ``round``,
        the step it names (sync / reuse / local), the parameter round, then
        ``commit``.  A MoE model's drop tap is on for the step only (the
        reference's stays on from the session's construction, which also
        counts forwards run outside steps, such as ``profile_backward``'s);
        left on, its running device count would meet the next run's
        tensors, a fake-tensor trace's among them."""
        if not self.model_cfg.num_experts:
            return self._step_once()
        old = moe_mod.enable_drop_tap(True)
        try:
            return self._step_once()
        finally:
            moe_mod.enable_drop_tap(old)

    def _step_once(self) -> float:
        self._build()
        step = self.step
        batch = self.batch(step)
        if self.strategy is None:
            loss = self._base(self._params, self.opt_state, batch, step)
            self.grad_rounds += 1      # BSP syncs gradients every step
            return self._record(loss)

        # the stochastic compressors draw from a generator per
        # (seed, step), as the reference folds the step into its key
        rng = torch.Generator(self.device).manual_seed(
            self.cfg.seed * 2**32 + step)
        sched = self.strategy.scheduler
        probe = None
        if sched.needs_grad_probe:
            loss_p, grads, delta, scale = self._probe(
                self._params, batch, self._sched_state["g_last"])
            probe = {"delta": float(delta), "scale": float(scale)}
            self.control_rounds += 1
        action, self._sched_state = sched.round(step, self._sched_state,
                                                probe)
        synced = None
        if action.compute == "sync":
            if sched.needs_grad_probe:
                self._params, self.opt_state, self.sync_state, synced = \
                    self._sync(self._params, self.opt_state, self.sync_state,
                               grads, step, rng)
                loss = loss_p
            else:
                self._params, self.opt_state, self.sync_state, loss = \
                    self._sync(self._params, self.opt_state, self.sync_state,
                               batch, step, rng)
            self.grad_rounds += 1
        elif action.compute == "reuse":
            self._params, self.opt_state = self._reuse(
                self._params, self.opt_state, self._sched_state["g_last"],
                step)
            loss = loss_p
        elif action.compute == "local":
            loss = self._local(self._params, self.opt_state, batch, step)
        else:
            raise ValueError(f"unknown action {action.compute!r}")
        if sched.needs_grad_probe:
            del grads
        if action.param_round:
            self._params, self._anchor, self._red_state = self._param_round(
                self._params, self._anchor, self._red_state, rng)
            self.param_rounds += 1
        self._sched_state = sched.commit(self._sched_state, action, synced)
        del synced
        return self._record(loss)

    def _record(self, loss) -> float:
        loss = float(loss)
        self.losses.append(loss)
        self.step += 1
        self._drain_drops()
        return loss

    def _drain_drops(self) -> None:
        """Add the step's MoE drop counts (one host read of the device
        count, after the loss reached the host)."""
        if not self.model_cfg.num_experts:
            return
        d, r = moe_mod.drain_drop_tap()
        self.dropped_tokens += d
        self.routed_tokens += r

    @property
    def drop_fraction(self) -> float:
        """Share of the routed token-choices dropped to capacity overflow
        so far (0.0 for dense models and before any step)."""
        return self.dropped_tokens / self.routed_tokens \
            if self.routed_tokens else 0.0

    def run(self, steps: Optional[int] = None, log_every: int = 0,
            log=print) -> List[float]:
        """Train ``steps`` steps (default: ``cfg.steps``); returns the
        losses of THIS run.  Each step's wall time (host clock, after the
        loss reached the host) is kept in ``step_times``; the steps after
        the one that built the programs feed the drift check of
        :meth:`enable_replan`, which runs after every step."""
        steps = steps or self.cfg.steps
        t0 = time.perf_counter()
        out: List[float] = []
        for i in range(steps):
            pre_built = self._built      # a build step pays the build
            ts = time.perf_counter()
            loss = self.step_once()
            dt = time.perf_counter() - ts
            self.step_times.append(dt)
            if pre_built:
                self._window.append(dt)
            self._maybe_replan()
            out.append(loss)
            if log_every and i % log_every == 0:
                drops = (f", dropped {self.drop_fraction * 100:.1f}%"
                         if self.routed_tokens else "")
                log(f"step {self.step - 1:5d} loss {loss:.4f} "
                    f"({dt * 1e3:.1f} ms, comm rounds {self.comm_rounds}"
                    f"{drops})", flush=True)
        self.wall_s = time.perf_counter() - t0
        return out

    # -- modeled vs measured ------------------------------------------------

    def measured_step_s(self) -> float:
        """Median wall time of this rank's steps that :meth:`run` ran,
        dropping the first (it builds the programs).  NaN before any
        step."""
        times = self.step_times[1:] or self.step_times
        return statistics.median(times) if times else float("nan")

    def enable_replan(self, drift_pct: float, check_every: int = 25,
                      max_replans: int = 1) -> None:
        """Arm the drift-gated re-planning hook (``--replan-drift-pct``):
        every ``check_every`` steps after the build, compare the window's
        median step time (the group's largest) against the plan's modeled
        wall step; when the drift exceeds ``drift_pct`` percent,
        re-profile the backward and re-run the planner's search.  Off by
        default (0 disarms)."""
        self._replan_drift_pct = float(drift_pct)
        self._replan_every = max(int(check_every), 2)
        self._max_replans = int(max_replans)

    def _modeled_wall_s(self) -> float:
        sp = self.planned.get("strategy_plan") if self.planned else None
        if sp is None:
            return float("nan")
        return modeled_wall_step_s(sp.modeled_step_s, sp.t_backward_s)

    def _maybe_replan(self) -> None:
        """The drift check after a step.  Every rank reaches the same
        decision: the window fills at the same step on every rank, the
        measured step is the group's largest median, and the modeled one
        comes from the plan all ranks agreed on."""
        if (self._replan_drift_pct <= 0 or self.planned is None
                or len(self._window) < self._replan_every
                or self.replans >= self._max_replans):
            if len(self._window) >= self._replan_every:
                self._window.clear()
            return
        measured = self._group_max(statistics.median(self._window))
        self._window.clear()
        modeled = self._modeled_wall_s()
        if not modeled or modeled != modeled:
            return
        drift = drift_fraction(modeled, measured)
        if abs(drift) * 100.0 <= self._replan_drift_pct:
            return
        self._replan(drift, measured)

    def replan_now(self, straggler_s: float = 0.0,
                   t_backward_s: Optional[float] = None) -> Dict[str, Any]:
        """Force one re-plan outside the drift gate (the elastic runtime's
        straggler escalation): re-run the stashed planner search pricing
        every arm with ``cost.straggler_penalty_s(straggler_s,
        rounds/step)``, so a persistent straggler demotes the winning
        cadence.  ``t_backward_s`` skips the backward re-profile
        (deterministic re-plans).  Every rank calls it, with the same
        ``straggler_s``.  Returns the recorded event; needs a prior
        :meth:`plan_auto` (the stashed search)."""
        if self.planned is None:
            raise RuntimeError("replan_now needs a prior plan_auto")
        measured = self.measured_step_s()
        if measured == measured:
            measured = self._group_max(measured)
        self._replan(0.0, measured, straggler_s=straggler_s,
                     t_backward_s=t_backward_s)
        return self.replan_events[-1]

    def _collapse_mean(self, tree):
        """A diverging scheduler's per-rank state collapsed to its mean
        over the group (the parameter-averaging round the scheduler owed):
        floating leaves averaged in f32 and cast back, the others kept."""
        if self.world == 1:
            return tree
        from repro_torch.core.collectives import allreduce

        def one(x):
            if not torch.is_floating_point(x):
                return x
            buf = x.detach().to(torch.float32, copy=True)
            buf = allreduce(buf, "psum", self.group) / float(self.world)
            return buf.to(x.dtype)
        return tree_map(one, tree)

    def _replan(self, drift: float, measured_s: float,
                straggler_s: float = 0.0,
                t_backward_s: Optional[float] = None) -> None:
        """Re-run the stashed planner search with a FRESH backward profile
        (the group's smallest, as :meth:`plan_auto` takes it).  The ranks
        check that they planned alike, then the new winner is installed
        when neither the outgoing nor the incoming arm pins an execution
        shape that would strand state: no pipeline / micro-batch mesh and
        no shard rows on either side, and an incoming plain every-step or
        local-SGD arm.  An outgoing diverging scheduler's per-rank state is
        collapsed to its mean first (counted as one parameter round);
        scheduler and EF state start afresh on the rebuild.  Pipeline and
        sharded shapes only record the recommendation."""
        event: Dict[str, Any] = {
            "step": self.step, "drift_frac": drift,
            "measured_step_s": measured_s,
            "old_key": self.planned["strategy_plan"].key,
            "applied": False, "note": ""}
        if straggler_s > 0.0:
            event["straggler_s"] = straggler_s
        search = self._replan_search
        if search is None:
            event["note"] = ("no free-search plan to rerun (pinned "
                             "pipeline)")
            event["new_key"] = event["old_key"]
            self.replans += 1
            self.replan_events.append(event)
            return
        t_bwd = t_backward_s if t_backward_s is not None \
            else self._group_min(self.profile_backward())
        # the leaf sizes plan_auto profiled (the model's tree, whatever
        # this rank holds)
        profiles = profiles_from_grads(self.model.param_desc(), t_bwd)
        ss = straggler_s if straggler_s > 0.0 \
            else search.keywords["straggler_s"]
        best, arms = search(profiles, straggler_s=ss)
        digest = self._check_plan_agreement(best)
        event["new_key"] = best.key
        old = self.strategy
        old_ok = (old is not None
                  and old.pipeline_stages <= 1 and old.micro_batches <= 1
                  and not old.shard_state)
        new_ok = (best.schedule.kind in ("every_step", "local_sgd")
                  and not best.shard_state
                  and best.pipeline_stages <= 1
                  and best.micro_batches <= 1)
        if old_ok and new_ok:
            if best.key != event["old_key"] \
                    or type(old.scheduler).name != best.schedule.kind:
                if self._built and old.scheduler.diverges_params:
                    # the collapse IS the parameter-averaging round the
                    # outgoing local scheduler owed
                    self._params = self._collapse_mean(self._params)
                    self.opt_state = self._collapse_mean(self.opt_state)
                    self.param_rounds += 1
                self.strategy = strategy_from_plan(best, self.axes)
                self._built = False    # rebuilt lazily; EF residual resets
                event["applied"] = True
            else:
                event["note"] = "re-plan kept the incumbent arm"
        else:
            event["note"] = ("winner needs a different execution shape "
                             "(shard/pipeline); not swapped mid-run")
        self.planned = dict(self.planned, strategy_plan=best, arms=arms,
                            t_backward_s=t_bwd, digest=digest,
                            **({"executed": best} if event["applied"]
                               else {}))
        self.replans += 1
        self.replan_events.append(event)
        self._note(f"replan @step {self.step}: drift {drift * 100:+.1f}%"
                   + (f", straggler {ss * 1e3:.1f} ms" if ss > 0 else "")
                   + f" -> {best.key}"
                   + (" (installed)" if event["applied"]
                      else f" ({event['note']})"))

    def drift_report(self) -> Optional[Dict[str, Any]]:
        """The modeled-vs-measured closing of the loop: per-arm predicted
        step time against this rank's measured median, with the fit's
        error budget (comm α/β confidence + backward-profile spread +
        measurement spread).  None until both a plan and steps exist.
        Local to the rank (no collective)."""
        if self.planned is None or not self.step_times:
            return None
        sp = self.planned["strategy_plan"]
        measured = self.measured_step_s()
        modeled_wall = self._modeled_wall_s()
        times = self.step_times[1:] or self.step_times
        spread = (max(times) - min(times)) / 2.0 if len(times) > 1 else 0.0
        comm_err = plan_comm_error_s(sp.comm, self.calibration)
        fit_err = comm_err + self._t_backward_spread_s + spread
        arms = {}
        for key, arm in self.planned.get("arms", {}).items():
            wall = modeled_wall_step_s(arm.modeled_step_s, arm.t_backward_s)
            arms[key] = {
                "modeled_step_s": arm.modeled_step_s,
                "modeled_wall_step_s": wall,
                "drift_pct": drift_fraction(wall, measured) * 100.0}
        return {
            "plan_key": sp.key,
            "modeled_step_s": sp.modeled_step_s,
            "modeled_wall_step_s": modeled_wall,
            "measured_step_s": measured,
            "steps_measured": len(times),
            "drift_frac": drift_fraction(modeled_wall, measured),
            "drift_pct": drift_fraction(modeled_wall, measured) * 100.0,
            "comm_fit_err_s": comm_err,
            "t_backward_err_s": self._t_backward_spread_s,
            "measured_spread_s": spread,
            "fit_error_s": fit_err,
            "within_fit_error": abs(measured - modeled_wall) <= fit_err,
            "replans": self.replans,
            "replan_events": list(self.replan_events),
            "arms": arms,
        }

    def num_params(self) -> int:
        return count_params(self.model_cfg)

    def save_checkpoint(self, path: str) -> None:
        """Write ``{"params", "opt"}`` and the step in the reference's
        format (``checkpoint.save``).  Rank 0 writes (this rank's worker
        under a diverging scheduler, as the reference saves worker 0's
        view); the other ranks wait for it.  In sharded mode the optimizer
        state is saved LEAF-SHAPED (:meth:`full_opt_state`, which every
        rank joins: the moments and the f32 master), so the checkpoint
        restores at any world and in either mode; in pipeline mode the
        parameters and moments are merged from every stage into the
        model's leaves, so the checkpoint does not pin the stage count."""
        params, opt = self.params, self.full_opt_state()
        if self.rank == 0:
            checkpoint.save(path, {"params": params, "opt": opt},
                            step=self.step)
        del params, opt
        if self.world > 1:
            dist.barrier(self.group)

    def load_checkpoint(self, path: str) -> int:
        """Restore a checkpoint written by :meth:`save_checkpoint` (or by
        the reference's) into this session, BEFORE the first step.  The
        payload checksum is verified first (a truncated file raises
        ``ValueError``); a missing leaf or optimizer buffer is refused.
        Leaves keep their stored dtypes.  Checkpoints are leaf-shaped, so
        restoring is mode-agnostic: a replicated session takes the moments
        (a sharded checkpoint's f32 ``master`` is dropped: the params
        carry the same values), and a sharded build re-partitions the
        whole leaf-shaped state onto its own layout at its own world.
        Sets and returns the restored step; the synthetic data is a
        function of the step, so the resumed run replays the batch
        sequence."""
        if self.strategy is not None and (
                self.strategy.pipeline_stages > 1
                or self.strategy.micro_batches > 1):
            raise NotImplementedError(
                "load_checkpoint composes with replicated and sharded DP "
                "builds; restoring into a pipeline/micro-batched build is "
                "not supported")
        if self._built:
            raise RuntimeError("load_checkpoint must run before the first "
                               "step")
        data, manifest = checkpoint.load_tensors(path, self.device)
        data = _leaf_shaped_keys(data)

        def tree_at(prefix, like):
            flat = _flatten_with_paths(like)
            missing = [k for k in flat if f"{prefix}/{k}" not in data]
            if missing:
                raise ValueError(
                    f"checkpoint {path!r} lacks {prefix!r} leaves "
                    f"{missing[:3]}{'…' if len(missing) > 3 else ''} — "
                    f"was it saved from a different model config?")
            it = iter([data[f"{prefix}/{k}"] for k in flat])
            return tree_map(lambda _: next(it), like)

        self._params = tree_at("params", self._params)
        tops = sorted({k.split("/", 2)[1]
                       for k in data if k.startswith("opt/")})
        full = {t: tree_at(f"opt/{t}", self._params) for t in tops}
        moments = {k: v for k, v in full.items() if k != "master"}
        missing = sorted(set(self.opt_state) - set(moments))
        if missing:
            raise ValueError(
                f"checkpoint {path!r} lacks optimizer buffers "
                f"{missing} required by {self.cfg.optimizer!r}")
        self.opt_state = {k: moments[k] for k in self.opt_state}
        self._restore_opt = full
        self.step = int(manifest.get("step") or 0)
        return self.step

    def summary(self) -> str:
        parts = [f"steps {self.step}", f"comm rounds {self.comm_rounds} "
                 f"(grad {self.grad_rounds}, param {self.param_rounds}"
                 + (f", control probes {self.control_rounds}"
                    if self.control_rounds else "") + ")"]
        if self.routed_tokens:
            parts.append(
                f"moe dropped {self.dropped_tokens:.0f}/"
                f"{self.routed_tokens:.0f} token-choices "
                f"({self.drop_fraction * 100:.1f}%)")
        parts.append(self.strategy.describe() if self.strategy is not None
                     else "vanilla BSP")
        return "; ".join(parts)
