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
and read the reference's checkpoint format.  The sharded, pipeline and
elastic modes wait (ROADMAP.md queue 1, items 8, 9 and 12), and so does
calibration (item 11).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import checkpoint
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.checkpoint.checkpoint import _flatten_with_paths
from repro_torch.configs import get_config, reduced
from repro_torch.core import (GradientSynchronizer, PlanExecutor, SyncConfig,
                              SyncStrategy, get_scheduler)
from repro_torch.core.collectives import all_gather, as_axes
from repro_torch.core.collectives import axes_for_topology
from repro_torch.core.collectives.p2p import process_group, to_wire
from repro_torch.core.schedule import (LINK_PRESETS, LinkParams,
                                       PipelineAxis, RoundSchedule,
                                       StrategyPlan, TensorAxis, Topology,
                                       fixed_config_plan, plan, plan_rounds,
                                       profiles_from_grads,
                                       resolve_cost_table, serial_round_plan)
from repro_torch.core.schedule.planner import FIXED_BASELINES, local_sgd_arm
from repro_torch.core.strategy import LocalSGDScheduler
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.dist import init_group
from repro_torch.launch.steps import (_make_synced_train_step,
                                      loss_and_grads, make_lag_programs,
                                      make_local_train_step,
                                      make_param_round_step, make_train_step)
from repro_torch.models import Model
from repro_torch.optim import make_optimizer, warmup_cosine


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
    data axes ``axes`` (process groups; None: the default group).  A tp /
    ep winner runs its DP edge (the arm's comm plan) and carries the spec
    as record axes, as the reference does on a mesh with no model axis; a
    sharded winner raises (``SyncStrategy``, ROADMAP.md queue 1, item 8)
    and a pipeline winner too (item 9: :meth:`TrainSession.plan_auto`
    runs the best executable arm in its place)."""
    if sp.schedule.kind == "local_sgd":
        return SyncStrategy(
            scheduler=get_scheduler("local_sgd", period=sp.schedule.period),
            param_reducer=PlanExecutor(sp.comm, axes))
    if sp.pipeline_stages > 1:
        raise NotImplementedError(
            f"the planner's arm {sp.key} needs a pipeline executor, not "
            f"ported yet (ROADMAP.md queue 1, item 9)")
    return SyncStrategy(scheduler=get_scheduler("every_step"),
                        grad_reducer=PlanExecutor(sp.comm, axes),
                        parallelism=sp.parallelism)


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


class TrainSession:
    """One training run driven by a :class:`SyncStrategy` (or vanilla BSP).

    ``params`` seeds the run with a given parameter tree (tensors, moved to
    the session's device; e.g. ``convert.params_from_jax``), so that both
    packages can start from one tree; otherwise random weights are drawn
    from a ``torch.Generator`` seeded with ``cfg.seed`` on the device.
    ``group`` is the process group (default: the default group, created at
    world 1 if there is none).  ``self.params`` and ``self.opt_state`` are
    this rank's: under local SGD or push/pull, this worker's parameters
    (the reference's ``params`` is worker 0's view)."""

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
        if c.batch % self.world:
            raise ValueError(f"global batch {c.batch} does not split over "
                             f"{self.world} ranks")
        self.optimizer = make_optimizer(c.optimizer,
                                        lr=warmup_cosine(c.lr, c.warmup,
                                                         c.steps))
        self.data = SyntheticPipeline(DataConfig(
            vocab_size=model_cfg.vocab_size, seq_len=c.seq,
            global_batch=c.batch))
        if params is None:
            params = self.model.init(torch.Generator(self.device).manual_seed(
                c.seed))
        else:
            params = tree_map(lambda t: t.detach().to(self.device).clone(),
                              params)
        self.params = params
        self.opt_state = self.optimizer.init(params)
        # measured f32 moment buffers per parameter (sgd carries one, adam
        # two): the planner's memory model
        n_elems = sum(int(p.numel()) for p in tree_leaves(params))
        self.opt_moments = (sum(int(x.numel()) for x in
                                tree_leaves(self.opt_state))
                            / max(n_elems, 1))
        # the data axes the planned reducers run over: the session's
        # group, or one group per tier after apply_topology
        self.axes: Tuple[Any, ...] = as_axes(group)
        self.topology: Optional[Topology] = None
        self.tiered_mesh = False
        self.planned: Optional[Dict[str, Any]] = None
        self.sync_state: Optional[Any] = None
        self.step = 0
        self.losses: List[float] = []
        self.grad_rounds = 0
        self.param_rounds = 0
        self.control_rounds = 0
        self.step_times: List[float] = []
        self.wall_s = float("nan")
        self._engine = None
        self._built = False

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
        if self.strategy is None:
            self._base = make_train_step(self.model, self.optimizer,
                                         self.group)
            self._built = True
            return
        st = self.strategy
        sched = st.scheduler
        self._sched_state = sched.init_state(self.params)
        engine = st.grad_reducer
        if engine is None and "sync" in sched.computes:
            engine = GradientSynchronizer(SyncConfig(), self.group)
        self._engine = engine
        if sched.needs_grad_probe:
            self._probe, self._sync, self._reuse = make_lag_programs(
                self.model, self.optimizer, engine, self.group)
            self.sync_state = engine.init_state(self.params)
        elif "sync" in sched.computes:
            self._sync, _, init_sync_state = _make_synced_train_step(
                self.model, self.optimizer, engine, self.group)
            self.sync_state = init_sync_state(self.params)
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
                    self.params)
                self._red_state = st.param_reducer.init_state(self.params)
        self._built = True

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
        backward's share of a grad step).  The reference's policy."""
        batch = self.batch(0)
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))

        def once() -> float:
            sync()
            t0 = time.perf_counter()
            _, grads = loss_and_grads(self.model, self.params, batch)
            sync()
            dt = time.perf_counter() - t0
            del grads
            return dt

        once()
        times = [once() for _ in range(max(repeats, 1))]
        return min(times) * (2.0 / 3.0)

    def _group_min(self, value: float) -> float:
        """The smallest of every rank's ``value`` (one f64 all-reduce)."""
        if self.world == 1:
            return value
        wire_dev = self.device if dist.get_backend(self.group) == "nccl" \
            else torch.device("cpu")
        buf = to_wire(torch.tensor([value], dtype=torch.float64,
                                   device=wire_dev), self.group)
        dist.all_reduce(buf, op=dist.ReduceOp.MIN,
                        group=process_group(self.group))
        return float(buf.item())

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

    def _note(self, msg: str) -> None:
        if self.rank == 0:
            print(msg, flush=True)

    def plan_auto(self, link="fast_ici", *, alpha=None, beta_gbps=None,
                  tau_grid=None, candidates=None, scheduler=None,
                  t_backward_s: Optional[float] = None,
                  shard_state: Optional[bool] = None,
                  memory_budget_gb: Optional[float] = None,
                  topology=None, compression_costs=None) -> StrategyPlan:
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
        ``memory_budget_gb`` constrain the free search's shard axis.
        ``compression_costs`` (a ``CompressionCostTable`` or a path to the
        reference's JSON) replaces the analytic compression-compute term.

        A pipeline winner cannot run here (item 9): the best executable
        arm runs instead, with the reference's note.  A sharded winner
        raises ``NotImplementedError`` (item 8).  Before returning, every
        rank checks that all ranks planned alike.  The decision record is
        ``self.planned``: the reference's keys, plus the arm that runs
        (``executed``), the plan's ``digest`` and the search's host
        seconds (``search_s``)."""
        if self._built:
            raise RuntimeError("plan_auto must run before the first step")
        if topology is not None:
            self.apply_topology(topology)
        if scheduler is not None and shard_state:
            raise ValueError("shard_state composes only with the planner's "
                             "every-step arm, not a pinned rounds scheduler")
        if scheduler is not None and memory_budget_gb is not None:
            raise ValueError(
                "memory_budget_gb constrains the planner's FREE search "
                "over arms; a pinned rounds scheduler fixes the memory "
                "footprint, so the budget cannot be enforced — drop one")
        if self.topology is not None:
            lp: Any = self.topology
            world = lp.world
        else:
            lp = self.resolve_link(link, alpha, beta_gbps)
            world = self.world
        if t_backward_s is None:
            t_backward_s = self._group_min(self.profile_backward())
        profiles = profiles_from_grads(self.params, t_backward_s)
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
        # tp pays 4 activation allreduces per layer (Megatron wire); the
        # expert axis would price MoE stacks, which the port has none of
        # (ROADMAP.md queue 1, item 4)
        tensor_axis = TensorAxis(
            global_tokens=pipe_axis.global_tokens,
            bytes_per_token=pipe_axis.bytes_per_token,
            n_layers=self.model_cfg.num_layers)
        mem_budget = (memory_budget_gb * 2**30
                      if memory_budget_gb is not None else None)

        arms: Dict[str, StrategyPlan]
        t_search = time.perf_counter()
        if scheduler is None:
            shard_grid = ((False, True) if shard_state is None
                          else (bool(shard_state),))
            best, arms = plan_rounds(
                profiles, lp, world,
                opt_name=self.cfg.optimizer, shard_grid=shard_grid,
                opt_moments=self.opt_moments,
                memory_budget_bytes=mem_budget,
                pipeline=pipe_axis, tensor=tensor_axis,
                **dict(kw, **({"tau_grid": tau_grid}
                              if tau_grid is not None else {})))
            exec_best = best
            if best.pipeline_stages > 1:
                # no pipeline executor yet (ROADMAP.md queue 1, item 9):
                # run the best arm that CAN execute, keep the record
                exec_best = min((a for a in arms.values()
                                 if a.pipeline_stages <= 1),
                                key=lambda a: a.modeled_step_s)
                self._note(f"note: modeled winner {best.key} needs a "
                           f"pipe({best.pipeline_stages}) mesh this host "
                           f"cannot build; executing {exec_best.key} "
                           f"instead")
            strategy = strategy_from_plan(exec_best, self.axes)
        elif isinstance(scheduler, LocalSGDScheduler):
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

    def batch(self, step: int):
        """This rank's rows of the global batch of ``step`` (rank r of w
        takes rows r·B/w … (r+1)·B/w, as the reference shards the batch
        over its data axis)."""
        tokens = self.data.batch(step)["tokens"]
        local = tokens.shape[0] // self.world
        rows = tokens[self.rank * local:(self.rank + 1) * local]
        return {"tokens": torch.from_numpy(np.ascontiguousarray(rows)).to(
            self.device, torch.int64)}

    def step_once(self) -> float:
        """Run one training step under the strategy; returns the loss.  The
        order is the reference's: LAG's probe, the scheduler's ``round``,
        the step it names (sync / reuse / local), the parameter round, then
        ``commit``."""
        self._build()
        step = self.step
        batch = self.batch(step)
        if self.strategy is None:
            loss = self._base(self.params, self.opt_state, batch, step)
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
                self.params, batch, self._sched_state["g_last"])
            probe = {"delta": float(delta), "scale": float(scale)}
            self.control_rounds += 1
        action, self._sched_state = sched.round(step, self._sched_state,
                                                probe)
        synced = None
        if action.compute == "sync":
            if sched.needs_grad_probe:
                self.params, self.opt_state, self.sync_state, synced = \
                    self._sync(self.params, self.opt_state, self.sync_state,
                               grads, step, rng)
                loss = loss_p
            else:
                self.params, self.opt_state, self.sync_state, loss = \
                    self._sync(self.params, self.opt_state, self.sync_state,
                               batch, step, rng)
            self.grad_rounds += 1
        elif action.compute == "reuse":
            self.params, self.opt_state = self._reuse(
                self.params, self.opt_state, self._sched_state["g_last"],
                step)
            loss = loss_p
        elif action.compute == "local":
            loss = self._local(self.params, self.opt_state, batch, step)
        else:
            raise ValueError(f"unknown action {action.compute!r}")
        if sched.needs_grad_probe:
            del grads
        if action.param_round:
            self.params, self._anchor, self._red_state = self._param_round(
                self.params, self._anchor, self._red_state, rng)
            self.param_rounds += 1
        self._sched_state = sched.commit(self._sched_state, action, synced)
        del synced
        return self._record(loss)

    def _record(self, loss) -> float:
        loss = float(loss)
        self.losses.append(loss)
        self.step += 1
        return loss
    def run(self, steps: Optional[int] = None, log_every: int = 0,
            log=print) -> List[float]:
        """Train ``steps`` steps (default: ``cfg.steps``); returns the
        losses of THIS run.  Each step's wall time (host clock, after the
        loss reached the host) is kept in ``step_times``."""
        steps = steps or self.cfg.steps
        t0 = time.perf_counter()
        out: List[float] = []
        for i in range(steps):
            ts = time.perf_counter()
            loss = self.step_once()
            dt = time.perf_counter() - ts
            self.step_times.append(dt)
            out.append(loss)
            if log_every and i % log_every == 0:
                log(f"step {self.step - 1:5d} loss {loss:.4f} "
                    f"({dt * 1e3:.1f} ms, comm rounds {self.comm_rounds})",
                    flush=True)
        self.wall_s = time.perf_counter() - t0
        return out

    def num_params(self) -> int:
        return sum(int(p.numel()) for p in tree_leaves(self.params))

    def save_checkpoint(self, path: str) -> None:
        """Write ``{"params", "opt"}`` and the step in the reference's
        format (``checkpoint.save``).  Rank 0 writes (this rank's worker
        under a diverging scheduler, as the reference saves worker 0's
        view); the other ranks wait for it."""
        if self.rank == 0:
            checkpoint.save(path, {"params": self.params,
                                   "opt": self.opt_state}, step=self.step)
        if self.world > 1:
            dist.barrier(self.group)

    def load_checkpoint(self, path: str) -> int:
        """Restore a checkpoint written by :meth:`save_checkpoint` (or by
        the reference's) into this session, BEFORE the first step.  The
        payload checksum is verified first (a truncated file raises
        ``ValueError``); a missing leaf or optimizer buffer is refused.
        Leaves keep their stored dtypes.  Sets and returns the restored
        step; the synthetic data is a function of the step, so the resumed
        run replays the batch sequence."""
        if self._built:
            raise RuntimeError("load_checkpoint must run before the first "
                               "step")
        data, manifest = checkpoint.load_tensors(path, self.device)

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

        self.params = tree_at("params", self.params)
        tops = sorted({k.split("/", 2)[1]
                       for k in data if k.startswith("opt/")})
        full = {t: tree_at(f"opt/{t}", self.params) for t in tops}
        moments = {k: v for k, v in full.items() if k != "master"}
        missing = sorted(set(self.opt_state) - set(moments))
        if missing:
            raise ValueError(
                f"checkpoint {path!r} lacks optimizer buffers "
                f"{missing} required by {self.cfg.optimizer!r}")
        self.opt_state = {k: moments[k] for k in self.opt_state}
        self.step = int(manifest.get("step") or 0)
        return self.step

    def summary(self) -> str:
        parts = [f"steps {self.step}", f"comm rounds {self.comm_rounds} "
                 f"(grad {self.grad_rounds}, param {self.param_rounds}"
                 + (f", control probes {self.control_rounds}"
                    if self.control_rounds else "") + ")"]
        parts.append(self.strategy.describe() if self.strategy is not None
                     else "vanilla BSP")
        return "; ".join(parts)
