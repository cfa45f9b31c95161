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

The session joins (or creates) the default process group
(``launch/dist.py``): a one-process run is a group of world 1, and each
rank of a larger world trains on its rows of the global batch.  One
process is one worker: under a scheduler whose workers diverge (local
SGD, push/pull) each rank's ``params`` and ``opt_state`` are its own
worker's (the reference carries them on a leading device axis and shows
worker 0's).  ``save_checkpoint`` / ``load_checkpoint`` write and read
the reference's checkpoint format.  Planning and the sharded, pipeline
and elastic modes wait (ROADMAP.md queue 1, items 7-9 and 12).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import checkpoint
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.checkpoint.checkpoint import _flatten_with_paths
from repro_torch.configs import get_config, reduced
from repro_torch.core import GradientSynchronizer, SyncConfig, SyncStrategy
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.dist import init_group
from repro_torch.launch.steps import (_make_synced_train_step,
                                      make_lag_programs,
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
