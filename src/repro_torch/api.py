"""TrainSession — the programmatic training surface of the port
(counterpart of ``repro/api.py``).

    from repro_torch.api import SessionConfig, TrainSession
    from repro_torch.core import SyncConfig, make_strategy

    sess = TrainSession(SessionConfig(arch="gemma-2b", reduced=True,
                                      device="cpu"),
                        strategy=make_strategy(
                            "every_step", sync=SyncConfig(
                                compressor="int8_fused")))
    losses = sess.run(steps=3, log_every=1)

``strategy=None`` is the vanilla BSP step; an every-step strategy runs the
synced step through its reducer.  The session joins (or creates) the
default process group (``launch/dist.py``): a one-process run is a group
of world 1, and each rank of a larger world trains on its rows of the
global batch.  Ported: ``__init__``, ``step_once``, ``run``, ``wall_s``
and ``summary``; planning, checkpoints and the other schedulers wait
(ROADMAP.md queue 1, items 6-7).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs import get_config, reduced
from repro_torch.core import GradientSynchronizer, SyncConfig, SyncStrategy
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.dist import init_group
from repro_torch.launch.steps import _make_synced_train_step, make_train_step
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


class TrainSession:
    """One training run driven by a :class:`SyncStrategy` (or vanilla BSP).

    ``params`` seeds the run with a given parameter tree (tensors, moved to
    the session's device; e.g. ``convert.params_from_jax``), so that both
    packages can start from one tree; otherwise random weights are drawn
    from a ``torch.Generator`` seeded with ``cfg.seed`` on the device.
    ``group`` is the process group (default: the default group, created at
    world 1 if there is none)."""

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
        self.model_cfg = model_cfg
        self.model = Model(model_cfg)
        if group is None:
            init_group(self.device)
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
        self.step_times: List[float] = []
        self.wall_s = float("nan")
        self._built = False

    @property
    def comm_rounds(self) -> int:
        """Collective rounds that actually ran (survey Table 2)."""
        return self.grad_rounds

    @property
    def synchronizer(self):
        return self._engine if self._built and self.strategy else None

    def _build(self) -> None:
        if self._built:
            return
        if self.strategy is None:
            self._base = make_train_step(self.model, self.optimizer,
                                         self.group)
        else:
            if "sync" not in self.strategy.scheduler.computes:
                raise NotImplementedError(
                    f"scheduler {self.strategy.scheduler.name!r} is not "
                    f"ported yet (ROADMAP.md queue 1, item 6)")
            engine = self.strategy.grad_reducer or GradientSynchronizer(
                SyncConfig(), self.group)
            self._sync, self._engine, init_sync_state = \
                _make_synced_train_step(self.model, self.optimizer, engine,
                                        self.group)
            self.sync_state = init_sync_state(self.params)
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
        """Run one training step under the strategy; returns the loss."""
        self._build()
        batch = self.batch(self.step)
        if self.strategy is None:
            loss = self._base(self.params, self.opt_state, batch, self.step)
        else:
            action, _ = self.strategy.scheduler.round(self.step, {})
            if action.compute != "sync":
                raise NotImplementedError(f"action {action.compute!r}")
            # the stochastic compressors draw from a generator per
            # (seed, step), as the reference folds the step into its key
            rng = torch.Generator(self.device).manual_seed(
                self.cfg.seed * 2**32 + self.step)
            self.params, self.opt_state, self.sync_state, loss = self._sync(
                self.params, self.opt_state, self.sync_state, batch,
                self.step, rng)
        self.grad_rounds += 1          # BSP syncs gradients every step
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

    def summary(self) -> str:
        parts = [f"steps {self.step}",
                 f"comm rounds {self.comm_rounds} (grad {self.grad_rounds})",
                 f"world {self.world} on {self.device.type}"]
        parts.append(self.strategy.describe() if self.strategy is not None
                     else "vanilla BSP")
        return "; ".join(parts)
