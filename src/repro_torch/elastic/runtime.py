"""Elastic fault-tolerant step loop (DESIGN.md §15) — the port of
``repro/elastic/runtime.py`` over the port's ``TrainSession``.

:class:`ElasticRuntime` supervises a :class:`~repro_torch.api.TrainSession`
through a replayable :class:`~repro_torch.elastic.faults.FaultSchedule`:

  * **membership changes** (kill / restore) trigger in-process
    resharding — checkpoint the live session through the portable
    leaf-shaped format, release it, build a fresh session on the
    :func:`~repro_torch.elastic.reshard.surviving_topology`, restore, and
    (when planning is on) re-run the planner search on the surviving
    fabric.  No process restart: the loss trajectory continues from the
    exact saved step, and the synthetic data pipeline replays the exact
    batch sequence because batches are a pure function of the step index.
  * **slowdowns** feed a straggler watch: when the worst worker's modeled
    step time exceeds the median by ``straggler_factor`` for
    ``straggler_patience`` consecutive steps, the runtime DEMOTES the
    global round cadence instead of letting the bus stall — first via the
    installed scheduler's ``backpressure`` hook (stretch τ / the LAG
    threshold / push-pull cadences), escalating to a straggler-priced
    re-plan (``TrainSession.replan_now``) when the scheduler has no
    cadence to stretch.

As in the reference, the surviving world is a planning model: the
session's process group (world 1, or the ranks of ``--data-parallel``)
stays the same across generations, and every rank runs the runtime.  Its
decisions are pure functions of the trace, so all ranks decide alike;
``save_checkpoint`` has rank 0 write while the others wait, and every
rank reads the file back.

Unlike the reference, the old session is released (parameters, moments,
EF residuals, the caching allocator's blocks) before the factory builds
the next one: on one card at full width two generations of the training
state and the restored copy do not fit.  That changes no event, counter
or loss.

Step execution goes through an injectable executor so fault traces are
replayable without wall clocks: the default :class:`SimulatedExecutor`
runs the REAL training step (losses are genuine) but models per-worker
times from the schedule's slow factors — the same trace always produces
the same trajectory AND the same recovery decisions.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import os
from typing import Any, Callable, Dict, List, Optional, Set

import torch

from repro_torch.core.schedule.topology import Topology
from repro_torch.elastic.faults import FaultSchedule
from repro_torch.elastic.reshard import surviving_topology


@dataclasses.dataclass(frozen=True)
class StepOutcome:
    """One executed step: the (real) loss plus modeled per-worker wall
    times — the straggler watch's input."""
    loss: float
    worker_times_s: Dict[int, float]


class SimulatedExecutor:
    """Default step executor: real ``step_once`` loss, modeled per-worker
    times (``base_step_s`` scaled by each worker's slow factor).  Pure in
    the trace — no wall clocks — so elastic runs replay bit-for-bit."""

    def __init__(self, base_step_s: float = 0.1):
        self.base_step_s = float(base_step_s)

    def __call__(self, session, step: int, alive: Set[int],
                 slow: Dict[int, float]) -> StepOutcome:
        loss = session.step_once()
        times = {w: self.base_step_s * float(slow.get(w, 1.0))
                 for w in sorted(alive)}
        return StepOutcome(loss=loss, worker_times_s=times)


@dataclasses.dataclass(frozen=True)
class ReshardEvent:
    """One runtime decision, for the report table and the bench suite."""
    step: int
    kind: str                 # "reshard" | "backpressure" | "replan"
    old_world: int
    new_world: int
    topology: str             # surviving Topology spec
    plan_key: str = ""        # installed plan after the event ("" = none)
    note: str = ""


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """Runtime knobs.  ``topology`` is the LAUNCH fabric (spec string,
    preset name, or Topology); its world must equal the fault schedule's.
    ``plan`` re-runs ``plan_auto`` on every reshard so the installed
    strategy always matches the surviving fabric; ``t_backward_s`` pins
    the backward profile those searches use (wall-clock-free replays).
    ``continuity_max_jump`` bounds the allowed loss jump across a reshard
    — resharding through the portable checkpoint is bit-exact, so any
    jump beyond numerical noise is a restore bug and fails loudly."""
    topology: Any
    checkpoint_dir: str
    plan: bool = False
    link: Any = "fast_ici"
    t_backward_s: Optional[float] = 0.05
    plan_kwargs: Optional[Dict[str, Any]] = None
    straggler_factor: float = 2.0
    straggler_patience: int = 2
    backpressure_factor: float = 2.0
    base_step_s: float = 0.1
    continuity_max_jump: float = 1.0


class ElasticRuntime:
    """Supervised elastic step loop over fresh ``TrainSession`` builds.

    ``session_factory`` returns a FRESH, un-built session (same seed and
    config every call — determinism is the factory's contract); the
    runtime applies the surviving topology, restores the checkpoint, and
    re-plans.  Round counters (``grad_rounds`` etc.) aggregate across
    every session generation, so the honest-accounting contract survives
    resharding."""

    def __init__(self, session_factory: Callable[[], Any],
                 schedule: FaultSchedule, cfg: ElasticConfig,
                 executor: Optional[Callable[..., StepOutcome]] = None):
        self.factory = session_factory
        self.schedule = schedule
        self.cfg = cfg
        self.executor = executor or SimulatedExecutor(cfg.base_step_s)
        self.topology: Topology = (
            Topology.from_spec(cfg.topology)
            if isinstance(cfg.topology, str) else cfg.topology)
        if self.topology.world != schedule.world:
            raise ValueError(
                f"fault schedule is against world={schedule.world} but the "
                f"topology {self.topology.spec()!r} has world="
                f"{self.topology.world}")
        self.alive: Set[int] = set(range(schedule.world))
        self.slow: Dict[int, float] = {}
        self.losses: List[float] = []
        self.events: List[ReshardEvent] = []
        self._retired = {"grad_rounds": 0, "param_rounds": 0,
                         "control_rounds": 0}
        self._streak = 0
        self._acted_on: Optional[frozenset] = None
        self.session = self._spawn(self.topology, restore_from=None)

    # -- aggregated counters -------------------------------------------------

    @property
    def grad_rounds(self) -> int:
        return self._retired["grad_rounds"] + self.session.grad_rounds

    @property
    def param_rounds(self) -> int:
        return self._retired["param_rounds"] + self.session.param_rounds

    @property
    def control_rounds(self) -> int:
        return self._retired["control_rounds"] + self.session.control_rounds

    @property
    def comm_rounds(self) -> int:
        return self.grad_rounds + self.param_rounds

    @property
    def plan_key(self) -> str:
        p = self.session.planned
        return p["strategy_plan"].key if p else ""

    # -- session lifecycle ---------------------------------------------------

    def _spawn(self, topo: Topology, restore_from: Optional[str]):
        s = self.factory()
        s.apply_topology(topo)
        if restore_from is not None:
            s.load_checkpoint(restore_from)
        if self.cfg.plan:
            s.plan_auto(self.cfg.link, t_backward_s=self.cfg.t_backward_s,
                        **(self.cfg.plan_kwargs or {}))
        return s

    def _release(self) -> None:
        """Drop the live session and everything it holds (parameters,
        moments, EF residuals, built steps), then hand the card's cached
        blocks back, so the next generation is built on a free card."""
        on_card = self.session.device.type == "cuda"
        self.session = None
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    def _ckpt_path(self) -> str:
        os.makedirs(self.cfg.checkpoint_dir, exist_ok=True)
        return os.path.join(self.cfg.checkpoint_dir, "elastic")

    def _reshard(self, step: int) -> None:
        old_world = self.session.world if self.session.topology is None \
            else self.session.topology.world
        dead = set(range(self.schedule.world)) - self.alive
        new_topo = surviving_topology(self.topology, dead)
        path = self._ckpt_path()
        self.session.save_checkpoint(path)
        for k in self._retired:
            self._retired[k] += getattr(self.session, k)
        self._release()
        self.session = self._spawn(new_topo, restore_from=path)
        self.events.append(ReshardEvent(
            step=step, kind="reshard", old_world=old_world,
            new_world=new_topo.world, topology=new_topo.spec(),
            plan_key=self.plan_key,
            note=f"dead={sorted(dead)}" if dead else "fleet restored"))
        self._streak = 0
        self._acted_on = None

    # -- straggler watch -----------------------------------------------------

    def _watch_stragglers(self, out: StepOutcome, step: int) -> None:
        times = sorted(out.worker_times_s.values())
        if len(times) < 2:
            self._streak = 0
            return
        med = times[len(times) // 2]
        worst = times[-1]
        if med <= 0.0 or worst < self.cfg.straggler_factor * med:
            self._streak = 0
            return
        self._streak += 1
        episode = frozenset(self.slow.items())
        if self._streak < self.cfg.straggler_patience \
                or episode == self._acted_on:
            return
        self._acted_on = episode
        self._streak = 0
        skew_s = worst - med
        old_world = self.topology.world - \
            (self.schedule.world - len(self.alive))
        sess = self.session
        sched = sess.strategy.scheduler if sess.strategy is not None \
            else None
        if sched is not None and sched.supports_backpressure \
                and sched.backpressure(self.cfg.backpressure_factor):
            self.events.append(ReshardEvent(
                step=step, kind="backpressure", old_world=old_world,
                new_world=old_world, topology="", plan_key=self.plan_key,
                note=f"{sched.name} cadence /"
                     f"{self.cfg.backpressure_factor:g} "
                     f"(skew {skew_s * 1e3:.0f} ms)"))
            return
        if sess.planned is not None:
            ev = sess.replan_now(straggler_s=skew_s,
                                 t_backward_s=self.cfg.t_backward_s)
            self.events.append(ReshardEvent(
                step=step, kind="replan", old_world=old_world,
                new_world=old_world, topology="",
                plan_key=ev["new_key"],
                note=("installed" if ev["applied"] else ev["note"])
                + f" (skew {skew_s * 1e3:.0f} ms)"))
            return
        self.events.append(ReshardEvent(
            step=step, kind="backpressure", old_world=old_world,
            new_world=old_world, topology="", plan_key=self.plan_key,
            note=f"no cadence lever (skew {skew_s * 1e3:.0f} ms); "
                 f"straggler tolerated"))

    # -- the supervised loop -------------------------------------------------

    def run(self, steps: int) -> List[float]:
        """Drive the session to ``steps`` total steps under the fault
        schedule; returns every loss executed by THIS call."""
        out: List[float] = []
        while self.session.step < steps:
            step = self.session.step
            changed = False
            for e in self.schedule.events_at(step):
                if e.kind == "kill":
                    self.alive.discard(e.worker)
                    self.slow.pop(e.worker, None)
                    changed = True
                elif e.kind == "restore":
                    self.alive.add(e.worker)
                    changed = True
                else:                                  # slow
                    self.slow[e.worker] = e.factor
            if changed:
                self._reshard(step)
            prev = self.losses[-1] if self.losses else None
            o = self.executor(self.session, step, self.alive, self.slow)
            loss = float(o.loss)
            if not math.isfinite(loss):
                raise RuntimeError(
                    f"loss diverged to {loss} at step {step} "
                    f"(world {len(self.alive)})")
            if changed and prev is not None \
                    and abs(loss - prev) > self.cfg.continuity_max_jump:
                raise RuntimeError(
                    f"loss discontinuity across reshard at step {step}: "
                    f"{prev:.4f} -> {loss:.4f} (max allowed jump "
                    f"{self.cfg.continuity_max_jump}) — restore bug")
            self.losses.append(loss)
            out.append(loss)
            self._watch_stragglers(o, step)
        return out
