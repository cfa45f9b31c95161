"""Deterministic fault injection for the elastic runtime (DESIGN.md §15);
a copy of ``repro/elastic/faults.py``, held to it by
``tests/test_torch_elastic.py``.

Preemption in real fleets is a stochastic external event; reproducing a
recovery bug requires replaying the *exact* fault sequence.  A
:class:`FaultSchedule` pins that sequence up front — every kill, slowdown
and restore carries the step index it fires at — so an elastic run is a
pure function of (model seed, data seed, fault schedule).  The schedule is
serializable both ways (compact spec strings for CLI flags, JSON for
committed trace files) and the seeded :meth:`FaultSchedule.random`
constructor makes fuzzing replayable: the trace that found a bug IS the
regression test.

Fault kinds:

  * ``kill``    — worker leaves the fleet at the start of the step
                  (preemption / hardware loss).  Triggers resharding.
  * ``restore`` — a previously-killed worker (or a fresh replacement at
                  the same rank) rejoins.  Triggers resharding.
  * ``slow``    — worker stays in the fleet but runs ``factor``× slower
                  (thermal throttle, noisy neighbour).  Does NOT trigger
                  resharding — it feeds the straggler watch instead.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Sequence, Tuple, Union

import numpy as np

VALID_KINDS = ("kill", "slow", "restore")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One fault, firing at the START of ``step`` against rank ``worker``.

    ``factor`` is only meaningful for ``slow`` (wall-clock multiplier for
    that worker's step time, > 1) — and for ``restore``, where it is
    ignored and a restored worker runs at nominal speed again.
    """
    step: int
    worker: int
    kind: str
    factor: float = 1.0

    def __post_init__(self):
        if self.kind not in VALID_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected "
                             f"one of {VALID_KINDS}")
        if self.step < 0 or self.worker < 0:
            raise ValueError(f"step and worker must be >= 0, got "
                             f"step={self.step} worker={self.worker}")
        if self.kind == "slow" and not self.factor > 1.0:
            raise ValueError(f"slow factor must be > 1, got {self.factor}")

    def describe(self) -> str:
        """Compact spec form: ``kill:3@5`` / ``slow:1x4@3`` /
        ``restore:3@9`` (kind:worker[xfactor]@step)."""
        fac = (f"x{self.factor:g}" if self.kind == "slow" else "")
        return f"{self.kind}:{self.worker}{fac}@{self.step}"


def _parse_event(tok: str) -> FaultEvent:
    try:
        kind, rest = tok.split(":", 1)
        body, step = rest.rsplit("@", 1)
        factor = 1.0
        if "x" in body:
            w, f = body.split("x", 1)
            factor = float(f)
        else:
            w = body
        return FaultEvent(step=int(step), worker=int(w), kind=kind.strip(),
                          factor=factor)
    except ValueError as e:
        if "fault kind" in str(e) or "factor" in str(e) or ">= 0" in str(e):
            raise
        raise ValueError(
            f"cannot parse fault spec {tok!r}: expected "
            f"kind:worker[xfactor]@step, e.g. kill:3@5 or slow:1x4@3") \
            from e


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """An ordered, validated sequence of :class:`FaultEvent` against a
    fleet of ``world`` workers (ranks 0..world-1).

    Validation replays liveness: kills must target live workers, restores
    dead ones, slowdowns live ones, and at least one worker must survive
    every prefix of the schedule — an impossible trace fails at
    construction, not 40 steps into a run.
    """
    events: Tuple[FaultEvent, ...]
    world: int

    def __post_init__(self):
        if self.world < 1:
            raise ValueError(f"world must be >= 1, got {self.world}")
        ordered = tuple(sorted(self.events,
                               key=lambda e: (e.step, e.worker)))
        object.__setattr__(self, "events", ordered)
        alive = set(range(self.world))
        for e in ordered:
            if e.worker >= self.world:
                raise ValueError(f"{e.describe()}: worker {e.worker} out "
                                 f"of range for world={self.world}")
            if e.kind == "kill":
                if e.worker not in alive:
                    raise ValueError(f"{e.describe()}: worker already dead")
                alive.discard(e.worker)
                if not alive:
                    raise ValueError(f"{e.describe()}: schedule leaves no "
                                     f"survivors")
            elif e.kind == "restore":
                if e.worker in alive:
                    raise ValueError(f"{e.describe()}: worker is not dead")
                alive.add(e.worker)
            else:                                      # slow
                if e.worker not in alive:
                    raise ValueError(f"{e.describe()}: cannot slow a dead "
                                     f"worker")

    # -- queries -------------------------------------------------------------

    def events_at(self, step: int) -> List[FaultEvent]:
        return [e for e in self.events if e.step == step]

    @property
    def last_step(self) -> int:
        return max((e.step for e in self.events), default=-1)

    # -- (de)serialization ---------------------------------------------------

    def spec(self) -> str:
        """Round-trippable compact form, ``,``-joined event specs."""
        return ",".join(e.describe() for e in self.events)

    @classmethod
    def from_spec(cls, spec: str, world: int) -> "FaultSchedule":
        toks = [t.strip() for t in spec.split(",") if t.strip()]
        return cls(events=tuple(_parse_event(t) for t in toks), world=world)

    def to_json(self) -> Dict[str, Any]:
        return {"world": self.world,
                "events": [dataclasses.asdict(e) for e in self.events]}

    @classmethod
    def from_json(cls, src: Union[str, Dict[str, Any]]) -> "FaultSchedule":
        """Build from a dict or a path to a JSON trace file."""
        if isinstance(src, str):
            with open(src) as f:
                src = json.load(f)
        return cls(events=tuple(FaultEvent(**e) for e in src["events"]),
                   world=int(src["world"]))

    # -- seeded fuzzing ------------------------------------------------------

    @classmethod
    def random(cls, world: int, steps: int, n_faults: int,
               seed: int = 0) -> "FaultSchedule":
        """A replayable random schedule: kills, matched restores two-plus
        steps later when room remains, occasional slowdowns.  Same seed →
        same trace, so a fuzzed failure is immediately a regression test."""
        rng = np.random.default_rng(seed)
        alive = set(range(world))
        events: List[FaultEvent] = []
        for _ in range(n_faults):
            step = int(rng.integers(1, max(steps - 1, 2)))
            roll = rng.random()
            if roll < 0.5 and len(alive) > 1:
                w = int(rng.choice(sorted(alive)))
                events.append(FaultEvent(step=step, worker=w, kind="kill"))
                alive.discard(w)
                back = step + 2 + int(rng.integers(0, 3))
                if back < steps:
                    events.append(FaultEvent(step=back, worker=w,
                                             kind="restore"))
                    alive.add(w)
            elif alive:
                w = int(rng.choice(sorted(alive)))
                events.append(FaultEvent(
                    step=step, worker=w, kind="slow",
                    factor=float(2 + 2 * rng.random())))
        # replay-order sanity: drop events invalidated by reordering
        ordered, live = [], set(range(world))
        for e in sorted(events, key=lambda e: (e.step, e.worker)):
            if e.kind == "kill" and e.worker in live and len(live) > 1:
                ordered.append(e)
                live.discard(e.worker)
            elif e.kind == "restore" and e.worker not in live:
                ordered.append(e)
                live.add(e.worker)
            elif e.kind == "slow" and e.worker in live:
                ordered.append(e)
        return cls(events=tuple(ordered), world=world)


def replay_world_sizes(schedule: FaultSchedule,
                       steps: int) -> Tuple[List[int], List[int]]:
    """Pure host-side replay: per-step fleet size over ``steps`` steps and
    the list of steps whose membership CHANGED (reshard points).  Used by
    the bench suite to pin recovery counts without running a model."""
    alive = set(range(schedule.world))
    sizes, changes = [], []
    for s in range(steps):
        before = len(alive)
        for e in schedule.events_at(s):
            if e.kind == "kill":
                alive.discard(e.worker)
            elif e.kind == "restore":
                alive.add(e.worker)
        if len(alive) != before:
            changes.append(s)
        sizes.append(len(alive))
    return sizes, changes
