"""SyncStrategy — the round scheduler × per-round reducer surface of
``repro/core/strategy.py``, ported for its every-step case.

A strategy is a **round scheduler** (how often a communication round
runs) composed with a **per-round reducer** (what a round moves: a
``CommPlan`` run by ``PlanExecutor``, or one ``SyncConfig`` through
``GradientSynchronizer``).  Ported: ``every_step``.  The local-SGD, LAG and
push/pull schedulers wait (ROADMAP.md queue 1, item 6); asking for one
raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, FrozenSet, Optional

from repro_torch.core.grad_sync import (GradientSynchronizer, PlanExecutor,
                                        SyncConfig)
from repro_torch.core.schedule.planner import CommPlan


@dataclasses.dataclass(frozen=True)
class RoundAction:
    """What the trainer runs at one step."""
    compute: str = "sync"        # 'sync' | 'local' | 'reuse'
    param_round: bool = False    # run the parameter-reduce program after


class RoundScheduler:
    """Base round scheduler: WHEN communication happens (survey §3.1).
    ``computes`` is the set of compute actions ``round`` may return."""
    name: str = "base"
    computes: FrozenSet[str] = frozenset({"sync"})

    def round(self, step: int, state: Dict[str, Any],
              probe: Optional[Dict[str, float]] = None):
        raise NotImplementedError

    def describe(self) -> str:
        return self.name


SCHEDULERS: Dict[str, Callable[..., RoundScheduler]] = {}

# schedulers of the JAX package that the port does not have yet
NOT_PORTED = ("local_sgd", "lag", "push_pull")


def register_scheduler(name: str):
    def deco(cls):
        SCHEDULERS[name] = cls
        return cls
    return deco


def get_scheduler(name: str, **kwargs) -> RoundScheduler:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"scheduler {name!r} is not ported yet (ROADMAP.md queue 1, "
            f"item 6: local_sgd.py, lag.py and the other schedulers); "
            f"ported: {sorted(SCHEDULERS)}")
    if name not in SCHEDULERS:
        raise KeyError(
            f"unknown scheduler {name!r}; known: {sorted(SCHEDULERS)}")
    return SCHEDULERS[name](**kwargs)


@register_scheduler("every_step")
class EveryStepScheduler(RoundScheduler):
    """Vanilla BSP cadence: one gradient-sync round per step."""
    name = "every_step"
    computes = frozenset({"sync"})

    def round(self, step, state, probe=None):
        return RoundAction("sync"), state


class SyncStrategy:
    """A round scheduler with its gradient reducer (``None``: dense psum)."""

    def __init__(self, scheduler: RoundScheduler, grad_reducer: Any = None):
        self.scheduler = scheduler
        self.grad_reducer = grad_reducer

    def describe(self) -> str:
        return (f"{self.scheduler.describe()}; grads via "
                f"{_describe_reducer(self.grad_reducer, 'dense psum')}")


def _describe_reducer(reducer, default: str) -> str:
    if reducer is None:
        return default
    if isinstance(reducer, GradientSynchronizer):
        c = reducer.cfg
        return f"{c.algo}/{c.compressor}"
    if isinstance(reducer, PlanExecutor):
        n = reducer.plan.n_buckets
        kinds = sorted({f"{b.algo}/{b.compressor}"
                        for b in reducer.plan.buckets})
        return f"CommPlan[{n} buckets: {', '.join(kinds)}]"
    return type(reducer).__name__


def make_strategy(scheduler="every_step", *, group=None,
                  sync: Optional[SyncConfig] = None,
                  plan: Optional[CommPlan] = None,
                  **scheduler_kwargs) -> SyncStrategy:
    """Resolve the scheduler by registry name and build the gradient
    reducer from either a global ``SyncConfig`` or a ``CommPlan``, over the
    process group ``group`` (the default group when None)."""
    if isinstance(scheduler, str):
        scheduler = get_scheduler(scheduler, **scheduler_kwargs)
    if sync is not None and plan is not None:
        raise ValueError("pass either sync= or plan=, not both")
    grad_reducer = None
    if plan is not None:
        grad_reducer = PlanExecutor(plan, group)
    elif sync is not None:
        grad_reducer = GradientSynchronizer(sync, group)
    return SyncStrategy(scheduler=scheduler, grad_reducer=grad_reducer)
