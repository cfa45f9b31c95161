"""SyncStrategy — the round scheduler × per-round reducer surface of
``repro/core/strategy.py`` (survey §3.1 rounds × §3.2-3.3 bits).

A strategy is a **round scheduler** (how often a communication round
runs: every step, local-SGD τ, LAG's lazy trigger, Dean-style asymmetric
push/pull) composed with **per-round reducers** (what a round moves: a
``CommPlan`` run by ``PlanExecutor``, one ``SyncConfig`` through
``GradientSynchronizer``, or plain parameter averaging).  Periodic
averaging *of compressed syncs* is the composition of the two.

Schedulers carry their own state through ``init_state`` / ``round`` /
``commit`` and live in a registry:

    sched = get_scheduler("local_sgd", period=8)
    action, state = sched.round(step, state)        # host-side dispatch
    state = sched.commit(state, action, synced)     # after the round ran

``round`` returns a :class:`RoundAction` naming the step the session runs
(``sync`` — gradient-reducing step, ``local`` — purely local step with NO
gradient collective, ``reuse`` — LAG's apply of the last synchronized
gradient) and whether a parameter round follows.  Every scheduler of the
reference is here.  The parallelism axis is a ``ParallelismSpec``: its
tensor and expert axes are carried as record axes (the planner prices
them; the session runs their DP edge, as the reference's does; the
model-level wire is ``layers.mlp_tp`` and ``moe_ffn(ep_axis=...)``),
``shard`` runs sharded data parallelism
(partitioned f32 master and moments, the session's sharded step), and
``pp`` / ``micro`` the 1F1B pipeline (the session's pipeline step;
``micro`` alone is micro-batched accumulation).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, FrozenSet, Optional

from repro_torch.core.grad_sync import (GradientSynchronizer, PlanExecutor,
                                        SyncConfig)
from repro_torch.core.lag import LAGConfig, init_lag_state, lag_update_state
from repro_torch.core.local_sgd import (AsymmetricPushPullConfig,
                                        LocalSGDConfig, should_sync)
from repro_torch.core.parallelism import ParallelismSpec
from repro_torch.core.schedule.planner import CommPlan


@dataclasses.dataclass(frozen=True)
class RoundAction:
    """What the trainer runs at one step."""
    compute: str = "sync"        # 'sync' | 'local' | 'reuse'
    param_round: bool = False    # run the parameter-reduce program after


class RoundScheduler:
    """Base round scheduler: WHEN communication happens (survey §3.1).

    Class attributes tell the session what to build:

      * ``computes`` — the set of compute actions ``round`` may return
      * ``has_param_rounds`` — ever requests a parameter-averaging round
      * ``needs_grad_probe`` — ``round`` needs this step's gradient norms
        (LAG: ``probe={'delta': .., 'scale': ..}``)
      * ``diverges_params`` — local phases let each worker's parameters
        drift between rounds (each rank keeps its own)
      * ``supports_backpressure`` — the scheduler has a cadence lever a
        straggler signal can demote (:meth:`backpressure`)
    """
    name: str = "base"
    computes: FrozenSet[str] = frozenset({"sync"})
    has_param_rounds: bool = False
    needs_grad_probe: bool = False
    diverges_params: bool = False
    supports_backpressure: bool = False

    def init_state(self, params) -> Dict[str, Any]:
        return {}

    def backpressure(self, factor: float = 2.0) -> bool:
        """Demote the round cadence in response to a straggler signal;
        True when it changed (the base scheduler has no lever)."""
        return False

    def round(self, step: int, state: Dict[str, Any],
              probe: Optional[Dict[str, float]] = None):
        raise NotImplementedError

    def commit(self, state: Dict[str, Any], action: RoundAction,
               synced_grads=None) -> Dict[str, Any]:
        """Called after the dispatched step ran (LAG records the newly
        synchronized gradient here)."""
        return state

    def describe(self) -> str:
        return self.name


SCHEDULERS: Dict[str, Callable[..., RoundScheduler]] = {}


def register_scheduler(name: str):
    def deco(cls):
        SCHEDULERS[name] = cls
        return cls
    return deco


def get_scheduler(name: str, **kwargs) -> RoundScheduler:
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


@register_scheduler("local_sgd")
class LocalSGDScheduler(RoundScheduler):
    """Periodic averaging (survey §3.1.2): τ purely local optimizer steps,
    then one parameter round; ``post_local_after`` runs a parameter round
    after EVERY step during warmup.  Optimizer moments stay local
    throughout (local Adam).  Rounds = T/τ, the survey's Table 2."""
    name = "local_sgd"
    computes = frozenset({"local"})
    has_param_rounds = True
    diverges_params = True
    supports_backpressure = True

    def __init__(self, period: int = 4, post_local_after: int = 0,
                 cfg: Optional[LocalSGDConfig] = None):
        self.cfg = cfg or LocalSGDConfig(period=period,
                                         post_local_after=post_local_after)
        if self.cfg.period < 1:
            raise ValueError(f"local SGD period must be >= 1, "
                             f"got {self.cfg.period}")

    def round(self, step, state, probe=None):
        return RoundAction("local",
                           param_round=should_sync(step, self.cfg)), state

    def backpressure(self, factor: float = 2.0) -> bool:
        # host-side dispatch only: rounds get rarer from the next step on
        new = max(int(round(self.cfg.period * factor)), self.cfg.period + 1)
        self.cfg = dataclasses.replace(self.cfg, period=new)
        return True

    def describe(self):
        return (f"local_sgd τ={self.cfg.period}"
                + (f" post_local={self.cfg.post_local_after}"
                   if self.cfg.post_local_after else ""))


@register_scheduler("lag")
class LAGScheduler(RoundScheduler):
    """Lazily aggregated gradients (survey §3.1.2, Chen et al. 2018):
    communicate only when the gradient changed enough,

        sync  iff  ||g_t - g_last||² > threshold · ||g_t||²,

    otherwise reuse the last synchronized gradient.  The session's probe
    sums the two scalars over the group — the only wire traffic of a
    skipped round.  State: ``{'g_last': tree, 'rounds': int}``."""
    name = "lag"
    computes = frozenset({"sync", "reuse"})
    needs_grad_probe = True
    supports_backpressure = True

    def __init__(self, threshold: float = 0.1,
                 cfg: Optional[LAGConfig] = None):
        self.cfg = cfg or LAGConfig(threshold=threshold)
        if self.cfg.check_every != 1:
            # the probe is the backward (grads are needed every step), so a
            # trigger cadence would skip only two scalar sums while changing
            # the sync pattern: refuse it rather than ignore it
            raise ValueError("check_every != 1 is not supported by this "
                             "executor: the trigger rides the per-step "
                             "backward probe")

    def init_state(self, params):
        return init_lag_state(params)

    def round(self, step, state, probe=None):
        if probe is None:
            raise ValueError("LAG needs a gradient probe "
                             "({'delta': .., 'scale': ..})")
        # the first round syncs unconditionally: g_last is still zero, so
        # delta == scale and a threshold >= 1 would reuse zeros forever
        trigger = (int(state["rounds"]) == 0
                   or probe["delta"] > self.cfg.threshold * probe["scale"])
        return RoundAction("sync" if trigger else "reuse"), state

    def commit(self, state, action, synced_grads=None):
        if action.compute == "sync":
            return lag_update_state(state, synced_grads, True)
        return state

    def backpressure(self, factor: float = 2.0) -> bool:
        # a larger threshold makes the trigger lazier: more reuse rounds
        self.cfg = dataclasses.replace(
            self.cfg, threshold=self.cfg.threshold * max(factor, 1.0))
        return True

    def describe(self):
        return f"lag θ={self.cfg.threshold}"


@register_scheduler("push_pull")
class PushPullScheduler(RoundScheduler):
    """Dean et al. 2012 asymmetric push/pull (survey §3.1.2): gradients are
    pushed (synced) every ``n_push`` steps, parameters fetched (averaged)
    every ``n_fetch`` steps.  Steps that push nothing run locally."""
    name = "push_pull"
    computes = frozenset({"sync", "local"})
    has_param_rounds = True
    diverges_params = True
    supports_backpressure = True

    def __init__(self, n_push: int = 1, n_fetch: int = 1,
                 cfg: Optional[AsymmetricPushPullConfig] = None):
        self.cfg = cfg or AsymmetricPushPullConfig(n_push=n_push,
                                                   n_fetch=n_fetch)

    def backpressure(self, factor: float = 2.0) -> bool:
        c = self.cfg
        self.cfg = AsymmetricPushPullConfig(
            n_push=max(int(round(c.n_push * factor)), c.n_push + 1),
            n_fetch=max(int(round(c.n_fetch * factor)), c.n_fetch + 1))
        return True

    def round(self, step, state, probe=None):
        compute = "sync" if self.cfg.should_push(step) else "local"
        return RoundAction(compute,
                           param_round=self.cfg.should_fetch(step)), state

    def describe(self):
        return f"push_pull push={self.cfg.n_push} fetch={self.cfg.n_fetch}"


class SyncStrategy:
    """scheduler × reducers × parallelism.  Reducers are engines with the
    ``init_state(tree)`` / ``__call__(tree, state, rng)`` interface
    (``PlanExecutor``, ``GradientSynchronizer``):

      * ``grad_reducer`` — runs inside 'sync' rounds on the gradients
        (None -> dense psum)
      * ``param_reducer`` — runs inside parameter rounds on the
        params-minus-anchor delta (None -> dense ``average_params`` on
        ``param_algo``); compressing the delta, not the raw parameters,
        keeps error feedback and sparsification sound

    ``parallelism`` (a :class:`ParallelismSpec`, a spec string, or None =
    pure replicated DP) names how the world is factored.  Its ``tp`` /
    ``ep`` axes are record axes: the gradient reducer runs the DP edge the
    planner priced for them.  ``shard`` partitions the optimizer state
    (the session builds the sharded step); it needs an every-step
    gradient-sync scheduler.  ``pp > 1`` or ``micro > 1`` makes the
    session build the 1F1B pipeline step (``pp = 1, micro > 1``: plain
    micro-batched accumulation); it composes with every-step replicated
    DP only — the spec refuses ``pp`` with ``shard``, and the session's
    build refuses another scheduler, as the reference's does."""

    def __init__(self, scheduler: RoundScheduler, grad_reducer: Any = None,
                 param_reducer: Any = None, param_algo: str = "psum",
                 parallelism=None):
        spec = ParallelismSpec.coerce(parallelism)
        if spec.shard_state:
            check_shardable(scheduler)
        self.scheduler = scheduler
        self.grad_reducer = grad_reducer
        self.param_reducer = param_reducer
        self.param_algo = param_algo
        self.parallelism = spec

    @property
    def shard_state(self) -> bool:
        return self.parallelism.shard_state

    @property
    def pipeline_stages(self) -> int:
        return int(self.parallelism.pp)

    @property
    def micro_batches(self) -> int:
        return max(int(self.parallelism.micro_batches), 1)

    def describe(self) -> str:
        p = self.parallelism
        if self.pipeline_stages > 1:
            mode = (f" [pipeline S={self.pipeline_stages} "
                    f"M={self.micro_batches}]")
        elif self.micro_batches > 1:
            mode = f" [micro-batches M={self.micro_batches}]"
        else:
            mode = ""
        if p.tp > 1:
            mode += f" [tp={p.tp}" + (f"@{p.tp_tier}" if p.tp_tier else "") \
                + "]"
        if p.ep > 1:
            mode += f" [ep={p.ep}" + (f"@{p.ep_tier}" if p.ep_tier else "") \
                + "]"
        parts = [self.scheduler.describe()
                 + (" [shard_state 1/p]" if p.shard_state else "") + mode]
        if "sync" in self.scheduler.computes:
            parts.append("grads via "
                         + _describe_reducer(self.grad_reducer, "dense psum"))
        if self.scheduler.has_param_rounds:
            parts.append("param rounds via "
                         + _describe_reducer(self.param_reducer,
                                             f"dense {self.param_algo} avg"))
        return "; ".join(parts)


def check_shardable(scheduler: RoundScheduler) -> None:
    """Sharded optimizer state needs every step to sync gradients: raise
    ``ValueError`` for a scheduler with local phases, parameter rounds or
    gradient reuse (the reference's refusal, its message)."""
    if (scheduler.computes != frozenset({"sync"})
            or scheduler.has_param_rounds or scheduler.needs_grad_probe
            or scheduler.diverges_params):
        raise ValueError(
            f"shard_state requires an every-step gradient-sync "
            f"scheduler, got {scheduler.name!r}: local phases (local_sgd/"
            f"push_pull) and gradient reuse (lag) need full per-worker "
            f"optimizer state by construction")


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
                  param_plan: Optional[CommPlan] = None,
                  param_algo: str = "psum", parallelism=None,
                  **scheduler_kwargs) -> SyncStrategy:
    """Resolve the scheduler by registry name and build the reducers from
    either a global ``SyncConfig`` or a ``CommPlan``, over the process
    group ``group`` (the default group when None).  For a scheduler with
    parameter rounds, ``param_plan`` feeds the round's reducer; a pure
    parameter-round scheduler (local SGD) takes ``sync=`` / ``plan=`` as
    its round's reducer instead of a per-step gradient sync."""
    if isinstance(scheduler, str):
        scheduler = get_scheduler(scheduler, **scheduler_kwargs)
    if sync is not None and plan is not None:
        raise ValueError("pass either sync= or plan=, not both")
    grad_reducer = param_reducer = None
    if plan is not None:
        grad_reducer = PlanExecutor(plan, group)
    elif sync is not None:
        grad_reducer = GradientSynchronizer(sync, group)
    if scheduler.has_param_rounds:
        if param_plan is not None:
            param_reducer = PlanExecutor(param_plan, group)
        elif "sync" not in scheduler.computes:
            param_reducer, grad_reducer = grad_reducer, None
    return SyncStrategy(scheduler=scheduler, grad_reducer=grad_reducer,
                        param_reducer=param_reducer, param_algo=param_algo,
                        parallelism=parallelism)
