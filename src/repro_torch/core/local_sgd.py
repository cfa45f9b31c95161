"""Periodic communication (survey §3.1.2): local SGD / model averaging —
the port of ``repro/core/local_sgd.py``.

Workers run ``tau`` purely local optimizer steps, then average model
parameters over the process group (K-AVG / PR-SGD / local SGD; tau = 1 is
vanilla parallel SGD, tau = T one-shot averaging).  ``post_local`` delays
the first local phase (Stich's post-local SGD: synchronize every step
during warmup).  The session alternates the local step and the
parameter round; the number of communication rounds is T/tau, the
quantity of the survey's Table 2.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch._tree import tree_map
from repro_torch.core.collectives import allreduce, world_size
from repro_torch.core.collectives.api import Axes
from repro_torch.core.grad_sync import _div


@dataclasses.dataclass(frozen=True)
class LocalSGDConfig:
    period: int = 1          # tau; 1 = vanilla parallel SGD
    post_local_after: int = 0  # sync every step for the first N steps
    algo: str = "psum"


@dataclasses.dataclass(frozen=True)
class AsymmetricPushPullConfig:
    """Dean et al. 2012 (survey §3.1.2): workers PUSH gradients every
    ``n_push`` steps and FETCH parameters every ``n_fetch`` steps, decoupling
    the two directions of worker-server traffic."""
    n_push: int = 1
    n_fetch: int = 1

    def __post_init__(self):
        if self.n_push < 1 or self.n_fetch < 1:
            raise ValueError(f"push/fetch cadences must be >= 1, got "
                             f"n_push={self.n_push} n_fetch={self.n_fetch}")

    def should_push(self, step: int) -> bool:
        return (step + 1) % self.n_push == 0

    def should_fetch(self, step: int) -> bool:
        return (step + 1) % self.n_fetch == 0

    def rounds(self, total_steps: int) -> dict:
        return {"push": sum(self.should_push(t) for t in range(total_steps)),
                "fetch": sum(self.should_fetch(t) for t in range(total_steps))}


def average_leaf(p: torch.Tensor, group: Axes = None,
                 algo: str = "psum") -> torch.Tensor:
    """One leaf's model average: an f32 all-reduce over ``group``, one IEEE
    division by the world size, cast back to the leaf's dtype."""
    total = allreduce(p.to(torch.float32, copy=True), algo, group)
    return _div(total, float(world_size(group))).to(p.dtype)


def average_params(params, group: Axes = None, algo: str = "psum"):
    """The model-averaging collective over the process group(s)
    ``group`` (the default group when None), leaf by leaf."""
    return tree_map(lambda p: average_leaf(p, group, algo), params)


def should_sync(step: int, cfg: LocalSGDConfig) -> bool:
    """The schedule's host-side decision (the session alternates steps)."""
    if step < cfg.post_local_after:
        return True
    return (step + 1) % cfg.period == 0


def communication_rounds(total_steps: int, cfg: LocalSGDConfig) -> int:
    return sum(1 for t in range(total_steps) if should_sync(t, cfg))
