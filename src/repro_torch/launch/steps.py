"""Train steps of the port — counterparts of ``repro/launch/steps.py``:

  * :func:`make_train_step` — vanilla BSP (loss, backward, update; at a
    world above 1 the gradients are averaged densely);
  * :func:`make_comm_optimized_train_step` / :func:`_make_synced_train_step`
    — per-rank loss and backward, the gradient synchronizer (compression +
    collective over the process group), the update, and the loss averaged
    over the group.

Each rank runs its own process; the reference's manual ``shard_map`` data
axes become the process group.  EF state is per process, as in the
reference (a per-worker leading axis there).  Parameters and optimizer
moments are updated in place.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.core.collectives import allreduce, world_size
from repro_torch.core.grad_sync import (GradientSynchronizer, SyncConfig,
                                        _div)
from repro_torch.models.model import Model
from repro_torch.optim import step_inplace


def loss_and_grads(model: Model, params, batch):
    """(loss, grads): the loss (detached) and its gradient for every leaf of
    ``params``, as a tree of the same shape."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def mean_over_group(x: torch.Tensor,
                    group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """The mean of a per-rank value over the group (the reference's
    ``pmean`` of the loss)."""
    return _div(allreduce(x.clone(), "psum", group), float(world_size(group)))


def make_train_step(model: Model, optimizer,
                    group: Optional[dist.ProcessGroup] = None):
    """Vanilla BSP step: loss, backward, update.  Returns
    ``train_step(params, opt_state, batch, step) -> loss``; params and the
    optimizer state are updated in place."""
    dense = GradientSynchronizer(SyncConfig(), group)

    def train_step(params, opt_state, batch, step):
        loss, grads = loss_and_grads(model, params, batch)
        if world_size(group) > 1:
            grads, _ = dense(grads, {"step": 0})
            loss = mean_over_group(loss, group)
        step_inplace(optimizer, params, grads, opt_state, step)
        return loss

    return train_step


def make_comm_optimized_train_step(model: Model, optimizer, sync: SyncConfig,
                                   group: Optional[dist.ProcessGroup] = None):
    """Per-rank loss/backward; gradient exchange through the
    GradientSynchronizer (compression + collective algorithm)."""
    synchronizer = GradientSynchronizer(sync, group)
    return _make_synced_train_step(model, optimizer, synchronizer, group)


def _make_synced_train_step(model: Model, optimizer, synchronizer,
                            group: Optional[dist.ProcessGroup] = None):
    """The synced step around any grad-sync engine exposing
    ``init_state(grads)`` and ``__call__(grads, state, rng)``.  Returns
    ``(step_fn, synchronizer, init_sync_state)`` with
    ``step_fn(params, opt_state, sync_state, batch, step, rng) ->
    (params, opt_state, sync_state, loss)``."""

    def step_fn(params, opt_state, sync_state, batch, step, rng=None):
        loss, grads = loss_and_grads(model, params, batch)
        grads, sync_state = synchronizer(grads, sync_state, rng)
        step_inplace(optimizer, params, grads, opt_state, step)
        # local losses differ per rank only through data; report the mean
        return params, opt_state, sync_state, mean_over_group(loss, group)

    def init_sync_state(params):
        """Per-process EF state, from the plain parameter tree."""
        return synchronizer.init_state(params)

    return step_fn, synchronizer, init_sync_state
