"""Train steps of the port — counterparts of ``repro/launch/steps.py``:

  * :func:`make_train_step` — vanilla BSP (loss, backward, update; at a
    world above 1 the gradients are averaged densely);
  * :func:`make_comm_optimized_train_step` / :func:`_make_synced_train_step`
    — per-rank loss and backward, the gradient synchronizer (compression +
    collective over the process group), the update, and the loss averaged
    over the group;
  * the strategy phase steps: :func:`make_local_train_step` (no gradient
    collective), :func:`make_param_round_step` (model averaging, or the
    params-minus-anchor delta through a compressing reducer) and
    :func:`make_lag_programs` (LAG's probe, sync and reuse);
  * :func:`make_sharded_train_step` — sharded data parallelism: the
    reduce-scatter edge, the update on this rank's rows of the f32 master
    and moments, and the all-gather back into the parameters.

Each rank runs its own process; the reference's manual ``shard_map`` data
axes become the process group.  EF state is per process, as in the
reference (a per-worker leading axis there), and so are the parameters
and optimizer state under a scheduler whose workers diverge (local SGD,
push/pull): the reference's ``broadcast_worker_state`` / ``worker_view``
axis has no counterpart.  Parameters and optimizer moments are updated in
place.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.core.collectives import (all_gather_shards, allreduce,
                                          world_size)
from repro_torch.core.grad_sync import (GradientSynchronizer, SyncConfig,
                                        _div)
from repro_torch.core.lag import change_and_scale
from repro_torch.core.local_sgd import average_leaf
from repro_torch.models.model import Model
from repro_torch.optim import apply_rows_inplace, step_inplace


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


# ---------------------------------------------------------------------------
# Sharded data parallelism (ZeRO-style, DESIGN.md §8)
# ---------------------------------------------------------------------------

def make_sharded_train_step(model: Model, executor, layout, sharded_opt,
                            group: Optional[dist.ProcessGroup] = None):
    """Sharded-DP step: gradients reduce-scatter per bucket to their
    canonical owners (``PlanExecutor.sync_shards``), each rank updates
    only its (m,) rows of the f32 master parameters and optimizer moments
    (``sharded_opt``, from ``optim.make_sharded_optimizer``), and the
    updated master rows all-gather back, per bucket on the bucket's
    algorithm, into the parameters (cast to each leaf's dtype, in place).

    Parameters stay whole on every rank (the forward needs them); what is
    partitioned — the f32 master and the moments — is this rank's rows:
    ``{"master": [row_b], "opt": <moments over the rows>}``, one (m_b,)
    f32 row per bucket (the reference carries every rank's rows on a
    leading device axis).

    Bit-compatibility: for dense f32 plans on psum and ring, and for the
    gather-pattern wires, parameters and gathered state equal the
    replicated ``_make_synced_train_step`` on the same plan bit for bit —
    the scatter chunks equal the all-reduce slices, the elementwise
    update commutes with slicing (and with running a row in chunks), and
    the gather moves exact values.

    Returns ``(step_fn, init_opt_rows, init_sync_state)`` with
    ``step_fn(params, opt_rows, sync_state, batch, step, rng) -> (params,
    opt_rows, sync_state, loss)``."""
    if tuple(b.leaves for b in executor.plan.buckets) != \
            tuple(b.leaves for b in layout.buckets):
        raise ValueError("ShardLayout does not match the executor's plan "
                         "buckets — build it with ShardLayout.from_plan on "
                         "the same CommPlan")
    axes = executor.axes

    def step_fn(params, opt_rows, sync_state, batch, step, rng=None):
        loss, grads = loss_and_grads(model, params, batch)
        gshards, sync_state = executor.sync_shards(grads, sync_state, rng)
        del grads
        masters = opt_rows["master"]
        # masters + updates, as apply_updates on the replicated path
        apply_rows_inplace(sharded_opt, masters, gshards, opt_rows["opt"],
                           step)
        del gshards
        # the forward edge: the updated master rows, gathered whole, in
        # the leaves' own dtypes
        leaves = tree_leaves(params)
        with torch.no_grad():
            for b, bl, row in zip(executor.plan.buckets, layout.buckets,
                                  masters):
                full = all_gather_shards(row, bl.n, b.algo, axes)
                off = 0
                for i, sz in zip(bl.leaves, bl.sizes):
                    leaves[i].copy_(full[off:off + sz].reshape(
                        leaves[i].shape))
                    off += sz
                del full
        return params, opt_rows, sync_state, mean_over_group(loss, group)

    def init_opt_rows(params):
        """This rank's partitioned state: the f32 master rows of the
        current parameters (``layout.my_rows``) and the sharded
        optimizer's moments over them (zeros)."""
        masters = layout.my_rows(params, axes)
        return {"master": masters, "opt": sharded_opt.init(masters)}

    def init_sync_state(params):
        return executor.init_state(params)

    return step_fn, init_opt_rows, init_sync_state


# ---------------------------------------------------------------------------
# Strategy phase steps (local SGD, push/pull, LAG)
# ---------------------------------------------------------------------------

def make_local_train_step(model: Model, optimizer,
                          group: Optional[dist.ProcessGroup] = None):
    """Purely local step: this rank's loss, backward and in-place update
    with NO gradient collective (the skip step of local SGD and push/pull),
    so ranks diverge between rounds.  Only the scalar loss is averaged over
    the group, for reporting.  Returns ``step_fn(params, opt_state, batch,
    step) -> loss``."""

    def step_fn(params, opt_state, batch, step):
        loss, grads = loss_and_grads(model, params, batch)
        step_inplace(optimizer, params, grads, opt_state, step)
        del grads
        return mean_over_group(loss, group)

    return step_fn


def make_param_round_step(reducer, group: Optional[dist.ProcessGroup] = None,
                          algo: str = "psum"):
    """One parameter round (local SGD's averaging, push/pull's fetch).

    ``reducer=None``: the dense model average on ``algo``, leaf by leaf in
    place.  Otherwise the round moves the params-minus-anchor DELTA
    through the reducer (per-bucket compression with error feedback: the
    card's kernels for the fused compressors) and rebuilds
    ``params = anchor + reduced``; the anchor (the parameters agreed at the
    last round, equal on every rank) is what keeps compressed averaging
    sound.  Parameters keep their dtype (bf16 stays bf16) and the f32
    anchor is rebuilt FROM the cast result, so it equals what every rank
    holds entering the next local phase.

    Returns ``round_fn(params, anchor, red_state, rng) -> (params, anchor,
    red_state)``; params and anchor are updated in place (``anchor`` is
    None without a reducer)."""
    if reducer is None:
        def avg_round(params, anchor, red_state, rng=None):
            with torch.no_grad():
                for p in tree_leaves(params):
                    p.copy_(average_leaf(p, group, algo))
            return params, anchor, red_state

        return avg_round

    def round_fn(params, anchor, red_state, rng=None):
        with torch.no_grad():
            delta = tree_map(lambda p, a: p.to(torch.float32) - a,
                             params, anchor)
            reduced, red_state = reducer(delta, red_state, rng)
            del delta
            for p, a, r in zip(tree_leaves(params), tree_leaves(anchor),
                               tree_leaves(reduced)):
                a.add_(r)            # anchor + reduced delta, in f32
                p.copy_(a)           # cast to the parameter's dtype
                a.copy_(p)           # the new anchor: what p now holds
            del reduced
        return params, anchor, red_state

    return round_fn


def make_lag_programs(model: Model, optimizer, synchronizer,
                      group: Optional[dist.ProcessGroup] = None):
    """The three LAG steps (host dispatch):

      * ``probe(params, batch, g_last) -> (loss, grads, delta, scale)`` —
        this rank's backward, then ``delta = Σ||g - g_last||²`` and
        ``scale = Σ||g||²`` summed over the group in ONE 2-element f32
        collective, the only wire traffic of a skipped round; the loss is
        the group's mean;
      * ``sync_apply(params, opt_state, sync_state, grads, step, rng) ->
        (params, opt_state, sync_state, synced)`` — reduce the probe's
        gradients through the strategy's reducer and update; ``synced`` is
        the new ``g_last``;
      * ``reuse_apply(params, opt_state, g_last, step)`` — apply the last
        synchronized gradient with no collective at all.
    """

    def probe(params, batch, g_last):
        loss, grads = loss_and_grads(model, params, batch)
        with torch.no_grad():
            sums = torch.stack(change_and_scale(grads, g_last))
            sums = allreduce(sums, "psum", group)
        return mean_over_group(loss, group), grads, sums[0], sums[1]

    def sync_apply(params, opt_state, sync_state, grads, step, rng=None):
        synced, sync_state = synchronizer(grads, sync_state, rng)
        step_inplace(optimizer, params, synced, opt_state, step)
        return params, opt_state, sync_state, synced

    def reuse_apply(params, opt_state, g_last, step):
        step_inplace(optimizer, params, g_last, opt_state, step)
        return params, opt_state

    return probe, sync_apply, reuse_apply
