"""Train steps of the port — counterparts of ``repro/launch/steps.py``:

  * :func:`make_train_step` — vanilla BSP (loss, backward, update; at a
    world above 1 the gradients are averaged densely), with gradient
    accumulation over ``microbatches``;
  * :func:`make_prefill_step` / :func:`make_decode_step` — the serving
    steps the dry run traces;
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
    and moments, and the all-gather back into the parameters;
  * :func:`make_pipeline_train_step` — pipeline parallelism: 1F1B over
    ``send_recv`` on a pipe group, the DP edge per layer row on the data
    group.

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
from repro_torch.core.collectives import (all_gather, all_gather_shards,
                                          allreduce, send_recv, world_size)
from repro_torch.core.collectives.p2p import (axis_index, axis_size,
                                              staged_bytes)
from repro_torch.core.grad_sync import (GradientSynchronizer, SyncConfig,
                                        _div)
from repro_torch.core.lag import change_and_scale
from repro_torch.core.local_sgd import average_leaf
from repro_torch.core.pipeline import aligned_ticks
from repro_torch.models.model import Model
from repro_torch.models.moe import drop_tap_paused
from repro_torch.models.sharding_ctx import train_axes
from repro_torch.optim import apply_rows_inplace, step_inplace


def loss_and_grads(model: Model, params, batch):
    """(loss, grads): the loss (detached) and its gradient for every leaf of
    ``params``, as a tree of the same shape; a leaf the loss does not read
    (the encoder-decoder's ``final_norm``) gets zeros, as under
    ``jax.grad``."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def mean_over_group(x: torch.Tensor,
                    group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """The mean of a per-rank value over the group (the reference's
    ``pmean`` of the loss)."""
    return _div(allreduce(x.clone(), "psum", group), float(world_size(group)))


def make_train_step(model: Model, optimizer,
                    group: Optional[dist.ProcessGroup] = None,
                    microbatches: int = 1):
    """Vanilla BSP step: loss, backward, update.  Returns
    ``train_step(params, opt_state, batch, step) -> loss``; params and the
    optimizer state are updated in place.

    ``microbatches > 1`` runs gradient accumulation, as the reference's
    scan: the batch is split along dim 0 into that many slices, each
    slice's gradients are added in f32 in slice order, and the loss and the
    gradients are the means over the slices; the update and the gradient
    sync run once per step."""
    dense = GradientSynchronizer(SyncConfig(), group)
    M = int(microbatches)

    def grads_of(params, batch):
        if M <= 1:
            return loss_and_grads(model, params, batch)
        B = tree_leaves(batch)[0].shape[0]
        if B % M:
            raise ValueError(f"batch rows {B} do not split into {M} "
                             f"micro-batches")
        mb = B // M
        loss = torch.zeros((), dtype=torch.float32,
                           device=tree_leaves(params)[0].device)
        acc = None
        for i in range(M):
            part = tree_map(lambda x: x[i * mb:(i + 1) * mb], batch)
            l, g = loss_and_grads(model, params, part)
            if acc is None:
                acc = tree_map(lambda t: torch.zeros(t.shape,
                                                     dtype=torch.float32,
                                                     device=t.device), g)
            for a, gg in zip(tree_leaves(acc), tree_leaves(g)):
                a.add_(gg)
            del g
            loss = loss + l
        return _div(loss, float(M)), tree_map(
            lambda a: _div(a, float(M), inplace=True), acc)

    def train_step(params, opt_state, batch, step):
        loss, grads = grads_of(params, batch)
        if world_size(group) > 1:
            grads, _ = dense(grads, {"step": 0})
            loss = mean_over_group(loss, group)
        step_inplace(optimizer, params, grads, opt_state, step)
        return loss

    return train_step


def make_prefill_step(model: Model, max_len: Optional[int] = None):
    """``prefill_step(params, batch) -> (last-token logits, cache)``, the
    cache ``max_len`` entries long (the prompt's length when None)."""
    def prefill_step(params, batch):
        return model.prefill(params, batch, max_len)

    return prefill_step


def make_decode_step(model: Model, mla_absorb: bool = False,
                     moe_dispatch: bool = False, donate: bool = False):
    """``decode_step(params, tokens, cache, pos) -> (logits, new_cache)``
    with MLA's absorbed decode and the MoE capacity dispatch as asked.
    ``donate=True`` is the reference's ``donate_argnums=(2,)``: the new
    token's entries are written into ``cache`` itself, which is returned,
    so the step holds one cache, not two."""
    def decode_step(params, tokens, cache, pos):
        return model.decode_step(params, tokens, cache, pos,
                                 mla_absorb=mla_absorb,
                                 moe_dispatch=moe_dispatch, inplace=donate)

    return decode_step


def make_comm_optimized_train_step(model: Model, optimizer, sync: SyncConfig,
                                   group: Optional[dist.ProcessGroup] = None):
    """Per-rank loss/backward; gradient exchange through the
    GradientSynchronizer (compression + collective algorithm)."""
    synchronizer = GradientSynchronizer(sync, group)
    return _make_synced_train_step(model, optimizer, synchronizer, group)


def _check_dp_edge(synchronizer) -> None:
    """Raise if a packed lossy DP edge runs under the train layout without
    the leaves' sharing classes (``SyncConfig.classes``): a tile coded from
    a leaf that every rank of the model axis holds and a rank's own block
    would move the shared leaf apart on the ranks."""
    cfg = getattr(synchronizer, "cfg", None)
    if (train_axes() is not None and cfg is not None and cfg.classes is None
            and cfg.compressor not in ("none", "powersgd")
            and cfg.bucket_bytes > 0):
        raise ValueError(
            f"a packed {cfg.compressor} DP edge under the train layout "
            f"needs SyncConfig.classes (convert.train_classes)")


def _make_synced_train_step(model: Model, optimizer, synchronizer,
                            group: Optional[dist.ProcessGroup] = None):
    """The synced step around any grad-sync engine exposing
    ``init_state(grads)`` and ``__call__(grads, state, rng)``.  Returns
    ``(step_fn, synchronizer, init_sync_state)`` with
    ``step_fn(params, opt_state, sync_state, batch, step, rng) ->
    (params, opt_state, sync_state, loss)``."""

    def step_fn(params, opt_state, sync_state, batch, step, rng=None):
        _check_dp_edge(synchronizer)
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
# Pipeline parallelism (1F1B micro-batching over a pipe axis, DESIGN.md §9)
# ---------------------------------------------------------------------------
#
# The reference's ``pipe_spec_tree`` (which leaves carry the pipe-sharded
# stage axis) has no counterpart: each process holds its own stage's rows
# and their optimizer state, so no leaf is laid out over the pipe axis.

def unstack_rows(rows_local, rows_per_stage: int):
    """Stage rows (R/S, ...) -> list of R/S per-row trees, each a VIEW of
    its row: the DP gradient edge syncs, and the optimizer updates, PER
    LAYER ROW, so compression granularity (int8 scales, top-k masks, EF
    residuals) and the update's leaf shapes are the same at every stage
    count (DESIGN.md §9)."""
    return [tree_map(lambda x, i=i: x[i], rows_local)
            for i in range(rows_per_stage)]


def restack_rows(row_trees):
    """Inverse of :func:`unstack_rows` (a new (R/S, ...) tensor per leaf)."""
    return tree_map(lambda *xs: torch.stack(xs), *row_trees)


def merge_opt_rows(state, rows: int, pipe_axis=None):
    """Leaf-shaped view of pipeline optimizer state: wherever the state
    mirrors the stage tree (``{"shared": ..., "rows": [per-row trees]}``),
    stack the per-row entries into (R/S, ...) and, over a pipe axis of
    more than one stage, gather every stage's (a collective: every rank
    calls it) into the stack's (R, ...) leaves — row r lives at stage
    r // (R/S), slot r % (R/S), the order ``StagedModel.split`` cuts.
    The session's checkpoints and the conformance checks share it."""
    S = 1 if pipe_axis is None else axis_size(pipe_axis)

    def stack(v):
        st = restack_rows(v)
        if S > 1:
            st = tree_map(lambda x: all_gather(x, pipe_axis), st)
        return tree_map(lambda x: x.reshape((rows,) + tuple(
            x.shape[2 if S > 1 else 1:])), st)

    def merge(node):
        if isinstance(node, dict):
            return {k: stack(v) if k == "rows" and isinstance(v, list)
                    else merge(v) for k, v in node.items()}
        if isinstance(node, list):
            return [merge(x) for x in node]
        return node

    return merge(state)


def make_pipeline_train_step(staged, optimizer, engine, micro_batches: int,
                             pipe_axis=None, data_axis=None):
    """1F1B pipeline-parallel step of this rank's stage, on a ``pipe ×
    data`` mesh (``launch/dist.py:mesh_axes((S, dp))``; ``pipe_axis`` may
    be None at S = 1).

    ``staged`` is a :class:`repro_torch.core.pipeline.StagedModel` (or
    anything with its ``layout`` / ``embed_mb`` / ``stage_apply`` /
    ``loss_tail`` / ``aux_coef`` surface).  Params travel as ``{"shared":
    ..., "rows": ...}``: the shared cells, and this stage's rows with
    leaves (R/S, ...).

    The step walks the reference's aligned slot grid of T = M + 2(S-1)
    ticks (``pipeline.aligned_ticks``): F(m) at tick m + s, B(m) at tick
    m + 2(S-1) - s, and after each tick one hop each way on the pipe
    group (``send_recv``: {"h", "aux"} forward, its cotangent backward).
    Only the slots that hold a micro-batch run — the reference computes
    masked work in every slot, as SPMD must — and only the ranks with a
    payload send, which every rank knows from the schedule.  A forward
    slot runs under ``torch.no_grad`` and keeps its boundary input, in a
    ring of 2S - 1 entries; the backward slot recomputes the stage from
    it and takes ``torch.autograd.grad`` with the received cotangent (the
    last stage, whose forward has no consumer, runs only the backward
    slot, seeded by its loss).  Stage 0 recomputes the embedding inside
    its backward slot.

    Gradients accumulate in f32 over micro-batches in ascending order.
    The shared cells keep one accumulator per owning stage — stage 0's
    embedding lookup, stage S-1's loss tail (with a tied embedding both
    write the table) — even at S = 1, summed once after the loop in stage
    order, across stages by one all-reduce over the pipe group: so the
    sums are the same at every S.  Then x 1/M, and the DP edge syncs
    ``{"shared": ..., "rows": [row_0, ...]}`` per layer row through
    ``engine`` (over the data axis only), and the optimizer updates that
    per-row tree of views in place.  S = 1 with M > 1 is plain
    micro-batched accumulation, with no hop.  The loss is the last
    stage's micro-batch sum, all-reduced over pipe, x 1/M, averaged over
    the data group.

    Returns ``(step_fn, init_opt_state, init_sync_state)``;
    ``step_fn(params, opt_state, sync_state, batch, step, rng) -> (params,
    opt_state, sync_state, loss)`` keeps in ``step_fn.staged`` the bytes
    its gloo traffic staged through host memory (``"hops"``, ``"pipe"``
    for the shared cells' all-reduce; ``p2p.staged_bytes``)."""
    S = staged.layout.n_stages
    rps = staged.layout.rows_per_stage
    M = int(micro_batches)
    if M < 1:
        raise ValueError(f"micro_batches must be >= 1, got {M}")
    if S > 1 and (pipe_axis is None or axis_size(pipe_axis) != S):
        raise ValueError(f"pipe axis of {axis_size(pipe_axis)} ranks != "
                         f"staged n_stages {S}")
    T = aligned_ticks(S, M)
    W = 2 * S - 1                        # live window of buffered F inputs
    s = axis_index(pipe_axis) if S > 1 else 0
    first, last = s == 0, s == S - 1
    inv_m = 1.0 / M
    f32 = torch.float32

    def grad_leaf(t):
        return t.detach().requires_grad_(True)

    templates = {}       # micro-batch shape -> a payload-less rank's send

    def template(shared, toks):
        """A payload of the boundary's shape and dtype (read off the
        embedding on meta tensors, no device work), made once per
        micro-batch shape: ``send_recv`` moves only the senders' data."""
        key = tuple(toks.shape)
        if key not in templates:
            h = staged.embed_mb(tree_map(lambda t: t.to("meta"), shared),
                                toks.to("meta"))
            templates[key] = {
                "aux": torch.zeros((), dtype=f32, device=toks.device),
                "h": torch.empty(h.shape, dtype=h.dtype, device=toks.device)}
        return templates[key]

    def senders(k: int, shift: int):
        if shift > 0:                    # F(k - r) done at stage r < S-1
            return [r for r in range(S - 1) if 0 <= k - r < M]
        return [r for r in range(1, S)   # B(k - 2(S-1) + r) done at r > 0
                if 0 <= k - 2 * (S - 1) + r < M]

    def step_fn(params, opt_state, sync_state, batch, step, rng=None):
        shared, rows = params["shared"], params["rows"]
        tokens = batch["tokens"]                  # this data rank's rows
        b_dp = tokens.shape[0]
        if b_dp % M:
            raise ValueError(f"batch rows {b_dp} do not split into {M} "
                             f"micro-batches")
        toks_mb = tokens.reshape((M, b_dp // M) + tuple(tokens.shape[1:]))
        dev = tokens.device
        rows_g = tree_map(grad_leaf, rows)
        row_leaves = tree_leaves(rows_g)
        sh_leaves = tree_leaves(shared)
        g_rows = [torch.zeros(t.shape, dtype=f32, device=t.device)
                  for t in row_leaves]
        own = {"first": {}, "last": {}}   # owner -> {shared leaf: f32 acc}
        loss_sum = torch.zeros((), dtype=f32, device=dev)
        buf = [None] * W
        recv_f = recv_b = None
        staged0 = staged_bytes()
        hop_bytes = 0

        def accumulate(owner, grads):
            for j, g in enumerate(grads):
                if g is None:
                    continue
                acc = own[owner].get(j)
                if acc is None:
                    acc = own[owner][j] = torch.zeros(g.shape, dtype=f32,
                                                      device=g.device)
                acc.add_(g)

        def hop(payload, shift, k):
            """One hop of {"h", "aux"} along the pipe; what arrives here,
            or None."""
            who = senders(k, shift)
            if payload is None:
                payload = template(shared, toks_mb[0])
            got = {key: send_recv(payload[key], pipe_axis, shift, who)
                   for key in ("aux", "h")}
            return got if s - shift in who else None

        for k in range(T):
            # ---- forward slot: F(k - s); the last stage only keeps it ----
            m_f = k - s
            out = None
            if 0 <= m_f < M:
                if first:
                    x_in = None
                else:
                    x_in = recv_f
                    buf[k % W] = x_in
                if not last:
                    # the backward slot recomputes this forward: the MoE
                    # drop tap counts it there, once
                    with torch.no_grad(), drop_tap_paused():
                        if first:
                            x_in = {"h": staged.embed_mb(shared,
                                                         toks_mb[m_f]),
                                    "aux": torch.zeros((), dtype=f32,
                                                       device=dev)}
                        h, aux = staged.stage_apply(rows, x_in["h"])
                        out = {"h": h, "aux": x_in["aux"] + aux}
                    del x_in

            # ---- backward slot: B(k - 2(S-1) + s), recomputed from the
            # input buffered at tick k - 2(S-1) + 2s ----
            m_b = k - 2 * (S - 1) + s
            d_x = None
            if 0 <= m_b < M:
                toks = toks_mb[m_b]
                with torch.enable_grad():
                    inputs = list(row_leaves)
                    if first:
                        emb = tree_map(grad_leaf, shared)
                        h0 = staged.embed_mb(emb, toks)
                        aux0 = torch.zeros((), dtype=f32, device=dev)
                        inputs += tree_leaves(emb)
                    else:
                        slot = (k - 2 * (S - 1) + 2 * s) % W
                        x_b, buf[slot] = buf[slot], None
                        h0, aux0 = grad_leaf(x_b["h"]), grad_leaf(x_b["aux"])
                        inputs += [h0, aux0]
                        del x_b
                    h, aux = staged.stage_apply(rows_g, h0)
                    aux = aux0 + aux
                    if last:
                        tail = tree_map(grad_leaf, shared)
                        inputs += tree_leaves(tail)
                        loss = (staged.loss_tail(tail, h, toks)
                                + staged.aux_coef * aux)
                        outs, cts = [loss], [None]
                    else:
                        outs, cts = [h], [recv_b["h"]]
                        if aux.requires_grad:
                            outs.append(aux)
                            cts.append(recv_b["aux"])
                    grads = list(torch.autograd.grad(outs, inputs, cts,
                                                     allow_unused=True))
                    del outs, cts, h, aux
                for acc, g in zip(g_rows, grads[:len(row_leaves)]):
                    acc.add_(g)
                rest = grads[len(row_leaves):]
                if first:
                    accumulate("first", rest[:len(sh_leaves)])
                    rest = rest[len(sh_leaves):]
                else:
                    d_x = {"h": rest[0], "aux": rest[1] if rest[1] is not None
                           else torch.zeros((), dtype=f32, device=dev)}
                    rest = rest[2:]
                if last:
                    accumulate("last", rest)
                    loss_sum += loss.detach()
                    del loss
                del grads, rest

            # ---- boundary exchange: one hop each way ----
            if S > 1:
                before = staged_bytes()
                recv_f = hop(out, +1, k)
                recv_b = hop(d_x, -1, k)
                hop_bytes += staged_bytes() - before
            del out, d_x

        # shared cells: each owner's sum, in stage order, then across the
        # stages (the other stages hold zeros, which add exactly)
        g_shared = []
        for j, p in enumerate(sh_leaves):
            parts = [own[o].pop(j) for o in ("first", "last") if j in own[o]]
            g = parts[0] if parts else torch.zeros(p.shape, dtype=f32,
                                                   device=p.device)
            for q in parts[1:]:
                g.add_(q)
            del parts
            g_shared.append(g)
        before = staged_bytes()
        if S > 1:
            g_shared = [allreduce(g, "psum", pipe_axis) for g in g_shared]
            loss_sum = allreduce(loss_sum, "psum", pipe_axis)
        pipe_bytes = staged_bytes() - before
        for g in g_rows + g_shared:
            g.mul_(inv_m)
        loss = mean_over_group(loss_sum * inv_m, data_axis)
        step_fn.staged = {"hops": hop_bytes, "pipe": pipe_bytes,
                          "total": staged_bytes() - staged0}

        # DP edge: per layer row, data axis only
        it_r, it_s = iter(g_rows), iter(g_shared)
        gtree = {"rows": unstack_rows(tree_map(lambda _: next(it_r), rows),
                                      rps),
                 "shared": tree_map(lambda _: next(it_s), shared)}
        del g_rows, g_shared, it_r, it_s
        synced, sync_state = engine(gtree, sync_state, rng)
        del gtree
        # the optimizer on the per-row tree of views: every row's update
        # has the same leaf shapes at every stage count
        step_inplace(optimizer, {"shared": shared,
                                 "rows": unstack_rows(rows, rps)},
                     synced, opt_state, step)
        del synced
        return params, opt_state, sync_state, loss

    step_fn.staged = {"hops": 0, "pipe": 0, "total": 0}

    def stage_tree(params):
        return {"shared": params["shared"],
                "rows": unstack_rows(params["rows"], rps)}

    def init_opt_state(params):
        """Optimizer state over the per-row stage tree ``{"shared": ...,
        "rows": [row_0, ..., row_{R/S-1}]}`` of this stage."""
        return optimizer.init(stage_tree(params))

    def init_sync_state(params):
        """This (pipe, data) rank's reducer state over the per-row tree."""
        return engine.init_state(stage_tree(params))

    return step_fn, init_opt_state, init_sync_state


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
