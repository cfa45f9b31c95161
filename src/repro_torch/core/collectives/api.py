"""Dispatch for the port's collectives on ``torch.distributed`` process
groups (counterpart of ``repro/core/collectives/api.py``, survey §4.1).

A manual ``shard_map`` axis of the reference becomes a process group
(NCCL on the card, gloo on the CPU; ``launch/dist.py:mesh_axes`` builds
one per mesh axis).  Where the reference takes ``axes: Sequence[str]``,
the port takes ``axes``: a tuple of groups, or one group (``None``: the
default group) for a one-axis mesh.

  * :func:`allreduce` over every algorithm of ``ALGOS``: ``psum``
    (``dist.all_reduce`` on each axis in turn) and the explicit
    schedules of ``ring.py``, ``tree.py``, ``hierarchical.py``,
    ``mesh2d.py`` and ``ring_fused.py`` (the compressed ring, whose
    per-hop encode is the ``quantize_tiles`` kernel on the card);
  * :func:`all_gather` (the payload exchange of gather-pattern wires),
    :func:`all_to_all` (``direct`` and ``ring``), its differentiable
    form :func:`all_to_all_grad` and :func:`send_recv`;
  * the sharded-DP edges :func:`reduce_scatter` and
    :func:`all_gather_shards` with the nested canonical chunking
    (:func:`nested_shard_len`, :func:`pad_to_chunks`,
    :func:`my_chunk_index`, :func:`local_chunk`).

A CUDA tensor on a gloo group is moved through a pinned host copy
(``p2p.py``).  :func:`axes_for_topology` maps a tiered topology's tiers
onto one process group each, innermost first, so ``hierarchical`` runs
its inner ring on the fast tier as the cost model
(``core/schedule/cost.py``, re-exported here as in the reference) prices
it.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.core.collectives.hierarchical import hierarchical_allreduce
from repro_torch.core.collectives.mesh2d import mesh2d_allreduce
from repro_torch.core.collectives.p2p import (Axis, axis_index, axis_size,
                                              from_wire, permute,
                                              process_group, to_wire)
from repro_torch.core.collectives.ring import (ring_all_gather_canonical,
                                               ring_allreduce,
                                               ring_reduce_scatter_canonical)
from repro_torch.core.collectives.ring_fused import ring_fused_allreduce
from repro_torch.core.collectives.tree import tree_allreduce
from repro_torch.core.schedule.cost import (  # noqa: F401
    LINK_PRESETS, LinkParams, allreduce_cost_s)

# one output tensor for every rank's input: the new name where it exists
_all_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor

# ring_fused is the LOSSY compressed ring; every other algo sums exactly
ALGOS = ("psum", "ring", "tree", "hierarchical", "mesh2d", "mesh2d_split",
         "ring_fused")

Axes = Union[Axis, Sequence[Axis]]


def as_axes(axes: Axes) -> Tuple[Axis, ...]:
    """A tuple of axes from one group, ``None`` or a sequence of them."""
    if axes is None or isinstance(axes, dist.ProcessGroup):
        return (axes,)
    return tuple(axes)


def axes_for_topology(topo) -> Tuple[dist.ProcessGroup, ...]:
    """THE tier→group mapping of topology-dispatched collectives
    (DESIGN.md §10): one process group per tier of ``topo`` over the
    default group (``launch/dist.py:mesh_axes`` on the tier sizes,
    outermost first, so global rank ``r`` sits at the row-major
    coordinates of ``r``), returned INNERMOST FIRST.  :func:`allreduce`'s
    two-axis algorithms take ``(inner, outer)``: ``hierarchical`` runs its
    ring reduce-scatter / all-gather on ``axes[0]``, the fast tier, and
    the shard ring on ``axes[1]``, exactly as the cost model prices it.
    Every rank must call it, in the same order (``dist.new_group``)."""
    from repro_torch.launch.dist import mesh_axes
    groups = mesh_axes([t.size for t in topo.tiers])
    return tuple(reversed(groups))


def world_size(axes: Axes = None) -> int:
    """Ranks over all ``axes`` (the default group when None)."""
    n = 1
    for ax in as_axes(axes):
        n *= axis_size(ax)
    return n


def check_algo(algo: str) -> None:
    """Raise ``ValueError`` unless ``algo`` is one of ``ALGOS``."""
    if algo not in ALGOS:
        raise ValueError(f"unknown collective algo {algo!r}; known: {ALGOS}")


def _psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``dist.all_reduce`` (sum) of ``x`` over one axis, in place."""
    buf = to_wire(x, axis)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=process_group(axis))
    if buf is not x:
        x.copy_(from_wire(buf, x.device))
    return x


def allreduce(x: torch.Tensor, algo: str, axes: Axes = None) -> torch.Tensor:
    """Sum ``x`` over one or more axes with ``algo`` and return the sum.
    ``psum`` sums in place into ``x`` (the caller passes a buffer it
    owns); the explicit schedules return a new tensor (``x`` itself when
    every axis has one rank)."""
    axes = as_axes(axes)
    if algo == "psum":
        for ax in axes:
            x = _psum(x, ax)
        return x
    if algo == "ring":
        for ax in axes:
            x = ring_allreduce(x, ax)
        return x
    if algo == "tree":
        for ax in axes:
            x = tree_allreduce(x, ax)
        return x
    if algo == "hierarchical":
        if len(axes) == 1:
            return ring_allreduce(x, axes[0])
        return hierarchical_allreduce(x, inner_axis=axes[0],
                                      outer_axis=axes[1:])
    if algo == "ring_fused":
        for ax in axes:
            x = ring_fused_allreduce(x, ax)
        return x
    if algo in ("mesh2d", "mesh2d_split"):
        if len(axes) == 1:
            return ring_allreduce(x, axes[0])
        if len(axes) > 2:
            raise ValueError(f"mesh2d is a two-axis collective, got "
                             f"{len(axes)} axes")
        return mesh2d_allreduce(x, axes[0], axes[1],
                                split=algo == "mesh2d_split")
    raise ValueError(f"unknown collective algo {algo!r}; known: {ALGOS}")


def all_gather(x: torch.Tensor, axis: Axis = None) -> torch.Tensor:
    """Every rank's ``x`` stacked along a new leading rank axis:
    (axis size, *x.shape), in the order of the ranks in the group."""
    w = axis_size(axis)
    flat = to_wire(x.reshape(-1), axis)
    # the concatenated form (gloo takes no other), viewed as a stack
    out = torch.empty(w * flat.numel(), dtype=x.dtype, device=flat.device,
                      pin_memory=flat.device != x.device)
    _all_gather_into(out, flat, group=process_group(axis))
    return from_wire(out, x.device).view((w,) + tuple(x.shape))


# ---------------------------------------------------------------------------
# Expert-parallel edge: all-to-all along one axis (survey §4, DESIGN.md §14)
# ---------------------------------------------------------------------------

A2A_VARIANTS = ("direct", "ring")


def all_to_all(x: torch.Tensor, axis: Axis, variant: str = "direct"):
    """Transpose the leading dim of ``x`` (p, m, ...) across ``axis``:
    row j of the input is this rank's chunk for rank j, row j of the
    output the chunk received from rank j.  Chunks move verbatim, so both
    variants are bit-equal.  ``direct`` is ``dist.all_to_all_single``;
    ``ring`` is p-1 permutes, each moving one chunk one rotation
    further."""
    p = axis_size(axis)
    if x.shape[0] != p:
        raise ValueError(f"all_to_all wants a leading chunk dim of "
                         f"axis_size {p}, got shape {tuple(x.shape)}")
    if variant == "direct":
        buf = to_wire(x, axis)
        out = torch.empty_like(buf)
        dist.all_to_all_single(out, buf, group=process_group(axis))
        return from_wire(out, x.device)
    if variant != "ring":
        raise ValueError(f"unknown all_to_all variant {variant!r}; "
                         f"known: {A2A_VARIANTS}")
    if p == 1:
        return x
    i = axis_index(axis)
    out = x.clone()              # own chunk x[i] is already in place
    for s in range(1, p):
        # rank r sends its chunk for rank (r+s)%p and receives, from rank
        # (r-s)%p, that rank's chunk for r
        perm = [(r, (r + s) % p) for r in range(p)]
        out[(i - s) % p] = permute(x[(i + s) % p], perm, axis)
    return out


class _AllToAll(torch.autograd.Function):
    """:func:`all_to_all` under autograd.  The exchange is its own inverse
    (a rank <-> chunk transpose), so its backward is the same exchange of
    the cotangent: the dispatch's reverse edge is the combine."""

    @staticmethod
    def forward(ctx, x, axis, variant):
        ctx.axis, ctx.variant = axis, variant
        return all_to_all(x, axis, variant)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g.contiguous(), ctx.axis, ctx.variant), None, None


def all_to_all_grad(x: torch.Tensor, axis: Axis,
                    variant: str = "direct") -> torch.Tensor:
    """The differentiable :func:`all_to_all` (either variant): what flows
    back is the all-to-all of the cotangent.  The expert-parallel MoE
    dispatches and combines through it."""
    return _AllToAll.apply(x, axis, variant)


# ---------------------------------------------------------------------------
# Pipeline edge: neighbour send/recv along one axis (DESIGN.md §9)
# ---------------------------------------------------------------------------

def send_recv(x: torch.Tensor, axis: Axis, shift: int = 1,
              senders: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Every rank's ``x`` moves to rank ``r + shift`` along ``axis``
    (``+1`` forward, ``-1`` backward).  It does not wrap: an edge rank
    with no sender gets zeros.  ``senders`` (axis indices; default all)
    names the ranks that hold a payload this hop, as the pipeline's
    schedule knows on every rank: only those pairs move data, the others
    get zeros, and a rank that is no one's receiver passes any tensor of
    the payload's shape and dtype."""
    p = axis_size(axis)
    if shift not in (1, -1):
        raise ValueError(f"send_recv moves one hop, got shift={shift}")
    perm = [(i, i + shift) for i in range(p) if 0 <= i + shift < p
            and (senders is None or i in senders)]
    if not perm:                        # single-stage degenerate pipe
        return torch.zeros_like(x)
    return permute(x, perm, axis)


# ---------------------------------------------------------------------------
# Sharded-DP edges: reduce_scatter / all_gather (survey §3.1.3, DESIGN.md §8)
# ---------------------------------------------------------------------------
#
# The flat buffer is padded and split NESTED over the axes in order: first
# into p1 chunks of m1 = ceil(n/p1), each of those into p2 chunks of
# m2 = ceil(m1/p2), ...  The canonical owner of the chunk at flat offset
# w*m is the rank at row-major mesh position w over the axes.

def nested_shard_len(n: int, axis_sizes) -> int:
    """Per-rank shard length of an n-element buffer under nested chunking."""
    m = int(n)
    for p in axis_sizes:
        m = -(-m // int(p))
    return m


def pad_to_chunks(flat: torch.Tensor, axis_sizes) -> torch.Tensor:
    """Reorder/pad a flat buffer to canonical chunk-major order
    ((world*m,), chunk w at [w*m, (w+1)*m)) under nested chunking."""
    arr = flat.reshape(1, -1)
    for p in axis_sizes:
        n = arr.shape[-1]
        m = -(-n // int(p))
        if int(p) * m != n:          # no copy where nothing is padded
            arr = torch.nn.functional.pad(arr, (0, int(p) * m - n))
        arr = arr.reshape(arr.shape[:-1] + (int(p), m))
    return arr.reshape(-1)


def my_chunk_index(axes: Axes) -> int:
    """Row-major rank index over ``axes`` (the canonical shard this rank
    owns)."""
    w = 0
    for ax in as_axes(axes):
        w = w * axis_size(ax) + axis_index(ax)
    return w


def local_chunk(flat: torch.Tensor, axes: Axes, axis_sizes=None):
    """This rank's canonical chunk of an (already summed) flat buffer."""
    axes = as_axes(axes)
    sizes = tuple(axis_sizes) if axis_sizes is not None else tuple(
        axis_size(ax) for ax in axes)
    m = nested_shard_len(flat.numel(), sizes)
    padded = pad_to_chunks(flat.reshape(-1), sizes)
    w = my_chunk_index(axes)
    return padded[w * m:(w + 1) * m]


def reduce_scatter(x: torch.Tensor, algo: str, axes: Axes) -> torch.Tensor:
    """Sum a flat buffer over ``axes`` and return this rank's canonical
    chunk ((m,), nested-padded).  ``psum``: all-reduce + local slice;
    every other algo: the explicit canonical ring reduce-scatter per
    axis, bit-equal to the matching slices of ``ring_allreduce``."""
    axes = as_axes(axes)
    if algo == "psum":
        return local_chunk(allreduce(x.reshape(-1).clone(), "psum", axes),
                           axes)
    out = x.reshape(-1)
    for ax in axes:
        out, _ = ring_reduce_scatter_canonical(out, ax)
    return out


def all_gather_shards(shard: torch.Tensor, n: int, algo: str,
                      axes: Axes) -> torch.Tensor:
    """Inverse edge: every rank contributes its canonical chunk (m,) and
    gets back the full unpadded buffer (n,).  ``psum`` uses the
    backend's all-gather, other algos the explicit ring gather per axis
    (inner axes first, undoing the nested padding level by level)."""
    axes = as_axes(axes)
    sizes = [axis_size(ax) for ax in axes]
    lens = [int(n)]
    for p in sizes[:-1]:
        lens.append(-(-lens[-1] // p))
    out = shard.reshape(-1)
    for ax, ln in zip(reversed(axes), reversed(lens)):
        if algo == "psum":
            out = all_gather(out, ax).reshape(-1)
        else:
            out = ring_all_gather_canonical(out, ax)
        out = out[:ln]
    return out
