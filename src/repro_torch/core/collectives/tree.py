"""Tree reduction / broadcast — the parameter-server pattern (counterpart
of ``repro/core/collectives/tree.py``; survey §4.1.1, Fig. 9).

Reduce to rank 0 by recursive distance doubling, then broadcast back:
log2(p) rounds of full-payload transfers each way (against the ring's
2(p-1) rounds of 1/p).  The axis size must be a power of two.  Which rank
absorbs a partner is a Python choice per rank (the reference's
``jnp.where``): a rank that takes nothing keeps its buffer untouched, so
a -0 stays -0.
"""
from __future__ import annotations

import torch

from repro_torch.core.collectives.p2p import (Axis, axis_index, axis_size,
                                              permute)


def _shift_perm(p: int, d: int):
    """rank r -> r - d (send towards the root at rank 0)."""
    return [(i, i - d) for i in range(p) if i - d >= 0]


def tree_reduce_to_root(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """After log2(p) rounds rank 0 holds the sum; other ranks hold partial
    sums."""
    p = axis_size(axis)
    if p & (p - 1) != 0:
        raise ValueError(f"tree collective requires a power-of-two axis "
                         f"size, got {p}")
    r = axis_index(axis)
    acc = x
    d = 1
    while d < p:
        recv = permute(acc, _shift_perm(p, d), axis)
        if r % (2 * d) == 0:      # absorb the partner at distance d
            acc = acc + recv
        d *= 2
    return acc


def tree_broadcast_from_root(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    p, r = axis_size(axis), axis_index(axis)
    d = p // 2
    acc = x
    while d >= 1:
        fwd = [(i, i + d) for i in range(p) if i + d < p]
        recv = permute(acc, fwd, axis)
        if r % (2 * d) == d:
            acc = recv
        d //= 2
    return acc


def tree_allreduce(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Parameter-server pattern: reduce to rank 0, broadcast back."""
    if axis_size(axis) == 1:
        return x
    return tree_broadcast_from_root(tree_reduce_to_root(x, axis), axis)
