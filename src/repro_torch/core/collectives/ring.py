"""Ring Allreduce (counterpart of ``repro/core/collectives/ring.py``;
survey §4.1.2, Fig. 10; Baidu 2017; Patarasuk & Yuan 2009).

Explicit :func:`~repro_torch.core.collectives.p2p.permute` steps over one
axis (a process group): a reduce-scatter phase (p-1 steps) followed by an
all-gather phase (p-1 steps), each moving 1/p of the payload per step —
the bandwidth-optimal 2(p-1)/p · n total traffic.  Chunk order, zero
padding and the order of every sum (``acc[recv_i] + recv``) are the
reference's, so the result is bit-equal to it.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.core.collectives.p2p import (Axis, axis_index, axis_size,
                                              permute)


def ring_perm(p: int) -> List[Tuple[int, int]]:
    return [(i, (i + 1) % p) for i in range(p)]


def pad_chunks(x: torch.Tensor, p: int) -> Tuple[torch.Tensor, int]:
    """A new (p, ceil(n/p)) buffer holding flat ``x`` zero-padded, and n."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    m = -(-n // p)
    out = flat.new_zeros(p * m)
    out[:n] = flat
    return out.view(p, m), n


def ring_reduce_scatter(x: torch.Tensor, axis: Axis):
    """Returns (my_chunk (m,), chunk_index, n): rank r ends with chunk
    (r+1) % p of the padded sum."""
    p, r = axis_size(axis), axis_index(axis)
    acc, n = pad_chunks(x, p)
    perm = ring_perm(p)
    for s in range(p - 1):
        recv = permute(acc[(r - s) % p], perm, axis)
        acc[(r - s - 1) % p] += recv
    return acc[(r + 1) % p], (r + 1) % p, n


def ring_all_gather_chunks(mine: torch.Tensor, my_index: int, p: int,
                           axis: Axis) -> torch.Tensor:
    """Inverse phase: circulate each rank's chunk until every rank holds
    all of them; returns (p, m)."""
    perm = ring_perm(p)
    out = mine.new_zeros((p,) + tuple(mine.shape))
    out[my_index] = mine
    cur, idx = mine, my_index
    for _ in range(p - 1):
        cur = permute(cur, perm, axis)
        idx = (idx - 1) % p
        out[idx] = cur
    return out


def ring_allreduce(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Bandwidth-optimal allreduce of one tensor over one axis."""
    p = axis_size(axis)
    if p == 1:
        return x
    mine, my_idx, n = ring_reduce_scatter(x, axis)
    mine = mine.clone()       # frees the padded accumulator before the gather
    gathered = ring_all_gather_chunks(mine, my_idx, p, axis)
    return gathered.reshape(-1)[:n].reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Canonical-ownership variants (sharded data parallelism, DESIGN.md §8)
# ---------------------------------------------------------------------------

def ring_reduce_scatter_canonical(x: torch.Tensor, axis: Axis):
    """Reduce-scatter with canonical ownership: rank r ends holding chunk
    r of the padded sum (m = ceil(n/p) elements).  One more hop relabels
    the (r+1) % p chunk of :func:`ring_reduce_scatter` without touching
    its values.  Returns (my_chunk (m,), n_unpadded)."""
    p = axis_size(axis)
    flat = x.reshape(-1)
    if p == 1:
        return flat, flat.shape[0]
    mine, _, n = ring_reduce_scatter(flat, axis)
    return permute(mine, ring_perm(p), axis), n


def ring_all_gather_canonical(shard: torch.Tensor, axis: Axis):
    """Inverse phase for canonically owned chunks: every rank contributes
    its chunk r (m,) and ends with the full padded buffer (p*m,)."""
    p = axis_size(axis)
    if p == 1:
        return shard.reshape(-1)
    out = ring_all_gather_chunks(shard.reshape(-1), axis_index(axis), p, axis)
    return out.reshape(-1)
