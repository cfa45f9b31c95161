"""Hierarchical Allreduce (counterpart of
``repro/core/collectives/hierarchical.py``; survey §4.1.2, Fig. 12; Jia et
al. 2018).

A ring reduce-scatter inside the inner axis, a ring allreduce of the
scattered shard over each outer axis, and a ring all-gather inside the
inner axis: 4(k-1)/k·(n/p_outer) intra + 2(p_outer-1)/p_outer·(n/k)
inter traffic, every rank symmetric (no master).
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

from repro_torch.core.collectives.p2p import Axis, axis_size
from repro_torch.core.collectives.ring import (ring_all_gather_chunks,
                                               ring_allreduce,
                                               ring_reduce_scatter)


def hierarchical_allreduce(x: torch.Tensor, inner_axis: Axis,
                           outer_axis: Union[Axis, Sequence[Axis]]):
    """Ring RS over ``inner_axis``; ring allreduce of the shard over
    ``outer_axis`` (one axis, or a sequence of them, innermost first);
    ring AG over ``inner_axis``."""
    outer_axes = tuple(outer_axis) if isinstance(outer_axis, (tuple, list)) \
        else (outer_axis,)
    p_in = axis_size(inner_axis)
    if p_in == 1:
        out = x
        for ax in outer_axes:
            out = ring_allreduce(out, ax)
        return out
    mine, my_idx, n = ring_reduce_scatter(x, inner_axis)
    for ax in outer_axes:
        mine = ring_allreduce(mine, ax)
    gathered = ring_all_gather_chunks(mine, my_idx, p_in, inner_axis)
    return gathered.reshape(-1)[:n].reshape(x.shape).to(x.dtype)
