"""2D-Mesh / 2D-Torus Allreduce (counterpart of
``repro/core/collectives/mesh2d.py``; survey §4.1.2, Fig. 11; Ying et al.
2018; Mikami et al. 2018).

Reduce-scatter along X, allreduce of the shards along Y, all-gather along
X.  ``split=True`` is Ying et al.'s trick: the two halves of the payload
reduce on perpendicular ring orders (the second half with the axes'
roles swapped).
"""
from __future__ import annotations

import torch

from repro_torch.core.collectives.hierarchical import hierarchical_allreduce
from repro_torch.core.collectives.p2p import Axis


def mesh2d_allreduce(x: torch.Tensor, x_axis: Axis, y_axis: Axis,
                     split: bool = False) -> torch.Tensor:
    if not split:
        return hierarchical_allreduce(x, inner_axis=x_axis, outer_axis=y_axis)
    flat = x.reshape(-1)
    h = flat.shape[0] // 2
    a = hierarchical_allreduce(flat[:h], inner_axis=x_axis, outer_axis=y_axis)
    b = hierarchical_allreduce(flat[h:], inner_axis=y_axis, outer_axis=x_axis)
    return torch.cat([a, b]).reshape(x.shape)
