"""Collectives of the port on ``torch.distributed`` process groups
(counterpart of ``repro/core/collectives/api.py``, survey §4.1).

A mesh axis of the reference becomes a process group: NCCL on the card,
gloo on the CPU (``launch/dist.py`` sets it up).  Ported so far:

  * ``allreduce(x, "psum", group)`` — ``dist.all_reduce`` (sum), the
    collective of dense and aggregatable buckets;
  * ``all_gather(x, group)`` — ``dist.all_gather_into_tensor`` (named
    ``all_gather_single`` in the PyTorch releases that deprecate the old
    name), the payload exchange of gather-pattern wires
    (``PlanExecutor._gather_mean``).

The reference's other algorithms (``ring``, ``tree``, ``hierarchical``,
``mesh2d``, ``mesh2d_split``, ``ring_fused``) are explicit schedules still
to port; asking for one raises.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

# one output tensor for every rank's input: the new name where it exists
_all_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor

ALGOS = ("psum", "ring", "tree", "hierarchical", "mesh2d", "mesh2d_split",
         "ring_fused")


def world_size(group: Optional[dist.ProcessGroup] = None) -> int:
    """Ranks in ``group`` (the default group when None)."""
    return dist.get_world_size(group)


def check_algo(algo: str) -> None:
    """Raise unless ``algo`` is a collective the port can run."""
    if algo == "psum":
        return
    if algo in ALGOS:
        raise NotImplementedError(
            f"collective algo {algo!r} is not ported yet (ROADMAP.md queue "
            f"1, item 2: the explicit ring/tree/hierarchical/mesh2d/"
            f"ring_fused schedules on process groups); ported: psum")
    raise ValueError(f"unknown collective algo {algo!r}; known: {ALGOS}")


def allreduce(x: torch.Tensor, algo: str,
              group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Sum ``x`` over the ranks of ``group`` IN PLACE and return it (the
    caller passes a buffer it owns)."""
    check_algo(algo)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_gather(x: torch.Tensor,
               group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Every rank's ``x`` stacked along a new leading rank axis:
    (world, *x.shape), rank order."""
    flat = x.contiguous().reshape(-1)
    w = world_size(group)
    # the concatenated form (gloo takes no other), viewed as a stack
    out = torch.empty(w * flat.numel(), dtype=x.dtype, device=x.device)
    _all_gather_into(out, flat, group=group)
    return out.view((w,) + tuple(x.shape))
