"""The tensor- and expert-parallel regions of the port — the part of
``repro/models/sharding_ctx.py`` that tensor and expert parallelism need.

Inside ``with tp_region(group):`` the training blocks' dense FFNs run the
Megatron wire ``layers.mlp_tp`` over ``group`` (a process group), on the
rank's ffn slice of the parameters (``convert.tp_slice``), instead of
``layers.mlp``.  Inside ``with ep_region(group):`` their MoE FFNs run
``moe_ffn(ep_axis=group)`` on the rank's block of the experts
(``convert.ep_slice``).  The contexts are process-global; ``tp_axis()`` and
``ep_axis()`` are None outside every region.  The rest of the reference module (activation
sharding constraints, the mesh context) steers XLA's partitioner and has
no counterpart here.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch.distributed as dist

_CTX = {"tp_axis": None, "ep_axis": None}


@contextlib.contextmanager
def _region(key: str, group: Optional[dist.ProcessGroup]):
    old = _CTX[key]
    _CTX[key] = group
    try:
        yield
    finally:
        _CTX[key] = old


def tp_region(group: Optional[dist.ProcessGroup]):
    """Run the enclosed forward passes with ``group`` as the tp axis
    (None: no tensor parallelism)."""
    return _region("tp_axis", group)


def ep_region(group: Optional[dist.ProcessGroup]):
    """Run the enclosed forward passes with ``group`` as the ep axis
    (None: no expert parallelism)."""
    return _region("ep_axis", group)


def tp_axis() -> Optional[dist.ProcessGroup]:
    """The active tp process group, or None."""
    return _CTX["tp_axis"]


def ep_axis() -> Optional[dist.ProcessGroup]:
    """The active ep process group, or None."""
    return _CTX["ep_axis"]
