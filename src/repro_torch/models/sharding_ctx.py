"""The tensor-parallel region of the port — the part of
``repro/models/sharding_ctx.py`` that tensor parallelism needs.

Inside ``with tp_region(group):`` the training blocks' dense FFNs run the
Megatron wire ``layers.mlp_tp`` over ``group`` (a process group), on the
rank's ffn slice of the parameters (``convert.tp_slice``), instead of
``layers.mlp``.  The context is process-global; ``tp_axis()`` is None
outside every region.  The rest of the reference module (activation
sharding constraints, the mesh context) steers XLA's partitioner and has
no counterpart here.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch.distributed as dist

_CTX = {"tp_axis": None}


@contextlib.contextmanager
def tp_region(group: Optional[dist.ProcessGroup]):
    """Run the enclosed forward passes with ``group`` as the tp axis
    (None: no tensor parallelism)."""
    old = _CTX["tp_axis"]
    _CTX["tp_axis"] = group
    try:
        yield
    finally:
        _CTX["tp_axis"] = old


def tp_axis() -> Optional[dist.ProcessGroup]:
    """The active tp process group, or None."""
    return _CTX["tp_axis"]
