"""The tensor-, expert- and serve-parallel regions of the port — the part
of ``repro/models/sharding_ctx.py`` that the port's parallelism needs —
and the reference's decode-cache layout rule.

Inside ``with tp_region(group):`` the training blocks' dense FFNs run the
Megatron wire ``layers.mlp_tp`` over ``group`` (a process group), on the
rank's ffn slice of the parameters (``convert.tp_slice``), instead of
``layers.mlp``.  Inside ``with ep_region(group):`` their MoE FFNs run
``moe_ffn(ep_axis=group)`` on the rank's block of the experts
(``convert.ep_slice``).  Inside ``with serve_region(group, data,
max_len):`` the prefill and decode steps run the reference's serve
layout over the model axis ``group`` on the rank's share of the
parameters (``convert.serve_slice``): head-parallel attention, the
vocab-parallel embedding and LM head, the dense FFNs on their ffn slice
and the experts in blocks, and the decode cache laid out by
:func:`cache_leaf_spec` with the tp group's size in place of the
reference's 16 (``data``: the data groups that split a batch-1 cache's
length too; ``max_len``: the cache length of a full-attention layer).
The contexts are process-global; ``tp_axis()``, ``ep_axis()`` and
``serve_axes()`` are None outside every region.  The rest of the
reference module (activation sharding constraints, the mesh context)
steers XLA's partitioner and has no counterpart here.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence, Tuple

import torch.distributed as dist

_CTX = {"tp_axis": None, "ep_axis": None, "serve": None}


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


@dataclasses.dataclass(frozen=True)
class ServeAxes:
    """The serve layout's groups: ``tp`` the model axis, ``data`` the data
    axes over which a batch-1 cache's length is split as well (empty when
    the batch is split over them or there are none), and ``max_len`` the
    cache length of a full-attention layer (a window layer keeps
    ``min(window, max_len)``)."""
    tp: dist.ProcessGroup
    data: Tuple[dist.ProcessGroup, ...] = ()
    max_len: Optional[int] = None


def serve_region(group: Optional[dist.ProcessGroup],
                 data: Sequence[dist.ProcessGroup] = (),
                 max_len: Optional[int] = None):
    """Run the enclosed prefill and decode steps under the serve layout
    over ``group`` (None: every rank holds the whole model)."""
    return _region("serve", None if group is None else
                   ServeAxes(group, tuple(data), max_len))


def serve_axes() -> Optional[ServeAxes]:
    """The active serve layout, or None."""
    return _CTX["serve"]


# cache leaves by name (reference ``model.py:247-277``)
KV_LEAVES = ("k", "v", "cross_k", "cross_v")
LATENT_LEAVES = ("c_kv", "k_rope")
STATE_LEAVES = ("h", "conv", "C")


def cache_leaf_spec(name: str, shape: Tuple[int, ...], batch: int,
                    model_n: int = 16,
                    data: Tuple[str, ...] = ("data",),
                    batch_dim: Optional[int] = None) -> Tuple:
    """The reference's ``cache_spec`` for one decode-cache leaf of the
    global ``batch``: a tuple of mesh axes per dim.  The batch goes over
    the data axes when ``batch > 1``; attention K/V over the model axis
    on the kv-head dim where ``model_n`` divides it, else on the length
    dim where it divides the length and the length is at least 2048;
    MLA latents on the length on the same terms; recurrent states on
    their widest dim where ``model_n`` divides it; and at ``batch == 1``
    a length of at least 4096 over the data axes too (before the model
    axis).  ``model_n`` is the model axis' size (the reference's
    production 16).  The batch dim is the first of the leaf's first two
    dims of size ``batch``, as the reference finds it (a stacked leaf
    whose layer count equals the batch is read as batched on its layers),
    unless ``batch_dim`` names it."""
    nd = len(shape)
    spec = [None] * nd
    bi = batch_dim if batch_dim is not None else next(
        (i for i in range(min(nd, 2)) if shape[i] == batch), None)
    if bi is None:
        return tuple(spec)
    batch_axis = (data if len(data) > 1 else data[0]) if data else None
    if batch > 1:
        spec[bi] = batch_axis
    li = bi + 1
    if name in KV_LEAVES:
        kv_dim = bi + 2
        if shape[kv_dim] % model_n == 0:
            spec[kv_dim] = "model"
        elif li < nd and shape[li] % model_n == 0 and shape[li] >= 2048:
            spec[li] = "model"
    elif name in LATENT_LEAVES:
        if li < nd and shape[li] % model_n == 0 and shape[li] >= 2048:
            spec[li] = "model"
    elif name in STATE_LEAVES:
        fi = max(range(bi + 1, nd), key=lambda i: shape[i])
        if shape[fi] % model_n == 0:
            spec[fi] = "model"
    if batch == 1 and li < nd and shape[li] >= 4096:
        if spec[li] is None:
            spec[li] = tuple(data)
        elif spec[li] == "model":
            spec[li] = tuple(data) + ("model",)
    return tuple(spec)
