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
parameters (``convert.serve_slice``): head-parallel attention and MLA,
Mamba and the xLSTM blocks over ``inner``, the vocab-parallel embedding
and LM head, the dense FFNs on their ffn slice and the experts in
blocks, and the decode cache laid out by
:func:`cache_leaf_spec` with the tp group's size in place of the
reference's 16 (``data``: the data groups that split a batch-1 cache's
length too; ``max_len``: the cache length of a full-attention layer).
:func:`leaf_share` is one rank's block of a cache leaf under that
layout.  Inside ``with train_region(group, algo):`` the training loss runs the
reference's train layout over ``group`` on the rank's share
(``convert.train_slice``), every family; ``blocked_region(tp)`` is its
control in one process.  The contexts are process-global; ``tp_axis()``, ``ep_axis()``
and ``serve_axes()`` are None outside every region.  The rest of the
reference module (activation sharding constraints, the mesh context)
steers XLA's partitioner and has no counterpart here.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence, Tuple

import torch.distributed as dist

_CTX = {"tp_axis": None, "ep_axis": None, "serve": None, "train": None,
        "blocked": None}


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


@dataclasses.dataclass(frozen=True)
class TrainAxes:
    """The train layout's model axis ``tp`` (a process group) and the
    all-reduce ``algo`` of its sums (``collectives.api.ALGOS``; ``tree``
    sums every element in one order that a control can repeat).  A packed
    lossy DP edge under it needs the leaves' sharing classes
    (``SyncConfig.classes``, from ``convert.train_classes``)."""
    tp: dist.ProcessGroup
    algo: str = "psum"


def train_region(group: Optional[dist.ProcessGroup], algo: str = "psum"):
    """Run the enclosed training steps under the train layout over
    ``group`` (None: every rank holds the whole model)."""
    return _region("train", None if group is None else TrainAxes(group, algo))


def train_axes() -> Optional[TrainAxes]:
    """The active train layout, or None."""
    return _CTX["train"]


def blocked_region(tp: Optional[int]):
    """Run the enclosed training steps as the train layout's control: the
    whole parameters in one process, every split piece computed in the
    blocks of ``tp`` ranks and summed apart (None: off)."""
    return _region("blocked", tp)


def blocked_tp() -> Optional[int]:
    """The active control's tp, or None."""
    return _CTX["blocked"]


@contextlib.contextmanager
def regions_of(snapshot: dict):
    """Re-enter the regions of ``snapshot`` (a :func:`snapshot`): a
    checkpointed block's recomputation runs in the forward's regions,
    whatever the backward runs in."""
    old = dict(_CTX)
    _CTX.update(snapshot)
    try:
        yield
    finally:
        _CTX.update(old)


def snapshot() -> dict:
    """The active regions, for :func:`regions_of`."""
    return dict(_CTX)


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


@dataclasses.dataclass(frozen=True)
class LeafShare:
    """A rank's share of one decode-cache leaf under the serve layout:
    ``dim`` (of the unstacked leaf, batch first) cut into ``parts``
    blocks, the rank holding block ``index`` (the data axes' index major,
    the model axis' minor, as the reference's ``(data, model)``);
    ``model`` / ``data``: whether the model axis / the data axes take
    part in the cut."""
    dim: int
    parts: int
    index: int
    model: bool
    data: bool


def leaf_share(name: str, shape: Tuple[int, ...],
               sa: ServeAxes) -> Optional[LeafShare]:
    """The rank's share of the decode-cache leaf ``name`` of the global
    ``shape`` (unstacked, batch first) under the region ``sa``: the
    reference's ``cache_spec`` with the tp group's size as the model
    axis' and the region's data groups (a batch-1 cache's) as its data
    axes; None where the rank holds the whole leaf.  Raises where the
    spec splits two dims (a K/V leaf's kv heads over the model axis and
    its length over the data axes), which no caller of this one-dim
    share runs."""
    from repro_torch.core.collectives.p2p import axis_index, axis_size
    names = tuple(f"d{i}" for i in range(len(sa.data)))
    batch = 1 if sa.data else 2
    spec = cache_leaf_spec(name, (batch,) + tuple(shape[1:]), batch,
                           model_n=axis_size(sa.tp), data=names, batch_dim=0)
    split = [(dim, e) for dim, e in enumerate(spec[1:], 1) if e is not None]
    if len(split) > 1:
        raise ValueError(f"cache leaf {name} {tuple(shape)}: the spec "
                         f"{spec} splits two dims")
    for dim, entry in split:
        axes = entry if isinstance(entry, tuple) else (entry,)
        parts, index = 1, 0
        for a in axes:
            g = sa.tp if a == "model" else sa.data[names.index(a)]
            parts, index = parts * axis_size(g), \
                index * axis_size(g) + axis_index(g)
        if shape[dim] % parts:
            raise ValueError(f"cache leaf {name} {tuple(shape)}: dim {dim} "
                             f"does not split into {parts}")
        return LeafShare(dim, parts, index, "model" in axes,
                         any(a != "model" for a in axes))
    return None
