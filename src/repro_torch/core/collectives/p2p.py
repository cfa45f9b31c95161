"""Point-to-point transport of the explicit collectives: the port's
``jax.lax.ppermute`` (survey §4.1).

An axis is a ``torch.distributed`` process group (``None`` is the default
group; ``launch/dist.py:mesh_axes`` builds one group per mesh axis).  The
rank inside the group is the reference's ``axis_index``.
:func:`permute` sends along a permutation of axis indices with
``dist.batch_isend_irecv``; a rank that no one sends to gets zeros, as
under ``ppermute``.  Peers are handed to ``P2POp`` as global ranks
(``dist.get_global_rank``), which every PyTorch release takes.

gloo moves host memory only.  So a CUDA tensor on a gloo group goes over
the wire through a pinned host copy (:func:`to_wire` / :func:`from_wire`),
chosen by the group's backend; those copies are counted in
:func:`staged_bytes`, and left out of an op analysis' count
(``op_analysis.uncounted``).  On NCCL nothing is copied.  Under
``launch/op_analysis.count`` a :func:`permute` that moves data records one
hop (``collective-permute``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch.op_analysis import record_collective, uncounted

Axis = Optional[dist.ProcessGroup]

_staged = 0


def process_group(axis: Axis) -> dist.ProcessGroup:
    return dist.group.WORLD if axis is None else axis


def axis_size(axis: Axis) -> int:
    return dist.get_world_size(process_group(axis))


def axis_index(axis: Axis) -> int:
    return dist.get_rank(process_group(axis))


def staged_bytes() -> int:
    """Bytes copied between the card and the host for gloo since the last
    :func:`reset_staged_bytes` (both directions)."""
    return _staged


def reset_staged_bytes() -> None:
    global _staged
    _staged = 0


def _count(x: torch.Tensor) -> None:
    global _staged
    _staged += x.numel() * x.element_size()


def is_staged(x: torch.Tensor, axis: Axis) -> bool:
    """True when ``axis``'s backend cannot move ``x`` where it lies: a CUDA
    tensor on a gloo group."""
    return x.device.type == "cuda" and \
        dist.get_backend(process_group(axis)) == "gloo"


def to_wire(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` as the backend of ``axis`` moves it: itself (contiguous), or
    a pinned host copy for a CUDA tensor on gloo."""
    if not is_staged(x, axis):
        return x.contiguous()
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    with uncounted():
        host.copy_(x)
    _count(host)
    return host


def from_wire(y: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A received tensor on ``device`` (copied back if it was staged)."""
    if y.device == device:
        return y
    _count(y)
    with uncounted():
        return y.to(device)


def permute(x: torch.Tensor, perm: Sequence[Tuple[int, int]],
            axis: Axis) -> torch.Tensor:
    """Send ``x`` from axis index ``src`` to ``dst`` for every pair of
    ``perm`` (a partial permutation) and return what arrives here, zeros
    where nothing does."""
    pg = process_group(axis)
    r = dist.get_rank(pg)
    dst = [d for s, d in perm if s == r]
    src = [s for s, d in perm if d == r]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"perm {list(perm)} is not a permutation")
    if x.numel() == 0:              # the same shape on every rank
        return torch.zeros_like(x)
    if dst == [r]:
        return x.clone()
    record_collective("collective-permute", x, axis)
    staged = is_staged(x, axis)
    ops = []
    if dst:
        ops.append(dist.P2POp(dist.isend, to_wire(x, axis),
                              dist.get_global_rank(pg, dst[0]), pg))
    if src:
        recv = torch.empty(x.shape, dtype=x.dtype, pin_memory=True) \
            if staged else torch.empty_like(x)
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(pg, src[0]), pg))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return from_wire(recv, x.device) if src else torch.zeros_like(x)
