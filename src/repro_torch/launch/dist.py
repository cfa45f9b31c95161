"""Process groups for the port's data-parallel training — the counterpart
of ``repro/launch/mesh.py``: a mesh's data axis becomes a
``torch.distributed`` process group.

The backend is NCCL for a CUDA device and gloo for the CPU.  Ranks meet
through a ``FileStore`` (a file in a directory all ranks can see), never a
TCP port: no network is needed, and concurrent test workers cannot collide
on a fixed ``MASTER_PORT``.  A one-process run still gets a real group of
world 1, so its collectives (NCCL's ``all_reduce`` and
``all_gather_into_tensor`` on the card) are on the path.
:func:`mesh_axes` splits the default group into one group per axis of a
multi-axis mesh, the manual axes the explicit collectives run over, and
:func:`spawn` starts a world of processes on one machine that meet through
such a file.
"""
from __future__ import annotations

import itertools
import math
import os
import shutil
import tempfile
import time
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_group(device: torch.device, world_size: Optional[int] = 1,
               rank: int = 0, store_path: Optional[str] = None) -> None:
    """Join (or create) the default process group.  ``store_path`` names
    the rendezvous file that all ``world_size`` ranks share; a world of 1
    makes its own in a fresh temporary directory.  A group that already
    exists is kept if its backend and size match (any size when
    ``world_size`` is None), and refused otherwise."""
    backend = backend_for(device)
    if dist.is_initialized():
        if dist.get_backend() != backend or (
                world_size is not None and dist.get_world_size() != world_size):
            raise RuntimeError(
                f"a {dist.get_backend()} process group of world "
                f"{dist.get_world_size()} already exists; this run needs "
                f"{backend} with world {world_size}")
        return
    world_size = 1 if world_size is None else world_size
    if store_path is None:
        if world_size != 1:
            raise ValueError("ranks of a world > 1 must share a store_path")
        store_path = os.path.join(tempfile.mkdtemp(prefix="repro_torch_pg_"),
                                  "store")
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None
                              else torch.cuda.current_device())
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size)


def spawn(fn: Callable, world_size: int, args: tuple = (),
          timeout: Optional[float] = None) -> None:
    """Run ``fn(rank, world_size, store_path, *args)`` in ``world_size``
    fresh processes (the ``spawn`` start method), which meet through the
    rendezvous file ``store_path`` in a new temporary directory
    (:func:`init_group`).  Waits for all of them; when one exits non-zero
    or ``timeout`` seconds pass, the others are stopped and
    ``RuntimeError`` names the exit codes.  ``fn`` and ``args`` must be
    picklable (``fn`` a module-level function)."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    store_dir = tempfile.mkdtemp(prefix="repro_torch_pg_")
    store = os.path.join(store_dir, "store")
    procs = [ctx.Process(target=fn, args=(r, world_size, store, *args))
             for r in range(world_size)]
    t0 = time.monotonic()
    try:
        for p in procs:
            p.start()
        while any(p.is_alive() for p in procs):
            failed = any(p.exitcode not in (None, 0) for p in procs)
            if failed or (timeout is not None
                          and time.monotonic() - t0 > timeout):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.pid is None:        # never started
                continue
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(store_dir, ignore_errors=True)
    codes = [p.exitcode for p in procs]
    if codes != [0] * world_size:
        raise RuntimeError(f"spawned world of {world_size}: rank exit codes "
                           f"{codes} after {time.monotonic() - t0:.1f} s")


def destroy_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def mesh_axes(shape: Sequence[int]) -> Tuple[dist.ProcessGroup, ...]:
    """One process group per axis of a row-major mesh of ``shape`` over the
    default group (the counterpart of ``jax.make_mesh``'s axes, taken as
    ``shard_map``'s manual axes).  Global rank ``r`` sits at the row-major
    coordinates of ``r`` in ``shape``; the group of axis ``k`` holds the
    ranks that share every other coordinate, in the order of their
    coordinate on axis ``k``, so the rank inside the group is
    ``jax.lax.axis_index`` of that axis.  Every rank calls
    ``dist.new_group`` for every group, in the same order, as the call
    requires.  A one-axis mesh is the default group itself."""
    shape = tuple(int(p) for p in shape)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} does not hold a world of {world}")
    if len(shape) == 1:
        return (dist.group.WORLD,)
    coords = list(itertools.product(*(range(p) for p in shape)))
    me = coords[dist.get_rank()]
    axes = []
    for k in range(len(shape)):
        mine = None
        others = [range(p) if i != k else range(1)
                  for i, p in enumerate(shape)]
        for fixed in itertools.product(*others):
            ranks = [coords.index(fixed[:k] + (c,) + fixed[k + 1:])
                     for c in range(shape[k])]
            group = dist.new_group(ranks)
            if me[:k] + me[k + 1:] == fixed[:k] + fixed[k + 1:]:
                mine = group
        axes.append(mine)
    return tuple(axes)
