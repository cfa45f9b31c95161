"""Process groups for the port's data-parallel training — the counterpart
of ``repro/launch/mesh.py``: a mesh's data axis becomes a
``torch.distributed`` process group.

The backend is NCCL for a CUDA device and gloo for the CPU.  Ranks meet
through a ``FileStore`` (a file in a directory all ranks can see), never a
TCP port: no network is needed, and concurrent test workers cannot collide
on a fixed ``MASTER_PORT``.  A one-process run still gets a real group of
world 1, so its collectives (NCCL's ``all_reduce`` and
``all_gather_into_tensor`` on the card) are on the path.
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist


def backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_group(device: torch.device, world_size: int = 1, rank: int = 0,
               store_path: Optional[str] = None) -> None:
    """Join (or create) the default process group.  ``store_path`` names
    the rendezvous file that all ``world_size`` ranks share; a world of 1
    makes its own in a fresh temporary directory.  A group that already
    exists is kept if its backend and size match, and refused otherwise."""
    backend = backend_for(device)
    if dist.is_initialized():
        if dist.get_backend() != backend or dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a {dist.get_backend()} process group of world "
                f"{dist.get_world_size()} already exists; this run needs "
                f"{backend} with world {world_size}")
        return
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


def destroy_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
