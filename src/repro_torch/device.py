"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for another device
(the CPU tests pass ``device="cpu"``).  With no device given and no CUDA
device present they raise: a silent fall-back to the CPU would turn every
timing into a CPU timing.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch._tree import tree_leaves

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the PyTorch port runs on the GPU by default; "
                "pass device='cpu' (or --device cpu) to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def tensor_device(tree) -> Optional[torch.device]:
    """Device of the first tensor leaf of a parameter tree, else None."""
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None
