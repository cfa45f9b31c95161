"""Public kernel wrappers of the port — the entry points the hot path calls
(the paged KV cache today; the compressed ring in the training slice).

Dispatch is by the tensor's device (``kernels/dispatch.py``): the Hopper
kernel for a CUDA tensor, the plain PyTorch version for a CPU tensor.
``quantize_tiles.launches`` counts the kernel's launches (a plain int,
never incremented on the CPU path), so a run can show that its main path
went through the kernel; ``reset_launch_counts`` sets it to 0.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.dispatch import use_kernel
from repro_torch.kernels.quantize import quantize_tiles_cuda

TILE = 8 * 128


def quantize_tiles(x: torch.Tensor, *, tile: int = TILE):
    """Per-tile int8 quantize without error feedback: x flat (n,) f32 or
    bf16 -> (q int8 (n,), scales f32 (ceil(n/tile),))."""
    if use_kernel(x):
        out = quantize_tiles_cuda(x.contiguous(), tile)
        quantize_tiles.launches += 1
        return out
    return _ref.quantize_tiles_ref(x, tile=tile)


quantize_tiles.launches = 0


def dequantize(q: torch.Tensor, scales: torch.Tensor, tile: int = TILE):
    """q int8 (n,), scales (ceil(n/tile),) -> f32 (n,) = q * (s / 127)."""
    return _ref.dequantize_ref(q, scales, tile=tile)


KERNEL_WRAPPERS = {"quantize_tiles": quantize_tiles}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


__all__ = ["quantize_tiles", "dequantize", "launch_counts",
           "reset_launch_counts", "TILE"]
