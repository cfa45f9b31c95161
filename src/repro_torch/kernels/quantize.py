"""Wrapper of the Hopper per-tile int8 quantize kernel
(``csrc/quantize_tiles.cu``), the port of the Pallas kernel
``src/repro/kernels/quantize_ef.py:_q_kernel`` / ``quantize_pallas``.

The kernel is built with nvcc on first use (``kernels/build.py``) and
called through a plain C launcher with ctypes.  It launches on PyTorch's
current stream and does not synchronise.  ``dequantize`` is plain tensor
code in the JAX package too (``quantize_ef.py:dequantize``), so it stays a
plain PyTorch function here (``ref.dequantize_ref``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import launch, require_flat_cuda


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C launcher, built and loaded on first use, with its signature
    declared (pointers and the stream as void*, so none is cut to 32 bits)."""
    fn = build.load("quantize_tiles").quantize_tiles_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def quantize_tiles_cuda(x: torch.Tensor, tile: int):
    """Launch the kernel on a flat contiguous CUDA tensor (f32 or bf16).
    Returns (q int8 (n,), scales f32 (ceil(n/tile),)); raises if the
    launch is refused."""
    require_flat_cuda(x, "quantize_tiles", (torch.float32, torch.bfloat16))
    tile = int(tile)
    if not 1 <= tile <= 1 << 30:
        raise ValueError(f"tile must be in [1, 2**30], got {tile}")
    n = x.shape[0]
    ntiles = -(-n // tile)
    q = torch.empty(n, dtype=torch.int8, device=x.device)
    scales = torch.empty(ntiles, dtype=torch.float32, device=x.device)
    if n == 0:
        return q, scales
    launch("quantize_tiles", _launcher(), x, x.data_ptr(), q.data_ptr(),
           scales.data_ptr(), n, tile, int(x.dtype == torch.bfloat16))
    return q, scales
