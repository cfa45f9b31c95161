"""Wrapper of the Hopper per-tile int8 quantize kernel
(``csrc/quantize_tiles.cu``), the port of the Pallas kernel
``src/repro/kernels/quantize_ef.py:_q_kernel`` / ``quantize_pallas``.

Two kernels, chosen from the tile alone (``dispatch.tile_route``): the
warp route (one warp per tile, the tile in registers) for tiles of up to
1024 elements, which every serving write takes, and the block route (one
thread block per tile) above.  The library is built with nvcc on first
use (``kernels/build.py``) and called through plain C launchers with
ctypes.  It launches on PyTorch's
current stream and does not synchronise.  ``dequantize`` is plain tensor
code in the JAX package too (``quantize_ef.py:dequantize``), so it stays a
plain PyTorch function here (``ref.dequantize_ref``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import (launch, require_flat_cuda,
                                          tile_route)


@functools.lru_cache(maxsize=None)
def _launcher(route: str):
    """The C launcher of ``route``, built and loaded on first use, with its
    signature declared (pointers and the stream as void*, so none is cut
    to 32 bits)."""
    fn = getattr(build.load("quantize_tiles"),
                 f"quantize_tiles_{route}_launch")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def quantize_tiles_cuda(x: torch.Tensor, tile: int):
    """Launch the kernel of ``tile_route(tile)`` on a flat contiguous CUDA
    tensor (f32 or bf16).  Returns (q int8 (n,), scales f32
    (ceil(n/tile),)); raises if the launch is refused."""
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
    launch("quantize_tiles", _launcher(tile_route(tile)), x, x.data_ptr(),
           q.data_ptr(), scales.data_ptr(), n, tile,
           int(x.dtype == torch.bfloat16))
    return q, scales
