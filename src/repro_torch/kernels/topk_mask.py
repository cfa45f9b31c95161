"""Wrappers of the Hopper bisection top-k kernels (``csrc/topk_mask.cu``):
``topk_ef`` (the port of the Pallas kernel
``src/repro/kernels/topk_mask.py:_ef_kernel`` / ``topk_ef_pallas``, the
topk_fused wire) and ``topk_mask`` (the port of ``_kernel`` /
``topk_mask_pallas``).  Both share the bisection of ``_bisect_threshold``.

The caller passes ``k = max(1, int(tile * ratio))`` computed as the
reference does.  Each has two kernels, chosen from the tile alone
(``dispatch.tile_route``): the warp route (one warp per tile, the tile in
registers) for tiles of up to 1024 elements, which the training wire
takes, and the block route (one thread block per tile) for 1025 to 8192.
The library is built with nvcc on first use (``kernels/build.py``) and
called through plain C launchers with ctypes, on PyTorch's current
stream, without synchronising.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import (launch, require_flat_cuda,
                                          tile_route)
from repro_torch.kernels.quantize_ef import _check_tile, check_residual_pair

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
MAX_ITERS = 64


@functools.lru_cache(maxsize=None)
def _launchers():
    """{kernel: {route: launcher}} for topk_ef and topk_mask, built and
    loaded on first use."""
    lib = build.load("topk_mask")
    argtypes = {"topk_ef": [_P, _P, _P, _P, _I64, _I64, _I64, _I64,
                            ctypes.c_float, _P],
                "topk_mask": [_P, _P, _I64, _I64, _I64, _I64, ctypes.c_int,
                              _P]}
    out = {}
    for kernel, types in argtypes.items():
        out[kernel] = {}
        for route in ("warp", "block"):
            fn = getattr(lib, f"{kernel}_{route}_launch")
            fn.argtypes = types
            fn.restype = ctypes.c_int
            out[kernel][route] = fn
    return out


def _check_k_iters(k: int, iters: int):
    k, iters = int(k), int(iters)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if not 0 <= iters <= MAX_ITERS:
        raise ValueError(f"iters must be in [0, {MAX_ITERS}], got {iters}")
    return k, iters


def topk_ef_cuda(g: torch.Tensor, e: torch.Tensor, k: int, tile: int,
                 iters: int, decay: float,
                 e_out: Optional[torch.Tensor] = None):
    """Launch topk_ef (the kernel of ``tile_route(tile)``) on flat
    contiguous f32 CUDA tensors g, e of equal length; the new residual is
    written to ``e_out`` (which may be ``e``) or to a new tensor.  Returns
    (y f32 (n,), e_new f32 (n,))."""
    e_new = check_residual_pair(g, e, e_out, "topk_ef")
    tile = _check_tile(tile)
    k, iters = _check_k_iters(k, iters)
    n = g.shape[0]
    y = torch.empty(n, dtype=torch.float32, device=g.device)
    if n == 0:
        return y, e_new
    launch("topk_ef", _launchers()["topk_ef"][tile_route(tile)], g,
           g.data_ptr(), e.data_ptr(), y.data_ptr(), e_new.data_ptr(), n,
           tile, k, iters, float(decay))
    return y, e_new


def topk_mask_cuda(x: torch.Tensor, k: int, tile: int, iters: int):
    """Launch topk_mask (the kernel of ``tile_route(tile)``) on a flat
    contiguous CUDA tensor (f32 or bf16).  Returns the masked tensor in x's
    dtype."""
    require_flat_cuda(x, "topk_mask", (torch.float32, torch.bfloat16))
    tile = _check_tile(tile)
    k, iters = _check_k_iters(k, iters)
    n = x.shape[0]
    y = torch.empty_like(x)
    if n == 0:
        return y
    launch("topk_mask", _launchers()["topk_mask"][tile_route(tile)], x,
           x.data_ptr(), y.data_ptr(), n, tile, k, iters,
           int(x.dtype == torch.bfloat16))
    return y
