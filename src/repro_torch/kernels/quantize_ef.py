"""Wrappers of the Hopper int8_fused wire kernels (``csrc/quantize_ef.cu``):
``quantize_ef`` (the port of the Pallas kernel
``src/repro/kernels/quantize_ef.py:_kernel`` / ``quantize_ef_pallas``) and
``dequant_accum`` (the port of ``_accum_kernel`` / ``dequant_accum_pallas``).

``dequant_accum`` has two kernels, chosen from the tile alone
(``dispatch.tile_route``): the warp route (one warp per tile, the sums in
registers) for tiles of up to 1024 elements, which the training wire
takes, and the block route (one thread block per tile) for 1025 to 8192.
The library is built with nvcc on first use (``kernels/build.py``) and
called through plain C launchers with ctypes.  Each launch runs on
PyTorch's current stream and does not synchronise; outputs are allocated
here with ``torch.empty``, apart from the new EF residual, which the caller
may have written into its old buffer.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import (launch, require_flat_cuda,
                                          tile_route)

MAX_TILE = 8192         # the tile's f32 values stay within 32 KB of shared memory
MAX_RANKS = 1024

_P, _I64 = ctypes.c_void_p, ctypes.c_int64


@functools.lru_cache(maxsize=None)
def _launchers():
    """(quantize_ef's launcher, {route: dequant_accum's launcher}), built
    and loaded on first use."""
    lib = build.load("quantize_ef")
    qef = lib.quantize_ef_launch
    qef.argtypes = [_P, _P, _P, _P, _P, _I64, _I64, ctypes.c_float, _P]
    qef.restype = ctypes.c_int
    acc = {}
    for route in ("warp", "block"):
        fn = getattr(lib, f"dequant_accum_{route}_launch")
        fn.argtypes = [_P, _P, _P, _I64, _I64, _I64, _P]
        fn.restype = ctypes.c_int
        acc[route] = fn
    return qef, acc


def _check_tile(tile: int) -> int:
    tile = int(tile)
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(f"tile must be in [1, {MAX_TILE}], got {tile}")
    return tile


def check_residual_pair(g: torch.Tensor, e: torch.Tensor,
                        e_out: Optional[torch.Tensor], name: str):
    """Flat contiguous f32 CUDA tensors g, e (and e_out, when given) of one
    length on one device; returns the buffer the new residual goes to
    (``e_out``, which may be ``e`` itself, or a new tensor)."""
    for t in (g, e) if e_out is None else (g, e, e_out):
        require_flat_cuda(t, name, (torch.float32,))
        if t.shape != g.shape or t.device != g.device:
            raise ValueError(f"{name}: g {tuple(g.shape)} on {g.device} and "
                             f"{tuple(t.shape)} on {t.device} must match")
    if e_out is None:
        return torch.empty_like(g)
    if e_out.data_ptr() != e.data_ptr() and \
            abs(e_out.data_ptr() - e.data_ptr()) < 4 * e.numel():
        raise ValueError(f"{name}: e_out must be e itself or not overlap it")
    return e_out


def quantize_ef_cuda(g: torch.Tensor, e: torch.Tensor, decay: float,
                     tile: int, e_out: Optional[torch.Tensor] = None):
    """Launch quantize_ef on flat contiguous f32 CUDA tensors g, e of equal
    length; the new residual is written to ``e_out`` (which may be ``e``)
    or to a new tensor.  Returns (q int8 (n,), e_new f32 (n,), scales f32
    (ceil(n/tile),))."""
    e_new = check_residual_pair(g, e, e_out, "quantize_ef")
    tile = _check_tile(tile)
    n = g.shape[0]
    q = torch.empty(n, dtype=torch.int8, device=g.device)
    scales = torch.empty(-(-n // tile), dtype=torch.float32, device=g.device)
    if n == 0:
        return q, e_new, scales
    launch("quantize_ef", _launchers()[0], g, g.data_ptr(), e.data_ptr(),
           q.data_ptr(), e_new.data_ptr(), scales.data_ptr(), n, tile,
           float(decay))
    return q, e_new, scales


def dequant_accum_cuda(q: torch.Tensor, scales: torch.Tensor, tile: int):
    """Launch dequant_accum (the kernel of ``tile_route(tile)``) on
    contiguous CUDA tensors q (w, n) int8 and scales (w, ceil(n/tile))
    f32.  Returns the (n,) f32 sum over ranks."""
    if q.device.type != "cuda" or scales.device != q.device:
        raise ValueError(f"dequant_accum kernel needs q and scales on one "
                         f"CUDA device, got {q.device} and {scales.device}")
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"dequant_accum kernel takes int8 q and float32 "
                        f"scales, got {q.dtype} and {scales.dtype}")
    if q.ndim != 2 or not (q.is_contiguous() and scales.is_contiguous()):
        raise ValueError(f"dequant_accum kernel takes contiguous (w, n) q, "
                         f"got shape {tuple(q.shape)}")
    tile = _check_tile(tile)
    w, n = q.shape
    if tuple(scales.shape) != (w, -(-n // tile)):
        raise ValueError(f"dequant_accum: scales {tuple(scales.shape)} != "
                         f"{(w, -(-n // tile))}")
    if not 1 <= w <= MAX_RANKS:
        raise ValueError(f"dequant_accum takes 1 to {MAX_RANKS} ranks, got {w}")
    out = torch.empty(n, dtype=torch.float32, device=q.device)
    if n == 0:
        return out
    launch("dequant_accum", _launchers()[1][tile_route(tile)], q,
           q.data_ptr(), scales.data_ptr(), out.data_ptr(), n, w, tile)
    return out
