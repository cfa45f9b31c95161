"""Public kernel wrappers of the port — the entry points the hot path calls
(the prefill attention of every layer; the paged KV cache; the int8_fused
and topk_fused wires of the training step).

Dispatch is by the tensor's device (``kernels/dispatch.py``): the Hopper
kernel for a CUDA tensor, the plain PyTorch version for a CPU tensor.
Each wrapper's ``launches`` attribute counts its kernel's launches (a plain
int, never incremented on the CPU path), so a run can show that its main
path went through the kernel; the ``routes`` of ``flash_attention``
(wgmma / SIMT) and of the per-tile wrappers ``quantize_tiles``,
``dequant_accum``, ``topk_ef`` and ``topk_mask`` (warp / block) split that
count by kernel (``route_counts``); ``reset_launch_counts`` sets them all
to 0.  Under ``launch/op_analysis.count`` each wrapper's call is counted
once, by a formula of its arguments' shapes, with the counting of the ops
inside it suspended (``op_analysis.kernel_call``).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.dispatch import TILE_ROUTES, tile_route, use_kernel
from repro_torch.kernels.flash_attention import (check_args, check_cuda,
                                                 flash_attention_cuda,
                                                 nonfinite_tiles_cuda, route)
from repro_torch.kernels.quantize import quantize_tiles_cuda
from repro_torch.kernels.quantize_ef import (dequant_accum_cuda,
                                             quantize_ef_cuda)
from repro_torch.kernels.topk_mask import topk_ef_cuda, topk_mask_cuda
from repro_torch.launch.op_analysis import kernel_call

TILE = 8 * 128


def _counted(fn):
    """One op-analysis kernel call per call of the wrapper ``fn``."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with kernel_call(fn.__name__, *args) as box:
            out = fn(*args, **kwargs)
            box.append(out)
        return out
    return wrapper


def _topk_k(ratio: float, tile: int) -> int:
    """Entries kept per tile, computed as the reference does."""
    return max(1, int(tile * ratio))


@_counted
def quantize_tiles(x: torch.Tensor, *, tile: int = TILE):
    """Per-tile int8 quantize without error feedback: x flat (n,) f32 or
    bf16 -> (q int8 (n,), scales f32 (ceil(n/tile),))."""
    if use_kernel(x):
        out = quantize_tiles_cuda(x.contiguous(), tile)
        quantize_tiles.launches += 1
        quantize_tiles.routes[tile_route(tile)] += 1
        return out
    return _ref.quantize_tiles_ref(x, tile=tile)


def dequantize(q: torch.Tensor, scales: torch.Tensor, tile: int = TILE):
    """q int8 (n,), scales (ceil(n/tile),) -> f32 (n,) = q * (s / 127)."""
    return _ref.dequantize_ref(q, scales, tile=tile)


def _into(e_out: Optional[torch.Tensor], e_new: torch.Tensor):
    """The plain versions' new residual, written into ``e_out`` if given."""
    return e_new if e_out is None else e_out.copy_(e_new)


@_counted
def quantize_ef(g: torch.Tensor, e: torch.Tensor, *, decay: float = 1.0,
                tile: int = TILE, e_out: Optional[torch.Tensor] = None):
    """Fused EF + per-tile int8 quantize of flat f32 g, e:
    (q int8 (n,), e_new f32 (n,), scales f32 (ceil(n/tile),)).  With
    ``e_out`` (flat contiguous f32, may be ``e`` itself) the new residual
    is written there and returned as e_new."""
    if use_kernel(g):
        out = quantize_ef_cuda(g.contiguous(), e.contiguous(), decay, tile,
                               e_out)
        quantize_ef.launches += 1
        return out
    q, e_new, scales = _ref.quantize_ef_ref(g, e, decay=decay, tile=tile)
    return q, _into(e_out, e_new), scales


@_counted
def dequant_accum(q: torch.Tensor, scales: torch.Tensor, *, tile: int = TILE):
    """Fused dequantize + accumulate of gathered payloads: q (w, n) int8,
    scales (w, ceil(n/tile)) -> (n,) f32 sum over ranks in rank order."""
    if use_kernel(q):
        out = dequant_accum_cuda(q.contiguous(), scales.contiguous(), tile)
        dequant_accum.launches += 1
        dequant_accum.routes[tile_route(tile)] += 1
        return out
    return _ref.dequant_accum_ref(q, scales, tile=tile)


@_counted
def topk_ef(g: torch.Tensor, e: torch.Tensor, *, ratio: float = 0.01,
            tile: int = TILE, iters: int = 16, decay: float = 1.0,
            e_out: Optional[torch.Tensor] = None):
    """Fused EF + per-tile bisection top-k + residual of flat f32 g, e:
    (y, e_new) with y + e_new = g + decay·e; ``e_out`` as in
    :func:`quantize_ef`."""
    if use_kernel(g):
        out = topk_ef_cuda(g.contiguous(), e.contiguous(),
                           _topk_k(ratio, tile), tile, iters, decay, e_out)
        topk_ef.launches += 1
        topk_ef.routes[tile_route(tile)] += 1
        return out
    y, e_new = _ref.topk_ef_ref(g, e, ratio=ratio, tile=tile, iters=iters,
                                decay=decay)
    return y, _into(e_out, e_new)


@_counted
def topk_mask(x: torch.Tensor, *, ratio: float = 0.01, tile: int = TILE,
              iters: int = 16):
    """Per-tile bisection top-k mask (no EF) of flat f32 or bf16 x."""
    if use_kernel(x):
        out = topk_mask_cuda(x.contiguous(), _topk_k(ratio, tile), tile,
                             iters)
        topk_mask.launches += 1
        topk_mask.routes[tile_route(tile)] += 1
        return out
    return _ref.topk_mask_bisect_ref(x, ratio=ratio, tile=tile, iters=iters)


@_counted
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Forward attention: q (B, T, H, hd), k and v (B, S, KV, hd) with
    H = KV·G (query head h reads KV head h // G), query and key positions
    counted from 0, causal and/or sliding-window mask, optional logit
    softcap.  Returns (B, T, H, hd) in q's dtype.  No gradient: the
    training path keeps ``models/attention.flash_attention``."""
    check_args(q, k, v, window)
    if use_kernel(q):
        check_cuda(q, softcap)
        kernel = route(q.dtype, q.shape[-1])
        out = flash_attention_cuda(q, k, v, nonfinite_tiles(v), causal,
                                   window, softcap, kernel)
        flash_attention.launches += 1
        flash_attention.routes[kernel] += 1
        return out
    return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                    softcap=softcap)


@_counted
def nonfinite_tiles(v: torch.Tensor) -> torch.Tensor:
    """The flash kernels' pre-pass: which 64-key tiles of v (B, S, KV, hd)
    hold a non-finite value, per (b, kv head), and at which head dims, as
    int32 (layout in ``csrc/flash_common.cuh``)."""
    if use_kernel(v):
        out = nonfinite_tiles_cuda(v)
        nonfinite_tiles.launches += 1
        return out
    return _ref.nonfinite_tiles_ref(v)


KERNEL_WRAPPERS = {"flash_attention": flash_attention,
                   "nonfinite_tiles": nonfinite_tiles,
                   "quantize_tiles": quantize_tiles,
                   "quantize_ef": quantize_ef,
                   "dequant_accum": dequant_accum,
                   "topk_ef": topk_ef,
                   "topk_mask": topk_mask}

KERNEL_ROUTES = {"flash_attention": ("wgmma", "simt"),
                 "quantize_tiles": TILE_ROUTES,
                 "dequant_accum": TILE_ROUTES,
                 "topk_ef": TILE_ROUTES,
                 "topk_mask": TILE_ROUTES}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def route_counts() -> Dict[str, Dict[str, int]]:
    """Launches per kernel route of each wrapper that has routes:
    ``{"flash_attention": {"wgmma": n, "simt": n}, "quantize_tiles":
    {"warp": n, "block": n}, "dequant_accum": {...}, "topk_ef": {...},
    "topk_mask": {...}}``."""
    return {name: dict(KERNEL_WRAPPERS[name].routes) for name in KERNEL_ROUTES}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
    for name, routes in KERNEL_ROUTES.items():
        KERNEL_WRAPPERS[name].routes = dict.fromkeys(routes, 0)


reset_launch_counts()


__all__ = ["flash_attention", "nonfinite_tiles", "quantize_tiles",
           "dequantize", "quantize_ef", "dequant_accum", "topk_ef",
           "topk_mask", "launch_counts", "route_counts",
           "reset_launch_counts", "TILE"]
