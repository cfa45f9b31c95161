"""Wrapper of the Hopper forward attention kernel
(``csrc/flash_attention.cu``), the port of the Pallas kernel
``src/repro/kernels/flash_attention.py:_kernel`` /
``flash_attention_pallas``: GQA, causal or sliding-window masks, optional
logit softcap, online softmax in f32.

The kernel reads q (B, T, H, hd) and k, v (B, S, KV, hd) in place through
their strides (the last dim must be contiguous; a tensor whose last dim is
not is copied once) and writes a new contiguous (B, T, H, hd) output in
q's dtype.  It is built with nvcc on first use (``kernels/build.py``) and
called through a plain C launcher with ctypes, on PyTorch's current
stream, without synchronising.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import launch

MAX_HEAD_DIM = 256
_P, _I64 = ctypes.c_void_p, ctypes.c_int64


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("flash_attention").flash_attention_launch
    fn.argtypes = ([_P] * 4 + [_I64] * 15
                   + [ctypes.c_int, _I64, ctypes.c_double, ctypes.c_int, _P])
    fn.restype = ctypes.c_int
    return fn


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window: Optional[int]) -> None:
    """Raise unless q (B, T, H, hd), k and v (B, S, KV, hd) have one dtype
    and one device, B, T, S >= 1, KV divides H, and ``window`` is None or
    >= 1: what the kernel and its plain version both take."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q (B, T, H, hd) and k, v "
                         f"(B, S, KV, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, hd = q.shape
    Bk, S, KV, hdk = k.shape
    if Bk != B or hdk != hd or min(B, T, S, KV) < 1 or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k, v {tuple(k.shape)} (B, T, S >= 1, H a multiple "
                         f"of KV, same head dim)")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: q, k, v dtypes {q.dtype}, "
                        f"{k.dtype}, {v.dtype} differ")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v lie on different devices")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def _inner_contiguous(x: torch.Tensor) -> torch.Tensor:
    return x if x.stride(-1) == 1 else x.contiguous()


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, window: Optional[int],
                         softcap: Optional[float]) -> torch.Tensor:
    """Launch the kernel on CUDA tensors (f32 or bf16, hd <= 256).
    Returns out (B, T, H, hd) in q's dtype; raises if the launch is
    refused.  The shapes are those :func:`check_args` admits (checked by
    ``ops.flash_attention``)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM}, got {hd}")
    if softcap is not None and not float(softcap) > 0.0:
        raise ValueError(f"softcap must be None or > 0, got {softcap}")
    q, k, v = (_inner_contiguous(x) for x in (q, k, v))
    out = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    launch("flash_attention", _launcher(), q, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), out.data_ptr(), B, T, S, H, KV, hd,
           *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal),
           0 if window is None else int(window),
           0.0 if softcap is None else float(softcap),
           int(q.dtype == torch.bfloat16))
    return out
