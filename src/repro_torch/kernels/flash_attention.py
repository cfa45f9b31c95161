"""Wrappers of the Hopper forward attention kernels, the port of the Pallas
kernel ``src/repro/kernels/flash_attention.py:_kernel`` /
``flash_attention_pallas``: GQA, causal or sliding-window masks, optional
logit softcap, online softmax in f32.

Two routes, chosen by :func:`route` from the dtype and head dim alone:

  * ``wgmma`` (``csrc/flash_attention_wgmma.cu``): bf16 at a head dim in
    ``WGMMA_HEAD_DIMS`` (192 is MLA's q/k head dim, with v zero-padded to
    it by the caller), both products on the tensor cores, K/V tiles fed
    by TMA.  It reads q, k, v through TMA tensor maps, which take a
    contiguous last dim, 16-byte aligned bases and strides that are
    multiples of 16 bytes (:func:`tma_ready`); a tensor that fails is
    copied once into a new contiguous buffer.
  * ``simt`` (``csrc/flash_attention.cu``): f32, and bf16 at other head
    dims (<= 256), on the CUDA cores; it takes any strides with a
    contiguous last dim.

Both first run the pre-pass :func:`nonfinite_tiles_cuda` over v (which key
tiles, and which head dims of them, hold an inf or a NaN), which keeps
their skipping of fully-masked key tiles exact: the reference visits every
tile, so a non-finite v at a masked position makes the row's output NaN.
The attention kernels are launched as programmatic dependents of the
pre-pass: they start while it runs and wait for it only in their
epilogue.

Each writes a new contiguous (B, T, H, hd) output in q's dtype.  The
kernels are built with nvcc on first use (``kernels/build.py``) and called
through plain C launchers with ctypes, on PyTorch's current stream,
without synchronising.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import launch

MAX_HEAD_DIM = 256
WGMMA_HEAD_DIMS = (32, 64, 128, 192, 256)
WGMMA_ROWS = 64          # query rows per consumer warpgroup
KV_TILE = 64             # keys per tile, both kernels
_P, _I64 = ctypes.c_void_p, ctypes.c_int64


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that takes attention of this dtype and head dim:
    ``"wgmma"`` for bf16 at a head dim in ``WGMMA_HEAD_DIMS``, ``"simt"``
    otherwise (f32 keeps full f32 products; TF32 would break its
    tolerance)."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def consumers(B: int, T: int, H: int, sm_count: int) -> int:
    """Consumer warpgroups per block of the wgmma kernel: 2 (128 query
    rows sharing each K/V tile) when that still gives every SM a block,
    else 1 (64 rows, twice the blocks, for short prompts)."""
    tiles = -(-T // (2 * WGMMA_ROWS))
    return 2 if B * H * tiles >= sm_count else 1


def tma_ready(x: torch.Tensor) -> bool:
    """Can a TMA tensor map read ``x`` in place: last dim contiguous, base
    16-byte aligned, every other stride positive and a multiple of 16
    bytes?"""
    size = x.element_size()
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(st > 0 and (st * size) % 16 == 0
                    for st in x.stride()[:-1]))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _launcher(name: str):
    if name == "tiles":
        fn = build.load("flash_attention").nonfinite_tiles_launch
        fn.argtypes = [_P, _P] + [_I64] * 7 + [ctypes.c_int, _P]
    else:
        lib = build.load("flash_attention_wgmma" if name == "wgmma"
                         else "flash_attention")
        fn = (lib.flash_wgmma_launch if name == "wgmma"
              else lib.flash_attention_launch)
        fn.argtypes = ([_P] * 5 + [_I64] * 15
                       + [ctypes.c_int, _I64, ctypes.c_double, ctypes.c_int,
                          _P])
    fn.restype = ctypes.c_int
    return fn


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window: Optional[int]) -> None:
    """Raise unless q (B, T, H, hd), k and v (B, S, KV, hd) have one dtype
    and one device, B, T, S >= 1, KV divides H, and ``window`` is None or
    >= 1: what the kernels and their plain version all take."""
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


def check_cuda(q: torch.Tensor, softcap: Optional[float]) -> None:
    """Raise unless q lies on the card in a dtype and at a head dim that
    one of the kernels takes, and ``softcap`` is None or > 0."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM}, got {q.shape[-1]}")
    if softcap is not None and not float(softcap) > 0.0:
        raise ValueError(f"softcap must be None or > 0, got {softcap}")


def nonfinite_tiles_cuda(v: torch.Tensor) -> torch.Tensor:
    """The pre-pass: for v (B, S, KV, hd) on the card (f32 or bf16), which
    64-key tiles of each (b, kv head) hold a non-finite value, and at which
    head dims, as int32, laid out as ``csrc/flash_common.cuh`` says and as
    ``ref.nonfinite_tiles_ref`` computes it."""
    check_cuda(v, None)
    if v.stride(-1) != 1:
        v = v.contiguous()
    B, S, KV, hd = v.shape
    tiles = torch.empty(nonfinite_tiles_entries(B, S, KV, hd),
                        dtype=torch.int32, device=v.device)
    launch("nonfinite_tiles", _launcher("tiles"), v, v.data_ptr(),
           tiles.data_ptr(), B, S, KV, hd, *v.stride()[:3],
           int(v.dtype == torch.bfloat16))
    return tiles


def nonfinite_tiles_entries(B: int, S: int, KV: int, hd: int) -> int:
    """int32 entries of the pre-pass's output: a flag and ceil(hd / 32)
    words of head-dim bits per (key tile, b, kv head)."""
    return -(-S // KV_TILE) * B * KV * (1 + -(-hd // 32))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         tiles: torch.Tensor, causal: bool,
                         window: Optional[int], softcap: Optional[float],
                         kernel: str) -> torch.Tensor:
    """Launch the attention kernel ``kernel`` on CUDA tensors: "wgmma"
    for what :func:`route` sends there, "simt" for every dtype and head
    dim the wrapper admits (``ops.flash_attention`` passes ``route(q.dtype,
    hd)``).  ``tiles`` is :func:`nonfinite_tiles_cuda` of this v, launched
    just before on the same stream.  Returns out (B, T, H, hd) in q's
    dtype; raises if the launch is refused.  The shapes are those
    :func:`check_args` admits (checked by ``ops.flash_attention``)."""
    check_cuda(q, softcap)
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    if kernel == "wgmma":
        if route(q.dtype, hd) != "wgmma":
            raise ValueError(f"the wgmma kernel takes bf16 at head dims "
                             f"{WGMMA_HEAD_DIMS}, got {q.dtype}, {hd}")
        q, k, v = (x if tma_ready(x)
                   else x.clone(memory_format=torch.contiguous_format)
                   for x in (q, k, v))
        index = q.device.index
        last = consumers(B, T, H, _sm_count(
            torch.cuda.current_device() if index is None else index))
    elif kernel == "simt":
        q, k, v = (x if x.stride(-1) == 1 else x.contiguous()
                   for x in (q, k, v))
        last = int(q.dtype == torch.bfloat16)
    else:
        raise ValueError(f"no flash attention kernel {kernel!r}")
    out = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    launch(f"flash_attention ({kernel})", _launcher(kernel), q, q.data_ptr(),
           k.data_ptr(), v.data_ptr(), out.data_ptr(), tiles.data_ptr(),
           B, T, S, H, KV, hd,
           *(st for x in (q, k, v) for st in x.stride()[:3]), int(causal),
           0 if window is None else int(window),
           0.0 if softcap is None else float(softcap), last)
    return out
