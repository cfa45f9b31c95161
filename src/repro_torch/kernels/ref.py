"""Plain PyTorch versions of the port's kernels.

Each function repeats the op sequence of its counterpart in
``src/repro/kernels/ref.py`` so that the two are bit-equal on the CPU, and
each CUDA kernel is held bit-equal to it on the card.  Ragged lengths
follow the pad-and-slice contract: zero-pad to the tile boundary, compute
per tile, slice back to ``n`` (zeros cannot raise a tile's max|x|).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

TILE = 8 * 128


def _pad_blocks(x: torch.Tensor, tile: int) -> torch.Tensor:
    """Zero-pad a flat tensor to the tile boundary and reshape to
    (ntiles, tile) f32 blocks."""
    n = x.shape[0]
    m = -(-n // tile) * tile
    x = x.to(torch.float32)
    if m != n:
        x = F.pad(x, (0, m - n))
    return x.reshape(m // tile, tile)


def quantize_tiles_ref(x: torch.Tensor, *, tile: int = TILE):
    """Per-tile int8 quantization: ``s = max(max|x|, 1e-30)``,
    ``q = clip(round((x / s) * 127), ±127)`` with round-half-to-even.
    x: flat (n,) f32 or bf16.  Returns (q int8 (n,), scales f32
    (ceil(n/tile),))."""
    n = x.shape[0]
    blocks = _pad_blocks(x, tile)
    scales = torch.clamp_min(blocks.abs().amax(dim=1), 1e-30)
    q = torch.clamp(torch.round(blocks / scales[:, None] * 127.0), -127, 127)
    return q.reshape(-1)[:n].to(torch.int8), scales


def dequantize_ref(q: torch.Tensor, scales: torch.Tensor, *,
                   tile: int = TILE) -> torch.Tensor:
    """Inverse of :func:`quantize_tiles_ref` (error at most scale/254 per
    element).  ``s / 127`` is formed first, as in the reference:
    ``scales * q / 127`` would not give the same bits."""
    n = q.shape[0]
    s = torch.repeat_interleave(scales, tile)[:n]
    return q.to(torch.float32) * (s / 127.0)
