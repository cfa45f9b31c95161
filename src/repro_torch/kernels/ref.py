"""Plain PyTorch versions of the port's kernels.

Each function repeats the op sequence of its counterpart in
``src/repro/kernels/ref.py`` so that the two are bit-equal on the CPU, and
each CUDA kernel is held bit-equal to it on the card.  Ragged lengths
follow the pad-and-slice contract: zero-pad to the tile boundary, compute
per tile, slice back to ``n`` (zeros cannot raise a tile's max|x| and
cannot pass a positive bisection threshold).

The exception is :func:`flash_attention_ref`, the plain version of the
attention kernel: its sums run in another order than the kernel's, so the
two are held within a stated tolerance, not bit for bit.

Two rules keep the bits equal on every device:

  * ``s / 127`` divides by a tensor (:func:`_div127`): on CUDA, PyTorch
    turns a division by a Python scalar into a multiplication by its
    reciprocal, which can differ from the reference in the last bit;
  * a NaN is stored as int8 0 (:func:`_to_int8`), as XLA converts it (the
    C cast PyTorch uses leaves NaN undefined).  A NaN anywhere in a tile
    propagates into its scale (``amax``), as ``jnp.max`` does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

TILE = 8 * 128
NEG_INF = -1e30
FLASH_Q_CHUNK = 1024   # query rows per step of flash_attention_ref


def _pad_blocks(x: torch.Tensor, tile: int) -> torch.Tensor:
    """Zero-pad a flat tensor to the tile boundary and reshape to
    (ntiles, tile) f32 blocks."""
    n = x.shape[0]
    m = -(-n // tile) * tile
    x = x.to(torch.float32)
    if m != n:
        x = F.pad(x, (0, m - n))
    return x.reshape(m // tile, tile)


def _div127(s: torch.Tensor) -> torch.Tensor:
    """``s / 127`` as one IEEE division per element on any device."""
    return s / torch.full_like(s, 127.0)


def _to_int8(q: torch.Tensor) -> torch.Tensor:
    """The int8 store of clipped quantized values; NaN becomes 0."""
    return torch.where(torch.isnan(q), 0.0, q).to(torch.int8)


def _tile_scales(blocks: torch.Tensor) -> torch.Tensor:
    """``max(max|x|, 1e-30)`` per tile row; a NaN propagates."""
    return torch.clamp_min(blocks.abs().amax(dim=1), 1e-30)


def _quantize_blocks(blocks: torch.Tensor, scales: torch.Tensor):
    """``clip(round((x / s) * 127), ±127)`` in f32 (NaN stays NaN)."""
    return torch.clamp(torch.round(blocks / scales[:, None] * 127.0),
                       -127, 127)


def quantize_tiles_ref(x: torch.Tensor, *, tile: int = TILE):
    """Per-tile int8 quantization: ``s = max(max|x|, 1e-30)``,
    ``q = clip(round((x / s) * 127), ±127)`` with round-half-to-even.
    x: flat (n,) f32 or bf16.  Returns (q int8 (n,), scales f32
    (ceil(n/tile),))."""
    n = x.shape[0]
    blocks = _pad_blocks(x, tile)
    scales = _tile_scales(blocks)
    q = _quantize_blocks(blocks, scales)
    return _to_int8(q).reshape(-1)[:n], scales


def dequantize_ref(q: torch.Tensor, scales: torch.Tensor, *,
                   tile: int = TILE) -> torch.Tensor:
    """Inverse of :func:`quantize_tiles_ref` (error at most scale/254 per
    element).  ``s / 127`` is formed first, as in the reference:
    ``scales * q / 127`` would not give the same bits."""
    n = q.shape[0]
    s = torch.repeat_interleave(_div127(scales), tile)[:n]
    return q.to(torch.float32) * s


def quantize_ef_ref(g: torch.Tensor, e: torch.Tensor, *, decay: float = 1.0,
                    tile: int = TILE):
    """Per-tile error feedback + int8 quantization (the quantize_ef
    kernel's op sequence): ``c = g + decay·e``, ``s = max(max|c|, 1e-30)``,
    ``q = clip(round((c / s) * 127), ±127)``, ``e_new = c − q·(s/127)``.
    g, e: flat (n,) f32.  Returns (q int8 (n,), e_new f32 (n,), scales f32
    (ceil(n/tile),))."""
    n = g.shape[0]
    blocks = _pad_blocks(g, tile) + decay * _pad_blocks(e, tile)
    scales = _tile_scales(blocks)
    q = _quantize_blocks(blocks, scales)
    e_new = blocks - q * _div127(scales)[:, None]
    return (_to_int8(q).reshape(-1)[:n], e_new.reshape(-1)[:n], scales)


def dequant_accum_ref(q: torch.Tensor, scales: torch.Tensor, *,
                      tile: int = TILE) -> torch.Tensor:
    """The dequant_accum kernel's op sequence: q (w, n) int8 payloads,
    scales (w, ceil(n/tile)) -> the (n,) f32 sum over ranks of
    ``q[r]·(s[r]/127)``, added in rank order 0 … w−1 (an explicit loop:
    ``sum(dim=0)`` does not fix its order)."""
    w, n = q.shape
    factors = _div127(scales)
    out = None
    for r in range(w):
        term = q[r].to(torch.float32) * torch.repeat_interleave(
            factors[r], tile)[:n]
        out = term if out is None else out + term
    return out


def _bisect_threshold(ax: torch.Tensor, k: int, iters: int) -> torch.Tensor:
    """The topk kernels' bisection per tile row of ``ax`` (= |x|):
    ``mid = 0.5·(lo+hi)``; more than k entries ``>= mid`` raise lo, else
    lower hi.  Returns hi per row (NaN for a row holding a NaN)."""
    hi = ax.amax(dim=1)
    lo = torch.zeros_like(hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        more = (ax >= mid[:, None]).sum(dim=1) > k
        lo = torch.where(more, mid, lo)
        hi = torch.where(more, hi, mid)
    return hi


def topk_mask_bisect_ref(x: torch.Tensor, *, ratio: float = 0.01,
                         tile: int = TILE, iters: int = 16) -> torch.Tensor:
    """The topk_mask KERNEL's bisection semantics: x with all but about
    ``k = max(1, int(tile·ratio))`` entries per tile zeroed, in x's dtype
    (distinct from :func:`topk_mask_ref`, the exact oracle)."""
    n = x.shape[0]
    k = max(1, int(tile * ratio))
    blocks = _pad_blocks(x, tile)
    ax = blocks.abs()
    hi = _bisect_threshold(ax, k, iters)
    y = torch.where(ax >= hi[:, None], blocks, 0.0)
    return y.reshape(-1)[:n].to(x.dtype)


def topk_ef_ref(g: torch.Tensor, e: torch.Tensor, *, ratio: float = 0.01,
                tile: int = TILE, iters: int = 16, decay: float = 1.0):
    """The fused topk_ef kernel's op sequence: EF add + bisection mask +
    residual.  Returns (y (n,), e_new (n,)) f32 with y + e_new ==
    g + decay·e."""
    n = g.shape[0]
    k = max(1, int(tile * ratio))
    blocks = _pad_blocks(g, tile) + decay * _pad_blocks(e, tile)
    ax = blocks.abs()
    keep = ax >= _bisect_threshold(ax, k, iters)[:, None]
    y = torch.where(keep, blocks, 0.0)
    e_new = torch.where(keep, 0.0, blocks)
    return y.reshape(-1)[:n], e_new.reshape(-1)[:n]


def topk_mask_ref(x: torch.Tensor, *, ratio: float = 0.01,
                  tile: int = TILE) -> torch.Tensor:
    """EXACT per-tile top-k oracle (the bisection approximates it): keep
    ``|x| >= `` the k-th largest |x| of the tile."""
    n = x.shape[0]
    k = max(1, int(tile * ratio))
    blocks = _pad_blocks(x, tile)
    ax = blocks.abs()
    thresh = torch.sort(ax, dim=1).values[:, -k]
    y = torch.where(ax >= thresh[:, None], blocks, 0.0)
    return y.reshape(-1)[:n].to(x.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """Plain attention with the flash kernel's arithmetic over one key tile
    that holds every key: q (B, T, H, hd), k/v (B, S, KV, hd), H = KV·G,
    query head h reads KV head h // G.  Scores ``(q·k)·(1/sqrt(hd))`` in
    f32, optional ``softcap·tanh(s/softcap)``, masked to -1e30 (causal:
    key <= query; window w: query − key < w, and key − query < w when not
    causal), ``p = exp(s − max s)``, ``l = Σ p``, ``out = (p rounded to v's
    dtype)·v / max(l, 1e-30)`` cast to q's dtype — the port of
    ``repro/kernels/ref.py:flash_attention_ref`` (the reference's
    ``attention_reference``) with the kernel's rounding of p.  A row with
    no valid key gets the mean of v, as in the reference.  Query rows are
    independent, so they are computed ``FLASH_Q_CHUNK`` at a time to bound
    the (T, S) score memory."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    f32 = torch.float32
    scale = 1.0 / math.sqrt(hd)
    kf = k.to(f32)
    vf = v.to(f32)
    k_pos = torch.arange(S, device=q.device)
    outs = []
    for t0 in range(0, T, FLASH_Q_CHUNK):
        qc = q[:, t0:t0 + FLASH_Q_CHUNK].to(f32)
        tc = qc.shape[1]
        s = torch.einsum("btkgh,bskh->bkgts", qc.reshape(B, tc, KV, G, hd),
                         kf) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        q_pos = t0 + torch.arange(tc, device=q.device)
        mask = torch.ones((tc, S), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
            if not causal:
                mask &= (k_pos[None, :] - q_pos[:, None]) < window
        s = torch.where(mask, s, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1)                                  # (B, KV, G, tc)
        acc = torch.einsum("bkgts,bskh->btkgh", p.to(v.dtype).to(f32), vf)
        denom = torch.clamp_min(l, 1e-30).permute(0, 3, 1, 2)[..., None]
        outs.append((acc / denom).to(q.dtype).reshape(B, tc, H, hd))
    return torch.cat(outs, dim=1)


def nonfinite_tiles_ref(v: torch.Tensor, *, tile: int = 64) -> torch.Tensor:
    """Plain version of the flash kernels' pre-pass: for v (B, S, KV, hd),
    with nt = ceil(S / tile) key tiles, int32 holding first a flag per
    (key tile, b·KV + kv head), 1 where that tile of v holds a non-finite
    value, then ceil(hd / 32) words per (key tile, b·KV + kv head) whose
    bit i of word w is set where head dim 32·w + i does."""
    B, S, KV, hd = v.shape
    nt, nw = -(-S // tile), -(-hd // 32)
    bad = (~torch.isfinite(v)).to(torch.int64)
    bad = F.pad(bad, (0, 0, 0, 0, 0, nt * tile - S))
    per = bad.reshape(B, nt, tile, KV, hd).amax(dim=2)      # (B, nt, KV, hd)
    per = per.permute(1, 0, 2, 3).reshape(nt, B * KV, hd)
    flags = per.amax(dim=-1)
    bits = F.pad(per, (0, nw * 32 - hd)).reshape(nt, B * KV, nw, 32)
    words = (bits << torch.arange(32, device=v.device)).sum(dim=-1)
    words = torch.where(words >= 2**31, words - 2**32, words)  # as uint32
    return torch.cat([flags.reshape(-1), words.reshape(-1)]).to(torch.int32)
