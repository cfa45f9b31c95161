"""Sparsification compressors (counterpart of
``repro/core/compression/sparsification.py``, survey §3.2.2).

  * ``topk``      — the k largest-|g| entries [Aji & Heafield 2017; DGC].
  * ``randomk``   — k uniformly random entries amplified by d/k, unbiased
                    [Wangni et al. 2018]; the indices are drawn through
                    :func:`choice` from an explicit ``torch.Generator``.
  * ``threshold`` — static threshold [Strom 2015], zeroed in place.

Payloads are (values, int32 indices) pairs; ``payload_bits`` counts 32
bits each.  ``topk`` ranks by a stable descending sort, so equal
magnitudes keep the lower index first, as ``jax.lax.top_k`` does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.compression.base import Compressor, _numel, register


def choice(d: int, k: int, rng: Optional[torch.Generator]) -> torch.Tensor:
    """k distinct indices of range(d), uniformly at random."""
    if rng is None:
        raise ValueError("a stochastic compressor needs a torch.Generator")
    return torch.randperm(d, generator=rng, device=rng.device)[:k]


def _scatter(payload, shape) -> torch.Tensor:
    vals, idx = payload
    out = torch.zeros(_numel(shape), dtype=torch.float32, device=vals.device)
    out[idx.long()] = vals
    return out.reshape(shape)


@register("topk")
def topk_compressor(ratio: float = 0.01, k: int = 0) -> Compressor:
    """Keep the k = max(1, ratio·d) largest-magnitude entries."""

    def _k(d):
        return k if k else max(1, int(d * ratio))

    def compress(g, rng=None):
        flat = g.to(torch.float32).reshape(-1)
        idx = torch.sort(torch.abs(flat), descending=True,
                         stable=True).indices[:_k(flat.shape[0])]
        return (flat[idx], idx.to(torch.int32)), tuple(g.shape)

    return Compressor("topk", compress, _scatter,
                      lambda shape: _k(_numel(shape)) * 64,
                      aggregatable=False, unbiased=False)


@register("randomk")
def randomk_compressor(ratio: float = 0.01) -> Compressor:
    """Random-k with d/k amplification (unbiased)."""

    def compress(g, rng=None):
        flat = g.to(torch.float32).reshape(-1)
        d = flat.shape[0]
        kk = max(1, int(d * ratio))
        idx = choice(d, kk, rng).to(flat.device)
        return (flat[idx] * (d / kk), idx.to(torch.int32)), tuple(g.shape)

    return Compressor("randomk", compress, _scatter,
                      lambda shape: max(1, int(_numel(shape) * ratio)) * 64,
                      aggregatable=False, unbiased=True)


@register("threshold")
def threshold_compressor(tau: float = 1e-3) -> Compressor:
    """Static threshold: entries with |g| >= tau are kept in place, the
    rest zeroed (``payload_bits`` reports the worst case d)."""

    def compress(g, rng=None):
        gf = g.to(torch.float32)
        return torch.where(torch.abs(gf) >= tau, gf, 0.0), None

    return Compressor("threshold", compress, lambda payload, meta: payload,
                      payload_bits=lambda shape: _numel(shape) * 64,
                      aggregatable=True, unbiased=False)
