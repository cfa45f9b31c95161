"""Low-rank decomposition compressors (counterpart of
``repro/core/compression/lowrank.py``, survey §3.2.3).

  * ``powersgd`` — rank-r power iteration [Vogels et al. 2019]:
                   P = orthonormalize(M Q);  Q = M^T P.  The factors are
                   linear in M, hence aggregatable; the warm start Q and
                   the error buffer live in ``PlanExecutor``'s state, and
                   a cold start draws Q through :func:`normal` from an
                   explicit ``torch.Generator``.
  * ``svd``      — exact truncated SVD, the ATOMO-style oracle [Wang et
                   al. 2018].

Non-matrix leaves are reshaped to one row (the executor sends them dense).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.compression.base import Compressor, _numel, register


def normal(shape: Tuple[int, ...], rng: Optional[torch.Generator],
           device=None) -> torch.Tensor:
    """Standard normal f32 draws of ``shape`` on ``device``."""
    if rng is None:
        raise ValueError("a PowerSGD cold start needs a torch.Generator")
    return torch.randn(shape, generator=rng, device=rng.device,
                       dtype=torch.float32).to(device or rng.device)


def _as_matrix(g: torch.Tensor):
    shape = tuple(g.shape)
    if g.ndim < 2:
        return g.reshape(1, -1), shape
    return g.reshape(shape[0], -1), shape


def _bits(rank: int):
    def bits(shape):
        if len(shape) < 2:
            return _numel(shape) * 32
        n, d = shape[0], _numel(shape[1:])
        return (n + d) * min(rank, n, d) * 32
    return bits


@register("powersgd")
def powersgd_compressor(rank: int = 4) -> Compressor:
    """One power iteration per step; meta carries the new Q."""

    def compress(g, rng=None, q_prev: Optional[torch.Tensor] = None):
        m, shape = _as_matrix(g.to(torch.float32))
        n, d = m.shape
        if q_prev is None:
            q_prev = normal((d, min(rank, n, d)), rng, m.device)
        p = torch.linalg.qr(m @ q_prev).Q        # (n, r)
        q = m.T @ p                               # (d, r)
        return (p, q), (shape, q)

    def decompress(payload, meta):
        p, q = payload
        return (p @ q.T).reshape(meta[0])

    return Compressor("powersgd", compress, decompress, _bits(rank),
                      aggregatable=True, unbiased=False)


@register("svd")
def svd_compressor(rank: int = 4) -> Compressor:
    """Exact truncated SVD (the ATOMO reference oracle)."""

    def compress(g, rng=None):
        m, shape = _as_matrix(g.to(torch.float32))
        u, s, vt = torch.linalg.svd(m, full_matrices=False)
        r = min(rank, s.shape[0])
        return (u[:, :r] * s[:r], vt[:r]), shape

    def decompress(payload, shape):
        us, vt = payload
        return (us @ vt).reshape(shape)

    return Compressor("svd", compress, decompress, _bits(rank),
                      aggregatable=False, unbiased=False)
