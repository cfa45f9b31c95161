"""Quantization compressors (counterpart of
``repro/core/compression/quantization.py``, survey §3.2.1).

  * ``sign``      — 1-bit signSGD with a per-tensor mean |g| [Bernstein et
                    al. 2018; Seide et al. 2014].  Biased; pair with error
                    feedback.
  * ``terngrad``  — stochastic ternary {-1, 0, +1} · max|g| [Wen et al.
                    2017].  Unbiased.
  * ``qsgd``      — stochastic s-level quantization against the per-tensor
                    L2 norm [Alistarh et al. 2017].  Unbiased.
  * ``int8``      — deterministic linear int8 against max|g|.

Payloads are int8; ``payload_bits`` reports the true wire width.  The
stochastic rounding of terngrad and qsgd draws through :func:`bernoulli`
from an explicit ``torch.Generator`` (the one place a draw happens, so a
test can hand it other draws).  Divisions by a constant divide by a
tensor, so they round the same on the card as on the CPU.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.compression.base import Compressor, _numel, register
from repro_torch.kernels.ref import _to_int8


def bernoulli(p: torch.Tensor, rng: Optional[torch.Generator]) -> torch.Tensor:
    """True with probability ``p`` per element: ``uniform[0, 1) < p``, as
    ``jax.random.bernoulli`` draws it."""
    if rng is None:
        raise ValueError("a stochastic compressor needs a torch.Generator")
    u = torch.rand(p.shape, generator=rng, device=rng.device,
                   dtype=torch.float32).to(p.device)
    return u < p


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as one IEEE division on any device."""
    return x / torch.full_like(x, c)


def _l2(g: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.square(g.to(torch.float32))))


@register("sign")
def sign_compressor(scale_mode: str = "mean_abs") -> Compressor:
    """1-bit sign quantization with the per-tensor mean |g| (the EF-signSGD
    convention)."""

    def compress(g, rng=None):
        scale = torch.mean(torch.abs(g.to(torch.float32)))
        return torch.sign(g).to(torch.int8), scale

    def decompress(payload, scale):
        return payload.to(torch.float32) * scale

    return Compressor("sign", compress, decompress,
                      payload_bits=lambda shape: _numel(shape) * 1 + 32,
                      aggregatable=False, unbiased=False)


@register("terngrad")
def terngrad_compressor() -> Compressor:
    """g_hat = s * sign(g) ∘ b,  b ~ Bernoulli(|g| / s),  s = max|g|."""

    def compress(g, rng=None):
        gf = g.to(torch.float32)
        s = torch.max(torch.abs(gf))
        p = torch.where(s > 0, torch.abs(gf) / s, 0.0)
        b = bernoulli(p, rng).to(torch.int8)
        return torch.sign(gf).to(torch.int8) * b, s

    def decompress(payload, s):
        return payload.to(torch.float32) * s

    return Compressor(
        "terngrad", compress, decompress,
        payload_bits=lambda shape: int(math.ceil(_numel(shape)
                                                 * math.log2(3))) + 32,
        aggregatable=True, unbiased=True)


@register("qsgd")
def qsgd_compressor(levels: int = 127) -> Compressor:
    """Stochastic uniform quantization to ``levels`` positive levels (plus
    sign and zero) against the per-tensor L2 norm; levels=127 fits int8."""
    if not 1 <= levels <= 127:
        raise ValueError(f"qsgd levels must be in [1, 127], got {levels}")

    def compress(g, rng=None):
        gf = g.to(torch.float32)
        norm = _l2(gf)
        x = torch.where(norm > 0, torch.abs(gf) / norm * levels, 0.0)
        lo = torch.floor(x)
        up = bernoulli(x - lo, rng).to(torch.float32)
        q = (lo + up) * torch.sign(gf)
        return q.to(torch.int8), norm

    def decompress(payload, norm):
        return payload.to(torch.float32) * _div(norm, levels)

    bits = int(math.ceil(math.log2(2 * levels + 1)))
    return Compressor("qsgd", compress, decompress,
                      payload_bits=lambda shape: _numel(shape) * bits + 32,
                      aggregatable=True, unbiased=True)


@register("int8")
def int8_compressor() -> Compressor:
    """Deterministic linear int8 against max|g| (biased, tiny bias)."""

    def compress(g, rng=None):
        gf = g.to(torch.float32)
        s = torch.clamp_min(torch.max(torch.abs(gf)), 1e-30)
        q = torch.clamp(torch.round(gf / s * 127.0), -127, 127)
        return _to_int8(q), s

    def decompress(payload, s):
        return payload.to(torch.float32) * _div(s, 127.0)

    return Compressor("int8", compress, decompress,
                      payload_bits=lambda shape: _numel(shape) * 8 + 32,
                      aggregatable=True, unbiased=False)
