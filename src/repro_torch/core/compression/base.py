"""Compressor interface (counterpart of ``repro/core/compression/base.py``,
survey §3.2).

A compressor maps a gradient leaf ``g`` to a compact payload and back:

    payload, meta = compress(g, rng)
    g_hat         = decompress(payload, meta)

``payload_bits(shape)`` reports the wire size and ``aggregatable`` says
whether payloads can be summed directly by a reduce collective or must be
gathered and decompressed per rank first.  Every compressor of the JAX
package is registered (``quantization.py``, ``sparsification.py``,
``lowrank.py``, ``fused.py``); the fused ones add the one-pass hooks
``fused_ef_compress`` and ``fused_decode_sum`` that the executor prefers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Compressor:
    name: str
    compress: Callable[..., Tuple[Any, Any]]          # (g, rng) -> (payload, meta)
    decompress: Callable[[Any, Any], torch.Tensor]    # (payload, meta) -> g_hat
    payload_bits: Callable[[Tuple[int, ...]], int]
    aggregatable: bool = False                        # payloads sum correctly
    unbiased: bool = False                            # E[decompress] == g
    # Fused hot-path hooks, wired by the fused compressors only:
    #   fused_ef_compress(g, e, decay) -> (payload, meta, e), the new
    #       residual written into e's buffer
    #   fused_decode_sum(gathered_payload, meta) -> sum over ranks
    # Both are bit-identical (payload and residual) to the decomposed chain.
    fused_ef_compress: Optional[Callable[..., Tuple[Any, Any, Any]]] = None
    fused_decode_sum: Optional[Callable[[Any, Any], torch.Tensor]] = None

    def roundtrip(self, g, rng=None):
        payload, meta = self.compress(g, rng)
        return self.decompress(payload, meta)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def identity_compressor() -> Compressor:
    return Compressor(
        name="none",
        compress=lambda g, rng=None: (g, None),
        decompress=lambda p, m: p,
        payload_bits=lambda shape: _numel(shape) * 32,
        aggregatable=True,
        unbiased=True,
    )


REGISTRY: Dict[str, Callable[..., Compressor]] = {}


def register(name: str):
    def deco(fn):
        REGISTRY[name] = fn
        return fn
    return deco


register("none")(identity_compressor)


def get_compressor(name: str, **kwargs) -> Compressor:
    if name not in REGISTRY:
        raise KeyError(f"unknown compressor {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name](**kwargs)
