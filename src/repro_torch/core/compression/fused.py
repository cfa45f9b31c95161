"""Fused compressed wires backed by the port's Hopper kernels
(counterpart of ``repro/core/compression/fused.py``, DESIGN.md §11).

  * ``int8_fused`` — per-TILE int8 + f32 scales.  Gather-pattern: the
    (q, scales) payload all-gathers and every rank runs ONE fused
    dequantize + accumulate pass over all payloads (``ops.dequant_accum``).
  * ``topk_fused`` — per-tile bisection top-k of the EF-corrected gradient.
    The payload is the masked dense buffer, so it is aggregatable.

The fused hooks and ``compress`` dispatch to ``repro_torch.kernels.ops``
(the CUDA kernels on the card, their plain versions on the CPU):
``fused_ef_compress`` (a bucket with error feedback) writes the new
residual into e's buffer (f32, contiguous) and returns that buffer;
``compress`` (a bucket without error feedback, and the reference chain
the fused hooks are pinned against) is ``ops.quantize_tiles`` or
``ops.topk_mask``, bit-equal on every device to the plain versions in
``kernels/ref.py`` that the reference's jnp lowering mirrors.  The
int8_fused ``decompress`` stays plain PyTorch (``kref.dequantize_ref``):
the executor decodes gathered payloads through ``fused_decode_sum``.
"""
from __future__ import annotations

import torch

from repro_torch.core.compression.base import Compressor, _numel, register
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref


def _flat32(g: torch.Tensor) -> torch.Tensor:
    return g.reshape(-1).to(torch.float32)


@register("int8_fused")
def int8_fused_compressor(tile: int = ops.TILE) -> Compressor:
    """Per-tile int8 against max|corrected| per tile.  Payload
    ``(q int8 (n,), scales f32 (ceil(n/tile),))``; meta is the original
    leaf shape."""
    tile = int(tile)

    def compress(g, rng=None):
        q, scales = ops.quantize_tiles(_flat32(g), tile=tile)
        return (q, scales), tuple(g.shape)

    def decompress(payload, shape):
        q, scales = payload
        return kref.dequantize_ref(q, scales, tile=tile).reshape(shape)

    def fused_ef_compress(g, e, decay):
        e_flat = e.view(-1)
        q, _, scales = ops.quantize_ef(_flat32(g), e_flat, decay=float(decay),
                                       tile=tile, e_out=e_flat)
        return (q, scales), tuple(g.shape), e

    def fused_decode_sum(gathered_payload, shape):
        q, scales = gathered_payload        # (w, n) int8, (w, ntiles) f32
        return ops.dequant_accum(q, scales, tile=tile).reshape(shape)

    def payload_bits(shape):
        n = _numel(shape)
        return n * 8 + 32 * int(-(-n // tile))

    return Compressor("int8_fused", compress, decompress, payload_bits,
                      aggregatable=False, unbiased=False,
                      fused_ef_compress=fused_ef_compress,
                      fused_decode_sum=fused_decode_sum)


@register("topk_fused")
def topk_fused_compressor(ratio: float = 0.01, tile: int = ops.TILE,
                          iters: int = 16) -> Compressor:
    """Per-tile bisection top-k (the topk_mask kernel's semantics, not the
    exact sort oracle).  The payload keeps the kept values dense-in-place,
    so payloads from different ranks sum correctly (aggregatable) while
    ``payload_bits`` reports the survey's (value, index) wire size."""
    ratio, tile, iters = float(ratio), int(tile), int(iters)

    def compress(g, rng=None):
        y = ops.topk_mask(_flat32(g), ratio=ratio, tile=tile, iters=iters)
        return y.reshape(g.shape), None

    def decompress(payload, meta):
        return payload

    def fused_ef_compress(g, e, decay):
        e_flat = e.view(-1)
        y, _ = ops.topk_ef(_flat32(g), e_flat, ratio=ratio, tile=tile,
                           iters=iters, decay=float(decay), e_out=e_flat)
        return y.reshape(g.shape), None, e

    def payload_bits(shape):
        n = _numel(shape)
        k = max(1, int(tile * ratio))
        return min(n, int(-(-n // tile)) * k) * 64   # f32 value + i32 index

    return Compressor("topk_fused", compress, decompress, payload_bits,
                      aggregatable=True, unbiased=False,
                      fused_ef_compress=fused_ef_compress)
