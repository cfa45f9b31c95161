"""Compressed ring allreduce (counterpart of
``repro/core/collectives/ring_fused.py``; survey §4.1 × §3.2, DESIGN.md
§11).

The two-phase ring of ``ring.py``, but every hop's payload is per-tile
int8 + f32 scales (``ops.quantize_tiles``, the CUDA kernel on the card,
its plain version on the CPU), with the partial sums requantized at each
reduce-scatter hop:

  reduce-scatter, step s:  quantize own outgoing chunk -> permute the
                           (q, scales) payload -> dequantize + add
  all-gather:              quantize the completed chunk once; circulate
                           the int8 payload p-1 hops; every rank (the
                           owner included) dequantizes the same payload,
                           so all ranks reconstruct identical values.

The flat buffer splits into ``streams`` sub-buffers at
``round(n·i/streams)`` (Python's round, halves to even), each padded to p
chunks; every stream's encode of a step is issued before any stream's
receive is used, the reference's double-buffered schedule.  Each chunk
handed to the kernel is a contiguous row of its stream's (p, m) buffer;
m = ceil(part/p) is seldom a multiple of 4, so a row may start off a
16-byte boundary, which the kernel takes with scalar loads.

Lossy: the per-hop requantization error of partial sums is uncorrected
(error feedback in the executor corrects the sender's first quantization
only).
"""
from __future__ import annotations

import torch

from repro_torch.core.collectives.p2p import (Axis, axis_index, axis_size,
                                              permute)
from repro_torch.core.collectives.ring import pad_chunks, ring_perm
from repro_torch.kernels import ops


def ring_fused_allreduce(x: torch.Tensor, axis: Axis, *, tile: int = ops.TILE,
                         streams: int = 2) -> torch.Tensor:
    """Allreduce of ``x`` over one axis on the compressed ring.  Returns
    the (lossy) sum, identical on every rank, in x's dtype."""
    p = axis_size(axis)
    if p == 1:
        return x
    flat = x.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    r = axis_index(axis)
    perm = ring_perm(p)

    bounds = [round(n * i / streams) for i in range(streams + 1)]
    spans = [(bounds[i], bounds[i + 1]) for i in range(streams)
             if bounds[i + 1] > bounds[i]]
    accs = [pad_chunks(flat[lo:hi], p)[0] for lo, hi in spans]

    # phase 1: reduce-scatter on the int8 wire
    for s in range(p - 1):
        sends = [ops.quantize_tiles(a[(r - s) % p], tile=tile) for a in accs]
        for a, (q, sc) in zip(accs, sends):
            recv = ops.dequantize(permute(q, perm, axis),
                                  permute(sc, perm, axis), tile=tile)
            a[(r - s - 1) % p] += recv

    # phase 2: all-gather of the quantized completed chunks (rank r owns
    # chunk (r+1) % p); the owner decodes its own payload too
    cur = [ops.quantize_tiles(a[(r + 1) % p], tile=tile) for a in accs]
    ms = [a.shape[1] for a in accs]
    del accs
    out = torch.empty(n, dtype=torch.float32, device=flat.device)

    def put(t: int, idx: int, q, sc) -> None:
        lo = spans[t][0] + idx * ms[t]
        hi = min(lo + ms[t], spans[t][1])
        if hi > lo:
            out[lo:hi] = ops.dequantize(q, sc, tile=tile)[:hi - lo]

    idx = (r + 1) % p
    for t, (q, sc) in enumerate(cur):
        put(t, idx, q, sc)
    for _ in range(p - 1):
        cur = [(permute(q, perm, axis), permute(sc, perm, axis))
               for q, sc in cur]
        idx = (idx - 1) % p
        for t, (q, sc) in enumerate(cur):
            put(t, idx, q, sc)
    return out.reshape(x.shape).to(x.dtype)
