"""Analytic computation-communication overlap model (survey §3.3, Fig. 8);
a copy of ``repro/core/schedule/perf_model.py``, held to it by
``tests/test_torch_planner.py``.

Back-propagation produces per-layer gradients last-layer-first; each layer's
communication can start once its gradient exists (WFBP, Poseidon).  Given
per-layer backward times ``t_b[l]`` and communication times ``t_c[l]`` (from
the α-β model), this module computes the iteration time of:

  * ``fifo``     — serial: all backward, then all communication
  * ``wfbp``     — wait-free BP: comm of layer l starts at max(ready, link free)
  * ``mg_wfbp``  — WFBP with merged (fused) gradients [Shi et al. 2019]:
                   merging removes per-message latency α when a merge lets a
                   transfer be hidden (the survey's Fig. 8 Case 3 fix)
  * ``p3``       — priority-based propagation [Jayarajan et al. 2019]:
                   tensors are sliced and the *first* layers get priority, so
                   the forward pass of the next iteration can start earliest.

These are simulators (the scheduling insight), not XLA passes — on TPU the
XLA latency-hiding scheduler performs the overlap; the knob our runtime
actually owns is the fusion granularity (``grad_sync.bucketize``), whose
effect this model predicts (see benchmarks/bench_overlap.py).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class LayerProfile:
    """Backward compute time and gradient size of one layer (index 0 = input
    layer; backward runs from the last layer to the first)."""
    t_backward_s: float
    grad_bytes: float


def comm_time(nbytes: float, alpha: float, beta: float) -> float:
    return alpha + nbytes * beta


def iteration_time_fifo(layers: Sequence[LayerProfile], alpha: float,
                        beta: float) -> float:
    tb = sum(l.t_backward_s for l in layers)
    tc = sum(comm_time(l.grad_bytes, alpha, beta) for l in layers)
    return tb + tc


def iteration_time_wfbp(layers: Sequence[LayerProfile], alpha: float,
                        beta: float) -> float:
    """Comm of layer l (produced in order L-1 .. 0) starts when its gradient
    is ready and the link is free; iteration ends when all comms finish."""
    order = list(range(len(layers)))[::-1]
    t = 0.0
    link_free = 0.0
    for l in order:
        t += layers[l].t_backward_s            # gradient ready
        start = max(t, link_free)
        link_free = start + comm_time(layers[l].grad_bytes, alpha, beta)
    return max(t, link_free)


def iteration_time_mg_wfbp(layers: Sequence[LayerProfile], alpha: float,
                           beta: float, bucket_bytes: float) -> float:
    """Merge consecutive gradients into buckets of ``bucket_bytes`` before
    sending — one α per bucket instead of one per layer."""
    order = list(range(len(layers)))[::-1]
    t = 0.0
    link_free = 0.0
    pending = 0.0
    for j, l in enumerate(order):
        t += layers[l].t_backward_s
        pending += layers[l].grad_bytes
        last = j == len(order) - 1
        if pending >= bucket_bytes or last:
            start = max(t, link_free)
            link_free = start + comm_time(pending, alpha, beta)
            pending = 0.0
    return max(t, link_free)


def iteration_time_p3(layers: Sequence[LayerProfile], alpha: float,
                      beta: float, slice_bytes: float) -> float:
    """P3: slice every gradient into ``slice_bytes`` pieces; at each link-free
    instant send the READY slice with the highest priority (layer 0 highest).
    Returns time until layer 0's gradient (needed first by the next forward)
    has fully arrived — P3's target metric — plus remaining drain time."""
    order = list(range(len(layers)))[::-1]
    ready: List[Tuple[int, float]] = []   # (priority=layer index, bytes remaining)
    t = 0.0
    link_free = 0.0
    finish = 0.0
    for l in order:
        t += layers[l].t_backward_s
        ready.append((l, layers[l].grad_bytes))
        ready.sort(key=lambda x: x[0])     # low layer index = high priority
        # drain slices that fit before the next gradient is produced
        while ready and link_free < t:
            pr, rem = ready[0]
            chunk = min(slice_bytes, rem)
            start = max(link_free, t - layers[l].t_backward_s)
            link_free = start + comm_time(chunk, alpha, beta)
            rem -= chunk
            if rem <= 0:
                ready.pop(0)
            else:
                ready[0] = (pr, rem)
    # drain the rest after backward completes
    while ready:
        pr, rem = ready.pop(0)
        link_free = max(link_free, t) + comm_time(rem, alpha, beta)
    return max(t, link_free)


def iteration_time_tic(layers: Sequence[LayerProfile], alpha: float,
                       beta: float) -> float:
    """TIC (Timing-Independent Communication, Hashemi et al. 2018): order
    transfers purely by DAG position — earliest-needed-next-iteration first
    (== layer index ascending), ignoring produce times; transfers wait for
    readiness."""
    ready_at = {}
    t = 0.0
    for l in reversed(range(len(layers))):      # backward produces L-1..0
        t += layers[l].t_backward_s
        ready_at[l] = t
    link_free = 0.0
    for l in range(len(layers)):                # send layer 0 first
        start = max(ready_at[l], link_free)
        link_free = start + comm_time(layers[l].grad_bytes, alpha, beta)
    return max(t, link_free)


def iteration_time_tac(layers: Sequence[LayerProfile], alpha: float,
                       beta: float) -> float:
    """TAC (Timing-Aware Communication): like TIC but a transfer is only
    preferred if its directly-dependent compute (the next forward's use)
    cannot already be covered; approximated as shortest-remaining-compute
    first among ready transfers."""
    ready_at = sorted((sum(layers[j].t_backward_s
                           for j in range(l, len(layers))), l)
                      for l in range(len(layers)))
    link_free = 0.0
    t_total = sum(l.t_backward_s for l in layers)
    # process in order of readiness; among ready, prefer small comm first
    pending = sorted(ready_at)
    link_free = 0.0
    for ready, l in pending:
        start = max(ready, link_free)
        link_free = start + comm_time(layers[l].grad_bytes, alpha, beta)
    return max(t_total, link_free)


def wfbp_case(layers: Sequence[LayerProfile], alpha: float, beta: float) -> int:
    """Classify into the survey's Fig. 8 cases: 1 = comm fully hidden,
    2 = partially hidden, 3 = comm dominates (merging needed)."""
    tb = sum(l.t_backward_s for l in layers)
    tc = sum(comm_time(l.grad_bytes, alpha, beta) for l in layers)
    wfbp = iteration_time_wfbp(layers, alpha, beta)
    if wfbp <= tb * 1.01:
        return 1
    if wfbp < tb + tc * 0.5:
        return 2
    return 3
