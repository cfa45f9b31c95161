"""Sharded (ZeRO-style) optimizer states: init/update over partitioned flat
buckets (DESIGN.md §8) — the port of ``repro/optim/sharded.py``.

In sharded-DP mode the optimizer runs on per-bucket SHARDS — each rank
updates only the (m,) slice of master params and moments it owns — so the
state trees here are lists of flat buffers, one per plan bucket, not
leaf-shaped trees.

  * ``adam`` / ``sgd`` are elementwise: the registered replicated update
    applied to shard rows is bit-identical to the replicated update
    restricted to the shard, so they delegate straight to
    ``make_optimizer`` (this is what makes sharded mode bit-compatible
    with replicated DP for dense f32), and :func:`apply_rows_inplace` may
    run them over a row in chunks;
  * ``lamb`` / ``lars`` are layerwise: the trust ratio needs per-LAYER
    norms, which one shard only partially sees.  Their sharded variants
    segment-sum partial squared norms per leaf (the layout's leaf
    segment ids; padding slots map to a dropped sentinel segment) and sum
    the small (2, n_leaves) table over the data axes with one
    ``all_reduce`` per step — the standard ZeRO-LAMB construction.

Moments are updated in place, as in the replicated optimizers.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.core.collectives import allreduce
from repro_torch.core.collectives.api import Axes, as_axes
from repro_torch.core.collectives.p2p import axis_index
from repro_torch.optim.adam import _f32
from repro_torch.optim.base import (CHUNK, ELEMENTWISE, Optimizer, Schedule,
                                    make_optimizer, resolve_lr, step_inplace)


def make_sharded_optimizer(name: str, layout, axes: Axes = None,
                           **kwargs) -> Optimizer:
    """Optimizer over per-bucket shard lists for ``layout``.  ``axes`` are
    the data axes the rows are partitioned over (process groups; used
    only by the layerwise optimizers' norm reduction)."""
    if name in ELEMENTWISE:
        return make_optimizer(name, **kwargs)
    if name == "lamb":
        return _sharded_lamb(layout, as_axes(axes), **kwargs)
    if name == "lars":
        return _sharded_lars(layout, as_axes(axes), **kwargs)
    raise KeyError(f"no sharded variant for optimizer {name!r}; known: "
                   f"{ELEMENTWISE + ('lamb', 'lars')}")


def apply_rows_inplace(optimizer: Optimizer, masters: List[torch.Tensor],
                       grads: List[torch.Tensor],
                       opt_state: Dict[str, List[torch.Tensor]], step: int,
                       chunk: int = CHUNK) -> None:
    """``updates, state = optimizer.update(...)``, then ``masters +=
    updates``, writing the new masters and moments into their rows in
    place.  An elementwise optimizer runs row by row through
    ``step_inplace`` (in chunks of a row, bit-equal to the whole row), so
    a bucket-wide f32 temporary never exists; a layerwise one updates
    every row at once (its trust ratios need every row's norms)."""
    if optimizer.name in ELEMENTWISE:
        step_inplace(optimizer, masters, grads, opt_state, step, chunk)
        return
    with torch.no_grad():
        updates, _ = optimizer.update(grads, opt_state, masters, step)
        for m, u in zip(masters, updates):
            m.add_(u)


def _my_segments(layout, axes) -> List[torch.Tensor]:
    """Per-bucket (m,) leaf-segment ids of THIS rank's shard, derived from
    the static per-bucket leaf offsets (O(m) arange + a leaf-count-sized
    table per bucket; ``layout.seg_rows`` stays the host-side reference
    the tests compare against).

    Under nested chunking the canonical chunk at mesh position (i1, i2,
    ...) covers a CONTIGUOUS flat range: the global position of slot k is
    Σ_l i_l·m_l + k, and the slot is real (not padding) iff its offset at
    every nesting level stays inside that level's parent length.  ``i_l``
    is this rank's index in the group of axis l (``p2p.axis_index``)."""
    from repro_torch.core.shard_state import nested_ms
    segs = []
    for b in layout.buckets:
        ms = nested_ms(b.n, layout.axis_sizes)
        lens = [b.n] + ms[:-1]          # parent length per nesting level
        pos = torch.arange(ms[-1], dtype=torch.int64)
        ok = torch.ones((ms[-1],), dtype=torch.bool)
        for ax, m, ln in zip(reversed(axes), reversed(ms), reversed(lens)):
            pos = axis_index(ax) * m + pos
            ok = ok & (pos < ln)
        starts = torch.from_numpy(
            np.cumsum([0] + list(b.sizes))[:-1].astype(np.int64))
        ids = torch.tensor(b.leaves, dtype=torch.int64)
        at = torch.searchsorted(starts, pos.clamp(0, b.n - 1),
                                right=True) - 1
        segs.append(torch.where(ok, ids[at],
                                torch.tensor(layout.n_leaves)))
    return segs


def _segment_sq(x: torch.Tensor, seg: torch.Tensor, L: int) -> torch.Tensor:
    """(L + 1,) sums of x² per segment id (the last: padding)."""
    out = torch.zeros((L + 1,), dtype=torch.float32, device=x.device)
    return out.index_add_(0, seg, torch.square(x))


def _reduce_norms(w_sq: torch.Tensor, o_sq: torch.Tensor, axes):
    """Sum both (L,) partial squared-norm tables over the data axes in ONE
    all-reduce."""
    both = torch.stack([w_sq, o_sq])
    both = allreduce(both, "psum", axes)
    return both[0], both[1]


def _sharded_lamb(layout, axes: Sequence, lr: Schedule = 1e-3,
                  b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                  weight_decay: float = 0.01) -> Optimizer:
    L = layout.n_leaves

    def init(shards):
        def z(s):
            return torch.zeros(s.shape, dtype=torch.float32, device=s.device)
        return {"m": [z(s) for s in shards], "v": [z(s) for s in shards]}

    def update(grads, state, params, step):
        eta = resolve_lr(lr, step)
        # the bias corrections in f32, as the reference computes them
        t = _f32(step) + 1.0
        c1 = float(1.0 - _f32(b1) ** t)
        c2 = float(1.0 - _f32(b2) ** t)
        dev = params[0].device if params else torch.device("cpu")
        segs = [s.to(dev) for s in _my_segments(layout, axes)]
        rs = []
        w_sq = torch.zeros((L + 1,), dtype=torch.float32, device=dev)
        r_sq = torch.zeros((L + 1,), dtype=torch.float32, device=dev)
        for g, m, v, p, seg in zip(grads, state["m"], state["v"], params,
                                   segs):
            g = g.to(torch.float32)
            pf = p.to(torch.float32)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            r = (m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * pf
            w_sq += _segment_sq(pf, seg, L)
            r_sq += _segment_sq(r, seg, L)
            rs.append(r)
        w_sq, r_sq = _reduce_norms(w_sq[:L], r_sq[:L], axes)
        w_norm, r_norm = torch.sqrt(w_sq), torch.sqrt(r_sq)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        trust = torch.cat([trust, torch.ones((1,), device=dev)])
        return [-eta * trust[seg] * r for seg, r in zip(segs, rs)], state

    return Optimizer("lamb", init, update)


def _sharded_lars(layout, axes: Sequence, lr: Schedule = 1.0,
                  momentum: float = 0.9, weight_decay: float = 1e-4,
                  trust_coef: float = 0.001, eps: float = 1e-9) -> Optimizer:
    L = layout.n_leaves

    def init(shards):
        return {"mu": [torch.zeros(s.shape, dtype=torch.float32,
                                   device=s.device) for s in shards]}

    def update(grads, state, params, step):
        eta = resolve_lr(lr, step)
        dev = params[0].device if params else torch.device("cpu")
        segs = [s.to(dev) for s in _my_segments(layout, axes)]
        gs = []
        w_sq = torch.zeros((L + 1,), dtype=torch.float32, device=dev)
        g_sq = torch.zeros((L + 1,), dtype=torch.float32, device=dev)
        for g, p, seg in zip(grads, params, segs):
            pf = p.to(torch.float32)
            g = g.to(torch.float32) + weight_decay * pf
            w_sq += _segment_sq(pf, seg, L)
            g_sq += _segment_sq(g, seg, L)
            gs.append(g)
        w_sq, g_sq = _reduce_norms(w_sq[:L], g_sq[:L], axes)
        w_norm, g_norm = torch.sqrt(w_sq), torch.sqrt(g_sq)
        trust = torch.where((w_norm > 0) & (g_norm > 0),
                            trust_coef * w_norm / (g_norm + eps),
                            torch.ones_like(w_norm))
        trust = torch.cat([trust, torch.ones((1,), device=dev)])
        for mu, seg, g in zip(state["mu"], segs, gs):
            mu.mul_(momentum).add_(eta * trust[seg] * g)
        return [-mu for mu in state["mu"]], state

    return Optimizer("lars", init, update)


__all__ = ["ELEMENTWISE", "make_sharded_optimizer", "apply_rows_inplace"]
