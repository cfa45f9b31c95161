"""Chunked, remat-friendly time scans — counterpart of
``repro/models/scan_utils.py``.

A recurrence over T steps is a Python loop here (the reference's
``lax.scan``).  Under autograd a plain loop keeps every step's
intermediates for the backward: for mLSTM's (B, H, dh, dh) matrix memory
at xlstm-125m's width (9.4 MB a step at B = 4) and its ~4 intermediates
that is ~38 MB x T steps x layers, more than the card holds at T = 256.
:func:`chunked_scan` cuts time into chunks of ``chunk`` steps, each under
``torch.utils.checkpoint`` (and each step too, with ``checkpoint_step``),
so the backward keeps T/chunk boundary carries plus one chunk of
recompute, as the reference's nested ``jax.checkpoint`` does.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._tree import tree_leaves, tree_map


def _stack(ys: List[Any]):
    return tree_map(lambda *t: torch.stack(t), *ys)


def _loop(step: Callable, carry, xs, lo: int, hi: int) -> Tuple[Any, Any]:
    """Steps lo … hi-1 in order; returns (carry, ys stacked on axis 0)."""
    ys = []
    for t in range(lo, hi):
        carry, y = step(carry, tree_map(lambda a: a[t], xs))
        ys.append(y)
    return carry, _stack(ys)


_SLOT = object()


def _checkpoint(fn: Callable, *trees):
    """``fn(*trees)`` under a non-reentrant checkpoint, every tensor of
    ``trees`` passed as an argument of its own.  The checkpoint then
    saves them through the saved-tensor hooks, which an enclosing
    checkpoint empties; a tuple argument, or a tensor in the recompute
    function's closure, would be held by reference until the backward
    (every step's carry, for the whole forward).  No RNG state is
    stashed: the scans draw none."""
    leaves = [t for t in tree_leaves(trees) if isinstance(t, torch.Tensor)]
    skeleton = tree_map(lambda t: _SLOT if isinstance(t, torch.Tensor)
                        else t, trees)

    def flat(*ts):
        it = iter(ts)
        return fn(*tree_map(lambda t: next(it) if t is _SLOT else t,
                            skeleton))
    return checkpoint(flat, *leaves, use_reentrant=False,
                      preserve_rng_state=False)


def chunked_scan(step: Callable, init, xs, chunk: int,
                 checkpoint_step: bool = True):
    """``(carry, ys)`` of ``step(carry, x_t) -> (carry, y_t)`` over the
    leading (time) axis of every leaf of ``xs``, as ``lax.scan``.

    Without autograd (no grad mode, or no tensor of ``init`` and ``xs``
    that requires grad: serving) it is one plain loop.  Under autograd,
    when ``chunk`` divides T and is smaller than it, each chunk runs
    under a non-reentrant checkpoint (and each step inside it too with
    ``checkpoint_step``); otherwise one loop of (checkpointed) steps, as
    the reference falls back to one scan for lengths that do not tile."""
    T = tree_leaves(xs)[0].shape[0]
    grad = torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad
        for t in tree_leaves((init, xs)))
    if not grad:
        return _loop(step, init, xs, 0, T)
    body = step
    if checkpoint_step:
        def body(carry, x_t):
            return _checkpoint(step, carry, x_t)
    if chunk >= T or T % chunk:
        return _loop(body, init, xs, 0, T)
    carry, ys = init, []
    for lo in range(0, T, chunk):
        carry, yc = _checkpoint(
            lambda c, x, lo=lo: _loop(body, c, x, lo, lo + chunk), carry, xs)
        ys.append(yc)
    return carry, tree_map(lambda *t: torch.cat(t), *ys)
