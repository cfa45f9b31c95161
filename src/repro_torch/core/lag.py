"""LAG — Lazily Aggregated Gradients (survey §3.1.2; Chen et al. 2018), the
port of ``repro/core/lag.py``.

Workers reuse the last synchronized gradient when their local gradient has
not changed enough to justify a communication round:

    skip if ||g_t - g_last||^2 <= threshold * ||g_t||^2

The decision is made on the host: a probe computes the global trigger
(two scalars summed over the group), and the session dispatches either the
synced step or the reuse step.  Rounds actually used are counted, as in the
paper's linear-regression experiment.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch._tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class LAGConfig:
    threshold: float = 0.1     # relative change that forces a sync
    check_every: int = 1


def init_lag_state(grads):
    return {"g_last": tree_map(lambda g: torch.zeros(
                g.shape, dtype=torch.float32, device=g.device), grads),
            "rounds": 0}


def change_and_scale(grads, g_last):
    """(||g - g_last||², ||g||²) as f32 scalars on the gradients' device,
    summed leaf by leaf."""
    delta = scale = None
    for g, last in zip(tree_leaves(grads), tree_leaves(g_last)):
        g = g.to(torch.float32)
        d, s = torch.sum(torch.square(g - last)), torch.sum(torch.square(g))
        delta = d if delta is None else delta + d
        scale = s if scale is None else scale + s
    return delta, scale


def lag_trigger(grads, g_last, threshold: float) -> bool:
    """True -> the change is large, communicate this round."""
    delta, scale = change_and_scale(grads, g_last)
    return bool(delta > threshold * scale)


def lag_update_state(state, grads, synced: bool):
    """After a synced round: ``g_last`` takes the synchronized gradient (in
    f32, written into the state's buffers in place: at full width a second
    f32 copy would not fit beside the first) and ``rounds`` counts it."""
    if synced:
        with torch.no_grad():
            g_last = tree_map(lambda old, g: old.copy_(g), state["g_last"],
                              grads)
        return {"g_last": g_last, "rounds": state["rounds"] + 1}
    return state
