"""Adam / AdamW (counterpart of ``repro/optim/adam.py``)."""
from __future__ import annotations

import torch

from repro_torch._tree import tree_map
from repro_torch.optim.base import Optimizer, Schedule, register, resolve_lr


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


@register("adam")
def adam(lr: Schedule = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                    device=p.device), params),
                "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                    device=p.device), params)}

    def update(grads, state, params, step):
        eta = resolve_lr(lr, step)
        # the bias corrections in f32, as the reference computes them
        t = _f32(step) + 1.0
        c1 = float(1.0 - _f32(b1) ** t)
        c2 = float(1.0 - _f32(b2) ** t)

        def upd(g, m, v, p):
            g = g.to(torch.float32)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            d = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                d = d + weight_decay * p.to(torch.float32)
            return -eta * d

        updates = tree_map(upd, grads, state["m"], state["v"], params)
        return updates, state

    return Optimizer("adam", init, update)
