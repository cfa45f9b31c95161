"""LAMB (counterpart of ``repro/optim/lamb.py``; survey §3.1.1; You et al.
2020): the Adam direction with a per-layer trust ratio ||w|| / ||r||.
The moments are updated in place, as in ``adam.py``."""
from __future__ import annotations

import torch

from repro_torch._tree import tree_map
from repro_torch.optim.adam import _f32
from repro_torch.optim.base import Optimizer, Schedule, register, resolve_lr


@register("lamb")
def lamb(lr: Schedule = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-6, weight_decay: float = 0.01) -> Optimizer:
    def init(params):
        def z(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    def update(grads, state, params, step):
        eta = resolve_lr(lr, step)
        # the bias corrections in f32, as the reference computes them
        t = _f32(step) + 1.0
        c1 = float(1.0 - _f32(b1) ** t)
        c2 = float(1.0 - _f32(b2) ** t)

        def upd(g, m, v, p):
            g = g.to(torch.float32)
            pf = p.to(torch.float32)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            r = (m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * pf
            w_norm = torch.linalg.vector_norm(pf)
            r_norm = torch.linalg.vector_norm(r)
            trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                                1.0)
            return -eta * trust * r

        return tree_map(upd, grads, state["m"], state["v"], params), state

    return Optimizer("lamb", init, update)
