"""LARS (counterpart of ``repro/optim/lars.py``; survey §3.1.1; You et al.
2017): the per-layer trust ratio ||w|| / (||g|| + wd·||w||) rescales the
learning rate.  The momentum is updated in place."""
from __future__ import annotations

import torch

from repro_torch._tree import tree_map
from repro_torch.optim.base import Optimizer, Schedule, register, resolve_lr


@register("lars")
def lars(lr: Schedule = 1.0, momentum: float = 0.9, weight_decay: float = 1e-4,
         trust_coef: float = 0.001, eps: float = 1e-9) -> Optimizer:
    def init(params):
        return {"mu": tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)}

    def update(grads, state, params, step):
        eta = resolve_lr(lr, step)

        def upd(g, mu, p):
            pf = p.to(torch.float32)
            g = g.to(torch.float32) + weight_decay * pf
            w_norm = torch.linalg.vector_norm(pf)
            g_norm = torch.linalg.vector_norm(g)
            trust = torch.where((w_norm > 0) & (g_norm > 0),
                                trust_coef * w_norm / (g_norm + eps), 1.0)
            mu.mul_(momentum).add_(eta * trust * g)
            return -mu

        return tree_map(upd, grads, state["mu"], params), state

    return Optimizer("lars", init, update)
