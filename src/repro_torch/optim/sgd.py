"""SGD with momentum (counterpart of ``repro/optim/sgd.py``)."""
from __future__ import annotations

import torch

from repro_torch._tree import tree_map
from repro_torch.optim.base import Optimizer, Schedule, register, resolve_lr


@register("sgd")
def sgd(lr: Schedule = 0.1, momentum: float = 0.0, nesterov: bool = False,
        weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {}
        return {"mu": tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)}

    def update(grads, state, params, step):
        eta = resolve_lr(lr, step)

        def upd(g, p, mu=None):
            g = g.to(torch.float32)
            if weight_decay:
                g = g + weight_decay * p.to(torch.float32)
            if mu is None:
                return -eta * g
            mu.mul_(momentum).add_(g)
            d = g + momentum * mu if nesterov else mu
            return -eta * d

        if momentum == 0.0:
            return tree_map(upd, grads, params), state
        return tree_map(upd, grads, params, state["mu"]), state

    return Optimizer("sgd", init, update)
