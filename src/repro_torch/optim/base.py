"""Optimizer interface of the port (the reference's optax-style API):

    opt = make_optimizer(name, lr=fn_or_float, **kwargs)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params, step)
    params = apply_updates(params, updates)

The moments are updated in place (the returned state holds the same
tensors): at full width a second copy of Adam's f32 moments would not fit
beside the first.  :func:`step_inplace` runs update + apply leaf by leaf,
so only one leaf's f32 update exists at a time; it is what the train steps
call.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple, Union

import torch

from repro_torch._tree import tree_leaves, tree_map

Schedule = Union[float, Callable[[int], float]]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, int], Tuple[Any, Any]]


def resolve_lr(lr: Schedule, step: int) -> float:
    """The learning rate at ``step`` as an f32 value (held in a Python
    float, which represents it exactly)."""
    value = lr(step) if callable(lr) else lr
    return float(torch.tensor(value, dtype=torch.float32))


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.to(torch.float32) + u).to(p.dtype),
                    params, updates)


def step_inplace(optimizer: Optimizer, params, grads, opt_state,
                 step: int) -> None:
    """``updates, state = optimizer.update(...)`` then ``apply_updates``,
    one leaf at a time, writing the new parameters into ``params`` and the
    new moments into ``opt_state`` in place.  Bit-equal to the tree-wide
    form: every leaf's update is elementwise."""
    p_leaves: List[torch.Tensor] = tree_leaves(params)
    g_leaves = tree_leaves(grads)
    moments: Dict[str, List[torch.Tensor]] = {
        k: tree_leaves(v) for k, v in opt_state.items()}
    with torch.no_grad():
        for i, (p, g) in enumerate(zip(p_leaves, g_leaves)):
            state = {k: v[i] for k, v in moments.items()}
            upd, new = optimizer.update(g, state, p, step)
            for k, t in new.items():
                if t is not state[k]:
                    state[k].copy_(t)
            p.copy_((p.to(torch.float32) + upd).to(p.dtype))


REGISTRY: Dict[str, Callable[..., Optimizer]] = {}


def register(name: str):
    def deco(fn):
        REGISTRY[name] = fn
        return fn
    return deco


def make_optimizer(name: str, **kwargs) -> Optimizer:
    if name not in REGISTRY:
        raise KeyError(f"unknown optimizer {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name](**kwargs)
