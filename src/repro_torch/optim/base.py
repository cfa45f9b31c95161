"""Optimizer interface of the port (the reference's optax-style API):

    opt = make_optimizer(name, lr=fn_or_float, **kwargs)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params, step)
    params = apply_updates(params, updates)

The moments are updated in place (the returned state holds the same
tensors): at full width a second copy of Adam's f32 moments would not fit
beside the first.  :func:`step_inplace` runs update + apply leaf by leaf,
and an elementwise optimizer's large leaf in chunks, so only one chunk's
f32 temporaries exist at a time; it is what the train steps call.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple, Union

import torch

from repro_torch._tree import tree_leaves, tree_map

Schedule = Union[float, Callable[[int], float]]

# optimizers whose update of an element reads only that element (and
# scalars): running them over any split of a leaf gives the same bits
ELEMENTWISE = ("adam", "sgd")
CHUNK = 1 << 24        # elements per elementwise update pass (64 MiB f32)


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
                 step: int, chunk: int = CHUNK) -> None:
    """``updates, state = optimizer.update(...)`` then ``apply_updates``,
    one leaf at a time, writing the new parameters into ``params`` and the
    new moments into ``opt_state`` in place.  Bit-equal to the tree-wide
    form: every leaf's update is its own.  An ``ELEMENTWISE`` optimizer
    runs a leaf of more than ``chunk`` elements ``chunk`` elements at a
    time (bit-equal too), so no leaf-wide f32 temporary exists: at full
    width one such temporary of the embedding is 2.1 GB."""
    p_leaves: List[torch.Tensor] = tree_leaves(params)
    g_leaves = tree_leaves(grads)
    moments: Dict[str, List[torch.Tensor]] = {
        k: tree_leaves(v) for k, v in opt_state.items()}
    with torch.no_grad():
        for i, (p, g) in enumerate(zip(p_leaves, g_leaves)):
            state = {k: v[i] for k, v in moments.items()}
            if optimizer.name in ELEMENTWISE and p.numel() > chunk:
                pf, gf = p.view(-1), g.reshape(-1)
                sf = {k: t.view(-1) for k, t in state.items()}
                parts = [(pf[a:a + chunk], gf[a:a + chunk],
                          {k: t[a:a + chunk] for k, t in sf.items()})
                         for a in range(0, pf.numel(), chunk)]
            else:
                parts = [(p, g, state)]
            for pp, gg, st in parts:
                upd, new = optimizer.update(gg, st, pp, step)
                for k, t in new.items():
                    if t is not st[k]:
                        st[k].copy_(t)
                pp.copy_((pp.to(torch.float32) + upd).to(pp.dtype))
                del upd, new


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
