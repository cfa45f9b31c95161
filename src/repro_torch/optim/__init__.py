"""Optimizers of the port (counterparts of ``repro/optim``): ``adam``,
``sgd``, ``lamb`` and ``lars``, the LR schedules, the leaf-by-leaf
in-place application, and their sharded (ZeRO) forms over partitioned
flat buckets (``optim/sharded.py``)."""
from repro_torch.optim.base import (  # noqa: F401
    Optimizer, apply_updates, make_optimizer, step_inplace)
from repro_torch.optim import adam, lamb, lars, sgd  # noqa: F401
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
from repro_torch.optim.sharded import (  # noqa: F401
    apply_rows_inplace, make_sharded_optimizer)
