"""Learning-rate schedules (counterpart of ``repro/optim/schedule.py``),
computed in f32 as the reference computes them on the device."""
from __future__ import annotations

import math
from typing import Callable

import torch


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  end_lr: float = 0.0) -> Callable[[int], float]:
    def sched(step):
        step = torch.tensor(step, dtype=torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = end_lr + 0.5 * (peak_lr - end_lr) * (1 + torch.cos(
            torch.tensor(math.pi, dtype=torch.float32) * prog))
        return float(torch.where(step < warmup_steps, warm, cos))
    return sched
