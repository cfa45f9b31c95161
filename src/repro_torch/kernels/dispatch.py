"""Backend dispatch for the port's kernels: chosen by the tensor's device.

  * a CUDA tensor goes to the hand-written Hopper kernel;
  * a CPU tensor goes to the plain PyTorch version (``kernels/ref.py``).

There is no override that sends a CUDA tensor to the plain version (the
JAX package's ``REPRO_KERNELS_IMPL`` has no counterpart here), and no
fall-back: if a kernel does not build or does not launch, its wrapper
raises.
"""
from __future__ import annotations

import torch


def use_kernel(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version).  Any other device raises."""
    kind = x.device.type
    if kind == "cuda":
        return True
    if kind == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")
