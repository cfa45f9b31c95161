"""Backend dispatch for the port's kernels: chosen by the tensor's device.

  * a CUDA tensor goes to the hand-written Hopper kernel;
  * a CPU tensor goes to the plain PyTorch version (``kernels/ref.py``).

There is no override that sends a CUDA tensor to the plain version (the
JAX package's ``REPRO_KERNELS_IMPL`` has no counterpart here), and no
fall-back: if a kernel does not build or does not launch, its wrapper
raises.  ``require_flat_cuda`` and ``launch`` are the checks and the
launch every wrapper shares; ``tile_route`` picks the kernel of the
per-tile wrappers (``quantize_tiles``, ``dequant_accum``, ``topk_ef``,
``topk_mask``).
"""
from __future__ import annotations

import torch

WARP_MAX_TILE = 1024          # kWarpMaxTile in csrc/tile_math.cuh
TILE_ROUTES = ("warp", "block")


def use_kernel(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version).  Any other device raises."""
    kind = x.device.type
    if kind == "cuda":
        return True
    if kind == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")


def tile_route(tile: int) -> str:
    """The kernel of a per-tile wrapper for tiles of ``tile`` elements:
    ``"warp"`` (one warp per tile, the tile in registers) up to
    ``WARP_MAX_TILE``, ``"block"`` (one thread block per tile) above.  The
    tile alone decides: a failed build or launch raises, it never sends a
    tile to the other kernel."""
    return "warp" if int(tile) <= WARP_MAX_TILE else "block"


def require_flat_cuda(x: torch.Tensor, kernel: str, dtypes) -> None:
    """Raise unless ``x`` is a flat contiguous CUDA tensor of one of
    ``dtypes``: what every launcher of the port takes."""
    if x.device.type != "cuda":
        raise ValueError(f"{kernel} kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{kernel} kernel takes {[str(d) for d in dtypes]},"
                        f" got {x.dtype}")
    if x.ndim != 1 or not x.is_contiguous():
        raise ValueError(f"{kernel} kernel takes a flat contiguous tensor, "
                         f"got shape {tuple(x.shape)} strides {x.stride()}")


def launch(kernel: str, fn, x: torch.Tensor, *args) -> None:
    """Call the C launcher ``fn(*args, stream)`` on ``x``'s CUDA device and
    PyTorch's current stream there; raise if it returns a CUDA error (a
    refused launch never runs, and a later synchronise does not report
    it)."""
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
