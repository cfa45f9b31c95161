"""Checkpoints of the port (counterpart of ``repro/checkpoint``), in the
reference's file format."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    latest_step, load_arrays, load_tensors, restore, save, verify)
