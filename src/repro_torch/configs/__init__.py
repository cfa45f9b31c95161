"""Architecture registry of the port: ``get_config(name)``, ``reduced(cfg)``.

The config dataclasses are a copy of ``repro/configs/base.py`` (the JAX
package's registry cannot be imported: any ``repro.*`` import loads jax).
Only the architectures whose blocks the port implements are registered;
the others raise and name the ROADMAP item that ports them.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    LayerSpec, ModelConfig, Segment, ShapeConfig, SHAPES,
    TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K, reduced,
)

_ARCH_MODULES = {
    "gemma-2b": "gemma_2b",
    "gemma2-9b": "gemma2_9b",
    "gemma3-4b": "gemma3_4b",
    "deepseek-67b": "deepseek_67b",
    "chameleon-34b": "chameleon_34b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
}

# Architectures of the JAX package that the port does not cover yet.
NOT_PORTED = ("xlstm-125m", "seamless-m4t-large-v2", "jamba-v0.1-52b")

ALL_ARCHS = tuple(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to PyTorch yet (ROADMAP.md "
            f"queue 1, item 4: the remaining model families); ported: "
            f"{sorted(_ARCH_MODULES)}")
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG
