"""Architecture registry of the port: ``get_config(name)``, ``reduced(cfg)``.

The config dataclasses are a copy of ``repro/configs/base.py`` (the JAX
package's registry cannot be imported: any ``repro.*`` import loads jax),
and every architecture of the JAX package is registered.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    LayerSpec, ModelConfig, Segment, ShapeConfig, SHAPES,
    TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K, reduced,
)

_ARCH_MODULES = {   # the JAX package's registry, in its order
    "deepseek-67b": "deepseek_67b",
    "gemma2-9b": "gemma2_9b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "gemma-2b": "gemma_2b",
    "gemma3-4b": "gemma3_4b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "chameleon-34b": "chameleon_34b",
    "xlstm-125m": "xlstm_125m",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "jamba-v0.1-52b": "jamba_v01_52b",
}

# Architectures of the JAX package that the port does not cover: none.
NOT_PORTED: tuple = ()

ALL_ARCHS = tuple(_ARCH_MODULES)


def applicable_shapes(cfg: ModelConfig) -> tuple:
    """Which of the four assigned input shapes run for this arch (the
    reference's rule): ``long_500k`` only for sub-quadratic archs."""
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        shapes.append("long_500k")
    return tuple(shapes)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG
