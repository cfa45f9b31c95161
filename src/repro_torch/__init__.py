"""PyTorch + CUDA port of the ``repro`` package for NVIDIA Hopper.

The JAX package (``src/repro``) is the reference; this package mirrors
its module names and is held against it by the ``tests/test_torch_*.py``
parity tests.  It imports torch, numpy and the standard library only —
never jax, and never ``repro.*``.  Ported so far: the gemma-2b serving
path (configs, model stack, paged int8 KV cache, continuous-batching
engine, serving CLI) with the per-tile int8 quantize kernel in CUDA
(``csrc/quantize_tiles.cu``).
"""
