"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false.  The file imports only torch,
numpy and ``repro_torch`` (never jax), so it runs on a machine with a GPU
and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The standard is bit-equality, NaN for NaN (the payload bits of a NaN may
differ between devices).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

pytestmark = pytest.mark.cuda

TILES = [64, 256, 1024]
TILE = 1024
EF_SIZES = [1024, 1000, 2065, 4096]
RATIOS = [0.01, 0.05, 0.25]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _input(n: int, tile: int, seed: int) -> np.ndarray:
    """Gaussian values with an all-zero tile (when there are two or more
    tiles) and a run of exact-half rounding values in the last tile."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 3.0).astype(np.float32)
    if n >= 2 * tile:
        x[:tile] = 0.0
    start = (n - 1) // tile * tile
    k = min(n - start, 64)
    if k >= 2:
        x[start] = 127.0
        x[start + 1:start + k] = np.arange(1, k) - 32 + 0.5
    return x


def _ef_inputs(n: int, seed: int, nan: bool = False):
    """g as :func:`_input`; e a smaller Gaussian, zero on the first and
    last tiles; optionally a NaN in the second tile."""
    g = _input(n, TILE, seed)
    e = (np.random.default_rng(seed + 1).standard_normal(n) * 0.5).astype(
        np.float32)
    if n >= 2 * TILE:
        e[:TILE] = 0.0
    e[(n - 1) // TILE * TILE:] = 0.0
    if nan:
        g[TILE + 5] = np.nan
    return g, e


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The card's ``a`` equals the CPU's ``b`` in shape, type and value,
    NaN equal to NaN at the same places."""
    a = a.cpu()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    return (torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_bit_equal_to_plain(cuda_device, dtype):
    for tile in TILES:
        for n in (tile, 3 * tile + 17, 18 * 4 * 256, 18 * 128 * 256):
            x = torch.from_numpy(_input(n, tile, seed=n)).to(dtype)
            if n >= 3 * tile:
                x[tile + 3] = float("nan")
            qk, sk = tops.quantize_tiles(x.to(cuda_device), tile=tile)
            torch.cuda.synchronize()
            qp, sp = tref.quantize_tiles_ref(x, tile=tile)
            assert _same(qk, qp) and _same(sk, sp), (n, tile)


@pytest.mark.parametrize("decay", [1.0, 0.9])
def test_cuda_training_kernels_bit_equal_to_plain(cuda_device, decay):
    for n in EF_SIZES + [18 * 2048 * 16384 // 64]:
        g, e = _ef_inputs(n, seed=n, nan=n >= 2 * TILE)
        gt, et = torch.from_numpy(g), torch.from_numpy(e)
        gc, ec = gt.to(cuda_device), et.to(cuda_device)
        got = tops.quantize_ef(gc, ec, decay=decay, tile=TILE)
        torch.cuda.synchronize()
        want = tref.quantize_ef_ref(gt, et, decay=decay, tile=TILE)
        assert all(_same(a, b) for a, b in zip(got, want)), n
        q, _, s = want
        for w in (1, 2, 8):
            qw, sw = torch.stack([q] * w), torch.stack([s * (1 + r)
                                                        for r in range(w)])
            acc = tops.dequant_accum(qw.to(cuda_device), sw.to(cuda_device),
                                     tile=TILE)
            torch.cuda.synchronize()
            assert _same(acc, tref.dequant_accum_ref(qw, sw, tile=TILE))
        for ratio in RATIOS:
            got = tops.topk_ef(gc, ec, ratio=ratio, tile=TILE, decay=decay)
            torch.cuda.synchronize()
            want = tref.topk_ef_ref(gt, et, ratio=ratio, tile=TILE,
                                    decay=decay)
            assert all(_same(a, b) for a, b in zip(got, want)), (n, ratio)
            for dtype in (torch.float32, torch.bfloat16):
                x = gt.to(dtype)
                y = tops.topk_mask(x.to(cuda_device), ratio=ratio, tile=TILE)
                torch.cuda.synchronize()
                assert _same(y, tref.topk_mask_bisect_ref(x, ratio=ratio,
                                                          tile=TILE))


@pytest.mark.parametrize("n", [2065, 18 * 2048 * 16384 // 64])
def test_cuda_residual_written_in_place(cuda_device, n):
    # as the executor calls them: e_out is the residual buffer e itself
    g, e = _ef_inputs(n, seed=n + 3, nan=True)
    gt, et = torch.from_numpy(g), torch.from_numpy(e)
    gc = gt.to(cuda_device)
    for fn, kw, ref_fn in ((tops.quantize_ef, {}, tref.quantize_ef_ref),
                           (tops.topk_ef, {"ratio": 0.01}, tref.topk_ef_ref)):
        buf = et.to(cuda_device)
        got = fn(gc, buf, decay=0.9, tile=TILE, e_out=buf, **kw)
        torch.cuda.synchronize()
        assert got[1] is buf
        want = ref_fn(gt, et, decay=0.9, tile=TILE, **kw)
        assert all(_same(a, b) for a, b in zip(got, want)), fn.__name__
