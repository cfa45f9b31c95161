"""The port's per-tile int8 quantize (``repro_torch.kernels``) against the
JAX package.

On the CPU the port's wrapper runs its plain PyTorch version, which must be
BIT-EQUAL to ``repro.kernels.ref.quantize_tiles_ref`` and to the Pallas
kernel body under the interpreter (``ops.quantize_tiles(...,
impl="interpret")``, as ``tests/test_kernels.py`` runs it) — ragged
lengths, several tiles, f32 and bf16, all-zero tiles and exact-half
rounding values.  The CUDA kernel is held bit-equal to the plain version
by the ``cuda``-marked test (and by ``chip_smoke.py`` on the card).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import quantize_ef as jquant
from repro.kernels import ref as jref
from repro_torch.kernels import build, dispatch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.quantize import quantize_tiles_cuda

SIZES = [1, 255, 256, 1000, 1024, 3000]
TILES = [64, 256, 1024]


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
        # scale 127 and values k+0.5: (x / 127) * 127 lands on .5 exactly
        # for most k, so round-half-to-even decides those entries
        x[start] = 127.0
        x[start + 1:start + k] = np.arange(1, k) - 32 + 0.5
    return x


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor."""
    if dtype == "bf16":
        xj = jnp.asarray(x, jnp.bfloat16)
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
            torch.bfloat16)
        return xj, xt
    return jnp.asarray(x), torch.from_numpy(x.copy())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("n", SIZES)
def test_quantize_tiles_bit_equal_to_jax(n, tile, dtype):
    x = _input(n, tile, seed=n * 31 + tile)
    xj, xt = _pair(x, dtype)
    q, s = tops.quantize_tiles(xt, tile=tile)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == (n,) and s.shape == (-(-n // tile),)
    for name, (qj, sj) in {
            "ref": jref.quantize_tiles_ref(xj, tile=tile),
            "interpret": jops.quantize_tiles(xj, tile=tile,
                                             impl="interpret")}.items():
        np.testing.assert_array_equal(q.numpy(), np.asarray(qj), err_msg=name)
        np.testing.assert_array_equal(s.numpy(), np.asarray(sj), err_msg=name)


def test_exact_half_values_are_exercised():
    # the sweep's half-way entries really land on .5 in f32, and the port
    # rounds them to even as jnp.round does
    x = _input(256, 256, seed=0)
    s = np.float32(np.abs(x).max())
    v = (x / s).astype(np.float32) * np.float32(127.0)
    halves = np.abs(v - np.trunc(v)) == 0.5
    assert halves.sum() >= 16
    q, _ = tops.quantize_tiles(torch.from_numpy(x), tile=256)
    np.testing.assert_array_equal(q.numpy()[halves],
                                  np.round(v[halves]).astype(np.int8))


def test_all_zero_tile_scale_floor():
    q, s = tops.quantize_tiles(torch.zeros(512), tile=256)
    assert (q == 0).all()
    assert s.tolist() == [np.float32(1e-30)] * 2


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("n", [255, 1000, 3000])
def test_dequantize_bit_equal_and_bound(n, tile):
    x = _input(n, tile, seed=7 + n)
    q, s = tops.quantize_tiles(torch.from_numpy(x), tile=tile)
    deq = tops.dequantize(q, s, tile=tile)
    for ref in (jref.dequantize_ref(jnp.asarray(q.numpy()),
                                    jnp.asarray(s.numpy()), tile=tile),
                jquant.dequantize(jnp.asarray(q.numpy()),
                                  jnp.asarray(s.numpy()), tile=tile)):
        np.testing.assert_array_equal(deq.numpy(), np.asarray(ref))
    # round-to-nearest: |x - deq| <= s / 254 per element, plus the f32
    # rounding of (x / s) * 127 and of q * (s / 127) (a few ulp of s)
    srep = torch.repeat_interleave(s, tile)[:n]
    bound = srep / 254.0 + srep * 2.0 ** -20
    assert (torch.from_numpy(x) - deq).abs().le(bound).all()


def test_cpu_path_leaves_launch_counter_at_zero():
    tops.reset_launch_counts()
    tops.quantize_tiles(torch.randn(1000), tile=256)
    tops.quantize_tiles(torch.randn(1000, dtype=torch.bfloat16), tile=64)
    assert tops.launch_counts() == {"quantize_tiles": 0}


def test_dispatch_by_device():
    assert dispatch.use_kernel(torch.zeros(1)) is False
    with pytest.raises(ValueError):
        dispatch.use_kernel(torch.zeros(1, device="meta"))


def test_cuda_wrapper_refuses_cpu_tensors():
    # checked before anything is built or launched
    with pytest.raises(ValueError, match="CUDA tensor"):
        quantize_tiles_cuda(torch.zeros(256), 256)


def test_build_flags_and_cache_key():
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast-math" not in flags and "fast_math" not in flags
    path = build.library_path("quantize_tiles")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("quantize_tiles-") and path.suffix == ".so"
    assert (build.CSRC / "quantize_tiles.cu").exists()
    assert set(build.KERNEL_SOURCES) == {"quantize_tiles"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_bit_equal_to_plain(cuda_device, dtype):
    for tile in TILES:
        for n in (tile, 3 * tile + 17, 18 * 4 * 256, 18 * 128 * 256):
            x = torch.from_numpy(_input(n, tile, seed=n)).to(dtype)
            qk, sk = tops.quantize_tiles(x.to(cuda_device), tile=tile)
            torch.cuda.synchronize()
            qp, sp = tref.quantize_tiles_ref(x, tile=tile)
            assert torch.equal(qk.cpu(), qp) and torch.equal(sk.cpu(), sp)
