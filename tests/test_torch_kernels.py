"""The port's kernels (``repro_torch.kernels``) against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions.  The
per-tile int8 quantize must be BIT-EQUAL to
``repro.kernels.ref.quantize_tiles_ref`` and to the Pallas kernel body
under the interpreter (``ops.quantize_tiles(..., impl="interpret")``, as
``tests/test_kernels.py`` runs it) — ragged lengths, several tiles, f32 and
bf16, all-zero tiles, exact-half rounding values and a tile holding a NaN.
The training wire's kernels (quantize_ef, dequant_accum, topk_ef,
topk_mask) are held the same way in the second half of this file.  The
CUDA kernels are held bit-equal to the plain versions by the
``cuda``-marked tests (and by ``chip_smoke.py`` on the card).
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
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 nonfinite_tiles_cuda)
from repro_torch.kernels.quantize import quantize_tiles_cuda
from repro_torch.kernels.quantize_ef import (dequant_accum_cuda,
                                             quantize_ef_cuda)
from repro_torch.kernels.topk_mask import topk_ef_cuda, topk_mask_cuda

SIZES = [1, 255, 256, 1000, 1024, 3000]
TILES = [64, 256, 1024]


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
    g, e = torch.randn(3000), torch.randn(3000)
    q, _, s = tops.quantize_ef(g, e)
    tops.dequant_accum(torch.stack([q, q]), torch.stack([s, s]))
    tops.topk_ef(g, e, ratio=0.05)
    tops.topk_mask(g, ratio=0.05)
    tops.flash_attention(torch.randn(1, 8, 2, 4), torch.randn(1, 8, 1, 4),
                         torch.randn(1, 8, 1, 4), window=3)
    tops.nonfinite_tiles(torch.randn(1, 8, 1, 4))
    assert tops.launch_counts() == {name: 0 for name in tops.KERNEL_WRAPPERS}
    assert tops.route_counts() == {
        "flash_attention": {"wgmma": 0, "simt": 0},
        "quantize_tiles": {"warp": 0, "block": 0},
        "dequant_accum": {"warp": 0, "block": 0},
        "topk_ef": {"warp": 0, "block": 0},
        "topk_mask": {"warp": 0, "block": 0}}
    assert set(tops.KERNEL_WRAPPERS) == {"flash_attention", "nonfinite_tiles",
                                         "quantize_tiles", "quantize_ef",
                                         "dequant_accum", "topk_ef",
                                         "topk_mask"}


def test_tile_route():
    # every tile of up to 1024 takes the warp route, every larger one the
    # block route; the serving pools' tile (head_dim 256) and the training
    # wire's (1024) are warp tiles
    assert dispatch.WARP_MAX_TILE == 1024
    assert {dispatch.tile_route(t) for t in range(1, 1025)} == {"warp"}
    assert {dispatch.tile_route(t) for t in range(1025, 8193)} == {"block"}
    assert dispatch.tile_route(2**30) == "block"
    assert dispatch.tile_route(256) == dispatch.tile_route(tops.TILE) == "warp"


def test_reset_launch_counts_zeroes_every_route():
    for name, routes in tops.route_counts().items():
        for route in routes:
            tops.KERNEL_WRAPPERS[name].routes[route] = 5
        tops.KERNEL_WRAPPERS[name].launches = 5
    tops.reset_launch_counts()
    assert tops.route_counts() == {
        name: {r: 0 for r in routes}
        for name, routes in tops.KERNEL_ROUTES.items()}
    assert tops.KERNEL_ROUTES == {"flash_attention": ("wgmma", "simt"),
                                  "quantize_tiles": ("warp", "block"),
                                  "dequant_accum": ("warp", "block"),
                                  "topk_ef": ("warp", "block"),
                                  "topk_mask": ("warp", "block")}
    assert set(tops.launch_counts().values()) == {0}


def test_dispatch_by_device():
    assert dispatch.use_kernel(torch.zeros(1)) is False
    with pytest.raises(ValueError):
        dispatch.use_kernel(torch.zeros(1, device="meta"))


def test_cuda_wrapper_refuses_cpu_tensors():
    # checked before anything is built or launched
    x = torch.zeros(256)
    with pytest.raises(ValueError, match="CUDA tensor"):
        quantize_tiles_cuda(x, 256)
    with pytest.raises(ValueError, match="CUDA tensor"):
        quantize_ef_cuda(x, x, 1.0, 256)
    with pytest.raises(ValueError, match="CUDA device"):
        dequant_accum_cuda(torch.zeros(2, 256, dtype=torch.int8),
                           torch.ones(2, 1), 256)
    with pytest.raises(ValueError, match="CUDA tensor"):
        topk_ef_cuda(x, x, 3, 256, 16, 1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        topk_mask_cuda(x, 3, 256, 16)
    qkv = torch.zeros(1, 4, 2, 8)
    for kernel in ("wgmma", "simt"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            flash_attention_cuda(qkv, qkv, qkv, None, True, None, None,
                                 kernel)
    with pytest.raises(ValueError, match="CUDA tensors"):
        nonfinite_tiles_cuda(qkv)


def test_build_flags_and_cache_key():
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast-math" not in flags and "fast_math" not in flags
    assert "-lcuda" not in flags      # cuTensorMapEncodeTiled: looked up
    assert set(build.KERNEL_SOURCES) == {"quantize_tiles", "quantize_ef",
                                         "topk_mask", "flash_attention",
                                         "flash_attention_wgmma"}
    for name in build.KERNEL_SOURCES:
        path = build.library_path(name)
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(f"{name}-") and path.suffix == ".so"
        assert (build.CSRC / f"{name}.cu").exists()
    # the shared headers are part of every library's cache key
    assert (build.CSRC / "tile_math.cuh").exists()
    assert (build.CSRC / "flash_common.cuh").exists()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_tiles_nan_tile_matches_jax(dtype):
    # jnp.max propagates a NaN into the tile's scale; XLA stores the NaN
    # quotients as int8 0.  The plain version (and the kernel) do the same.
    x = _input(3000, 1024, seed=5)
    x[1030] = np.nan
    xj, xt = _pair(x, dtype)
    q, s = tops.quantize_tiles(xt, tile=1024)
    assert np.isnan(s[1].item()) and np.isfinite(s[[0, 2]].numpy()).all()
    assert not q[1024:2048].any()
    for name, (qj, sj) in {
            "ref": jref.quantize_tiles_ref(xj, tile=1024),
            "interpret": jops.quantize_tiles(xj, tile=1024,
                                             impl="interpret")}.items():
        # assert_array_equal holds NaN equal to NaN at the same position
        np.testing.assert_array_equal(s.numpy(), np.asarray(sj), err_msg=name)
        np.testing.assert_array_equal(q.numpy(), np.asarray(qj), err_msg=name)


# ---------------------------------------------------------------------------
# The training wire's kernels: quantize_ef, dequant_accum, topk_ef, topk_mask
# ---------------------------------------------------------------------------
#
# Against ``repro.kernels.ref`` (run eagerly, one XLA op at a time) the
# plain versions are bit-equal.  Against the interpreted Pallas kernels,
# which run under jit, XLA on the CPU contracts ``c − q·(s/127)`` and
# ``g + decay·e`` into fused multiply-adds, while ref.py, the plain
# versions and the CUDA kernels round the product and the sum apart.  One
# FMA differs from the two roundings by at most one ulp of the product plus
# one of the result, so those comparisons hold to 2 ulp of the operands'
# magnitudes (ULP = 2**-23, relative), and the int8 codes to ±1.

TILE = 1024
EF_SIZES = [1024, 1000, 2065, 4096]
RATIOS = [0.01, 0.05, 0.25]
ULP = 2.0 ** -23


def _ef_inputs(n: int, seed: int, nan: bool = False):
    """g as :func:`_input` (an all-zero first tile, exact halves in the
    last); e a smaller Gaussian, zero on those two tiles so that
    c = g + decay·e keeps them; optionally a NaN in the second tile."""
    g = _input(n, TILE, seed)
    e = (np.random.default_rng(seed + 1).standard_normal(n) * 0.5).astype(
        np.float32)
    if n >= 2 * TILE:
        e[:TILE] = 0.0
    e[(n - 1) // TILE * TILE:] = 0.0
    if nan:
        g[TILE + 5] = np.nan
    return g, e


def _c_bound(g, e, decay):
    """Two ulp of |g| + |decay·e|: the most one FMA moves c = g + decay·e."""
    return 2 * ULP * (np.abs(g) + np.abs(np.float32(decay) * e))


def _tile_rep(s, n):
    return np.repeat(np.asarray(s), TILE)[:n]


# every length and decay, and a NaN case (in a second tile) for the lengths
# that have one
EF_CASES = ([(n, d, False) for n in EF_SIZES for d in (1.0, 0.9)]
            + [(n, d, True) for n in EF_SIZES if n >= 2 * TILE
               for d in (1.0, 0.9)])


@pytest.mark.parametrize("n,decay,nan", EF_CASES)
def test_quantize_ef_matches_jax(n, decay, nan):
    g, e = _ef_inputs(n, seed=n, nan=nan)
    gj, ej = jnp.asarray(g), jnp.asarray(e)
    q, e_new, s = tops.quantize_ef(torch.from_numpy(g), torch.from_numpy(e),
                                   decay=decay, tile=TILE)
    assert (q.dtype, e_new.dtype, s.dtype) == (torch.int8, torch.float32,
                                               torch.float32)
    assert q.shape == e_new.shape == (n,) and s.shape == (-(-n // TILE),)
    for got, want in zip((q, e_new, s),
                         jref.quantize_ef_ref(gj, ej, decay=decay, tile=TILE)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if n >= 2 * TILE:          # the all-zero tile: floor scale, zero codes
        assert s[0].item() == np.float32(1e-30)
        assert not q[:TILE].any() and not e_new[:TILE].any()
    if nan:                    # the NaN tile: NaN scale and residual, q 0
        assert np.isnan(s[1].item()) and not q[TILE:2 * TILE].any()
        assert torch.isnan(e_new[TILE:2 * TILE]).all()
        return

    qi, ei, si = (np.asarray(a) for a in jops.quantize_ef(
        gj, ej, decay=decay, tile=TILE, impl="interpret"))
    sn = s.numpy()
    assert np.all(np.abs(sn - si) <= 2 * ULP * sn)
    dq = np.abs(q.numpy().astype(int) - qi.astype(int))
    assert dq.max() <= 1
    same = dq == 0
    bound = 2 * ULP * _tile_rep(sn, n) + _c_bound(g, e, decay)
    assert np.all(np.abs(e_new.numpy() - ei)[same] <= bound[same])
    if decay == 1.0:
        # 1.0·e is exact, so c, the scales and the codes agree in every bit
        np.testing.assert_array_equal(q.numpy(), qi)
        np.testing.assert_array_equal(sn, si)


@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("n,decay,nan", EF_CASES)
def test_topk_ef_matches_jax(n, decay, nan, ratio):
    g, e = _ef_inputs(n, seed=3 * n + 1, nan=nan)
    gj, ej = jnp.asarray(g), jnp.asarray(e)
    y, e_new = tops.topk_ef(torch.from_numpy(g), torch.from_numpy(e),
                            ratio=ratio, tile=TILE, decay=decay)
    for got, want in zip((y, e_new), jref.topk_ef_ref(
            gj, ej, ratio=ratio, tile=TILE, decay=decay)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    c = (torch.from_numpy(g) + decay * torch.from_numpy(e)).numpy()
    kept = y.numpy() != 0
    if nan:                    # hi is NaN: nothing kept, the residual is c
        assert not kept[TILE:2 * TILE].any()
        np.testing.assert_array_equal(e_new.numpy()[TILE:2 * TILE],
                                      c[TILE:2 * TILE])
        return
    np.testing.assert_array_equal(y.numpy() + e_new.numpy(), c)
    k = max(1, int(TILE * ratio))
    full = (n // TILE) * TILE
    per_tile = kept[:full].reshape(-1, TILE).sum(axis=1)
    nonzero = (c[:full] != 0).reshape(-1, TILE).any(axis=1)
    assert np.all(per_tile[nonzero] >= k)

    yi, ei = (np.asarray(a) for a in jops.topk_ef(
        gj, ej, ratio=ratio, tile=TILE, decay=decay, impl="interpret"))
    np.testing.assert_array_equal(kept, yi != 0)
    bound = _c_bound(g, e, decay)
    assert np.all(np.abs(y.numpy() - yi) <= bound)
    assert np.all(np.abs(e_new.numpy() - ei) <= bound)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("n", EF_SIZES)
def test_topk_mask_bit_equal_to_jax(n, ratio, dtype):
    # only comparisons and exact halvings: bit-equal to the interpreted
    # kernel too
    x = _input(n, TILE, seed=7 * n)
    if n >= 2 * TILE:
        x[TILE + 9] = np.nan
    xj, xt = _pair(x, dtype)
    y = tops.topk_mask(xt, ratio=ratio, tile=TILE)
    assert y.dtype == xt.dtype and y.shape == (n,)
    for name, want in {
            "ref": jref.topk_mask_bisect_ref(xj, ratio=ratio, tile=TILE),
            "interpret": jops.topk_mask(xj, ratio=ratio, tile=TILE,
                                        impl="interpret")}.items():
        np.testing.assert_array_equal(y.float().numpy(),
                                      np.asarray(want, np.float32),
                                      err_msg=name)
    exact = tref.topk_mask_ref(xt, ratio=ratio, tile=TILE)
    np.testing.assert_array_equal(
        exact.float().numpy(),
        np.asarray(jref.topk_mask_ref(xj, ratio=ratio, tile=TILE),
                   np.float32))


@pytest.mark.parametrize("w", [1, 2, 8])
@pytest.mark.parametrize("n", [1000, 4096])
def test_dequant_accum_matches_jax(n, w):
    rng = np.random.default_rng(100 * n + w)
    qs, ss = [], []
    for r in range(w):
        x = (rng.standard_normal(n) * (1 + r)).astype(np.float32)
        if n >= 2 * TILE and r == 0:
            x[:TILE] = 0.0
        q, s = tops.quantize_tiles(torch.from_numpy(x), tile=TILE)
        qs.append(q)
        ss.append(s)
    q, s = torch.stack(qs), torch.stack(ss)
    out = tops.dequant_accum(q, s, tile=TILE)
    assert out.dtype == torch.float32 and out.shape == (n,)
    qj, sj = jnp.asarray(q.numpy()), jnp.asarray(s.numpy())
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jref.dequant_accum_ref(qj, sj, tile=TILE)))
    # the per-rank loop of dequantized payloads, in rank order
    loop = tref.dequantize_ref(qs[0], ss[0], tile=TILE)
    for r in range(1, w):
        loop = loop + tref.dequantize_ref(qs[r], ss[r], tile=TILE)
    np.testing.assert_array_equal(out.numpy(), loop.numpy())
    # the jitted kernel sums with FMAs: w ulp of the sum of |terms|
    interp = np.asarray(jops.dequant_accum(qj, sj, tile=TILE,
                                           impl="interpret"))
    mag = sum(np.abs(tref.dequantize_ref(a, b, tile=TILE).numpy())
              for a, b in zip(qs, ss))
    assert np.all(np.abs(out.numpy() - interp) <= w * ULP * mag)
    if w == 1:
        np.testing.assert_array_equal(out.numpy(), interp)


@pytest.mark.parametrize("into", ["e", "separate"])
def test_plain_path_writes_residual_into_e_out(into):
    # the executor passes the EF state's buffer as e_out (the kernels write
    # it in place); the plain path copies its result there
    g, e = (torch.from_numpy(a) for a in _ef_inputs(2065, seed=4))
    for fn, kw, ref_fn in ((tops.quantize_ef, {}, tref.quantize_ef_ref),
                           (tops.topk_ef, {"ratio": 0.05}, tref.topk_ef_ref)):
        want = ref_fn(g, e, decay=0.9, tile=TILE, **kw)
        e_buf = e.clone()
        e_out = e_buf if into == "e" else torch.full_like(e, 7.0)
        got = fn(g, e_buf, decay=0.9, tile=TILE, e_out=e_out, **kw)
        assert got[1] is e_out           # the new residual, in e_out
        for a, b in zip(got, want):
            assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))


# ---------------------------------------------------------------------------
# Tiles on both sides of the warp route's limit (1024): the plain versions
# against the JAX reference at tiles 1000, 1025 and 2048
# ---------------------------------------------------------------------------

EDGE_TILES = [1000, 1025, 2048]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("tile", EDGE_TILES)
def test_quantize_tiles_edge_tiles_bit_equal_to_jax(tile, dtype):
    n = 3 * tile + 17
    x = _input(n, tile, seed=tile + 11)
    x[tile + 3] = np.nan                 # a NaN tile
    xj, xt = _pair(x, dtype)
    q, s = tops.quantize_tiles(xt, tile=tile)
    qj, sj = jref.quantize_tiles_ref(xj, tile=tile)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    assert s[0].item() == np.float32(1e-30) and np.isnan(s[1].item())


@pytest.mark.parametrize("ratio", [0.01, 0.25])
@pytest.mark.parametrize("tile", EDGE_TILES)
def test_topk_ef_edge_tiles_bit_equal_to_jax(tile, ratio):
    n = 3 * tile + 17
    g = _input(n, tile, seed=tile + 5)
    g[tile + 7] = np.nan
    e = (np.random.default_rng(tile).standard_normal(n) * 0.5).astype(
        np.float32)
    e[:tile] = 0.0
    y, e_new = tops.topk_ef(torch.from_numpy(g), torch.from_numpy(e),
                            ratio=ratio, tile=tile, decay=0.9)
    for got, want in zip((y, e_new), jref.topk_ef_ref(
            jnp.asarray(g), jnp.asarray(e), ratio=ratio, tile=tile,
            decay=0.9)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not y[tile:2 * tile].any()         # the NaN tile keeps nothing


@pytest.mark.parametrize("tile", EDGE_TILES)
def test_topk_mask_edge_tiles_bit_equal_to_jax(tile):
    x = _input(2 * tile + 5, tile, seed=tile + 9)
    xj, xt = _pair(x, "f32")
    y = tops.topk_mask(xt, ratio=0.05, tile=tile)
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(jref.topk_mask_bisect_ref(xj, ratio=0.05,
                                                        tile=tile)))


@pytest.mark.parametrize("tile", EDGE_TILES)
def test_dequant_accum_edge_tiles_bit_equal_to_jax(tile):
    # four ranks, n not a multiple of 16 (the kernels' vector rule), a NaN
    # tile in rank 1: its NaN scale makes the tile NaN in the sum
    n, w = 3 * tile + 17, 4
    qs, ss = [], []
    for r in range(w):
        x = _input(n, tile, seed=tile + r)
        if r == 1:
            x[tile + 3] = np.nan
        q, s = tops.quantize_tiles(torch.from_numpy(x), tile=tile)
        qs.append(q)
        ss.append(s)
    q, s = torch.stack(qs), torch.stack(ss)
    out = tops.dequant_accum(q, s, tile=tile)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jref.dequant_accum_ref(
            jnp.asarray(q.numpy()), jnp.asarray(s.numpy()), tile=tile)))
    assert torch.isnan(out[tile:2 * tile]).all()
    assert not torch.isnan(out[:tile]).any()
