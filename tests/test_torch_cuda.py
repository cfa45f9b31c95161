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

import os

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


def _ef_inputs(n: int, seed: int, nan: bool = False, tile: int = TILE):
    """g as :func:`_input`; e a smaller Gaussian, zero on the first and
    last tiles; optionally a NaN in the second tile."""
    g = _input(n, tile, seed)
    e = (np.random.default_rng(seed + 1).standard_normal(n) * 0.5).astype(
        np.float32)
    if n >= 2 * tile:
        e[:tile] = 0.0
    e[(n - 1) // tile * tile:] = 0.0
    if nan:
        g[tile + 5] = np.nan
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


# ---------------------------------------------------------------------------
# quantize_tiles and topk_ef on their two routes: one warp per tile (tiles
# of up to 1024) and one block per tile (above)
# ---------------------------------------------------------------------------

WARP_TILES = [1, 17, 32, 100, 256, 1000, 1024]
BLOCK_TILES = [1025, 8192]


def _route_count(kernel: str, route: str) -> int:
    return tops.route_counts()[kernel][route]


def _lengths(tile: int):
    """One tile; a ragged last tile; 41 whole tiles (several blocks of
    the warp route)."""
    return (tile, 3 * tile + 17, 41 * tile)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", WARP_TILES + BLOCK_TILES)
def test_cuda_quantize_tiles_routes(cuda_device, tile, dtype):
    # an all-zero first tile, exact halves in the last, a NaN tile
    route = "warp" if tile <= 1024 else "block"
    for n in _lengths(tile):
        x = torch.from_numpy(_input(n, tile, seed=n + tile)).to(dtype)
        if n >= 3 * tile:
            x[tile + 3] = float("nan")
        r0 = _route_count("quantize_tiles", route)
        qk, sk = tops.quantize_tiles(x.to(cuda_device), tile=tile)
        torch.cuda.synchronize()
        assert _route_count("quantize_tiles", route) == r0 + 1
        qp, sp = tref.quantize_tiles_ref(x, tile=tile)
        assert _same(qk, qp) and _same(sk, sp), (n, tile)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", [256, 1024, 2048])
def test_cuda_quantize_tiles_misaligned_view(cuda_device, tile, dtype):
    # x[1:] of a contiguous tensor: contiguous, but its base is one element
    # past a 16-byte boundary, so every tile takes the scalar loads
    n = 4 * tile + 1
    x = torch.from_numpy(_input(n, tile, seed=tile + 1)).to(dtype)
    xc = x.to(cuda_device)[1:]
    assert xc.is_contiguous() and xc.data_ptr() % 16 != 0
    qk, sk = tops.quantize_tiles(xc, tile=tile)
    torch.cuda.synchronize()
    qp, sp = tref.quantize_tiles_ref(x[1:], tile=tile)
    assert _same(qk, qp) and _same(sk, sp)


@pytest.mark.parametrize("ratio", [0.01, 0.25])
@pytest.mark.parametrize("tile", WARP_TILES + BLOCK_TILES)
def test_cuda_topk_ef_routes(cuda_device, tile, ratio):
    # decay 0.9, the residual written in place (e_out is e), an all-zero
    # first tile, ties at exact halves in the last, a NaN tile
    route = "warp" if tile <= 1024 else "block"
    for n in _lengths(tile):
        g, e = _ef_inputs(n, seed=n + tile, nan=n >= 3 * tile, tile=tile)
        gt, et = torch.from_numpy(g), torch.from_numpy(e)
        buf = et.to(cuda_device)
        r0 = _route_count("topk_ef", route)
        got = tops.topk_ef(gt.to(cuda_device), buf, ratio=ratio, tile=tile,
                           decay=0.9, e_out=buf)
        torch.cuda.synchronize()
        assert _route_count("topk_ef", route) == r0 + 1 and got[1] is buf
        want = tref.topk_ef_ref(gt, et, ratio=ratio, tile=tile, decay=0.9)
        assert all(_same(a, b) for a, b in zip(got, want)), (n, tile)


@pytest.mark.parametrize("tile", [256, 1024, 2048])
def test_cuda_topk_ef_misaligned_views_in_place(cuda_device, tile):
    # g[1:] and e[1:] (bases 4 bytes past a 16-byte boundary), the residual
    # written into e[1:] itself; e[0] stays as it was
    n = 4 * tile + 1
    g, e = _ef_inputs(n, seed=tile + 2, nan=True, tile=tile)
    gt, et = torch.from_numpy(g), torch.from_numpy(e)
    gc, ec = gt.to(cuda_device), et.to(cuda_device)
    gv, ev = gc[1:], ec[1:]
    assert gv.is_contiguous() and gv.data_ptr() % 16 != 0
    got = tops.topk_ef(gv, ev, ratio=0.01, tile=tile, decay=0.9, e_out=ev)
    torch.cuda.synchronize()
    assert got[1] is ev and ec[0].item() == e[0]
    want = tref.topk_ef_ref(gt[1:], et[1:], ratio=0.01, tile=tile,
                            decay=0.9)
    assert all(_same(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# dequant_accum and topk_mask on their two routes
# ---------------------------------------------------------------------------

def _payloads(n: int, tile: int, w: int, seed: int):
    """w ranks' quantize_tiles payloads (CPU) of :func:`_input` values
    scaled by 1 + r: q (w, n) int8 and scales (w, ceil(n/tile)); rank
    min(1, w-1)'s second tile holds a NaN (a NaN scale, codes 0) when
    there are three tiles or more."""
    qs, ss = [], []
    for r in range(w):
        x = _input(n, tile, seed=seed + r) * np.float32(1 + r)
        if r == min(1, w - 1) and n >= 3 * tile:
            x[tile + tile // 2] = np.nan
        q, s = tref.quantize_tiles_ref(torch.from_numpy(x), tile=tile)
        qs.append(q)
        ss.append(s)
    return torch.stack(qs), torch.stack(ss)


def _check_dequant_accum(q, s, tile, cuda_device, route, qc=None):
    """dequant_accum of q, s (CPU) on the card, from ``qc`` (a CUDA view
    holding q's values) when given, on ``route``; bit-equal to the plain
    version on the CPU."""
    r0 = _route_count("dequant_accum", route)
    got = tops.dequant_accum(q.to(cuda_device) if qc is None else qc,
                             s.to(cuda_device), tile=tile)
    torch.cuda.synchronize()
    assert _route_count("dequant_accum", route) == r0 + 1
    assert _same(got, tref.dequant_accum_ref(q, s, tile=tile))


@pytest.mark.parametrize("w", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("tile", WARP_TILES + BLOCK_TILES)
def test_cuda_dequant_accum_routes(cuda_device, tile, w):
    # one tile, a ragged last tile (n % 16 != 0), 41 whole tiles and 16 of
    # them (n % 16 == 0 when tile % 16 == 0: the vector loads at w > 1); a
    # NaN tile, an all-zero tile, exact halves
    route = "warp" if tile <= 1024 else "block"
    for n in _lengths(tile) + (16 * tile,):
        q, s = _payloads(n, tile, w, seed=n + tile)
        _check_dequant_accum(q, s, tile, cuda_device, route)


@pytest.mark.parametrize("n", [2 * 1024 + 16, 2 * 1024 + 5])
@pytest.mark.parametrize("tile", [1024, 2048])
def test_cuda_dequant_accum_most_ranks(cuda_device, tile, n):
    # 1024 ranks, the most the kernels take, added in rank order
    q, s = _payloads(n, tile, 1024, seed=tile)
    _check_dequant_accum(q, s, tile, cuda_device,
                         "warp" if tile <= 1024 else "block")


@pytest.mark.parametrize("w", [1, 2])
@pytest.mark.parametrize("tile", [256, 1024, 2048])
def test_cuda_dequant_accum_misaligned_rows(cuda_device, tile, w):
    # q as rows of a buffer whose base is one byte past a 16-byte boundary
    # (contiguous: every tile takes the scalar loads), and q[:, 1:] (for
    # w > 1 not contiguous: the wrapper copies it)
    route = "warp" if tile <= 1024 else "block"
    n = 4 * tile
    q, s = _payloads(n + 1, tile, w, seed=tile + w)
    flat = torch.zeros(w * n + 1, dtype=torch.int8, device=cuda_device)
    qc = flat[1:].view(w, n)
    qc.copy_(q[:, :n].to(cuda_device))
    assert qc.is_contiguous() and qc.data_ptr() % 16 != 0
    s_n = s[:, :-(-n // tile)].contiguous()
    _check_dequant_accum(q[:, :n], s_n, tile, cuda_device, route, qc=qc)
    view = q.to(cuda_device)[:, 1:]
    _check_dequant_accum(q[:, 1:].contiguous(), s_n, tile, cuda_device,
                         route, qc=view)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ratio", [0.01, 0.25])
@pytest.mark.parametrize("tile", WARP_TILES + BLOCK_TILES)
def test_cuda_topk_mask_routes(cuda_device, tile, ratio, dtype):
    # an all-zero first tile, ties at exact halves in the last, a NaN tile
    route = "warp" if tile <= 1024 else "block"
    for n in _lengths(tile):
        x = torch.from_numpy(_input(n, tile, seed=n + tile + 1)).to(dtype)
        if n >= 3 * tile:
            x[tile + tile // 2] = float("nan")
        r0 = _route_count("topk_mask", route)
        got = tops.topk_mask(x.to(cuda_device), ratio=ratio, tile=tile)
        torch.cuda.synchronize()
        assert _route_count("topk_mask", route) == r0 + 1
        assert got.dtype == dtype
        want = tref.topk_mask_bisect_ref(x, ratio=ratio, tile=tile)
        assert _same(got, want), (n, tile)
        if n >= 3 * tile:                     # the NaN tile keeps nothing
            assert not got[tile:2 * tile].cpu().any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", [256, 1024, 2048])
def test_cuda_topk_mask_misaligned_view(cuda_device, tile, dtype):
    # x[1:]: contiguous, its base one element past a 16-byte boundary, so
    # every tile takes the scalar loads
    n = 4 * tile + 1
    x = torch.from_numpy(_input(n, tile, seed=tile + 3)).to(dtype)
    xc = x.to(cuda_device)[1:]
    assert xc.is_contiguous() and xc.data_ptr() % 16 != 0
    got = tops.topk_mask(xc, ratio=0.01, tile=tile)
    torch.cuda.synchronize()
    assert _same(got, tref.topk_mask_bisect_ref(x[1:], ratio=0.01,
                                                tile=tile))


@pytest.mark.parametrize("name", ["int8_fused", "topk_fused"])
def test_cuda_compress_without_error_feedback_launches_its_kernel(
        cuda_device, name):
    # the encode of a bucket without error feedback: one launch of
    # quantize_tiles (int8_fused) or topk_mask (topk_fused), on the warp
    # route at the wire's tile, bit-equal to the plain versions
    from repro_torch.core.compression import get_compressor
    comp = get_compressor(name)
    g = torch.from_numpy(_input(3 * 2065, TILE, seed=21)).reshape(3, 2065)
    kernel = "quantize_tiles" if name == "int8_fused" else "topk_mask"
    before, routes = tops.launch_counts(), tops.route_counts()
    payload, meta = comp.compress(g.to(cuda_device), None)
    torch.cuda.synchronize()
    after = tops.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == kernel) for k in after}
    assert tops.route_counts()[kernel]["warp"] == routes[kernel]["warp"] + 1
    flat = g.reshape(-1)
    if name == "int8_fused":
        assert meta == (3, 2065)
        want = tref.quantize_tiles_ref(flat, tile=TILE)
        assert all(_same(a, b) for a, b in zip(payload, want))
    else:
        assert meta is None and payload.shape == g.shape
        assert _same(payload.reshape(-1),
                     tref.topk_mask_bisect_ref(flat, tile=TILE))


# ---------------------------------------------------------------------------
# flash attention: the kernel against its plain version, within tolerance
# ---------------------------------------------------------------------------

# (B, T, H, KV, hd): the JAX kernel tests' shapes, hd 256 at G = 2 and
# G = 8, and ragged T (a partial last query and key tile)
FLASH_SHAPES = [(1, 128, 2, 2, 32), (2, 256, 4, 2, 64), (1, 128, 8, 1, 32),
                (2, 128, 4, 4, 128), (1, 192, 4, 2, 256), (1, 128, 8, 1, 256),
                (1, 200, 4, 2, 64), (2, 11, 4, 1, 32)]
FLASH_VARIANTS = [dict(), dict(window=64), dict(softcap=30.0),
                  dict(window=64, softcap=20.0), dict(causal=False),
                  dict(causal=False, window=64)]


def _qkv(B, T, H, KV, hd, dtype, seed, S=None):
    rng = np.random.default_rng(seed)
    S = T if S is None else S
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype) for shape in ((B, T, H, hd), (B, S, KV, hd),
                                             (B, S, KV, hd)))


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The bfloat16 ulp at |x|, 2^(floor(log2 |x|) - 7), and 0 at 0."""
    _, e = torch.frexp(x.abs())
    return torch.where(x != 0, torch.exp2((e - 8).float()), 0.0)


def _flash_close(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Element by element.  f32: rtol = atol = 1e-5 (sums in another
    order); bf16: 2 bf16 ulps of the element plus 2 of its row's largest
    magnitude (p is rounded to bf16 at another running max, and the
    output's own bf16 rounding can flip)."""
    dtype = got.dtype
    got, want = got.cpu().float(), want.cpu().float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        return False
    if dtype == torch.float32:
        return torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    row = want.abs().amax(dim=-1, keepdim=True)
    tol = 2 * _bf16_ulp(want) + 2 * _bf16_ulp(row)
    return bool(((got - want).abs() <= tol).all())


def _route_of(dtype, hd) -> str:
    return "wgmma" if dtype == torch.bfloat16 else "simt"


def _flash_wgmma() -> int:
    return tops.route_counts()["flash_attention"]["wgmma"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", FLASH_VARIANTS,
                         ids=lambda kw: "-".join(f"{k}={v}"
                                                 for k, v in kw.items())
                         or "causal")
def test_cuda_flash_matches_plain(cuda_device, dtype, variant):
    # bf16 takes the wgmma kernel, f32 the SIMT one
    for i, shape in enumerate(FLASH_SHAPES):
        q, k, v = _qkv(*shape, dtype, seed=i)
        n0 = tops.flash_attention.launches
        r0 = tops.route_counts()["flash_attention"]
        got = tops.flash_attention(q.to(cuda_device), k.to(cuda_device),
                                   v.to(cuda_device), **variant)
        torch.cuda.synchronize()
        assert tops.flash_attention.launches == n0 + 1
        route = _route_of(dtype, shape[-1])
        assert tops.route_counts()["flash_attention"][route] == r0[route] + 1
        assert got.dtype == dtype and got.is_contiguous()
        want = tref.flash_attention_ref(q.to(cuda_device), k.to(cuda_device),
                                        v.to(cuda_device), **variant)
        assert _flash_close(got, want), (shape, variant)


# the wgmma route's grid: ragged T and S, G = 1, 2, 3, 4, 8, every head dim
# (192: MLA's), and grids of 128-row blocks (two consumer warpgroups: B x H
# x ceil(T / 128) >= the SM count) beside 64-row ones
WGMMA_CASES = [
    # (B, T, S, H, KV, hd)
    (1, 11, 11, 2, 2, 32), (2, 200, 200, 4, 2, 64), (1, 150, 40, 8, 1, 128),
    (1, 200, 200, 8, 1, 256), (1, 11, 11, 16, 8, 256), (1, 150, 40, 2, 1, 64),
    (1, 1000, 1000, 136, 2, 64), (1, 520, 520, 48, 8, 256),
    (2, 300, 300, 34, 34, 32), (1, 200, 150, 144, 72, 128),
    (2, 75, 75, 16, 16, 192), (1, 150, 40, 8, 2, 192),
    (1, 300, 300, 48, 16, 192),
]


@pytest.mark.parametrize("B,T,S,H,KV,hd", WGMMA_CASES)
def test_cuda_flash_wgmma_route(cuda_device, B, T, S, H, KV, hd):
    q, k, v = (x.to(cuda_device) for x in _qkv(B, T, H, KV, hd,
                                                  torch.bfloat16, seed=T + H,
                                                  S=S))
    for variant in (dict(), dict(window=64, softcap=50.0),
                    dict(causal=False), dict(causal=False, window=30)):
        r0 = _flash_wgmma()
        got = tops.flash_attention(q, k, v, **variant)
        torch.cuda.synchronize()
        assert _flash_wgmma() == r0 + 1
        want = tref.flash_attention_ref(q, k, v, **variant)
        assert _flash_close(got, want), ((B, T, S, H, KV, hd), variant)


@pytest.mark.parametrize("hd", [16, 96, 160, 224])
def test_cuda_flash_wgmma_launcher_refuses_other_head_dims(cuda_device, hd):
    # strides and pointers the TMA takes, a head dim with no instantiation:
    # the C launcher refuses (cudaErrorInvalidValue) and launches nothing
    from repro_torch.kernels.flash_attention import (_launcher,
                                                     nonfinite_tiles_cuda)
    q, k, v = (x.to(cuda_device) for x in _qkv(1, 64, 2, 2, hd,
                                                  torch.bfloat16, seed=hd))
    out = torch.zeros_like(q)
    rc = _launcher("wgmma")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        nonfinite_tiles_cuda(v).data_ptr(), 1, 64, 64, 2, 2, hd,
        *(st for x in (q, k, v) for st in x.stride()[:3]), 1, 0, 0.0, 1,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 1 and not out.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_reads_strided_inputs(cuda_device, dtype):
    # q, k, v as views of one fused (B, T, H + 2 KV, hd) projection: the
    # kernels read them through their strides (the TMA's maps take them
    # as they are: no copy)
    from repro_torch.kernels.flash_attention import tma_ready
    B, T, H, KV, hd = 2, 100, 4, 2, 64
    fused = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (B, T, H + 2 * KV, hd)).astype(np.float32)).to(cuda_device, dtype)
    q, k, v = fused[:, :, :H], fused[:, :, H:H + KV], fused[:, :, H + KV:]
    assert not q.is_contiguous() and all(map(tma_ready, (q, k, v)))
    got = tops.flash_attention(q, k, v, window=30, softcap=25.0)
    want = tref.flash_attention_ref(q.contiguous(), k.contiguous(),
                                    v.contiguous(), window=30, softcap=25.0)
    assert _flash_close(got, want)


def test_cuda_flash_copies_what_the_tma_refuses(cuda_device):
    # a base 2 bytes past a 16-byte boundary, and a transposed last dim:
    # copied once, then the wgmma kernel runs
    from repro_torch.kernels.flash_attention import tma_ready
    q, k, v = (x.to(cuda_device) for x in _qkv(1, 64, 4, 2, 64,
                                                  torch.bfloat16, seed=4))
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda_device)
    q_odd = flat[1:].view(q.shape).copy_(q)
    k_t = k.transpose(2, 3).contiguous().transpose(2, 3)
    assert not tma_ready(q_odd) and not tma_ready(k_t)
    r0 = _flash_wgmma()
    got = tops.flash_attention(q_odd, k_t, v)
    assert _flash_wgmma() == r0 + 1
    assert _flash_close(got, tref.flash_attention_ref(q, k, v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_rows_without_a_key(cuda_device, dtype):
    # T > S with a window: rows q >= S + window - 1 have no valid key and
    # get the reference's mean of v; their query tiles visit every key tile
    q, k, v = _qkv(1, 150, 2, 1, 32, dtype, seed=3, S=40)
    for causal in (True, False):
        got = tops.flash_attention(q.to(cuda_device), k.to(cuda_device),
                                   v.to(cuda_device), causal=causal,
                                   window=20)
        want = tref.flash_attention_ref(q, k, v, causal=causal, window=20)
        assert _flash_close(got, want)
        mean = v.float().mean(dim=1, keepdim=True).expand(1, 150 - 59, 1, 32)
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        assert torch.allclose(got[:, 59:, :1].cpu().float(), mean, atol=tol)


@pytest.mark.parametrize("dtype,kernel", [
    (torch.float32, "simt"), (torch.bfloat16, "wgmma"),
    (torch.bfloat16, "simt")],
    ids=["f32-simt", "bf16-wgmma", "bf16-simt"])
def test_cuda_flash_skips_fully_masked_leading_tile(cuda_device, dtype,
                                                    kernel):
    # window 64 at T = 200: the query tiles from row 128 on skip key tile 0,
    # which holds only masked keys for them.  With finite v the skip is
    # exact.  With an inf at key 0 the reference (and the plain version)
    # gives NaN on every row that masks key 0 (0 * inf), rows 64 on; the
    # kernels' rows from 128 on never read it, and the pre-pass's record of
    # the key tiles holding a non-finite v makes them NaN all the same: NaN
    # exactly where the plain version has NaN, on both routes.
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     nonfinite_tiles_cuda)
    q, k, v = _qkv(1, 200, 4, 2, 64, dtype, seed=5)
    qc, kc = q.to(cuda_device), k.to(cuda_device)

    def run(vv):
        vc = vv.to(cuda_device)
        return flash_attention_cuda(qc, kc, vc, nonfinite_tiles_cuda(vc),
                                    True, 64, None, kernel).cpu()
    got = run(v)
    assert _flash_close(got, tref.flash_attention_ref(q, k, v, window=64))
    for d, val in ((None, float("inf")), (3, float("nan"))):
        v_bad = v.clone()
        if d is None:
            v_bad[:, 0] = val
        else:
            v_bad[:, 0, :, d] = val
        got_bad = run(v_bad)
        plain = tref.flash_attention_ref(q, k, v_bad, window=64)
        assert torch.isnan(plain[:, 64:, :, 3]).all()
        assert torch.equal(torch.isnan(got_bad), torch.isnan(plain))
        # rows 0-63 attend key 0: +inf there with the inf, as in the plain
        # version; every finite place is the finite run's
        inf, fin = torch.isinf(plain), torch.isfinite(plain)
        assert torch.equal(got_bad[inf], plain[inf])
        assert torch.equal(got_bad[fin], got[fin])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_nonfinite_tiles_bit_equal_to_plain(cuda_device, dtype):
    for B, S, KV, hd in ((1, 128, 1, 256), (2, 300, 3, 64), (1, 7, 2, 40)):
        v = torch.randn(B, S, KV, hd, generator=torch.Generator(
            "cpu").manual_seed(S)).to(dtype)
        n0 = tops.nonfinite_tiles.launches
        got = tops.nonfinite_tiles(v.to(cuda_device))
        assert tops.nonfinite_tiles.launches == n0 + 1
        assert not got.any()
        for s, kvh, d, val in ((0, 0, 0, "inf"), (S - 1, KV - 1, hd - 1,
                                                  "nan"),
                               (S // 2, 0, 5, "-inf"), (S // 3, 0, 5, "nan")):
            v[B - 1, s, kvh, d] = float(val)
        got = tops.nonfinite_tiles(v.to(cuda_device))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), tref.nonfinite_tiles_ref(v))


# ---------------------------------------------------------------------------
# ring_fused on a gloo group of 2 and 4 processes sharing the one card
# ---------------------------------------------------------------------------

RING_FUSED_N = 2 * 4 * 1024 * 3 + 37      # chunk rows off 16-byte boundaries


def _ring_fused_rank(rank: int, world: int, store: str, out: str) -> None:
    """One rank: the compressed ring on its card tensor (the kernel on
    every hop, tensors staged through the host for gloo) and on the same
    values on the CPU (the plain versions); saves both and the launch
    counts."""
    import torch.distributed as dist

    from repro_torch.core.collectives import allreduce, p2p
    from repro_torch.launch.dist import init_group
    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")   # no name lookup
    init_group(torch.device("cpu"), world_size=world, rank=rank,
               store_path=store)
    x = torch.from_numpy(_input(RING_FUSED_N, TILE, seed=40 + rank))
    tops.reset_launch_counts()
    got = allreduce(x.cuda(), "ring_fused").cpu()
    counts = {"launches": tops.launch_counts(),
              "routes": tops.route_counts()["quantize_tiles"]}
    want = allreduce(x.clone(), "ring_fused")
    np.savez(f"{out}/{rank}.npz", got=got.numpy(), want=want.numpy(),
             staged=p2p.staged_bytes(),
             counts=np.array([counts["launches"]["quantize_tiles"],
                              counts["routes"]["warp"],
                              sum(counts["launches"].values())]))
    dist.barrier()
    dist.destroy_process_group()


@pytest.mark.parametrize("world", [2, 4])
def test_cuda_ring_fused_gloo_world(cuda_device, tmp_path, world):
    # every rank decodes the same payloads: bit-equal across ranks and to
    # the same schedule on the CPU; quantize_tiles launches 2 streams x p
    # hops' encodes = 2p times, all on the warp route, and nothing else
    from repro_torch.kernels import build
    build.build_all(("quantize_tiles",))      # before the ranks start
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_ring_fused_rank,
                         args=(r, world, str(tmp_path / "store"),
                               str(tmp_path))) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * world
    res = [np.load(tmp_path / f"{r}.npz") for r in range(world)]
    for r in res:
        np.testing.assert_array_equal(r["got"], res[0]["got"])
        np.testing.assert_array_equal(r["got"], r["want"])
        assert r["counts"].tolist() == [2 * world] * 3
        assert int(r["staged"]) > 0
    exact = sum(_input(RING_FUSED_N, TILE, seed=40 + r).astype(np.float64)
                for r in range(world))
    assert np.abs(res[0]["got"] - exact).max() <= \
        2 * (world - 1) * np.abs(exact).max() / 127


# ---------------------------------------------------------------------------
# The MoE and MLA families' shapes: MLA's prefill attention at q/k head dim
# 192 (v padded from 128 with zeros) and qwen3-moe's GQA 32/4 at head dim
# 128, both on the wgmma route, and the int8 pools' latent tiles (512 for
# c_kv, 64 for k_rope) on quantize_tiles' warp route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,T,H,KV,hd,vw,route", [
    (1, 128, 16, 16, 192, 128, "wgmma"), (2, 75, 16, 16, 192, 128, "wgmma"),
    (1, 128, 32, 4, 128, 128, "wgmma"), (1, 128, 32, 8, 128, 128, "wgmma")],
    ids=["mla", "mla-ragged", "qwen3-moe", "jamba"])
def test_cuda_flash_new_family_shapes(cuda_device, B, T, H, KV, hd, vw,
                                      route):
    q, k, v = _qkv(B, T, H, KV, hd, torch.bfloat16, seed=hd + T)
    v[..., vw:] = 0.0
    q, k, v = (x.to(cuda_device) for x in (q, k, v))
    r0 = tops.route_counts()["flash_attention"][route]
    got = tops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert tops.route_counts()["flash_attention"][route] == r0 + 1
    assert _flash_close(got, tref.flash_attention_ref(q, k, v))
    vn = v.clone()
    vn[0, T - 10, 1, 3] = float("nan")       # a key the first rows skip
    got = tops.flash_attention(q, k, vn, causal=True)
    want = tref.flash_attention_ref(q, k, vn)
    assert torch.equal(got.isnan().cpu(), want.isnan().cpu())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,S,causal",
                         [(1, 512, False), (32, 512, False),
                          (512, 512, False), (1, 32, False),
                          (32, 32, False), (32, 32, True)],
                         ids=["cross-decode", "cross-prefill", "encoder",
                              "cross-decode-32-frames",
                              "encoder-32-frames", "decoder-self-prefill"])
def test_cuda_flash_encoder_decoder_shapes(cuda_device, T, S, causal,
                                           dtype):
    # seamless-m4t-large-v2's attention at batch 4, 16 heads of 64,
    # non-causal: the cross-attention at decode (T = 1) and at a 32-token
    # prefill against 512 frames, and the encoder; the same against the
    # serve CLI's 32 frames (its encoder's shape is also its
    # cross-attention's at prefill); and the decoder's causal
    # self-attention at the 32-token prompt.  bf16 on the wgmma route, f32
    # (the memory of f32 frames) on the SIMT route
    q, k, v = (x.to(cuda_device) for x in _qkv(4, T, 16, 16, 64, dtype,
                                                  seed=T + S, S=S))
    route = _route_of(dtype, 64)
    r0 = tops.route_counts()["flash_attention"][route]
    got = tops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tops.route_counts()["flash_attention"][route] == r0 + 1
    assert got.shape == q.shape and got.dtype == dtype
    assert _flash_close(got, tref.flash_attention_ref(q, k, v,
                                                      causal=causal))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T", [(1, 128), (2, 75)])
def test_cuda_flash_simt_at_mla_head_dim(cuda_device, dtype, B, T):
    # the SIMT kernel, called directly at MLA's head dim 192 (the route
    # bf16 took there before the wgmma instantiation; f32 still takes it),
    # equals the plain version
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     nonfinite_tiles_cuda)
    q, k, v = (x.to(cuda_device) for x in _qkv(B, T, 16, 16, 192, dtype,
                                                  seed=T + 1))
    v[..., 128:] = 0.0
    got = flash_attention_cuda(q, k, v, nonfinite_tiles_cuda(v), True, None,
                               None, "simt")
    torch.cuda.synchronize()
    assert _flash_close(got, tref.flash_attention_ref(q, k, v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,tile", [(131072, 512), (2048, 512),
                                    (3407872, 512), (16384, 64), (256, 64),
                                    (425984, 64), (6291456, 128),
                                    (524288, 128), (8192, 128),
                                    (1703936, 512), (26624, 512),
                                    (212992, 64), (3328, 64),
                                    (3145728, 128), (49152, 128),
                                    (1048576, 128), (16384, 128)])
def test_cuda_quantize_tiles_pool_lengths(cuda_device, n, tile, dtype):
    # every length deepseek-v2-lite-16b's, qwen3-moe-30b-a3b's and
    # jamba-v0.1-52b's int8 pools write at 4 slots x 256 (an admission's
    # row, a tick's entries), at the configurations' own depths and at
    # the depths their full-width serving runs are cut to (14, 24 and 16
    # layers; jamba's 16 hold K/V of 2 stacked attention layers, its 32
    # of 4)
    x = torch.from_numpy(_input(n, tile, seed=n + tile)).to(dtype)
    if n >= 3 * tile:
        x[tile + 3] = float("nan")
    r0 = _route_count("quantize_tiles", "warp")
    qk, sk = tops.quantize_tiles(x.to(cuda_device), tile=tile)
    torch.cuda.synchronize()
    assert _route_count("quantize_tiles", "warp") == r0 + 1
    qp, sp = tref.quantize_tiles_ref(x, tile=tile)
    assert _same(qk, qp) and _same(sk, sp)
