"""The port's attention kernel entry (``repro_torch.kernels.ops
.flash_attention``) on the CPU — its plain version — against the JAX
package: the Pallas kernel ``repro.kernels.ops.flash_attention`` (run in
interpret mode off the TPU, ``q_blk = kv_blk = 64``) over the shapes and
variants of ``tests/test_kernels.py``, and the naive
``attention_reference`` where the Pallas kernel's tiling assert refuses
the shape (ragged T, T != S).

Tolerances: f32 ``rtol = atol = 1e-5`` (the same sums in another order);
bf16 ``3e-2``, as the JAX kernel tests hold the Pallas kernel against its
f32 oracle (the port rounds p to bf16 before the p·v product, as the
JAX model path's twin does; the Pallas kernel widens v to f32 first).

Also here: the NaN rule for a v holding inf or NaN at masked positions
(the plain version against the JAX model path and the interpreted Pallas
kernel, which both visit every key tile), the pre-pass's plain version,
and the pure-Python parts of the kernel wrapper (route, grid and stride
choices) that decide what the card runs.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import attention as jattention
from repro.models.attention import attention_reference
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _inputs(B, T, H, KV, hd, seed, S=None):
    rng = np.random.default_rng(seed)
    S = T if S is None else S
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, T, H, hd), (B, S, KV, hd), (B, S, KV, hd)))


def _torch(xs, dtype):
    return tuple(torch.from_numpy(x).to(dtype) for x in xs)


def _jax(xs, dtype):
    return tuple(jnp.asarray(x).astype(dtype) for x in xs)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,T,H,KV,hd", [
    (1, 128, 2, 2, 32), (2, 256, 4, 2, 64), (1, 128, 8, 1, 32),
    (2, 128, 4, 4, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_shapes(B, T, H, KV, hd, dtype):
    xs = _inputs(B, T, H, KV, hd, seed=T + hd)
    out = tops.flash_attention(*_torch(xs, getattr(torch, dtype)))
    ref = jops.flash_attention(*_jax(xs, getattr(jnp, dtype)), q_blk=64,
                               kv_blk=64)
    assert out.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("kwargs", [
    dict(window=64), dict(softcap=30.0), dict(window=64, softcap=20.0),
    dict(causal=False), dict(causal=False, window=64),
])
def test_plain_matches_pallas_variants(kwargs):
    xs = _inputs(1, 256, 4, 2, 32, seed=11)
    out = tops.flash_attention(*_torch(xs, torch.float32), **kwargs)
    ref = jops.flash_attention(*_jax(xs, jnp.float32), q_blk=64, kv_blk=64,
                               **kwargs)
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T,S,kwargs", [
    (200, 200, dict()), (200, 200, dict(window=64, softcap=50.0)),
    (11, 11, dict(window=4)), (200, 200, dict(causal=False, window=30)),
    # rows q >= S + window - 1 have no valid key: the mean of v
    (70, 24, dict(window=8)), (70, 24, dict(causal=False, window=8)),
])
def test_plain_matches_reference_ragged(T, S, kwargs):
    xs = _inputs(2, T, 4, 2, 32, seed=T + S, S=S)
    out = tops.flash_attention(*_torch(xs, torch.float32), **kwargs)
    ref = attention_reference(*_jax(xs, jnp.float32), **kwargs)
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=1e-5, atol=1e-5)


def test_plain_chunks_rows_without_changing_them(monkeypatch):
    # the plain version takes FLASH_Q_CHUNK query rows at a time (a 6144
    # prompt takes six steps); smaller chunks must give the same bits
    q, k, v = _torch(_inputs(1, 50, 4, 1, 16, seed=2), torch.bfloat16)
    whole = tref.flash_attention_ref(q, k, v, window=9, softcap=5.0)
    for chunk in (1, 7, 64):
        monkeypatch.setattr(tref, "FLASH_Q_CHUNK", chunk)
        assert torch.equal(tref.flash_attention_ref(
            q, k, v, window=9, softcap=5.0), whole)


def test_cpu_call_launches_no_kernel_and_checks_shapes():
    q, k, v = _torch(_inputs(1, 16, 4, 2, 8, seed=1), torch.float32)
    tops.reset_launch_counts()
    tops.flash_attention(q, k, v)
    assert tops.flash_attention.launches == 0
    with pytest.raises(ValueError):
        tops.flash_attention(q, k[:, :, :1].expand(1, 16, 3, 8),
                             v[:, :, :1].expand(1, 16, 3, 8))
    with pytest.raises(ValueError):
        tops.flash_attention(q, k, v, window=0)
    with pytest.raises(TypeError):
        tops.flash_attention(q, k.double(), v)


# ---------------------------------------------------------------------------
# The NaN rule: a non-finite v at a key masked for row t makes out[t] NaN
# ---------------------------------------------------------------------------

# (position, kv head, d, value) of v; with T = 128 and window 48, key 3 is
# masked for rows 0-2 (causal) and 51-127 (window), key 100 for rows 0-99
NONFINITE_V = ((3, 0, 1, np.inf), (100, 1, 5, np.nan), (40, 0, 7, -np.inf),
               (127, 1, 2, np.inf), (64, 0, 1, np.nan))


def _rule_mask(T, S, H, KV, hd, kwargs):
    """(T, H, hd) True where the rule demands NaN: some key masked for the
    row holds a non-finite v in that head's KV head and that dim."""
    causal, window = kwargs.get("causal", True), kwargs.get("window")
    t = np.arange(T)[:, None]
    s = np.arange(S)[None, :]
    valid = np.ones((T, S), bool)
    if causal:
        valid &= s <= t
    if window is not None:
        valid &= t - s < window
        if not causal:
            valid &= s - t < window
    out = np.zeros((T, H, hd), bool)
    G = H // KV
    for pos, kvh, d, _ in NONFINITE_V:
        for h in range(kvh * G, (kvh + 1) * G):
            out[:, h, d] |= ~valid[:, pos]
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kwargs", [
    dict(), dict(window=48), dict(window=48, softcap=30.0),
    dict(causal=False, window=48)],
    ids=["causal", "window", "window-softcap", "noncausal-window"])
def test_plain_nan_rule_matches_jax(kwargs, dtype):
    B, T, H, KV, hd = 1, 128, 4, 2, 16
    q, k, v = _inputs(B, T, H, KV, hd, seed=21)
    for pos, kvh, d, val in NONFINITE_V:
        v[0, pos, kvh, d] = val
    out = _f32(tops.flash_attention(*_torch((q, k, v), getattr(torch, dtype)),
                                    **kwargs))[0]
    jx = _jax((q, k, v), getattr(jnp, dtype))
    refs = {"model path": jattention.flash_attention(*jx, q_chunk=32,
                                                     kv_chunk=32, **kwargs),
            "pallas": jops.flash_attention(*jx, q_blk=64, kv_blk=64,
                                           **kwargs)}
    rule = _rule_mask(T, T, H, KV, hd, kwargs)
    assert rule.any() and np.isnan(out[rule]).all()
    tol = 1e-5 if dtype == "float32" else 3e-2
    for name, ref in refs.items():
        ref = _f32(ref)[0]
        np.testing.assert_array_equal(np.isnan(out), np.isnan(ref),
                                      err_msg=name)
        # elsewhere: equal infinities, finite values within tolerance
        np.testing.assert_allclose(out, ref, rtol=tol, atol=tol,
                                   err_msg=name)


def _tiles_numpy(v: np.ndarray) -> np.ndarray:
    """The pre-pass's output by loops: a flag per (key tile of 64, b·KV +
    kv head), then per (tile, b·KV + kv head) ceil(hd / 32) words of
    head-dim bits, as int32."""
    B, S, KV, hd = v.shape
    nt, nw = -(-S // 64), -(-hd // 32)
    flags = np.zeros((nt, B * KV), np.int64)
    words = np.zeros((nt, B * KV, nw), np.int64)
    for c in range(nt):
        for b in range(B):
            for kvh in range(KV):
                bad = ~np.isfinite(v[b, 64 * c:64 * (c + 1), kvh])  # (., hd)
                flags[c, b * KV + kvh] = bad.any()
                for d in np.flatnonzero(bad.any(axis=0)):
                    words[c, b * KV + kvh, d // 32] |= 1 << (d % 32)
    return np.concatenate([flags.ravel(), words.ravel()]).astype(
        np.uint32).view(np.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nonfinite_tiles_ref(dtype):
    rng = np.random.default_rng(4)
    v = rng.standard_normal((2, 150, 3, 40)).astype(np.float32)
    got = tops.nonfinite_tiles(torch.from_numpy(v).to(dtype))
    assert got.dtype == torch.int32 and got.shape == (3 * 6 * 3,)
    assert not got.any()
    for s, b, kvh, d, val in ((0, 0, 0, 0, np.inf), (149, 1, 2, 39, np.nan),
                              (5, 1, 1, 31, -np.inf), (70, 1, 1, 31, np.nan),
                              (127, 1, 1, 3, np.inf), (128, 0, 2, 32, np.inf)):
        v[b, s, kvh, d] = val
    want = _tiles_numpy(v)
    got = tops.nonfinite_tiles(torch.from_numpy(v).to(dtype))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:18].sum() == 5          # five (tile, b·KV + kv head) flags
    assert (want == np.int32(-2**31)).any()   # bit 31 (d = 31) as uint32


# ---------------------------------------------------------------------------
# The wrapper's choices: route, consumer warpgroups, copies for the TMA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [32, 64, 128, 192, 256])
def test_route_tensor_cores_for_bf16(hd):
    assert tflash.route(torch.bfloat16, hd) == "wgmma"
    assert tflash.route(torch.float32, hd) == "simt"


@pytest.mark.parametrize("hd", [8, 16, 48, 80, 96, 200])
def test_route_simt_for_other_head_dims(hd):
    assert tflash.route(torch.bfloat16, hd) == "simt"
    assert tflash.route(torch.float32, hd) == "simt"


@pytest.mark.parametrize("B,T,H,want", [
    (1, 128, 8, 1),       # gemma-2b prefill: 8 blocks of 128 rows
    (1, 6144, 16, 2),     # gemma2-9b prefill: 768 blocks
    (1, 1000, 17, 2),     # 8 x 17 = 136 blocks
    (2, 300, 20, 1),      # 3 x 20 x 2 = 120 blocks
])
def test_consumers_fill_the_card(B, T, H, want):
    assert tflash.consumers(B, T, H, sm_count=132) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tma_ready_decides_copies(dtype):
    x = torch.zeros(2, 16, 6, 64, dtype=dtype)
    assert tflash.tma_ready(x)
    # q, k, v as views of one fused projection, as a model may hand them
    fused = torch.zeros(2, 16, 8, 64, dtype=dtype)
    assert all(tflash.tma_ready(t) for t in
               (fused[:, :, :4], fused[:, :, 4:6], fused[:, :, 6:]))
    # last dim not contiguous
    assert not tflash.tma_ready(x.transpose(2, 3))
    # base 2 or 4 bytes past a 16-byte boundary
    flat = torch.zeros(x.numel() + 1, dtype=dtype)
    assert not tflash.tma_ready(flat[1:].view(2, 16, 6, 64))
    # head stride of 4 elements: 8 or 16 bytes
    narrow = torch.zeros(2, 16, 6, 4, dtype=dtype)
    assert tflash.tma_ready(narrow) == (dtype == torch.float32)
    # a stride that is not a positive multiple of 16 bytes, even of a dim
    # of extent 1, is refused (the kernel's launcher refuses it too)
    one = torch.zeros(64 * 6 * 3 + 8, dtype=dtype).as_strided(
        (1, 3, 6, 64), (7, 6 * 64, 64, 1))
    assert not tflash.tma_ready(one)
    assert tflash.tma_ready(one.clone(memory_format=torch.contiguous_format))
    assert not tflash.tma_ready(x[:1].expand(2, 16, 6, 64))
