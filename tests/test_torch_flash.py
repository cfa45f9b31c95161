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
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models.attention import attention_reference
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
