"""The port's compressors (``repro_torch.core.compression``) against the JAX
package's.

On the CPU the fused hooks run the kernels' plain versions.  Held here:

  * the port's fused hooks are BIT-IDENTICAL to its own decomposed chain
    (EF add -> compress -> decompress -> residual), payload and residual,
    over ragged and 2-D leaves, f32 and bf16 gradients and two decays (the
    reference's ``test_fused_hooks_bit_identical_to_chain``);
  * the fused decode equals the per-rank decompress loop in rank order;
  * payloads and residuals equal the JAX compressors' (run eagerly, op by
    op, so XLA fuses nothing: bit-equal), and ``payload_bits`` is the same;
  * the compressors of ``quantization.py``, ``sparsification.py`` and
    ``lowrank.py`` round-trip as the JAX ones do (held in full in
    ``tests/test_torch_compressors.py``); an unknown name raises.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compression import apply_with_feedback as japply
from repro.core.compression import get_compressor as jget
from repro_torch.core.compression import apply_with_feedback, get_compressor

FUSED = [("int8_fused", {}), ("topk_fused", {"ratio": 0.25})]
IDS = [f[0] for f in FUSED]


def _ge(shape, dtype, seed):
    """g (in ``dtype``) and an f32 residual e, the same values as torch
    tensors and JAX arrays."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(shape).astype(np.float32)
    e = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    gj = jnp.asarray(g, dtype)
    gt = torch.from_numpy(np.array(gj.astype(jnp.float32)))
    if dtype == "bfloat16":
        gt = gt.to(torch.bfloat16)
    return gt, torch.from_numpy(e), gj, jnp.asarray(e)


def _leaves(payload):
    """A payload's arrays: a tuple's entries, or the one array."""
    return list(payload) if isinstance(payload, tuple) else [payload]


@pytest.mark.parametrize("decay", [1.0, 0.9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2500,), (64, 33)], ids=["ragged-1d", "2d"])
@pytest.mark.parametrize("name,kw", FUSED, ids=IDS)
def test_fused_hooks_bit_identical_to_chain(name, kw, shape, dtype, decay):
    comp = get_compressor(name, tile=1024, **kw)
    g, e, _, _ = _ge(shape, dtype, seed=len(shape) * 11)
    # the hook writes the new residual into the buffer it is given
    e_buf = e.clone()
    pf, mf, ef = comp.fused_ef_compress(g, e_buf, decay)
    assert ef is e_buf
    corrected = g.to(torch.float32) + decay * e
    pu, mu = comp.compress(corrected, None)
    eu = corrected - comp.decompress(pu, mu)
    assert mf == mu
    for a, b in zip(_leaves(pf), _leaves(pu)):
        assert torch.equal(a, b), f"{name} payload"
    assert torch.equal(ef, eu), f"{name} residual"
    assert ef.shape == g.shape and ef.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2500,), (64, 33)], ids=["ragged-1d", "2d"])
@pytest.mark.parametrize("name,kw", FUSED, ids=IDS)
def test_payloads_and_residuals_equal_jax(name, kw, shape, dtype):
    comp = get_compressor(name, tile=1024, **kw)
    jcomp = jget(name, tile=1024, **kw)
    g, e, gj, ej = _ge(shape, dtype, seed=7 + len(shape))
    for a, b in zip(_leaves(comp.compress(g.to(torch.float32), None)[0]),
                    _leaves(jcomp.compress(gj.astype(jnp.float32), None)[0])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    g_hat, e_new = apply_with_feedback(comp, g, e, None, 1.0)
    jg_hat, je_new = japply(jcomp, gj, ej, None, 1.0)
    np.testing.assert_array_equal(g_hat.numpy(), np.asarray(jg_hat))
    np.testing.assert_array_equal(e_new.numpy(), np.asarray(je_new))


def test_fused_decode_sum_matches_per_rank_loop():
    comp = get_compressor("int8_fused", tile=1024)
    n, w = 2500, 8
    rng = np.random.default_rng(3)
    payloads = [comp.compress(torch.from_numpy(
        (rng.standard_normal(n) * (1 + i)).astype(np.float32)), None)[0]
        for i in range(w)]
    gathered = (torch.stack([p[0] for p in payloads]),
                torch.stack([p[1] for p in payloads]))
    got = comp.fused_decode_sum(gathered, (n,))
    want = comp.decompress(payloads[0], (n,))
    for p in payloads[1:]:
        want = want + comp.decompress(p, (n,))
    assert got.shape == (n,)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(2048,), (1000,), (64, 33), (7,),
                                   (3, 1024, 5)])
@pytest.mark.parametrize("name,kw", FUSED + [("none", {})],
                         ids=IDS + ["none"])
def test_payload_bits_equal_jax(name, kw, shape):
    comp, jcomp = get_compressor(name, **kw), jget(name, **kw)
    assert comp.payload_bits(shape) == jcomp.payload_bits(shape)
    assert comp.aggregatable == jcomp.aggregatable


def test_payload_bits_values():
    i8 = get_compressor("int8_fused", tile=1024)
    assert i8.payload_bits((2048,)) == 2048 * 8 + 2 * 32
    assert i8.payload_bits((1000,)) == 1000 * 8 + 32
    tk = get_compressor("topk_fused", ratio=0.25, tile=1024)
    assert tk.payload_bits((2048,)) == 2 * 256 * 64
    assert tk.aggregatable and not i8.aggregatable


@pytest.mark.parametrize("name", ["sign", "qsgd", "int8", "topk", "powersgd"])
def test_unported_compressors_name_the_roadmap(name, monkeypatch):
    # ported now: each round-trips as its JAX counterpart does (qsgd fed
    # the JAX draws; sign, qsgd and powersgd within 1e-6 of the largest
    # magnitude, their scales being sums); an unknown name still raises
    # KeyError
    import jax

    import repro_torch.core.compression.quantization as quantization
    key = jax.random.PRNGKey(0)
    monkeypatch.setattr(quantization, "bernoulli", lambda p, rng: (
        torch.from_numpy(np.array(jax.random.bernoulli(
            key, jnp.asarray(p.numpy()))))))
    comp, jcomp = get_compressor(name), jget(name)
    g = np.random.default_rng(5).standard_normal((64, 33)).astype(np.float32)
    gt, gj = torch.from_numpy(g), jnp.asarray(g)
    if name == "powersgd":
        q0 = np.random.default_rng(6).standard_normal((33, 4)).astype(
            np.float32)
        got = comp.decompress(*comp.compress(gt, q_prev=torch.from_numpy(q0)))
        want = jcomp.decompress(*jcomp.compress(gj, q_prev=jnp.asarray(q0)))
    else:
        got, want = comp.roundtrip(gt, torch.Generator()), \
            jcomp.roundtrip(gj, key)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6 * np.abs(g).max())
    assert comp.payload_bits((64, 33)) == jcomp.payload_bits((64, 33))
    with pytest.raises(KeyError):
        get_compressor("no-such-compressor")
