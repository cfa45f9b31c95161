"""The port's nine §3.2 compressors (``quantization.py``,
``sparsification.py``, ``lowrank.py``) and PowerSGD in the executor, at
world 1, against the JAX package's.

  * sign, int8, topk and threshold: payloads, decompressed gradients and
    EF residuals BIT-EQUAL to the JAX compressors run eagerly (op by op),
    except sign's scale, a mean whose summation order differs between
    the frameworks: within 1e-6 relative (its codes are bit-equal);
  * terngrad, qsgd and randomk draw through one function each
    (``quantization.bernoulli``, ``sparsification.choice``); fed the JAX
    draws, their payloads are bit-equal too (qsgd's L2 norm, a sum:
    within 1e-6 relative).  Their own draws are held statistically: the
    mean of 400 decodes is unbiased within 5 standard errors;
  * svd and powersgd factor with LAPACK and matmuls in another order:
    decompressed within 1e-5 of the gradient's largest magnitude (svd's
    factors up to the sign of each singular pair);
  * ``payload_bits``, ``aggregatable`` and ``unbiased`` equal JAX's, and
    the registry holds every name of JAX's;
  * PowerSGD through ``PlanExecutor`` (a leaf large enough to be
    factored, one that stays dense) for 3 rounds, the warm start taken
    from JAX (``lowrank.normal``): synced gradients, residuals and Q
    within 1e-5 of the largest magnitude, against the reference executor
    run in ``shard_map`` over a one-device mesh.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as Ps

import repro_torch.core.compression.lowrank as lowrank
import repro_torch.core.compression.quantization as quantization
import repro_torch.core.compression.sparsification as sparsification
from repro.core import PlanExecutor as JExec
from repro.core import SyncConfig as JCfg
from repro.core import plan_from_config as jplan
from repro.core.compression import REGISTRY as JREGISTRY
from repro.core.compression import apply_with_feedback as japply
from repro.core.compression import get_compressor as jget
from repro_torch.core import PlanExecutor, SyncConfig, plan_from_config
from repro_torch.core.compression import (REGISTRY, apply_with_feedback,
                                          get_compressor)
from repro_torch.launch.dist import init_group

NINE = ["sign", "terngrad", "qsgd", "int8", "topk", "randomk", "threshold",
        "powersgd", "svd"]
KWARGS = {"topk": {"ratio": 0.1}, "randomk": {"ratio": 0.1},
          "threshold": {"tau": 0.5}, "powersgd": {"rank": 3},
          "svd": {"rank": 3}}
SHAPES = [(2500,), (64, 33)]
SHAPE_IDS = ["1d", "2d"]


def _g(shape, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(shape).astype(np.float32)
    e = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return g, e


def _leaves(payload):
    return list(payload) if isinstance(payload, tuple) else [payload]


class JaxDraws:
    """Feeds the port's draw functions what ``jax.random`` draws for
    ``key`` (the reference's ``bernoulli`` / ``choice``)."""

    def __init__(self, key):
        self.key = key

    def bernoulli(self, p, rng):
        b = jax.random.bernoulli(self.key, jnp.asarray(p.numpy()))
        return torch.from_numpy(np.array(b))

    def choice(self, d, k, rng):
        idx = jax.random.choice(self.key, d, (k,), replace=False)
        return torch.from_numpy(np.asarray(idx).astype(np.int64))


@pytest.fixture
def jax_draws(monkeypatch):
    draws = JaxDraws(jax.random.PRNGKey(7))
    monkeypatch.setattr(quantization, "bernoulli", draws.bernoulli)
    monkeypatch.setattr(sparsification, "choice", draws.choice)
    return draws


def _compare_payload(name, got, want):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name in ("sign", "qsgd") and a.ndim == 0:
            # a per-tensor reduction: summation order (module docstring)
            np.testing.assert_allclose(a, b, rtol=1e-6)
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("name", ["sign", "int8", "topk", "threshold",
                                  "terngrad", "qsgd", "randomk"])
def test_payload_and_decompress_equal_jax(jax_draws, name, shape):
    kw = KWARGS.get(name, {})
    comp, jcomp = get_compressor(name, **kw), jget(name, **kw)
    g, _ = _g(shape, seed=3)
    payload, meta = comp.compress(torch.from_numpy(g), torch.Generator())
    jpayload, jmeta = jcomp.compress(jnp.asarray(g), jax_draws.key)
    _compare_payload(name, payload, jpayload)
    got = comp.decompress(payload, meta).numpy()
    want = np.asarray(jcomp.decompress(jpayload, jmeta))
    assert got.shape == want.shape == shape
    if name in ("sign", "qsgd"):
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["sign", "int8", "topk", "threshold"])
def test_error_feedback_step_equals_jax(name):
    kw = KWARGS.get(name, {})
    comp, jcomp = get_compressor(name, **kw), jget(name, **kw)
    g, e = _g((64, 33), seed=4)
    g_hat, e_new = apply_with_feedback(comp, torch.from_numpy(g),
                                       torch.from_numpy(e), None, 0.9)
    jg_hat, je_new = japply(jcomp, jnp.asarray(g), jnp.asarray(e), None, 0.9)
    if name == "sign":
        np.testing.assert_allclose(g_hat.numpy(), np.asarray(jg_hat),
                                   rtol=1e-6)
        np.testing.assert_allclose(e_new.numpy(), np.asarray(je_new),
                                   rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(g_hat.numpy(), np.asarray(jg_hat))
        np.testing.assert_array_equal(e_new.numpy(), np.asarray(je_new))


@pytest.mark.parametrize("shape", SHAPES + [(40, 3, 7)],
                         ids=SHAPE_IDS + ["3d"])
def test_svd_matches_jax(shape):
    comp, jcomp = get_compressor("svd", rank=3), jget("svd", rank=3)
    g, _ = _g(shape, seed=5)
    (us, vt), meta = comp.compress(torch.from_numpy(g))
    (jus, jvt), jmeta = jcomp.compress(jnp.asarray(g))
    assert us.shape == jus.shape and vt.shape == jvt.shape
    # a singular pair is defined up to its sign
    sign = np.sign(np.sum(vt.numpy() * np.asarray(jvt), axis=1))
    tol = 1e-5 * np.abs(g).max()
    np.testing.assert_allclose(vt.numpy() * sign[:, None], np.asarray(jvt),
                               atol=1e-5)
    np.testing.assert_allclose(us.numpy() * sign, np.asarray(jus), atol=tol)
    np.testing.assert_allclose(comp.decompress((us, vt), meta).numpy(),
                               np.asarray(jcomp.decompress((jus, jvt),
                                                           jmeta)), atol=tol)


@pytest.mark.parametrize("shape", SHAPES + [(40, 3, 7)],
                         ids=SHAPE_IDS + ["3d"])
def test_powersgd_compress_matches_jax(shape):
    comp, jcomp = get_compressor("powersgd", rank=3), \
        jget("powersgd", rank=3)
    g, _ = _g(shape, seed=6)
    d = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
    n = shape[0] if len(shape) > 1 else 1
    q0 = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                      (d, min(3, n, d))))
    (p, q), meta = comp.compress(torch.from_numpy(g),
                                 q_prev=torch.from_numpy(q0.copy()))
    (jp, jq), jmeta = jcomp.compress(jnp.asarray(g), q_prev=jnp.asarray(q0))
    tol = 1e-5 * np.abs(g).max() * np.abs(q0).max() * d
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-5)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=tol)
    np.testing.assert_allclose(comp.decompress((p, q), meta).numpy(),
                               np.asarray(jcomp.decompress((jp, jq), jmeta)),
                               atol=1e-5 * np.abs(g).max())


def _draw_std(name, g: torch.Tensor) -> torch.Tensor:
    """Each element's standard deviation of one decode."""
    a = torch.abs(g)
    if name == "terngrad":
        s = a.max()
        return s * torch.sqrt(a / s * (1 - a / s))
    if name == "qsgd":
        step = torch.linalg.vector_norm(g) / 127
        f = a / step - torch.floor(a / step)
        return step * torch.sqrt(f * (1 - f))
    keep = KWARGS["randomk"]["ratio"]          # randomk: kept w.p. k/d
    return a * (1 / keep - 1) ** 0.5


@pytest.mark.parametrize("name", ["terngrad", "qsgd", "randomk"])
def test_stochastic_compressors_unbiased_with_own_draws(name):
    comp = get_compressor(name, **KWARGS.get(name, {}))
    assert comp.unbiased
    g = torch.from_numpy(_g((200,), seed=8)[0])
    rng = torch.Generator().manual_seed(0)
    mean = torch.stack([comp.roundtrip(g, rng) for _ in range(400)]).mean(0)
    # five standard errors of a 400-draw mean
    assert torch.all(torch.abs(mean - g) <= 5 * _draw_std(name, g) / 20
                     + 1e-5)


def test_stochastic_compressors_need_a_generator():
    g = torch.ones(8)
    for name in ("terngrad", "qsgd", "randomk"):
        with pytest.raises(ValueError, match="Generator"):
            get_compressor(name).compress(g, None)


@pytest.mark.parametrize("shape", [(2048,), (1000,), (64, 33), (7,),
                                   (3, 1024, 5)])
@pytest.mark.parametrize("name", NINE)
def test_payload_bits_and_flags_equal_jax(name, shape):
    kw = KWARGS.get(name, {})
    comp, jcomp = get_compressor(name, **kw), jget(name, **kw)
    assert comp.payload_bits(shape) == jcomp.payload_bits(shape)
    assert comp.aggregatable == jcomp.aggregatable
    assert comp.unbiased == jcomp.unbiased
    assert comp.name == jcomp.name == name


def test_registry_holds_every_jax_compressor():
    assert set(REGISTRY) == set(JREGISTRY)


# ---------------------------------------------------------------------------
# PowerSGD through the executor, warm start from JAX
# ---------------------------------------------------------------------------

PSGD_SHAPES = {"b": (33,), "w": (96, 64)}      # b stays dense


@pytest.fixture(scope="module")
def world1():
    init_group(torch.device("cpu"))


def test_powersgd_executor_matches_jax_over_three_rounds(world1,
                                                         monkeypatch):
    cfg = dict(compressor="powersgd", algo="ring",
               compressor_args=(("rank", 4),))
    rng = np.random.default_rng(9)
    steps = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in PSGD_SHAPES.items()} for _ in range(3)]
    gj = {k: jnp.asarray(v) for k, v in steps[0].items()}
    jex = JExec(jplan(JCfg(**cfg), gj), ("data",))
    jstate = jex.init_state(gj)
    # the port draws its warm start where the reference does, from JAX
    monkeypatch.setattr(lowrank, "normal", lambda shape, rng, device=None:
                        torch.from_numpy(np.array(jax.random.normal(
                            jax.random.PRNGKey(2 * 7919 + 64), shape))))
    ex = PlanExecutor(plan_from_config(SyncConfig(**cfg),
                                       {k: torch.from_numpy(v) for k, v in
                                        steps[0].items()}))
    state = ex.init_state({k: torch.from_numpy(v)
                           for k, v in steps[0].items()})
    assert [q is None for q in state["q"]] == [q is None
                                               for q in jstate["q"]]
    for q, jq in zip(state["q"], jstate["q"]):
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))

    mesh = jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    f = jax.jit(jax.shard_map(lambda g_, s_, r_: jex(g_, s_, r_), mesh=mesh,
                              in_specs=(Ps(), Ps(), Ps()),
                              out_specs=(Ps(), Ps()), axis_names={"data"},
                              check_vma=False))
    for g in steps:
        synced, state = ex({k: torch.from_numpy(v.copy())
                            for k, v in g.items()}, state)
        jsynced, jstate = f({k: jnp.asarray(v) for k, v in g.items()},
                            jstate, jax.random.PRNGKey(0))
        tol = 1e-5 * max(np.abs(v).max() for v in g.values())
        for k in PSGD_SHAPES:
            np.testing.assert_allclose(synced[k].numpy(),
                                       np.asarray(jsynced[k]), atol=tol)
        for e, je in zip(state["error"], jstate["error"]):
            np.testing.assert_allclose(e.numpy(), np.asarray(je), atol=tol)
        for q, jq in zip(state["q"], jstate["q"]):
            jq = np.asarray(jq)
            np.testing.assert_allclose(q.numpy(), jq, atol=1e-5 * np.abs(
                jq).max(initial=0.0))
    # the factored leaf is not its dense mean: the wire compressed it
    assert not np.allclose(synced["w"].numpy(), steps[-1]["w"], atol=1e-3)
