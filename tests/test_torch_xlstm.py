"""The port's xLSTM blocks (``repro_torch.models.xlstm``: mLSTM in its
sequential and chunkwise forms, sLSTM) and the xlstm-125m model against
the JAX package, on the same weights (``params_from_jax``) and numpy-made
inputs, in f32.

The config is ``reduced()``: one 4-layer period (3 mLSTM + 1 sLSTM, as
the full model's 3 x 4), d_model 256, 4 heads, mlstm_chunk 16.

Tolerances, each relative to the largest magnitude of the reference's
tensor: one block's output, state and decode 1e-5 (two frameworks' f32
matmul and exp kernels over one layer); the chunkwise mLSTM against the
sequential recurrence 1e-4 (the reference test's bound: a different
summation order of the exponential gates); a whole model's loss 1e-5,
its gradients, prefill and decode logits and states 1e-4 (the model
tests' bound).  sqrt(dh) in bf16 and k / sqrt(dh) are held EXACTLY.  The
engine's tokens at temperature 0 are held EQUAL to a batched
``generate``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.models import xlstm as jx
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax, to_numpy
from repro_torch.kernels import ops
from repro_torch.launch.serve import generate
from repro_torch.models import Model, count_params
from repro_torch.models import xlstm as tx
from repro_torch.serve import Engine, Request, ServeConfig

ARCH = "xlstm-125m"
REL_LAYER = 1e-5
REL_MODEL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the recurrences are loops of small ops, which
    threads only slow down (and more so beside other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, rel):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.abs(b).max(), 1e-30)
    err = np.abs(a - b).max()
    assert err <= rel * scale, f"max|Δ|={err:.3e} > {rel}·{scale:.3e}"


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def xl():
    jcfg = jreduced(jget_config(ARCH))
    cfg = reduced(get_config(ARCH))
    jmodel = JModel(jcfg)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    params = params_from_jax(tree, cfg, device="cpu")
    return jcfg, jmodel, tree, cfg, Model(cfg), params


def _layer(xl, mixer):
    jcfg, _, tree, cfg, _, params = xl
    seg = cfg.stack_plan()[0]
    i = [s.mixer for s in seg.period].index(mixer)
    return (jcfg, tree["stack"][0][i]["mixer"], cfg,
            params["stack"][0][i]["mixer"])


def test_xlstm_plan_and_param_count():
    for full in (False, True):
        j, t = jget_config(ARCH), get_config(ARCH)
        if not full:
            j, t = jreduced(j), reduced(t)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert count_params(t) == j.num_params()
    plan = get_config(ARCH).stack_plan()
    assert [(tuple(s.mixer for s in seg.period), seg.repeats)
            for seg in plan] == [(("mlstm",) * 3 + ("slstm",), 3)]
    assert not get_config(ARCH).mlstm_parallel
    assert count_params(get_config(ARCH)) == 189_155_400


def test_sqrt_dh_is_rounded_to_bf16_and_divides_exactly():
    # xlstm-125m: dh = 2 * 768 / 4 = 384; sqrt(384) = 19.596 is 19.625 in
    # bf16, and k is divided by that, not by the f32 root
    like = torch.zeros((), dtype=torch.bfloat16)
    s = tx._sqrt_dh(384, like)
    assert s.dtype == torch.bfloat16 and float(s) == 19.625
    assert float(s) == float(jnp.sqrt(jnp.asarray(384, jnp.bfloat16)))
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    jq = jnp.asarray(x, jnp.bfloat16) / jnp.sqrt(jnp.asarray(384,
                                                             jnp.bfloat16))
    tq = _t(x).to(torch.bfloat16) / s
    np.testing.assert_array_equal(tq.float().numpy(),
                                  np.asarray(jq, np.float32))


@pytest.mark.parametrize("T", [16, 2], ids=["T16", "T2_tail_padded"])
@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_forward_with_state_matches(xl, mixer, T):
    jcfg, jp, cfg, tp = _layer(xl, mixer)
    x = np.random.default_rng(T).standard_normal(
        (2, T, cfg.d_model)).astype(np.float32)
    jf = jx.mlstm_forward if mixer == "mlstm" else jx.slstm_forward
    tf = tx.mlstm_forward if mixer == "mlstm" else tx.slstm_forward
    jout, jst = jf(jp, jcfg, jnp.asarray(x), return_state=True)
    tout, tst = tf(tp, cfg, _t(x), return_state=True)
    _close(tout, jout, REL_LAYER)
    assert set(tst) == set(jst)
    for k in jst:
        assert tuple(tst[k].shape) == jst[k].shape
        _close(tst[k], jst[k], REL_LAYER)
    _close(tf(tp, cfg, _t(x)), jout, REL_LAYER)


@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_decode_matches(xl, mixer):
    jcfg, jp, cfg, tp = _layer(xl, mixer)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    jf = jx.mlstm_forward if mixer == "mlstm" else jx.slstm_forward
    jd = jx.mlstm_decode if mixer == "mlstm" else jx.slstm_decode
    td = tx.mlstm_decode if mixer == "mlstm" else tx.slstm_decode
    _, jst = jf(jp, jcfg, jnp.asarray(x), return_state=True)
    tst = {k: _t(v) for k, v in jst.items()}
    for _ in range(4):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jout, jst = jd(jp, jcfg, jnp.asarray(xt), jst)
        before, inp = {k: v.clone() for k, v in tst.items()}, tst
        tout, tst = td(tp, cfg, _t(xt), inp)
        _close(tout, jout, REL_LAYER)
        for k in jst:
            _close(tst[k], jst[k], REL_LAYER)
        assert all(torch.equal(before[k], inp[k]) for k in before)
    init = tx.init_mlstm_state if mixer == "mlstm" else tx.init_slstm_state
    jinit = jx.init_mlstm_state if mixer == "mlstm" else jx.init_slstm_state
    assert {k: tuple(s.shape) for k, s in init(cfg, 3,
                                               torch.float32).items()} == \
        {k: s.shape for k, s in jinit(jcfg, 3, jnp.float32).items()}


# ---------------------------------------------------------------------------
# the chunkwise-parallel mLSTM (tests/test_xlstm_chunkwise.py's cases)
# ---------------------------------------------------------------------------

def _sequential(q, k, v, log_i, log_f):
    """The per-step recurrence written out (f32), as the reference test's
    ``sequential_reference``."""
    B, T, H, dh = q.shape
    C = torch.zeros((B, H, dh, dh))
    n = torch.zeros((B, H, dh))
    m = torch.full((B, H), -1e30)
    hs = []
    for t in range(T):
        C, n, m, h = tx._mlstm_update(C, n, m, q[:, t], k[:, t], v[:, t],
                                      log_i[:, t], log_f[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1), (C, n, m)


def _gates(B, T, H, dh, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T, H, dh)).astype(np.float32)
               for _ in range(3))
    log_i = rng.standard_normal((B, T, H)).astype(np.float32)
    log_f = np.asarray(-jax.nn.softplus(-jnp.asarray(
        rng.standard_normal((B, T, H)).astype(np.float32))))
    return q, k, v, log_i, log_f


@pytest.mark.parametrize("chunk", [1, 4, 8, 32])
def test_chunkwise_equals_sequential_and_reference(chunk):
    B, T, H, dh = 2, 32, 3, 8
    arrays = _gates(B, T, H, dh, chunk)
    init = (torch.zeros((B, H, dh, dh)), torch.zeros((B, H, dh)),
            torch.full((B, H), -1e30))
    hs, state = tx.mlstm_chunkwise(*map(_t, arrays), init, chunk=chunk)
    hs_seq, state_seq = _sequential(*map(_t, arrays))
    for a, b in zip((hs,) + state, (hs_seq,) + state_seq):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)
    jinit = tuple(jnp.asarray(t.numpy()) for t in init)
    jhs, jstate = jx.mlstm_chunkwise(*map(jnp.asarray, arrays), jinit,
                                     chunk=chunk)
    for a, b in zip((hs,) + state, (jhs,) + tuple(jstate)):
        _close(a, b, REL_LAYER)


def test_parallel_form_matches_sequential_in_the_block(xl):
    jcfg, jp, cfg, tp = _layer(xl, "mlstm")
    x = _t(np.random.default_rng(8).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32))
    seq = tx.mlstm_forward(tp, cfg, x, return_state=True)
    par_cfg = dataclasses.replace(cfg, mlstm_parallel=True)
    par = tx.mlstm_forward(tp, par_cfg, x, return_state=True)
    jpar = jx.mlstm_forward(jp, dataclasses.replace(jcfg,
                                                    mlstm_parallel=True),
                            jnp.asarray(x.numpy()), return_state=True)
    _close(par[0], seq[0].detach(), 1e-4)
    _close(par[0], jpar[0], REL_LAYER)
    for k in ("C", "n", "m"):
        _close(par[1][k], jpar[1][k], REL_LAYER)


def test_chunkwise_gradients_finite():
    B, T, H, dh = 1, 16, 2, 4
    arrays = [_t(a) for a in _gates(B, T, H, dh, 3)]
    for a in arrays[:3]:
        a.requires_grad_(True)
    init = (torch.zeros((B, H, dh, dh)), torch.zeros((B, H, dh)),
            torch.full((B, H), -1e30))
    hs, _ = tx.mlstm_chunkwise(*arrays, init, chunk=4)
    torch.sum(hs ** 2).backward()
    assert all(torch.isfinite(a.grad).all() for a in arrays[:3])


# ---------------------------------------------------------------------------
# the xlstm-125m model
# ---------------------------------------------------------------------------

def test_xlstm_prefill_and_decode_match(xl):
    jcfg, jmodel, tree, cfg, model, params = xl
    rng = np.random.default_rng(5)
    B, T, ML = 2, 12, 20
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (4, B, 1)).astype(np.int32)
    jprefill = jax.jit(jmodel.prefill, static_argnames=("max_len",))
    jdecode = jax.jit(jmodel.decode_step)
    jl, jc = jprefill(tree, {"tokens": jnp.asarray(tokens)}, max_len=ML)
    tl, tc = model.prefill(params, {"tokens": _t(tokens).long()}, max_len=ML)
    _close(tl, jl, REL_MODEL)
    for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        assert tuple(a.shape) == b.shape
        _close(a, b, REL_MODEL)
    for i in range(4):
        jl, jc = jdecode(tree, jnp.asarray(forced[i]), jc,
                         jnp.asarray(T + i, jnp.int32))
        tl, tc = model.decode_step(params, _t(forced[i]).long(), tc, T + i)
        _close(tl, jl, REL_MODEL)
    for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        _close(a, b, REL_MODEL)


def test_xlstm_loss_and_gradients_match(xl):
    # T = 32 = 2 chunks of 16: the chunked, checkpointed scan under grad
    jcfg, jmodel, tree, cfg, model, params = xl
    tokens = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(
        tree, {"tokens": jnp.asarray(tokens)})
    p = tree_map(lambda t: t.clone().requires_grad_(True), params)
    loss = model.loss(p, {"tokens": _t(tokens).long()})
    loss.backward()
    _close(loss.detach(), jloss, REL_LAYER)
    grads = to_numpy(tree_map(lambda t: t.grad, p))
    for a, b in zip(tree_leaves(grads), jax.tree.leaves(jgrads)):
        _close(a, b, REL_MODEL)


def test_xlstm_engine_matches_batched_generate(xl, monkeypatch):
    """3 requests through 2 slots: every cache leaf is per-slot state, so
    the pool has no paged leaf and no allocator (every admission fits),
    and int8 quantizes nothing.  At temperature 0 every row equals
    ``generate`` at batch 3, with and without int8."""
    _, _, _, cfg, model, params = xl
    P, G, ML = 8, 6, 16
    prompts = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (3, P)).astype(np.int32)
    ref = generate(model, params, prompts, gen=G, max_len=ML).numpy()
    calls = []
    monkeypatch.setattr(ops, "quantize_tiles",
                        lambda x, *, tile: calls.append(tile))
    for quantize in (None, "int8"):
        eng = Engine(model, params, ServeConfig(
            max_batch=2, max_len=ML, page_size=4, quantize=quantize))
        assert eng.cache.paged_leaves() == 0 and not eng.cache.allocators
        assert eng.cache.can_admit(10 ** 9)
        out = eng.run([Request(rid=i, prompt=prompts[i], max_new=G)
                       for i in range(3)])
        for c in out:
            np.testing.assert_array_equal(c.tokens, ref[c.rid])
    assert calls == []
