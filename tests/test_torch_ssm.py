"""The port's time scan (``repro_torch.models.scan_utils``), Mamba block
(``repro_torch.models.ssm``) and the Jamba hybrid (jamba-v0.1-52b:
Mamba:attention 7:1, MoE every other layer) against the JAX package, on
the same weights (``params_from_jax``) and numpy-made inputs, in f32.

The Jamba config is ``reduced()``: one whole 8-layer hybrid period (7
Mamba layers, attention at offset 3, 4 experts top-2 on the odd layers),
d_model 256.

Tolerances, each relative to the largest magnitude of the reference's
tensor: ``chunked_scan`` values and gradients 1e-6 against a plain loop
in the same framework (the same ops in the same order) and 1e-5 against
``lax.scan``; one Mamba block's output, state and decode 1e-5 (two
frameworks' f32 matmul and exp kernels over one layer); a whole model's
loss 1e-5, its gradients, prefill and decode logits and cache 1e-4 (the
model tests' bound, over eight layers).  The engine's tokens at
temperature 0 are held EQUAL to a batched ``generate``.
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
from repro.models import ssm as jssm
from repro.models.scan_utils import chunked_scan as jchunked_scan
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax, to_numpy
from repro_torch.kernels import ops
from repro_torch.launch.serve import generate
from repro_torch.models import Model
from repro_torch.models import ssm as tssm
from repro_torch.models.scan_utils import chunked_scan
from repro_torch.serve import Engine, Request, ServeConfig

ARCH = "jamba-v0.1-52b"
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
def jamba():
    jcfg = jreduced(jget_config(ARCH))
    cfg = reduced(get_config(ARCH))
    jmodel = JModel(jcfg)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    params = params_from_jax(tree, cfg, device="cpu")
    return jcfg, jmodel, tree, cfg, Model(cfg), params


# ---------------------------------------------------------------------------
# chunked_scan
# ---------------------------------------------------------------------------

# a contracting recurrence, so that one ulp of difference between the two
# frameworks' tanh is not amplified over the steps
def _step_t(c, x):
    c = torch.tanh(0.5 * c + x.sum(-1, keepdim=True))
    return c, c * x


def _step_j(c, x):
    c = jnp.tanh(0.5 * c + x.sum(-1, keepdims=True))
    return c, c * x


# (T, chunk, checkpoint_step): chunks that tile T, one chunk, a chunk
# larger than T and one that does not divide T (both fall back to one
# loop), each with and without the per-step checkpoint
SCAN_CASES = [(32, 8, True), (32, 8, False), (16, 16, True), (15, 4, True),
              (6, 32, False), (1, 3, True)]


@pytest.mark.parametrize("T,chunk,ckpt", SCAN_CASES)
def test_chunked_scan_values_and_gradients(T, chunk, ckpt):
    rng = np.random.default_rng(T * 100 + chunk)
    xs = rng.standard_normal((T, 2, 3)).astype(np.float32)
    init = rng.standard_normal((2, 1)).astype(np.float32)

    def loss_t(fn):
        x, c0 = _t(xs).requires_grad_(True), _t(init).requires_grad_(True)
        c, ys = fn(_step_t, c0, x)
        (torch.sum(ys ** 2) + torch.sum(c)).backward()
        return c.detach(), ys.detach(), x.grad, c0.grad

    def plain(step, c, x):
        ys = []
        for t in range(x.shape[0]):
            c, y = step(c, x[t])
            ys.append(y)
        return c, torch.stack(ys)

    got = loss_t(lambda s, c, x: chunked_scan(s, c, x, chunk=chunk,
                                              checkpoint_step=ckpt))
    want = loss_t(plain)
    for a, b in zip(got, want):
        _close(a, b, 1e-6)

    def loss_j(xs_, c0):
        c, ys = jax.lax.scan(_step_j, c0, xs_)
        return jnp.sum(ys ** 2) + jnp.sum(c)
    jc, jys = jchunked_scan(_step_j, jnp.asarray(init), jnp.asarray(xs),
                            chunk=chunk, checkpoint_step=ckpt)
    jgx, jgc = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(xs),
                                                 jnp.asarray(init))
    for a, b in zip(got, (jc, jys, jgx, jgc)):
        _close(a, b, 1e-5)


def test_chunked_scan_keeps_only_the_boundary_carries():
    """The backward's memory: after a forward under grad, the scan keeps
    the T / chunk boundary carries, not one per step; inside an enclosing
    checkpoint (``stack_train`` checkpoints every block) it keeps none.
    Carries are told apart by their shape, (3, 5, 7)."""
    import gc

    def alive():
        gc.collect()
        return len({id(o) for o in gc.get_objects()
                    if isinstance(o, torch.Tensor)
                    and tuple(o.shape) == (3, 5, 7)})

    def step(carry, x):             # a tuple carry, as mLSTM's (C, n, m)
        c, n = carry
        c = torch.tanh(0.5 * c + x)
        return (c, n + c.sum()), c.sum(-1)

    T, chunk = 32, 8
    xs = torch.randn(T, 3, 5, 7, requires_grad=True)
    init = (torch.zeros(3, 5, 7), torch.zeros(()))
    before = alive()
    c, ys = chunked_scan(step, init, xs, chunk=chunk)
    assert alive() - before <= T // chunk + 1
    del c, ys

    def run(x):
        return chunked_scan(step, init, x, chunk=chunk)[1]
    ys = torch.utils.checkpoint.checkpoint(run, xs, use_reentrant=False)
    assert alive() - before <= 1
    ys.sum().backward()
    assert torch.isfinite(xs.grad).all()


def test_chunked_scan_without_grad_is_a_plain_loop(monkeypatch):
    # serving: no tensor requires grad, so no checkpoint is taken
    import repro_torch.models.scan_utils as su
    monkeypatch.setattr(su, "checkpoint", None)
    xs = torch.randn(16, 2, 3)
    c, ys = chunked_scan(_step_t, torch.zeros(2, 1), xs, chunk=4)
    assert ys.shape == (16, 2, 3) and c.shape == (2, 1)
    with torch.no_grad():
        chunked_scan(_step_t, torch.zeros(2, 1),
                     xs.clone().requires_grad_(True), chunk=4)


# ---------------------------------------------------------------------------
# softplus and the Mamba block
# ---------------------------------------------------------------------------

def test_softplus_is_logaddexp_at_every_x():
    # F.softplus switches to the identity above 20; jax.nn.softplus does
    # not, and its log1p(exp) never overflows
    x = np.linspace(-120.0, 120.0, 4001).astype(np.float32)
    got = tssm.softplus(_t(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    # the two frameworks round subnormal results (x < -87) differently
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=2e-38)
    assert np.isfinite(got).all()


def _mamba_layer(jamba):
    jcfg, _, tree, cfg, _, params = jamba
    seg = cfg.stack_plan()[0]
    assert seg.repeats == 1 and seg.period[0].mixer == "mamba"
    return (jcfg, tree["stack"][0][0]["mixer"], cfg,
            params["stack"][0][0]["mixer"])


@pytest.mark.parametrize("T", [16, 2], ids=["T16", "T2_tail_padded"])
def test_mamba_forward_with_state_matches(jamba, T):
    jcfg, jp, cfg, tp = _mamba_layer(jamba)
    x = np.random.default_rng(T).standard_normal(
        (2, T, cfg.d_model)).astype(np.float32)
    jout, jst = jssm.mamba_forward(jp, jcfg, jnp.asarray(x),
                                   return_state=True)
    tout, tst = tssm.mamba_forward(tp, cfg, _t(x), return_state=True)
    _close(tout, jout, REL_LAYER)
    assert set(tst) == {"h", "conv"} and tst["h"].dtype == torch.float32
    for k in ("h", "conv"):
        assert tuple(tst[k].shape) == jst[k].shape
        _close(tst[k], jst[k], REL_LAYER)
    _close(tssm.mamba_forward(tp, cfg, _t(x)), jout, REL_LAYER)


def test_mamba_decode_matches(jamba):
    jcfg, jp, cfg, tp = _mamba_layer(jamba)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    _, jst = jssm.mamba_forward(jp, jcfg, jnp.asarray(x), return_state=True)
    tst = {k: _t(v) for k, v in jst.items()}
    for i in range(4):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jout, jst = jssm.mamba_decode(jp, jcfg, jnp.asarray(xt), jst)
        before, inp = {k: v.clone() for k, v in tst.items()}, tst
        tout, tst = tssm.mamba_decode(tp, cfg, _t(xt), inp)
        _close(tout, jout, REL_LAYER)
        for k in ("h", "conv"):
            _close(tst[k], jst[k], REL_LAYER)
        # the input state is not modified
        assert all(torch.equal(before[k], inp[k]) for k in before)
    spec = tssm.init_mamba_state(cfg, 3, torch.float32)
    jspec = jssm.init_mamba_state(jcfg, 3, jnp.float32)
    assert {k: tuple(s.shape) for k, s in spec.items()} == \
        {k: s.shape for k, s in jspec.items()}


# ---------------------------------------------------------------------------
# the Jamba model
# ---------------------------------------------------------------------------

def test_jamba_plan_and_param_count():
    for full in (False, True):
        j, t = jget_config(ARCH), get_config(ARCH)
        if not full:
            j, t = jreduced(j), reduced(t)
        assert [(tuple((s.mixer, s.ffn) for s in seg.period), seg.repeats)
                for seg in t.stack_plan()] == \
            [(tuple((s.mixer, s.ffn) for s in seg.period), seg.repeats)
             for seg in j.stack_plan()]
    period = get_config(ARCH).stack_plan()
    assert [(len(s.period), s.repeats) for s in period] == [(8, 4)]
    assert [s.mixer for s in period[0].period] == \
        ["mamba"] * 3 + ["attn"] + ["mamba"] * 4
    assert [s.ffn for s in period[0].period] == ["dense", "moe"] * 4
    from repro_torch.models import count_params
    assert count_params(get_config(ARCH)) == 51_570_315_264


def test_jamba_prefill_and_decode_match(jamba):
    jcfg, jmodel, tree, cfg, model, params = jamba
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
        pos = np.array([T + i, T + i], np.int32)
        jl, jc = jdecode(tree, jnp.asarray(forced[i]), jc, jnp.asarray(pos))
        tl, tc = model.decode_step(params, _t(forced[i]).long(), tc,
                                   _t(pos).long())
        _close(tl, jl, REL_MODEL)
    for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        _close(a, b, REL_MODEL)


def test_jamba_loss_and_gradients_match(jamba):
    jcfg, jmodel, tree, cfg, model, params = jamba
    tokens = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(
        tree, {"tokens": jnp.asarray(tokens)})
    p = tree_map(lambda t: t.clone().requires_grad_(True), params)
    loss = model.loss(p, {"tokens": _t(tokens).long()})
    loss.backward()
    _close(loss.detach(), jloss, REL_LAYER)
    grads = to_numpy(tree_map(lambda t: t.grad, p))
    for a, b in zip(tree_leaves(grads), jax.tree.leaves(jgrads)):
        _close(a, b, REL_MODEL)


def test_jamba_engine_matches_batched_generate(jamba, monkeypatch):
    """3 requests through 2 slots: the Mamba layers' state rides the
    pool's per-slot state leaves, the attention layer's K/V its pages.
    At temperature 0 every row equals ``generate`` at batch 3; the int8
    pool quantizes the two paged leaves (k, v) once per admission and
    tick, at tile head_dim.  The capacity factor is the expert count, so
    that the MoE layers drop no token and a row's tokens do not depend on
    the other rows of its batch (at 1.25 an admission's batch of one and
    ``generate``'s batch of three drop different tokens)."""
    _, _, _, cfg, _, params = jamba
    cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    model = Model(cfg)
    P, G, ML = 8, 6, 16
    prompts = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (3, P)).astype(np.int32)
    ref = generate(model, params, prompts, gen=G, max_len=ML).numpy()
    reqs = [Request(rid=i, prompt=prompts[i], max_new=G) for i in range(3)]
    eng = Engine(model, params, ServeConfig(max_batch=2, max_len=ML,
                                            page_size=4))
    for c in eng.run(reqs):
        np.testing.assert_array_equal(c.tokens, ref[c.rid])
    calls = []
    real = ops.quantize_tiles

    def spy(x, *, tile):
        calls.append(tile)
        return real(x, tile=tile)
    monkeypatch.setattr(ops, "quantize_tiles", spy)
    eng8 = Engine(model, params, ServeConfig(max_batch=2, max_len=ML,
                                             page_size=4, quantize="int8"))
    assert eng8.cache.paged_leaves() == 2
    out = eng8.run(reqs)
    assert [len(c.tokens) for c in out] == [G] * 3
    assert calls == [cfg.hd] * 2 * (eng8.prefills + eng8.decode_ticks)
    assert not any(a.live_pages() for a in eng8.cache.allocators.values())
