"""The replicated column of ``tests/test_conformance.py`` on the port: every
wire of ``WIRES`` × {adam, sgd}, three synced training steps of ``TinyLM``
at world 1, the port's ``_make_synced_train_step`` on a gloo group of one
process against the reference's ``_run_replicated``, from the same
parameters (the reference's ``TinyLM.init``, as numpy) and the same
``tiny_batch`` data, running the reference's own plan
(``sharded_plan_from_config``, copied bucket by bucket).  The sync state
starts from the reference's (EF zeros and PowerSGD's warm-start factors),
and qsgd's stochastic rounding takes the reference's draws (per step and
bucket, ``split(fold_in(PRNGKey(1), step), n_buckets)[j]``).

Nothing in this column is bit-equal, so the reference's ``exact`` flag
(which pins its sharded leg to its replicated one) is not used here: the
reference runs the loss, the backward and the update under jit (XLA's
summation order, FMA contraction and the ``s/127`` rewrite of ROADMAP.md
queue 3) and the port runs them eagerly.  Even with the reference run
under ``jax.disable_jit()`` the first loss of the dense and int8 wires
differs by one ulp (the log-softmax).  Measured on this tree, wire by
wire, as max |port - reference| of the parameters after 3 steps (sgd /
adam) and of the EF residuals (sgd / adam):

  dense (psum, ring, hierarchical)  1.5e-8 / 6.4e-7   -
  int8/ring                         7.5e-9 / 3.0e-8   1.9e-8 / 1.6e-8
  topk/ring                         1.5e-8 / 6.0e-8   9.8e-9 / 1.3e-8
  qsgd/ring                         4.7e-10 / 3.0e-8  1.1e-8 / 1.1e-8
  powersgd/ring                     1.5e-8 / 2.4e-5   2.8e-9 / 1.6e-7
  int8_fused/ring                   3.7e-9 / 4.5e-8   1.4e-8 / 1.5e-8
  topk_fused/ring                   7.5e-9 / 6.0e-8   5.6e-9 / 8.4e-9

and every wire's losses within 4.6e-7 relative.  Held, with the largest
deviation above in brackets:

  * losses at rtol 1e-6 (4.6e-7);
  * parameters: sgd within 1e-7 (1.5e-8); adam within 1e-4, with at most
    1% of the entries beyond 1e-6 (2.4e-5 for powersgd, whose factored
    leaves Adam divides by a tiny sqrt(v); 6.4e-7 otherwise);
  * EF residuals within 1e-6 (1.6e-7), nonzero for every compressed wire,
    in the reference's state schema (one entry per bucket, None where a
    bucket keeps none), with the step counter at 3.

``TinyStackLM``'s loss surface (its staged surface waits for the pipeline
port) matches the reference's loss and gradients and trains like it, and
the port's runs are deterministic.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_conformance import STEPS, WIRES, _run_replicated
from tiny_lm import TinyLM as JTinyLM
from tiny_lm import TinyStackLM as JTinyStackLM
from tiny_lm import tiny_batch

from repro.core import PlanExecutor as JPlanExecutor
from repro.core import SyncConfig as JSyncConfig
from repro.core.grad_sync import sharded_plan_from_config
from repro.launch.steps import _make_synced_train_step as j_synced_step
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.core import BucketPlan, CommPlan, PlanExecutor
from repro_torch.core.compression import quantization
from repro_torch.launch.dist import init_group
from repro_torch.launch.steps import _make_synced_train_step, loss_and_grads
from repro_torch.optim import make_optimizer

LR = 0.05


class TinyLM:
    """``tests/tiny_lm.py:TinyLM`` in torch: embedding + linear LM with the
    reference's ``loss(params, batch)`` over ``{'tokens': (B, T)}``."""

    def __init__(self, vocab: int = 64, d: int = 16):
        self.vocab, self.d = vocab, d

    def loss(self, params, batch):
        toks = batch["tokens"]
        x = params["emb"][toks[:, :-1]]
        logits = x @ params["out"] + params["b"]
        lp = torch.log_softmax(logits, -1)
        return -torch.mean(torch.gather(lp, -1, toks[:, 1:, None]))


class TinyStackLM:
    """``tests/tiny_lm.py:TinyStackLM``'s single-program ``loss``: TinyLM
    with a stack of residual MLP blocks stored stacked ``(R, ...)``."""

    def __init__(self, vocab: int = 64, d: int = 16, hidden: int = 32,
                 blocks: int = 4):
        self.vocab, self.d, self.hidden, self.blocks = vocab, d, hidden, blocks

    def loss(self, params, batch):
        toks = batch["tokens"]
        h = params["emb"][toks[:, :-1]]
        blk = params["blocks"]
        for i in range(self.blocks):
            h = h + torch.tanh(h @ blk["w1"][i] + blk["b1"][i]) @ blk["w2"][i]
        logits = h @ params["out"] + params["b"]
        lp = torch.log_softmax(logits, -1)
        return -torch.mean(torch.gather(lp, -1, toks[:, 1:, None]))


@pytest.fixture(scope="module", autouse=True)
def world1():
    init_group(torch.device("cpu"))


def _tensors(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _batch(step: int):
    return {"tokens": torch.from_numpy(
        np.asarray(tiny_batch(step)["tokens"]).astype(np.int64))}


def _port_plan(jplan) -> CommPlan:
    """The reference's plan as the port's, bucket by bucket."""
    return CommPlan(buckets=tuple(
        BucketPlan(**dataclasses.asdict(b)) for b in jplan.buckets),
        mean=jplan.mean)


def _reference_init_state(jmodel, params0, jplan, opt_name):
    """The reference's initial sync state (world-1 view) as the port's."""
    mesh = jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    _, _, init = j_synced_step(jmodel, jmake_optimizer(opt_name, lr=LR),
                               JPlanExecutor(jplan, ("data",)), mesh,
                               ("data",))
    js = jax.tree.map(lambda x: np.asarray(x)[0], init(params0))
    state = {"step": 0}
    for key in ("error", "q"):
        if key in js:
            state[key] = [None if x is None else torch.from_numpy(x.copy())
                          for x in js[key]]
    return state


def _jax_bernoulli(n_buckets: int):
    """A ``quantization.bernoulli`` that draws what the reference's bucket
    draws: calls come step by step, bucket by bucket."""
    calls = []

    def bernoulli(p, rng):
        step, j = divmod(len(calls), n_buckets)
        calls.append(None)
        key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(1),
                                                  step), n_buckets)[j]
        return torch.from_numpy(np.array(jax.random.bernoulli(
            key, jnp.asarray(p.numpy()))))

    return bernoulli


def _run_port(model, params0, plan, opt_name, state, steps=STEPS):
    """The port's replicated run, as ``_run_replicated`` runs the
    reference's: (params, opt_state, sync_state, losses)."""
    opt = make_optimizer(opt_name, lr=LR)
    step_fn, _, _ = _make_synced_train_step(model, opt, PlanExecutor(plan))
    p = _tensors(params0)
    os_ = opt.init(p)
    losses = []
    for s in range(steps):
        p, os_, state, loss = step_fn(p, os_, state, _batch(s), s,
                                      torch.Generator())
        losses.append(float(loss))
    return tree_map(lambda v: v.detach(), p), os_, state, losses


def _model_for(kw):
    # powersgd needs a leaf above its dense-small fallback (4096 elements)
    d = 80 if kw["compressor"] == "powersgd" else 16
    return JTinyLM(d=d), TinyLM(d=d)


@pytest.mark.parametrize("opt_name", ["adam", "sgd"])
@pytest.mark.parametrize("name,kw", [w[:2] for w in WIRES],
                         ids=[w[0] for w in WIRES])
def test_replicated_matches_reference(name, kw, opt_name, monkeypatch):
    jmodel, model = _model_for(kw)
    params0 = jmodel.init(jax.random.PRNGKey(0))
    jplan = sharded_plan_from_config(JSyncConfig(**kw), params0)
    plan = _port_plan(jplan)
    monkeypatch.setattr(quantization, "bernoulli",
                        _jax_bernoulli(plan.n_buckets))
    jp, _, jss, jlosses = _run_replicated(jmodel, params0, jplan, opt_name)
    state = _reference_init_state(jmodel, params0, jplan, opt_name)
    p, _, ss, losses = _run_port(model, params0, plan, opt_name, state)

    np.testing.assert_allclose(losses, jlosses, rtol=1e-6, err_msg=name)
    for k in jp:
        a, b = p[k].numpy(), np.asarray(jp[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (name, k)
        d = np.abs(a - b)
        if opt_name == "sgd":
            assert d.max() <= 1e-7, (name, k, d.max())
        else:
            assert d.max() <= 1e-4, (name, k, d.max())
            assert (d > 1e-6).mean() <= 0.01, (name, k, (d > 1e-6).mean())
    assert ss["step"] == int(jss["step"]) == STEPS
    assert ("error" in ss) == ("error" in jss), name
    if "error" not in jss:
        return
    nonzero = 0
    for e, je in zip(ss["error"], jss["error"], strict=True):
        assert (e is None) == (je is None), name
        if e is None:
            continue
        np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=0,
                                   atol=1e-6, err_msg=name)
        nonzero += int(torch.any(e != 0))
    assert nonzero > 0, f"{name}: EF residuals all zero after {STEPS} steps"


def test_modes_are_deterministic():
    """Same seed -> bit-identical run (the comparisons above depend on
    it); the reference's sharded leg waits for the sharded port.  One
    thread: the CPU's embedding backward accumulates over threads in no
    fixed order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _deterministic_run()
    finally:
        torch.set_num_threads(n)


def _deterministic_run():
    jmodel, model = JTinyLM(), TinyLM()
    params0 = jmodel.init(jax.random.PRNGKey(0))
    jplan = sharded_plan_from_config(
        JSyncConfig(compressor="int8", algo="ring", bucket_bytes=2048),
        params0)
    runs = [_run_port(model, params0, _port_plan(jplan), "adam",
                      _reference_init_state(jmodel, params0, jplan, "adam"))
            for _ in range(2)]
    (pa, _, sa, la), (pb, _, sb, lb) = runs
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    for ea, eb in zip(sa["error"], sb["error"]):
        assert torch.equal(ea, eb)
    assert la == lb


def test_tiny_stack_lm_loss_surface_matches_reference():
    """TinyStackLM's ``loss``: the loss and every gradient at rtol 1e-6 of
    the leaf's largest |g|, and three dense/ring adam steps like the
    reference's."""
    jmodel, model = JTinyStackLM(), TinyStackLM()
    params0 = jmodel.init(jax.random.PRNGKey(0))
    batch = tiny_batch(0)
    jloss, jgrads = jax.value_and_grad(jmodel.loss)(params0, batch)
    loss, grads = loss_and_grads(model, _tensors(params0), _batch(0))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    for a, b in zip(tree_leaves(grads), jax.tree.leaves(jgrads),
                    strict=True):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-6 * np.abs(b).max()

    kw = dict(compressor="none", algo="ring")
    jplan = sharded_plan_from_config(JSyncConfig(**kw), params0)
    jp, _, _, jlosses = _run_replicated(jmodel, params0, jplan, "adam")
    p, _, _, losses = _run_port(
        model, params0, _port_plan(jplan), "adam",
        _reference_init_state(jmodel, params0, jplan, "adam"))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-6)
    for a, b in zip(tree_leaves(p), jax.tree.leaves(jp), strict=True):
        d = np.abs(a.numpy() - np.asarray(b))
        assert d.max() <= 1e-4 and (d > 1e-6).mean() <= 0.01, d.max()
