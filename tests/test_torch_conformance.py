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

The sharded column (``make_sharded_train_step``, DESIGN.md §8) runs the
same 9 wires × {adam, sgd} for 3 steps at world 1 against the reference's
``_run_sharded``, within the replicated column's bounds above.  Measured
on this tree, as max |port - reference| of the parameters after 3 steps
(sgd / adam), the figures of the replicated column, wire by wire (the EF
residuals too, and the losses within 4.6e-7 relative), with
``topk_fused/ring`` at 7.5e-9 / 6.0e-8.  That is the leg the reference
fails against itself (``tests/test_conformance.py``): its gathered master
differs from its parameters in 1 of 1024 entries, by 3.7e-9, where the
port's equal its parameters exactly.  The port's own sharded step equals
its replicated step on the same plan BIT FOR BIT on every wire:
parameters, the gathered master rows, the gathered moments and the EF
residuals.

The pipeline column (``make_pipeline_train_step``, DESIGN.md §9) runs
``TinyStackLM`` (2 blocks) through the degenerate pipe — S = 1, M = 2,
the DP edge per layer row (``bucket_bytes=0``) — for the same 9 wires ×
{adam, sgd}, 3 steps, against the reference's pipeline step on a
``pipe(1) x data(1)`` mesh from the same start and sync state, within the
replicated column's bounds but for PowerSGD under Adam (its test's
docstring has the numbers).  Dense ring and hierarchical are left out: at
world 1 they are dense psum's computation.  (S = 2 against S = 1 and against the
reference at world 4 is ``tests/test_torch_pipeline.py``.)

``TinyStackLM``'s loss surface matches the reference's loss and gradients
and trains like it, and the port's runs are deterministic in both modes.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_conformance import STEPS, WIRES, _run_replicated, _run_sharded
from tiny_lm import TinyLM as JTinyLM
from tiny_lm import TinyStackLM as JTinyStackLM
from tiny_lm import tiny_batch

from repro.core import PlanExecutor as JPlanExecutor
from repro.core import SyncConfig as JSyncConfig
from repro.core.grad_sync import sharded_plan_from_config
from repro.launch.steps import _make_synced_train_step as j_synced_step
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.core import (BucketPlan, CommPlan, GradientSynchronizer,
                              PlanExecutor, ShardLayout, SyncConfig)
from repro_torch.core.compression import quantization
from repro_torch.core.pipeline import StageLayout
from repro_torch.launch.dist import init_group
from repro_torch.launch.steps import (_make_synced_train_step,
                                      loss_and_grads,
                                      make_pipeline_train_step,
                                      make_sharded_train_step,
                                      merge_opt_rows)
from repro_torch.optim import make_optimizer, make_sharded_optimizer

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
    """``tests/tiny_lm.py:TinyStackLM`` in torch: TinyLM with a stack of
    residual MLP blocks stored stacked ``(R, ...)``, with both of the
    reference's surfaces — the single-program ``loss`` and the staged one
    ``make_pipeline_train_step`` runs (``layout`` / ``split`` / ``merge``
    / ``embed_mb`` / ``stage_apply`` / ``loss_tail`` / ``aux_coef``), the
    blocks cut into ``n_stages`` row groups.  ``split(params, stage=s)``
    keeps stage s's rows only, as ``StagedModel.split`` does."""

    def __init__(self, vocab: int = 64, d: int = 16, hidden: int = 32,
                 blocks: int = 4, n_stages: int = 1):
        if blocks % n_stages:
            raise ValueError((blocks, n_stages))
        self.vocab, self.d, self.hidden, self.blocks = vocab, d, hidden, blocks
        self.layout = StageLayout(n_stages=n_stages, rows=blocks,
                                  rows_per_stage=blocks // n_stages)
        self.aux_coef = 0.0

    # -- staged surface ------------------------------------------------------

    def split(self, params, stage=None):
        S, rps = self.layout.n_stages, self.layout.rows_per_stage
        shared = {k: v for k, v in params.items() if k != "blocks"}
        if stage is None:
            rows = tree_map(lambda x: x.reshape((S, rps) + x.shape[1:]),
                            params["blocks"])
        else:
            rows = tree_map(lambda x: x[stage * rps:(stage + 1) * rps],
                            params["blocks"])
        return shared, rows

    def merge(self, shared, rows_stacked):
        out = dict(shared)
        out["blocks"] = tree_map(
            lambda x: x.reshape((self.blocks,) + x.shape[2:]), rows_stacked)
        return out

    def embed_mb(self, shared, tokens):
        return shared["emb"][tokens[:, :-1]]

    def stage_apply(self, rows, h):
        for i in range(self.layout.rows_per_stage):
            h = h + torch.tanh(h @ rows["w1"][i] + rows["b1"][i]) \
                @ rows["w2"][i]
        return h, torch.zeros((), dtype=torch.float32)

    def loss_tail(self, shared, h, tokens):
        logits = h @ shared["out"] + shared["b"]
        lp = torch.log_softmax(logits, -1)
        return -torch.mean(torch.gather(lp, -1, tokens[:, 1:, None]))

    # -- single-program path -------------------------------------------------

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
        mean=jplan.mean, shard_state=jplan.shard_state)


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


def _run_port_sharded(model, params0, plan, opt_name, state, steps=STEPS):
    """The port's sharded run at world 1, as ``_run_sharded`` runs the
    reference's: (params, leaf-shaped optimizer state with ``master``,
    sync_state, losses)."""
    ex = PlanExecutor(plan)
    p = _tensors(params0)
    layout = ShardLayout.from_plan(plan, p, (1,))
    shopt = make_sharded_optimizer(opt_name, layout, ex.axes, lr=LR)
    step_fn, init_rows, _ = make_sharded_train_step(model, ex, layout, shopt)
    rows = init_rows(p)
    losses = []
    for s in range(steps):
        p, rows, state, loss = step_fn(p, rows, state, _batch(s), s,
                                       torch.Generator())
        losses.append(float(loss))
    full = {k: layout.gather_tree(v, p, ex.axes)
            for k, v in rows["opt"].items()}
    full["master"] = layout.gather_tree(rows["master"], p, ex.axes)
    return tree_map(lambda v: v.detach(), p), full, state, losses


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


def _assert_within_column(name, opt_name, p, jp, losses, jlosses, ss, jss):
    """The replicated column's bounds (the module docstring)."""
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
    for e, je in zip(ss.get("error", []), jss.get("error", []), strict=True):
        assert (e is None) == (je is None), name
        if e is not None:
            np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=0,
                                       atol=1e-6, err_msg=name)


@pytest.mark.parametrize("opt_name", ["adam", "sgd"])
@pytest.mark.parametrize("name,kw", [w[:2] for w in WIRES],
                         ids=[w[0] for w in WIRES])
def test_sharded_matches_reference(name, kw, opt_name, monkeypatch):
    """The sharded column: the port's sharded step against the
    reference's ``_run_sharded`` on the same plan and start, within the
    replicated column's bounds; the gathered master rows are the
    parameters exactly, and the gathered Adam moments are the
    reference's within the parameters' bounds."""
    jmodel, model = _model_for(kw)
    params0 = jmodel.init(jax.random.PRNGKey(0))
    jplan = sharded_plan_from_config(JSyncConfig(**kw), params0)
    plan = _port_plan(jplan)
    monkeypatch.setattr(quantization, "bernoulli",
                        _jax_bernoulli(plan.n_buckets))
    jp, jrows, jss, jlosses, jlayout = _run_sharded(jmodel, params0, jplan,
                                                    opt_name)
    state = _reference_init_state(jmodel, params0, jplan, opt_name)
    p, full, ss, losses = _run_port_sharded(model, params0, plan, opt_name,
                                            state)
    _assert_within_column(name, opt_name, p, jp, losses, jlosses, ss, jss)
    for k in jp:
        assert torch.equal(full["master"][k], p[k]), (name, k)
    if opt_name == "adam":
        for mom in ("m", "v"):
            jfull = jlayout.tree_from_rows(jrows["opt"][mom], params0)
            for k in jp:
                d = np.abs(full[mom][k].numpy() - np.asarray(jfull[k]))
                assert d.max() <= 1e-4 and (d > 1e-6).mean() <= 0.01, \
                    (name, mom, k, d.max())


@pytest.mark.parametrize("opt_name", ["adam", "sgd"])
@pytest.mark.parametrize("name,kw", [w[:2] for w in WIRES],
                         ids=[w[0] for w in WIRES])
def test_sharded_equals_replicated_bit_for_bit(name, kw, opt_name):
    """DESIGN.md §8 on the port's own two paths, the same plan and sync
    state: parameters, the gathered master rows and moments and the EF
    residuals after 3 steps, bit for bit.  One thread (the CPU's
    embedding backward sums over threads in no fixed order)."""
    jmodel, model = _model_for(kw)
    params0 = jmodel.init(jax.random.PRNGKey(0))
    jplan = sharded_plan_from_config(JSyncConfig(**kw), params0)
    plan = _port_plan(jplan)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = [run(model, params0, plan, opt_name,
                    _reference_init_state(jmodel, params0, jplan, opt_name))
                for run in (_run_port, _run_port_sharded)]
    finally:
        torch.set_num_threads(n)
    (p_r, os_r, ss_r, l_r), (p_s, full, ss_s, l_s) = runs
    assert l_r == l_s, name
    for k in p_r:
        assert torch.equal(p_r[k], p_s[k]), (name, k)
        assert torch.equal(full["master"][k], p_s[k]), (name, k)
        for mom in os_r:
            assert torch.equal(os_r[mom][k], full[mom][k]), (name, mom, k)
    for e_r, e_s in zip(ss_r.get("error", []), ss_s.get("error", []),
                        strict=True):
        assert (e_r is None) == (e_s is None)
        if e_r is not None:
            assert torch.equal(e_r, e_s), (name, "EF")


@pytest.mark.parametrize("name,kw", [w[:2] for w in WIRES
                                     if w[1]["compressor"] != "none"],
                         ids=[w[0] for w in WIRES
                              if w[1]["compressor"] != "none"])
def test_ef_residual_bookkeeping_preserved_under_sharding(name, kw):
    """Compressed wires carry EF state in both modes with one schema and
    one trajectory: present, bucket-shaped, updated every step, nonzero,
    and bit-equal between the modes (the residual corrects what this
    worker SENT; sharding does not change the send)."""
    jmodel, model = _model_for(kw)
    params0 = jmodel.init(jax.random.PRNGKey(0))
    jplan = sharded_plan_from_config(JSyncConfig(**kw), params0)
    plan = _port_plan(jplan)
    state = _reference_init_state(jmodel, params0, jplan, "adam")
    shapes = [None if e is None else tuple(e.shape) for e in state["error"]]
    _, _, ss_r, _ = _run_port(model, params0, plan, "adam",
                              _reference_init_state(jmodel, params0, jplan,
                                                    "adam"))
    _, _, ss_s, _ = _run_port_sharded(model, params0, plan, "adam", state)
    assert ss_r["step"] == ss_s["step"] == STEPS
    nonzero = 0
    for a, b, shape in zip(ss_r["error"], ss_s["error"], shapes,
                           strict=True):
        assert (a is None) == (b is None) == (shape is None), name
        if a is None:
            continue
        assert tuple(b.shape) == shape
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-7,
                                   err_msg=name)
        nonzero += int(torch.any(b != 0))
    assert nonzero > 0, f"{name}: EF residuals all zero after {STEPS} steps"


PIPE_M = 2


def _run_reference_pipeline(jmodel, params0, kw, opt_name):
    """The reference's S = 1 pipeline step on a pipe(1) x data(1) mesh:
    (params, merged moments, world-1 sync state, losses, initial sync
    state)."""
    from repro.core import GradientSynchronizer as JGradientSynchronizer
    from repro.launch.mesh import make_pipe_mesh
    from repro.launch.steps import make_pipeline_train_step as jpipe_step
    from repro.launch.steps import merge_opt_rows as jmerge_opt_rows
    engine = JGradientSynchronizer(JSyncConfig(**kw), ("data",))
    fn, init_opt, init_ss = jpipe_step(
        jmodel, jmake_optimizer(opt_name, lr=LR), engine,
        make_pipe_mesh(1, 1), PIPE_M)
    shared, rows = jmodel.split(params0)
    p = {"shared": shared, "rows": rows}
    o, ss = init_opt(p), init_ss(p)
    ss0 = jax.tree.map(lambda x: np.asarray(x)[0], ss)
    jit = jax.jit(fn)
    losses = []
    for s in range(STEPS):
        p, o, ss, loss = jit(p, o, ss, tiny_batch(s),
                             jnp.asarray(s, jnp.int32),
                             jax.random.fold_in(jax.random.PRNGKey(1), s))
        losses.append(float(loss))
    return (jmodel.merge(p["shared"], p["rows"]),
            jmerge_opt_rows(o, jmodel.layout.rows),
            jax.tree.map(lambda x: x[0], ss), losses, ss0)


# at world 1 the dense ring and hierarchical wires are dense/psum's sum
PIPE_WIRES = [w for w in WIRES
              if w[0] not in ("dense/ring", "dense/hierarchical")]


@pytest.mark.parametrize("opt_name", ["adam", "sgd"])
@pytest.mark.parametrize("name,kw", [w[:2] for w in PIPE_WIRES],
                         ids=[w[0] for w in PIPE_WIRES])
def test_pipeline_matches_reference(name, kw, opt_name, monkeypatch):
    """The pipeline column: the port's degenerate pipe against the
    reference's, within the replicated column's bounds (parameters, the
    merged moments at the parameters' bounds, EF residuals).  Measured,
    as max |port - reference| after 3 steps (sgd / adam): dense 6.0e-8 /
    5.0e-6 (0.29% of one leaf beyond 1e-6), compressed wires at most
    6.0e-8 / 1.2e-7, losses within 2.3e-7 relative — but powersgd/ring
    with Adam: the parameters up to 1.1e-3 apart (the embedding; 2.4e-4
    the blocks' weights), losses 2.7e-6 relative at step 3, while with
    SGD the same wire is 6.0e-8 apart: Adam normalizes the factorization's
    near-zero reconstructed entries, whose last bits differ.  That leg is
    held at 2e-3 with no share bound (parameters and moments), its EF
    residuals (6.6e-5 apart) at 1e-4 and its losses at 1e-5 (ROADMAP.md
    queue 3)."""
    d = 80 if kw["compressor"] == "powersgd" else 16
    jmodel = JTinyStackLM(d=d, blocks=2, n_stages=1)
    model = TinyStackLM(d=d, blocks=2)
    kw = dict(kw, bucket_bytes=0)
    params0 = jmodel.init(jax.random.PRNGKey(0))
    # one bucket per leaf of the per-row tree: 2 rows of 3, 3 shared
    monkeypatch.setattr(quantization, "bernoulli", _jax_bernoulli(9))
    jp, jmo, jss, jlosses, jss0 = _run_reference_pipeline(
        jmodel, params0, kw, opt_name)
    state = {"step": 0}
    for key in ("error", "q"):
        if key in jss0:
            state[key] = [None if x is None else torch.from_numpy(x.copy())
                          for x in jss0[key]]
    opt = make_optimizer(opt_name, lr=LR)
    step, init_opt, _ = make_pipeline_train_step(
        model, opt, GradientSynchronizer(SyncConfig(**kw)), PIPE_M)
    shared, rows = model.split(_tensors(params0), stage=0)
    p = {"shared": shared, "rows": rows}
    o = init_opt(p)
    losses = []
    for s in range(STEPS):
        p, o, state, loss = step(p, o, state, _batch(s), s,
                                 torch.Generator())
        losses.append(float(loss))
    got = model.merge(p["shared"], tree_map(lambda x: x[None], p["rows"]))
    # PowerSGD under Adam: Adam divides the factorization's last-bit
    # differences by a tiny sqrt(v) (the replicated column's worst wire)
    loose = name == "powersgd/ring" and opt_name == "adam"
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5 if loose else 1e-6,
                               err_msg=name)
    bound = 1e-7 if opt_name == "sgd" else 1e-4
    lim = 2e-3 if loose else bound
    for tree, jtree in ((got, jp), (merge_opt_rows(o, 2), jmo)):
        for a, b in zip(tree_leaves(tree), jax.tree.leaves(jtree),
                        strict=True):
            dd = np.abs(a.numpy() - np.asarray(b))
            assert a.shape == b.shape and dd.max() <= lim, (name, dd.max())
            assert loose or (dd > 1e-6).mean() <= 0.01, (name, dd.max())
    assert state["step"] == int(jss["step"]) == STEPS
    assert ("error" in state) == ("error" in jss), name
    for e, je in zip(state.get("error", []), jss.get("error", []),
                     strict=True):
        assert (e is None) == (je is None), name
        if e is not None:
            np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=0,
                                       atol=1e-4 if loose else 1e-6,
                                       err_msg=name)


def test_modes_are_deterministic():
    """Same seed -> bit-identical run, in both modes (the comparisons
    above depend on it).  One thread: the CPU's embedding backward
    accumulates over threads in no fixed order."""
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
    for runner in (_run_port, _run_port_sharded):
        runs = [runner(model, params0, _port_plan(jplan), "adam",
                       _reference_init_state(jmodel, params0, jplan,
                                             "adam"))
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
