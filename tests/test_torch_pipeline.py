"""Pipeline parallelism on the port (``core/pipeline.py:StagedModel``,
``launch/steps.py:make_pipeline_train_step``, the session's pipeline
build, ``--parallelism pp/micro`` and the planner's pipeline arm) against
its own S = 1 path and the JAX package's.

  * ``StagedModel``: split and merge of reduced gemma-2b equal the
    reference's; a stage's split keeps its own rows only; the reference's
    refusals (gemma3-4b's two segments, repeats not divisible by S) with
    its messages; the staged loss (embed, every row, loss tail) equals
    ``Model.loss`` bit for bit and the reference's at rtol 1e-6.
  * Micro-batched accumulation (S = 1) on the inputs of the reference's
    ``test_microbatch_accumulation_bit_exact_vs_scan_reference``: bit-equal
    to an ascending-order accumulation written out here, and within that
    test's tolerance (rtol 3e-6, atol 1e-7) of the reference's.
  * S = 1 against S = 2, bit for bit, inside the port: 4 spawned ranks on
    gloo (pipe(2) x data(2) beside S = 1 x data(2) on each data group),
    3 steps, M = 4, on ``TinyStackLM`` and on tied reduced gemma-2b, Adam
    and SGD x dense psum, dense ring, int8 and top-k on ring (int8_fused
    and topk_fused on gemma): parameters, merged moments, EF residuals and
    losses.
  * The port's S = 2 against the reference's ``make_pipeline_train_step``
    on 4 fake devices (this file run as a script with ``--reference``),
    on four of the six legs of ``check_pipeline_bit_exact``: parameters and
    merged moments within rtol 3e-5, atol 1e-7 (the fallback tolerance
    that check names; the reference itself is not bit-exact across stage
    counts on jax 0.9.0, ROADMAP.md queue 3), EF residuals within 1e-6;
    Adam on the dense wires within the replicated conformance column's
    Adam bound (one entry of 1024 is 3.96e-7 off, rel 5.5e-5; the test's
    docstring says why).
  * S = 1, M = 1 against the port's classic synced step: bit-equal.
  * ``SyncStrategy`` compositions, the CLI's ``--pipeline-stages``,
    ``--micro-batches`` and ``--parallelism pp=2,micro=4`` (a spawned
    world of 2 on gloo), and a world-4 ``plan_auto`` whose free search
    picks ``pipeline(S=2,M=32)@device`` and now runs it.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_conformance import TinyStackLM, _tensors
from tiny_lm import TinyStackLM as JTinyStackLM
from tiny_lm import tiny_batch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import GradientSynchronizer as JGradientSynchronizer
from repro.core import SyncConfig as JSyncConfig
from repro.core import SyncStrategy as JSyncStrategy
from repro.core import get_scheduler as jget_scheduler
from repro.core.pipeline import StagedModel as JStagedModel
from repro.models import Model as JModel
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.api import SessionConfig, TrainSession
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core import (GradientSynchronizer, PlanExecutor, SyncConfig,
                              SyncStrategy, get_scheduler, plan_from_config)
from repro_torch.core.collectives import all_gather
from repro_torch.core.pipeline import StagedModel
from repro_torch.launch import train
from repro_torch.launch.dist import init_group, mesh_axes, spawn
from repro_torch.launch.steps import (_make_synced_train_step,
                                      make_pipeline_train_step,
                                      merge_opt_rows)
from repro_torch.models import Model
from repro_torch.optim import make_optimizer, step_inplace

ROOT = Path(__file__).resolve().parents[1]
W4, S2, DP, M, STEPS, LR = 4, 2, 2, 4, 3, 0.05
BATCH, SEQ = 16, 12
# four of check_pipeline_bit_exact's six legs (tests/multi_device_checks.py;
# its other two, adam on dense ring and sgd on psum, differ from these only
# in the dense wire, which the port holds S = 1 == S = 2 on)
REF_LEGS = [("adam", "none", "psum"), ("adam", "int8", "ring"),
            ("adam", "topk", "ring"), ("sgd", "none", "ring")]
# S = 1 against S = 2 inside the port: optimizer x wire, per model
WIRES = {"tiny": [("none", "psum"), ("none", "ring"), ("int8", "ring"),
                  ("topk", "ring")],
         "gemma": [("none", "psum"), ("none", "ring"),
                   ("int8_fused", "ring"), ("topk_fused", "ring")]}
LEGS = [(m, o, c, a) for m, ws in WIRES.items() for o in ("adam", "sgd")
        for c, a in ws]
GEMMA = dict(arch="gemma-2b", reduced=True, batch=8, seq=16)
TIERED = "node:2@commodity,device:2@fast_ici"
AUTO = dict(arch="gemma-2b", reduced=True, batch=64, seq=32,
            optimizer="sgd", lr=3e-3, warmup=1, steps=2, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def world1():
    init_group(torch.device("cpu"))


@pytest.fixture
def one_thread():
    """The CPU's embedding backward sums over threads in no fixed order:
    bit-equality needs one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sync_cfg(comp, algo):
    args = (("ratio", 0.25),) if comp.startswith("topk") else ()
    return dict(compressor=comp, algo=algo, compressor_args=args,
                bucket_bytes=0)


def _tokens(step, batch=BATCH, seq=SEQ):
    return torch.from_numpy(np.asarray(
        tiny_batch(step, batch=batch, seq=seq)["tokens"]).astype(np.int64))


# ---------------------------------------------------------------------------
# StagedModel
# ---------------------------------------------------------------------------

def _gemma_pair():
    jcfg = jreduced(jget_config("gemma-2b"))
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    cfg = reduced(get_config("gemma-2b"))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return jcfg, jparams, Model(cfg), params


@pytest.mark.parametrize("S", [1, 2])
def test_split_merge_round_trip_matches_reference(S):
    jcfg, jparams, model, params = _gemma_pair()
    jshared, jrows = JStagedModel(JModel(jcfg), S).split(jparams)
    staged = StagedModel(model, S)
    shared, rows = staged.split(params)
    for a, b in zip(tree_leaves(rows), jax.tree.leaves(jrows), strict=True):
        assert tuple(a.shape) == b.shape
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert sorted(shared) == sorted(jshared)
    merged = staged.merge(shared, rows)
    for a, b in zip(tree_leaves(merged), tree_leaves(params), strict=True):
        assert torch.equal(a, b)
    # one stage's split: its own rows, copied out of the stack
    rps = staged.layout.rows_per_stage
    for s in range(S):
        _, mine = staged.split(params, stage=s)
        for a, b in zip(tree_leaves(mine), tree_leaves(rows), strict=True):
            assert torch.equal(a, b[s]) and a.shape[0] == rps
            if S > 1:
                assert a.untyped_storage().nbytes() == \
                    a.numel() * a.element_size()


@pytest.mark.parametrize("stage", [0, 1])
def test_init_stage_keeps_the_stage_rows_of_the_whole_draw(stage):
    """A stage's own draw equals its rows of the whole model's draw, and
    its rows own their storage."""
    model = Model(reduced(get_config("gemma-2b")))
    staged = StagedModel(model, 2)
    want = staged.split(model.init(torch.Generator("cpu").manual_seed(3)),
                        stage=stage)
    got = staged.init_stage(torch.Generator("cpu").manual_seed(3), stage)
    for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
        assert torch.equal(a, b)
    for a in tree_leaves(got[1]):
        assert a.shape[0] == staged.layout.rows_per_stage
        assert a.untyped_storage().nbytes() == a.numel() * a.element_size()


def test_pipeline_session_builds_at_construction(one_thread):
    """A pipeline strategy given at construction is built there: the
    moments are per layer row from the start, and the planner's moment
    count is the replicated session's."""
    st = SyncStrategy(get_scheduler("every_step"), parallelism="micro=2")
    sess = TrainSession(SessionConfig(device="cpu", **GEMMA), strategy=st)
    plain = TrainSession(SessionConfig(device="cpu", **GEMMA))
    assert sess._built and sess.staged is not None
    R = sess.staged.layout.rows
    assert sorted(sess.opt_state) == sorted(plain.opt_state)
    for k in sess.opt_state:
        assert len(sess.opt_state[k]["rows"]) == R
    assert sess.opt_moments == plain.opt_moments == len(plain.opt_state)
    assert sess.apply_micro_batching(2)
    full = sess.full_opt_state()
    for k in plain.opt_state:
        for a, b in zip(tree_leaves(full[k]), tree_leaves(plain.opt_state[k]),
                        strict=True):
            assert a.shape == b.shape and not a.any()


@pytest.mark.parametrize("arch,S,reduce", [
    ("gemma3-4b", 2, False), ("gemma-2b", 4, False), ("gemma2-9b", 2, False),
    ("gemma-2b", 3, True)], ids=["gemma3-4b-segments", "gemma-2b-S4",
                                 "gemma2-9b-S2", "gemma-2b-reduced-S3"])
def test_staged_model_refusals_match_reference(arch, S, reduce):
    jcfg, cfg = jget_config(arch), get_config(arch)
    if reduce:
        jcfg, cfg = jreduced(jcfg), reduced(cfg)
    with pytest.raises(ValueError) as want:
        JStagedModel(JModel(jcfg), S)
    with pytest.raises(ValueError) as got:
        StagedModel(Model(cfg), S)
    assert str(got.value) == str(want.value)
    assert "segment" in str(got.value) or "divisible" in str(got.value)


def test_staged_loss_equals_model_loss_and_reference():
    jcfg, jparams, model, params = _gemma_pair()
    tokens = _tokens(0, batch=2, seq=32)
    batch = {"tokens": tokens}
    staged = StagedModel(model, 1)
    shared, rows = staged.split(params, stage=0)
    with torch.no_grad():
        h, aux = staged.stage_apply(rows, staged.embed_mb(shared, tokens))
        got = staged.loss_tail(shared, h, tokens) + staged.aux_coef * aux
        whole = model.loss(params, batch)
    assert torch.equal(got, whole)
    want = float(JModel(jcfg).loss(jparams, {"tokens": jnp.asarray(
        tokens.numpy().astype(np.int32))}))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


# ---------------------------------------------------------------------------
# Micro-batched accumulation (S = 1)
# ---------------------------------------------------------------------------

def _pipe_run(model, params0, opt_name, cfg_kw, steps, batches, m,
              pipe=None, data=None, stage=0):
    """``steps`` pipeline steps of ``model`` (stage ``stage``) from the
    numpy tree ``params0``: (params, opt_state, sync_state, losses)."""
    opt = make_optimizer(opt_name, lr=LR)
    eng = GradientSynchronizer(SyncConfig(**cfg_kw), data)
    step, init_opt, init_ss = make_pipeline_train_step(model, opt, eng, m,
                                                       pipe, data)
    shared, rows = model.split(_tensors(params0), stage=stage)
    p = {"shared": shared, "rows": tree_map(lambda x: x.clone(), rows)}
    o, ss = init_opt(p), init_ss(p)
    losses = []
    for s in range(steps):
        p, o, ss, loss = step(p, o, ss, {"tokens": batches(s)}, s)
        losses.append(float(loss))
    return p, o, ss, losses


def test_microbatch_accumulation_bit_equal_and_matches_reference(one_thread):
    """The reference test's inputs: TinyStackLM(blocks=4), PRNGKey(0),
    tiny_batch(0, 8, 16), M = 4, SGD at lr 0.1."""
    from test_pipeline import _pipeline_step_once
    jmodel = JTinyStackLM(blocks=4, n_stages=1)
    params0 = jmodel.init(jax.random.PRNGKey(0))
    jbatch = tiny_batch(0, batch=8, seq=16)
    want, jloss = _pipeline_step_once(jmodel, params0, jbatch, 4)
    model = TinyStackLM(blocks=4)
    toks = _tokens(0, batch=8, seq=16)
    opt = make_optimizer("sgd", lr=0.1)
    eng = GradientSynchronizer(SyncConfig(bucket_bytes=0))
    step, init_opt, init_ss = make_pipeline_train_step(model, opt, eng, 4)
    shared, rows = model.split(_tensors(params0), stage=0)
    p = {"shared": shared, "rows": rows}
    p, _, _, loss = step(p, init_opt(p), init_ss(p), {"tokens": toks}, 0)
    got = model.merge(p["shared"], tree_map(lambda x: x[None], p["rows"]))

    # ascending-order accumulation, written out
    ref = _tensors(params0)
    acc = tree_map(lambda x: torch.zeros_like(x), ref)
    ls = torch.zeros(())
    for m in range(4):
        leaves = [x.clone().requires_grad_(True) for x in tree_leaves(ref)]
        it = iter(leaves)
        tree = tree_map(lambda _: next(it), ref)
        lm = model.loss(tree, {"tokens": toks[2 * m:2 * m + 2]})
        for a, g in zip(tree_leaves(acc), torch.autograd.grad(lm, leaves)):
            a.add_(g)
        ls += lm.detach()
    for a in tree_leaves(acc):
        a.mul_(0.25)
    step_inplace(opt, ref, acc, opt.init(ref), 0)
    assert float(loss) == float(ls * 0.25)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-6)
    for (a, b), w in zip(zip(tree_leaves(got), tree_leaves(ref)),
                         jax.tree.leaves(want), strict=True):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=3e-6,
                                   atol=1e-7)


def test_s1_m1_equals_classic_synced_step(one_thread):
    """The degenerate pipe (S = 1, M = 1, dense psum) against the classic
    synced step on one dense bucket: the same loss and bit-equal
    parameters and moments (check_pipeline_matches_classic_dp_step holds
    the reference's pair only within rtol 3e-5)."""
    jmodel = JTinyStackLM(blocks=2, n_stages=1)
    params0 = jmodel.init(jax.random.PRNGKey(0))
    model = TinyStackLM(blocks=2)
    p, o, _, losses = _pipe_run(model, params0, "adam",
                                dict(bucket_bytes=0), 2,
                                lambda s: _tokens(s), 1)
    opt = make_optimizer("adam", lr=LR)
    pc = _tensors(params0)
    cstep, _, init_cs = _make_synced_train_step(
        model, opt, PlanExecutor(plan_from_config(SyncConfig(), pc)))
    oc, sc = opt.init(pc), init_cs(pc)
    closs = []
    for s in range(2):
        pc, oc, sc, lc = cstep(pc, oc, sc, {"tokens": _tokens(s)}, s)
        closs.append(float(lc))
    assert losses == closs
    merged = model.merge(p["shared"], tree_map(lambda x: x[None], p["rows"]))
    for a, b in zip(tree_leaves(merged), tree_leaves(pc), strict=True):
        assert torch.equal(a, b)
    mo = merge_opt_rows(o, 2)
    for k in ("m", "v"):
        full = model.merge(mo[k]["shared"],
                           tree_map(lambda x: x[None], mo[k]["rows"]))
        for a, b in zip(tree_leaves(full), tree_leaves(oc[k]), strict=True):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# World 4 on gloo: S = 1 vs S = 2 in the port; the port vs the reference
# ---------------------------------------------------------------------------

def _leg_model(name):
    if name == "tiny":
        return (lambda S: TinyStackLM(blocks=2, n_stages=S),
                JTinyStackLM(blocks=2, n_stages=1).init(
                    jax.random.PRNGKey(0)), lambda s: _tokens(s))
    jcfg = jreduced(jget_config("gemma-2b"))
    start = jax.tree.map(np.asarray, JModel(jcfg).init(
        jax.random.PRNGKey(0)))
    cfg = reduced(get_config("gemma-2b"))
    assert cfg.tie_embeddings
    flat = params_from_jax(start, cfg, device="cpu")
    return (lambda S: StagedModel(Model(cfg), S), flat,
            lambda s: _tokens(s, batch=GEMMA["batch"], seq=GEMMA["seq"]))


def _w4_port(rank: int, world: int, store: str, out_dir: str) -> None:
    """One rank: for every leg, S = 2 on pipe(2) x data(2) and S = 1 on
    this rank's data group, compared bit for bit here; then the planned
    world-4 session."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    init_group(torch.device("cpu"), world_size=world, rank=rank,
               store_path=store)
    pipe, data = mesh_axes((S2, DP))
    s, d = divmod(rank, DP)
    res, arrays = {}, {}
    for mname, opt_name, comp, algo in LEGS:
        make, start, batches = _leg_model(mname)
        start = tree_map(lambda x: np.asarray(x), start)
        rows_b = batches(0).shape[0] // DP

        def local(step):
            return batches(step)[d * rows_b:(d + 1) * rows_b]

        runs = {}
        for S, pp in ((S2, pipe), (1, None)):
            model = make(S)
            runs[S] = (model,) + _pipe_run(
                model, start, opt_name, _sync_cfg(comp, algo), STEPS, local,
                M, pp, data, stage=s if S > 1 else 0)
        (m2, p2, o2, ss2, l2), (m1, p1, o1, ss1, l1) = runs[S2], runs[1]
        rows2 = tree_map(lambda x: all_gather(x, pipe).reshape(
            (-1,) + tuple(x.shape[1:])), p2["rows"])
        full2 = m2.merge(p2["shared"], tree_map(lambda x: x[None], rows2))
        full1 = m1.merge(p1["shared"], tree_map(lambda x: x[None],
                                                p1["rows"]))
        R = m1.layout.rows
        mo2, mo1 = merge_opt_rows(o2, R, pipe), merge_opt_rows(o1, R)
        rps = R // S2
        e2, e1 = ss2.get("error", []), ss1.get("error", [])
        n_row = len(e2) - len(tree_leaves(p2["shared"]))
        per = n_row // rps if rps else 0
        mine = e1[s * n_row:(s + 1) * n_row] + e1[R * per:]
        key = f"{mname}/{opt_name}/{comp}/{algo}"
        res[key] = {
            "losses": l2 == l1,
            "params": all(torch.equal(a, b) for a, b in zip(
                tree_leaves(full2), tree_leaves(full1), strict=True)),
            "moments": all(torch.equal(a, b) for a, b in zip(
                tree_leaves(mo2), tree_leaves(mo1), strict=True)),
            "ef": len(e2) == len(mine) and all(
                (a is None and b is None) or torch.equal(a, b)
                for a, b in zip(e2, mine)),
            "ef_nonzero": any(e is not None and bool(torch.any(e != 0))
                              for e in e2),
            "loss": l2}
        if mname == "tiny":
            for i, x in enumerate(tree_leaves(full2)):
                arrays[f"{key}/p{i}"] = x.numpy()
            for i, x in enumerate(tree_leaves(mo2)):
                arrays[f"{key}/o{i}"] = x.numpy()
            for i, x in enumerate(e2):
                if x is not None:
                    arrays[f"{key}/e{i}"] = x.numpy()

    # the planner's free search at world 4 picks a pipeline, which runs
    sess = TrainSession(SessionConfig(**AUTO))
    sp = sess.plan_auto(topology=TIERED, t_backward_s=1e-3, tau_grid=(1,))
    sess.run(2)
    merged = tree_leaves(sess.params)
    digests = [float(x.double().sum()) for x in merged]
    res["auto"] = {"key": sp.key, "executed": sess.planned["executed"].key,
                   "stages": sess.staged.layout.n_stages
                   if sess.staged is not None else 1,
                   "describe": sess.strategy.describe(),
                   "losses": sess.losses, "digests": digests}
    np.savez(os.path.join(out_dir, f"port-{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"port-{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()


def _w4_reference(out_dir: str) -> None:
    """The reference's S = 2 pipeline step on pipe(2) x data(2) fake
    devices, check_pipeline_bit_exact's legs, TinyStackLM(blocks=2)."""
    from repro.core import GradientSynchronizer as JGS
    from repro.launch.mesh import make_pipe_mesh
    from repro.launch.steps import make_pipeline_train_step as jstep
    from repro.launch.steps import merge_opt_rows as jmerge
    from repro.optim import make_optimizer as jopt
    out = {}
    for opt_name, comp, algo in REF_LEGS:
        model = JTinyStackLM(blocks=2, n_stages=S2)
        params = model.init(jax.random.PRNGKey(0))
        engine = JGS(JSyncConfig(**_sync_cfg(comp, algo)), ("data",))
        fn, init_opt, init_ss = jstep(model, jopt(opt_name, lr=LR), engine,
                                      make_pipe_mesh(S2, DP), M)
        shared, rows = model.split(params)
        p = {"shared": shared, "rows": rows}
        o, ss = init_opt(p), init_ss(p)
        jit = jax.jit(fn)
        for s in range(STEPS):
            p, o, ss, loss = jit(p, o, ss, tiny_batch(s, batch=BATCH,
                                                      seq=SEQ),
                                 jnp.asarray(s, jnp.int32),
                                 jax.random.fold_in(jax.random.PRNGKey(1), s))
        key = f"tiny/{opt_name}/{comp}/{algo}"
        for i, x in enumerate(jax.tree.leaves(model.merge(p["shared"],
                                                          p["rows"]))):
            out[f"{key}/p{i}"] = np.asarray(x)
        for i, x in enumerate(jax.tree.leaves(jmerge(o, 2))):
            out[f"{key}/o{i}"] = np.asarray(x)
        for i, x in enumerate(jax.tree.leaves(ss.get("error", []))):
            out[f"{key}/e{i}"] = np.asarray(x)      # (S x dp, ...)
        out[f"{key}/loss"] = np.asarray(float(loss))
    np.savez(os.path.join(out_dir, "reference.npz"), **out)


@pytest.fixture(scope="module")
def w4(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline_w4")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, __file__, "--reference",
                            str(out)], env=env, cwd=ROOT / "tests",
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    try:
        spawn(_w4_port, W4, args=(str(out),), timeout=300)
        log, _ = ref.communicate(timeout=300)
    finally:
        ref.kill()
    assert ref.returncode == 0, log[-4000:]
    res = [json.loads((out / f"port-{r}.json").read_text())
           for r in range(W4)]
    got = [dict(np.load(out / f"port-{r}.npz")) for r in range(W4)]
    return res, got, dict(np.load(out / "reference.npz"))


@pytest.mark.parametrize("leg", LEGS, ids=["/".join(x) for x in LEGS])
def test_s1_equals_s2_bit_for_bit(w4, leg):
    res, _, _ = w4
    key = "/".join(leg)
    for r in range(W4):
        got = res[r][key]
        for what in ("losses", "params", "moments", "ef"):
            assert got[what] is True, (r, key, what)
        if leg[2] != "none":
            assert got["ef_nonzero"], (r, key)
        assert res[r][key]["loss"] == res[0][key]["loss"]


@pytest.mark.parametrize("leg", REF_LEGS, ids=["/".join(x) for x in REF_LEGS])
def test_world4_matches_reference(w4, leg):
    """rtol 3e-5, atol 1e-7 — but for Adam on the dense wires, whose one
    embedding entry (of 1024) sits 3.96e-7 (rel 5.5e-5) from the
    reference's after 3 steps, the replicated conformance column's Adam
    bound (1e-4, at most 1% beyond 1e-6).  That entry's gradient is a
    near-cancelling sum: after ONE step at world 1 its Adam moment
    differs by 4.7e-4 relative between the packages (the embedding
    backward's summation order), and Adam's m/sqrt(v) passes relative
    gradient differences on at full size."""
    _, got, want = w4
    key = "tiny/" + "/".join(leg)
    adam_dense = leg[0] == "adam" and leg[1] == "none"
    for kind in ("p", "o"):
        names = sorted(k for k in want if k.startswith(f"{key}/{kind}"))
        assert names == sorted(k for k in got[0]
                               if k.startswith(f"{key}/{kind}"))
        assert names or (kind == "o" and leg[0] == "sgd")
        for k in names:
            if adam_dense:
                d = np.abs(got[0][k] - want[k])
                assert d.max() <= 1e-4 and (d > 1e-6).mean() <= 0.01, \
                    (k, d.max())
            else:
                np.testing.assert_allclose(got[0][k], want[k], rtol=3e-5,
                                           atol=1e-7, err_msg=k)
    # EF residuals: rank r = (s, d) is the reference's worker s * dp + d
    for r in range(W4):
        for k in [k for k in want if k.startswith(f"{key}/e")]:
            np.testing.assert_allclose(got[r][k], want[k][r], rtol=0,
                                       atol=1e-6, err_msg=(r, k))


def test_world4_plan_auto_runs_the_pipeline_winner(w4):
    res, _, _ = w4
    autos = [r["auto"] for r in res]
    a = autos[0]
    assert a["key"] == a["executed"] == "pipeline(S=2,M=32)@device"
    assert a["stages"] == 2
    assert a["describe"].startswith("every_step [pipeline S=2 M=32]")
    assert all(np.isfinite(a["losses"])) and len(a["losses"]) == 2
    for b in autos[1:]:
        assert b["losses"] == a["losses"] and b["digests"] == a["digests"]


# ---------------------------------------------------------------------------
# Strategies, the CLI
# ---------------------------------------------------------------------------

def test_sync_strategy_compositions_match_reference():
    with pytest.raises(ValueError, match="shard"):
        SyncStrategy(get_scheduler("every_step"), parallelism="pp=2,shard")
    with pytest.raises(ValueError):
        SyncStrategy(get_scheduler("every_step"), parallelism="pp=0")
    for spec in ("pp=2,micro=8", "micro=4", "dp=2,pp=4,micro=16"):
        st = SyncStrategy(get_scheduler("every_step"),
                          grad_reducer=GradientSynchronizer(SyncConfig(
                              compressor="int8_fused", bucket_bytes=0)),
                          parallelism=spec)
        jst = JSyncStrategy(jget_scheduler("every_step"),
                            grad_reducer=JGradientSynchronizer(JSyncConfig(
                                compressor="int8_fused", bucket_bytes=0),
                                ("data",)), parallelism=spec)
        assert (st.pipeline_stages, st.micro_batches) == \
            (jst.pipeline_stages, jst.micro_batches)
        assert st.describe() == jst.describe()
    # a scheduler with local phases is refused at the build (a pipeline
    # strategy given at construction is built there)
    with pytest.raises(ValueError, match="every-step"):
        TrainSession(SessionConfig(device="cpu", **GEMMA), strategy=(
            SyncStrategy(get_scheduler("local_sgd", period=2),
                         parallelism="pp=2")))
    # world 1 holds no pipe(2); a CommPlan reducer is refused
    for st, msg in ((SyncStrategy(get_scheduler("every_step"),
                                  parallelism="pp=2"), "pipe\\(2\\)"),
                    (SyncStrategy(get_scheduler("every_step"),
                                  grad_reducer=PlanExecutor(plan_from_config(
                                      SyncConfig(), {"w": torch.zeros(4)})),
                                  parallelism="micro=2"), "CommPlan")):
        with pytest.raises(ValueError, match=msg):
            TrainSession(SessionConfig(device="cpu", **GEMMA), strategy=st)


def test_strategy_from_plan_pipeline_arm_matches_reference():
    from repro.api import strategy_from_plan as jstrategy_from_plan
    from repro.core.schedule import LINK_PRESETS as JLINKS
    from repro.core.schedule import pipeline_arm as jpipeline_arm
    from repro.core.schedule import profiles_from_sizes as jprofiles
    from repro_torch.api import strategy_from_plan
    from repro_torch.core.schedule import (LINK_PRESETS, pipeline_arm,
                                           profiles_from_sizes)
    sizes = [8.0 * 2**20] * 24
    arm = pipeline_arm(profiles_from_sizes(sizes, 1e-3),
                       LINK_PRESETS["commodity"], 64, 2, 8, act_bytes_mb=1e5)
    jarm = jpipeline_arm(jprofiles(sizes, 1e-3), JLINKS["commodity"], 64, 2,
                         8, act_bytes_mb=1e5)
    st, jst = strategy_from_plan(arm), jstrategy_from_plan(jarm)
    assert (st.pipeline_stages, st.micro_batches) == (2, 8)
    assert isinstance(st.grad_reducer, GradientSynchronizer)
    assert st.grad_reducer.cfg.bucket_bytes == 0
    assert st.describe() == jst.describe()


def test_session_checkpoint_of_micro_batched_run_is_leaf_shaped(
        tmp_path, one_thread):
    """A micro-batched session's checkpoint holds the model's leaves and
    restores into a replicated session; loading into a pipeline build is
    refused, as the reference refuses it."""
    st = SyncStrategy(get_scheduler("every_step"), parallelism="micro=2")
    sess = TrainSession(SessionConfig(device="cpu", **GEMMA), strategy=st)
    sess.run(1)
    sess.save_checkpoint(str(tmp_path / "ck"))
    back = TrainSession(SessionConfig(device="cpu", **GEMMA))
    assert back.load_checkpoint(str(tmp_path / "ck")) == 1
    for a, b in zip(tree_leaves(back.params), tree_leaves(sess.params),
                    strict=True):
        assert torch.equal(a, b)
    full = sess.full_opt_state()
    for k in ("m", "v"):
        for a, b in zip(tree_leaves(back.opt_state[k]),
                        tree_leaves(full[k]), strict=True):
            assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="pipeline"):
        TrainSession(SessionConfig(device="cpu", **GEMMA),
                     strategy=st).load_checkpoint(str(tmp_path / "ck"))


BASE = ["--device", "cpu", "--reduced", "--steps", "2", "--batch", "4",
        "--seq", "16", "--log-every", "1"]


@pytest.mark.parametrize("flags,pp,micro,warn", [
    (["--parallelism", "pp=2"], 2, 8, False),
    (["--parallelism", "pp=2,micro=4"], 2, 4, False),
    (["--pipeline-stages", "2"], 2, 8, True),
    (["--pipeline-stages", "2", "--micro-batches", "4"], 2, 4, True),
    (["--micro-batches", "2"], 1, 2, True)],
    ids=["pp", "pp-micro", "shim-stages", "shim-both", "shim-micro"])
def test_cli_resolves_pipeline_flags(flags, pp, micro, warn, capsys):
    args = train.build_parser().parse_args(BASE + flags)
    spec = train.resolve_cli_parallelism(args)
    assert (spec.pp, max(spec.micro_batches, 1)) == (pp, micro)
    assert ("deprecated" in capsys.readouterr().out) == warn


def test_cli_pipeline_refusals():
    for flags in (["--parallelism", "pp=2", "--pipeline-stages", "2"],
                  ["--pipeline-stages", "2", "--shard-state"],
                  ["--parallelism", "micro=2", "--local-sgd", "2"]):
        with pytest.raises(SystemExit):
            train.main(BASE + ["--sync", "comm"] + flags)


def test_cli_micro_batches_runs_at_world1(capsys, one_thread):
    sess = train.main(BASE + ["--sync", "comm", "--compressor",
                              "int8_fused", "--micro-batches", "2"])
    out = capsys.readouterr().out
    assert sess.staged is not None and sess.strategy.micro_batches == 2
    assert out.count("warning: --micro-batches deprecated") == 1
    assert "[micro-batches M=2]" in out and "pipeline: 1 stages" in out
    assert sess.grad_rounds == 2 and np.isfinite(sess.losses).all()


def test_cli_pipeline_world2_matches_world1(capfd):
    """``--parallelism pp=2,micro=2`` on a spawned world of 2 (dp 1)
    prints the losses of ``--parallelism micro=2`` at world 1."""
    flags = BASE + ["--sync", "comm", "--compressor", "int8_fused"]
    one = train.main(flags + ["--parallelism", "micro=2"])
    capfd.readouterr()
    assert train.main(flags + ["--parallelism", "pp=2,micro=2",
                               "--data-parallel", "2"]) is None
    out = capfd.readouterr().out
    assert "strategy: every_step [pipeline S=2 M=2]" in out
    assert f"final loss {one.losses[-1]:.4f} (first {one.losses[0]:.4f})" \
        in out
    assert "| 1 | 1 |" in out          # the stage table's second stage


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _w4_reference(sys.argv[2])
    print(json.dumps({"ok": True}))
