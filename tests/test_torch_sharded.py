"""Sharded data parallelism on the port (``PlanExecutor.sync_shards``,
``optim/sharded.py``, ``make_sharded_train_step``, the session's sharded
build and checkpoints) against its own replicated path and the JAX
package's.

  * ``sync_shards`` per arm (dense psum and ring, PowerSGD, aggregatable
    ``topk_fused`` and qsgd, gather-pattern ``int8_fused`` / int8 / sign /
    top-k) at world 1, from the same gradients and sync state: the shard
    equals the reference's ``sync_shards`` inside its one-device
    ``shard_map`` within 1e-6 of the gradient's largest magnitude, and
    equals the port's own replicated ``__call__`` BIT FOR BIT, EF residuals
    included.
  * The port's sharded step against its replicated step on the same plan,
    TinyLM, 3 steps, at world 1 and at world 4 (4 spawned processes on a
    gloo group): ``dense/psum``, ``dense/ring``, ``int8_fused/ring`` and
    ``topk_fused/ring`` × {adam, sgd} — parameters, the gathered master
    rows, the gathered Adam moments and the EF residuals all bit-equal
    (DESIGN.md §8).  LAMB and LARS within rtol 2e-5, atol 1e-7 (their
    trust-ratio norms are partial segment sums plus an all-reduce).
  * World 4 against the reference's ``make_sharded_train_step`` on 4 fake
    devices (this file run as a script with ``--reference``): parameters
    within the replicated conformance column's bounds (sgd 1e-7; adam
    1e-4 with at most 1% of the entries beyond 1e-6).
  * Checkpoints: a sharded session of reduced gemma-2b saves at world 4;
    the file restores into sharded sessions at world 2 and world 1 and a
    replicated one, whose full optimizer state (and ``master``, where
    kept) is the saved state bit for bit.
  * The refusals: local SGD, push/pull and LAG with ``shard``, a plan that
    does not match the layout, an unknown sharded optimizer.
"""
from __future__ import annotations

import dataclasses
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
from test_torch_conformance import LR, TinyLM, _batch, _tensors
from tiny_lm import TinyLM as JTinyLM
from tiny_lm import tiny_batch

from repro.core import PlanExecutor as JPlanExecutor
from repro.core import SyncConfig as JSyncConfig
from repro.core.grad_sync import \
    sharded_plan_from_config as jsharded_plan_from_config
from repro_torch._tree import tree_leaves
from repro_torch.api import SessionConfig, TrainSession
from repro_torch.core import (PlanExecutor, ShardLayout, SyncConfig,
                              SyncStrategy, get_scheduler, make_strategy,
                              sharded_plan_from_config)
from repro_torch.launch.dist import init_group, spawn
from repro_torch.launch.steps import (_make_synced_train_step,
                                      make_sharded_train_step)
from repro_torch.optim import (apply_rows_inplace, make_optimizer,
                               make_sharded_optimizer, step_inplace)

ROOT = Path(__file__).resolve().parents[1]
STEPS = 3
W4 = 4
# the wires whose sharded step is promised bit-equal to the replicated one
EXACT = [
    ("dense/psum", dict(compressor="none", algo="psum")),
    ("dense/ring", dict(compressor="none", algo="ring")),
    ("int8_fused/ring", dict(compressor="int8_fused", algo="ring",
                             compressor_args=(("tile", 128),),
                             bucket_bytes=2048)),
    ("topk_fused/ring", dict(compressor="topk_fused", algo="ring",
                             compressor_args=(("ratio", 0.25),
                                              ("tile", 128)),
                             bucket_bytes=2048)),
]
LAYERWISE = ("lamb", "lars")
SESSION = dict(arch="gemma-2b", reduced=True, batch=4, seq=16, lr=3e-3,
               warmup=1, steps=4)


@pytest.fixture(scope="module", autouse=True)
def world1():
    init_group(torch.device("cpu"))


def _plan(kw, jparams):
    """The port's sharded plan of ``kw``, checked equal to the reference's
    (``sharded_plan_from_config``) bucket by bucket."""
    plan = sharded_plan_from_config(SyncConfig(**kw), _tensors(jparams))
    jplan = jsharded_plan_from_config(JSyncConfig(**kw), jparams)
    assert [dataclasses.asdict(b) for b in plan.buckets] == \
        [dataclasses.asdict(b) for b in jplan.buckets]
    assert plan.shard_state and jplan.shard_state
    return plan


def _rows_of(batch, rank: int, world: int):
    toks = batch["tokens"]
    n = toks.shape[0] // world
    return {"tokens": toks[rank * n:(rank + 1) * n]}


def run_port(model, params0, plan, opt_name, mode: str, group=None,
             rank: int = 0, world: int = 1, steps: int = STEPS):
    """``steps`` synced TinyLM steps of the port on ``group``, replicated
    or sharded on the same plan, this rank's rows of each batch.  Returns
    (params, leaf-shaped optimizer state with ``master`` when sharded,
    sync state, losses)."""
    opt = make_optimizer(opt_name, lr=LR)
    ex = PlanExecutor(plan, group)
    p = _tensors(params0)
    if mode == "replicated":
        step_fn, _, _ = _make_synced_train_step(model, opt, ex, group)
        state = opt.init(p)
    else:
        layout = ShardLayout.from_plan(plan, p, (world,))
        shopt = make_sharded_optimizer(opt_name, layout, ex.axes, lr=LR)
        step_fn, init_rows, _ = make_sharded_train_step(model, ex, layout,
                                                        shopt, group)
        state = init_rows(p)
    sync_state = ex.init_state(p)
    losses = []
    for s in range(steps):
        p, state, sync_state, loss = step_fn(
            p, state, sync_state, _rows_of(_batch(s), rank, world), s,
            torch.Generator().manual_seed(s))
        losses.append(float(loss))
    if mode == "sharded":
        full = {k: layout.gather_tree(v, p, ex.axes)
                for k, v in state["opt"].items()}
        full["master"] = layout.gather_tree(state["master"], p, ex.axes)
        state = full
    return ({k: v.detach() for k, v in p.items()}, state, sync_state,
            losses)


def _assert_bit_equal(rep, sh, what):
    p_r, os_r, ss_r, l_r = rep
    p_s, os_s, ss_s, l_s = sh
    assert l_r == l_s, what
    for k in p_r:
        assert torch.equal(p_r[k], p_s[k]), (what, k)
        # the gathered master rows are the (f32) parameters
        assert torch.equal(os_s["master"][k], p_s[k]), (what, "master", k)
    for mom in os_r:
        for k in p_r:
            assert torch.equal(os_r[mom][k], os_s[mom][k]), (what, mom, k)
    assert ("error" in ss_r) == ("error" in ss_s)
    for a, b in zip(ss_r.get("error", []), ss_s.get("error", [])):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b), (what, "EF")


# ---------------------------------------------------------------------------
# sync_shards per arm, world 1
# ---------------------------------------------------------------------------

ARMS = [
    ("dense/psum", dict(compressor="none", algo="psum")),
    ("dense/ring", dict(compressor="none", algo="ring")),
    ("powersgd", dict(compressor="powersgd", algo="ring",
                      compressor_args=(("rank", 2),))),
    ("topk_fused", dict(compressor="topk_fused", algo="ring",
                        compressor_args=(("ratio", 0.25), ("tile", 128)),
                        bucket_bytes=2048)),
    ("qsgd", dict(compressor="qsgd", algo="ring", bucket_bytes=2048)),
    ("int8_fused", dict(compressor="int8_fused", algo="ring",
                        compressor_args=(("tile", 128),),
                        bucket_bytes=2048)),
    ("int8", dict(compressor="int8", algo="ring", bucket_bytes=2048)),
    ("sign", dict(compressor="sign", algo="psum", bucket_bytes=2048)),
    ("topk", dict(compressor="topk", algo="ring",
                  compressor_args=(("ratio", 0.25),), bucket_bytes=2048)),
]


def _reference_sync_shards(jplan, jgrads, state_fn):
    """The reference's ``sync_shards`` on a one-device mesh: the shards
    and the new sync state, as numpy."""
    mesh = jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    ex = JPlanExecutor(jplan, ("data",))

    def body():
        st = state_fn(ex)
        shards, new = ex.sync_shards(jgrads, st, jax.random.PRNGKey(7))
        return shards, new

    f = jax.shard_map(body, mesh=mesh, in_specs=(),
                      out_specs=jax.sharding.PartitionSpec(),
                      axis_names={"data"}, check_vma=False)
    shards, new = jax.jit(f)()
    return [np.asarray(s) for s in shards], new


@pytest.mark.parametrize("name,kw", ARMS, ids=[a[0] for a in ARMS])
def test_sync_shards_per_arm(name, kw):
    """Per arm: the port's shards equal the reference's within 1e-6 of the
    gradient's largest magnitude (qsgd, stochastic, is held to its own
    replicated path only), and equal the port's replicated ``__call__``
    output, packed and canonically chunked, bit for bit — EF residuals
    too."""
    jmodel = JTinyLM(d=80) if kw["compressor"] == "powersgd" else JTinyLM()
    params0 = jmodel.init(jax.random.PRNGKey(0))
    jgrads = jax.grad(jmodel.loss)(params0, tiny_batch(0))
    plan = _plan(kw, params0)
    grads = _tensors(jgrads)
    ex = PlanExecutor(plan)

    def fresh():
        return ex.init_state(grads)

    state = fresh()
    shards, new = ex.sync_shards(grads, state, torch.Generator()
                                 .manual_seed(3))
    assert new["step"] == 1 and len(shards) == plan.n_buckets
    layout = ShardLayout.from_plan(plan, grads, (1,))
    for b, s in zip(layout.buckets, shards):
        assert s.dtype == torch.float32 and tuple(s.shape) == (b.m,)

    # the replicated path on the same plan: bit for bit
    rstate = fresh()
    synced, rnew = ex(grads, rstate, torch.Generator().manual_seed(3))
    want = layout.my_rows(synced, None)
    for j, (a, b) in enumerate(zip(shards, want)):
        assert torch.equal(a, b), (name, j)
    for a, b in zip(new.get("error", []), rnew.get("error", [])):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b), (name, "EF")

    if kw["compressor"] == "qsgd":
        return
    jplan = jsharded_plan_from_config(JSyncConfig(**kw), params0)

    def jstate(jex):
        st = jex.init_state(params0)
        if "q" in st:       # PowerSGD: the port's warm start, as numpy
            st["q"] = [None if q is None else jnp.asarray(q.numpy())
                       for q in fresh()["q"]]
        return st

    jshards, jnew = _reference_sync_shards(jplan, jgrads, jstate)
    scale = max(float(np.abs(np.asarray(g)).max())
                for g in jax.tree.leaves(jgrads))
    for j, (a, b) in enumerate(zip(shards, jshards)):
        assert a.shape == b.shape, (name, j)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-6 * scale, err_msg=f"{name} {j}")
    for a, b in zip(new.get("error", []), jnew.get("error", [])):
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6 * scale, err_msg=name)


# ---------------------------------------------------------------------------
# Sharded == replicated, world 1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt_name", ["adam", "sgd"])
@pytest.mark.parametrize("name,kw", EXACT, ids=[w[0] for w in EXACT])
def test_world1_sharded_equals_replicated(name, kw, opt_name):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jmodel, model = JTinyLM(), TinyLM()
        params0 = jmodel.init(jax.random.PRNGKey(0))
        plan = _plan(kw, params0)
        rep = run_port(model, params0, plan, opt_name, "replicated")
        sh = run_port(model, params0, plan, opt_name, "sharded")
    finally:
        torch.set_num_threads(n)
    _assert_bit_equal(rep, sh, f"{name}/{opt_name}")


@pytest.mark.parametrize("opt_name", LAYERWISE)
def test_world1_layerwise_within_bounds(opt_name):
    jmodel, model = JTinyLM(), TinyLM()
    params0 = jmodel.init(jax.random.PRNGKey(0))
    plan = _plan(dict(compressor="none", algo="ring"), params0)
    p_r, _, _, _ = run_port(model, params0, plan, opt_name, "replicated")
    p_s, os_s, _, _ = run_port(model, params0, plan, opt_name, "sharded")
    for k in p_r:
        np.testing.assert_allclose(p_s[k].numpy(), p_r[k].numpy(),
                                   rtol=2e-5, atol=1e-7, err_msg=k)
        assert torch.equal(os_s["master"][k], p_s[k])


@pytest.mark.parametrize("apply", ["rows", "leaves"])
@pytest.mark.parametrize("opt_name", ["adam", "sgd"])
def test_update_in_chunks_is_bit_equal(opt_name, apply):
    """An elementwise optimizer runs a large row (``apply_rows_inplace``,
    the sharded step) or leaf (``step_inplace``, the replicated step) in
    chunks of 16 M elements: ragged chunks of 7 elements give the whole
    update bit for bit — masters or f32 and bf16 parameters, and the
    moments — over 3 steps."""
    gen = torch.Generator().manual_seed(0)
    if apply == "rows":
        start = [torch.randn(n, generator=gen) for n in (1, 50, 1000)]
    else:
        start = [torch.randn(40, 25, generator=gen),
                 torch.randn(3, 7, 9, generator=gen).to(torch.bfloat16)]
    grads = [[torch.randn(r.shape, generator=gen).to(r.dtype)
              for r in start] for _ in range(3)]
    runs = []
    for chunk in (7, 1 << 24):
        opt = make_optimizer(opt_name, lr=LR, **(
            {"momentum": 0.9} if opt_name == "sgd" else {}))
        masters = [r.clone() for r in start]
        state = opt.init(masters)
        for step, g in enumerate(grads):
            if apply == "rows":
                apply_rows_inplace(opt, masters, g, state, step, chunk=chunk)
            else:
                step_inplace(opt, masters, g, state, step, chunk=chunk)
        runs.append((masters, state))
    (ma, sa), (mb, sb) = runs
    assert all(torch.equal(a, b) for a, b in zip(ma, mb))
    assert sorted(sa) == sorted(sb) and sa
    for k in sa:
        assert all(torch.equal(a, b) for a, b in zip(sa[k], sb[k]))


# ---------------------------------------------------------------------------
# World 4 on gloo, against itself and against the reference
# ---------------------------------------------------------------------------

REF_RUNS = [("dense/ring", "adam"), ("dense/ring", "sgd"),
            ("int8_fused/ring", "adam"), ("topk_fused/ring", "sgd")]


def _w4_port(rank: int, world: int, store: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    init_group(torch.device("cpu"), world_size=world, rank=rank,
               store_path=store)
    jparams = {k: np.asarray(v) for k, v in
               np.load(os.path.join(out_dir, "start.npz")).items()}
    model = TinyLM()
    out, res = {}, {}
    for name, kw in EXACT:
        plan = sharded_plan_from_config(SyncConfig(**kw), _tensors(jparams))
        for opt_name in ("adam", "sgd"):
            rep = run_port(model, jparams, plan, opt_name, "replicated",
                           rank=rank, world=world)
            sh = run_port(model, jparams, plan, opt_name, "sharded",
                          rank=rank, world=world)
            try:
                _assert_bit_equal(rep, sh, f"{name}/{opt_name}")
                res[f"{name}/{opt_name}"] = "equal"
            except AssertionError as e:
                res[f"{name}/{opt_name}"] = f"differs: {e}"
            for k, v in sh[0].items():
                out[f"{name}/{opt_name}/{k}"] = v.numpy()
    plan = sharded_plan_from_config(SyncConfig(algo="ring"),
                                    _tensors(jparams))
    for opt_name in LAYERWISE:
        p_r, _, _, _ = run_port(model, jparams, plan, opt_name,
                                "replicated", rank=rank, world=world)
        p_s, _, _, _ = run_port(model, jparams, plan, opt_name, "sharded",
                                rank=rank, world=world)
        res[opt_name] = max(float(((p_s[k] - p_r[k]).abs() - 1e-7 -
                                   2e-5 * p_r[k].abs()).max())
                            for k in p_r)
    res["checkpoint"] = _w4_checkpoint(rank, out_dir)
    np.savez(os.path.join(out_dir, f"port-{rank}.npz"), **out)
    with open(os.path.join(out_dir, f"port-{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


def _equal_trees(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _w4_checkpoint(rank: int, out_dir: str) -> dict:
    """A sharded session at world 4 trains 2 steps and saves; the file
    restores into sharded sessions on world-2 and world-1 subgroups and
    into a replicated one (rank 0): each one's full optimizer state is
    the saved one bit for bit."""
    import torch.distributed as dist
    path = os.path.join(out_dir, "ck")
    strat = make_strategy("every_step", sync=SyncConfig(algo="ring"),
                          parallelism="shard")
    sess = TrainSession(SessionConfig(device="cpu", **SESSION),
                        strategy=strat)
    sess.run(2)
    saved = sess.full_opt_state()
    sess.save_checkpoint(path)
    res = {"world": sess.world,
           "row_elems": sum(int(r.numel()) for r in sess.opt_state["master"]),
           "param_elems": sess.num_params()}
    g2 = dist.new_group([0, 1])
    g1 = dist.new_group([0])
    for tag, group, ranks in (("world2", g2, (0, 1)), ("world1", g1, (0,))):
        if rank not in ranks:
            continue
        re = TrainSession(SessionConfig(device="cpu", **SESSION),
                          strategy=make_strategy(
                              "every_step", group=group,
                              sync=SyncConfig(algo="ring"),
                              parallelism="shard"), group=group)
        res[f"{tag}_step"] = re.load_checkpoint(path)
        re._build()
        got = re.full_opt_state()
        res[tag] = (sorted(got) == sorted(saved) and all(
            _equal_trees(got[k], saved[k]) for k in saved)
            and re.layout.world == len(ranks))
    if rank == 0:
        rp = TrainSession(SessionConfig(device="cpu", **SESSION),
                          group=g1)
        rp.load_checkpoint(path)
        rp._build()
        res["replicated"] = (sorted(rp.opt_state) == ["m", "v"] and all(
            _equal_trees(rp.opt_state[k], saved[k]) for k in ("m", "v"))
            and _equal_trees(rp.params, sess.params))
    dist.barrier()
    return res


def _w4_reference(out_dir: str) -> None:
    """The reference's sharded step on 4 fake devices, 3 steps per run of
    ``REF_RUNS``: its parameters."""
    from jax.sharding import AxisType

    from repro.core import ShardLayout as JShardLayout
    from repro.launch.steps import make_sharded_train_step as jstep
    from repro.optim import make_sharded_optimizer as jshopt
    mesh = jax.make_mesh((W4,), ("data",), axis_types=(AxisType.Auto,))
    jmodel = JTinyLM()
    params0 = {k: jnp.asarray(v) for k, v in
               np.load(os.path.join(out_dir, "start.npz")).items()}
    kws = dict(EXACT)
    out = {}
    for name, opt_name in REF_RUNS:
        plan = jsharded_plan_from_config(JSyncConfig(**kws[name]), params0)
        ex = JPlanExecutor(plan, ("data",))
        layout = JShardLayout.from_plan(plan, params0, (W4,))
        shopt = jshopt(opt_name, layout, ("data",), lr=LR)
        fn, init_rows, init_ss = jstep(jmodel, ex, layout, shopt, mesh,
                                       ("data",))
        p, rows, ss = params0, init_rows(params0), init_ss(params0)
        jit = jax.jit(fn)
        for s in range(STEPS):
            p, rows, ss, _ = jit(p, rows, ss, tiny_batch(s),
                                 jnp.asarray(s, jnp.int32),
                                 jax.random.fold_in(jax.random.PRNGKey(1), s))
        for k, v in p.items():
            out[f"{name}/{opt_name}/{k}"] = np.asarray(v)
    np.savez(os.path.join(out_dir, "reference.npz"), **out)


@pytest.fixture(scope="module")
def w4_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_w4")
    start = JTinyLM().init(jax.random.PRNGKey(0))
    np.savez(out / "start.npz", **{k: np.asarray(v)
                                   for k, v in start.items()})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, __file__, "--reference",
                            str(out)], env=env, cwd=ROOT / "tests",
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    try:
        spawn(_w4_port, W4, args=(str(out),), timeout=240)
        log, _ = ref.communicate(timeout=300)
    finally:
        ref.kill()
    assert ref.returncode == 0, log[-4000:]
    want = dict(np.load(out / "reference.npz"))
    got = [dict(np.load(out / f"port-{r}.npz")) for r in range(W4)]
    res = [json.loads((out / f"port-{r}.json").read_text())
           for r in range(W4)]
    return want, got, res


@pytest.mark.parametrize("opt_name", ["adam", "sgd"])
@pytest.mark.parametrize("name", [w[0] for w in EXACT])
def test_world4_sharded_equals_replicated(w4_runs, name, opt_name):
    """On every rank: parameters, gathered master rows and moments, EF
    residuals bit-equal to the replicated step on the same plan; and the
    ranks hold one model."""
    _, got, res = w4_runs
    key = f"{name}/{opt_name}"
    for r in range(W4):
        assert res[r][key] == "equal", (r, res[r][key])
        for k in ("emb", "out", "b"):
            assert np.array_equal(got[r][f"{key}/{k}"], got[0][f"{key}/{k}"])


@pytest.mark.parametrize("opt_name", LAYERWISE)
def test_world4_layerwise_within_bounds(w4_runs, opt_name):
    _, _, res = w4_runs
    for r in range(W4):
        assert res[r][opt_name] <= 0.0, (r, res[r][opt_name])


@pytest.mark.parametrize("name,opt_name", REF_RUNS,
                         ids=[f"{a}-{b}" for a, b in REF_RUNS])
def test_world4_matches_reference(w4_runs, name, opt_name):
    want, got, _ = w4_runs
    for k in ("emb", "out", "b"):
        key = f"{name}/{opt_name}/{k}"
        d = np.abs(got[0][key] - want[key])
        if opt_name == "sgd":
            assert d.max() <= 1e-7, (key, d.max())
        else:
            assert d.max() <= 1e-4 and (d > 1e-6).mean() <= 0.01, \
                (key, d.max())


@pytest.mark.parametrize("target", ["world2", "world1", "replicated"])
def test_world4_checkpoint_restores_bit_equal(w4_runs, target):
    _, _, res = w4_runs
    ck = res[0]["checkpoint"]
    assert ck["world"] == W4 and ck[target] is True, ck
    if target != "replicated":
        assert ck[f"{target}_step"] == 2
        assert res[1]["checkpoint"].get("world2") is True
    # each rank of the world-4 session held a quarter of the state
    assert ck["row_elems"] <= -(-ck["param_elems"] // W4) + 16 * 8


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sched_kw", [
    dict(scheduler="local_sgd", period=2),
    dict(scheduler="push_pull", n_push=2, n_fetch=2),
    dict(scheduler="lag", threshold=0.5),
], ids=["local_sgd", "push_pull", "lag"])
def test_shard_state_refuses_diverging_schedulers(sched_kw):
    with pytest.raises(ValueError, match="shard_state requires an "
                                         "every-step gradient-sync"):
        make_strategy(parallelism="shard", **sched_kw)
    with pytest.raises(ValueError, match="shard_state"):
        SyncStrategy(scheduler=get_scheduler(**{
            "name" if k == "scheduler" else k: v
            for k, v in sched_kw.items()}), parallelism="dp=1,shard")


def test_refuses_mismatched_layout_and_unknown_optimizer():
    jparams = JTinyLM().init(jax.random.PRNGKey(0))
    params = _tensors(jparams)
    plan = sharded_plan_from_config(SyncConfig(), params)
    other = sharded_plan_from_config(SyncConfig(bucket_bytes=2048), params)
    assert other.n_buckets > plan.n_buckets
    layout = ShardLayout.from_plan(other, params, (1,))
    opt = make_sharded_optimizer("adam", layout)
    with pytest.raises(ValueError, match="does not match"):
        make_sharded_train_step(TinyLM(), PlanExecutor(plan), layout, opt)
    with pytest.raises(KeyError, match="no sharded variant"):
        make_sharded_optimizer("adagrad", layout)


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _w4_reference(sys.argv[2])
    print(json.dumps({"ok": True}))
