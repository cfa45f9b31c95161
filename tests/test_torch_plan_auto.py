"""``--sync auto`` on the port (``TrainSession.plan_auto``, the CLI, the
executor's mixed plans) against the JAX package's.

  * Session parity on reduced gemma-2b at a pinned backward time: the free
    search (a heterogeneous every-step plan at world 4's topology, a
    tp(2) arm on ``commodity_cluster``), a pinned local-SGD scheduler, a
    pinned LAG scheduler, the pipeline-winner fallback (the reference's
    note, then the best executable arm) and the shard winner (the
    reference picks ``every_step_sharded``; the port raises
    ``NotImplementedError`` naming item 8 before the first step): the same
    ``planned`` record (winner, every arm, the fixed baselines, the
    backward time) and the same executed plan.  Two synced steps of the
    planned strategies then agree with the reference's: losses at rtol
    1e-6 and at most 1% of the parameters beyond 1e-6, as in the
    replicated conformance column (``tests/test_torch_conformance.py``).
    Its 1e-4 cap on every Adam parameter does not hold at this size: an
    int8 code that the jitted reference rounds the other way (ROADMAP.md
    queue 3) moves an entry by up to the learning rate (measured: 1.1e-3
    on 0.016% of the entries after 2 steps), so the cap is the Adam
    envelope of ``tests/test_torch_training.py``, and an EF residual's,
    2.5 times the residual's largest magnitude (a flip moves it by one
    quantization step, twice its largest value).
  * A planner plan of per-leaf buckets (compressed and dense side by side)
    for TinyLM, through the conformance column's harness for 2 steps:
    within that column's bounds, unchanged.
  * ``BucketPlan.fused=False``: the decomposed EF chain and the per-rank
    decode give the fused wire's results bit for bit at world 1
    (``tests/test_conformance.py``'s fused-vs-unfused trajectory; the
    world-8 case is in ``tests/test_torch_collectives.py``).
  * The CLI: ``--sync auto --topology commodity_cluster`` on the CPU
    prints the plan and baselines, writes the record and trains, with the
    reference CLI's winner and buckets at a pinned ``--plan-backward-ms``;
    the ignored-flags warning; the ``auto <= best fixed baseline`` check;
    the flags of later items raise and name them.
  * World 4 (4 spawned processes on gloo, ``FileStore``) on
    ``node:2@commodity,device:2@fast_ici``: the tiered mesh (one group per
    tier, ``hierarchical`` on the inner one), every rank the same plan as
    the reference's session on 4 fake devices (this file run as a script),
    4 synced steps within the bounds of ``tests/test_torch_strategy.py``'s
    world-4 run; with the backward MEASURED per rank, every rank still
    plans one plan (the group's minimum backward time); ``--sync comm
    --topology`` runs its reducer on the tier groups.
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
import numpy as np
import pytest
import torch
from test_torch_planner import (_assert_same_arm, _assert_same_comm,
                                _bucket_key, assert_same_rounds)
from test_torch_training import _assert_close_after_steps

import repro_torch.launch.paths as p_paths
from repro.api import SessionConfig as JSessionConfig
from repro.api import TrainSession as JTrainSession
from repro.core import get_scheduler as jget_scheduler
from repro.core.schedule import DEFAULT_CANDIDATES as JCANDIDATES
from repro_torch import api as p_api
from repro_torch._tree import tree_leaves
from repro_torch.api import SessionConfig, TrainSession, plan_decision
from repro_torch.checkpoint.checkpoint import _flatten_with_paths
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax, to_numpy
from repro_torch.core import (PlanExecutor, SyncConfig, get_scheduler,
                              plan_from_config)
from repro_torch.core.schedule import DEFAULT_CANDIDATES
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.launch.dist import init_group

ROOT = Path(__file__).resolve().parents[1]
CFG = reduced(get_config("gemma-2b"))
SESSION = dict(arch="gemma-2b", reduced=True, batch=4, seq=32, lr=3e-3,
               warmup=2, steps=8)
TIERED = "node:2@commodity,device:2@fast_ici"
W4 = 4
W4_STEPS = 4
W4_T_BWD = 0.01
W4_LEAVES = ("embed", "mixer", "norm")


@pytest.fixture(scope="module", autouse=True)
def world1():
    init_group(torch.device("cpu"))


def _no_tree(cands):
    return tuple(c for c in cands if c.algo != "tree")


# ---------------------------------------------------------------------------
# Session parity
# ---------------------------------------------------------------------------

def _pair(**cfg):
    """A reference session and a port session on its parameters."""
    kw = dict(SESSION, **cfg)
    jsess = JTrainSession(JSessionConfig(**kw))
    start = jax.tree.map(np.asarray, jsess._params)
    sess = TrainSession(SessionConfig(device="cpu", **kw),
                        params=params_from_jax(start, CFG, device="cpu"))
    return jsess, sess


def _assert_same_planned(jsess, sess):
    jp, pp = jsess.planned, sess.planned
    _assert_same_arm(jp["strategy_plan"], pp["strategy_plan"], "winner")
    assert_same_rounds((jp["strategy_plan"], jp["arms"]),
                       (pp["strategy_plan"], pp["arms"]), "arms")
    assert sorted(jp["baselines"]) == sorted(pp["baselines"])
    for k in jp["baselines"]:
        _assert_same_comm(jp["baselines"][k], pp["baselines"][k], k)
    assert jp["t_backward_s"] == pp["t_backward_s"]
    assert (jp["cost_table"] is None) == (pp["cost_table"] is None)
    # the executed strategy: the same reducers on the same plans
    assert sess.strategy.describe() == jsess.strategy.describe()
    for attr in ("grad_reducer", "param_reducer"):
        got, want = (getattr(sess.strategy, attr),
                     getattr(jsess.strategy, attr))
        assert (got is None) == (want is None), attr
        if got is not None:
            assert [_bucket_key(b) for b in got.plan.buckets] == \
                [_bucket_key(b) for b in want.plan.buckets], attr


def _assert_steps_close(sess, jsess, losses, jlosses, steps=2):
    """Losses at rtol 1e-6; parameters and EF residuals at most 1% beyond
    1e-6, each within its envelope (the module docstring)."""
    np.testing.assert_allclose(losses, jlosses, rtol=1e-6)
    envelope = 2 * 3.2 * sum(
        SESSION["lr"] * min(1.0, s / SESSION["warmup"]) for s in range(steps))
    for a, b in zip(tree_leaves(to_numpy(sess.params)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jsess.params)),
                    strict=True):
        _assert_close_after_steps(a, b, 0.01, envelope)
    errs = list((sess.sync_state or {}).get("error", []))
    jerrs = list((jsess.sync_state or {}).get("error", []))
    assert len(errs) == len(jerrs)
    for e, je in zip(errs, jerrs):
        assert (e is None) == (je is None)
        if e is not None:
            je = np.asarray(je)
            _assert_close_after_steps(e.numpy(), je, 0.01,
                                      2.5 * np.abs(je).max())


FREE = [  # (topology, t_backward_s, the planned arm's wires)
    ("device:4@fast_ici", 0.01, {("ring_fused", "int8_fused"),
                                 ("tree", "none")}),
    ("commodity_cluster", 0.05, {("tree", "int8")}),
]


@pytest.mark.parametrize("topology,t_bwd,wires", FREE,
                         ids=["device4", "commodity_cluster"])
def test_free_search_session_matches_reference(topology, t_bwd, wires):
    jsess, sess = _pair()
    jsp = jsess.plan_auto(topology=topology, t_backward_s=t_bwd)
    sp = sess.plan_auto(topology=topology, t_backward_s=t_bwd)
    assert sp.key == jsp.key
    assert {(b.algo, b.compressor) for b in sp.comm.buckets} == wires
    assert sess.planned["executed"] is sp
    _assert_same_planned(jsess, sess)
    assert isinstance(sess.strategy.grad_reducer, PlanExecutor)
    assert sess.strategy.grad_reducer.plan is sp.comm
    if sp.tp > 1:                       # tp is carried as a record axis
        assert sess.strategy.parallelism.tp == sp.tp
    jlosses, losses = jsess.run(2), sess.run(2)
    assert sess.grad_rounds == jsess.grad_rounds == 2
    _assert_steps_close(sess, jsess, losses, jlosses)


def test_pinned_local_sgd_session_matches_reference():
    jsess, sess = _pair()
    jsp = jsess.plan_auto(topology=TIERED, t_backward_s=0.01,
                          scheduler=jget_scheduler("local_sgd", period=2))
    sp = sess.plan_auto(topology=TIERED, t_backward_s=0.01,
                        scheduler=get_scheduler("local_sgd", period=2))
    assert sp.key == jsp.key == "local_sgd/tau2"
    _assert_same_planned(jsess, sess)
    assert sess.strategy.grad_reducer is None
    assert sess.strategy.param_reducer.plan.buckets == sp.comm.buckets
    # the session's world is 1: the 4-rank topology is a planning model
    assert not sess.tiered_mesh and sess.axes == (None,)
    jlosses, losses = jsess.run(2), sess.run(2)
    assert (sess.grad_rounds, sess.param_rounds) == \
        (jsess.grad_rounds, jsess.param_rounds) == (0, 1)
    _assert_steps_close(sess, jsess, losses, jlosses)


def test_pinned_lag_session_matches_reference():
    jsess, sess = _pair()
    jsp = jsess.plan_auto(topology="node:4@datacenter", t_backward_s=0.01,
                          scheduler=jget_scheduler("lag", threshold=0.5))
    sp = sess.plan_auto(topology="node:4@datacenter", t_backward_s=0.01,
                        scheduler=get_scheduler("lag", threshold=0.5))
    assert sp.key == jsp.key == "lag"
    assert {(b.algo, b.compressor) for b in sp.comm.buckets} == \
        {("ring", "topk"), ("tree", "none")}
    _assert_same_planned(jsess, sess)


def test_pipeline_winner_runs_the_best_executable_arm(capsys):
    # SGD, 4096 tokens a step, no local-SGD arm: the modeled winner is a
    # pipeline, which neither host can stage (one device)
    kw = dict(optimizer="sgd", batch=8, seq=512)
    jsess, sess = _pair(**kw)
    plan_kw = dict(topology=TIERED, t_backward_s=1e-3, tau_grid=(1,))
    capsys.readouterr()
    jsp = jsess.plan_auto(**plan_kw)
    jnote = capsys.readouterr().out
    sp = sess.plan_auto(**plan_kw)
    note = capsys.readouterr().out
    assert sp.key == jsp.key == "pipeline(S=2,M=32)@device"
    assert note == jnote and note.startswith(
        "note: modeled winner pipeline(S=2,M=32)@device needs a pipe(2) "
        "mesh this host cannot build; executing ")
    executed = sess.planned["executed"]
    assert executed.pipeline_stages == 1
    assert executed.key == min(
        (a for a in sess.planned["arms"].values()
         if a.pipeline_stages <= 1), key=lambda a: a.modeled_step_s).key
    assert f"executing {executed.key} instead" in note
    _assert_same_planned(jsess, sess)


def test_shard_winner_raises_before_the_first_step():
    jsess, sess = _pair()
    pb = 4.0 * sum(int(p.numel()) for p in tree_leaves(sess.params))
    plan_kw = dict(topology="node:16@datacenter", t_backward_s=0.01,
                   memory_budget_gb=0.2 * pb / 2**30)
    jsp = jsess.plan_auto(**plan_kw)
    assert jsp.key == "every_step_sharded"
    with pytest.raises(NotImplementedError, match="item 8"):
        sess.plan_auto(**plan_kw)
    assert sess.strategy is None and sess.step == 0 and not sess._built


def test_plan_auto_refuses_what_the_reference_refuses():
    _, sess = _pair()
    with pytest.raises(ValueError, match="shard_state"):
        sess.plan_auto(t_backward_s=0.01, shard_state=True,
                       scheduler=get_scheduler("lag"))
    with pytest.raises(ValueError, match="memory_budget_gb"):
        sess.plan_auto(t_backward_s=0.01, memory_budget_gb=1.0,
                       scheduler=get_scheduler("lag"))
    sess.plan_auto(t_backward_s=0.01)
    assert sess.planned["strategy_plan"].comm.n_buckets == 1   # world 1
    sess.run(1)
    with pytest.raises(RuntimeError, match="before the first step"):
        sess.plan_auto(t_backward_s=0.01)
    with pytest.raises(RuntimeError, match="before the first step"):
        sess.apply_topology(TIERED)


def test_profile_backward_times_this_ranks_slice():
    _, sess = _pair()
    t = sess.profile_backward(repeats=2)
    assert 0.0 < t < 60.0
    sess.plan_auto(topology="device:4@fast_ici")    # measured
    assert sess.planned["t_backward_s"] > 0.0
    assert len(sess.planned["digest"]) == 64


@pytest.mark.parametrize("opt_name", ["adam", "sgd"])
@pytest.mark.parametrize("topology,wires", [
    ("node:4@datacenter", {("ring", "topk")}),
    ("commodity_cluster", {("tree", "int8")})], ids=["topk", "int8"])
def test_planned_tinylm_plan_within_conformance_bounds(topology, wires,
                                                       opt_name, monkeypatch):
    """The planner's plan for a wider TinyLM at a 128 KiB fusion grid (one
    single-leaf bucket per leaf; the bias is produced last, so its bucket
    takes the matrices' wire), from each package's planner, through the
    replicated conformance column for 2 steps."""
    import repro.core.schedule as jsched
    from test_conformance import _run_replicated
    from test_torch_conformance import TinyLM, _reference_init_state, \
        _run_port
    from tiny_lm import TinyLM as JTinyLM

    import repro_torch.core.schedule as psched
    jmodel, model = JTinyLM(vocab=512, d=96), TinyLM(vocab=512, d=96)
    params0 = jmodel.init(jax.random.PRNGKey(0))
    sizes = [int(np.prod(x.shape)) * 4 for x in jax.tree.leaves(params0)]
    jt = jsched.Topology.from_spec(topology)
    jplan = jsched.plan(jsched.profiles_from_sizes(sizes, 0.01), jt,
                        jt.world, bucket_grid=(2**20 // 8,))
    pt = psched.Topology.from_spec(topology)
    plan = psched.plan(psched.profiles_from_sizes(sizes, 0.01), pt,
                       pt.world, bucket_grid=(2**20 // 8,))
    _assert_same_comm(jplan, plan)
    assert {(b.algo, b.compressor) for b in plan.buckets} == wires
    steps = 2
    jp, _, jss, jlosses = _run_replicated(jmodel, params0, jplan, opt_name,
                                          steps=steps)
    state = _reference_init_state(jmodel, params0, jplan, opt_name)
    p, _, ss, losses = _run_port(model, params0, plan, opt_name, state,
                                 steps=steps)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-6)
    for k in jp:
        a, b = p[k].numpy(), np.asarray(jp[k])
        d = np.abs(a - b)
        if opt_name == "sgd":
            assert d.max() <= 1e-7, (k, d.max())
        else:
            assert d.max() <= 1e-4, (k, d.max())
            assert (d > 1e-6).mean() <= 0.01, (k, (d > 1e-6).mean())
    for e, je in zip(ss["error"], jss["error"], strict=True):
        assert (e is None) == (je is None)
        if e is not None:
            np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=0,
                                       atol=1e-6)


# ---------------------------------------------------------------------------
# BucketPlan.fused = False
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("int8_fused", dict(compressor="int8_fused", algo="ring",
                        bucket_bytes=2048)),
    ("topk_fused", dict(compressor="topk_fused", algo="ring",
                        compressor_args=(("ratio", 0.25),),
                        bucket_bytes=2048))], ids=["int8_fused", "topk_fused"])
def test_fused_vs_unfused_bit_trajectory(name, kw):
    """The fused wire vs the SAME plan with ``fused=False`` (the decomposed
    chain: EF add, compress, decompress, residual; the per-rank decode),
    3 rounds of fresh gradients: synced sums and EF residuals bit-equal
    (both are the plain versions on the CPU, whose fused and decomposed
    forms round alike)."""
    tmpl = {"w": torch.zeros(64, 33), "b": torch.zeros(17)}
    plan_f = plan_from_config(SyncConfig(**kw), tmpl)
    assert all(b.fused for b in plan_f.buckets) and plan_f.n_buckets > 1
    plan_u = dataclasses.replace(plan_f, buckets=tuple(
        dataclasses.replace(b, fused=False) for b in plan_f.buckets))
    rng = np.random.default_rng(3)
    grads = [{k: torch.from_numpy(rng.standard_normal(v.shape).astype(
        np.float32)) for k, v in tmpl.items()} for _ in range(3)]

    def run(plan):
        ex = PlanExecutor(plan)
        calls = []

        def counted(hook):
            def call(*a, **kw):
                calls.append(hook)
                return hook(*a, **kw)
            return None if hook is None else call

        ex.comps = [dataclasses.replace(
            c, fused_ef_compress=counted(c.fused_ef_compress),
            fused_decode_sum=counted(c.fused_decode_sum)) for c in ex.comps]
        state, out = ex.init_state(tmpl), []
        for g in grads:
            synced, state = ex({k: v.clone() for k, v in g.items()}, state)
            out.append(synced)
        return out, state, len(calls)

    (sf, stf, nf), (su, stu, nu) = run(plan_f), run(plan_u)
    # the fused arm runs the one-pass hooks, the unfused arm never does
    assert nf >= 3 * plan_f.n_buckets and nu == 0
    for a, b in zip(sf, su):
        for k in a:
            assert torch.equal(a[k], b[k]), (name, k)
    assert any(e is not None and torch.any(e != 0) for e in stf["error"])
    for a, b in zip(stf["error"], stu["error"]):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

BASE = ["--device", "cpu", "--reduced", "--steps", "2", "--batch", "2",
        "--seq", "16"]


@pytest.fixture()
def plan_dirs(tmp_path, monkeypatch):
    """Both packages' plan records under ``tmp_path``."""
    import repro.launch.paths as j_paths
    monkeypatch.setattr(p_paths, "COMM_PLANS", str(tmp_path / "port"))
    monkeypatch.setattr(j_paths, "COMM_PLANS", str(tmp_path / "ref"))
    return tmp_path


def test_cli_sync_auto_commodity_cluster_on_cpu(plan_dirs, capsys):
    ops.reset_launch_counts()
    session = train.main(BASE + ["--sync", "auto", "--topology",
                                 "commodity_cluster"])
    out = capsys.readouterr().out
    assert "### Sync strategy (auto-tuned" in out
    assert "| fixed config | modeled iteration | auto speedup |" in out
    assert "topology: node:32@commodity,device:8@fast_ici (planning model" \
        in out
    assert out.strip().splitlines()[-1].startswith("final loss ")
    assert np.isfinite(session.losses).all() and len(session.losses) == 2
    assert all(n == 0 for n in ops.launch_counts().values())
    # the winner depends on the measured backward; the record is its own
    rec = json.loads((plan_dirs / "port" / "gemma-2b.json").read_text())
    sp = session.planned["strategy_plan"]
    assert sp.key in session.planned["arms"]
    assert rec["world"] == sp.comm.world and rec["n_buckets"] == \
        sp.comm.n_buckets
    assert rec["schedule"] == {"kind": sp.schedule.kind,
                               "period": sp.schedule.period}
    assert rec["t_backward_s"] == session.planned["t_backward_s"] > 0


def test_cli_plan_matches_reference_cli(plan_dirs, capsys):
    from repro.launch import train as jtrain
    flags = ["--arch", "gemma-2b", "--reduced", "--steps", "1", "--batch",
             "2", "--seq", "16",
             "--sync", "auto", "--topology", "commodity_cluster",
             "--plan-backward-ms", "20"]
    jtrain.main(flags)
    train.main(["--device", "cpu"] + flags)
    want = json.loads((plan_dirs / "ref" / "gemma-2b.json").read_text())
    got = json.loads((plan_dirs / "port" / "gemma-2b.json").read_text())
    assert set(got) == set(want)
    for k in got:
        if k in ("modeled_step_s", "round_cost_s", "t_backward_s",
                 "opt_mem_bytes_per_worker"):
            assert got[k] == pytest.approx(want[k], rel=1e-12), k
        elif k == "topology":
            assert got[k]["spec"] == want[k]["spec"]
            for t, c in want[k]["tier_cost_s"].items():
                assert got[k]["tier_cost_s"][t] == pytest.approx(c,
                                                                 rel=1e-12)
        elif k == "parallelism":
            assert {a: b for a, b in got[k].items() if a != "model_comm_s"} \
                == {a: b for a, b in want[k].items() if a != "model_comm_s"}
        else:
            assert got[k] == want[k], k


def test_cli_auto_warns_about_ignored_flags(plan_dirs, capsys):
    train.main(BASE[:3] + ["--steps", "1", "--batch", "2", "--seq", "16",
                           "--sync", "auto", "--compressor", "int8",
                           "--algo", "ring", "--plan-backward-ms", "5"])
    out = capsys.readouterr().out
    assert "warning: --sync auto chooses per-bucket strategies; ignoring " \
        "--compressor, --algo" in out


def test_cli_auto_holds_the_planner_to_the_fixed_baselines(plan_dirs,
                                                           monkeypatch):
    real = p_api.fixed_config_plan

    def too_good(*a, **kw):
        return dataclasses.replace(real(*a, **kw), modeled_step_s=0.0)

    monkeypatch.setattr(p_api, "fixed_config_plan", too_good)
    with pytest.raises(RuntimeError, match="planner regression"):
        train.main(BASE + ["--sync", "auto", "--plan-backward-ms", "5"])


@pytest.mark.parametrize("flags,item", [
    (["--calibrate"], "item 11"), (["--replan-drift-pct", "10"], "item 11"),
    (["--replan-every", "5"], "item 11"),
    (["--parallelism", "dp=1,shard"], "items 8-10")],
    ids=["calibrate", "replan-drift", "replan-every", "parallelism"])
def test_cli_flags_of_later_items_raise(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        train.main(BASE + ["--sync", "auto"] + flags)


def test_cli_topology_warns_about_flat_link_flags(plan_dirs, capsys):
    train.main(BASE + ["--sync", "auto", "--topology", "device:4@fast_ici",
                       "--link", "commodity", "--alpha", "1e-5",
                       "--plan-backward-ms", "5"])
    out = capsys.readouterr().out
    assert "ignoring flat link flags --link, --alpha" in out


# ---------------------------------------------------------------------------
# World 4: the tiered mesh on a gloo group against 4 fake devices
# ---------------------------------------------------------------------------

def _w4_kept(key: str) -> bool:
    return any(part in key for part in W4_LEAVES)


def _w4_reference(out_dir: str) -> None:
    """The reference's session on 4 fake devices, planned on the tiered
    topology with every-step sync: its decision and every step's kept
    leaves."""
    sess = JTrainSession(JSessionConfig(data_parallel=W4, **dict(
        SESSION, steps=W4_STEPS)))
    sp = sess.plan_auto(topology=TIERED, t_backward_s=W4_T_BWD,
                        scheduler=jget_scheduler("every_step"),
                        candidates=_no_tree(JCANDIDATES))
    assert sess.tiered_mesh
    out = {}
    for s in range(W4_STEPS):
        sess.step_once()
        for k, v in _flatten_with_paths(jax.tree.map(
                np.array, sess._params)).items():
            if _w4_kept(k):
                out[f"{s}/{k}"] = v
    out["losses"] = np.asarray(sess.losses)
    np.savez(os.path.join(out_dir, "reference.npz"), **out)
    with open(os.path.join(out_dir, "reference.json"), "w") as f:
        json.dump({"key": sp.key, "buckets": [
            [list(b.leaves), b.algo, b.compressor,
             [list(a) for a in b.compressor_args], int(b.bucket_bytes),
             b.pack] for b in sp.comm.buckets]}, f)


def _w4_port(rank: int, world: int, store: str, out_dir: str) -> None:
    from repro_torch.core.collectives import as_axes
    from repro_torch.core.collectives.p2p import axis_size
    torch.set_num_threads(1)
    init_group(torch.device("cpu"), world_size=world, rank=rank,
               store_path=store)
    start = dict(np.load(os.path.join(out_dir, "start.npz")))
    from test_torch_strategy import _unflat
    tree = _unflat(start)
    res = {}
    sess = TrainSession(SessionConfig(device="cpu", steps=W4_STEPS,
                                      **{k: v for k, v in SESSION.items()
                                         if k != "steps"}),
                        params=params_from_jax(tree, CFG, device="cpu"))
    sp = sess.plan_auto(topology=TIERED, t_backward_s=W4_T_BWD,
                        scheduler=get_scheduler("every_step"),
                        candidates=_no_tree(DEFAULT_CANDIDATES))
    ex = sess.strategy.grad_reducer
    res["tiered"] = [sess.tiered_mesh, [axis_size(a) for a in sess.axes],
                     ex.axes == sess.axes]
    res["decision"] = plan_decision(sp)
    res["digest"] = sess.planned["digest"]
    out = {}
    for s in range(W4_STEPS):
        sess.step_once()
        for k, v in _flatten_with_paths(to_numpy(sess.params)).items():
            if _w4_kept(k):
                out[f"{s}/{k}"] = v.copy()
    out["losses"] = np.asarray(sess.losses)
    np.savez(os.path.join(out_dir, f"port-{rank}.npz"), **out)

    # the backward measured on every rank: one plan all the same
    measured = TrainSession(SessionConfig(device="cpu", **SESSION),
                            params=params_from_jax(tree, CFG, device="cpu"))
    own = []
    profile = measured.profile_backward
    measured.profile_backward = lambda: own.append(profile()) or own[-1]
    measured.plan_auto(topology=TIERED, scheduler=get_scheduler("lag",
                                                                threshold=0.5))
    res["measured_t"] = measured.planned["t_backward_s"]
    res["measured_own_t"] = own
    res["measured_digest"] = measured.planned["digest"]

    # --sync comm --topology: the reducer runs on the tier groups
    args = train.build_parser().parse_args(
        ["--device", "cpu", "--reduced", "--steps", "1", "--batch", "4",
         "--seq", "16", "--sync", "comm", "--algo", "hierarchical",
         "--topology", TIERED])
    cli = train.run(args, rank)
    red = cli.strategy.grad_reducer
    res["cli"] = [cli.tiered_mesh, as_axes(red.axes) == cli.axes,
                  len(cli.axes), bool(np.isfinite(cli.losses).all())]
    with open(os.path.join(out_dir, f"port-{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def w4_runs(tmp_path_factory):
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import Model as JModel
    from repro_torch.launch.dist import spawn
    out = tmp_path_factory.mktemp("plan_auto_w4")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, __file__, "--reference",
                            str(out)], env=env, cwd=ROOT / "tests",
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    try:
        # the reference session's parameters (its seed 0), for the port
        start = JModel(jreduced(jget_config("gemma-2b"))).init(
            jax.random.PRNGKey(0))
        np.savez(out / "start.npz", **_flatten_with_paths(
            jax.tree.map(np.asarray, start)))
        spawn(_w4_port, W4, args=(str(out),), timeout=240)
        log, _ = ref.communicate(timeout=300)
    finally:
        ref.kill()
    assert ref.returncode == 0, log[-4000:]
    want = dict(np.load(out / "reference.npz"))
    want_plan = json.loads((out / "reference.json").read_text())
    got = [dict(np.load(out / f"port-{r}.npz")) for r in range(W4)]
    got_res = [json.loads((out / f"port-{r}.json").read_text())
               for r in range(W4)]
    return want, want_plan, got, got_res


def test_world4_every_rank_plans_the_reference_plan(w4_runs):
    _, want_plan, _, res = w4_runs
    for r in range(W4):
        d = res[r]["decision"]
        assert d["key"] == want_plan["key"] == "every_step"
        assert [b[:6] for b in d["buckets"]] == want_plan["buckets"], r
        assert res[r]["digest"] == res[0]["digest"]
        # the tiered mesh: a group per tier, innermost (device:2) first
        assert res[r]["tiered"] == [True, [2, 2], True]
    algos = {(b[1], b[2]) for b in want_plan["buckets"]}
    assert ("hierarchical", "none") in algos and ("ring", "topk") in algos


def test_world4_planned_steps_match_reference(w4_runs):
    want, _, got, _ = w4_runs
    for r in range(W4):
        np.testing.assert_allclose(got[r]["losses"], want["losses"],
                                   rtol=1e-4)
    keys = sorted(k[2:] for k in got[0] if k.startswith("0/"))
    assert keys and any("embed" in k for k in keys)
    lr = [SESSION["lr"] * min(1.0, s / SESSION["warmup"])
          for s in range(W4_STEPS)]
    envelope = 2 * 3.2 * sum(lr)
    for s in range(W4_STEPS):
        for k in keys:
            rows = [got[r][f"{s}/{k}"] for r in range(W4)]
            # every step syncs: the ranks hold one model, bit for bit
            assert all(np.array_equal(rows[r], rows[0]) for r in range(W4))
            _assert_close_after_steps(rows[0], want[f"{s}/{k}"], 2e-2,
                                      envelope)


def test_world4_measured_backward_gives_one_plan(w4_runs):
    _, _, _, res = w4_runs
    ts = [r["measured_t"] for r in res]
    own = [r["measured_own_t"] for r in res]
    assert all(len(o) == 1 for o in own)
    # every rank planned from the group's minimum of their own measurements
    assert ts == [min(o[0] for o in own)] * W4 and ts[0] > 0
    assert len({r["measured_digest"] for r in res}) == 1


def test_world4_sync_comm_topology_runs_on_tier_groups(w4_runs):
    _, _, _, res = w4_runs
    for r in range(W4):
        assert res[r]["cli"] == [True, True, 2, True], r


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _w4_reference(sys.argv[2])
    print(json.dumps({"ok": True}))
