"""The port's rounds axis (``repro_torch.core.{local_sgd,lag,strategy}``,
the session's phase steps and the CLI flags) against the JAX package's.

  * The schedulers: registry, the ``RoundAction`` sequence over 20 steps
    for a sweep of periods, warmups, cadences, thresholds and probes
    (LAG's first round, post-local warmup), ``commit``, ``backpressure``
    and ``describe`` — all equal to the reference's; ``make_strategy``
    routes reducers as the reference does.
  * Sessions on reduced gemma-2b in f32 from the reference's parameters:
    local SGD τ = 3 for 7 steps with dense and int8_fused rounds, LAG
    θ = 0.5 on a fixed batch, push/pull 2/2 with top-k pushes.  Round
    counts equal; losses at rtol 1e-4; parameters as
    ``_assert_close_after_steps`` states (``tests/test_torch_training.py``).
  * The parameter round: dense is the exact average, the dtype is kept,
    a compressed round tracks the parameters.
  * World 4: local SGD τ = 2 (dense and int8_fused rounds) on a world-4
    gloo group (4 spawned processes) against the reference's session on
    4 fake devices (this file run as a script): after every step each
    rank's parameters match worker r's; before a round the ranks differ,
    after it they are bit-equal.
  * The CLI: every new flag drives on the CPU without a kernel launch,
    two schedulers exit, ``--data-parallel 2`` runs on gloo and is refused
    on CUDA without a card per rank.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    # the reference's world of 4: fake host devices, set before jax starts
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_training import _assert_close_after_steps

from repro.api import SessionConfig as JSessionConfig
from repro.api import TrainSession as JTrainSession
from repro.core import GradientSynchronizer as JGradientSynchronizer
from repro.core import SyncConfig as JSyncConfig
from repro.core import SyncStrategy as JSyncStrategy
from repro.core import get_scheduler as jget_scheduler
from repro.core import make_strategy as jmake_strategy
from repro_torch._tree import tree_leaves
from repro_torch.api import SessionConfig, TrainSession
from repro_torch.checkpoint.checkpoint import _flatten_with_paths
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax, to_numpy
from repro_torch.core import (SCHEDULERS, AsymmetricPushPullConfig,
                              GradientSynchronizer, LAGConfig,
                              LocalSGDConfig, PlanExecutor, SyncConfig,
                              SyncStrategy, communication_rounds,
                              get_scheduler, make_strategy, plan_from_config)
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.launch.dist import init_group
from repro_torch.launch.steps import make_param_round_step
from repro_torch.optim import warmup_cosine

ROOT = Path(__file__).resolve().parents[1]
CFG = reduced(get_config("gemma-2b"))
SESSION = dict(arch="gemma-2b", reduced=True, batch=4, seq=32, lr=3e-3,
               warmup=2)
W4 = 4
W4_STEPS = 4
W4_SESSION = dict(SESSION, steps=W4_STEPS)
# the leaves the world-4 run compares (all but the FFN matrices, to keep
# the exchanged files small): embedding, attention and norms
W4_LEAVES = ("embed", "mixer", "norm")


@pytest.fixture(scope="module", autouse=True)
def world1():
    init_group(torch.device("cpu"))


# ---------------------------------------------------------------------------
# Schedulers
# ---------------------------------------------------------------------------

def test_registry_matches_reference():
    from repro.core import SCHEDULERS as JSCHEDULERS
    assert set(SCHEDULERS) == set(JSCHEDULERS)
    with pytest.raises(KeyError):
        get_scheduler("nope")
    for name, cls in SCHEDULERS.items():
        jcls = JSCHEDULERS[name]
        for attr in ("computes", "has_param_rounds", "needs_grad_probe",
                     "diverges_params", "supports_backpressure"):
            assert getattr(cls, attr) == getattr(jcls, attr), (name, attr)


SWEEP = [("every_step", {}),
         ("local_sgd", dict(period=1)), ("local_sgd", dict(period=3)),
         ("local_sgd", dict(period=4, post_local_after=3)),
         ("local_sgd", dict(period=5, post_local_after=7)),
         ("push_pull", dict(n_push=1, n_fetch=1)),
         ("push_pull", dict(n_push=2, n_fetch=3)),
         ("push_pull", dict(n_push=3, n_fetch=2)),
         ("lag", dict(threshold=0.1)), ("lag", dict(threshold=0.5)),
         ("lag", dict(threshold=5.0))]


def _probes(n: int):
    rng = np.random.default_rng(4)
    return [{"delta": float(d), "scale": 1.0}
            for d in rng.uniform(0.0, 1.2, n)]


def _simulate(sched, steps, probes, template, synced):
    state = sched.init_state(template)
    out = []
    for t in range(steps):
        a, state = sched.round(t, state, probes[t])
        state = sched.commit(state, a, synced)
        out.append((a.compute, a.param_round,
                    int(state["rounds"]) if "rounds" in state else None))
    return out


@pytest.mark.parametrize("name,kw", SWEEP,
                         ids=[f"{n}-{'-'.join(map(str, k.values()))}"
                              for n, k in SWEEP])
def test_round_actions_match_reference(name, kw):
    probes = _probes(20)
    got = _simulate(get_scheduler(name, **kw), 20, probes,
                    {"w": torch.zeros(3)}, {"w": torch.ones(3)})
    want = _simulate(jget_scheduler(name, **kw), 20, probes,
                     {"w": jnp.zeros(3)}, {"w": jnp.ones(3)})
    assert got == want
    sched, jsched = get_scheduler(name, **kw), jget_scheduler(name, **kw)
    assert sched.describe() == jsched.describe()
    for factor in (2.0, 1.5, 0.5):
        assert sched.backpressure(factor) == jsched.backpressure(factor)
        assert sched.describe() == jsched.describe()


def test_schedule_configs_match_reference():
    from repro.core import AsymmetricPushPullConfig as JPP
    from repro.core import LocalSGDConfig as JL
    from repro.core import communication_rounds as jrounds
    for period, warm in ((1, 0), (3, 0), (4, 3), (5, 9)):
        assert communication_rounds(20, LocalSGDConfig(period, warm)) == \
            jrounds(20, JL(period, warm))
    for n_push, n_fetch in ((1, 1), (2, 3), (4, 2)):
        assert AsymmetricPushPullConfig(n_push, n_fetch).rounds(20) == \
            JPP(n_push, n_fetch).rounds(20)
    with pytest.raises(ValueError):
        AsymmetricPushPullConfig(0, 1)
    with pytest.raises(ValueError):
        get_scheduler("local_sgd", period=0)


def test_lag_refuses_check_every_and_a_missing_probe():
    with pytest.raises(ValueError):
        get_scheduler("lag", cfg=LAGConfig(threshold=0.1, check_every=10))
    sched = get_scheduler("lag", threshold=0.5)
    with pytest.raises(ValueError):
        sched.round(0, sched.init_state({"w": torch.zeros(2)}), None)
    # the first round syncs whatever the threshold says
    sched = get_scheduler("lag", threshold=5.0)
    acts = _simulate(sched, 3, [{"delta": 1.0, "scale": 1.0}] * 3,
                     {"w": torch.zeros(2)}, {"w": torch.full((2,), 3.0)})
    assert [a[0] for a in acts] == ["sync", "reuse", "reuse"]


def test_lag_commit_updates_g_last_and_rounds():
    sched = get_scheduler("lag", threshold=0.5)
    state = sched.init_state({"w": torch.zeros(2, dtype=torch.bfloat16)})
    a, state = sched.round(0, state, {"delta": 1.0, "scale": 1.0})
    state = sched.commit(state, a, {"w": torch.full((2,), 3.0,
                                                    dtype=torch.bfloat16)})
    assert state["rounds"] == 1
    assert state["g_last"]["w"].dtype == torch.float32
    assert torch.equal(state["g_last"]["w"], torch.full((2,), 3.0))


def test_make_strategy_routes_reducers_as_reference():
    kw = dict(compressor="int8", algo="ring")
    for name, skw in (("every_step", {}), ("local_sgd", dict(period=4)),
                      ("push_pull", dict(n_push=2, n_fetch=3)),
                      ("lag", dict(threshold=0.5))):
        st = make_strategy(name, sync=SyncConfig(**kw), **skw)
        jst = jmake_strategy(name, axes=("data",), sync=JSyncConfig(**kw),
                             **skw)
        for attr in ("grad_reducer", "param_reducer"):
            got, want = getattr(st, attr), getattr(jst, attr)
            assert (got is None) == (want is None), (name, attr)
            if got is not None:
                assert isinstance(got, GradientSynchronizer)
                assert isinstance(want, JGradientSynchronizer)
        assert st.describe() == jst.describe()
    # a param plan feeds the round even for a scheduler that syncs grads
    plan = plan_from_config(SyncConfig(compressor="int8_fused"),
                            {"w": torch.zeros(8)})
    st = make_strategy("push_pull", sync=SyncConfig(**kw), param_plan=plan)
    assert isinstance(st.param_reducer, PlanExecutor)
    assert isinstance(st.grad_reducer, GradientSynchronizer)
    assert SyncStrategy(get_scheduler("local_sgd")).describe() == \
        JSyncStrategy(jget_scheduler("local_sgd")).describe()
    with pytest.raises(ValueError):
        make_strategy(sync=SyncConfig(), plan=plan)
    # a pipeline strategy, described as the reference's
    st = make_strategy("every_step", sync=SyncConfig(**kw),
                       parallelism="pp=2")
    jst = jmake_strategy("every_step", axes=("data",),
                         sync=JSyncConfig(**kw), parallelism="pp=2")
    assert st.pipeline_stages == jst.pipeline_stages == 2
    assert st.describe() == jst.describe()
    # sharded state is a strategy of its own, described as the reference's
    st = make_strategy("every_step", sync=SyncConfig(**kw),
                       parallelism="shard")
    jst = jmake_strategy("every_step", axes=("data",),
                         sync=JSyncConfig(**kw), parallelism="shard")
    assert st.shard_state and st.describe() == jst.describe()


# ---------------------------------------------------------------------------
# Sessions against the reference
# ---------------------------------------------------------------------------

def _sessions(jstrategy, strategy, steps, fixed_batch=False):
    jsess = JTrainSession(JSessionConfig(steps=steps, **SESSION),
                          strategy=jstrategy)
    start = jax.tree.map(np.asarray, jsess._params)
    sess = TrainSession(SessionConfig(device="cpu", steps=steps, **SESSION),
                        strategy=strategy,
                        params=params_from_jax(start, CFG, device="cpu"))
    if fixed_batch:                     # LAG's full-batch regime
        jorig, orig = jsess.data.batch, sess.data.batch
        jsess.data.batch = lambda step, **kw: jorig(0)
        sess.data.batch = lambda step, **kw: orig(0)
    jlosses, losses = jsess.run(steps), sess.run(steps)
    for attr in ("grad_rounds", "param_rounds", "control_rounds",
                 "comm_rounds", "step"):
        assert getattr(sess, attr) == getattr(jsess, attr), attr
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    return jsess, sess


def _envelope(steps: int) -> float:
    """Two runs' Adam displacements over ``steps`` steps
    (``_assert_close_after_steps``)."""
    return 2 * 3.2 * sum(_lr_at(s, steps) for s in range(steps))


def _assert_params_close(got, want, steps, frac):
    envelope = _envelope(steps)
    for a, b in zip(tree_leaves(to_numpy(got)),
                    jax.tree.leaves(jax.tree.map(np.asarray, want)),
                    strict=True):
        assert a.shape == b.shape
        _assert_close_after_steps(a, b, frac, envelope)


def _lr_at(step, horizon):
    return warmup_cosine(SESSION["lr"], SESSION["warmup"], horizon)(step)


@pytest.mark.parametrize("compressor", [None, "int8_fused"],
                         ids=["dense", "int8_fused"])
def test_local_sgd_session_matches_reference(compressor):
    skw = dict(period=3)
    jsync = JSyncConfig(compressor=compressor) if compressor else None
    sync = SyncConfig(compressor=compressor) if compressor else None
    jsess, sess = _sessions(
        jmake_strategy("local_sgd", axes=("data",), sync=jsync, **skw),
        make_strategy("local_sgd", sync=sync, **skw), 7)
    assert sess.grad_rounds == 0 and sess.param_rounds == 2
    assert sess.summary() == jsess.summary()
    _assert_params_close(sess.params, jsess.params, 7,
                         2e-2 if compressor else 1e-2)
    if compressor:
        # the f32 anchor: what the last round left in every worker
        assert all(a.dtype == torch.float32
                   for a in tree_leaves(sess._anchor))
        _assert_params_close(sess._anchor, jsess._anchor, 7, 2e-2)
    else:
        assert sess._anchor is None and jsess._anchor is None


def test_lag_session_matches_reference():
    jsess, sess = _sessions(
        JSyncStrategy(scheduler=jget_scheduler("lag", threshold=0.5)),
        SyncStrategy(scheduler=get_scheduler("lag", threshold=0.5)), 8,
        fixed_batch=True)
    assert 1 <= sess.grad_rounds < 8 and sess.control_rounds == 8
    assert sess._sched_state["rounds"] == sess.grad_rounds
    assert sess.summary() == jsess.summary()
    _assert_params_close(sess.params, jsess.params, 8, 1e-2)
    for a, b in zip(tree_leaves(sess._sched_state["g_last"]),
                    jax.tree.leaves(jsess._sched_state["g_last"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4 * np.abs(np.asarray(b)).max())


def test_push_pull_session_matches_reference():
    ratio = (("ratio", 0.25),)
    jsess, sess = _sessions(
        jmake_strategy("push_pull", n_push=2, n_fetch=2, axes=("data",),
                       sync=JSyncConfig(compressor="topk",
                                        compressor_args=ratio)),
        make_strategy("push_pull", n_push=2, n_fetch=2,
                      sync=SyncConfig(compressor="topk",
                                      compressor_args=ratio)), 5)
    assert sess.grad_rounds == 2 and sess.param_rounds == 2
    assert sess.summary() == jsess.summary()
    _assert_params_close(sess.params, jsess.params, 5, 1e-2)
    errs = [e for e in sess.sync_state["error"] if e is not None]
    jerrs = [e for e in jsess.sync_state["error"] if e is not None]
    assert len(errs) == len(jerrs) > 0
    for a, b in zip(errs, jerrs):
        b = np.asarray(b)
        _assert_close_after_steps(a.numpy(), b, 1e-3, 2.5 * np.abs(b).max())


# ---------------------------------------------------------------------------
# The parameter round
# ---------------------------------------------------------------------------

def _toy_params(dtype=torch.float32):
    rng = np.random.default_rng(3)
    return {"w": torch.from_numpy(rng.standard_normal((16, 8)).astype(
                np.float32)).to(dtype),
            "b": torch.from_numpy(rng.standard_normal(5).astype(
                np.float32)).to(dtype)}


def _run_param_round(sync_cfg, dtype=torch.float32):
    params = _toy_params(dtype)
    reducer = PlanExecutor(plan_from_config(sync_cfg, params))
    round_fn = make_param_round_step(reducer)
    anchor = {k: p.to(torch.float32) for k, p in params.items()}
    moved = {k: p + 0.01 * torch.sign(p) for k, p in params.items()}
    out = {k: v.clone() for k, v in moved.items()}
    out, new_anchor, _ = round_fn(out, anchor, reducer.init_state(params),
                                  None)
    return moved, out, new_anchor


def test_param_round_dense_is_exact_average():
    moved, out, new_anchor = _run_param_round(SyncConfig(compressor="none"))
    for k in moved:
        np.testing.assert_allclose(out[k].numpy(), moved[k].numpy(),
                                   rtol=1e-6)
        assert torch.equal(new_anchor[k], out[k])
    # without a reducer the round is the model average itself
    params = _toy_params()
    before = {k: v.clone() for k, v in params.items()}
    avg, anchor, _ = make_param_round_step(None)(params, None, None)
    assert anchor is None
    for k in params:
        assert torch.equal(avg[k], before[k])     # world 1: the mean is p


def test_param_round_preserves_param_dtype():
    _, out, new_anchor = _run_param_round(
        SyncConfig(compressor="int8", bucket_bytes=0), torch.bfloat16)
    for k in out:
        assert out[k].dtype == torch.bfloat16, (k, out[k].dtype)
        assert new_anchor[k].dtype == torch.float32
        assert torch.equal(new_anchor[k], out[k].to(torch.float32))


@pytest.mark.parametrize("compressor", ["int8", "int8_fused"])
def test_param_round_compressed_tracks_params(compressor):
    moved, out, _ = _run_param_round(SyncConfig(compressor=compressor,
                                                bucket_bytes=0))
    for k in moved:
        err = (out[k] - moved[k]).abs().max().item()
        assert err < 2e-3, (k, err)   # delta scale 0.01, int8 grid ≈ 1e-4


# ---------------------------------------------------------------------------
# World 4: local SGD on a gloo group against 4 fake devices
# ---------------------------------------------------------------------------

def _w4_kept(key: str) -> bool:
    return any(part in key for part in W4_LEAVES)


def _w4_strategies(jax_side: bool):
    if jax_side:
        return {"dense": jmake_strategy("local_sgd", period=2,
                                        axes=("data",)),
                "int8_fused": jmake_strategy(
                    "local_sgd", period=2, axes=("data",),
                    sync=JSyncConfig(compressor="int8_fused"))}
    return {"dense": make_strategy("local_sgd", period=2),
            "int8_fused": make_strategy(
                "local_sgd", period=2,
                sync=SyncConfig(compressor="int8_fused"))}


def _w4_reference(out_dir: str) -> None:
    """The reference's sessions on 4 fake devices: every worker's kept
    leaves after every step, the losses and the start parameters."""
    out = {}
    for name in ("dense", "int8_fused"):
        sess = JTrainSession(JSessionConfig(data_parallel=W4, **W4_SESSION),
                             strategy=_w4_strategies(True)[name])
        for k, v in _flatten_with_paths(jax.tree.map(np.array,
                                                     sess._params)).items():
            out[f"start/{k}"] = v
        for s in range(W4_STEPS):
            sess.step_once()
            for k, v in _flatten_with_paths(jax.tree.map(
                    np.array, sess._params)).items():
                if _w4_kept(k):
                    out[f"{name}/{s}/{k}"] = v      # (workers, ...)
        out[f"{name}/losses"] = np.asarray(sess.losses)
        out[f"{name}/rounds"] = np.asarray([sess.grad_rounds,
                                            sess.param_rounds])
    np.savez(os.path.join(out_dir, "reference.npz"), **out)


def _w4_port(rank: int, world: int, store: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    init_group(torch.device("cpu"), world_size=world, rank=rank,
               store_path=store)
    ref = np.load(os.path.join(out_dir, "reference.npz"))
    start = {k[len("start/"):]: ref[k] for k in ref.files
             if k.startswith("start/")}
    tree = _unflat(start)
    out = {}
    for name, strategy in _w4_strategies(False).items():
        sess = TrainSession(SessionConfig(device="cpu", **W4_SESSION),
                            strategy=strategy,
                            params=params_from_jax(tree, CFG, device="cpu"))
        for s in range(W4_STEPS):
            sess.step_once()
            for k, v in _flatten_with_paths(to_numpy(sess.params)).items():
                if _w4_kept(k):     # a copy: the step updates in place
                    out[f"{name}/{s}/{k}"] = v.copy()
        out[f"{name}/losses"] = np.asarray(sess.losses)
        out[f"{name}/rounds"] = np.asarray([sess.grad_rounds,
                                            sess.param_rounds])
    np.savez(os.path.join(out_dir, f"port-{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


def _unflat(flat):
    """The nested dict/list tree of ``/``-joined keys (list indices are
    digits)."""
    root: dict = {}
    for key, v in flat.items():
        node = root
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(n):
        if not isinstance(n, dict):
            return n
        if n and all(k.isdigit() for k in n):
            return [fix(n[str(i)]) for i in range(len(n))]
        return {k: fix(v) for k, v in n.items()}

    return fix(root)


@pytest.fixture(scope="module")
def w4_runs(tmp_path_factory):
    from repro_torch.launch.dist import spawn
    out = tmp_path_factory.mktemp("local_sgd_w4")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, __file__, "--reference", str(out)],
                         env=env, cwd=ROOT / "tests", capture_output=True,
                         text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-4000:]
    spawn(_w4_port, W4, args=(str(out),), timeout=240)
    want = dict(np.load(out / "reference.npz"))
    got = [dict(np.load(out / f"port-{r}.npz")) for r in range(W4)]
    return want, got


@pytest.mark.parametrize("name", ["dense", "int8_fused"])
def test_world4_local_sgd_matches_reference(w4_runs, name):
    want, got = w4_runs
    envelope = _envelope(W4_STEPS)
    for r in range(W4):
        np.testing.assert_array_equal(got[r][f"{name}/rounds"], [0, 2])
        np.testing.assert_array_equal(want[f"{name}/rounds"], [0, 2])
        np.testing.assert_allclose(got[r][f"{name}/losses"],
                                   want[f"{name}/losses"], rtol=1e-4)
    keys = sorted(k[len(name) + 3:] for k in got[0]
                  if k.startswith(f"{name}/0/"))
    assert keys and any("embed" in k for k in keys)
    for s in range(W4_STEPS):
        round_after = (s + 1) % 2 == 0
        for k in keys:
            rows = [got[r][f"{name}/{s}/{k}"] for r in range(W4)]
            for r in range(W4):
                _assert_close_after_steps(rows[r],
                                          want[f"{name}/{s}/{k}"][r],
                                          2e-2, envelope)
            same = all(np.array_equal(rows[r], rows[0]) for r in range(W4))
            if round_after:
                assert same, (name, s, k)   # a round makes ranks bit-equal
        if not round_after and _lr_at(s, W4_STEPS) > 0:
            # each rank trains on its own rows: the ranks differ (at step
            # 0 the warmup's learning rate is 0)
            assert not all(np.array_equal(got[r][f"{name}/{s}/{k}"],
                                          got[0][f"{name}/{s}/{k}"])
                           for r in range(W4) for k in keys), (name, s)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

BASE = ["--device", "cpu", "--arch", "gemma-2b", "--reduced", "--steps",
        "4", "--batch", "2", "--seq", "32"]


@pytest.mark.parametrize("flags,rounds", [
    (["--local-sgd", "2", "--sync", "comm", "--compressor", "int8_fused"],
     (0, 2, 0)),
    (["--local-sgd", "3", "--post-local", "2"], (0, 3, 0)),
    (["--lag", "4", "--sync", "comm", "--compressor", "int8_fused"],
     None),
    (["--push-pull", "2", "2", "--sync", "comm", "--compressor",
      "topk_fused"], (2, 2, 0)),
    (["--push-pull", "1", "3"], (4, 1, 0))],
    ids=["local-sgd-int8_fused", "post-local", "lag-int8_fused",
         "push-pull-topk_fused", "push-pull-vanilla"])
def test_cli_rounds_flags_drive_on_cpu_without_a_kernel(flags, rounds,
                                                        capsys):
    ops.reset_launch_counts()
    session = train.main(BASE + flags)
    counts = ops.launch_counts()
    assert all(n == 0 for n in counts.values()), counts
    assert session.device.type == "cpu" and len(session.losses) == 4
    assert np.isfinite(session.losses).all()
    got = (session.grad_rounds, session.param_rounds,
           session.control_rounds)
    if rounds is None:                  # LAG: the first round syncs
        assert got[1] == 0 and got[2] == 4 and 1 <= got[0] <= 4
    else:
        assert got == rounds
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("strategy: ")
    assert lines[-1].startswith("final loss ")
    assert session.summary() in lines[-1]


def test_cli_refuses_two_schedules_and_a_world_without_cards():
    with pytest.raises(SystemExit, match="pick one rounds schedule"):
        train.main(BASE + ["--lag", "0.5", "--local-sgd", "2"])
    with pytest.raises(SystemExit, match="pick one rounds schedule"):
        train.main(BASE + ["--local-sgd", "2", "--push-pull", "1", "1"])
    if torch.cuda.device_count() < 64:
        with pytest.raises(SystemExit, match="one card per rank"):
            train.main(BASE[2:] + ["--device", "cuda",
                                   "--data-parallel", "64"])


def test_cli_data_parallel_world_2_on_gloo():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *BASE,
         "--data-parallel", "2", "--local-sgd", "2", "--sync", "comm",
         "--compressor", "int8_fused", "--log-every", "1"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "data parallel: world 2 on cpu"
    # only rank 0 prints: one line per step
    assert sum(line.startswith("step ") for line in lines) == 4
    assert lines[-1].startswith("final loss ")
    assert "comm rounds 2 (grad 0, param 2)" in lines[-1]


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _w4_reference(sys.argv[2])
    print(json.dumps({"ok": True}))
