"""The port's training slice against the JAX package: reduced gemma-2b in
f32 on the CPU, from the same parameters and the same data.

  * the data pipeline copy yields the original's batches;
  * the FlashAttention-2 ``torch.autograd.Function`` gives the reference's
    custom-VJP gradients (causal, sliding window, softcap, bidirectional);
  * the loss and every gradient of step 1 match at rtol 1e-5 (against each
    leaf's largest |g|: summation order differs between the frameworks);
  * Adam and SGD and the warmup-cosine schedule match the reference's;
  * ``TrainSession`` runs 3 steps like the reference's for ``vanilla``,
    ``int8_fused`` and ``topk_fused``: losses at rtol 1e-4, and parameters
    and EF residuals as ``_assert_close_after_steps`` states; the
    one-config step factory takes the session's step exactly;
  * LAMB and LARS match the reference over 3 in-place steps like Adam;
  * the CLI drives the path on the CPU without launching a kernel, runs
    every compressor, algorithm and optimizer, and refuses the planner
    (``--sync auto``) with its ROADMAP item.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import SessionConfig as JSessionConfig
from repro.api import TrainSession as JTrainSession
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import SyncConfig as JSyncConfig
from repro.core import make_strategy as jmake_strategy
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticPipeline as JPipeline
from repro.models import Model as JModel
from repro.models import attention as jattn
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch._tree import tree_leaves
from repro_torch.api import SessionConfig, TrainSession
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax, to_numpy
from repro_torch.core import SyncConfig, make_strategy
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.launch import train
from repro_torch.launch.steps import (loss_and_grads,
                                     make_comm_optimized_train_step)
from repro_torch.models import Model
from repro_torch.models import attention as tattn
from repro_torch.optim import make_optimizer, step_inplace, warmup_cosine

ROOT = Path(__file__).resolve().parents[1]
CFG = reduced(get_config("gemma-2b"))
SESSION = dict(arch="gemma-2b", reduced=True, steps=3, batch=4, seq=32,
               lr=3e-3, warmup=2)


@pytest.fixture(scope="module")
def jax_params():
    """The reference's reduced gemma-2b parameters as numpy (f32)."""
    return jax.tree.map(np.asarray,
                        JModel(jreduced(jget_config("gemma-2b"))).init(
                            jax.random.PRNGKey(0)))


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("structured", [True, False])
def test_pipeline_copy_matches_original(structured):
    for seed in (0, 3):
        kw = dict(vocab_size=1000, seq_len=24, global_batch=4, seed=seed,
                  structured=structured)
        a, b = SyntheticPipeline(DataConfig(**kw)), JPipeline(JDataConfig(**kw))
        for step in (0, 1, 7):
            np.testing.assert_array_equal(a.batch(step)["tokens"],
                                          b.batch(step)["tokens"])
            np.testing.assert_array_equal(
                a.batch(step, host_id=1, num_hosts=2)["tokens"],
                b.batch(step, host_id=1, num_hosts=2)["tokens"])


# ---------------------------------------------------------------------------
# Attention gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs", [dict(), dict(window=20),
                                    dict(softcap=5.0),
                                    dict(window=20, softcap=5.0),
                                    dict(causal=False)],
                         ids=["causal", "window", "softcap", "window-softcap",
                              "bidirectional"])
def test_flash_attention_grads_match_jax(kwargs):
    rng = np.random.default_rng(11)
    B, T, H, KV, hd = 2, 48, 4, 2, 16
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    do = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    chunks = dict(q_chunk=16, kv_chunk=16)

    out, vjp = jax.vjp(lambda a, b, c: jattn.flash_attention(
        a, b, c, **kwargs, **chunks), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))

    tq, tk, tv = (torch.from_numpy(a.copy()).requires_grad_(True)
                  for a in (q, k, v))
    tout = tattn.flash_attention(tq, tk, tv, **kwargs, **chunks)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-5)
    for name, a, b in zip("qkv", tgrads, jgrads):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max(), name


# ---------------------------------------------------------------------------
# Step 1: loss and gradients
# ---------------------------------------------------------------------------

def test_step1_loss_and_grads_match_jax(jax_params):
    jmodel = JModel(jreduced(jget_config("gemma-2b")))
    tokens = np.random.default_rng(0).integers(
        0, CFG.vocab_size, (2, 64)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(jmodel.loss)(
        jax_params, {"tokens": jnp.asarray(tokens)})
    params = params_from_jax(jax_params, CFG, device="cpu")
    loss, grads = loss_and_grads(Model(CFG), params,
                                 {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jleaves = jax.tree.leaves(jgrads)
    tleaves = tree_leaves(grads)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()


# ---------------------------------------------------------------------------
# Optimizers and schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("adam", dict(lr=1e-2)), ("adam", dict(lr=1e-2, weight_decay=0.1)),
    ("sgd", dict(lr=0.1)), ("sgd", dict(lr=0.1, momentum=0.9)),
    ("sgd", dict(lr=0.1, momentum=0.9, nesterov=True, weight_decay=0.01)),
    ("lamb", dict(lr=1e-2)), ("lars", dict(lr=0.5))],
    ids=["adam", "adamw", "sgd", "momentum", "nesterov-wd", "lamb", "lars"])
def test_optimizer_matches_jax(name, kw):
    rng = np.random.default_rng(5)
    shapes = {"a": (7, 5), "b": (11,)}
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    jopt, topt = jmake_optimizer(name, **kw), make_optimizer(name, **kw)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for step in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                  jstate, jp, jnp.asarray(step))
        jp = jax.tree.map(lambda a, u: a + u, jp, upd)
        step_inplace(topt, tp, {k: torch.from_numpy(v) for k, v in g.items()},
                     tstate, step)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)


def test_warmup_cosine_matches_jax():
    a, b = warmup_cosine(3e-3, 20, 100), jwarmup_cosine(3e-3, 20, 100)
    for step in (0, 1, 10, 19, 20, 21, 50, 99, 100, 150):
        np.testing.assert_allclose(a(step), float(b(step)), rtol=1e-6)
    assert a(0) == 0.0


def test_unported_optimizers_name_the_roadmap():
    # ported now: lamb and lars construct and take a step in place
    p = {"a": torch.ones(4, 3), "b": torch.full((5,), 2.0)}
    g = {"a": torch.full((4, 3), 0.5), "b": torch.full((5,), -1.0)}
    for name in ("lamb", "lars"):
        opt = make_optimizer(name)
        state = opt.init(p)
        before = {k: v.clone() for k, v in p.items()}
        step_inplace(opt, p, g, state, 0)
        for k in p:
            assert torch.isfinite(p[k]).all()
            assert not torch.equal(p[k], before[k]), (name, k)


# ---------------------------------------------------------------------------
# Sessions: 3 steps against the reference's
# ---------------------------------------------------------------------------

def _lr_sum(steps: int) -> float:
    sched = warmup_cosine(SESSION["lr"], SESSION["warmup"], SESSION["steps"])
    return sum(sched(s) for s in range(steps))


def _assert_close_after_steps(got, want, frac: float, envelope: float):
    """After a few steps most entries agree to 1e-6; at most ``frac`` of
    them differ by more, and none by more than ``envelope``.  Why entries
    can move apart at all: Adam divides each update by sqrt(v), so an entry
    whose gradient is tiny, or whose int8 code flipped (one flip moves a
    synced entry by s/127, and the EF residual carries the flip on), can
    take a different step of up to about the learning rate.  The envelope
    is that bound: the two runs' Adam displacements, each at most
    (1-b1)/sqrt(1-b2) = 3.2 times the learning rate per step."""
    d = np.abs(got - want)
    assert d.max() <= envelope, d.max()
    assert (d > 1e-6).mean() <= frac, (d > 1e-6).mean()


@pytest.mark.parametrize("mode", ["vanilla", "int8_fused", "topk_fused"])
def test_session_matches_jax_over_three_steps(jax_params, mode):
    jstrategy = strategy = None
    if mode != "vanilla":
        jstrategy = jmake_strategy("every_step", axes=("data",),
                                   sync=JSyncConfig(compressor=mode))
        strategy = make_strategy("every_step",
                                 sync=SyncConfig(compressor=mode))
    jsess = JTrainSession(JSessionConfig(**SESSION), strategy=jstrategy)
    start = jax.tree.map(np.asarray, jsess._params)
    jlosses = jsess.run(3)
    sess = TrainSession(SessionConfig(device="cpu", **SESSION),
                        strategy=strategy,
                        params=params_from_jax(start, CFG, device="cpu"))
    losses = sess.run(3)
    assert sess.device.type == "cpu" and sess.world == 1
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)

    envelope = 2 * 3.2 * _lr_sum(3)
    frac = 2e-2 if mode == "int8_fused" else 1e-3
    for a, b in zip(tree_leaves(to_numpy(sess.params)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jsess.params))):
        assert a.shape == b.shape
        _assert_close_after_steps(a, b, frac, envelope)
    if mode == "vanilla":
        return
    jerr = [np.asarray(e) for e in jsess.sync_state["error"]]
    terr = [e.numpy() for e in sess.sync_state["error"]]
    assert len(terr) == len(jerr) == sess.synchronizer.plan.n_buckets
    for a, b in zip(terr, jerr):
        # a flipped code moves the residual by s/127, twice its |e| bound
        _assert_close_after_steps(a, b, frac, 2.5 * np.abs(b).max())


def test_comm_optimized_step_equals_session_step(jax_params):
    # the legacy one-config step factory runs the session's synced step
    sync = SyncConfig(compressor="int8_fused")
    sess = TrainSession(SessionConfig(device="cpu", **SESSION),
                        strategy=make_strategy("every_step", sync=sync),
                        params=params_from_jax(jax_params, CFG, device="cpu"))
    loss = sess.step_once()
    step_fn, synchronizer, init_sync_state = make_comm_optimized_train_step(
        Model(CFG), make_optimizer("adam", lr=warmup_cosine(
            SESSION["lr"], SESSION["warmup"], SESSION["steps"])), sync)
    params = params_from_jax(jax_params, CFG, device="cpu")
    opt_state = make_optimizer("adam").init(params)
    params, _, state, loss2 = step_fn(params, opt_state,
                                      init_sync_state(params),
                                      sess.batch(0), 0)
    assert float(loss2) == loss and state["step"] == 1
    for a, b in zip(tree_leaves(params), tree_leaves(sess.params)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def _cli_cpu_drive(flags):
    """Two CPU steps of ``launch.train`` with ``flags``, in a fresh process:
    (stdout lines, the JSON of launch counts, device and losses)."""
    code = (
        "import json\n"
        "from repro_torch.kernels import ops\n"
        "from repro_torch.launch import train\n"
        "s = train.main(['--device', 'cpu', '--arch', 'gemma-2b', "
        "'--reduced', '--steps', '2', '--batch', '2', '--seq', '32', "
        f"'--sync', 'comm', {', '.join(map(repr, flags))}])\n"
        "print(json.dumps({'counts': ops.launch_counts(), "
        "'routes': ops.route_counts(), "
        "'device': s.device.type, 'losses': s.losses}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    return lines, json.loads(lines[-1])


def _assert_no_launch(lines, res):
    assert any(line.startswith("final loss ") for line in lines)
    assert sum(line.startswith("step ") for line in lines) == 2
    assert res["device"] == "cpu" and len(res["losses"]) == 2
    assert np.isfinite(res["losses"]).all()
    assert set(res["counts"]) == {"flash_attention", "nonfinite_tiles",
                                  "quantize_tiles", "quantize_ef",
                                  "dequant_accum", "topk_ef", "topk_mask"}
    assert all(n == 0 for n in res["counts"].values())
    assert all(n == 0 for routes in res["routes"].values()
               for n in routes.values())


def test_cli_cpu_drive_launches_no_kernel():
    _assert_no_launch(*_cli_cpu_drive(["--compressor", "int8_fused"]))


@pytest.mark.parametrize("compressor", ["int8_fused", "topk_fused"])
def test_cli_cpu_drive_without_error_feedback_launches_no_kernel(compressor):
    # the no-EF encode (compress) goes through ops.quantize_tiles /
    # ops.topk_mask, which run their plain versions on the CPU
    _assert_no_launch(*_cli_cpu_drive(["--compressor", compressor,
                                       "--no-error-feedback"]))


@pytest.mark.parametrize("flags", [
    ["--compressor", "int8", "--sync", "comm"],
    ["--compressor", "int8_fused", "--sync", "comm", "--algo", "ring"],
    ["--optimizer", "lamb"],
    ["--sync", "auto"]], ids=["int8", "ring", "lamb", "auto"])
def test_cli_refuses_unported_values(flags, capsys, tmp_path, monkeypatch):
    # int8, ring, lamb and the planner (--sync auto) are ported now: one
    # CPU step with a finite loss and the reference's final line (auto
    # writes its plan record under tmp_path)
    import repro_torch.launch.paths as paths
    monkeypatch.setattr(paths, "COMM_PLANS", str(tmp_path))
    base = ["--device", "cpu", "--reduced", "--steps", "1", "--batch", "2",
            "--seq", "16"]
    session = train.main(base + flags)
    assert len(session.losses) == 1 and np.isfinite(session.losses[0])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("final loss ")
    if "auto" in flags:
        assert any(line.startswith("### Sync strategy") for line in lines)
        assert session.planned["strategy_plan"].key == "every_step"
        assert (tmp_path / "gemma-2b.json").exists()
