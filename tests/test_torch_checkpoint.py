"""The port's checkpoints (``repro_torch.checkpoint``) and the session's
``save_checkpoint`` / ``load_checkpoint`` against the JAX package's.

  * A round trip restores every leaf bit for bit, bf16 leaves included
    (stored as their 16-bit pattern, named in the manifest), and
    ``latest_step`` reads the step; both files are written through a
    temporary sibling, which is gone after the write.
  * A truncated or corrupted ``.npz`` is refused by the sha256 check
    before anything is deserialized.
  * Both packages read each other's f32 checkpoints: the reference's
    ``save`` into the port's ``restore`` / ``load_checkpoint``, and the
    port's into ``repro.checkpoint.restore`` / the reference's session.
  * A session resumed from a checkpoint (vanilla Adam; local SGD with
    dense rounds) trains bit-equal to the uninterrupted run; loading after
    the first step, or a checkpoint missing a leaf or an optimizer buffer,
    is refused with the reference's messages; the CLI's ``--checkpoint``
    writes one the session loads.
  * Sharded and pipeline sessions' checkpoints cross both ways: each
    package's restores in the other's sharded and replicated sessions bit
    for bit.
"""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.api import SessionConfig as JSessionConfig
from repro.api import TrainSession as JTrainSession
from repro_torch import checkpoint
from repro_torch._tree import tree_leaves
from repro_torch.checkpoint.checkpoint import _flatten_with_paths
from repro_torch.api import SessionConfig, TrainSession
from repro_torch.convert import to_numpy
from repro_torch.core import make_strategy
from repro_torch.launch import train
from repro_torch.launch.dist import init_group

SESSION = dict(arch="gemma-2b", reduced=True, steps=4, batch=2, seq=32,
               lr=3e-3, warmup=1, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def world1():
    init_group(torch.device("cpu"))


def _tree(dtype=torch.float32):
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)

    return {"a": t(3, 4), "nested": {"w": t(5), "list": [t(2, 2), t(7)]},
            "f32": torch.arange(6, dtype=torch.float32)}


def _same(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_round_trip_bit_for_bit(tmp_path, dtype):
    tree = _tree(dtype)
    path = str(tmp_path / "sub" / "ck")
    assert checkpoint.latest_step(path) is None
    checkpoint.save(path, tree, step=7)
    assert checkpoint.latest_step(path) == 7
    assert sorted(os.listdir(tmp_path / "sub")) == ["ck.json", "ck.npz"]
    manifest = json.loads((tmp_path / "sub" / "ck.json").read_text())
    assert manifest["keys"] == sorted(
        ["a", "nested/w", "nested/list/0", "nested/list/1", "f32"])
    assert manifest.get("bfloat16", []) == (
        ["a", "nested/list/0", "nested/list/1", "nested/w"]
        if dtype == torch.bfloat16 else [])
    got = checkpoint.restore(path, _tree(dtype))
    assert _same(got, tree)
    if dtype == torch.bfloat16:
        # the raw payload holds the 16-bit patterns
        arrays, _ = checkpoint.load_arrays(path)
        assert arrays["a"].dtype == np.uint16
        assert np.array_equal(arrays["a"],
                              tree["a"].view(torch.int16).numpy().view(
                                  np.uint16))


@pytest.mark.parametrize("damage", ["truncate", "flip"])
def test_damaged_payload_refused_before_load(tmp_path, damage, monkeypatch):
    path = str(tmp_path / "ck")
    checkpoint.save(path, _tree(), step=1)
    blob = (tmp_path / "ck.npz").read_bytes()
    if damage == "truncate":
        blob = blob[:len(blob) // 2]
    else:
        blob = blob[:-10] + bytes([blob[-10] ^ 1]) + blob[-9:]
    (tmp_path / "ck.npz").write_bytes(blob)

    def never(*a, **k):
        raise AssertionError("the payload was deserialized")

    monkeypatch.setattr(np, "load", never)
    for load in (checkpoint.load_arrays, checkpoint.verify,
                 lambda p: checkpoint.restore(p, _tree())):
        with pytest.raises(ValueError, match="truncated or corrupt"):
            load(path)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    rng = np.random.default_rng(1)
    tree = {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "layers": [{"b": rng.standard_normal(5).astype(np.float32)}]}
    path = str(tmp_path / "ref")
    jckpt.save(path, jax.tree.map(jnp.asarray, tree), step=3)
    like = jax.tree.map(lambda a: torch.zeros(a.shape), tree)
    got = checkpoint.restore(path, like)
    assert checkpoint.latest_step(path) == 3
    for a, b in zip(tree_leaves(got), jax.tree.leaves(tree)):
        assert a.dtype == torch.float32 and np.array_equal(a.numpy(), b)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _tree()
    path = str(tmp_path / "port")
    checkpoint.save(path, tree, step=5)
    like = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.float32),
                        to_numpy(tree))
    got = jckpt.restore(path, like)
    assert jckpt.latest_step(path) == 5
    for a, b in zip(jax.tree.leaves(got), tree_leaves(tree)):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_sessions_cross_both_ways(tmp_path):
    """A reference session's checkpoint loads into the port's session and
    the port's into the reference's: same params, moments and step."""
    jsess = JTrainSession(JSessionConfig(**{k: v for k, v in SESSION.items()
                                            if k != "device"}))
    jsess.run(1)
    jsess.save_checkpoint(str(tmp_path / "j"))
    sess = TrainSession(SessionConfig(**SESSION))
    assert sess.load_checkpoint(str(tmp_path / "j")) == 1
    for got, want in ((sess.params, jsess.params),
                      (sess.opt_state, jsess.opt_state)):
        for a, b in zip(tree_leaves(to_numpy(got)),
                        jax.tree.leaves(jax.tree.map(np.asarray, want)),
                        strict=True):
            assert np.array_equal(a, b)
    sess.run(1)
    sess.save_checkpoint(str(tmp_path / "p"))
    jback = JTrainSession(JSessionConfig(**{k: v for k, v in SESSION.items()
                                            if k != "device"}))
    assert jback.load_checkpoint(str(tmp_path / "p")) == 2
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jback.params)),
                    tree_leaves(to_numpy(sess.params)), strict=True):
        assert np.array_equal(a, b)


@pytest.fixture
def one_thread():
    """The CPU's embedding backward accumulates over threads in no fixed
    order, so two identical multi-threaded runs may differ in the last
    bit: bit-equality needs one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("strategy", ["vanilla", "local_sgd"])
def test_session_resume_equals_uninterrupted_run(tmp_path, strategy,
                                                 one_thread):
    def session():
        st = (make_strategy("local_sgd", period=2)
              if strategy == "local_sgd" else None)
        return TrainSession(SessionConfig(**SESSION), strategy=st,
                            params=params0)

    params0 = TrainSession(SessionConfig(**SESSION)).params
    whole = session()
    losses = whole.run(4)
    first = session()
    first.run(2)
    first.save_checkpoint(str(tmp_path / "ck"))
    resumed = session()
    assert resumed.load_checkpoint(str(tmp_path / "ck")) == 2
    later = resumed.run(2)
    assert first.losses + later == losses
    assert _same(resumed.params, whole.params)
    assert _same(resumed.opt_state, whole.opt_state)
    assert resumed.step == whole.step == 4


def test_load_refusals(tmp_path):
    sess = TrainSession(SessionConfig(**SESSION))
    sess.save_checkpoint(str(tmp_path / "ok"))
    # a leaf missing
    params = dict(sess.params)
    params.pop("final_norm")
    checkpoint.save(str(tmp_path / "noleaf"),
                    {"params": params, "opt": sess.opt_state}, step=0)
    with pytest.raises(ValueError, match="lacks 'params' leaves"):
        TrainSession(SessionConfig(**SESSION)).load_checkpoint(
            str(tmp_path / "noleaf"))
    # an optimizer buffer missing
    checkpoint.save(str(tmp_path / "nov"),
                    {"params": sess.params, "opt": {"m": sess.opt_state["m"]}},
                    step=0)
    with pytest.raises(ValueError, match="lacks optimizer buffers"):
        TrainSession(SessionConfig(**SESSION)).load_checkpoint(
            str(tmp_path / "nov"))
    # after the first step
    sess.step_once()
    with pytest.raises(RuntimeError, match="before the first step"):
        sess.load_checkpoint(str(tmp_path / "ok"))


def test_cli_checkpoint_flag_writes_a_loadable_checkpoint(tmp_path, capsys):
    path = str(tmp_path / "cli")
    sess = train.main(["--device", "cpu", "--reduced", "--steps", "2",
                       "--batch", "2", "--seq", "32", "--local-sgd", "2",
                       "--checkpoint", path])
    assert f"checkpoint written: {path}" in capsys.readouterr().out
    assert checkpoint.latest_step(path) == 2
    fresh = TrainSession(SessionConfig(**SESSION))
    assert fresh.load_checkpoint(path) == 2
    assert _same(fresh.params, sess.params)


# ---------------------------------------------------------------------------
# Sharded and pipeline checkpoints across the packages
# ---------------------------------------------------------------------------

def _flat(tree):
    return {k: np.asarray(v) for k, v in
            _flatten_with_paths(to_numpy(tree) if _is_torch(tree)
                                else jax.tree.map(np.asarray, tree)).items()}


def _is_torch(tree):
    return isinstance(tree_leaves(tree)[0], torch.Tensor)


def _port_session(mode):
    st = {"replicated": None,
          "sharded": make_strategy("every_step", parallelism="shard"),
          "pipeline": make_strategy("every_step", parallelism="micro=2")}
    return TrainSession(SessionConfig(**SESSION), strategy=st[mode])


def _ref_session(mode):
    from repro.core import make_strategy as jmake_strategy
    st = {"replicated": None,
          "sharded": jmake_strategy("every_step", parallelism="shard"),
          "pipeline": jmake_strategy("every_step", parallelism="micro=2")}
    return JTrainSession(JSessionConfig(**{k: v for k, v in SESSION.items()
                                           if k != "device"}),
                         strategy=st[mode])


def _saved(path):
    """The checkpoint's arrays in the leaf-shaped form (the reference's
    pipeline sessions write their moments in the stage tree's)."""
    from repro_torch.api import _leaf_shaped_keys
    data, _ = checkpoint.load_arrays(path)
    return _leaf_shaped_keys(data)


def _assert_restored(saved, params, opt):
    got = {**{f"params/{k}": v for k, v in _flat(params).items()},
           **{f"opt/{k}": v for k, v in _flat(opt).items()}}
    want = {k: v for k, v in saved.items()
            if not (k.startswith("opt/master/") and k not in got)}
    for k, v in got.items():
        if k.startswith("opt/master/") and k not in saved:
            # a replicated / pipeline checkpoint: the master is the params
            v2 = saved["params/" + k[len("opt/master/"):]]
            assert np.array_equal(v, v2.astype(np.float32)), k
            continue
        assert np.array_equal(v, want.pop(k)), k
    assert not [k for k in want if not k.startswith("opt/master/")], want


@pytest.mark.parametrize("saved_by,target", [
    ("port-sharded", "reference-sharded"),
    ("port-sharded", "reference-replicated"),
    ("reference-sharded", "port-sharded"),
    ("reference-sharded", "port-replicated"),
    ("port-pipeline", "reference-sharded"),
    ("port-pipeline", "reference-replicated"),
    ("reference-pipeline", "port-sharded"),
    ("reference-pipeline", "port-replicated")])
def test_sharded_and_pipeline_checkpoints_cross_both_ways(
        tmp_path, saved_by, target, one_thread):
    """A sharded session's checkpoint (leaf-shaped moments and the f32
    ``master``) and a pipeline session's (micro-batched at world 1) from
    either package restore in the other's sharded and replicated sessions
    bit for bit: params, moments and, in a sharded session, the master
    (the saved one, or the params in f32).  The reference's pipeline
    checkpoint stores its moments in the stage tree's form, which the
    port reads as the leaf-shaped tree; the reference's own sessions
    refuse that file (ROADMAP.md queue 3)."""
    pkg, mode = saved_by.split("-")
    path = str(tmp_path / "ck")
    src = _port_session(mode) if pkg == "port" else _ref_session(mode)
    src.run(1)
    src.save_checkpoint(path)
    saved = _saved(path)
    assert any(k.startswith("opt/master/") for k in saved) == \
        (mode == "sharded")
    tpkg, tmode = target.split("-")
    dst = _port_session(tmode) if tpkg == "port" else _ref_session(tmode)
    assert dst.load_checkpoint(path) == 1
    dst._build()
    _assert_restored(saved, dst.params, dst.full_opt_state())
    if saved_by == "reference-pipeline" and tmode == "replicated":
        with pytest.raises(ValueError, match="lacks 'opt/m' leaves"):
            _ref_session("replicated").load_checkpoint(path)
