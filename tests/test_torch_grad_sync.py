"""The port's gradient synchronizer (``repro_torch.core.grad_sync``) against
the JAX package's.

  * World 1: the port's ``PlanExecutor`` on a gloo group of one process
    against the reference's, run inside ``shard_map`` over a one-device
    mesh, on the same gradients and EF residuals: synced gradients and new
    residuals for ``none``, ``int8_fused`` and ``topk_fused``, packed and
    per-leaf buckets, and the two compressed wires without error
    feedback.  The plans and ``payload_bits`` are the same.
  * World 2: two processes (``torch.multiprocessing``, gloo, rendezvous by
    a ``FileStore`` under ``tmp_path``) each sync their own gradients;
    every rank's synced gradients and residuals are held against an
    expectation composed from ``repro.kernels.ref`` per rank.

Tolerances: the reference executor runs under jit, where XLA turns
``s/127`` into ``s·(1/127)`` (one more rounding) and contracts the
residual's ``c − q·(s/127)`` into one FMA; the port, like ref.py, divides
and rounds the product and the difference apart.  So at world 1 an
int8_fused synced value may differ by 2 ulp of itself (2**-22 relative)
and a residual by 4 ulp of the bucket's largest |c|.  Everything else is
bit-equal; at world 2 the expectation comes from ref.py run eagerly (no
jit), and a sum of two terms is exact in either order, the mean a division
by 2.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp
from jax.sharding import PartitionSpec as P

from repro.core import GradientSynchronizer as JSync
from repro.core import PlanExecutor as JExec
from repro.core import SyncConfig as JCfg
from repro.core import bucketize as jbucketize
from repro.core import plan_from_config as jplan
from repro.kernels import ref as jref
from repro_torch.core import (GradientSynchronizer, PlanExecutor, SyncConfig,
                              bucketize, plan_from_config)
from repro_torch.core.collectives import ALGOS, tree
from repro_torch.launch.dist import init_group

SHAPES = {"a": (2065,), "b": (64, 33), "c": (3, 700), "d": (5000,)}
CASES = [("none", 32 * 2**20), ("int8_fused", 8192), ("int8_fused", 0),
         ("topk_fused", 8192), ("topk_fused", 0)]
CASE_IDS = [f"{c}-{b}" for c, b in CASES]
NO_EF_CASES = [c for c in CASES if c[0] != "none"]
NO_EF_IDS = [f"{c}-{b}" for c, b in NO_EF_CASES]
ULP = 2.0 ** -23


def _grads(seed: int):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * (1 + i)).astype(np.float32)
            for i, (k, s) in enumerate(sorted(SHAPES.items()))}


def _residuals(state_errors, seed: int):
    """Random residuals shaped like a plan's EF buffers (None stays None)."""
    rng = np.random.default_rng(seed)
    return [None if e is None else
            (rng.standard_normal(tuple(e.shape)) * 0.05).astype(np.float32)
            for e in state_errors]


@pytest.fixture(scope="module")
def world1():
    init_group(torch.device("cpu"))


@pytest.mark.parametrize("compressor,bucket_bytes", CASES, ids=CASE_IDS)
def test_world1_matches_jax_executor(world1, compressor, bucket_bytes):
    _world1_against_jax(compressor, bucket_bytes, error_feedback=True)


@pytest.mark.parametrize("compressor,bucket_bytes", NO_EF_CASES,
                         ids=NO_EF_IDS)
def test_world1_no_error_feedback_matches_jax_executor(world1, compressor,
                                                       bucket_bytes):
    # without error feedback the encode is the compressor's compress
    # (ops.quantize_tiles / ops.topk_mask), and the state holds no residual;
    # the same tolerances as with it (module docstring)
    _world1_against_jax(compressor, bucket_bytes, error_feedback=False)


def _world1_against_jax(compressor, bucket_bytes, error_feedback):
    g = _grads(seed=1)
    cfg = SyncConfig(compressor=compressor, bucket_bytes=bucket_bytes,
                     error_feedback=error_feedback)
    jcfg = JCfg(compressor=compressor, bucket_bytes=bucket_bytes,
                error_feedback=error_feedback)
    gt = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
    gj = {k: jnp.asarray(v) for k, v in g.items()}
    plan, jp = plan_from_config(cfg, gt), jplan(jcfg, gj)
    assert [(b.leaves, b.pack, b.bucket_bytes, b.compressor)
            for b in plan.buckets] == [(b.leaves, b.pack, b.bucket_bytes,
                                        b.compressor) for b in jp.buckets]
    ex, jex = PlanExecutor(plan), JExec(jp, ("data",))
    assert ex.payload_bits(gt) == jex.payload_bits(gj)

    state, jstate = ex.init_state(gt), jex.init_state(gj)
    assert ("error" in state) == (error_feedback and compressor != "none")
    res = []
    if "error" in state:
        res = _residuals(state["error"], seed=2)
        state["error"] = [None if r is None else torch.from_numpy(r.copy())
                          for r in res]
        jstate["error"] = [None if r is None else jnp.asarray(r) for r in res]
    synced, new = ex(gt, state)

    mesh = jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    f = jax.shard_map(lambda g_, s_, r_: jex(g_, s_, r_), mesh=mesh,
                      in_specs=(P(), P(), P()), out_specs=(P(), P()),
                      axis_names={"data"}, check_vma=False)
    jsynced, jnew = jax.jit(f)(gj, jstate, jax.random.PRNGKey(0))

    for k in SHAPES:
        assert synced[k].dtype == torch.float32
        got, want = synced[k].numpy(), np.asarray(jsynced[k])
        if compressor == "int8_fused":
            assert np.all(np.abs(got - want) <= 2 * ULP * np.abs(want)), k
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    assert new["step"] == int(jnew["step"]) == 1
    assert ("error" in new) == ("error" in jnew)
    for e, je in zip(new.get("error", []), jnew.get("error", [])):
        if e is None:
            assert je is None
            continue
        je = np.asarray(je)
        if compressor == "int8_fused":
            # the reference's FMA-contracted residual (module docstring);
            # max|c| <= max|g| + max|e|
            c_max = (max(np.abs(v).max() for v in g.values())
                     + max(np.abs(r).max() for r in res if r is not None))
            assert np.all(np.abs(e.numpy() - je) <= 4 * ULP * c_max)
        else:
            np.testing.assert_array_equal(e.numpy(), je)


@pytest.mark.parametrize("bucket_bytes", [0, 8192, 32 * 2**20])
def test_bucketize_matches_jax_and_round_trips(bucket_bytes):
    g = _grads(seed=6)
    gt = {k: torch.from_numpy(v) for k, v in g.items()}
    defs, pack, unpack = bucketize(gt, bucket_bytes)
    assert defs == jbucketize({k: jnp.asarray(v) for k, v in g.items()},
                              bucket_bytes)[0]
    back = unpack(pack(gt))
    for k in g:
        assert torch.equal(back[k], gt[k])


def test_world1_synchronizer_equals_executor(world1):
    g = {k: torch.from_numpy(v) for k, v in _grads(seed=4).items()}
    cfg = SyncConfig(compressor="int8_fused", bucket_bytes=8192)
    sync, ex = GradientSynchronizer(cfg), PlanExecutor(plan_from_config(cfg, g))
    out_s, st_s = sync(g, sync.init_state(g))
    out_e, st_e = ex(g, ex.init_state(g))
    for k in g:
        assert torch.equal(out_s[k], out_e[k])
    for a, b in zip(st_s["error"], st_e["error"]):
        assert torch.equal(a, b)
    assert sync.payload_bits(g) == JSync(
        JCfg(compressor="int8_fused", bucket_bytes=8192),
        ("data",)).payload_bits({k: jnp.asarray(v.numpy())
                                 for k, v in g.items()})


def test_unported_algorithms_raise(world1, monkeypatch):
    # every algorithm constructs and, at world 1, is the identity of the
    # reference (p == 1 returns x); unknown names raise ValueError
    g = {k: torch.from_numpy(v) for k, v in _grads(seed=5).items()}
    want, _ = GradientSynchronizer(SyncConfig(compressor="int8_fused"))(
        g, GradientSynchronizer(SyncConfig(compressor="int8_fused"))
        .init_state(g))
    for algo in ALGOS:
        sync = GradientSynchronizer(SyncConfig(compressor="int8_fused",
                                               algo=algo))
        got, _ = sync(g, sync.init_state(g))
        for k in g:
            assert torch.equal(got[k], want[k]), (algo, k)
    with pytest.raises(ValueError):
        GradientSynchronizer(SyncConfig(algo="nope"))
    with pytest.raises(ValueError):
        PlanExecutor(plan_from_config(SyncConfig(algo="nope"), g))
    # a tree over 3 ranks raises before it moves a byte
    monkeypatch.setattr(tree, "axis_size", lambda axis: 3)
    with pytest.raises(ValueError, match="power-of-two"):
        tree.tree_allreduce(torch.ones(4), None)


# ---------------------------------------------------------------------------
# World 2 on gloo
# ---------------------------------------------------------------------------

def _worker(rank: int, store: str, out_dir: str) -> None:
    """One rank: sync this rank's gradients under every case, save what
    came out."""
    init_group(torch.device("cpu"), world_size=2, rank=rank, store_path=store)
    g = {k: torch.from_numpy(v) for k, v in _grads(seed=10 + rank).items()}
    for compressor, bucket_bytes in CASES:
        ex = PlanExecutor(plan_from_config(
            SyncConfig(compressor=compressor, bucket_bytes=bucket_bytes), g))
        state = ex.init_state(g)
        if "error" in state:
            state["error"] = [None if r is None else torch.from_numpy(r)
                              for r in _residuals(state["error"],
                                                  seed=20 + rank)]
        synced, new = ex(g, state)
        arrays = {f"g_{k}": v.numpy() for k, v in synced.items()}
        arrays.update({f"e_{j}": e.numpy()
                       for j, e in enumerate(new.get("error", []))
                       if e is not None})
        np.savez(os.path.join(out_dir, f"{compressor}-{bucket_bytes}-"
                              f"{rank}.npz"), **arrays)
    # leave the group together: a rank that exits while its peer's gloo
    # threads still hold the pair can abort the peer at exit
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def _expected(compressor, bucket_bytes):
    """Every rank's synced gradients and residuals from repro.kernels.ref,
    bucket by bucket (the same plan on every rank)."""
    gs = [_grads(seed=10 + r) for r in range(2)]
    gt = {k: torch.from_numpy(v) for k, v in gs[0].items()}
    plan = plan_from_config(SyncConfig(compressor=compressor,
                                       bucket_bytes=bucket_bytes), gt)
    keys = sorted(SHAPES)
    state = PlanExecutor(plan).init_state(gt)
    res = [_residuals(state.get("error", [None] * plan.n_buckets),
                      seed=20 + r) for r in range(2)]
    synced = {}
    errors = [{}, {}]
    for j, b in enumerate(plan.buckets):
        names = [keys[i] for i in b.leaves]
        bufs = [jnp.asarray(np.concatenate([gr[k].reshape(-1)
                                            for k in names])) for gr in gs]
        if compressor == "none":
            total = (bufs[0] + bufs[1]) / 2.0
        elif compressor == "int8_fused":
            outs = [jref.quantize_ef_ref(bufs[r], jnp.asarray(res[r][j]
                                                               .reshape(-1)))
                    for r in range(2)]
            total = jref.dequant_accum_ref(
                jnp.stack([o[0] for o in outs]),
                jnp.stack([o[2] for o in outs])) / 2.0
            for r in range(2):
                errors[r][j] = np.asarray(outs[r][1])
        else:
            outs = [jref.topk_ef_ref(bufs[r], jnp.asarray(res[r][j]
                                                           .reshape(-1)))
                    for r in range(2)]
            total = (outs[0][0] + outs[1][0]) / 2.0
            for r in range(2):
                errors[r][j] = np.asarray(outs[r][1])
        off = 0
        for k in names:
            n = int(np.prod(SHAPES[k]))
            synced[k] = np.asarray(total[off:off + n]).reshape(SHAPES[k])
            off += n
    return synced, errors


def test_world2_gloo_matches_composed_reference(tmp_path):
    ctx = tmp.get_context("spawn")
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=_worker, args=(r, store, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0, 0]

    for compressor, bucket_bytes in CASES:
        synced, errors = _expected(compressor, bucket_bytes)
        for r in range(2):
            got = np.load(tmp_path / f"{compressor}-{bucket_bytes}-{r}.npz")
            for k in SHAPES:
                np.testing.assert_array_equal(
                    got[f"g_{k}"], synced[k],
                    err_msg=f"{compressor} rank {r} {k}")
            for j, e in errors[r].items():
                np.testing.assert_array_equal(
                    got[f"e_{j}"].reshape(-1), e,
                    err_msg=f"{compressor} rank {r} bucket {j}")
