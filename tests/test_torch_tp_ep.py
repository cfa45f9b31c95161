"""Tensor and expert parallelism of the port (the Megatron f/g pair
``layers.tp_in`` / ``tp_out`` / ``mlp_tp``, ``layers.mlp_blocked``, the
differentiable all-to-all ``collectives.all_to_all_grad`` and
``moe_ffn(ep_axis=...)``) against the JAX package's multi-device checks.

  * The inputs are drawn here by JAX (the reference checks' keys:
    PRNGKey 7 and ``tiny_batch`` for TP, 11 for EP, 17 / 18 for the
    all-to-all, 3 for the drop tap) and cross as numpy.
  * The reference runs once per module on 8 fake host devices, in a
    subprocess of this file: ``check_tp_dp_bit_exact``'s TP=2 x DP=4 and
    blocked DP=4 steps, ``check_ep_dp_bit_exact``'s EP=2 x DP=4 steps
    (both variants) and its ``groups=2`` DP=4 step,
    ``check_all_to_all_bit_identity``'s exchanges, the drop tap of
    ``check_drop_tap_shard_map``'s layer run per shard outside
    ``shard_map`` (that check aborts the process on jax 0.9.0, ROADMAP.md
    queue 3), and the CLI and the session at world 4 (``--data-parallel
    4``) with ``--parallelism dp=2,tp=2`` and ``dp=2,ep=2``.
  * The port runs once per module as a world-8 gloo group (``FileStore``
    under ``tmp_path``, one thread a process) on a (data 4, model 2) mesh
    of process groups; ranks 0-3 and 4-7 then run the two CLIs and
    sessions on two world-4 subgroups at once.  The steps sum gradients
    over the data axis on the ``tree`` schedule (every element in one
    order, wherever it sits in a shard), as the reference's psum does.

Held:

  * TP: 3 Adam steps of the port's TP=2 x DP=4 step are BIT-EQUAL to the
    port's DP=4 step on ``mlp_blocked(blocks=2)`` (parameters, both
    moments, losses), and within 1e-5 of the largest magnitude of each of
    the reference's leaves (parameters and moments; losses at rtol 1e-6):
    the two frameworks' f32 matmuls round differently, and Adam carries a
    relative gradient difference through at full size (measured: at most
    2.9e-6, ``wi_gate``; ROADMAP.md queue 3).
  * EP: in both variants, 3 Adam steps on the expert leaves (router
    frozen) of the port's EP=2 x DP=4 step are BIT-EQUAL to the port's
    ``groups=2`` DP=4 step, and within 1e-5 of the reference's largest
    magnitudes (measured: at most 5.4e-7).
  * The differentiable all-to-all on 8 ranks: bit-equal to the
    reference's exchange, an involution, and its backward the reference's
    autodiff reverse edge, in both variants.
  * The drop tap inside an ep region: the ranks' counts sum to the
    reference's per-shard counts exactly (capacity factor 0.5 drops), and
    a forward under ``drop_tap_paused`` counts nothing.
  * Reduced gemma-2b cut to 2 layers, in f32: the training loss and
    gradients under ``tp_region`` on a tp group of 2 (the rank's ffn
    slices, ``convert.tp_slice``) within 1e-5 of the unsharded model's.
  * The CLI at world 4: the plan records equal the reference CLI's (floats
    at rel 1e-12), and the runs end in ``final loss`` with the spec in
    ``describe()``; the sessions on the reference's weights plan the same
    arm, and their 2 steps' losses agree at rtol 1e-4 (the world-4 bound
    of ``tests/test_torch_plan_auto.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
from pathlib import Path

if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
P = 8
STEPS = 3
VARIANTS = ("direct", "ring")
MOE_CFG = dict(name="t", family="qwen3", num_layers=1, d_model=16,
               num_heads=2, num_kv_heads=2, d_ff=32, vocab_size=64,
               num_experts=4, top_k=2, moe_d_ff=24)
CLI_BASE = ["--reduced", "--steps", "1", "--batch", "4", "--seq", "16",
            "--sync", "auto", "--plan-backward-ms", "20"]
CLI_RUNS = {"tp": ["--arch", "gemma-2b", "--parallelism", "dp=2,tp=2"],
            "ep": ["--arch", "qwen3-moe-30b-a3b", "--parallelism",
                   "dp=2,ep=2"]}
SESSION = dict(batch=4, seq=16, lr=3e-3, warmup=2, steps=8)
SESSION_STEPS = 2
REL_REFERENCE = 1e-5     # of a leaf's largest magnitude, after 3 Adam steps


# ---------------------------------------------------------------------------
# Inputs, drawn by JAX as the reference checks draw them
# ---------------------------------------------------------------------------

def _inputs() -> dict:
    import jax
    import jax.numpy as jnp
    from tiny_lm import tiny_batch

    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import Model as JModel
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths

    out = {}
    d, dff, vocab = 16, 32, 64
    ks = jax.random.split(jax.random.PRNGKey(7), 6)
    tp = {"emb": jax.random.normal(ks[0], (vocab, d)) * 0.1,
          "wi_gate": jax.random.normal(ks[1], (d, dff)) * 0.3,
          "wi_up": jax.random.normal(ks[2], (d, dff)) * 0.3,
          "wo": jax.random.normal(ks[3], (dff, d)) * 0.3,
          "out": jax.random.normal(ks[4], (d, vocab)) * 0.1,
          "b": jnp.zeros((vocab,))}
    out.update({f"tp/{k}": np.asarray(v) for k, v in tp.items()})
    for s in range(STEPS):
        out[f"tp/toks{s}"] = np.asarray(tiny_batch(s, batch=16,
                                                   seq=12)["tokens"])
    ks = jax.random.split(jax.random.PRNGKey(11), 5)
    out["ep/router"] = np.asarray(jax.random.normal(ks[0], (d, 4)) * 0.1)
    out["ep/wi_gate"] = np.asarray(jax.random.normal(ks[1], (4, d, 24)) * .3)
    out["ep/wi_up"] = np.asarray(jax.random.normal(ks[2], (4, d, 24)) * 0.3)
    out["ep/wo"] = np.asarray(jax.random.normal(ks[3], (4, 24, d)) * 0.3)
    for s in range(STEPS):
        out[f"ep/x{s}"] = np.asarray(jax.random.normal(
            jax.random.fold_in(ks[4], s), (8, 4, d)))
    out["a2a/x"] = np.asarray(jax.random.normal(jax.random.PRNGKey(17),
                                                (P, P, 5, 7)))
    out["a2a/w"] = np.asarray(jax.random.normal(jax.random.PRNGKey(18),
                                                (P, P, 5, 7)))
    ks = jax.random.split(jax.random.PRNGKey(3), 5)
    out["tap/router"] = np.asarray(jax.random.normal(ks[0], (d, 4)) * 0.1)
    out["tap/wi_gate"] = np.asarray(jax.random.normal(ks[1], (4, d, 24)) * .3)
    out["tap/wi_up"] = np.asarray(jax.random.normal(ks[2], (4, d, 24)) * .3)
    out["tap/wo"] = np.asarray(jax.random.normal(ks[3], (4, 24, d)) * 0.3)
    out["tap/x"] = np.asarray(jax.random.normal(ks[4], (8, 4, d)))
    # the reference sessions' parameters (seed 0), for the port's sessions
    for arch in ("gemma-2b", "qwen3-moe-30b-a3b"):
        start = JModel(jreduced(jget_config(arch))).init(
            jax.random.PRNGKey(0))
        out.update({f"start/{arch}/{k}": v for k, v in _flatten_with_paths(
            jax.tree.map(np.asarray, start)).items()})
    return out


def _group(inp: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in inp.items()
            if k.startswith(prefix)}


def _unflat(flat: dict):
    """The nested dict/list tree of ``/``-joined keys (digit keys are list
    indices)."""
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


# ---------------------------------------------------------------------------
# The reference, on 8 fake devices (this file run as a script)
# ---------------------------------------------------------------------------

def _reference(out_dir: str) -> None:
    import jax
    import jax.numpy as jnp
    import repro.compat  # noqa: F401  (shard_map shims on old JAX)
    from jax.sharding import AxisType
    from jax.sharding import PartitionSpec as Ps
    from multi_device_checks import _adam_sgd_step

    import repro.launch.paths as j_paths
    from repro.api import SessionConfig, TrainSession
    from repro.configs.base import ModelConfig
    from repro.core.collectives.api import all_to_all
    from repro.launch import train as jtrain
    from repro.models import moe
    from repro.models.layers import mlp_blocked, mlp_tp

    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    out = {}

    # -- check_tp_dp_bit_exact ----------------------------------------------
    params0 = {k: jnp.asarray(v) for k, v in _group(inp, "tp/").items()
               if not k.startswith("toks")}

    def loss_with(mlp_fn, p, toks):
        x = p["emb"][toks[:, :-1]]
        xb = jax.lax.optimization_barrier(x)
        h = x + jax.lax.optimization_barrier(mlp_fn(p, xb))
        logits = h @ p["out"] + p["b"]
        lp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(lp, toks[:, 1:][..., None], -1))

    def tp_body(mlp_fn):
        def body(p, m, v, toks, t):
            lo, g = jax.value_and_grad(
                lambda q: loss_with(mlp_fn, q, toks))(p)
            g = jax.tree.map(lambda gi: jax.lax.psum(gi, "data") / 4.0, g)
            p, m, v = _adam_sgd_step(p, g, m, v, t)
            return jax.lax.psum(lo, "data") / 4.0, p, m, v
        return body

    def run(mesh, specs, xspec, body, w0, batches):
        zeros = jax.tree.map(jnp.zeros_like, w0)
        p, m, v = w0, zeros, zeros
        f = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(specs, specs, specs, xspec, Ps()),
            out_specs=(Ps(), specs, specs, specs),
            axis_names=set(mesh.axis_names), check_vma=False))
        losses = []
        for s in range(STEPS):
            lo, p, m, v = f(p, m, v, jnp.asarray(batches[s]),
                            jnp.asarray(s + 1, jnp.float32))
            losses.append(float(lo))
        return losses, p, m, v

    def keep(name, losses, p, m, v):
        out[f"{name}/losses"] = np.asarray(losses)
        for tag, tree in (("p", p), ("m", m), ("v", v)):
            for k, a in tree.items():
                out[f"{name}/{tag}/{k}"] = np.asarray(a)

    toks = [inp[f"tp/toks{s}"] for s in range(STEPS)]
    mesh_tp = jax.make_mesh((4, 2), ("data", "tp"),
                            axis_types=(AxisType.Auto,) * 2)
    specs_tp = {"emb": Ps(), "wi_gate": Ps(None, "tp"),
                "wi_up": Ps(None, "tp"), "wo": Ps("tp", None), "out": Ps(),
                "b": Ps()}
    keep("tp", *run(mesh_tp, specs_tp, Ps("data"),
                    tp_body(lambda p, x: mlp_tp(p, x, axis="tp")),
                    params0, toks))
    mesh_dp = jax.make_mesh((4,), ("data",), axis_types=(AxisType.Auto,))
    keep("tp_blocked", *run(mesh_dp, {k: Ps() for k in params0}, Ps("data"),
                            tp_body(lambda p, x: mlp_blocked(p, x,
                                                             blocks=2)),
                            params0, toks))

    # -- check_ep_dp_bit_exact ----------------------------------------------
    cfg = ModelConfig(**MOE_CFG, capacity_factor=1.5)
    router = jnp.asarray(inp["ep/router"])
    ew0 = {k: jnp.asarray(inp[f"ep/{k}"]) for k in ("wi_gate", "wi_up",
                                                     "wo")}
    xs = [inp[f"ep/x{s}"] for s in range(STEPS)]

    def ep_body(moe_kwargs, loss_axes):
        def body(ew, m, v, x, t):
            def loss_fn(w):
                o, _ = moe.moe_ffn(dict(w, router=router), cfg, x,
                                   **moe_kwargs)
                return jnp.sum(o ** 2)
            lo, g = jax.value_and_grad(loss_fn)(ew)
            g = jax.tree.map(lambda gi: jax.lax.psum(gi, "data") / 4.0, g)
            ew, m, v = _adam_sgd_step(ew, g, m, v, t)
            return jax.lax.psum(lo, loss_axes), ew, m, v
        return body

    keep("ep_dp", *run(mesh_dp, {k: Ps() for k in ew0}, Ps("data"),
                       ep_body({"groups": 2}, ("data",)), ew0, xs))
    mesh_ep = jax.make_mesh((4, 2), ("data", "ep"),
                            axis_types=(AxisType.Auto,) * 2)
    for variant in VARIANTS:
        keep(f"ep_{variant}", *run(
            mesh_ep, {k: Ps("ep") for k in ew0}, Ps(("data", "ep")),
            ep_body({"ep_axis": "ep", "a2a_variant": variant},
                    ("data", "ep")), ew0, xs))

    # -- check_all_to_all_bit_identity --------------------------------------
    mesh8 = jax.make_mesh((P,), ("ep",), axis_types=(AxisType.Auto,))
    x, w = jnp.asarray(inp["a2a/x"]), jnp.asarray(inp["a2a/w"])
    for variant in VARIANTS:
        def a2a_body(xs_, ws_, variant=variant):
            c = xs_[0]
            o = all_to_all(c, "ep", variant)
            back = all_to_all(o, "ep", variant)
            g = jax.grad(lambda t: jnp.sum(
                ws_[0] * all_to_all(t, "ep", variant)))(c)
            return o[None], back[None], g[None]
        f = jax.jit(jax.shard_map(a2a_body, mesh=mesh8,
                                  in_specs=(Ps("ep"), Ps("ep")),
                                  out_specs=(Ps("ep"),) * 3,
                                  axis_names={"ep"}, check_vma=False))
        o, back, g = f(x, w)
        out[f"a2a/{variant}/out"] = np.asarray(o)
        out[f"a2a/{variant}/back"] = np.asarray(back)
        out[f"a2a/{variant}/grad"] = np.asarray(g)

    # -- the drop tap, per shard outside shard_map --------------------------
    tcfg = ModelConfig(**MOE_CFG, capacity_factor=0.5)
    tparams = {k: jnp.asarray(v) for k, v in _group(inp, "tap/").items()
               if k != "x"}
    old = moe.enable_drop_tap(True)
    try:
        moe.drain_drop_tap()
        for i in range(P):
            float(jnp.sum(moe.moe_ffn(tparams, tcfg, jnp.asarray(
                inp["tap/x"][i:i + 1]))[0]))
        out["tap/counts"] = np.asarray(moe.drain_drop_tap())
    finally:
        moe.enable_drop_tap(old)

    # -- the CLI and the session at world 4 ---------------------------------
    j_paths.COMM_PLANS = os.path.join(out_dir, "ref_plans")
    res = {}
    for name, flags in CLI_RUNS.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            jtrain.main(CLI_BASE + flags + ["--data-parallel", "4"])
        res[f"cli/{name}"] = buf.getvalue()
        arch = flags[1]
        # its parameters: seed 0, as the port's sessions are given them
        sess = TrainSession(SessionConfig(arch=arch, reduced=True,
                                          data_parallel=4, **SESSION))
        sp = sess.plan_auto(parallelism=flags[3], t_backward_s=0.02)
        res[f"session/{name}"] = {"key": sp.key,
                                  "describe": sess.strategy.describe()}
        out[f"session/{name}/losses"] = np.asarray(sess.run(SESSION_STEPS))
    np.savez(os.path.join(out_dir, "reference.npz"), **out)
    with open(os.path.join(out_dir, "reference.json"), "w") as f:
        json.dump(res, f)


# ---------------------------------------------------------------------------
# The port, a world-8 gloo group
# ---------------------------------------------------------------------------

def _adam(p, g, m, v, t, lr=0.05, b1=0.9, b2=0.999, eps=1e-8):
    """The reference checks' inline elementwise Adam, leaf by leaf."""
    import torch
    m = {k: b1 * m[k] + (1 - b1) * g[k] for k in p}
    v = {k: b2 * v[k] + (1 - b2) * g[k] * g[k] for k in p}
    tt = torch.tensor(float(t))
    out = {}
    for k in p:
        mh = m[k] / (1 - torch.tensor(b1) ** tt)
        vh = v[k] / (1 - torch.tensor(b2) ** tt)
        out[k] = p[k] - lr * mh / (torch.sqrt(vh) + eps)
    return out, m, v


def _train(p0, loss_fn, batches, data):
    """3 steps: gradients summed over ``data`` / 4, then Adam.  The sum
    runs on the ``tree`` schedule, whose association is the same for every
    element: gloo's all-reduce sums an element in an order that depends
    on its place in the buffer, so a tp rank's column slice and the whole
    leaf would sum one column differently."""
    import torch

    from repro_torch.core.collectives import allreduce
    p = {k: v.clone() for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v = {k: torch.zeros_like(x) for k, x in p.items()}
    losses = []
    for s in range(STEPS):
        q = {k: x.detach().clone().requires_grad_(True) for k, x in p.items()}
        lo = loss_fn(q, batches[s])
        lo.backward()
        g = {k: allreduce(q[k].grad.clone(), "tree", data) / 4.0 for k in q}
        p, m, v = _adam(p, g, m, v, s + 1)
        losses.append(float(allreduce(lo.detach().clone(), "tree", data)
                            / 4.0))
    return losses, p, m, v


def _save(res, name, losses, p, m, v):
    res[f"{name}/losses"] = np.asarray(losses)
    for tag, tree in (("p", p), ("m", m), ("v", v)):
        for k, a in tree.items():
            res[f"{name}/{tag}/{k}"] = a.detach().numpy()


def _port_worker(rank: int, world: int, store: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    import repro_torch.launch.paths as p_paths
    from repro_torch.api import SessionConfig, TrainSession
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ModelConfig
    from repro_torch.convert import (experts_slice, mlp_slice,
                                     params_from_jax, tp_slice)
    from repro_torch.core.collectives import all_to_all, all_to_all_grad
    from repro_torch.launch import train
    from repro_torch.launch.dist import init_group, mesh_axes
    from repro_torch.models import Model
    from repro_torch.models import moe
    from repro_torch.models.layers import mlp_blocked, mlp_tp
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.models.sharding_ctx import tp_region

    torch.set_num_threads(1)
    init_group(torch.device("cpu"), world_size=world, rank=rank,
               store_path=store)
    data, model = mesh_axes((4, 2))
    d_idx, m_idx = divmod(rank, 2)
    inp = {k: torch.from_numpy(v) for k, v in
           np.load(os.path.join(out_dir, "inputs.npz")).items()}
    res = {}

    # -- TP: mlp_tp on the model axis vs mlp_blocked, both DP=4 --------------
    p0 = {k: v for k, v in _group(inp, "tp/").items()
          if not k.startswith("toks")}
    toks = [inp[f"tp/toks{s}"].to(torch.int64)[4 * d_idx:4 * d_idx + 4]
            for s in range(STEPS)]

    def tp_loss(mlp_fn):
        def loss(p, tk):
            x = p["emb"][tk[:, :-1]]
            h = x + mlp_fn(p, x)
            logits = h @ p["out"] + p["b"]
            lp = F.log_softmax(logits, dim=-1)
            return -torch.mean(torch.gather(lp, -1, tk[:, 1:, None]))
        return loss

    tp_p0 = dict(p0, **mlp_slice(p0, m_idx, 2))
    _save(res, "tp", *_train(
        tp_p0, tp_loss(lambda p, x: mlp_tp(p, x, group=model)), toks, data))
    _save(res, "tp_blocked", *_train(
        p0, tp_loss(lambda p, x: mlp_blocked(p, x, blocks=2)), toks, data))

    # -- EP: moe_ffn(ep_axis=) vs groups=2, both DP=4 ---------------------------
    cfg = ModelConfig(**MOE_CFG, capacity_factor=1.5)
    router = inp["ep/router"]
    ew0 = {k: inp[f"ep/{k}"] for k in ("wi_gate", "wi_up", "wo")}
    rows = [inp[f"ep/x{s}"] for s in range(STEPS)]

    def ep_loss(**kw):
        def loss(w, x):
            o, _ = moe.moe_ffn(dict(w, router=router), cfg, x, **kw)
            return torch.sum(o ** 2)
        return loss

    _save(res, "ep_dp", *_train(
        ew0, ep_loss(groups=2), [x[2 * d_idx:2 * d_idx + 2] for x in rows],
        data))
    mine = [x[rank:rank + 1] for x in rows]
    for variant in VARIANTS:
        _save(res, f"ep_{variant}", *_train(
            experts_slice(ew0, m_idx, 2),
            ep_loss(ep_axis=model, a2a_variant=variant), mine, data))

    # -- the differentiable all-to-all on 8 ranks ------------------------------
    for variant in VARIANTS:
        x = inp["a2a/x"][rank].clone()
        o = all_to_all_grad(x, None, variant)
        res[f"a2a/{variant}/out"] = o.numpy()
        res[f"a2a/{variant}/back"] = all_to_all(o, None, variant).numpy()
        t = x.clone().requires_grad_(True)
        torch.sum(inp["a2a/w"][rank] * all_to_all_grad(t, None,
                                                       variant)).backward()
        res[f"a2a/{variant}/grad"] = t.grad.numpy()

    # -- the drop tap inside the ep region -------------------------------------
    tcfg = ModelConfig(**MOE_CFG, capacity_factor=0.5)
    tparams = experts_slice({k: v for k, v in _group(inp, "tap/").items()
                             if k != "x"}, m_idx, 2)
    old = moe.enable_drop_tap(True)
    try:
        moe.drain_drop_tap()
        with torch.no_grad():
            moe.moe_ffn(tparams, tcfg, inp["tap/x"][rank:rank + 1],
                        ep_axis=model)
            res["tap/counts"] = np.asarray(moe.drain_drop_tap())
            with moe.drop_tap_paused():
                moe.moe_ffn(tparams, tcfg, inp["tap/x"][rank:rank + 1],
                            ep_axis=model)
            res["tap/paused"] = np.asarray(moe.drain_drop_tap())
    finally:
        moe.enable_drop_tap(old)

    # -- the transformer under tp_region (model axis of data row 0) ----------
    if d_idx == 0:
        gcfg = dataclasses.replace(reduced(get_config("gemma-2b")),
                                   num_layers=2)
        gm = Model(gcfg)
        params = gm.init(torch.Generator().manual_seed(0))
        tokens = torch.from_numpy(np.random.default_rng(5).integers(
            0, gcfg.vocab_size, (2, 16)))
        batch = {"tokens": tokens}

        def grads_of(tree, region):
            q = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                         tree)
            with contextlib.ExitStack() as st:
                if region is not None:
                    st.enter_context(tp_region(region))
                lo = gm.loss(q, batch)
            lo.backward()
            return float(lo.detach()), [t.grad.numpy() for t in tree_leaves(q)]

        res["tf/full_loss"], full = grads_of(params, None)
        res["tf/tp_loss"], sharded = grads_of(tp_slice(params, m_idx, 2),
                                              model)
        it = iter(full)
        full_tree = tree_map(lambda _: torch.from_numpy(next(it)), params)
        want = [t.numpy() for t in tree_leaves(tp_slice(full_tree, m_idx,
                                                        2))]
        for i, (a, b) in enumerate(zip(sharded, want, strict=True)):
            res[f"tf/grad/{i}"] = a
            res[f"tf/want/{i}"] = b

    # -- the CLI and the session at world 4, on two subgroups at once -------
    subs = [dist.new_group(list(range(4 * i, 4 * i + 4))) for i in range(2)]
    name = list(CLI_RUNS)[rank // 4]
    flags = CLI_RUNS[name]
    p_paths.COMM_PLANS = os.path.join(out_dir, f"port_plans_{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        args = train.build_parser().parse_args(["--device", "cpu"]
                                               + CLI_BASE + flags)
        train.run(args, rank % 4, group=subs[rank // 4])
    arch = flags[1]
    start = _unflat({k: v.numpy() for k, v in
                     _group(inp, f"start/{arch}/").items()})
    sess = TrainSession(SessionConfig(arch=arch, reduced=True, device="cpu",
                                      **SESSION),
                        params=params_from_jax(start,
                                               reduced(get_config(arch)),
                                               device="cpu"),
                        group=subs[rank // 4])
    sp = sess.plan_auto(parallelism=flags[3], t_backward_s=0.02)
    res[f"session/{name}/losses"] = np.asarray(sess.run(SESSION_STEPS))
    info = {"cli": buf.getvalue(), "key": sp.key,
            "describe": sess.strategy.describe()}
    np.savez(os.path.join(out_dir, f"port-{rank}.npz"), **res)
    with open(os.path.join(out_dir, f"port-{rank}.json"), "w") as f:
        json.dump(info, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference arrays, reference json, every rank's arrays and json)."""
    from repro_torch.launch.dist import spawn
    out = tmp_path_factory.mktemp("tp_ep")
    np.savez(out / "inputs.npz", **_inputs())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, __file__, "--reference",
                            str(out)], env=env, cwd=ROOT / "tests",
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    try:
        spawn(_port_worker, P, args=(str(out),), timeout=300)
        log, _ = ref.communicate(timeout=400)
    finally:
        ref.kill()
    assert ref.returncode == 0, log[-4000:]
    want = dict(np.load(out / "reference.npz"))
    want_json = json.loads((out / "reference.json").read_text())
    got = [dict(np.load(out / f"port-{r}.npz")) for r in range(P)]
    got_json = [json.loads((out / f"port-{r}.json").read_text())
                for r in range(P)]
    return want, want_json, got, got_json, out


def _assert_close(a, b, rel, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(np.abs(b).max(), 1e-30)
    err = np.abs(a - b).max()
    assert err <= rel * scale, f"{what}: max|Δ|={err:.3e} > {rel}·{scale:.3e}"


def _assembled(got, name, tag, k, axis):
    """The whole leaf from the model axis' two ranks of data row 0."""
    return np.concatenate([got[0][f"{name}/{tag}/{k}"],
                           got[1][f"{name}/{tag}/{k}"]], axis=axis)


TP_SHARDED = {"wi_gate": -1, "wi_up": -1, "wo": -2}


def _tp_leaf(got, name, tag, k):
    if name == "tp" and k in TP_SHARDED:
        return _assembled(got, name, tag, k, TP_SHARDED[k])
    return got[0][f"{name}/{tag}/{k}"]


def _ep_leaf(got, name, tag, k):
    if name.startswith("ep_") and name != "ep_dp":
        return _assembled(got, name, tag, k, 0)
    return got[0][f"{name}/{tag}/{k}"]


def _leaves(want, name, tag):
    pre = f"{name}/{tag}/"
    return sorted(k[len(pre):] for k in want if k.startswith(pre))


@pytest.mark.parametrize("tag", ["p", "m", "v"])
def test_tp_bit_equal_to_blocked_mlp(runs, tag):
    want, _, got, _, _ = runs
    keys = _leaves(want, "tp", tag)
    assert keys == sorted(["b", "emb", "out", "wi_gate", "wi_up", "wo"])
    for r in range(P):
        # every rank of a model-axis pair holds the same replicated leaves
        for k in ("b", "emb", "out"):
            assert np.array_equal(got[r][f"tp/{tag}/{k}"],
                                  got[0][f"tp/{tag}/{k}"]), (r, k)
    for k in keys:
        np.testing.assert_array_equal(_tp_leaf(got, "tp", tag, k),
                                      _tp_leaf(got, "tp_blocked", tag, k),
                                      err_msg=k)
    np.testing.assert_array_equal(got[0]["tp/losses"],
                                  got[0]["tp_blocked/losses"])


@pytest.mark.parametrize("tag", ["p", "m", "v"])
def test_tp_matches_reference(runs, tag):
    want, _, got, _, _ = runs
    # the reference's own claim holds on this tree: TP == blocked, bits
    for k in _leaves(want, "tp", tag):
        np.testing.assert_array_equal(want[f"tp/{tag}/{k}"],
                                      want[f"tp_blocked/{tag}/{k}"])
        _assert_close(_tp_leaf(got, "tp", tag, k), want[f"tp/{tag}/{k}"],
                      REL_REFERENCE, k)
    np.testing.assert_allclose(got[0]["tp/losses"], want["tp/losses"],
                               rtol=1e-6)


@pytest.mark.parametrize("variant", VARIANTS)
def test_ep_bit_equal_to_groups_run(runs, variant):
    want, _, got, _, _ = runs
    for tag in ("p", "m", "v"):
        for k in _leaves(want, "ep_dp", tag):
            np.testing.assert_array_equal(
                _ep_leaf(got, f"ep_{variant}", tag, k),
                _ep_leaf(got, "ep_dp", tag, k), err_msg=f"{tag}/{k}")


@pytest.mark.parametrize("variant", VARIANTS)
def test_ep_matches_reference(runs, variant):
    want, _, got, _, _ = runs
    for tag in ("p", "m", "v"):
        for k in _leaves(want, "ep_dp", tag):
            np.testing.assert_array_equal(want[f"ep_{variant}/{tag}/{k}"],
                                          want[f"ep_dp/{tag}/{k}"])
            _assert_close(_ep_leaf(got, f"ep_{variant}", tag, k),
                          want[f"ep_{variant}/{tag}/{k}"], REL_REFERENCE,
                          f"{tag}/{k}")


@pytest.mark.parametrize("variant", VARIANTS)
def test_all_to_all_grad_matches_reference(runs, variant):
    want, _, got, _, _ = runs
    x = np.load(runs[4] / "inputs.npz")["a2a/x"]
    for r in range(P):
        for part in ("out", "back", "grad"):
            np.testing.assert_array_equal(got[r][f"a2a/{variant}/{part}"],
                                          want[f"a2a/{variant}/{part}"][r],
                                          err_msg=f"rank {r} {part}")
        # the exchange is an involution
        np.testing.assert_array_equal(got[r][f"a2a/{variant}/back"], x[r])


def test_drop_tap_in_ep_region_matches_reference_per_shard(runs):
    want, _, got, _, _ = runs
    total = sum(g["tap/counts"] for g in got)
    np.testing.assert_array_equal(total, want["tap/counts"])
    assert total[0] > 0 and total[1] == P * 4 * MOE_CFG["top_k"]
    for g in got:
        np.testing.assert_array_equal(g["tap/paused"], [0.0, 0.0])


def test_transformer_under_tp_region_matches_unsharded(runs):
    _, _, got, _, _ = runs
    for r in (0, 1):
        g = got[r]
        assert g["tf/tp_loss"] == pytest.approx(float(g["tf/full_loss"]),
                                                rel=1e-6)
        n = sum(1 for k in g if k.startswith("tf/grad/"))
        assert n > 10
        for i in range(n):
            _assert_close(g[f"tf/grad/{i}"], g[f"tf/want/{i}"], 1e-5,
                          f"rank {r} leaf {i}")


@pytest.mark.parametrize("name", list(CLI_RUNS))
def test_cli_record_matches_reference_cli(runs, name):
    want, want_json, got, got_json, out = runs
    arch = CLI_RUNS[name][1]
    ref = json.loads((out / "ref_plans" / f"{arch}.json").read_text())
    port = json.loads((out / f"port_plans_{name}" / f"{arch}.json")
                      .read_text())
    assert set(port) == set(ref)
    for k in port:
        if k in ("modeled_step_s", "round_cost_s", "t_backward_s",
                 "opt_mem_bytes_per_worker"):
            assert port[k] == pytest.approx(ref[k], rel=1e-12), k
        elif k == "parallelism":
            assert port[k].keys() == ref[k].keys()
            for a, b in port[k].items():
                assert b == pytest.approx(ref[k][a], rel=1e-12), a
        else:
            assert port[k] == ref[k], k
    spec = CLI_RUNS[name][3].split(",")[1]
    describe = want_json[f"session/{name}"]["describe"]
    assert f"[{spec}]" in describe
    ref_last = want_json[f"cli/{name}"].strip().splitlines()[-1]
    assert ref_last.startswith("final loss ") and ref_last.endswith(describe)
    for r in range(4 * list(CLI_RUNS).index(name),
                   4 * list(CLI_RUNS).index(name) + 4):
        cli = got_json[r]["cli"]
        if r % 4 == 0:          # rank 0 of the run prints
            last = cli.strip().splitlines()[-1]
            assert last.startswith("final loss ") and last.endswith(describe)
            assert f"strategy: {describe}" in cli
            # the plan table's parallelism line, as the reference prints it
            par = [ln for ln in cli.splitlines()
                   if ln.startswith("parallelism: ")]
            assert par and par == [
                ln for ln in want_json[f"cli/{name}"].splitlines()
                if ln.startswith("parallelism: ")]
        else:
            assert cli == ""


@pytest.mark.parametrize("name", list(CLI_RUNS))
def test_session_at_world4_matches_reference(runs, name):
    want, want_json, got, got_json, _ = runs
    ranks = range(4 * list(CLI_RUNS).index(name),
                  4 * list(CLI_RUNS).index(name) + 4)
    for r in ranks:
        assert got_json[r]["key"] == want_json[f"session/{name}"]["key"]
        assert got_json[r]["describe"] == \
            want_json[f"session/{name}"]["describe"]
        np.testing.assert_allclose(got[r][f"session/{name}/losses"],
                                   want[f"session/{name}/losses"], rtol=1e-4)


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _reference(sys.argv[2])
    print(json.dumps({"ok": True}))
