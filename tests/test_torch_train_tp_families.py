"""Training the MLA, Mamba (jamba), xLSTM and encoder-decoder families
under the reference's model-axis layout (``sharding_ctx.train_region``):
MLA's head blocks over whole latents, Mamba and the xLSTM blocks over
``inner`` (``layers.sum_f32`` and ``layers.gather_tp``), the
encoder's, the decoder's and the cross-attention's head blocks with the
memory entering the model axis once, and the replica edge over the
leaves that every rank holds but reads only through its own share.

  * One spawned gloo world of 4 (``FileStore`` under a temporary
    directory, one thread a process) runs every case of ``CASES`` at a
    small size in f32, the world as the model axis (tp = 4): the rank's
    share of the case's numpy weights (``convert.train_slice``), its
    gradients under the region (``launch/steps.loss_and_grads``) and 3
    Adam steps, the region's sums on the ``tree`` all-reduce, whose order
    over the ranks the control repeats.
  * Each case's loss and every leaf's gradient (the rank's block) equal
    the unsharded port's within ``REL_PORT`` and ``jax.value_and_grad`` of
    the JAX package's ``Model.loss`` on the same weights within
    ``REL_JAX``, each relative to the leaf's largest magnitude.
  * Every leaf that several ranks hold the same (the norms, the routers,
    MLA's ``w_dkv`` and ``kv_norm``, the mLSTM's ``b_if`` and
    ``out_norm``, the sLSTM's cell, a shared kv head's columns) has
    bit-equal gradients and, after the steps, bit-equal parameters on
    those ranks.
  * The 3 Adam steps are bit-equal to the port's blocked control
    (``sharding_ctx.blocked_region(4)``: one process, the whole weights,
    each rank's share computed apart and every sum in the tree's order):
    parameters, both moments and the losses.
  * The int8_fused DP edge on each rank's one-rank data group, planned
    with the leaves' sharing classes (``convert.train_classes``), packs
    no bucket across two classes and keeps the shared leaves bit-equal.
  * Negative controls (``NEGATIVE``): with one sum taken out (MLA's
    replica edge on ``w_dkv``; the backward sum of Mamba's ``x_proj``,
    ``layers.sum_f32``; the mLSTM's edge on ``b_if`` or on ``out_norm``;
    the memory's ``tp_in``), the leaf named moves more than ``REL_WRONG``
    from the unsharded port's gradient.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import pickle

import numpy as np
import pytest

REL_PORT = 1e-5
REL_JAX = 1e-4
REL_WRONG = 1e-2
WORLD = 4
STEPS = 3
LR = 1e-2
BATCH, SEQ, FRAMES = 2, 16, 12
BASE = dict(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
            vocab_size=512, param_dtype="float32", compute_dtype="float32")
# name: (architecture, overrides)
CASES = {
    # a dense first layer and a MoE layer with two shared experts; H = 4
    # heads over tp = 4, the latents whole on every rank
    "mla": ("deepseek-v2-lite-16b",
            dict(num_layers=2, num_kv_heads=4, kv_lora_rank=32,
                 qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
                 num_experts=8, top_k=2, moe_d_ff=32, num_shared_experts=2)),
    # Mamba (layers 0-2, d_inner 128: 32 channels a rank), attention
    # (layer 3, each kv head on two ranks), dense and MoE FFNs
    "jamba": ("jamba-v0.1-52b",
              dict(num_layers=4, attn_every=4, attn_offset=3, num_experts=4,
                   top_k=2, moe_d_ff=32)),
    # three mLSTMs (dh_v 64: 16 rows a rank) and an sLSTM (dh 32: 8 a
    # rank), the sequential scan in chunks of 8
    "xlstm": ("xlstm-125m", dict(num_layers=4, num_heads=2, num_kv_heads=2,
                                 slstm_every=4, mlstm_chunk=8)),
    # the chunkwise-parallel mLSTM on the rank's rows
    "xlstm_chunkwise": ("xlstm-125m",
                        dict(num_layers=1, num_heads=2, num_kv_heads=2,
                             mlstm_chunk=8, mlstm_parallel=True)),
    # one encoder and one decoder layer; each kv head on two ranks
    "encdec": ("seamless-m4t-large-v2",
               dict(num_layers=1, num_encoder_layers=1)),
}
# (case, name, path of the leaf whose gradient moves): the sum each takes
# out is ``_without(name)``
NEGATIVE = [("mla", "mla_w_dkv_edge", ("stack", 0, 0, "mixer", "w_dkv")),
            ("jamba", "x_proj_backward_sum",
             ("stack", 0, 0, "mixer", "x_proj")),
            ("xlstm", "mlstm_b_if_edge", ("stack", 0, 0, "mixer", "b_if")),
            ("xlstm", "mlstm_out_norm_edge",
             ("stack", 0, 0, "mixer", "out_norm", "scale")),
            ("encdec", "memory_tp_in", ("encdec", "enc_norm", "scale"))]


def _cfg(case: str, jax_side: bool = False):
    if jax_side:
        from repro.configs import get_config
    else:
        from repro_torch.configs import get_config
    arch, over = CASES[case]
    return dataclasses.replace(get_config(arch), **{**BASE, **over})


def _weights(case: str):
    """The case's weights as a numpy tree in the JAX package's layout,
    drawn from a numpy seed by each leaf's init kind (the norms' deltas,
    the biases and ``D`` drawn around their init, so a wrong sum shows in
    them)."""
    from repro_torch._tree import tree_map
    from repro_torch.models.layers import ParamDesc
    from repro_torch.models.model import Model
    rng = np.random.default_rng(400 + len(case))

    def draw(d: ParamDesc):
        if d.init in ("zeros", "ones"):
            base = float(d.init == "ones")
            return (base + rng.standard_normal(d.shape) * 0.1).astype(
                np.float32)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        scale = 0.02 if d.init == "small" else 1.0 / math.sqrt(fan_in)
        return (rng.standard_normal(d.shape) * scale).astype(np.float32)
    return tree_map(draw, Model(_cfg(case)).param_desc(),
                    is_leaf=lambda x: isinstance(x, ParamDesc))


def _batches(case: str):
    """STEPS numpy batches: tokens (BATCH, SEQ), and frames (BATCH,
    FRAMES, d) for the encoder-decoder."""
    cfg = _cfg(case)
    rng = np.random.default_rng(500 + len(case))
    out = []
    for _ in range(STEPS):
        b = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, SEQ))
             .astype(np.int32)}
        if cfg.is_encoder_decoder:
            b["src"] = rng.standard_normal((BATCH, FRAMES, cfg.d_model)) \
                .astype(np.float32)
        out.append(b)
    return out


def _torch_batch(b):
    import torch
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in b.items()}


@contextlib.contextmanager
def _without(name: str):
    """The train layout with one of its sums taken out."""
    from repro_torch.models import attention, encdec, layers, xlstm
    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)
    if name == "mla_w_dkv_edge":
        edges = attention.mla_edge_blocks
        patch(attention, "mla_edge_blocks", lambda *a: {
            k: v for k, v in edges(*a).items() if k != "w_dkv"})
    elif name in ("mlstm_b_if_edge", "mlstm_out_norm_edge"):
        leaf = "b_if" if "b_if" in name else "out_norm"
        edges = xlstm.mlstm_edge_blocks
        patch(xlstm, "mlstm_edge_blocks", lambda *a: {
            k: v for k, v in edges(*a).items() if k != leaf})
    elif name == "x_proj_backward_sum":
        patch(layers._SumF32, "backward", staticmethod(
            lambda ctx, g: (g.to(ctx.args[2]), None, None, None)))
    elif name == "memory_tp_in":
        patch(encdec, "memory_in", lambda memory, cfg: memory)
    else:
        raise ValueError(name)
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)


def _adam_run(model, params, batches, region):
    """Step 0's (loss, grads) and 3 Adam steps under ``region()``:
    (losses, grads, params, opt_state), detached."""
    import torch
    from repro_torch._tree import tree_map
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.optim import make_optimizer, step_inplace
    opt = make_optimizer("adam", lr=LR)
    state = opt.init(params)
    losses, first = [], None
    for s in range(STEPS):
        with region():
            loss, g = loss_and_grads(model, params, _torch_batch(batches[s]))
        losses.append(float(loss))
        if first is None:
            first = tree_map(lambda t: t.detach().clone(), g)
        with torch.no_grad():
            step_inplace(opt, params, g, state, s)
    detach = (lambda t: t.detach().clone())
    return losses, first, tree_map(detach, params), tree_map(detach, state)


def _dp_edge_run(model, cfg, tree, batches, rank: int, group, data_group):
    """3 steps of the int8_fused synced step on the rank's one-rank data
    group under the region, planned with the leaves' sharing classes: the
    final parameters, the plan's buckets and each leaf's class."""
    import torch
    from repro_torch._tree import tree_map
    from repro_torch.convert import (params_from_jax, train_classes,
                                     train_slice)
    from repro_torch.core.grad_sync import SyncConfig
    from repro_torch.launch.steps import make_comm_optimized_train_step
    from repro_torch.models.sharding_ctx import train_region
    from repro_torch.optim import make_optimizer
    params = train_slice(params_from_jax(tree, cfg, "cpu"), cfg, rank, WORLD)
    classes = train_classes(params, cfg, rank, WORLD)
    opt = make_optimizer("adam", lr=LR)
    wire = SyncConfig(compressor="int8_fused", bucket_bytes=1 << 15,
                      classes=classes)
    step, sync, init_sync = make_comm_optimized_train_step(
        model, opt, wire, data_group)
    with train_region(group, "tree"):
        state, sync_state = opt.init(params), init_sync(params)
        for s in range(STEPS):
            step(params, state, sync_state, _torch_batch(batches[s]), s)
    return {"params": tree_map(lambda t: t.detach().clone(), params),
            "buckets": [b.leaves for b in sync.plan.buckets],
            "classes": classes}


def _worker(rank: int, world: int, store: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.convert import params_from_jax, train_slice
    from repro_torch.launch.dist import init_group
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.model import Model
    from repro_torch.models.sharding_ctx import train_region
    torch.set_num_threads(1)
    init_group(torch.device("cpu"), world_size=world, rank=rank,
               store_path=store)
    group = dist.group.WORLD
    ones = [dist.new_group([r]) for r in range(world)]
    out = {}
    for case in CASES:
        cfg = _cfg(case)
        with open(os.path.join(out_dir, f"{case}.pkl"), "rb") as f:
            tree = pickle.load(f)
        model = Model(cfg)
        batches = _batches(case)

        def share():
            return train_slice(params_from_jax(tree, cfg, "cpu"), cfg, rank,
                               WORLD)
        res = dict(zip(("losses", "grads", "params", "state"), _adam_run(
            model, share(), batches, lambda: train_region(group, "tree"))))
        for c, name, _ in NEGATIVE:
            if c == case:
                with _without(name), train_region(group, "tree"):
                    res[name] = loss_and_grads(
                        model, share(), _torch_batch(batches[0]))[1]
        res["dp_edge"] = _dp_edge_run(model, cfg, tree, batches, rank,
                                      group, ones[rank])
        out[case] = res
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _references(case: str):
    """The JAX package's step-0 (loss, grads), the unsharded port's, and
    the blocked control's 3 Adam steps, on the case's weights."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.models import Model as JModel
    from repro_torch.convert import params_from_jax, to_numpy
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.model import Model
    from repro_torch.models.sharding_ctx import blocked_region
    tree = _weights(case)
    batches = _batches(case)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        JModel(_cfg(case, jax_side=True)).loss))(
        tree, {k: jnp.asarray(v) for k, v in batches[0].items()})
    cfg = _cfg(case)
    model = Model(cfg)
    loss, grads = loss_and_grads(model, params_from_jax(tree, cfg, "cpu"),
                                 _torch_batch(batches[0]))
    blocked = _adam_run(model, params_from_jax(tree, cfg, "cpu"), batches,
                        lambda: blocked_region(WORLD))
    return {"jax": (float(jloss), jax.tree.map(np.asarray, jgrads)),
            "port": (float(loss), to_numpy(grads)), "blocked": blocked}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The ranks' results and the references: the world runs in a thread
    while this process computes the references."""
    import threading
    import torch
    from repro_torch.launch.dist import spawn
    out = tmp_path_factory.mktemp("train_tp_families")
    for case in CASES:
        with open(out / f"{case}.pkl", "wb") as f:
            pickle.dump(_weights(case), f)
    failed = []

    def world():
        try:
            spawn(_worker, WORLD, args=(str(out),), timeout=300)
        except Exception as e:          # re-raised below
            failed.append(e)
    thread = threading.Thread(target=world)
    thread.start()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        refs = {case: _references(case) for case in CASES}
    finally:
        torch.set_num_threads(n)
        thread.join()
    if failed:
        raise failed[0]
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return refs, ranks


def _gap(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _share_tree(tree, case: str, rank: int):
    """Rank ``rank``'s share of a whole tree (tensors or numpy)."""
    import torch
    from repro_torch._tree import tree_map
    from repro_torch.convert import train_slice
    t = tree_map(lambda a: a if isinstance(a, torch.Tensor)
                 else torch.from_numpy(np.array(a)), tree)
    return train_slice(t, _cfg(case), rank, WORLD)


def _share(tree, case: str, rank: int):
    """:func:`_share_tree` as a list of numpy leaves in the port's leaf
    order."""
    from repro_torch._tree import tree_leaves
    return [x.numpy() for x in tree_leaves(_share_tree(tree, case, rank))]


def _leaves(tree):
    from repro_torch._tree import tree_leaves
    return [np.asarray(x) for x in tree_leaves(tree)]


@pytest.mark.parametrize("case", list(CASES))
def test_rank_gradients_match_unsharded_and_reference(trained, case):
    refs, ranks = trained
    ref = refs[case]
    ploss, pgrads = ref["port"]
    jloss, jgrads = ref["jax"]
    for r, mine in enumerate(ranks):
        losses = mine[case]["losses"]
        assert abs(losses[0] - ploss) <= REL_PORT * abs(ploss)
        assert abs(losses[0] - jloss) <= REL_JAX * abs(jloss)
        got = _leaves(mine[case]["grads"])
        for want, rel in ((pgrads, REL_PORT), (jgrads, REL_JAX)):
            share = _share(want, case, r)
            assert len(got) == len(share)
            for i, (a, b) in enumerate(zip(got, share)):
                assert _gap(a, b) <= rel, (case, r, i, _gap(a, b), rel)


def _holders(case: str):
    """For each leaf (by index), the groups of ranks holding the same
    block of it: ranks whose shares of a position-coded tree agree."""
    import torch
    from repro_torch._tree import tree_map
    coded = tree_map(lambda a: torch.arange(a.size, dtype=torch.float64)
                     .reshape(a.shape), _weights(case))
    shares = [_share(coded, case, r) for r in range(WORLD)]
    out = []
    for i in range(len(shares[0])):
        groups = {}
        for r in range(WORLD):
            groups.setdefault(shares[r][i].tobytes(), []).append(r)
        out.append([g for g in groups.values() if len(g) > 1])
    return out


def _shared_equal(leaves, holders, what) -> int:
    checked = 0
    for i, groups in enumerate(holders):
        for g in groups:
            checked += 1
            for r in g[1:]:
                assert np.array_equal(leaves[r][i], leaves[g[0]][i]), \
                    (what, i, g)
    return checked


@pytest.mark.parametrize("case", list(CASES))
def test_shared_leaves_bit_equal_on_their_ranks(trained, case):
    _, ranks = trained
    holders = _holders(case)
    shared = sum(_shared_equal([_leaves(r[case][key]) for r in ranks],
                               holders, (case, key))
                 for key in ("grads", "params"))
    assert shared > 2 * 3


@pytest.mark.parametrize("case", list(CASES))
def test_adam_steps_bit_equal_to_the_blocked_control(trained, case):
    refs, ranks = trained
    losses, grads, params, state = refs[case]["blocked"]
    for r, mine in enumerate(ranks):
        assert mine[case]["losses"] == losses
        for key, want in (("grads", grads), ("params", params),
                          ("m", state["m"]), ("v", state["v"])):
            got = _leaves(mine[case]["state"][key] if key in "mv"
                          else mine[case][key])
            share = _share(want, case, r)
            assert len(got) == len(share)
            for i, (a, b) in enumerate(zip(got, share)):
                assert np.array_equal(a, b), (case, r, key, i)


@pytest.mark.parametrize("case,name,path", NEGATIVE)
def test_without_the_sum_the_gradient_is_wrong(trained, case, name, path):
    refs, ranks = trained
    _, pgrads = refs[case]["port"]

    def pick(tree):
        for k in path:
            tree = tree[k]
        return np.asarray(tree)
    for r, mine in enumerate(ranks):
        want = pick(_share_tree(pgrads, case, r))
        assert pick(mine[case][name]).shape == want.shape
        assert _gap(pick(mine[case][name]), want) > REL_WRONG
        assert _gap(pick(mine[case]["grads"]), want) <= REL_PORT


@pytest.mark.parametrize("case", list(CASES))
def test_int8_dp_edge_keeps_shared_leaves_bit_equal(trained, case):
    """The int8_fused DP edge on each rank's one-rank data group, planned
    with the sharing classes: no bucket packs two classes, and after 3
    steps every leaf that several ranks hold is bit-equal on them."""
    _, ranks = trained
    runs = [r[case]["dp_edge"] for r in ranks]
    for run in runs:
        for b in run["buckets"]:
            assert len({run["classes"][i] for i in b}) == 1
        assert len(set(run["classes"])) > 1
    assert _shared_equal([_leaves(run["params"]) for run in runs],
                         _holders(case), (case, "dp edge"))