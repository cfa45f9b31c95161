"""Training the grouped-query families under the reference's model-axis
layout (``sharding_ctx.train_region``): head-parallel attention with its
backward, the vocab-parallel embedding and cross-entropy, the dense FFNs'
ffn slice and the experts in blocks, and the replica edge over the
leaves that several ranks hold but each reads only through its own heads.

  * One spawned gloo world of 4 (``FileStore`` under a temporary
    directory, one thread a process) runs every case of ``CASES`` at a
    small size in f32, the world as the model axis (tp = 4): the rank's
    share of the case's numpy weights (``convert.train_slice``), its
    gradients under the region (``launch/steps.loss_and_grads``) and 3
    Adam steps.  The region's sums run on the ``tree`` all-reduce, whose
    order over the ranks the control repeats (gloo's own all-reduce of
    four ranks sums in an order of its own).
  * Each case's loss and every leaf's gradient (the rank's block) equal
    the unsharded port's within ``REL_PORT`` (the ranks' partial sums add
    in another order) and ``jax.value_and_grad`` of the JAX package's
    ``Model.loss`` on the same weights within ``REL_JAX``, each relative
    to the leaf's largest magnitude.
  * Every leaf that several ranks hold the same (the norms, the router,
    the kv columns of a shared kv head, a head block held by two ranks,
    the QK-norm scales) has bit-equal gradients and, after the steps,
    bit-equal parameters on those ranks.
  * The 3 Adam steps are bit-equal to the port's blocked control
    (``sharding_ctx.blocked_region(4)``: one process with the whole
    weights, each head block, ffn slice, expert block and vocabulary
    block computed apart and summed in the tree's order): parameters,
    both moments and the losses.
  * The int8_fused DP edge on each rank's one-rank data group, planned
    with the leaves' sharing classes (``SyncConfig.classes``), packs no
    bucket across two classes and keeps the shared leaves bit-equal;
    without the classes the step under the region is refused.
  * Negative controls: with the replica edge taken out
    (``attention.attn_replica_edge`` an identity), gemma-2b's ``wk`` (one
    kv head shared by every rank) and gemma3-4b's ``q_norm`` get
    gradients more than ``REL_WRONG`` from the unsharded port's; and the
    vocab-parallel loss (``layers.softmax_xent_tp``) equals
    ``softmax_xent`` of the whole logits within ``ABS_XENT``, labels
    masked with -1 included.
"""
from __future__ import annotations

import dataclasses
import math
import os
import pickle

import numpy as np
import pytest

REL_PORT = 1e-5
REL_JAX = 1e-4
REL_WRONG = 1e-2
ABS_XENT = 1e-6
WORLD = 4
STEPS = 3
LR = 1e-2
BATCH, SEQ = 2, 32
BASE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=512, param_dtype="float32",
            compute_dtype="float32")
# name: (architecture, overrides)
CASES = {
    # MQA and the tied table: the one kv head on every rank
    "gemma-2b": ("gemma-2b", dict(num_kv_heads=1)),
    # H = 2 below tp = 4: each head block on two ranks, replica 1 muted
    "gemma-2b-h2": ("gemma-2b", dict(num_heads=2, num_kv_heads=1)),
    # windows, both softcaps, the untied head; each kv head on two ranks
    "gemma2-9b": ("gemma2-9b", dict(window_size=16)),
    # QK-norm, windows
    "gemma3-4b": ("gemma3-4b", dict(window_size=16)),
    # heads over tp and one expert a rank over the same group
    "qwen3-moe": ("qwen3-moe-30b-a3b", dict(num_experts=4, top_k=2,
                                           moe_d_ff=32)),
}
# (case, leaf of the first attention layer) the replica edge must sum
WRONG = [("gemma-2b", "wk"), ("gemma3-4b", "q_norm")]
# the case whose int8_fused DP edge runs under the region (small buckets,
# so that every bucket holds several leaves)
DP_EDGE_CASE = "gemma2-9b"


def _cfg(case: str, jax_side: bool = False):
    if jax_side:
        from repro.configs import get_config
    else:
        from repro_torch.configs import get_config
    arch, over = CASES[case]
    return dataclasses.replace(get_config(arch), **{**BASE, **over})


def _weights(case: str):
    """The case's weights as a numpy tree in the JAX package's layout,
    drawn from a numpy seed by each leaf's init kind."""
    from repro_torch._tree import tree_map
    from repro_torch.models.layers import ParamDesc
    from repro_torch.models.model import Model
    rng = np.random.default_rng(200 + len(case))

    def draw(d: ParamDesc):
        if d.init in ("zeros", "ones"):
            # the norms' deltas drawn too, so a wrong sum shows in them
            return (rng.standard_normal(d.shape) * 0.1).astype(np.float32)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        scale = 0.02 if d.init == "small" else 1.0 / math.sqrt(fan_in)
        return (rng.standard_normal(d.shape) * scale).astype(np.float32)
    return tree_map(draw, Model(_cfg(case)).param_desc(),
                    is_leaf=lambda x: isinstance(x, ParamDesc))


def _tokens(case: str) -> np.ndarray:
    """(STEPS, BATCH, SEQ) int32 token batches."""
    rng = np.random.default_rng(300 + len(case))
    return rng.integers(0, _cfg(case).vocab_size,
                        (STEPS, BATCH, SEQ)).astype(np.int32)


def _adam_run(model, params, tokens, region):
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
            loss, g = loss_and_grads(
                model, params, {"tokens": torch.from_numpy(tokens[s]).long()})
        losses.append(float(loss))
        if first is None:
            first = tree_map(lambda t: t.detach().clone(), g)
        with torch.no_grad():
            step_inplace(opt, params, g, state, s)
    detach = (lambda t: t.detach().clone())
    return losses, first, tree_map(detach, params), tree_map(detach, state)


def _dp_edge_run(model, cfg, tree, tokens, rank: int, group, data_group):
    """3 steps of the int8_fused synced step on the rank's one-rank data
    group under the region with the leaves' sharing classes
    (``SyncConfig.classes``): the final parameters, the plan's buckets
    with each leaf's class, and the message with which the same step
    without the classes is refused."""
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
    wire = SyncConfig(compressor="int8_fused", bucket_bytes=1 << 16)
    batches = [{"tokens": torch.from_numpy(t).long()} for t in tokens]
    step, _, init_sync = make_comm_optimized_train_step(
        model, opt, wire, data_group)
    refused = None
    with train_region(group, "tree"):
        try:
            step(params, opt.init(params), init_sync(params), batches[0], 0)
        except ValueError as e:
            refused = str(e)
    step, sync, init_sync = make_comm_optimized_train_step(
        model, opt, dataclasses.replace(wire, classes=classes), data_group)
    with train_region(group, "tree"):
        state, sync_state = opt.init(params), init_sync(params)
        for s in range(STEPS):
            step(params, state, sync_state, batches[s], s)
    return {"params": tree_map(lambda t: t.detach().clone(), params),
            "buckets": [b.leaves for b in sync.plan.buckets],
            "classes": classes, "refused": refused}


def _worker(rank: int, world: int, store: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.convert import params_from_jax, train_slice
    from repro_torch.launch.dist import init_group
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import attention
    from repro_torch.models.layers import softmax_xent, softmax_xent_tp
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
        params = train_slice(params_from_jax(tree, cfg, "cpu"), cfg, rank,
                             WORLD)
        tokens = _tokens(case)
        res = dict(zip(("losses", "grads", "params", "state"), _adam_run(
            model, params, tokens, lambda: train_region(group, "tree"))))
        if any(c == case for c, _ in WRONG):
            fresh = train_slice(params_from_jax(tree, cfg, "cpu"), cfg, rank,
                                WORLD)
            edge = attention.attn_replica_edge
            attention.attn_replica_edge = lambda params, cfg, ta: params
            try:
                with train_region(group, "tree"):
                    _, res["no_edge"] = loss_and_grads(
                        model, fresh, {"tokens": torch.from_numpy(tokens[0])
                                       .long()})
            finally:
                attention.attn_replica_edge = edge
        if case == DP_EDGE_CASE:
            res["dp_edge"] = _dp_edge_run(model, cfg, tree, tokens, rank,
                                          group, ones[rank])
        out[case] = res
    # the vocab-parallel loss against the whole logits' softmax_xent
    rng = np.random.default_rng(7)
    logits = torch.from_numpy(rng.standard_normal((3, 9, 64))
                              .astype(np.float32) * 4)
    labels = torch.from_numpy(rng.integers(-1, 64, (3, 9)))
    mask = labels >= 0
    block = logits.narrow(-1, rank * 16, 16)
    out["xent"] = (float(softmax_xent_tp(block, labels.clamp_min(0), mask,
                                         group, "tree")),
                   float(softmax_xent(logits, labels.clamp_min(0), mask)),
                   int((~mask).sum()))
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
    tokens = _tokens(case)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        JModel(_cfg(case, jax_side=True)).loss))(
        tree, {"tokens": jnp.asarray(tokens[0])})
    cfg = _cfg(case)
    model = Model(cfg)
    loss, grads = loss_and_grads(model, params_from_jax(tree, cfg, "cpu"),
                                 {"tokens": torch.from_numpy(tokens[0])
                                  .long()})
    blocked = _adam_run(model, params_from_jax(tree, cfg, "cpu"), tokens,
                        lambda: blocked_region(WORLD))
    return {"tree": tree, "jax": (float(jloss), jax.tree.map(np.asarray,
                                                              jgrads)),
            "port": (float(loss), to_numpy(grads)), "blocked": blocked}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    import torch
    from repro_torch.launch.dist import spawn
    out = tmp_path_factory.mktemp("train_tp")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        refs = {}
        for case in CASES:
            refs[case] = _references(case)
            with open(out / f"{case}.pkl", "wb") as f:
                pickle.dump(refs[case]["tree"], f)
    finally:
        torch.set_num_threads(n)
    spawn(_worker, WORLD, args=(str(out),), timeout=300)
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


def _share(tree, case: str, rank: int):
    """Rank ``rank``'s share of a whole tree (tensors or numpy) as a list
    of numpy leaves in the port's leaf order."""
    import torch
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.convert import train_slice
    t = tree_map(lambda a: a if isinstance(a, torch.Tensor)
                 else torch.from_numpy(np.array(a)), tree)
    return [x.numpy() for x in tree_leaves(train_slice(t, _cfg(case), rank,
                                                       WORLD))]


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


@pytest.mark.parametrize("case", list(CASES))
def test_shared_leaves_bit_equal_on_their_ranks(trained, case):
    _, ranks = trained
    holders = _holders(case)
    shared = 0
    for key in ("grads", "params"):
        leaves = [_leaves(r[case][key]) for r in ranks]
        for i, groups in enumerate(holders):
            for g in groups:
                shared += 1
                for r in g[1:]:
                    assert np.array_equal(leaves[r][i], leaves[g[0]][i]), \
                        (case, key, i, g)
    # the norms at least, and in every case some attention leaf
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


@pytest.mark.parametrize("case,leaf", WRONG)
def test_without_the_replica_edge_the_shared_gradient_is_wrong(trained, case,
                                                               leaf):
    refs, ranks = trained
    _, pgrads = refs[case]["port"]

    def pick(tree):
        g = tree["stack"][0][0]["mixer"][leaf]
        return np.asarray(g["scale"] if isinstance(g, dict) else g)
    for r, mine in enumerate(ranks):
        want = pick(pgrads)
        if leaf == "wk":          # the one kv head, whole on every rank
            assert pick(mine[case]["grads"]).shape == want.shape
        assert _gap(pick(mine[case]["no_edge"]), want) > REL_WRONG
        assert _gap(pick(mine[case]["grads"]), want) <= REL_PORT


def test_int8_dp_edge_keeps_shared_leaves_bit_equal(trained):
    """The int8_fused DP edge on each rank's one-rank data group, planned
    with the sharing classes (``SyncConfig.classes`` from
    ``convert.train_classes``):
    no bucket packs two classes, and after 3 steps every leaf that
    several ranks hold is bit-equal on them (an int8 tile that coded a
    shared leaf with a rank's own block would scale it by that block)."""
    _, ranks = trained
    holders = _holders(DP_EDGE_CASE)
    runs = [r[DP_EDGE_CASE]["dp_edge"] for r in ranks]
    for run in runs:
        assert len({run["classes"][i] for b in run["buckets"]
                    for i in b}) == len(set(run["classes"])) > 1
        for b in run["buckets"]:
            assert len({run["classes"][i] for i in b}) == 1
        assert any(len(b) > 1 for b in run["buckets"])
    leaves = [_leaves(run["params"]) for run in runs]
    checked = 0
    for i, groups in enumerate(holders):
        for g in groups:
            checked += 1
            for r in g[1:]:
                assert np.array_equal(leaves[r][i], leaves[g[0]][i]), (i, g)
    assert checked


def test_int8_dp_edge_without_classes_is_refused(trained):
    """The same packed int8_fused step under the region without
    ``SyncConfig.classes`` raises before it computes anything, on every
    rank."""
    _, ranks = trained
    for r in ranks:
        assert "needs SyncConfig.classes" in r[DP_EDGE_CASE]["dp_edge"][
            "refused"]


def test_vocab_parallel_loss_equals_softmax_xent(trained):
    _, ranks = trained
    tp, whole, masked = ranks[0]["xent"]
    assert masked > 0
    assert abs(tp - whole) <= ABS_XENT
    assert all(r["xent"][0] == tp for r in ranks)
