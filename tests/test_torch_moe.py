"""The port's MoE FFN (``repro_torch.models.moe``) and the four model
families of its slice (qwen3-moe-30b-a3b, deepseek-v2-lite-16b,
deepseek-67b, chameleon-34b) against the JAX package, on the same
weights (``params_from_jax``) and numpy-made inputs, reduced, in f32.

Tolerances, each relative to the largest magnitude of the reference's
tensor: ``moe_ffn`` and ``moe_decode_ffn`` outputs and the aux loss 1e-5
(one layer, the same op order; two frameworks' f32 matmuls); their
gradients 1e-5; a whole model's loss 1e-5, its gradients, prefill and
decode logits 1e-4 (the model tests' bound: the slack covers the two
frameworks' matmul and transcendental kernels compounded over two
layers).  Routing is held EXACTLY: the same expert choices, the same
keep mask and the same drop tap counts.  ``jax.lax.top_k`` and
``torch.topk`` may order ties differently; a tie at these sizes would
make a test name the token, not widen a bound.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.models import moe as jmoe
from repro.models.layers import mlp as jmlp
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs import ALL_ARCHS, NOT_PORTED, get_config, reduced
from repro_torch.convert import params_from_jax, to_numpy
from repro_torch.models import Model, count_params
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer
from repro_torch.models.layers import mlp as tmlp

MOE_ARCHS = ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b")
NEW_ARCHS = MOE_ARCHS + ("deepseek-67b", "chameleon-34b")
REL_LAYER = 1e-5
REL_MODEL = 1e-4


def _close(a, b, rel):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.abs(b).max(), 1e-30)
    err = np.abs(a - b).max()
    assert err <= rel * scale, f"max|Δ|={err:.3e} > {rel}·{scale:.3e}"


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _plan(cfg):
    return [([dataclasses.asdict(p) for p in s.period], s.repeats)
            for s in cfg.stack_plan()]


# ---------------------------------------------------------------------------
# configs and the registry
# ---------------------------------------------------------------------------

# the reference's num_params() at full width, in billions
FULL_PARAMS_B = {"qwen3-moe-30b-a3b": 30.53, "deepseek-v2-lite-16b": 15.65,
                 "chameleon-34b": 34.29, "deepseek-67b": 67.43}


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_copy_and_param_count_match_reference(arch):
    for full in (False, True):
        j, t = jget_config(arch), get_config(arch)
        if not full:
            j, t = jreduced(j), reduced(t)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert _plan(t) == _plan(j)
        assert count_params(t) == j.num_params()
    assert round(count_params(get_config(arch)) / 1e9, 2) == \
        FULL_PARAMS_B[arch]


def test_registry_and_plans():
    from repro.configs import ALL_ARCHS as J_ALL
    assert NOT_PORTED == ()
    assert ALL_ARCHS == J_ALL
    assert set(NEW_ARCHS) <= set(ALL_ARCHS)
    plans = {a: [(tuple((s.mixer, s.ffn) for s in seg.period), seg.repeats)
                 for seg in get_config(a).stack_plan()] for a in MOE_ARCHS}
    assert plans["deepseek-v2-lite-16b"] == [((("mla", "dense"),), 1),
                                             ((("mla", "moe"),), 26)]
    assert plans["qwen3-moe-30b-a3b"] == [((("attn", "moe"),), 48)]


# ---------------------------------------------------------------------------
# moe_ffn / moe_decode_ffn
# ---------------------------------------------------------------------------

def _moe_layer(arch, capacity_factor, seed=0):
    """(jcfg, cfg, JAX ffn params (numpy), port ffn params) of the reduced
    model's first MoE layer."""
    jcfg = dataclasses.replace(jreduced(jget_config(arch)),
                               capacity_factor=capacity_factor)
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              capacity_factor=capacity_factor)
    tree = jax.tree.map(np.asarray, JModel(jcfg).init(
        jax.random.PRNGKey(seed)))
    params = params_from_jax(tree, cfg, device="cpu")
    for si, seg in enumerate(cfg.stack_plan()):
        if seg.period[0].ffn == "moe":
            jp, tp = tree["stack"][si][0]["ffn"], params["stack"][si][0]["ffn"]
            if seg.repeats > 1:
                jp = jax.tree.map(lambda a: a[0], jp)
                tp = tree_map(lambda a: a[0], tp)
            # a router of unit scale, so that choices are far from ties
            rng = np.random.default_rng(seed + 7)
            r = rng.standard_normal(jp["router"].shape).astype(np.float32)
            jp = dict(jp, router=r)
            tp = dict(tp, router=_t(r))
            return jcfg, cfg, jp, tp
    raise AssertionError(f"{arch} has no MoE layer")


def _jax_keep(jcfg, jp, x):
    """The reference's routing and keep mask (``moe_ffn``'s lines, G = 1)."""
    xf = jnp.asarray(x).reshape(-1, jcfg.d_model)
    w, e, _ = jmoe._route(jcfg, xf @ jnp.asarray(jp["router"]))
    N, k, E = xf.shape[0], jcfg.top_k, jcfg.num_experts
    cap = int(max(1, N * k / E * jcfg.capacity_factor))
    onehot = jax.nn.one_hot(e.reshape(1, N * k), E, dtype=jnp.int32)
    slot = ((jnp.cumsum(onehot, axis=1) - 1) * onehot).sum(-1)
    return np.asarray(e), np.asarray(slot < cap)


def _ties(jcfg, jp, x) -> list:
    """Tokens whose k-th and (k+1)-th router probabilities are equal."""
    xf = np.asarray(x).reshape(-1, jcfg.d_model)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(xf) @ jnp.asarray(
        jp["router"]), axis=-1))
    srt = -np.sort(-probs, axis=-1)
    k = jcfg.top_k
    return [i for i in range(len(srt)) if k < srt.shape[1]
            and srt[i, k - 1] == srt[i, k]]


MOE_CASES = [(a, cf) for a in MOE_ARCHS for cf in (1.25, 0.5)]


@pytest.mark.parametrize("arch,capacity_factor", MOE_CASES)
def test_moe_ffn_matches_reference(arch, capacity_factor):
    jcfg, cfg, jp, tp = _moe_layer(arch, capacity_factor)
    assert bool(cfg.num_shared_experts) == (arch == "deepseek-v2-lite-16b")
    x = np.random.default_rng(1).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    assert not _ties(jcfg, jp, x)
    experts, keep = _jax_keep(jcfg, jp, x)

    old_j, old_t = jmoe.enable_drop_tap(True), tmoe.enable_drop_tap(True)
    try:
        jmoe.drain_drop_tap()
        tmoe.drain_drop_tap()
        jout, jaux = jax.jit(lambda p, x: jmoe.moe_ffn(p, jcfg, x))(
            jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
        jout.block_until_ready()
        jtap = jmoe.drain_drop_tap()
        out, aux = tmoe.moe_ffn(tp, cfg, _t(x))
        ttap = tmoe.drain_drop_tap()
    finally:
        jmoe.enable_drop_tap(old_j)
        tmoe.enable_drop_tap(old_t)

    _, texperts, _ = tmoe._route(cfg, _t(x).reshape(-1, cfg.d_model)
                                 @ tp["router"])
    bad = np.nonzero((texperts.numpy() != experts).any(-1))[0]
    assert not len(bad), f"tokens {bad.tolist()} route differently"
    N, k, E = 48, cfg.top_k, cfg.num_experts
    cap = int(max(1, N * k / E * capacity_factor))
    _, tkeep = tmoe.dispatch_plan(texperts, E, 1, cap)
    bad = np.nonzero(tkeep.numpy() != keep)[1]
    assert not len(bad), f"(token, choice) {bad.tolist()} keep differently"
    assert ttap == jtap
    assert ttap[1] == N * k
    if capacity_factor < 1:
        assert ttap[0] > 0        # the small capacity does drop
    _close(out, jout, REL_LAYER)
    _close(aux, jaux, REL_LAYER)


@pytest.mark.parametrize("arch,capacity_factor", MOE_CASES[::3])
def test_moe_ffn_grads_match_jax(arch, capacity_factor):
    jcfg, cfg, jp, tp = _moe_layer(arch, capacity_factor)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)

    def jf(p, x):
        out, aux = jmoe.moe_ffn(p, jcfg, x)
        return jnp.sum(out * cot) + 3.0 * aux

    jg_p, jg_x = jax.jit(jax.grad(jf, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    tp = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    tx = _t(x).requires_grad_(True)
    out, aux = tmoe.moe_ffn(tp, cfg, tx)
    (torch.sum(out * _t(cot)) + 3.0 * aux).backward()
    _close(tx.grad, jg_x, REL_LAYER)
    flat_j = jax.tree_util.tree_leaves_with_path(jg_p)
    assert len(flat_j) == len(tree_leaves(tp))
    for (path, g), t in zip(flat_j, tree_leaves(tp)):
        _close(t.grad, g, REL_LAYER)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_ffn_matches_reference(arch):
    jcfg, cfg, jp, tp = _moe_layer(arch, 1.25)
    x = np.random.default_rng(3).standard_normal(
        (3, 1, cfg.d_model)).astype(np.float32)
    jout = jmoe.moe_decode_ffn(jax.tree.map(jnp.asarray, jp), jcfg,
                               jnp.asarray(x))
    _close(tmoe.moe_decode_ffn(tp, cfg, _t(x)), jout, REL_LAYER)


def test_moe_routing_mass_conservation():
    """Identical experts and normalized router weights: the MoE FFN is the
    dense MLP of one expert (the reference's check, ported; nothing is
    dropped at capacity factor 8)."""
    cfg = dataclasses.replace(reduced(get_config("qwen3-moe-30b-a3b")),
                              capacity_factor=8.0)
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    seg = tree_map(lambda a: a[0], params["stack"][0][0]["ffn"])
    for k in ("wi_gate", "wi_up", "wo"):
        seg[k] = seg[k][:1].expand(seg[k].shape).clone()
    x = torch.randn((2, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)) * 0.3
    out, aux = tmoe.moe_ffn(seg, cfg, x)
    dense = tmlp({k: seg[k][0] for k in ("wi_gate", "wi_up", "wo")}, x,
                 cfg.activation)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), rtol=2e-2,
                               atol=2e-2)
    assert torch.isfinite(aux)
    # and the reference's own function agrees on the same inputs
    jcfg = dataclasses.replace(jreduced(jget_config("qwen3-moe-30b-a3b")),
                               capacity_factor=8.0)
    jout, _ = jmoe.moe_ffn(jax.tree.map(jnp.asarray, to_numpy(seg)), jcfg,
                           jnp.asarray(x.numpy()))
    _close(out, jout, REL_LAYER)
    jdense = jmlp({k: jnp.asarray(seg[k][0].numpy())
                   for k in ("wi_gate", "wi_up", "wo")},
                  jnp.asarray(x.numpy()), cfg.activation)
    _close(dense, jdense, REL_LAYER)


def test_moe_ep_axis_of_one_rank_matches_reference_and_refuses():
    """Expert parallelism on a one-rank ep group (the exchanges move
    nothing): the reference's function on the same inputs, and the
    reference's refusals (more than one token group per rank; a block that
    is not this rank's ``E/ep`` experts).  ``tests/test_torch_tp_ep.py``
    holds ep = 2 against the reference's EP check."""
    from repro_torch.convert import experts_slice
    from repro_torch.launch.dist import init_group
    init_group(torch.device("cpu"))
    jcfg, cfg, jp, tp = _moe_layer("qwen3-moe-30b-a3b", 1.25)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32))
    for variant in ("direct", "ring"):
        out, aux = tmoe.moe_ffn(experts_slice(tp, 0, 1), cfg, x,
                                ep_axis=torch.distributed.group.WORLD,
                                a2a_variant=variant)
        jout, jaux = jmoe.moe_ffn(jax.tree.map(jnp.asarray, jp), jcfg,
                                  jnp.asarray(x.numpy()))
        _close(out, jout, REL_LAYER)
        _close(aux, jaux, REL_LAYER)
    with pytest.raises(ValueError, match="one token group per rank"):
        tmoe.moe_ffn(tp, cfg, x, groups=2,
                     ep_axis=torch.distributed.group.WORLD)
    with pytest.raises(ValueError, match="LOCAL expert block"):
        tmoe.moe_ffn(experts_slice(tp, 0, 2), cfg, x,
                     ep_axis=torch.distributed.group.WORLD)


def test_drop_tap_counts_once_through_checkpointed_blocks():
    """The training stack checkpoints every block: the recomputation in
    the backward must not count a routed choice twice."""
    cfg = dataclasses.replace(reduced(get_config("qwen3-moe-30b-a3b")),
                              capacity_factor=0.5)
    model = Model(cfg)
    params = tree_map(lambda t: t.requires_grad_(True), model.init(
        torch.Generator().manual_seed(0)))
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    old = tmoe.enable_drop_tap(True)
    try:
        tmoe.drain_drop_tap()
        model.loss(params, {"tokens": tokens}).backward()
        dropped, routed = tmoe.drain_drop_tap()
    finally:
        tmoe.enable_drop_tap(old)
    assert routed == cfg.num_layers * 32 * cfg.top_k
    assert 0 < dropped < routed


# ---------------------------------------------------------------------------
# the four models: loss, gradients, prefill and decode
# ---------------------------------------------------------------------------

def _model_pair(arch, **over):
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), **over)
    cfg = dataclasses.replace(reduced(get_config(arch)), **over)
    jmodel = JModel(jcfg)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(3)))
    # random norm scales (they init to 0), so QK-norm and MLA's kv_norm count
    rng = np.random.default_rng(4)

    def scales(path, a):
        keys = [getattr(p, "key", None) for p in path]
        if "scale" in keys and any(k in ("q_norm", "k_norm", "kv_norm")
                                   for k in keys):
            return (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    tree = jax.tree_util.tree_map_with_path(scales, tree)
    params = params_from_jax(tree, cfg, device="cpu")
    return jcfg, jmodel, jax.tree.map(jnp.asarray, tree), cfg, Model(cfg), \
        params


@pytest.fixture(scope="module", params=NEW_ARCHS)
def pair(request):
    return _model_pair(request.param)


def test_loss_and_grads_match_jax(pair):
    jcfg, jmodel, jparams, cfg, model, params = pair
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    jl, jg = jax.jit(jax.value_and_grad(jmodel.loss))(
        jparams, {"tokens": jnp.asarray(tokens)})
    tp = tree_map(lambda t: t.clone().requires_grad_(True), params)
    loss = model.loss(tp, {"tokens": _t(tokens).long()})
    loss.backward()
    _close(loss.detach(), jl, REL_LAYER)
    jleaves = jax.tree.leaves(jg)
    tleaves = tree_leaves(tp)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        _close(a.grad, b, REL_MODEL)
    if cfg.num_experts:
        # the aux loss is in: the loss is not the plain cross-entropy
        h, aux = model._backbone_train(params, {"tokens": _t(tokens).long()})
        assert float(aux) > 0.5


def test_prefill_and_decode_match_jax(pair):
    jcfg, jmodel, jparams, cfg, model, params = pair
    rng = np.random.default_rng(6)
    B, T, ML, steps = 2, 12, 20, 3
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (steps, B, 1)).astype(np.int32)
    jprefill = jax.jit(jmodel.prefill, static_argnames=("max_len",))
    jdecode = jax.jit(jmodel.decode_step,
                      static_argnames=("mla_absorb", "moe_dispatch"))
    jl, jc = jprefill(jparams, {"tokens": jnp.asarray(tokens)}, max_len=ML)
    tl, tc = model.prefill(params, {"tokens": _t(tokens).long()}, max_len=ML)
    _close(tl, jl, REL_MODEL)
    for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        assert tuple(a.shape) == b.shape
        _close(a, b, REL_MODEL)
    variants = [dict()]
    if cfg.num_experts:
        variants.append(dict(moe_dispatch=True))
    if cfg.use_mla:
        variants.append(dict(mla_absorb=True))
    for kw in variants:
        for pos_of in (lambda i: T + i,
                       lambda i: np.array([T + i, T - 4 + i], np.int32)):
            jcs, tcs = jc, tc
            for i in range(steps):
                pos = pos_of(i)
                tpos = _t(pos).long() if isinstance(pos, np.ndarray) else pos
                jl, jcs = jdecode(jparams, jnp.asarray(forced[i]), jcs,
                                  jnp.asarray(pos, jnp.int32), **kw)
                tl, tcs = model.decode_step(params, _t(forced[i]).long(),
                                            tcs, tpos, **kw)
                _close(tl, jl, REL_MODEL)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_then_decode_matches_full_prefill(arch):
    """logits(prefill P, then decode one) == logits(prefill P + 1), the
    reference's check (MoE capacity raised so that nothing drops: the two
    tokenizations drop differently)."""
    over = {"capacity_factor": 8.0} if get_config(arch).num_experts else {}
    cfg = dataclasses.replace(reduced(get_config(arch)), **over)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(2))
    B, P = 2, 12
    tokens = torch.randint(0, cfg.vocab_size, (B, P + 1),
                           generator=torch.Generator().manual_seed(3))
    full, _ = model.prefill(params, {"tokens": tokens}, max_len=P + 4)
    _, cache = model.prefill(params, {"tokens": tokens[:, :P]},
                             max_len=P + 4)
    step, _ = model.decode_step(params, tokens[:, P:], cache, P)
    np.testing.assert_allclose(step.numpy(), full.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_unported_mixers_name_item_4():
    # item 4 ported the recurrent mixers: each block's parameters are the
    # reference's, shape for shape, and an unknown mixer raises
    # ValueError as the reference's block_desc does
    from repro.configs.base import LayerSpec as JLayerSpec
    from repro.models import transformer as jtransformer
    from repro.models.layers import ParamDesc as JParamDesc
    from repro_torch.configs.base import LayerSpec
    from repro_torch.models.layers import ParamDesc
    arch = "jamba-v0.1-52b"
    cfg, jcfg = reduced(get_config(arch)), jreduced(jget_config(arch))
    for mixer in ("mamba", "mlstm", "slstm"):
        ffn = "dense" if mixer == "mamba" else "none"
        desc = transformer.block_desc(cfg, LayerSpec(mixer=mixer, ffn=ffn))
        jdesc = jtransformer.block_desc(jcfg, JLayerSpec(mixer=mixer,
                                                         ffn=ffn))
        assert tree_map(lambda d: d.shape, desc,
                        is_leaf=lambda d: isinstance(d, ParamDesc)) == \
            jax.tree.map(lambda d: d.shape, jdesc,
                         is_leaf=lambda d: isinstance(d, JParamDesc))
    with pytest.raises(ValueError):
        transformer.block_desc(cfg, LayerSpec(mixer="rnn"))
