"""The port's gemma-2b stack (``repro_torch.models``) against the JAX
package's, on the same weights (carried over by ``params_from_jax``) and
the same numpy-made tokens, at the reduced size in f32.

Tolerance: ``max|Δlogit| <= 1e-4 · max|logit|`` (and the same relative
bound on cache entries).  Both sides compute in f32 with the same op
order; the slack covers the two frameworks' different matmul and
transcendental (pow/exp/tanh/rsqrt) kernels, ~1e-7 relative per op
compounded over two layers.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as J_ALL_ARCHS
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.models import attention as jattn
from repro_torch.configs import get_config, reduced
from repro_torch._tree import tree_leaves
from repro_torch.convert import params_from_jax
from repro_torch.models import Model, count_params
from repro_torch.models import attention as tattn

REL = 1e-4


def _close(a, b, rel=REL):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.abs(b).max(), 1e-30)
    err = np.abs(a - b).max()
    assert err <= rel * scale, f"max|Δ|={err:.3e} > {rel}·{scale:.3e}"


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _jitted(jmodel):
    return (jax.jit(jmodel.prefill, static_argnames=("max_len",)),
            jax.jit(jmodel.decode_step))


def _plan(cfg):
    return [([dataclasses.asdict(p) for p in s.period], s.repeats)
            for s in cfg.stack_plan()]


@pytest.fixture(scope="module")
def pair():
    jcfg = jreduced(jget_config("gemma-2b"))
    cfg = reduced(get_config("gemma-2b"))
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return jcfg, jmodel, jparams, cfg, Model(cfg), params


def test_config_copy_matches_reference():
    for full in (False, True):
        j = jget_config("gemma-2b")
        t = get_config("gemma-2b")
        if not full:
            j, t = jreduced(j), reduced(t)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert _plan(t) == _plan(j)
    assert count_params(get_config("gemma-2b")) == \
        jget_config("gemma-2b").num_params()
    assert get_config("gemma-2b").num_params() == count_params(
        get_config("gemma-2b"))


def test_unported_arch_raises_with_roadmap_pointer():
    # every architecture of the JAX package is registered now; an unknown
    # name raises KeyError, as in the reference
    from repro.configs import ALL_ARCHS as J_ALL
    for name in J_ALL:
        assert get_config(name).name == name
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch", sorted(J_ALL_ARCHS))
def test_every_config_copy_plan_and_count_match_reference(arch):
    for full in (False, True):
        j, t = jget_config(arch), get_config(arch)
        if not full:
            j, t = jreduced(j), reduced(t)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert _plan(t) == _plan(j)
        assert count_params(t) == j.num_params()


def test_params_from_jax_checks_shapes(pair):
    jcfg, jmodel, jparams, cfg, _, params = pair
    tree = jax.tree.map(np.asarray, jparams)
    assert params["stack"][0][0]["mixer"]["wq"].shape == (2, 256, 256)
    tree["final_norm"]["scale"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="final_norm"):
        params_from_jax(tree, cfg, device="cpu")


def test_params_from_jax_bf16_bits():
    cfg = reduced(get_config("gemma-2b"))
    jcfg = jreduced(jget_config("gemma-2b"))
    jparams = JModel(jcfg).init(jax.random.PRNGKey(1), dtype=jnp.bfloat16)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    a = params["embed"]["table"]
    b = np.asarray(jparams["embed"]["table"])
    assert a.dtype == torch.bfloat16
    np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                  b.view(np.int16))


def test_prefill_and_teacher_forced_decode_match(pair):
    jcfg, jmodel, jparams, cfg, model, params = pair
    rng = np.random.default_rng(3)
    B, T, ML, steps = 2, 12, 20, 4
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (steps, B, 1)).astype(np.int32)

    jprefill, jdecode = _jitted(jmodel)
    jl, jc = jprefill(jparams, {"tokens": jnp.asarray(tokens)}, max_len=ML)
    tl, tc = model.prefill(params, {"tokens": _t(tokens).long()}, max_len=ML)
    _close(tl, jl)
    for leaf in ("k", "v"):
        _close(tc[0][0][leaf], jc[0][0][leaf])
        assert tuple(tc[0][0][leaf].shape) == jc[0][0][leaf].shape

    # scalar pos: every row at depth T + i
    jcs, tcs = jc, tc
    for i in range(steps):
        jl, jcs = jdecode(jparams, jnp.asarray(forced[i]), jcs,
                          jnp.asarray(T + i, jnp.int32))
        tl, tcs = model.decode_step(params, _t(forced[i]).long(), tcs, T + i)
        _close(tl, jl)
    _close(tcs[0][0]["k"], jcs[0][0]["k"])

    # vector pos: each row at its own depth (row 1 overwrites its tail)
    jcv, tcv = jc, tc
    for i in range(steps):
        pos = np.array([T + i, T - 3 + i], np.int32)
        jl, jcv = jdecode(jparams, jnp.asarray(forced[i]), jcv,
                          jnp.asarray(pos))
        tl, tcv = model.decode_step(params, _t(forced[i]).long(), tcv,
                                    _t(pos).long())
        _close(tl, jl)
    _close(tcv[0][0]["v"], jcv[0][0]["v"])


def test_decode_does_not_modify_input_cache(pair):
    *_, cfg, model, params = pair
    tokens = torch.randint(0, cfg.vocab_size, (2, 8))
    _, cache = model.prefill(params, {"tokens": tokens}, max_len=12)
    before = cache[0][0]["k"].clone()
    model.decode_step(params, tokens[:, :1], cache, 8)
    model.decode_step(params, tokens[:, :1], cache, torch.tensor([8, 9]))
    assert torch.equal(cache[0][0]["k"], before)


@pytest.mark.parametrize("kwargs", [
    dict(), dict(window=24), dict(softcap=20.0), dict(causal=False),
    dict(window=24, softcap=30.0, q_offset=8), dict(causal=False, window=20),
])
def test_chunked_attention_matches_jax_flash(kwargs):
    rng = np.random.default_rng(5)
    B, T, H, KV, hd = 2, 64, 4, 2, 16
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    # T > chunk: 4 query chunks x 2 key chunks
    out = tattn.flash_attention(_t(q), _t(k), _t(v), q_chunk=16, kv_chunk=32,
                                **kwargs)
    ref = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), q_chunk=16, kv_chunk=32,
                                **kwargs)
    _close(out, ref, rel=1e-5)
    naive = jattn.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), **kwargs)
    _close(out, naive, rel=1e-5)


def test_ring_window_decode_matches_jax():
    # sliding-window ring buffer (unused by gemma-2b, ported as written)
    jcfg = dataclasses.replace(jreduced(jget_config("gemma-2b")),
                               attn_pattern=("local",), window_size=8,
                               num_layers=1)
    cfg = dataclasses.replace(reduced(get_config("gemma-2b")),
                              attn_pattern=("local",), window_size=8,
                              num_layers=1)
    jmodel, model = JModel(jcfg), Model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(4))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    jprefill, jdecode = _jitted(jmodel)
    jl, jc = jprefill(jparams, {"tokens": jnp.asarray(tokens)}, max_len=16)
    tl, tc = model.prefill(params, {"tokens": _t(tokens).long()}, max_len=16)
    _close(tl, jl)
    _close(tc[0][0]["k"], jc[0][0]["k"])
    for i in range(3):
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        pos = np.array([11 + i, 9 + i], np.int32)
        jl, jc = jdecode(jparams, jnp.asarray(tok), jc, jnp.asarray(pos))
        tl, tc = model.decode_step(params, _t(tok).long(), tc, _t(pos).long())
        _close(tl, jl)


# ---------------------------------------------------------------------------
# gemma2-9b (sliding window + logit softcaps, untied head) and gemma3-4b
# (QK-norm, rope_theta 1e6, a stack of stacked repeats plus a tail)
# ---------------------------------------------------------------------------

# reduced sizes, with G = 2 query heads per KV head as in both full
# configs; gemma3-4b keeps two segments (2 repeats of its 6-layer period
# and a 4-layer tail, as the full 5 x 6 + 4)
NEW_ARCHS = {"gemma2-9b": dict(num_kv_heads=2),
             "gemma3-4b": dict(num_kv_heads=2, num_layers=16)}


def _reduced_pair(arch):
    over = NEW_ARCHS[arch]
    return (dataclasses.replace(jreduced(jget_config(arch)), **over),
            dataclasses.replace(reduced(get_config(arch)), **over))


@pytest.fixture(scope="module", params=sorted(NEW_ARCHS))
def new_pair(request):
    jcfg, cfg = _reduced_pair(request.param)
    jmodel = JModel(jcfg)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(2)))
    # the norms' scales init to 0; random ones make QK-norm's scale count
    rng = np.random.default_rng(8)
    for seg in tree["stack"]:
        for blk in seg:
            for name in ("q_norm", "k_norm"):
                if name in blk["mixer"]:
                    s = blk["mixer"][name]["scale"]
                    blk["mixer"][name]["scale"] = (
                        0.5 * rng.standard_normal(s.shape)).astype(s.dtype)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_jax(tree, cfg, device="cpu")
    return jcfg, jmodel, jparams, cfg, Model(cfg), params, tree


@pytest.mark.parametrize("arch", sorted(NEW_ARCHS))
def test_new_config_copies_match_reference(arch):
    for full in (False, True):
        j, t = jget_config(arch), get_config(arch)
        if not full:
            j, t = jreduced(j), reduced(t)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert _plan(t) == _plan(j)
    assert count_params(get_config(arch)) == jget_config(arch).num_params()
    jcfg, cfg = _reduced_pair(arch)
    assert _plan(cfg) == _plan(jcfg)


def test_registry_ports_the_two_new_archs_only():
    # the registry is the JAX package's, in its order, none left unported
    from repro_torch.configs import ALL_ARCHS, NOT_PORTED
    from repro.configs import ALL_ARCHS as J_ALL
    assert NOT_PORTED == ()
    assert ALL_ARCHS == J_ALL and len(ALL_ARCHS) == 10
    full = get_config("gemma3-4b").stack_plan()
    assert [(len(s.period), s.repeats) for s in full] == [(6, 5), (4, 1)]


def test_params_from_jax_carries_head_and_qk_norm(new_pair):
    jcfg, _, _, cfg, _, params, tree = new_pair
    assert not cfg.tie_embeddings
    np.testing.assert_array_equal(params["lm_head"]["table"].numpy(),
                                  tree["lm_head"]["table"])
    mixer = params["stack"][0][0]["mixer"]
    jmixer = tree["stack"][0][0]["mixer"]
    assert ("q_norm" in mixer) == ("k_norm" in mixer) == cfg.qk_norm
    for name in ("q_norm", "k_norm") if cfg.qk_norm else ():
        np.testing.assert_array_equal(mixer[name]["scale"].numpy(),
                                      jmixer[name]["scale"])
        assert mixer[name]["scale"].shape[-1] == cfg.hd
    bad = dict(tree, lm_head={"table": tree["lm_head"]["table"][:-1]})
    with pytest.raises(ValueError, match="lm_head"):
        params_from_jax(bad, cfg, device="cpu")


def test_new_archs_prefill_and_decode_match(new_pair):
    # prompts longer than the reduced window (32), decode past the ring's
    # wrap, with scalar and vector positions
    jcfg, jmodel, jparams, cfg, model, params, _ = new_pair
    assert cfg.window_size == 32 and cfg.num_heads == 2 * cfg.num_kv_heads
    rng = np.random.default_rng(12)
    B, T, ML, steps = 2, 40, 48, 4
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (steps, B, 1)).astype(np.int32)

    jprefill, jdecode = _jitted(jmodel)
    jl, jc = jprefill(jparams, {"tokens": jnp.asarray(tokens)}, max_len=ML)
    tl, tc = model.prefill(params, {"tokens": _t(tokens).long()}, max_len=ML)
    _close(tl, jl)
    jleaves, tleaves = jax.tree.leaves(jc), tree_leaves(tc)
    assert len(jleaves) == len(tleaves) == 2 * sum(
        len(seg.period) for seg in cfg.stack_plan())
    for a, b in zip(tleaves, jleaves):
        assert tuple(a.shape) == b.shape
        _close(a, b)

    for pos_of in (lambda i: T + i,
                   lambda i: np.array([T + i, T - 5 + i], np.int32)):
        jcs, tcs = jc, tc
        for i in range(steps):
            pos = pos_of(i)
            jpos = jnp.asarray(pos, jnp.int32)
            tpos = _t(pos).long() if isinstance(pos, np.ndarray) else pos
            jl, jcs = jdecode(jparams, jnp.asarray(forced[i]), jcs, jpos)
            tl, tcs = model.decode_step(params, _t(forced[i]).long(), tcs,
                                        tpos)
            _close(tl, jl)
        for a, b in zip(tree_leaves(tcs), jax.tree.leaves(jcs)):
            _close(a, b)
