"""The port's multi-head latent attention (``repro_torch.models.attention``
MLA functions) against the JAX package's, layer by layer, on the same
weights (``params_from_jax``) and numpy-made inputs, at the reduced
deepseek-v2-lite-16b size (16 heads of q/k head dim 32 + 16, v 32,
latent 64) in f32.

Tolerance: ``max|Δ| <= 1e-5 · max|reference|`` for every output and
cache leaf, and for the training path's gradients (one layer, the same
op order; the slack covers two frameworks' f32 matmuls and RoPE's
transcendentals).  The naive and absorbed decodes differ in op order:
they are held to each other within 1e-4 (the reference's own check,
tighter than its 2e-3).
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
from repro.models import attention as jattn
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.kernels import flash_attention as tflash
from repro_torch.models import attention as tattn
from repro_torch.models import transformer

REL = 1e-5


def _close(a, b, rel=REL):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.abs(b).max(), 1e-30)
    err = np.abs(a - b).max()
    assert err <= rel * scale, f"max|Δ|={err:.3e} > {rel}·{scale:.3e}"


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def mla():
    """(jcfg, cfg, spec, JAX mixer params, port mixer params) of the
    reduced model's first MLA layer, 16 heads, a random kv_norm scale."""
    over = dict(num_heads=16, num_kv_heads=16)
    jcfg = dataclasses.replace(jreduced(jget_config("deepseek-v2-lite-16b")),
                               **over)
    cfg = dataclasses.replace(reduced(get_config("deepseek-v2-lite-16b")),
                              **over)
    tree = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.PRNGKey(0)))
    jp = tree["stack"][0][0]["mixer"]
    jp["kv_norm"]["scale"] = (0.5 * np.random.default_rng(1).standard_normal(
        jp["kv_norm"]["scale"].shape)).astype(np.float32)
    params = params_from_jax(tree, cfg, device="cpu")
    spec = cfg.stack_plan()[0].period[0]
    assert spec.mixer == "mla"
    return jcfg, cfg, spec, jp, params["stack"][0][0]["mixer"]


def _x(cfg, B, T, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)


def test_mla_layout(mla):
    jcfg, cfg, _, jp, tp = mla
    desc = tattn.mla_desc(cfg)
    assert sorted(desc) == sorted(jp) == ["kv_norm", "w_dkv", "w_ukv", "wo",
                                          "wq"]
    for k, d in desc.items():
        shape = d["scale"].shape if k == "kv_norm" else d.shape
        ref = jp[k]["scale"].shape if k == "kv_norm" else jp[k].shape
        assert tuple(shape) == tuple(ref)
    spec = tattn.init_mla_cache(cfg, 3, 20, torch.float32)
    assert spec["c_kv"].shape == (3, 20, cfg.kv_lora_rank)
    assert spec["k_rope"].shape == (3, 20, 1, cfg.qk_rope_dim)


def test_mla_forward_and_grads_match_jax(mla):
    jcfg, cfg, spec, jp, tp = mla
    B, T = 2, 24
    x = _x(cfg, B, T, 2)
    cot = np.random.default_rng(3).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)
    pos = np.arange(T)[None, :]

    def jf(p, x):
        return jnp.sum(jattn.mla_forward(p, jcfg, spec, x, jnp.asarray(pos))
                       * cot)

    jout = jattn.mla_forward(jax.tree.map(jnp.asarray, jp), jcfg, spec,
                             jnp.asarray(x), jnp.asarray(pos))
    jg_p, jg_x = jax.jit(jax.grad(jf, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    tp = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    tx = _t(x).requires_grad_(True)
    out = tattn.mla_forward(tp, cfg, spec, tx, _t(pos))
    _close(out.detach(), jout)
    torch.sum(out * _t(cot)).backward()
    _close(tx.grad, jg_x)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jg_p)):
        _close(a.grad, b)


def test_mla_prefill_matches_jax(mla):
    jcfg, cfg, spec, jp, tp = mla
    B, T, ML = 2, 13, 20
    x = _x(cfg, B, T, 4)
    pos = np.arange(T)[None, :]
    jout, jc = jattn.mla_prefill(jax.tree.map(jnp.asarray, jp), jcfg, spec,
                                 jnp.asarray(x), jnp.asarray(pos), ML)
    out, c = tattn.mla_prefill(tp, cfg, spec, _t(x), _t(pos), ML)
    _close(out, jout)
    assert sorted(c) == sorted(jc) == ["c_kv", "k_rope"]
    for k in c:
        assert tuple(c[k].shape) == jc[k].shape
        _close(c[k], jc[k])
    # the prefill (ops.flash_attention) and the training path agree
    _close(tattn.mla_forward(tp, cfg, spec, _t(x), _t(pos)), jout)


@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("vector_pos", [False, True])
def test_mla_decode_matches_jax(mla, absorb, vector_pos):
    jcfg, cfg, spec, jp, tp = mla
    B, T, ML, steps = 2, 9, 16, 3
    x = _x(cfg, B, T, 5)
    jpa = jax.tree.map(jnp.asarray, jp)
    _, jc = jattn.mla_prefill(jpa, jcfg, spec, jnp.asarray(x),
                              jnp.arange(T)[None, :], ML)
    _, c = tattn.mla_prefill(tp, cfg, spec, _t(x), torch.arange(T)[None, :],
                             ML)
    xs = np.random.default_rng(6).standard_normal(
        (steps, B, 1, cfg.d_model)).astype(np.float32)
    for i in range(steps):
        pos = (np.array([T + i, T - 3 + i], np.int32) if vector_pos
               else T + i)
        jout, jc = jattn.mla_decode(jpa, jcfg, spec, jnp.asarray(xs[i]), jc,
                                    jnp.asarray(pos, jnp.int32), absorb=absorb)
        before = c["c_kv"].clone()
        out, c2 = tattn.mla_decode(
            tp, cfg, spec, _t(xs[i]), c,
            _t(pos).long() if vector_pos else pos, absorb=absorb)
        assert torch.equal(c["c_kv"], before)     # the input cache is kept
        c = c2
        _close(out, jout)
        for k in c:
            _close(c[k], jc[k])


def test_mla_naive_and_absorbed_decode_agree(mla):
    _, cfg, spec, _, tp = mla
    x = torch.from_numpy(_x(cfg, 2, 8, 7))
    _, c = tattn.mla_prefill(tp, cfg, spec, x, torch.arange(8)[None, :], 12)
    xs = torch.from_numpy(_x(cfg, 2, 1, 8))
    a, ca = tattn.mla_decode(tp, cfg, spec, xs, c, 8, absorb=False)
    b, cb = tattn.mla_decode(tp, cfg, spec, xs, c, 8, absorb=True)
    _close(a, b.numpy(), 1e-4)
    for k in ca:
        assert torch.equal(ca[k], cb[k])


def _qkv_for_the_kernel(params, cfg, T):
    """``_mla_full_qkv``'s q, k, v_p in bf16, as the prefill hands them to
    ``ops.flash_attention``; each must be contiguous and readable by the
    wgmma kernel's TMA maps in place (no copy)."""
    params = tree_map(lambda t: t.to(torch.bfloat16), params)
    x = torch.from_numpy(_x(cfg, 2, T, 9)).to(torch.bfloat16)
    q, k, v_p, _, _ = tattn._mla_full_qkv(params, cfg, x,
                                          torch.arange(T)[None, :])
    hd = cfg.qk_nope_dim + cfg.qk_rope_dim
    for t in (q, k, v_p):
        assert t.shape == (2, T, cfg.num_heads, hd) and t.is_contiguous()
        assert tflash.tma_ready(t)
    assert not v_p[..., cfg.v_head_dim:].any()    # v zero-padded to hd
    return q


def test_mla_prefill_qkv_are_tma_ready(mla):
    # the reduced widths (q/k head dim 32 + 16): the same layout as the
    # full model's, so the same in-place reads
    _, cfg, _, _, tp = mla
    q = _qkv_for_the_kernel(tp, cfg, 11)
    assert tflash.route(q.dtype, q.shape[-1]) == "simt"      # hd 48


def test_mla_prefill_takes_the_wgmma_route_at_full_width():
    # deepseek-v2-lite-16b's mixer at its full widths (q/k head dim 128 +
    # 64 = 192, v 128 padded to 192): bf16 goes to the tensor cores
    cfg = get_config("deepseek-v2-lite-16b")
    g = torch.Generator().manual_seed(0)
    params = {k: ({"scale": torch.zeros(d["scale"].shape)} if k == "kv_norm"
                  else torch.randn(d.shape, generator=g) * 0.02)
              for k, d in tattn.mla_desc(cfg).items()}
    q = _qkv_for_the_kernel(params, cfg, 5)
    assert q.shape[-1] == 192
    assert tflash.route(torch.bfloat16, 192) == "wgmma"
    assert tflash.route(q.dtype, q.shape[-1]) == "wgmma"
    assert tflash.route(torch.float32, 192) == "simt"


def test_mla_block_cache_is_paged_latents():
    cfg = reduced(get_config("deepseek-v2-lite-16b"))
    meta = transformer.stack_cache_meta(cfg, cfg.stack_plan(), 2, 16,
                                        torch.float32)
    kinds = [(m.kind, m.length) for m in tree_leaves(
        meta, is_leaf=lambda m: isinstance(m, transformer.CacheLeafMeta))]
    # two segments ((mla, dense) x 1, (mla, moe) x 1), two latents each
    assert kinds == [("paged", 16)] * 4
