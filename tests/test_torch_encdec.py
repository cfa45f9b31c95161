"""The port's encoder-decoder (``repro_torch.models.encdec``) and
seamless-m4t-large-v2 against the JAX package, on the same weights
(``params_from_jax``) and numpy-made frames and tokens.

The config is ``reduced()``: 2 encoder + 2 decoder layers, d_model 256,
4 heads of 64.  Frames (the speech frontend's stub) are f32, as the
reference's data pipeline and serve CLI draw them.

Tolerances, each relative to the largest magnitude of the reference's
tensor: the chunked attention (training) at the cross-attention's
shapes 1e-5 in values and gradients (the training tests' bound); in f32,
``encode``, ``decode_prefill`` and ``decode_step_stack`` 1e-5 (two
frameworks' f32 matmuls over two layers), a whole model's loss 1e-5,
its gradients, prefill and decode logits and caches 1e-4 (the model
tests' bound).  bf16 weights with f32 frames: every dtype EQUAL to the
reference's (the encoder, its memory and the cross K/V in f32 by
promotion, the self-attention K/V and the logits in bf16), the f32
memory within 1e-5, and the bf16 logits within 2e-2 of the largest
(bf16 rounding of the decoder's activations, ~4e-3 relative a rounding,
compounded over two layers and the two frameworks' bf16 matmuls).
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
from repro.models import encdec as jencdec
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax, to_numpy
from repro_torch.models import Model, count_params
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tencdec

ARCH = "seamless-m4t-large-v2"
REL_LAYER = 1e-5
REL_MODEL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the recurrences are loops of small ops, which
    threads only slow down (and more so beside other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, rel):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.abs(b).max(), 1e-30)
    err = np.abs(a - b).max()
    assert err <= rel * scale, f"max|Δ|={err:.3e} > {rel}·{scale:.3e}"


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def ed():
    jcfg = jreduced(jget_config(ARCH))
    cfg = reduced(get_config(ARCH))
    jmodel = JModel(jcfg)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    params = params_from_jax(tree, cfg, device="cpu")
    return jcfg, jmodel, tree, cfg, Model(cfg), params


def _data(cfg, B, T, S, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
            rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))


def test_config_tree_and_param_count():
    for full in (False, True):
        j, t = jget_config(ARCH), get_config(ARCH)
        if not full:
            j, t = jreduced(j), reduced(t)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert count_params(t) == j.num_params()
    assert count_params(get_config(ARCH)) == 2_034_887_680
    desc = Model(reduced(get_config(ARCH))).param_desc()
    # the reference's unused final_norm is kept, so that the trees match
    assert set(desc) == {"embed", "final_norm", "encdec", "lm_head"}
    assert set(desc["encdec"]) == {"enc_stack", "enc_norm", "dec_stack",
                                   "dec_norm"}


@pytest.mark.parametrize("T,S", [(8, 24), (1, 24)], ids=["T8", "T1"])
def test_noncausal_chunked_attention_at_cross_shapes(T, S):
    rng = np.random.default_rng(T)
    B, H, KV, hd = 2, 4, 4, 16
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, KV, hd)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b, c: jattn.flash_attention(
        a, b, c, causal=False), *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    tout = tattn.flash_attention(tq, tk, tv, causal=False)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), _t(do))
    _close(tout.detach(), out, REL_LAYER)
    for a, b in zip(tgrads, jgrads):
        _close(a, b, REL_LAYER)


def test_encode_prefill_and_decode_stack_match(ed):
    jcfg, _, tree, cfg, _, params = ed
    tokens, src = _data(cfg, 2, 8, 24, 1)
    jmem = jencdec.encode(tree["encdec"], jcfg, jnp.asarray(src))
    tmem = tencdec.encode(params["encdec"], cfg, _t(src))
    _close(tmem, jmem, REL_LAYER)
    _close(tencdec.encode(params["encdec"], cfg, _t(src), training=True),
           jmem, REL_LAYER)
    x = np.random.default_rng(2).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)
    pos = np.arange(8)[None, :]
    jh, jc = jencdec.decode_prefill(tree["encdec"], jcfg, jnp.asarray(x),
                                    jnp.asarray(pos), jmem, 12)
    th, tc = tencdec.decode_prefill(params["encdec"], cfg, _t(x),
                                    torch.arange(8)[None, :], tmem, 12)
    _close(th, jh, REL_LAYER)
    for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        assert tuple(a.shape) == b.shape
        _close(a, b, REL_LAYER)
    for i in range(3):
        xt = np.random.default_rng(3 + i).standard_normal(
            (2, 1, cfg.d_model)).astype(np.float32)
        jh, jc = jencdec.decode_step_stack(tree["encdec"], jcfg,
                                           jnp.asarray(xt), jc,
                                           jnp.asarray(8 + i, jnp.int32))
        th, tc = tencdec.decode_step_stack(params["encdec"], cfg, _t(xt),
                                           tc, 8 + i)
        _close(th, jh, REL_LAYER)
    for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        _close(a, b, REL_LAYER)


def test_model_prefill_and_decode_match(ed):
    jcfg, jmodel, tree, cfg, model, params = ed
    B, T, S, ML = 2, 8, 24, 16
    tokens, src = _data(cfg, B, T, S, 4)
    forced = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (4, B, 1)).astype(np.int32)
    jprefill = jax.jit(jmodel.prefill, static_argnames=("max_len",))
    jdecode = jax.jit(jmodel.decode_step)
    jl, jc = jprefill(tree, {"tokens": jnp.asarray(tokens),
                             "src": jnp.asarray(src)}, max_len=ML)
    tl, tc = model.prefill(params, {"tokens": _t(tokens).long(),
                                    "src": _t(src)}, max_len=ML)
    _close(tl, jl, REL_MODEL)
    specs = model.init_cache(B, ML, src_len=S)
    assert tree_map(lambda s: tuple(s.shape), specs) == \
        tree_map(lambda t: tuple(t.shape), tc)
    for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        _close(a, b, REL_MODEL)
    for pos_of in (lambda i: T + i,
                   lambda i: np.array([T + i, T - 3 + i], np.int32)):
        jcs, tcs = jc, tc
        for i in range(4):
            pos = pos_of(i)
            tpos = _t(pos).long() if isinstance(pos, np.ndarray) else pos
            jl, jcs = jdecode(tree, jnp.asarray(forced[i]), jcs,
                              jnp.asarray(pos, jnp.int32))
            tl, tcs = model.decode_step(params, _t(forced[i]).long(), tcs,
                                        tpos)
            _close(tl, jl, REL_MODEL)


def test_model_loss_and_gradients_match(ed):
    jcfg, jmodel, tree, cfg, model, params = ed
    tokens, src = _data(cfg, 2, 16, 16, 6)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(
        tree, {"tokens": jnp.asarray(tokens), "src": jnp.asarray(src)})
    p = tree_map(lambda t: t.clone().requires_grad_(True), params)
    loss = model.loss(p, {"tokens": _t(tokens).long(), "src": _t(src)})
    loss.backward()
    _close(loss.detach(), jloss, REL_LAYER)
    # final_norm is unused: no gradient here, a zero one in the reference
    assert p["final_norm"]["scale"].grad is None
    assert not np.any(np.asarray(jgrads["final_norm"]["scale"]))
    grads = to_numpy(tree_map(lambda t: torch.zeros_like(t)
                              if t.grad is None else t.grad, p))
    for a, b in zip(tree_leaves(grads), jax.tree.leaves(jgrads)):
        _close(a, b, REL_MODEL)


def test_bf16_weights_with_f32_frames_promote_as_the_reference():
    over = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg = dataclasses.replace(jreduced(jget_config(ARCH)), **over)
    cfg = dataclasses.replace(reduced(get_config(ARCH)), **over)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    assert params["embed"]["table"].dtype == torch.bfloat16
    tokens, src = _data(cfg, 2, 8, 16, 7)
    jmem = jencdec.encode(jparams["encdec"], jcfg, jnp.asarray(src))
    tmem = tencdec.encode(params["encdec"], cfg, _t(src))
    assert jmem.dtype == jnp.float32 and tmem.dtype == torch.float32
    _close(tmem, jmem, REL_LAYER)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens),
                                      "src": jnp.asarray(src)}, max_len=12)
    tl, tc = Model(cfg).prefill(params, {"tokens": _t(tokens).long(),
                                         "src": _t(src)}, max_len=12)
    want = {"cross_k": torch.float32, "cross_v": torch.float32,
            "k": torch.bfloat16, "v": torch.bfloat16}
    for key, dt in want.items():
        got = tc["self"][key] if key in ("k", "v") else tc[key]
        ref = jc["self"][key] if key in ("k", "v") else jc[key]
        assert got.dtype == dt and str(ref.dtype) == str(dt).split(".")[-1]
    assert tl.dtype == torch.bfloat16 and jl.dtype == jnp.bfloat16
    _close(tc["cross_k"], jc["cross_k"], REL_LAYER)
    _close(tl.float(), np.asarray(jl, np.float32), 2e-2)
    tok = np.array([[3], [5]], np.int32)
    jl, _ = jmodel.decode_step(jparams, jnp.asarray(tok), jc,
                               jnp.asarray(8, jnp.int32))
    tl, _ = Model(cfg).decode_step(params, _t(tok).long(), tc, 8)
    assert tl.dtype == torch.bfloat16
    _close(tl.float(), np.asarray(jl, np.float32), 2e-2)


def test_paged_serving_refuses_and_cli_serves_one_shot(capsys):
    from repro_torch.launch.serve import main
    from repro_torch.serve import Engine, ServeConfig
    cfg = reduced(get_config(ARCH))
    with pytest.raises(NotImplementedError, match="decoder-only"):
        Engine(Model(cfg), None, ServeConfig(max_batch=2, max_len=16))
    run = main(["--arch", ARCH, "--device", "cpu", "--reduced", "--batch",
                "2", "--prompt-len", "8", "--gen", "4"])
    assert run.tokens.shape == (2, 4) and not run.engines
    assert ((run.tokens >= 0) & (run.tokens < cfg.vocab_size)).all()
    assert "engine=oneshot" in capsys.readouterr().out


def test_session_feeds_frames_and_matches_jax():
    """Two vanilla steps from the reference's parameters: the pipeline's
    f32 frames reach the encoder (batch["src"]), losses at rtol 1e-4."""
    from repro.api import SessionConfig as JSessionConfig
    from repro.api import TrainSession as JTrainSession
    from repro_torch.api import SessionConfig, TrainSession
    session = dict(arch=ARCH, reduced=True, steps=2, batch=2, seq=16,
                   lr=3e-3, warmup=1)
    jsess = JTrainSession(JSessionConfig(**session))
    start = jax.tree.map(np.asarray, jsess._params)
    jlosses = jsess.run(2)
    sess = TrainSession(SessionConfig(device="cpu", **session),
                        params=params_from_jax(start, reduced(
                            get_config(ARCH)), device="cpu"))
    batch = sess.batch(0)
    assert batch["src"].dtype == torch.float32
    assert tuple(batch["src"].shape) == (2, 16, 256)
    np.testing.assert_allclose(sess.run(2), jlosses, rtol=1e-4)
