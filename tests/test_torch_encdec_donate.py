"""The encoder-decoder's donated decode step
(``launch/steps.make_decode_step(donate=True)``): each decoder layer's
self-attention entry is written into the cache it is given, as the
reference's donated buffer holds it once.

Reduced seamless-m4t-large-v2 in f32 on the JAX package's weights, 4
decode steps after one prefill, at one position for the batch and at a
(B,) position a row (the serving engine's continuous batch):

  * every self-cache leaf the donated step returns is the tensor passed
    in (the same storage), and so are the cross K/V; the step's temp
    (``launch/op_analysis``) is below one self cache: no second copy;
  * its logits and cache equal the non-donated step's bit for bit;
  * its logits are within ``REL_MODEL`` of the JAX package's
    ``decode_step`` (the model tests' tolerance).
"""
from __future__ import annotations

import numpy as np
import pytest

ARCH = "seamless-m4t-large-v2"
REL_MODEL = 1e-4
B, T, S, ML, STEPS = 2, 8, 24, 16, 4


@pytest.fixture(scope="module")
def decoded():
    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import Model as JModel
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import params_from_jax
    from repro_torch.launch import op_analysis
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import Model
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jmodel = JModel(jreduced(jget_config(ARCH)))
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    cfg = reduced(get_config(ARCH))
    model = Model(cfg)
    params = params_from_jax(tree, cfg, device="cpu")
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    src = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    forced = rng.integers(0, cfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    jl, jc = jax.jit(jmodel.prefill, static_argnames=("max_len",))(
        tree, {"tokens": jnp.asarray(tokens), "src": jnp.asarray(src)},
        max_len=ML)
    jdecode = jax.jit(jmodel.decode_step)
    out = {}
    try:
        with torch.no_grad():
            _, cache = model.prefill(
                params, {"tokens": torch.from_numpy(tokens).long(),
                         "src": torch.from_numpy(src)}, max_len=ML)
            for name, pos_of in (
                    ("scalar", lambda i: T + i),
                    ("rows", lambda i: np.array([T + i, T - 3 + i],
                                                np.int32))):
                kept = tree_map(lambda t: t.clone(), cache)
                donated = tree_map(lambda t: t.clone(), cache)
                ptrs = [t.data_ptr() for t in tree_leaves(donated)]
                jcs, res = jc, []
                for i in range(STEPS):
                    pos = pos_of(i)
                    tpos = (torch.from_numpy(pos).long()
                            if isinstance(pos, np.ndarray) else pos)
                    tok = torch.from_numpy(forced[i]).long()
                    jlog, jcs = jdecode(tree, jnp.asarray(forced[i]), jcs,
                                        jnp.asarray(pos, jnp.int32))
                    kl, kept = make_decode_step(model)(params, tok, kept,
                                                       tpos)
                    dl, new = make_decode_step(model, donate=True)(
                        params, tok, donated, tpos)
                    res.append({
                        "same": all(a is b for a, b in zip(
                            tree_leaves(new), tree_leaves(donated))),
                        "ptrs": [t.data_ptr() for t in tree_leaves(new)]
                        == ptrs,
                        "logits": (dl.numpy(), kl.numpy(),
                                   np.asarray(jlog))})
                equal = all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(donated), tree_leaves(kept)))
                # one more donated step, counted: its temp must hold no
                # second self cache
                _, stats = op_analysis.trace(
                    make_decode_step(model, donate=True),
                    (params, torch.from_numpy(forced[0]).long(), donated,
                     tpos + 1))
                self_bytes = sum(t.numel() * t.element_size()
                                 for t in tree_leaves(donated["self"]))
                res.append({
                    "caches_equal": equal,
                    "temp": stats.memory_analysis()["temp_size_in_bytes"],
                    "self_bytes": self_bytes})
                out[name] = res
    finally:
        torch.set_num_threads(n)
    return out


@pytest.mark.parametrize("pos", ["scalar", "rows"])
def test_donated_decode_writes_the_cache_it_is_given(decoded, pos):
    steps, last = decoded[pos][:-1], decoded[pos][-1]
    assert last["caches_equal"]
    assert last["temp"] < last["self_bytes"], last
    for s in steps:
        assert s["same"] and s["ptrs"]
        donated, kept, jax_logits = s["logits"]
        assert np.array_equal(donated, kept)
        gap = np.abs(donated.astype(np.float64) - jax_logits).max() / \
            np.abs(jax_logits).max()
        assert gap <= REL_MODEL, gap
