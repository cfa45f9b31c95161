"""Serving under the reference's model-axis layout
(``sharding_ctx.serve_region``): head-parallel attention, the reference's
decode-cache split, the vocab-parallel embedding and LM head, the dense
FFNs on their ffn slice and the experts in blocks.

  * One spawned gloo world of 4 (``FileStore`` under ``tmp_path``, one
    thread a process), a (data 2, model 2) mesh of process groups and
    the world itself as a model axis of 4, runs every case of ``CASES``
    at a small size in f32: the rank's share of the reference's weights
    (``convert.serve_slice``), ``make_prefill_step`` under the region,
    then ``make_decode_step(donate=True)`` steps on the cache the prefill
    returned (the length split's odd steps at a (B,) position, as the
    serving engine's continuous batch gives it).
  * Each case's logits are bit-equal on every rank, equal the unsharded
    port's within ``REL_PORT`` (the ranks' ``wo`` / FFN partials and the
    split-KV combine sum in another order) and the JAX package's
    ``Model.prefill`` / ``decode_step`` on the same numpy weights within
    ``REL_JAX`` (the reference tolerance of the model tests); the cache
    each rank ends with equals its share (``convert.cache_slice``) of the
    unsharded cache, within ``REL_PORT``.  Where no sum is reordered (the
    embedding's all-reduce adds one row to zeros; the head's all-gather
    moves whole logits) the parts are bit-equal.
  * The donated decode writes into the cache it is given: one cache,
    and the same logits and entries as the copying decode.
  * The port's logical axes and serve dims equal the reference's
    ``partition_specs("serve")`` for every architecture, and every decode
    shape's cache layout the reference's
    ``input_partition_specs(shape)["cache"]`` (JAX's specs only: no
    compile, no devices).
"""
from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np
import pytest

REL_PORT = 1e-5
REL_JAX = 1e-4
WORLD = 4
BASE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=512, param_dtype="float32",
            compute_dtype="float32")
# name: (architecture, overrides, tp, dp, batch, prompt, max_len, steps)
CASES = {
    # kv heads over tp = 2 (2 % 2 == 0); a window layer of 8 rings
    "kv_split": ("gemma2-9b", dict(window_size=8), 2, 1, 2, 12, 20, 3),
    # KV = 2 over tp = 4: a global layer of L = 2048 split by length, 512
    # a rank, the steps writing into its third block; a ring of 1024 (below
    # 2048) whole on every rank, each rank's kv head all-gathered into it,
    # the steps wrapping it
    "length_split": ("gemma2-9b", dict(window_size=1024), 4, 1, 2, 1024,
                     2048, 3),
    # H = 2 < tp = 4: two head blocks, each on two ranks; a cache of 20
    # entries whole on every rank (below the length split's 2048)
    "heads_below_tp": ("gemma-2b", dict(num_heads=2, num_kv_heads=1), 4, 1,
                       2, 12, 20, 3),
    # B = 1: the global layer's L = 4096 >= 4096 over (data, model), 1024
    # a rank, the steps writing into the block of data 1, model 1; the
    # ring of 2048 over model only (2048 < 4096), the prompt (a whole
    # number of the reference's 1024-key chunks) wrapping it
    "batch1_data_model": ("gemma2-9b", dict(num_kv_heads=1,
                                            window_size=2048),
                          2, 2, 1, 3072, 4096, 2),
    # 8 experts, 4 a rank; capacity factor 0.5 drops choices
    "moe_drops": ("qwen3-moe-30b-a3b", dict(num_experts=8, top_k=2,
                                            moe_d_ff=32,
                                            capacity_factor=0.5),
                  2, 1, 2, 16, 24, 2),
    # 2 experts a rank; capacity factor 8: every choice kept
    "moe_no_drops": ("qwen3-moe-30b-a3b", dict(num_experts=8, top_k=2,
                                               moe_d_ff=32,
                                               capacity_factor=8.0),
                     4, 1, 2, 16, 24, 2),
}


def _cfg(name: str, over: dict, jax_side: bool = False):
    if jax_side:
        from repro.configs import get_config
    else:
        from repro_torch.configs import get_config
    return dataclasses.replace(get_config(name), **{**BASE, **over})


def _tokens(case: str):
    arch, over, tp, dp, B, T, ML, steps = CASES[case]
    rng = np.random.default_rng(len(case))
    vocab = _cfg(arch, over).vocab_size
    return (rng.integers(0, vocab, (B, T)).astype(np.int32),
            rng.integers(0, vocab, (steps, B, 1)).astype(np.int32))


def _worker(rank: int, world: int, store: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch._tree import tree_leaves
    from repro_torch.convert import params_from_jax, serve_slice
    from repro_torch.core.collectives.p2p import axis_index
    from repro_torch.launch.dist import init_group, mesh_axes
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.model import Model
    from repro_torch.models.sharding_ctx import serve_region
    torch.set_num_threads(1)
    init_group(torch.device("cpu"), world_size=world, rank=rank,
               store_path=store)
    data, model2 = mesh_axes((2, 2))
    out = {}
    with torch.no_grad():
        for case, (arch, over, tp, dp, B, T, ML, steps) in CASES.items():
            cfg = _cfg(arch, over)
            with open(os.path.join(out_dir, f"{case}.pkl"), "rb") as f:
                tree = pickle.load(f)
            group = dist.group.WORLD if tp == 4 else model2
            params = serve_slice(params_from_jax(tree, cfg, "cpu"), cfg,
                                 axis_index(group), tp)
            model = Model(cfg)
            tokens, forced = _tokens(case)
            lengths = (data,) if dp > 1 else ()
            res = {}
            with serve_region(group, lengths, ML):
                logits, cache = make_prefill_step(model, ML)(
                    params, {"tokens": torch.from_numpy(tokens).long()})
                res["prefill"] = logits.numpy()
                step = make_decode_step(model, donate=True)
                ptrs = [t.data_ptr() for t in tree_leaves(cache)]
                for i in range(steps):
                    # the length split's odd steps at a (B,) position
                    pos = T + i if case != "length_split" or i % 2 == 0 \
                        else torch.full((B,), T + i)
                    logits, new = step(params,
                                       torch.from_numpy(forced[i]).long(),
                                       cache, pos)
                    res[f"decode{i}"] = logits.numpy()
                    assert new is cache
                assert [t.data_ptr() for t in tree_leaves(cache)] == ptrs
            res["cache"] = [t.numpy() for t in tree_leaves(cache)]
            res["coords"] = (axis_index(data), axis_index(group))
            out[case] = res
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _reference(case: str):
    """The JAX package's prefill and decode steps on the case's weights,
    and the unsharded port's (prefill logits, step logits, final cache)."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.models import Model as JModel
    from repro_torch._tree import tree_leaves
    from repro_torch.convert import params_from_jax
    from repro_torch.models.model import Model
    arch, over, tp, dp, B, T, ML, steps = CASES[case]
    jcfg, cfg = _cfg(arch, over, jax_side=True), _cfg(arch, over)
    jmodel = JModel(jcfg)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(
        len(case))))
    tokens, forced = _tokens(case)
    jl, jc = jax.jit(jmodel.prefill, static_argnames=("max_len",))(
        tree, {"tokens": jnp.asarray(tokens)}, max_len=ML)
    jdecode = jax.jit(jmodel.decode_step)
    jax_logits = [np.asarray(jl)]
    for i in range(steps):
        jl, jc = jdecode(tree, jnp.asarray(forced[i]), jc, jnp.int32(T + i))
        jax_logits.append(np.asarray(jl))
    model = Model(cfg)
    params = params_from_jax(tree, cfg, "cpu")
    with torch.no_grad():
        tl, tc = model.prefill(params,
                               {"tokens": torch.from_numpy(tokens).long()},
                               max_len=ML)
        port_logits = [tl.numpy()]
        for i in range(steps):
            tl, tc = model.decode_step(params,
                                       torch.from_numpy(forced[i]).long(),
                                       tc, T + i)
            port_logits.append(tl.numpy())
    return tree, jax_logits, port_logits, tc


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    import torch
    from repro_torch.launch.dist import spawn
    out = tmp_path_factory.mktemp("serve_tp")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        refs = {}
        for case in CASES:
            tree, jax_logits, port_logits, cache = _reference(case)
            with open(out / f"{case}.pkl", "wb") as f:
                pickle.dump(tree, f)
            refs[case] = (jax_logits, port_logits, cache)
    finally:
        torch.set_num_threads(n)
    spawn(_worker, WORLD, args=(str(out),), timeout=300)
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return refs, ranks


def _close(a, b, rel):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.abs(b).max(), 1e-30)
    err = np.abs(a - b).max()
    assert err <= rel * scale, f"max|Δ|={err:.3e} > {rel}·{scale:.3e}"


@pytest.mark.parametrize("case", list(CASES))
def test_serve_case_matches_unsharded_and_reference(served, case):
    from repro_torch._tree import tree_leaves
    from repro_torch.convert import cache_slice
    refs, ranks = served
    jax_logits, port_logits, cache = refs[case]
    arch, over, tp, dp, B, T, ML, steps = CASES[case]
    keys = ["prefill"] + [f"decode{i}" for i in range(steps)]
    mine = [r[case] for r in ranks]
    for key in keys:
        for r in mine[1:]:
            assert np.array_equal(r[key], mine[0][key]), (case, key)
    for key, want, jwant in zip(keys, port_logits, jax_logits):
        _close(mine[0][key], want, REL_PORT)
        _close(mine[0][key], jwant, REL_JAX)
    cfg = _cfg(arch, over)
    for r in mine:
        d, m = r["coords"]
        share = cache_slice(cache, cfg, B, ML, m, tp, d if dp > 1 else 0,
                            dp)
        got = r["cache"]
        want = [t.numpy() for t in tree_leaves(share)]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close(a, b, REL_PORT)


def test_cache_shares_hold_the_split(served):
    _, ranks = served
    # (B, L / parts, KV, hd): the global layer's 2048 a quarter, the ring's
    # 1024 whole, both with every kv head
    leaves = ranks[0]["length_split"]["cache"]
    assert sorted(a.shape[1] for a in leaves) == [512, 512, 1024, 1024]
    assert all(a.shape[2] == 2 for a in leaves)
    # B = 1: the global 4096 over (data, model), the ring's 2048 over model
    leaves = ranks[0]["batch1_data_model"]["cache"]
    assert [a.shape[:3] for a in leaves] == [(1, 1024, 1)] * 4


def test_vocab_parallel_embed_and_head_are_exact(tmp_path):
    """The embedding's all-reduce adds a rank's row to zeros and the
    head's all-gather moves whole logits: bit-equal to the unsharded
    ``embed`` and ``h @ table.T`` with the final softcap (gloo world of
    2, the table's 512 rows 256 a rank)."""
    from repro_torch.launch.dist import spawn
    spawn(_embed_worker, 2, args=(str(tmp_path),), timeout=120)
    assert sorted(os.listdir(tmp_path)) == ["ok0", "ok1"]


def _embed_worker(rank: int, world: int, store: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.launch.dist import init_group
    from repro_torch.models.layers import (embed, embed_tp, logits_tp)
    torch.set_num_threads(1)
    init_group(torch.device("cpu"), world_size=world, rank=rank,
               store_path=store)
    g = torch.Generator().manual_seed(0)
    table = torch.randn(512, 32, generator=g).to(torch.bfloat16)
    tokens = torch.randint(0, 512, (3, 7), generator=g)
    h = torch.randn(3, 7, 32, generator=g).to(torch.bfloat16)
    mine = table[rank * 256:(rank + 1) * 256].contiguous()
    x = embed_tp({"table": mine}, tokens, scale=True, d=32,
                 group=dist.group.WORLD)
    assert torch.equal(x, embed({"table": table}, tokens, scale=True, d=32))
    got = logits_tp(mine, h, dist.group.WORLD, 30.0)
    want = h @ table.T
    want = 30.0 * torch.tanh(want / 30.0)
    assert torch.equal(got, want)
    open(os.path.join(out_dir, f"ok{rank}"), "w").close()
    dist.barrier()
    dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["gemma2-9b", "deepseek-v2-lite-16b",
                                  "jamba-v0.1-52b", "seamless-m4t-large-v2"])
def test_donated_decode_writes_one_cache(arch):
    """``make_decode_step(donate=True)`` returns the cache it was given,
    written in place, with the copying step's logits and entries: the
    unsharded reduced models, a ring and a global layer (gemma2-9b), MLA's
    latents (deepseek-v2-lite-16b, absorbed), Mamba's states copied over
    their old values (jamba), the encoder-decoder's self and cross
    caches (seamless); the steps at an int position and at a (B,) one."""
    import torch
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models.model import Model
    cfg = reduced(get_config(arch))
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(1),
                        dtype=torch.float32)
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen)
    batch = {"tokens": tokens}
    if cfg.is_encoder_decoder:
        batch["src"] = torch.randn(2, 12, cfg.d_model, generator=gen)
    with torch.no_grad():
        _, cache = model.prefill(params, batch, max_len=48)
        donated = tree_map(lambda t: t.clone(), cache)
        ptrs = [t.data_ptr() for t in tree_leaves(donated)]
        copy_step = make_decode_step(model, mla_absorb=True)
        give_step = make_decode_step(model, mla_absorb=True, donate=True)
        for i in range(3):
            nxt = tokens[:, i:i + 1]
            pos = 40 + i if i % 2 == 0 else torch.full((2,), 40 + i)
            want, cache = copy_step(params, nxt, cache, pos)
            got, out = give_step(params, nxt, donated, pos)
            assert out is donated and torch.equal(got, want)
    assert [t.data_ptr() for t in tree_leaves(donated)] == ptrs
    for a, b in zip(tree_leaves(donated), tree_leaves(cache)):
        assert torch.equal(a, b)


def _all_archs():
    from repro_torch.configs import ALL_ARCHS
    return list(ALL_ARCHS)


@pytest.mark.parametrize("arch", _all_archs())
def test_serve_axes_and_dims_equal_the_reference(arch):
    import jax
    from jax.sharding import PartitionSpec
    from repro.configs import get_config as jget_config
    from repro.models import Model as JModel
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    model, jmodel = Model(get_config(arch)), JModel(jget_config(arch))
    for phase in ("serve", "train"):
        mine = tree_leaves(model.partition_specs(phase),
                           is_leaf=lambda x: isinstance(x, tuple))
        want = jax.tree.leaves(jmodel.partition_specs(phase),
                               is_leaf=lambda x: isinstance(x, PartitionSpec))
        assert len(mine) == len(want)
        for a, b in zip(mine, want):
            assert a == tuple(b), (phase, a, b)
    dims = tree_leaves(model.partition_dims("serve"))
    specs = jax.tree.leaves(jmodel.partition_specs("serve"),
                            is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert dims == [next((i for i, a in enumerate(s) if a == "model"), None)
                    for s in specs]


def _decode_pairs():
    from repro_torch.configs import ALL_ARCHS, applicable_shapes, get_config
    return [(a, s) for a in ALL_ARCHS for s in applicable_shapes(
        get_config(a)) if s in ("decode_32k", "long_500k")]


@pytest.mark.parametrize("arch,shape", _decode_pairs())
def test_cache_layout_equals_the_reference(arch, shape):
    import jax
    from jax.sharding import PartitionSpec
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget_config
    from repro.models import Model as JModel
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models.model import Model
    for multi_pod in (False, True):
        mine = Model(get_config(arch)).input_partition_specs(
            SHAPES[shape], multi_pod)["cache"]
        want = JModel(jget_config(arch)).input_partition_specs(
            JSHAPES[shape], multi_pod)["cache"]
        mine = tree_leaves(mine, is_leaf=lambda x: isinstance(x, tuple))
        want = jax.tree.leaves(want,
                               is_leaf=lambda x: isinstance(x, PartitionSpec))
        assert len(mine) == len(want)
        for a, b in zip(mine, want):
            assert a == tuple(b), (multi_pod, a, b)
