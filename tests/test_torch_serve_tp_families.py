"""Serving the MLA, Mamba, xLSTM and encoder-decoder families under the
reference's model-axis layout (``sharding_ctx.serve_region``).

  * One spawned gloo world of 4 (``FileStore`` under a temporary
    directory, one thread a process), a (data 2, model 2) mesh of process
    groups and the world itself as a model axis of 4, runs every case of
    ``CASES`` at a small size in f32: the rank's share of the reference's
    weights (``convert.serve_slice``, the packed leaves by their parts),
    ``make_prefill_step`` under the region, then
    ``make_decode_step(donate=True)`` steps on the cache the prefill
    returned (MLA's from ``absorb_from`` on absorbed; the length split's
    odd steps at a (B,) position, as the serving engine's continuous batch
    gives it).
  * Each case's logits are bit-equal on every rank, equal the unsharded
    port's within ``REL_PORT`` (the ranks' partial sums and the split-KV
    combine add in another order) and the JAX package's ``Model.prefill``
    / ``decode_step`` on the same numpy weights within ``REL_JAX`` (the
    reference tolerance of the model tests); the cache each rank ends with
    equals its share (``convert.cache_slice``) of the unsharded cache
    within ``REL_PORT``.
  * Each packed leaf (Mamba's ``in_proj``, the mLSTM's ``up``, the
    sLSTM's ``w_in`` and ``up``) cut as one contiguous block of its dim,
    the rest as ``serve_slice`` cuts it, moves the prefill's logits far
    beyond ``REL_PORT``: a contiguous cut is wrong.
  * The rank's parameter shares at tp = 16 (``serve_slice`` of the
    descriptors) and its decode-cache shares (``cache_slice`` at tp = 16
    over the mesh's data axes) have the shapes the reference's
    ``partition_specs("serve")`` and ``input_partition_specs(shape)``
    give on its 16x16 and 2x16x16 meshes (JAX's specs only: no compile,
    no devices).
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
# a contiguous cut of a packed leaf moves the prefill's logits by more
# than this, relative to their largest magnitude
REL_WRONG = 1e-2
WORLD = 4
BASE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=512, param_dtype="float32",
            compute_dtype="float32")
MLA = dict(num_kv_heads=4, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
           v_head_dim=16, num_experts=8, top_k=2, moe_d_ff=32,
           num_shared_experts=1, capacity_factor=8.0)
MAMBA = dict(attn_every=4, attn_offset=3)          # layers 0, 1: Mamba
XLSTM = dict(num_heads=2, num_kv_heads=2, slstm_every=2, mlstm_chunk=4)
# name: (architecture, overrides, tp, dp, batch, prompt, max_len, steps,
#        extra: {"absorb_from": first absorbed MLA step, "src": frames})
CASES = {
    # the latents split by length over tp = 4: 2048 entries, 512 a rank;
    # the prompt (one of the reference's 512-query chunks) fills the first
    # block, the steps write into the second (two naive, then two
    # absorbed); the first layer dense, the second MoE with a shared
    # expert
    "mla_length": ("deepseek-v2-lite-16b", MLA, 4, 1, 2, 512, 2048, 4,
                   {"absorb_from": 2}),
    # 20 entries (below 2048): the latents whole, each rank its heads
    "mla_whole": ("deepseek-v2-lite-16b", MLA, 2, 1, 2, 12, 20, 3,
                  {"absorb_from": 1}),
    # B = 1: 4096 entries over (data, model), 1024 a rank; the steps
    # write into the block of data 0, model 1
    "mla_batch1_data_model": ("deepseek-v2-lite-16b", MLA, 2, 2, 1, 1024,
                              4096, 2, {"absorb_from": 1}),
    # d_inner 128 over tp = 2 and 4
    "mamba_tp2": ("jamba-v0.1-52b", MAMBA, 2, 1, 2, 12, 20, 3, {}),
    "mamba_tp4": ("jamba-v0.1-52b", MAMBA, 4, 1, 2, 12, 20, 3, {}),
    # B = 1 and d_inner 4096: h's channels over (data, model), the conv
    # tail's over model only
    "mamba_batch1_data_model": ("jamba-v0.1-52b",
                                dict(num_layers=1, d_model=1024,
                                     ssm_expand=4, attn_every=2,
                                     attn_offset=1),
                                2, 2, 1, 8, 16, 2, {}),
    # an mLSTM and an sLSTM layer of H = 2 over tp = 4: every rank holds
    # part of a head (C's rows, h's dh, a quarter of each gate's dh)
    "xlstm_tp4": ("xlstm-125m", XLSTM, 4, 1, 2, 12, 20, 3, {}),
    "xlstm_chunkwise_tp2": ("xlstm-125m", dict(XLSTM, mlstm_parallel=True),
                            2, 1, 2, 12, 20, 3, {}),
    # 4 kv heads over tp = 2: the self and cross caches by kv heads
    "encdec_tp2": ("seamless-m4t-large-v2",
                   dict(num_kv_heads=4, num_encoder_layers=2), 2, 1, 2,
                   12, 20, 3, {"src": 10}),
    # attention (kv heads over tp), Mamba, dense and MoE FFNs
    "jamba_tp2": ("jamba-v0.1-52b", dict(num_layers=4, attn_every=4,
                                         attn_offset=3, num_experts=4,
                                         top_k=2, moe_d_ff=32,
                                         capacity_factor=8.0),
                  2, 1, 2, 12, 20, 3, {}),
}
# the packed leaves: (case, leaf, a sibling that names the mixer)
PACKED = [("mamba_tp2", "in_proj", "A_log"), ("xlstm_tp4", "up", "wq"),
          ("xlstm_tp4", "w_in", "w_in"), ("xlstm_tp4", "up", "w_in")]


def _cfg(name: str, over: dict, jax_side: bool = False):
    if jax_side:
        from repro.configs import get_config
    else:
        from repro_torch.configs import get_config
    return dataclasses.replace(get_config(name), **{**BASE, **over})


def _inputs(case: str):
    """(prompt tokens, forced step tokens, frames or None), numpy."""
    arch, over, tp, dp, B, T, ML, steps, extra = CASES[case]
    rng = np.random.default_rng(len(case))
    cfg = _cfg(arch, over)
    src = (rng.standard_normal((B, extra["src"], cfg.d_model))
           .astype(np.float32) if "src" in extra else None)
    return (rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (steps, B, 1)).astype(np.int32),
            src)


def _weights(case: str):
    """The case's weights as a numpy tree in the JAX package's layout
    (the port's descriptors give it), drawn from a numpy seed by each
    leaf's init kind: N(0, 1) / sqrt(fan_in), N(0, 1) · 0.02, zeros or
    ones."""
    from repro_torch._tree import tree_map
    from repro_torch.models.layers import ParamDesc
    from repro_torch.models.model import Model
    arch, over = CASES[case][:2]
    rng = np.random.default_rng(100 + len(case))

    def draw(d: ParamDesc):
        if d.init in ("zeros", "ones"):
            return np.full(d.shape, float(d.init == "ones"), np.float32)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        scale = 0.02 if d.init == "small" else 1.0 / math.sqrt(fan_in)
        return (rng.standard_normal(d.shape) * scale).astype(np.float32)
    return tree_map(draw, Model(_cfg(arch, over)).param_desc(),
                    is_leaf=lambda x: isinstance(x, ParamDesc))


def _absorb(case: str, i: int) -> bool:
    extra = CASES[case][-1]
    return "absorb_from" in extra and i >= extra["absorb_from"]


def _contiguous(full, params, leaf: str, sibling: str, rank: int, tp: int):
    """``params`` with every mixer's ``leaf`` (in a mixer holding
    ``sibling``) replaced by rank ``rank``'s contiguous block of the full
    leaf's last dim."""
    out = []
    for fseg, seg in zip(full["stack"], params["stack"]):
        blocks = []
        for fb, b in zip(fseg, seg):
            m = dict(b["mixer"])
            if sibling in m and leaf in m:
                w = fb["mixer"][leaf]
                n = w.shape[-1] // tp
                m[leaf] = w.narrow(-1, rank * n, n).contiguous()
            blocks.append({**b, "mixer": m})
        out.append(blocks)
    return {**params, "stack": out}


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
        for case, (arch, over, tp, dp, B, T, ML, steps, extra) in \
                CASES.items():
            cfg = _cfg(arch, over)
            with open(os.path.join(out_dir, f"{case}.pkl"), "rb") as f:
                tree = pickle.load(f)
            group = dist.group.WORLD if tp == 4 else model2
            full = params_from_jax(tree, cfg, "cpu")
            m = axis_index(group)
            params = serve_slice(full, cfg, m, tp)
            model = Model(cfg)
            tokens, forced, src = _inputs(case)
            batch = {"tokens": torch.from_numpy(tokens).long()}
            if src is not None:
                batch["src"] = torch.from_numpy(src)
            lengths = (data,) if dp > 1 else ()
            res = {}
            with serve_region(group, lengths, ML):
                prefill = make_prefill_step(model, ML)
                logits, cache = prefill(params, batch)
                res["prefill"] = logits.numpy()
                ptrs = [t.data_ptr() for t in tree_leaves(cache)]
                for i in range(steps):
                    step = make_decode_step(model, mla_absorb=_absorb(case, i),
                                            donate=True)
                    pos = T + i if case != "mla_length" or i % 2 == 0 \
                        else torch.full((B,), T + i)
                    logits, new = step(params,
                                       torch.from_numpy(forced[i]).long(),
                                       cache, pos)
                    res[f"decode{i}"] = logits.numpy()
                    assert new is cache
                assert [t.data_ptr() for t in tree_leaves(cache)] == ptrs
                for c, leaf, sib in PACKED:
                    if c == case:
                        wrong = _contiguous(full, params, leaf, sib, m, tp)
                        res[f"contiguous_{leaf}_{sib}"] = \
                            prefill(wrong, batch)[0].numpy()
            res["cache"] = [t.numpy() for t in tree_leaves(cache)]
            res["coords"] = (axis_index(data), m)
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
    from repro_torch.convert import params_from_jax
    from repro_torch.models.model import Model
    arch, over, tp, dp, B, T, ML, steps, extra = CASES[case]
    jcfg, cfg = _cfg(arch, over, jax_side=True), _cfg(arch, over)
    jmodel = JModel(jcfg)
    tree = _weights(case)
    tokens, forced, src = _inputs(case)
    jbatch = {"tokens": jnp.asarray(tokens)}
    if src is not None:
        jbatch["src"] = jnp.asarray(src)
    jl, jc = jax.jit(jmodel.prefill, static_argnames=("max_len",))(
        tree, jbatch, max_len=ML)
    jdecode = jax.jit(jmodel.decode_step, static_argnames=("mla_absorb",))
    jax_logits = [np.asarray(jl)]
    for i in range(steps):
        jl, jc = jdecode(tree, jnp.asarray(forced[i]), jc, jnp.int32(T + i),
                         mla_absorb=_absorb(case, i))
        jax_logits.append(np.asarray(jl))
    model = Model(cfg)
    params = params_from_jax(tree, cfg, "cpu")
    batch = {"tokens": torch.from_numpy(tokens).long()}
    if src is not None:
        batch["src"] = torch.from_numpy(src)
    with torch.no_grad():
        tl, tc = model.prefill(params, batch, max_len=ML)
        port_logits = [tl.numpy()]
        for i in range(steps):
            tl, tc = model.decode_step(params,
                                       torch.from_numpy(forced[i]).long(),
                                       tc, T + i, mla_absorb=_absorb(case, i))
            port_logits.append(tl.numpy())
    return tree, jax_logits, port_logits, tc


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    import torch
    from repro_torch.launch.dist import spawn
    out = tmp_path_factory.mktemp("serve_tp_families")
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


def _gap(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _close(a, b, rel):
    gap = _gap(a, b)
    assert gap <= rel, f"max|Δ| / max|ref| = {gap:.3e} > {rel}"


@pytest.mark.parametrize("case", list(CASES))
def test_serve_case_matches_unsharded_and_reference(served, case):
    from repro_torch._tree import tree_leaves
    from repro_torch.convert import cache_slice
    refs, ranks = served
    jax_logits, port_logits, cache = refs[case]
    arch, over, tp, dp, B, T, ML, steps, extra = CASES[case]
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
                            dp, src_len=extra.get("src", 0))
        got = r["cache"]
        want = [t.numpy() for t in tree_leaves(share)]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close(a, b, REL_PORT)


def test_cache_shares_hold_the_split(served):
    _, ranks = served
    shapes = {case: sorted(a.shape for a in ranks[0][case]["cache"])
              for case in CASES}
    # MLA: the latents' 2048 positions a quarter, 4096 an (data, model)
    # quarter, 20 whole
    assert [s[1] for s in shapes["mla_length"]] == [512] * 4
    assert [s[1] for s in shapes["mla_batch1_data_model"]] == [1024] * 4
    assert [s[1] for s in shapes["mla_whole"]] == [20] * 4
    # Mamba: the conv tail and h on the rank's 64 / 32 of d_inner's 128;
    # at B = 1, h's 4096 channels in (data, model) quarters, the conv's
    # 4096 in model halves
    assert shapes["mamba_tp2"] == [(2, 3, 64), (2, 3, 64), (2, 64, 16),
                                   (2, 64, 16)]
    assert shapes["mamba_tp4"][0] == (2, 3, 32)
    assert shapes["mamba_batch1_data_model"] == [(1, 3, 2048),
                                                 (1, 1024, 16)]
    # xLSTM, H = 2 over 4: C's dh_v 64 a quarter, the conv's 128 a quarter,
    # n and m whole; the sLSTM's h's dh 32 a quarter, c, n, m whole
    assert shapes["xlstm_tp4"] == sorted([
        (2, 2, 16, 64), (2, 2, 64), (2, 2), (2, 3, 32),
        (2, 2, 32), (2, 2, 32), (2, 2, 32), (2, 2, 8)])
    # the encoder-decoder: 4 kv heads, 2 a rank, in the self and the cross
    # caches of both layers
    assert all(s[3] == 2 for s in shapes["encdec_tp2"])


@pytest.mark.parametrize("case,leaf,sibling", PACKED)
def test_a_contiguous_cut_of_a_packed_leaf_is_wrong(served, case, leaf,
                                                    sibling):
    refs, ranks = served
    _, port_logits, _ = refs[case]
    got = ranks[0][case][f"contiguous_{leaf}_{sibling}"]
    assert _gap(got, port_logits[0]) > REL_WRONG
    _close(ranks[0][case]["prefill"], port_logits[0], REL_PORT)


FAMILIES = ["deepseek-v2-lite-16b", "jamba-v0.1-52b", "xlstm-125m",
            "seamless-m4t-large-v2"]


def _sizes(multi_pod: bool):
    return {"pod": 2, "data": 16, "model": 16} if multi_pod else \
        {"data": 16, "model": 16}


def _cut(shape, spec, sizes):
    """``shape`` with each dim divided by the mesh axes its spec names."""
    out = []
    for n, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if entry is None else \
            entry if isinstance(entry, tuple) else (entry,)
        out.append(n // math.prod(sizes[a] for a in axes))
    return tuple(out)


@pytest.mark.parametrize("arch", FAMILIES)
def test_rank_shares_have_the_reference_serve_shapes(arch):
    """serve_slice of the descriptors at tp = 16 (every rank) has each
    leaf's shape cut as the reference's ``partition_specs("serve")`` cuts
    it over the model axis of 16, but for the kv columns of a layer with
    fewer kv heads than ranks (jamba's 8): a rank's head block holds the
    whole kv head its query heads read (``attention.head_layout``)."""
    import jax
    from jax.sharding import PartitionSpec
    from repro.configs import get_config as jget_config
    from repro.models import Model as JModel
    import torch
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.configs import get_config
    from repro_torch.convert import serve_slice
    from repro_torch.models.layers import ParamDesc, TensorSpec
    from repro_torch.models.model import Model
    cfg = get_config(arch)
    desc = Model(cfg).param_desc()
    specs = jax.tree.leaves(JModel(jget_config(arch)).partition_specs(
        "serve"), is_leaf=lambda x: isinstance(x, PartitionSpec))
    leaves = tree_leaves(desc, is_leaf=lambda x: isinstance(x, ParamDesc))
    whole_kv = cfg.num_kv_heads < 16

    def want_shape(d, s):
        if whole_kv and "kv" in d.axes:
            return tuple(cfg.hd if a == "kv" else n
                         for n, a in zip(d.shape, d.axes))
        return _cut(d.shape, s, {"model": 16})
    want = [want_shape(d, s) for d, s in zip(leaves, specs)]
    spec_tree = tree_map(lambda d: TensorSpec(d.shape, torch.float32),
                         desc, is_leaf=lambda x: isinstance(x, ParamDesc))
    for rank in (0, 5, 15):
        got = [t.shape for t in tree_leaves(
            serve_slice(spec_tree, cfg, rank, 16),
            is_leaf=lambda x: isinstance(x, TensorSpec))]
        assert got == want


def _family_decode_pairs():
    from repro_torch.configs import applicable_shapes, get_config
    return [(a, s) for a in FAMILIES for s in applicable_shapes(
        get_config(a)) if s in ("decode_32k", "long_500k")]


@pytest.mark.parametrize("arch,shape", _family_decode_pairs())
def test_rank_cache_shares_have_the_reference_shapes(arch, shape):
    """cache_slice of the decode cache at tp = 16 over the mesh's data
    axes has every leaf's shape cut as the reference's
    ``input_partition_specs(shape)["cache"]`` cuts it (16x16 and
    2x16x16)."""
    import jax
    from jax.sharding import PartitionSpec
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget_config
    from repro.models import Model as JModel
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.convert import cache_slice
    from repro_torch.models.layers import TensorSpec
    from repro_torch.models.model import Model
    cfg = get_config(arch)
    B, L = SHAPES[shape].global_batch, SHAPES[shape].seq_len
    src = L if cfg.is_encoder_decoder else 0
    full = tree_leaves(Model(cfg).init_cache(B, L, src_len=src),
                       is_leaf=lambda x: isinstance(x, TensorSpec))
    for multi_pod in (False, True):
        sizes = _sizes(multi_pod)
        dp = sizes["data"] * sizes.get("pod", 1)
        specs = jax.tree.leaves(
            JModel(jget_config(arch)).input_partition_specs(
                JSHAPES[shape], multi_pod)["cache"],
            is_leaf=lambda x: isinstance(x, PartitionSpec))
        want = [_cut(t.shape, s, sizes) for t, s in zip(full, specs)]
        got = [t.shape for t in tree_leaves(
            cache_slice(Model(cfg).init_cache(B, L, src_len=src), cfg, B, L,
                        3, 16, 1, dp, src_len=src),
            is_leaf=lambda x: isinstance(x, TensorSpec))]
        assert got == want, multi_pod
