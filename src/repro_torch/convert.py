"""Carry a JAX parameter tree over to the port, and the port's trees back.

``params_from_jax(jax.tree.map(np.asarray, jax_model.init(key)), cfg)``
returns the port's parameters holding the same values, so both packages
compute the same function on the same inputs (the parity tests).  The
input is plain numpy — this module imports no JAX — with the JAX
package's layout::

    {"embed": {"table"}, "final_norm": {"scale"}, ["lm_head": {"table"}],
     "stack": [[BLOCK]]  or  "encdec": ENCDEC}

    BLOCK: {"norm1", "mixer": MIXER, ["norm2", "ffn": FFN]}
           or {"mixer": XLSTM}                (mLSTM / sLSTM blocks)
    MIXER: attention {wq, wk, wv, wo, [q_norm, k_norm]}
           or MLA    {wq, w_dkv, kv_norm: {scale}, w_ukv, wo}
           or Mamba  {in_proj, conv_w, conv_b, x_proj, dt_proj_w,
                      dt_proj_b, A_log, D, out_proj}
    XLSTM: mLSTM     {norm, up, conv_w, conv_b, wq, wk, wv, w_if, b_if,
                      out_norm, down}
           or sLSTM  {norm, w_in, r, b, out_norm, up, down}
    FFN:   dense     {wi_gate, wi_up, wo}
           or MoE    {router (d, E), wi_gate (E, d, ff), wi_up (E, d, ff),
                      wo (E, ff, d), [shared: {wi_gate, wi_up, wo}]}
    ENCDEC: {"enc_stack": BLOCK (attention, dense FFN), "enc_norm",
             "dec_stack": {norm1, self: attention, norm_x,
                           cross: {wq, wk, wv, wo}, norm2, ffn: dense},
             "dec_norm"}

where ``lm_head`` exists for an untied head (every registered model but
gemma-2b), ``q_norm``/``k_norm`` for QK-norm (gemma3-4b, chameleon-34b,
qwen3-moe-30b-a3b), MLA for deepseek-v2-lite-16b, Mamba for
jamba-v0.1-52b's non-attention layers, the xLSTM blocks for xlstm-125m,
``encdec`` for seamless-m4t-large-v2 (whose ``final_norm`` is unused),
the FFN only where the layer has one (``norm2`` with it), the MoE FFN
for the MoE layers of qwen3-moe-30b-a3b, deepseek-v2-lite-16b and
jamba-v0.1-52b (``shared`` for deepseek-v2-lite-16b's shared experts),
every leaf of a segment with ``repeats > 1`` has a leading ``repeats``
axis, and every leaf of ``enc_stack`` / ``dec_stack`` one of the
encoder's / decoder's layers.  The keys expected
are the port's own ``Model(cfg).param_desc()``, so a tree missing one of
them, or holding one more, is refused.  bf16 arrays (numpy's ``bfloat16``
extension dtype) cross bit for bit.

``tp_slice(params, rank, tp)`` and ``ep_slice(params, rank, ep)`` cut a
parameter tree to one model-axis rank's share by the reference's logical
axes ("ffn" and "experts" go to the model axis): every dense FFN's
``wi_gate`` / ``wi_up`` on their output features and ``wo`` on its input
features, and every MoE FFN's stacked experts on the expert dim.  The
rest of the tree (and a MoE FFN's router and shared experts) is kept
whole, replicated on every rank.

``serve_slice(params, cfg, rank, tp)`` cuts a tree to what model-axis
rank ``rank`` holds when serving (``sharding_ctx.serve_region``): every
leaf on the dim that the reference's serve rules put on the model axis
(``Model.partition_dims("serve")``), the vocabulary, ffn and expert dims
in ``tp`` equal blocks, the heads and kv heads by the rank's head block
(``attention.head_layout``), a leaf that packs several tensors on its
split dim (``ParamDesc.parts``: Mamba's ``in_proj``, the mLSTM's and the
sLSTM's ``up``, the sLSTM's ``w_in``) by the rank's block of each;
norms, routers and MLA's latent projections whole.
``serve_init(cfg, generator, rank, tp)`` draws the same values leaf by
leaf and keeps only the rank's share, so a rank never holds the whole
tree.  ``train_slice`` / ``train_init`` are the same for training
(``sharding_ctx.train_region``), by the train rules' model-axis dims,
which are the serve rules' (the train rules' FSDP dim, d_model over
data, is not taken: the port replicates parameters over data).
``cache_slice(cache, cfg, batch, max_len, rank, tp)`` cuts a
decode cache (tensors or ``TensorSpec``s) to the rank's share by
``Model.input_partition_specs``' rule with tp as the model axis' size.

``to_numpy(tree)`` is the reverse for comparisons: any tree of the port's
tensors (parameters, optimizer moments, EF residuals) as numpy arrays on
the host, bf16 widened to f32 (exact), so tests can hold it against the
JAX package's tree.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._tree import tree_leaves, tree_map, tree_map_with_path
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import head_layout
from repro_torch.models.layers import (ParamDesc, TensorSpec, _init_leaf,
                                       partition_specs, sharding_rules)
from repro_torch.models.model import Model
from repro_torch.models.sharding_ctx import cache_leaf_spec


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device)


def _convert(desc, tree, device, path: str):
    if isinstance(desc, ParamDesc):
        t = _to_tensor(tree, device)
        if tuple(t.shape) != tuple(desc.shape):
            raise ValueError(f"{path}: shape {tuple(t.shape)} != "
                             f"{tuple(desc.shape)}")
        return t
    if isinstance(desc, dict):
        if not isinstance(tree, dict) or set(tree) != set(desc):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{path}: keys {got} != {sorted(desc)}")
        return {k: _convert(desc[k], tree[k], device, f"{path}/{k}")
                for k in sorted(desc)}
    if not isinstance(tree, (list, tuple)) or len(tree) != len(desc):
        raise ValueError(f"{path}: expected a list of {len(desc)} entries")
    return [_convert(d, t, device, f"{path}/{i}")
            for i, (d, t) in enumerate(zip(desc, tree))]


def params_from_jax(tree, cfg: ModelConfig, device: DeviceLike = None):
    """The port's parameter tree for ``cfg`` from a numpy copy of the JAX
    package's tree; raises on any missing key or shape mismatch."""
    return _convert(Model(cfg).param_desc(), tree, resolve_device(device),
                    "params")


def _block(t: torch.Tensor, dim: int, rank: int, n: int) -> torch.Tensor:
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of shape {tuple(t.shape)} does not "
                         f"split over {n} ranks")
    return t.narrow(dim, rank * (size // n), size // n).contiguous()


def mlp_slice(ffn, rank: int, tp: int):
    """Tensor-parallel rank ``rank``'s slice of one dense FFN ``{wi_gate,
    wi_up, wo}`` (leaves may carry a leading stacked-layer dim)."""
    return {"wi_gate": _block(ffn["wi_gate"], -1, rank, tp),
            "wi_up": _block(ffn["wi_up"], -1, rank, tp),
            "wo": _block(ffn["wo"], -2, rank, tp)}


def experts_slice(ffn, rank: int, ep: int):
    """Expert-parallel rank ``rank``'s block of one MoE FFN's experts
    (``wi_gate`` / ``wi_up`` (E, d, ff), ``wo`` (E, ff, d), with an
    optional leading stacked-layer dim); router and shared experts kept."""
    out = dict(ffn)
    for k in ("wi_gate", "wi_up", "wo"):
        out[k] = _block(ffn[k], -3, rank, ep)
    return out


def _cut_ffns(tree, cut):
    if isinstance(tree, dict):
        return {k: (cut(v) if k == "ffn" and isinstance(v, dict)
                    else _cut_ffns(v, cut))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cut_ffns(v, cut) for v in tree]
    return tree


def tp_slice(params, rank: int, tp: int):
    """The parameter tree tp rank ``rank`` of ``tp`` holds: every dense
    FFN cut to its ffn slice (``mlp_slice``); MoE FFNs and everything
    else whole."""
    return _cut_ffns(params, lambda f: f if "router" in f
                     else mlp_slice(f, rank, tp))


def ep_slice(params, rank: int, ep: int):
    """The parameter tree ep rank ``rank`` of ``ep`` holds: every MoE
    FFN's experts cut to its block (``experts_slice``); the rest whole."""
    return _cut_ffns(params, lambda f: experts_slice(f, rank, ep)
                     if "router" in f else f)


def _leaf_cut(cfg: ModelConfig, rank: int, tp: int):
    """The cut of one leaf (``cut(desc, dim, t)``: ``t`` a tensor or a
    ``TensorSpec``, ``dim`` its model-axis dim or None) of model-axis
    rank ``rank``: the heads and kv heads by the rank's head block, every
    other split dim (vocab, ffn, experts, inner) in ``tp`` equal blocks,
    and a leaf of ``parts`` packed tensors (``ParamDesc.parts``) by the
    rank's block of each part; raises where a dim does not split."""
    lay = head_layout(cfg, tp, rank)
    H, KV = cfg.num_heads, cfg.num_kv_heads

    def cut(d: ParamDesc, dim, t):
        if dim is None:
            return t
        n, axis = d.shape[dim], d.axes[dim]
        if axis in ("heads", "kv"):
            per = n // (H if axis == "heads" else KV)
            lo, size = ((lay.h0, lay.hl) if axis == "heads"
                        else (lay.kv0, lay.kvl))
            spans = [(lo * per, size * per)]
        else:
            piece = n // d.parts
            if n % d.parts or piece % tp:
                what = f"{d.parts} parts of " if d.parts > 1 else ""
                raise ValueError(f"{axis} dim of {what}{d.shape} does not "
                                 f"split over tp={tp}")
            block = piece // tp
            spans = [(k * piece + rank * block, block)
                     for k in range(d.parts)]
        if isinstance(t, TensorSpec):
            shape = list(t.shape)
            shape[dim] = sum(size for _, size in spans)
            return TensorSpec(tuple(shape), t.dtype)
        return torch.cat([t.narrow(dim, lo, size) for lo, size in spans],
                         dim=dim).contiguous()
    return cut


def _model_cuts(cfg: ModelConfig, rank: int, tp: int, phase: str):
    """(descriptor tree, its model-axis dims under ``phase``'s rules, the
    cut of one leaf, :func:`_leaf_cut`) of model-axis rank ``rank``.  The
    train rules differ from the serve rules only in the d_model dim
    ("embed"), which they put over the data axes (FSDP), not on the model
    axis, so both phases cut the same dims."""
    model = Model(cfg)
    return (model.param_desc(), model.partition_dims(phase),
            _leaf_cut(cfg, rank, tp))


def train_share(params, desc, cfg: ModelConfig, rank: int, tp: int):
    """Model-axis rank ``rank``'s cut of a subtree ``params`` (one mixer's
    leaves, unstacked) under the train rules, by its descriptors
    ``desc``: each split leaf a contiguous copy (differentiable), each
    whole leaf itself: the lanes of the train layout's control
    (``layers.Lanes``)."""
    rules = sharding_rules("train")
    cut = _leaf_cut(cfg, rank, tp)
    return tree_map(
        lambda d, t: cut(d, next((i for i, a in enumerate(
            partition_specs(d, rules)) if a == "model"), None), t),
        desc, params, is_leaf=lambda x: isinstance(x, ParamDesc))


def _slice(params, cfg: ModelConfig, rank: int, tp: int, phase: str):
    desc, dims, cut = _model_cuts(cfg, rank, tp, phase)
    return tree_map(cut, desc, dims, params,
                    is_leaf=lambda x: isinstance(x, ParamDesc))


def _init(cfg: ModelConfig, generator, rank: int, tp: int, dtype,
          phase: str):
    from repro_torch.models.model import resolve_dtype
    dtype = dtype or resolve_dtype(cfg.param_dtype)
    desc, dims, cut = _model_cuts(cfg, rank, tp, phase)
    return tree_map(lambda d, dim: cut(d, dim, _init_leaf(d, generator,
                                                          dtype)),
                    desc, dims, is_leaf=lambda x: isinstance(x, ParamDesc))


def serve_slice(params, cfg: ModelConfig, rank: int, tp: int):
    """The parameter tree model-axis rank ``rank`` of ``tp`` holds when
    serving (see the module docstring)."""
    return _slice(params, cfg, rank, tp, "serve")


def serve_init(cfg: ModelConfig, generator, rank: int, tp: int, dtype=None):
    """``serve_slice(Model(cfg).init(generator, dtype), cfg, rank, tp)``
    drawn leaf by leaf: each leaf is cut as soon as it is drawn, so the
    rank holds one whole leaf at most, never the whole tree."""
    return _init(cfg, generator, rank, tp, dtype, "serve")


def train_slice(params, cfg: ModelConfig, rank: int, tp: int):
    """The parameter tree model-axis rank ``rank`` of ``tp`` holds when
    training under ``sharding_ctx.train_region``: the dims that the
    reference's train rules put on the model axis
    (``Model.partition_dims("train")``), cut as :func:`serve_slice` cuts
    them.  The d_model dim stays whole: the port keeps every parameter
    replicated over the data axes, where the reference's rules shard it
    (FSDP)."""
    return _slice(params, cfg, rank, tp, "train")


def train_init(cfg: ModelConfig, generator, rank: int, tp: int, dtype=None):
    """``train_slice(Model(cfg).init(generator, dtype), cfg, rank, tp)``
    drawn leaf by leaf, as :func:`serve_init`."""
    return _init(cfg, generator, rank, tp, dtype, "train")


def train_classes(params, cfg: ModelConfig, rank: int, tp: int):
    """Each leaf of rank ``rank``'s share ``params`` under the train
    layout (leaf order): over how many distinct blocks the group of
    ``tp`` holds it: the replica edge's blocks for a leaf that several
    ranks share (``model.train_edges``: a kv head's or a head block's
    columns, the QK-norm scales, MLA's latent projection, the mLSTM's
    gate bias and output norm), 1 for any other leaf every rank holds
    whole (the norms, the routers, the sLSTM's cell), ``tp`` for a leaf
    each rank holds its own block of.  Leaves of one class are held the
    same by the same runs of ranks, so a packed DP edge that never tiles
    two classes together (``SyncConfig.classes``) keeps every shared
    leaf's update the same on all its ranks."""
    from repro_torch.models.model import train_edges
    dims = {}
    tree_map_with_path(lambda path, dim: dims.__setitem__(path, dim),
                       Model(cfg).partition_dims("train"))
    edges = train_edges(cfg, tp, rank)

    def one(path, _):
        at = -2 if path[-1] == "scale" else -1
        blocks = edges.get(path[:at], {}).get(path[at])
        if blocks is not None:
            return blocks[0]
        return 1 if dims[path] is None else tp
    return tuple(tree_leaves(tree_map_with_path(one, params)))


def cache_slice(cache, cfg: ModelConfig, batch: int, max_len: int, rank: int,
                tp: int, data_index: int = 0, dp: int = 1, src_len: int = 0):
    """Model-axis rank ``rank``'s share of a decode cache of global
    ``batch`` and length ``max_len`` (leaves: tensors or ``TensorSpec``s),
    laid out by ``Model.input_partition_specs`` with ``tp`` as the model
    axis' size (the batch dim where the model puts it: a layer count equal
    to the batch is not read as one); ``data_index`` of ``dp`` is the
    rank's place on the data axes (its batch block where the batch is
    split, its length block where a batch-1 cache's length is);
    ``src_len``: the encoder-decoder's cross entries a layer."""
    model = Model(cfg)

    def batch_dim(path):
        # the encoder-decoder's leaves are stacked over its decoder layers
        return 1 if cfg.is_encoder_decoder else \
            int(model.plan[path[0]].repeats > 1)
    specs = tree_map_with_path(
        lambda path, s: cache_leaf_spec(path[-1], s.shape, batch, tp,
                                        batch_dim=batch_dim(path)),
        model.init_cache(batch, max_len, src_len=src_len))
    place = {"model": (rank, tp), "data": (data_index, dp)}

    def one(spec, t):
        shape = list(t.shape)
        cuts = []
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            axes = tuple(dict.fromkeys("model" if a == "model" else "data"
                                       for a in axes))
            index, parts = 0, 1
            for a in axes:
                i, n = place[a]
                index, parts = index * n + i, parts * n
            if shape[dim] % parts:
                raise ValueError(f"cache dim {dim} of {tuple(t.shape)} does "
                                 f"not split into {parts}")
            shape[dim] //= parts
            cuts.append((dim, index * shape[dim], shape[dim]))
        if isinstance(t, TensorSpec):
            return TensorSpec(tuple(shape), t.dtype)
        for dim, lo, size in cuts:
            t = t.narrow(dim, lo, size)
        return t.contiguous()
    return tree_map(one, specs, cache, is_leaf=lambda x: isinstance(x, tuple))


def to_numpy(tree):
    """The tree's tensors as host numpy arrays (bf16 widened to f32, which
    is exact); other leaves pass through."""
    def one(t):
        if not isinstance(t, torch.Tensor):
            return t
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    return tree_map(one, tree)
