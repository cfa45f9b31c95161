"""Decoder stack of the port, counterpart of
``repro/models/transformer.py``: attention, MLA, Mamba, mLSTM and sLSTM
blocks, the first three with a dense or MoE FFN (xLSTM blocks carry their
own norms and projections).

The stacked-repeats layout is kept: a segment of ``repeats`` identical
periods holds every parameter and cache leaf with a leading ``repeats``
axis, and the stack loops over that axis where the reference scans.  So
a segment's cache stays one tensor per leaf, and the paged serving pool
quantizes all of a segment's layers in one call.  The recurrent mixers'
caches (Mamba's ``h``/``conv``, the xLSTM states) are per-slot state
leaves of that pool, never paged.

Training (:func:`stack_train`) checkpoints every layer
(``torch.utils.checkpoint``), as the reference rematerializes every period,
and splits each stacked leaf into its layers once (``unbind``): indexing
``p[i]`` per layer would make autograd allocate a full-size zero gradient
of the stacked leaf for every layer.  The MoE aux loss is summed in f32
in layer order.  Under ``sharding_ctx.tp_region(group)`` the training
blocks' dense FFNs run tensor-parallel (``layers.mlp_tp``) on the rank's
ffn slice, and under ``sharding_ctx.ep_region(group)`` their MoE FFNs
expert-parallel (``moe_ffn(ep_axis=group)``) on the rank's expert block;
the prefill and decode blocks do neither.  Under
``sharding_ctx.serve_region(group, ...)`` the prefill and decode blocks
run the reference's serve layout over ``group`` on the rank's share of
the parameters (``convert.serve_slice``): head-parallel attention
(``attention.head_layout``), the dense FFNs' ffn slice (``mlp_tp``) and
the experts' block (``moe_ffn`` / ``moe_decode_ffn`` with ``tp_axis``);
the grouped-query attention stacks only (:func:`serve_tp_reason`).  The
decode stack writes into the cache it is given when ``inplace`` (the
reference's donated cache).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._tree import tree_leaves, tree_map, tree_map_with_path
from repro_torch.configs.base import LayerSpec, ModelConfig, Segment
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (TensorSpec, mlp, mlp_desc, mlp_tp,
                                       norm_desc, rmsnorm, stack_desc)
from repro_torch.models.sharding_ctx import (ep_axis, ep_region,
                                             serve_axes, tp_axis, tp_region)

XLSTM_MIXERS = ("mlstm", "slstm")
_MIXER_DESC = {"attn": attn.attn_desc, "mla": attn.mla_desc,
               "mamba": ssm_mod.mamba_desc, "mlstm": xlstm_mod.mlstm_desc,
               "slstm": xlstm_mod.slstm_desc}


def _mixer_desc(cfg: ModelConfig, spec: LayerSpec):
    if spec.mixer not in _MIXER_DESC:
        raise ValueError(spec.mixer)
    return _MIXER_DESC[spec.mixer](cfg)


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# One block
# ---------------------------------------------------------------------------

def block_desc(cfg: ModelConfig, spec: LayerSpec) -> Dict[str, Any]:
    if spec.mixer in XLSTM_MIXERS:
        # xLSTM blocks carry their own norms and FFN
        return {"mixer": _mixer_desc(cfg, spec)}
    desc: Dict[str, Any] = {"norm1": norm_desc(cfg.d_model),
                            "mixer": _mixer_desc(cfg, spec)}
    if spec.ffn != "none":
        desc["norm2"] = norm_desc(cfg.d_model)
        desc["ffn"] = (moe_mod.moe_desc(cfg) if spec.ffn == "moe"
                       else mlp_desc(cfg.d_model, cfg.d_ff))
    return desc


def serve_tp_reason(cfg: ModelConfig):
    """None where the serve layout over the model axis runs ``cfg`` (a
    decoder of grouped-query attention layers), else why not."""
    mixers = {cfg.layer_spec(i).mixer for i in range(cfg.num_layers)}
    if cfg.is_encoder_decoder or mixers != {"attn"}:
        kinds = "the encoder-decoder" if cfg.is_encoder_decoder else \
            "/".join(sorted(mixers - {"attn"}))
        return (f"serving {cfg.name} over the model axis ({kinds}) is the "
                f"remainder of ROADMAP queue 1 item 15: the whole model "
                f"sits on each rank")
    return None


def _serve_tp(cfg: ModelConfig):
    """The serve region's tp group, raising for a model it cannot run."""
    sa = serve_axes()
    if sa is None:
        return None
    reason = serve_tp_reason(cfg)
    if reason:
        raise NotImplementedError(reason)
    return sa.tp


def _ffn(params, cfg: ModelConfig, spec: LayerSpec, x, tp=None, ep=None,
         serve=None):
    """x + FFN(norm2(x)) and the MoE aux loss (an f32 zero for a dense
    FFN).  ``tp`` (a process group): the dense FFN is tensor-parallel,
    ``params`` hold this rank's ffn slice and the Megatron wire
    (``mlp_tp``) reduces the activations over ``tp``.  ``ep`` (a process
    group): the MoE FFN is expert-parallel over it, ``params`` hold this
    rank's block of the experts.  ``serve`` (the serve region's group):
    both, the MoE FFN on its expert block with one all-reduce."""
    aux = _zero(x)
    if spec.ffn == "none":
        return x, aux
    h = rmsnorm(params["norm2"], x, eps=cfg.norm_eps)
    tp = serve if serve is not None else tp
    if spec.ffn == "moe":
        h, aux = moe_mod.moe_ffn(params["ffn"], cfg, h, ep_axis=ep,
                                 tp_axis=serve)
    elif tp is not None:
        h = mlp_tp(params["ffn"], h, cfg.activation, group=tp)
    else:
        h = mlp(params["ffn"], h, cfg.activation)
    return x + h, aux


def block_train(params, cfg: ModelConfig, spec: LayerSpec, x, positions,
                causal: bool = True, kernel: bool = False):
    """Full-sequence block.  Returns (x, aux).  ``causal=False`` is the
    encoder's bidirectional attention, through ``ops.flash_attention``
    when ``kernel`` (the encoder at inference), else through the
    differentiable chunked attention (training)."""
    if spec.mixer in XLSTM_MIXERS:
        f = (xlstm_mod.mlstm_forward if spec.mixer == "mlstm"
             else xlstm_mod.slstm_forward)
        return x + f(params["mixer"], cfg, x), _zero(x)
    h = rmsnorm(params["norm1"], x, eps=cfg.norm_eps)
    if spec.mixer == "attn" and not causal:
        h = _attn_bidirectional(params["mixer"], cfg, spec, h, positions,
                                kernel)
    elif spec.mixer == "attn":
        h = attn.attn_forward(params["mixer"], cfg, spec, h, positions)
    elif spec.mixer == "mla":
        h = attn.mla_forward(params["mixer"], cfg, spec, h, positions)
    else:
        h = ssm_mod.mamba_forward(params["mixer"], cfg, h)
    # under an active tp region the dense FFN runs the Megatron wire, under
    # an ep region the MoE FFN exchanges its tokens over the ep group
    return _ffn(params, cfg, spec, x + h, tp=tp_axis(), ep=ep_axis())


def _attn_bidirectional(params, cfg: ModelConfig, spec: LayerSpec, x,
                        positions, kernel: bool):
    B, T, _ = x.shape
    q, k, v = attn._project_qkv(params, cfg, x, positions)
    fn = ops.flash_attention if kernel else attn.flash_attention
    out = fn(q, k, v, causal=False, window=spec.window,
             softcap=cfg.attn_logit_softcap)
    return out.reshape(B, T, -1) @ params["wo"]


def block_prefill(params, cfg: ModelConfig, spec: LayerSpec, x, positions,
                  max_len: int):
    """Full-sequence block that also emits this layer's decode cache.
    Returns (x, aux, cache)."""
    serve = _serve_tp(cfg)
    if spec.mixer in XLSTM_MIXERS:
        f = (xlstm_mod.mlstm_forward if spec.mixer == "mlstm"
             else xlstm_mod.slstm_forward)
        h, cache = f(params["mixer"], cfg, x, return_state=True)
        return x + h, _zero(x), cache
    h = rmsnorm(params["norm1"], x, eps=cfg.norm_eps)
    if spec.mixer == "mamba":
        h, cache = ssm_mod.mamba_forward(params["mixer"], cfg, h,
                                         return_state=True)
    else:
        mixer = attn.mla_prefill if spec.mixer == "mla" else attn.attn_prefill
        h, cache = mixer(params["mixer"], cfg, spec, h, positions, max_len)
    x, aux = _ffn(params, cfg, spec, x + h, serve=serve)
    return x, aux, cache


def block_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, max_len: int,
                dtype):
    if spec.mixer == "attn":
        return attn.init_attn_cache(cfg, spec, batch, max_len, dtype)
    if spec.mixer == "mla":
        return attn.init_mla_cache(cfg, batch, max_len, dtype)
    if spec.mixer == "mamba":
        return ssm_mod.init_mamba_state(cfg, batch, dtype)
    if spec.mixer == "mlstm":
        return xlstm_mod.init_mlstm_state(cfg, batch, dtype)
    if spec.mixer == "slstm":
        return xlstm_mod.init_slstm_state(cfg, batch, dtype)
    raise ValueError(spec.mixer)


def block_decode(params, cfg: ModelConfig, spec: LayerSpec, x, cache, pos,
                 mla_absorb: bool = False, moe_dispatch: bool = False,
                 inplace: bool = False):
    """One-token block step.  Returns (x, new_cache).  ``mla_absorb``
    picks MLA's absorbed decode; ``moe_dispatch`` runs a decode MoE
    through the capacity dispatch of training instead of the per-token
    gather of the experts' weights; ``inplace`` writes attention's and
    MLA's new entries into ``cache`` itself."""
    serve = _serve_tp(cfg)
    if spec.mixer in XLSTM_MIXERS:
        f = (xlstm_mod.mlstm_decode if spec.mixer == "mlstm"
             else xlstm_mod.slstm_decode)
        h, new_cache = f(params["mixer"], cfg, x, cache)
        return x + h, new_cache
    h = rmsnorm(params["norm1"], x, eps=cfg.norm_eps)
    if spec.mixer == "mamba":
        h, new_cache = ssm_mod.mamba_decode(params["mixer"], cfg, h, cache)
    elif spec.mixer == "mla":
        h, new_cache = attn.mla_decode(params["mixer"], cfg, spec, h, cache,
                                       pos, absorb=mla_absorb,
                                       inplace=inplace)
    else:
        h, new_cache = attn.attn_decode(params["mixer"], cfg, spec, h, cache,
                                        pos, inplace=inplace)
    x = x + h
    if spec.ffn != "none":
        h = rmsnorm(params["norm2"], x, eps=cfg.norm_eps)
        if spec.ffn == "moe":
            h = (moe_mod.moe_ffn(params["ffn"], cfg, h, tp_axis=serve)[0]
                 if moe_dispatch else
                 moe_mod.moe_decode_ffn(params["ffn"], cfg, h,
                                        tp_axis=serve))
        elif serve is not None:
            h = mlp_tp(params["ffn"], h, cfg.activation, group=serve)
        else:
            h = mlp(params["ffn"], h, cfg.activation)
        x = x + h
    return x, new_cache


def checkpointed(fn, *args):
    """``torch.utils.checkpoint`` of ``fn(*args)``, whose recomputation in
    the backward leaves the MoE drop tap alone: each routed choice is
    counted once per forward.  The recomputation runs in the tp and ep
    regions of the forward (the backward may run outside them)."""
    ran = [False]
    group, experts = tp_axis(), ep_axis()

    def once(*a):
        with tp_region(group), ep_region(experts):
            if ran[0]:
                with moe_mod.drop_tap_paused():
                    return fn(*a)
            ran[0] = True
            return fn(*a)
    return checkpoint(once, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# Stack (a loop over each segment's repeats)
# ---------------------------------------------------------------------------

def stack_desc_tree(cfg: ModelConfig, plan: Tuple[Segment, ...]) -> List[Any]:
    """Descriptor tree: list over segments; each segment is a list over
    period positions of block descriptors, stacked over ``repeats`` when
    > 1."""
    segs = []
    for seg in plan:
        period = [block_desc(cfg, spec) for spec in seg.period]
        if seg.repeats > 1:
            period = [stack_desc(p, seg.repeats) for p in period]
        segs.append(period)
    return segs


def _index(tree, i: int):
    return tree_map(lambda t: t[i], tree)


def _stack(trees: List[Any]):
    return tree_map(lambda *ts: torch.stack(ts), *trees)


def _unstack(tree, repeats: int) -> List[Any]:
    """The ``repeats`` per-layer trees of a stacked tree, each leaf split
    once with ``unbind`` (views; its backward stacks the layer gradients
    into one tensor)."""
    parts = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda u: u[r], parts,
                     is_leaf=lambda u: isinstance(u, tuple))
            for r in range(repeats)]


def stack_train(params_segs, cfg: ModelConfig, plan, x, positions,
                remat: bool = True):
    """Full-sequence stack (training).  Returns (x, aux).  ``remat=True``
    checkpoints each block: the backward stores one input per layer and
    recomputes the block, like the reference's per-period
    ``jax.checkpoint``."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for seg, seg_params in zip(plan, params_segs):
        periods = ([seg_params] if seg.repeats == 1
                   else _unstack(seg_params, seg.repeats))
        for period in periods:
            for spec, p in zip(seg.period, period):
                def blk(h, p=p, spec=spec):
                    return block_train(p, cfg, spec, h, positions)
                x, aux = checkpointed(blk, x) if remat else blk(x)
                aux_total = aux_total + aux
    return x, aux_total


def stack_prefill(params_segs, cfg: ModelConfig, plan, x, positions,
                  max_len: int):
    """Returns (x, aux, cache) where cache mirrors :func:`stack_cache`."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for seg, seg_params in zip(plan, params_segs):
        if seg.repeats == 1:
            seg_caches = []
            for spec, p in zip(seg.period, seg_params):
                x, aux, c = block_prefill(p, cfg, spec, x, positions, max_len)
                aux_total = aux_total + aux
                seg_caches.append(c)
            caches.append(seg_caches)
            continue
        per_layer: List[List[Any]] = [[] for _ in seg.period]
        for r in range(seg.repeats):
            for j, (spec, p) in enumerate(zip(seg.period, seg_params)):
                x, aux, c = block_prefill(_index(p, r), cfg, spec, x,
                                          positions, max_len)
                aux_total = aux_total + aux
                per_layer[j].append(c)
        caches.append([_stack(cs) for cs in per_layer])
    return x, aux_total, caches


def stack_cache(cfg: ModelConfig, plan, batch: int, max_len: int, dtype):
    """TensorSpec cache tree mirroring the segment structure."""
    segs = []
    for seg in plan:
        period = [block_cache(cfg, spec, batch, max_len, dtype)
                  for spec in seg.period]
        if seg.repeats > 1:
            period = [tree_map(lambda s: TensorSpec((seg.repeats,) + s.shape,
                                                    s.dtype), p)
                      for p in period]
        segs.append(period)
    return segs


# Cache leaves with a per-position length dim — the ones the serving
# engine stores in fixed-size pages (attention K/V, MLA latents).  Every
# other leaf is carried whole per serving slot.
PAGED_CACHE_LEAVES = ("k", "v", "c_kv", "k_rope")


@dataclasses.dataclass(frozen=True)
class CacheLeafMeta:
    """Per-leaf layout label for the paged serving pool (serve/kv_cache):
    ``kind`` is "paged" (length dim at ``batch_axis + 1``, ``length``
    entries) or "state"; ``batch_axis`` is 1 for leaves stacked over a
    segment's repeats, else 0."""
    kind: str
    batch_axis: int
    length: int


def stack_cache_meta(cfg: ModelConfig, plan, batch: int, max_len: int, dtype):
    """A tree structurally aligned with :func:`stack_cache` whose leaves
    are :class:`CacheLeafMeta` labels."""
    def label(stacked):
        def f(path, s):
            name = path[-1] if path else ""
            bi = 1 if stacked else 0
            if name in PAGED_CACHE_LEAVES:
                return CacheLeafMeta("paged", bi, int(s.shape[1]))
            return CacheLeafMeta("state", bi, 0)
        return f

    return [[tree_map_with_path(label(seg.repeats > 1),
                                block_cache(cfg, spec, batch, max_len, dtype))
             for spec in seg.period] for seg in plan]


def materialize_cache(cache_specs, device):
    """Concrete zero-initialized cache (stabilizer entries 'm' get -1e30)."""
    def init_leaf(path, s: TensorSpec):
        name = path[-1] if path else ""
        fill = -1e30 if name == "m" else 0.0
        return torch.full(s.shape, fill, dtype=s.dtype, device=device)
    return tree_map_with_path(init_leaf, cache_specs)


def write_back(old, new) -> None:
    """Copy each leaf of ``new`` into ``old``'s leaf unless the step wrote
    it there already (the donated cache's recurrent states)."""
    for o, n in zip(tree_leaves(old), tree_leaves(new)):
        if n is not o:
            o.copy_(n)


def stack_decode(params_segs, cfg: ModelConfig, plan, x, cache_segs, pos,
                 mla_absorb: bool = False, moe_dispatch: bool = False,
                 inplace: bool = False):
    """One token through every layer.  Returns (x, new cache); the input
    cache is not modified, unless ``inplace``: then every layer's new
    entries are written into ``cache_segs`` (attention and MLA in place,
    a recurrent state copied over its old value) and ``cache_segs`` is
    returned — the reference's donated cache, held once."""
    if inplace:
        for seg, seg_params, seg_cache in zip(plan, params_segs, cache_segs):
            stacked = seg.repeats > 1
            for i in range(seg.repeats):
                for spec, p, c in zip(seg.period, seg_params, seg_cache):
                    ci = _index(c, i) if stacked else c
                    x, nc = block_decode(_index(p, i) if stacked else p, cfg,
                                         spec, x, ci, pos, mla_absorb,
                                         moe_dispatch, inplace=True)
                    write_back(ci, nc)
        return x, cache_segs
    new_cache = []
    for seg, seg_params, seg_cache in zip(plan, params_segs, cache_segs):
        if seg.repeats == 1:
            updated = []
            for spec, p, c in zip(seg.period, seg_params, seg_cache):
                x, nc = block_decode(p, cfg, spec, x, c, pos, mla_absorb,
                                     moe_dispatch)
                updated.append(nc)
            new_cache.append(updated)
            continue
        per_layer: List[List[Any]] = [[] for _ in seg.period]
        for i in range(seg.repeats):
            for j, (spec, p, c) in enumerate(zip(seg.period, seg_params,
                                                 seg_cache)):
                x, nc = block_decode(_index(p, i), cfg, spec, x,
                                     _index(c, i), pos, mla_absorb,
                                     moe_dispatch)
                per_layer[j].append(nc)
        new_cache.append([_stack(cs) for cs in per_layer])
    return x, new_cache
