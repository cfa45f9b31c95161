"""Multi-pod dry run of the port — the counterpart of
``repro/launch/dryrun.py``: for every (architecture x input shape x mesh),
trace what one rank of the reference's production mesh runs, once, on CPU
fake tensors, and record the op analysis (``launch/op_analysis.py``: dot
FLOPs, bytes, collectives per mesh axis, the kernels' calls) and the
memory reckoning as JSON under ``artifacts/dryrun_torch/``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

What stands in for the reference's lower-and-compile: the step function
runs eagerly under ``FakeTensorMode`` on CPU-device fake tensors (no
storage; every kernel wrapper takes its plain version, as on any CPU
tensor), with its collectives on torch's ``fake`` process-group backend at
the mesh's world (256, or 512 with ``--multi-pod``), rank 0, one group per
mesh axis (``launch/dist.py:mesh_axes``).  Without that backend in the
installed torch the dry run raises; it falls back to nothing.

Which rank: the meshes are the reference's ``16x16`` ``(data, model)`` and
``2x16x16`` ``(pod, data, model)``.  The port has no SPMD partitioner, so
the trace is what the port's rank 0 of that mesh runs under the port's own
parallelism, and every record's ``layout`` block says so:

  * train ``baseline``: parameters replicated over the data axes; every
    family runs the reference's train rules over the model axis (tp = 16,
    ``sharding_ctx.train_region``: the rank's share by
    ``convert.train_slice``, head-parallel attention with its backward
    (the encoder-decoder's three kinds too), MLA's head blocks over whole
    latents, Mamba and the xLSTM blocks over ``inner``, the
    vocab-parallel embedding and cross-entropy, the dense FFNs' ffn
    slice, the experts in blocks, the replica edge over the leaves that
    ranks share).  Adam, ``make_train_step(microbatches=4)``, the dense
    psum DP edge over the data axes (``(pod, data)``: 32 ranks under
    ``--multi-pod``);
  * train ``zero1``: the same rank under the port's ``shard`` spec (f32
    master and moments in rows over the data axes,
    ``make_sharded_train_step``, which takes no micro-batches);
  * train ``comm_<compressor>``: ``make_comm_optimized_train_step`` with
    ``SyncConfig(compressor, algo="ring", bucket_bytes=0)`` on the data
    axes;
  * prefill / decode / long (``baseline``, ``mla_absorb``,
    ``moe_dispatch``, ``optimized``, ``chunkwise``): the batch split over
    the data axes where B > 1; every family under the reference's serve
    layout over the model axis (tp = 16, ``sharding_ctx.serve_region``:
    the rank's share of the parameters by ``convert.serve_slice``,
    head-parallel attention and MLA, Mamba and the xLSTM blocks over
    ``inner``, the encoder-decoder's cross-attention over kv heads, the
    vocab-parallel embedding and head, the FFNs' ffn slice and the
    experts in blocks), its decode cache laid out as the reference's
    ``cache_spec`` lays it out (``convert.cache_slice``: kv heads or the
    length over the model axis, MLA's latents by length, the recurrent
    states on their widest dim, a batch-1 cache's length over the data
    axes too) and donated (``make_decode_step(donate=True)``); decode at
    ``pos = T - 1`` against a T-entry cache.

A shape the port's parallelism refuses raises the port's own refusal; the
CLI lists it as ``[FAIL]``, as the reference's ``main`` does.  This module
sets no environment variable and needs no fake devices.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import threading
import time
import traceback
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch._tree import tree_map
from repro_torch.configs import (ALL_ARCHS, SHAPES, applicable_shapes,
                                 get_config)
from repro_torch.convert import cache_slice, serve_slice, train_slice
from repro_torch.launch import op_analysis
from repro_torch.launch.paths import DRYRUN
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.attention import cache_split, head_layout
from repro_torch.models.encdec import CROSS_SPEC, cross_split
from repro_torch.models.layers import TensorSpec
from repro_torch.models.model import Model, resolve_dtype, train_edges
from repro_torch.models.sharding_ctx import (ServeAxes, leaf_share,
                                             serve_region, train_region)
from repro_torch.models.transformer import block_cache

MICROBATCHES = 4      # train shapes' gradient accumulation (the reference's)
MODEL_AXIS = 16       # the production mesh's model axis
GPUS_PER_NODE = 8     # an H100 node: the NVLink domain

VARIANTS = ("baseline", "zero1", "mla_absorb", "moe_dispatch", "optimized",
            "chunkwise")      # and comm_<compressor>


def mesh_shape(multi_pod: bool) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The reference's production mesh (``launch/mesh.py``)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _fake_store():
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            f"the dry run needs torch's fake process-group backend "
            f"(torch.testing._internal.distributed.fake_pg), which this "
            f"torch {torch.__version__} lacks: {e}") from e
    return FakeStore()


def axis_layout(shape, names) -> Dict[str, Dict[str, Any]]:
    """Each mesh axis of rank 0's groups: its size, the stride between its
    ranks (row-major), and whether its ranks sit in one node of
    ``GPUS_PER_NODE`` cards (global rank r on node r // 8)."""
    out = {}
    for k, (p, name) in enumerate(zip(shape, names)):
        stride = math.prod(shape[k + 1:])
        out[name] = {"size": p, "stride": stride,
                     "within_node": (p - 1) * stride < GPUS_PER_NODE}
    return out


class FakeMesh:
    """The fake backend's default group at the mesh's world, rank 0, and
    one process group per mesh axis; made by :meth:`open`, destroyed by
    :meth:`close`."""

    def __init__(self, multi_pod: bool):
        self.shape, self.names = mesh_shape(multi_pod)
        self.world = math.prod(self.shape)

    def open(self) -> "FakeMesh":
        if dist.is_initialized():
            raise RuntimeError(
                f"the dry run makes its own fake process group; a "
                f"{dist.get_backend()} group of world "
                f"{dist.get_world_size()} already exists")
        from repro_torch.launch.dist import mesh_axes
        dist.init_process_group("fake", store=_fake_store(), rank=0,
                                world_size=self.world)
        self.groups = dict(zip(self.names, mesh_axes(self.shape)))
        return self

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()

    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.names if a in ("pod", "data"))

    def axis_names(self) -> Dict[Any, str]:
        return {g: n for n, g in self.groups.items()}


def _groups_of(cfg) -> Dict[str, bool]:
    """Leaf groups of the model, each with whether the reference shards it
    over the model axis (``models/layers.py:sharding_rules``: vocab, heads,
    kv, ffn, experts, inner)."""
    names = {"attn": "attention", "mla": "attention (MLA)",
             "mamba": "Mamba", "mlstm": "mLSTM", "slstm": "sLSTM"}
    specs = [cfg.layer_spec(i) for i in range(cfg.num_layers)]
    g = {"embeddings": True}
    if not cfg.tie_embeddings:
        g["lm head"] = True
    if cfg.is_encoder_decoder:
        g.update({"attention": True, "cross-attention": True,
                  "dense FFNs": True})
    for s in specs:
        if not cfg.is_encoder_decoder:
            g[names[s.mixer]] = True
        if s.ffn == "dense":
            g["dense FFNs"] = True
        elif s.ffn == "moe":
            g["experts"] = True
            g["routers"] = False
            if cfg.num_shared_experts:
                g["shared experts"] = True
    g["norms"] = False
    return g


def rank_layout(cfg, shape, variant: str, mesh: FakeMesh,
                microbatches: int) -> Dict[str, Any]:
    """The ``layout`` block: what the traced rank holds and runs."""
    data = mesh.data_axes()
    dp = math.prod(p for p, n in zip(mesh.shape, mesh.names) if n in data)
    lay: Dict[str, Any] = {
        "note": "the port has no SPMD partitioner: the record is what the "
                "port's rank 0 of this mesh runs under its own parallelism",
        "rank": 0, "mesh_axes": dict(zip(mesh.names, mesh.shape)),
        "axes": axis_layout(mesh.shape, mesh.names),
        "data_axes": list(data), "dp": dp}
    B = shape.global_batch
    if shape.phase == "train":
        lay["batch_per_rank"] = B // dp
        lay.update(train_model_layout(cfg))
        lay["replicated_over_data"] = "every parameter (the reference's " \
            "baseline shards the embed dim over data, FSDP)" \
            if variant == "baseline" else "every parameter"
        if variant == "zero1":
            lay["program"] = "make_sharded_train_step (the shard spec)"
            lay["microbatches"] = 1
            lay["optimizer_state"] = "f32 master and Adam moments in rows " \
                "over the data axes"
        elif variant.startswith("comm_"):
            lay["program"] = (f"make_comm_optimized_train_step(SyncConfig("
                              f"{variant[5:]!r}, algo='ring', "
                              f"bucket_bytes=0))")
            lay["microbatches"] = 1
        else:
            lay["program"] = f"make_train_step(microbatches={microbatches})"
            lay["microbatches"] = microbatches
        return lay
    b = B // dp if B > 1 else 1
    lay.update(serve_layout(cfg, shape, mesh, b))
    if shape.phase == "prefill":
        lay["program"] = "make_prefill_step"
    else:
        lay["program"] = (
            f"make_decode_step(mla_absorb="
            f"{variant in ('mla_absorb', 'optimized')}, moe_dispatch="
            f"{variant in ('moe_dispatch', 'optimized')})")
        lay["pos"] = shape.seq_len - 1
    return lay


def train_model_layout(cfg) -> Dict[str, Any]:
    """Rank 0's share under the train layout over the model axis
    (``sharding_ctx.train_region``, tp = 16): the head blocks (attention,
    MLA, the encoder's, the decoder's and the cross-attention's), the kv
    heads a rank computes and the ranks each is held on, Mamba's and the
    mLSTM's ``inner`` channels and the mLSTM's ``dh_v`` rows a rank, the
    sLSTM's dh block, the vocabulary rows a rank holds, what is split,
    what every rank holds whole (``unsharded``) and the leaves the
    replica edge sums (``model.train_edges``)."""
    tp = MODEL_AXIS
    moe = bool(cfg.num_experts)
    specs = [cfg.layer_spec(i) for i in range(cfg.num_layers)]
    mixers = {s.mixer for s in specs}
    heads = cfg.is_encoder_decoder or bool(mixers & {"attn", "mla"})
    dense = cfg.is_encoder_decoder or any(s.ffn == "dense" for s in specs)
    edges = sorted({name for e in train_edges(cfg, tp, 0).values()
                    for name in e})
    whole = ["norms"] + (["routers"] if moe else []) + \
        (["q / k norms"] if cfg.qk_norm and heads else [])
    split = {"vocab (embedding" + ("" if cfg.tie_embeddings else
                                   ", lm head") + ")": "rows"}
    out: Dict[str, Any] = {"tp": tp, "ep": tp if moe else 1,
                           "train_layout": "model axis"}
    if heads:
        hl = head_layout(cfg, tp, 0)
        out.update({"attn_tp": hl.attn_tp, "heads_per_rank": hl.hl,
                    "kv_heads_computed_per_rank": hl.kvl,
                    "ranks_per_kv_head": tp * hl.kvl // cfg.num_kv_heads,
                    "ranks_per_head_block": tp // hl.attn_tp})
    if "attn" in mixers or cfg.is_encoder_decoder:
        what = "(the encoder's, the decoder's and the cross-attention's)" \
            if cfg.is_encoder_decoder else "(attention)"
        split[f"heads {what}"] = "wq columns, wo rows"
        split[f"kv {what}"] = "wk / wv columns of the kv heads the " \
            "rank's query heads read"
    if "mla" in mixers:
        split["heads (MLA)"] = "wq and w_ukv columns, wo rows"
        whole.append("MLA latent projection (w_dkv, kv_norm)")
        out["mla_latents"] = "whole on every rank, summed by the replica " \
            "edge"
    if "mamba" in mixers:
        split["inner (Mamba)"] = "in_proj's x and z each, conv, dt_proj, " \
            "A_log, D by channels; x_proj and out_proj rows"
        out["mamba_inner_per_rank"] = cfg.d_inner // tp
    if "mlstm" in mixers:
        di = 2 * cfg.d_model
        split["inner (mLSTM)"] = "up's xm and z each, conv by channels; " \
            "wq / wk / wv / w_if / down rows; C by dh_v rows"
        whole.append("mLSTM b_if, out_norm")
        out["mlstm_inner_per_rank"] = di // tp
        out["mlstm_dh_v_rows_per_rank"] = di // cfg.num_heads // tp
    if "slstm" in mixers:
        split["inner (sLSTM)"] = "w_in by dh of every head's every gate"
        whole.append("sLSTM cell (r, b)")
        out["slstm_dh_per_rank"] = cfg.d_model // cfg.num_heads // tp
    if dense:
        split["ffn"] = "dense FFNs' wi columns and wo rows"
    if "slstm" in mixers:
        split["ffn (sLSTM)"] = "up's gate and up each, down rows"
    if moe:
        n = cfg.num_experts // tp
        split["experts"] = f"{n} whole expert{'s' * (n > 1)} a rank"
    out.update({"vocab_rows_per_rank": cfg.padded_vocab // tp,
                "split_over_model": split, "whole": whole,
                "replica_edge": edges, "unsharded": whole})
    return out


def _mixer_collectives(cfg, spec, b: int, seq: int, tp: int):
    """One checkpointed layer's model-axis collectives at (b, seq) as
    (what, kind, operand bytes): the forward's sums and gathers, those the
    recomputation repeats (it stops at the last tensor the backward
    needs: before the block's last sum, unless an FFN's norm reads its
    output), and the backward's."""
    d = cfg.d_model
    cb = resolve_dtype(cfg.compute_dtype).itemsize
    act, f32act = b * seq * d * cb, b * seq * d * 4

    def ar(what, n):
        return (what, "all-reduce", n)
    if spec.mixer in ("attn", "mla"):
        return [ar("attention wo sum", act)] * 2 + \
            [ar("attention input", act)]
    if spec.mixer == "mamba":
        proj = b * seq * (cfg.dt_rank + 2 * cfg.ssm_d_state) * 4
        return [ar("mamba x_proj sum", proj)] * 3 + \
            [ar("mamba out_proj sum", f32act)] * 2 + [ar("mamba input", act)]
    if spec.mixer == "mlstm":
        di, H = 2 * d, cfg.num_heads
        proj = b * seq * (3 * di + 2 * H) * 4
        return [ar("mlstm q/k/v/gates sum", proj)] * 3 + \
            [("mlstm h gather", "all-gather", b * seq * di // tp * cb)] * 2 \
            + [ar("mlstm h reduce-scatter", b * seq * di * cb),
               ar("mlstm down sum", f32act), ar("mlstm input", act)]
    return [("slstm gates gather", "all-gather", b * seq * 4 * d // tp * cb)
            ] * 2 + [ar("slstm ffn sum", f32act), ar("slstm ffn input", act),
                     ar("slstm input", act)]


def _ffn_collectives(cfg, spec, b: int, seq: int, nbytes: int):
    """A layer's FFN: the forward's row-parallel sum (the recomputation
    stops before it) and the backward's input sums (the MoE block's
    tokens and its f32 routing weights)."""
    act = b * seq * cfg.d_model * nbytes
    if spec.ffn == "moe":
        return [("ffn sum", "all-reduce", act),
                ("moe tokens input", "all-reduce", act),
                ("moe weights input", "all-reduce", b * seq * cfg.top_k * 4)]
    if spec.ffn == "dense":
        return [("ffn sum", "all-reduce", act),
                ("ffn input", "all-reduce", act)]
    return []


def train_layout_collectives(cfg, batch: int, seq: int, tp: int,
                             rank: int = 0, microbatches: int = 1,
                             xent_chunk: int = 512, src_dtype=None):
    """The model-axis collectives of one train step under the train
    layout at tp (rank ``rank``, the local ``batch`` split into
    ``microbatches``), as ``(what, kind, operand bytes)`` triples in no
    order (``kind``: ``all-reduce`` or ``all-gather``): a reckoning from
    the code's structure, which the op analysis' count of a traced step
    must equal.  Per micro-batch:

      * the embedding's sum, (b, T, d) in the parameters' dtype;
      * per layer (checkpointed, :func:`_mixer_collectives`,
        :func:`_ffn_collectives`): attention's and MLA's ``wo`` sum twice
        and their input's backward sum; Mamba's f32 ``x_proj`` sum twice
        and its backward sum, its f32 ``out_proj`` sum twice, its input's
        sum; the mLSTM's f32 q / k / v / gates sum twice and its backward
        sum, h's all-gather twice and its backward reduce-scatter (an
        all-reduce), the f32 ``down`` sum and the input's sum; the
        sLSTM's gates all-gather twice (its backward keeps the rank's
        block), the FFN's f32 sum and input sum and the input's sum; then
        the FFN's;
      * the encoder-decoder: its encoder's layers at the frames' length
        in the frames' promoted dtype (``src_dtype``: the compute dtype
        by default), the memory's one input sum, and per decoder layer
        the self- and cross-attention's as attention's and the FFN's;
      * per loss chunk: the f32 row maximum (b, c) and the block terms
        (2, b, c), twice where the chunk is checkpointed (every chunk of
        ``xent_chunk``; a shorter tail is not), and the head's input sum
        (b, c, d);
      * the replica edge, once per stacked leaf that ranks share
        (``model.train_edges``): its ``blocks`` rows of the rank's
        leaf."""
    b = batch // microbatches
    d = cfg.d_model
    cdt = resolve_dtype(cfg.compute_dtype)
    cbytes = cdt.itemsize
    pbytes = resolve_dtype(cfg.param_dtype).itemsize
    out = [("embedding", "all-reduce", b * seq * d * pbytes)]
    if cfg.is_encoder_decoder:
        ebytes = torch.promote_types(
            src_dtype or cdt, resolve_dtype(cfg.param_dtype)).itemsize
        enc = CROSS_SPEC
        for _ in range(cfg.num_encoder_layers):
            act = b * seq * d * ebytes
            out += [("encoder attention wo sum", "all-reduce", act)] * 2 + \
                [("encoder attention input", "all-reduce", act)] + \
                _ffn_collectives(cfg, enc, b, seq, ebytes)
        out.append(("memory input", "all-reduce", b * seq * d * ebytes))
        act = b * seq * d * cbytes
        for _ in range(cfg.num_layers):
            out += [("self-attention wo sum", "all-reduce", act)] * 2 + \
                [("self-attention input", "all-reduce", act)] + \
                [("cross-attention wo sum", "all-reduce", act)] * 2 + \
                [("cross-attention input", "all-reduce", act)] + \
                _ffn_collectives(cfg, enc, b, seq, cbytes)
    else:
        for i in range(cfg.num_layers):
            spec = cfg.layer_spec(i)
            out += _mixer_collectives(cfg, spec, b, seq, tp) + \
                _ffn_collectives(cfg, spec, b, seq, cbytes)
    c = min(xent_chunk, seq)
    full, tail = divmod(seq, c)
    for n, times in [(c, 2)] * full + [(tail, 1)] * bool(tail):
        out += [("loss max", "all-reduce", b * n * 4),
                ("loss terms", "all-reduce", 2 * b * n * 4)] * times + \
            [("head input", "all-reduce", b * n * d * cbytes)]
    out = out * microbatches
    widths = _edge_widths(cfg, tp, rank)
    repeats = _edge_repeats(cfg)
    for path, edges in sorted(train_edges(cfg, tp, rank).items(), key=str):
        out += [(f"replica edge {name}", "all-reduce",
                 blocks * repeats[path] * widths[path[-1]][name] * pbytes)
                for name, (blocks, _) in sorted(edges.items())
                if name in widths[path[-1]]] * microbatches
    return out


def _edge_repeats(cfg) -> Dict[Tuple, int]:
    """The layers each replica-edge subtree (``model.train_edges``) is
    stacked over."""
    if cfg.is_encoder_decoder:
        return {("encdec", "enc_stack", "mixer"): cfg.num_encoder_layers,
                ("encdec", "dec_stack", "self"): cfg.num_layers,
                ("encdec", "dec_stack", "cross"): cfg.num_layers}
    return {("stack", i, j, "mixer"): seg.repeats
            for i, seg in enumerate(cfg.stack_plan())
            for j in range(len(seg.period))}


def _edge_widths(cfg, tp: int, rank: int) -> Dict[str, Dict[str, int]]:
    """Elements of one layer's share of each leaf the replica edge may
    sum, by the subtree's last key: attention's (``mixer``, ``self``),
    the cross-attention's (without QK-norm) and, under ``mixer``, MLA's
    and the mLSTM's."""
    lay = head_layout(cfg, tp, rank)
    d, hd = cfg.d_model, cfg.hd
    attn = {"wq": d * lay.hl * hd, "wo": d * lay.hl * hd,
            "wk": d * lay.kvl * hd, "wv": d * lay.kvl * hd,
            "q_norm": hd, "k_norm": hd}
    mixer = dict(attn)
    lora, rope = cfg.kv_lora_rank, cfg.qk_rope_dim
    if cfg.use_mla:
        mixer.update({
            "wq": d * lay.hl * (cfg.qk_nope_dim + rope),
            "w_ukv": lora * lay.hl * (cfg.qk_nope_dim + cfg.v_head_dim),
            "wo": lay.hl * cfg.v_head_dim * d,
            "w_dkv": d * (lora + rope), "kv_norm": lora})
    mixer.update({"b_if": 2 * cfg.num_heads, "out_norm": 2 * d})
    cross = {k: v for k, v in attn.items() if k not in ("q_norm", "k_norm")}
    return {"mixer": mixer, "self": attn, "cross": cross}


# what each parameter group puts on the model axis under the serve rules
_SPLIT = {
    "attention": ("heads", "wq columns, wo rows"),
    "attention (MLA)": ("heads", "wq and w_ukv columns, wo rows (w_dkv and "
                        "kv_norm, the lora dim, whole)"),
    "cross-attention": ("kv", "wk / wv columns (and wq columns, wo rows by "
                        "heads)"),
    "Mamba": ("inner", "in_proj's x and z each, conv, dt_proj, A_log, D by "
              "channels; x_proj and out_proj rows"),
    "mLSTM": ("inner", "up's xm and z each, conv by channels; wq / wk / wv "
              "/ w_if / down rows"),
    "sLSTM": ("inner", "w_in by dh of every head's every gate (r, b "
              "whole)"),
}
# the dims of each recurrent or latent cache leaf (batch left out)
_LEAF_DIMS = {
    ("mla", "c_kv"): ("length", "lora"),
    ("mla", "k_rope"): ("length", "1", "rope"),
    ("mamba", "h"): ("d_inner", "d_state"),
    ("mamba", "conv"): ("conv", "d_inner"),
    ("mlstm", "C"): ("heads", "dh_v", "dh_k"),
    ("mlstm", "n"): ("heads", "dh_k"),
    ("mlstm", "m"): ("heads",),
    ("mlstm", "conv"): ("conv", "d_inner"),
    ("slstm", "c"): ("heads", "dh"), ("slstm", "n"): ("heads", "dh"),
    ("slstm", "m"): ("heads", "dh"), ("slstm", "h"): ("heads", "dh"),
}


def _leaves_layout(mixer: str, cache, sa, data) -> Dict[str, Any]:
    """Each leaf of one layer's decode cache: the dim split over the
    model (and data) axes and its size on the rank, or whole."""
    out = {}
    for name, spec in cache.items():
        share = leaf_share(name, spec.shape, sa)
        dims = _LEAF_DIMS[(mixer, name)]
        if share is None:
            out[name] = {"split": None, "shape": list(spec.shape[1:])}
            continue
        out[name] = {"split": dims[share.dim - 1],
                     "over": (list(data) if share.data else [])
                     + (["model"] if share.model else []),
                     "per_rank": spec.shape[share.dim] // share.parts,
                     "shape": list(spec.shape[1:])}
    return out


def _attn_cache(split, data) -> Dict[str, Any]:
    return {"length": split.L,
            "kv_heads": "model" if split.model == "kv" else None,
            "length_over": (list(data) if split.data else [])
            + (["model"] if split.model == "length" else []),
            "positions_per_rank": split.L // split.parts,
            "kv_heads_per_rank": split.kvl}


def serve_layout(cfg, shape, mesh: FakeMesh, b: int) -> Dict[str, Any]:
    """The serve layout of rank 0 over the model axis: what is split where
    (the reference's serve rules), the attention head blocks, and each
    layer kind's decode cache (``attention.cache_split`` for attention,
    ``sharding_ctx.leaf_share`` leaf by leaf for MLA's latents and the
    recurrent states, ``encdec.cross_split`` for the cross cache)."""
    tp = MODEL_AXIS
    hl = head_layout(cfg, tp, 0)
    moe = bool(cfg.num_experts)
    groups = _groups_of(cfg)
    mixers = {cfg.layer_spec(i).mixer for i in range(cfg.num_layers)}
    heads = cfg.is_encoder_decoder or mixers & {"attn", "mla"}
    split = {"vocab (embedding, lm head)": "rows",
             "ffn": "dense FFNs' wi columns and wo rows"
             + ("; the sLSTM FFN's up (gate and up each) columns, down rows"
                if "slstm" in mixers else "")}
    for g, (axis, what) in _SPLIT.items():
        if g in groups:
            split[f"{axis} ({g})"] = what
    if moe:
        split["experts"] = f"{cfg.num_experts // tp} whole experts a rank"
    out = {"tp": tp, "ep": tp if moe else 1, "batch_per_rank": b}
    if heads:
        out.update({"attn_tp": hl.attn_tp, "heads_per_rank": hl.hl,
                    "kv_heads_computed_per_rank": hl.kvl,
                    "ranks_per_kv_head": tp * hl.kvl // cfg.num_kv_heads})
    out.update({"split_over_model": split,
                "whole": ["norms"] + (["routers"] if moe else [])
                + (["q / k norms"] if cfg.qk_norm else [])
                + (["MLA's w_dkv and kv_norm (lora)"] if "mla" in mixers
                   else [])
                + (["the sLSTM's r and b"] if "slstm" in mixers else [])
                + (["the mLSTM's b_if"] if "mlstm" in mixers else []),
                "unsharded": []})
    if shape.phase == "prefill":
        return out
    data = mesh.data_axes() if shape.global_batch == 1 else ()
    T = shape.seq_len
    sa = ServeAxes(mesh.groups["model"],
                   tuple(mesh.groups[a] for a in data), T)
    B = shape.global_batch
    caches = {}
    if cfg.is_encoder_decoder:
        caches["decoder self"] = _attn_cache(
            cache_split(cfg, CROSS_SPEC, T, sa), data)
        caches["cross"] = _attn_cache(cross_split(cfg, B, T, sa)[1], data)
    for i in range(cfg.num_layers):
        spec = cfg.layer_spec(i)
        kind = {"attn": f"window {spec.window}" if spec.window else "global",
                "mla": "MLA latents", "mamba": "Mamba state",
                "mlstm": "mLSTM state",
                "slstm": "sLSTM state"}[spec.mixer] \
            if not cfg.is_encoder_decoder else None
        if kind is None or kind in caches:
            continue
        if spec.mixer == "attn":
            caches[kind] = _attn_cache(cache_split(cfg, spec, T, sa), data)
        else:
            caches[kind] = {"leaves": _leaves_layout(
                spec.mixer, block_cache(cfg, spec, B, T, torch.bfloat16),
                sa, data)}
    out["cache"] = caches
    out["cache_donated"] = True
    return out


def _materialize(specs, mode):
    with mode:
        return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype),
                        specs, is_leaf=lambda x: isinstance(x, TensorSpec))


def _build(model, shape, variant, mesh, lay, mode, microbatches):
    """(step function, argument tuple, context) of the traced rank."""
    from repro_torch.optim import make_optimizer
    params = model.abstract_params(mode=mode)
    local = dataclasses.replace(shape, global_batch=lay["batch_per_rank"])
    data = tuple(mesh.groups[a] for a in mesh.data_axes())
    if shape.phase != "train":
        return _build_serve(model, shape, variant, mesh, lay, mode, params,
                            local)
    inputs = _materialize(model.input_specs(local), mode)
    with mode:
        params = train_slice(params, model.cfg, 0, lay["tp"])
    ctx = _regions(train=mesh.groups["model"])
    opt = make_optimizer("adam", lr=1e-4)
    if variant == "zero1":
        from repro_torch.core.grad_sync import (PlanExecutor, SyncConfig,
                                                sharded_plan_from_config)
        from repro_torch.core.shard_state import ShardLayout
        from repro_torch.launch.steps import make_sharded_train_step
        from repro_torch.optim import make_sharded_optimizer
        engine = PlanExecutor(sharded_plan_from_config(SyncConfig(), params),
                              data)
        layout = ShardLayout.from_plan(
            engine.plan, params, [dist.get_world_size(g) for g in data])
        shopt = make_sharded_optimizer("adam", layout, data, lr=1e-4)
        step, init_rows, init_sync = make_sharded_train_step(
            model, engine, layout, shopt, data)
        with mode:
            rows, sync_state = init_rows(params), init_sync(params)
        return step, (params, rows, sync_state, inputs, 0, None), ctx
    if variant.startswith("comm_"):
        from repro_torch.core.grad_sync import SyncConfig
        from repro_torch.launch.steps import make_comm_optimized_train_step
        step, _, init_sync = make_comm_optimized_train_step(
            model, opt, SyncConfig(compressor=variant[5:], algo="ring",
                                   bucket_bytes=0), data)
        with mode:
            opt_state, sync_state = opt.init(params), init_sync(params)
        return step, (params, opt_state, sync_state, inputs, 0, None), ctx
    with mode:
        opt_state = opt.init(params)
    step = make_train_step(model, opt, group=data, microbatches=microbatches)
    return step, (params, opt_state, inputs, 0), ctx


@contextlib.contextmanager
def _regions(serve=None, train=None):
    """The traced step's regions: the train layout over the model axis
    (``train``: its group) or the serve layout (``(group, data groups,
    max_len)``)."""
    with train_region(train), \
            (serve_region(*serve) if serve else contextlib.nullcontext()):
        yield


def _build_serve(model, shape, variant, mesh, lay, mode, params, local):
    """(step, arguments, regions) of a prefill or decode rank: under the
    serve layout the rank's share of the parameters and of the cache (the
    global shape's cache cut by ``convert.cache_slice``) and the region
    over the model axis."""
    inputs = _materialize(model.input_specs(local), mode)
    serve = None
    if lay["tp"] > 1:
        with mode:
            params = serve_slice(params, model.cfg, 0, lay["tp"])
        data = mesh.data_axes() if shape.global_batch == 1 else ()
        serve = (mesh.groups["model"], tuple(mesh.groups[a] for a in data),
                 shape.seq_len)
        if shape.phase == "decode":
            dp = lay["dp"]
            src = shape.seq_len if model.cfg.is_encoder_decoder else 0
            cache = cache_slice(model.init_cache(shape.global_batch,
                                                 shape.seq_len, src_len=src),
                                model.cfg, shape.global_batch, shape.seq_len,
                                0, lay["tp"], 0, dp, src_len=src)
            inputs["cache"] = _materialize(cache, mode)
    ctx = _regions(serve=serve)
    if shape.phase == "prefill":
        return make_prefill_step(model), (params, inputs), ctx
    step = make_decode_step(
        model, mla_absorb=variant in ("mla_absorb", "optimized"),
        moe_dispatch=variant in ("moe_dispatch", "optimized"),
        donate=lay["tp"] > 1)
    return step, (params, inputs["tokens"], inputs["cache"], lay["pos"]), ctx


def trace_pair(arch: str, shape_name: str, multi_pod: bool = False,
               variant: str = "baseline", microbatches: int = MICROBATCHES,
               save_trace: bool = False, out_dir: str = DRYRUN):
    """Trace one (arch, shape, mesh, variant) on rank 0 and return the
    record (``lower_pair``'s counterpart)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_config(arch)
    if variant == "chunkwise":
        cfg = dataclasses.replace(cfg, mlstm_parallel=True)
    if not (variant in VARIANTS or variant.startswith("comm_")):
        raise ValueError(f"unknown variant {variant!r}; known: {VARIANTS} "
                         f"and comm_<compressor>")
    shape = SHAPES[shape_name]
    model = Model(cfg)
    mesh = FakeMesh(multi_pod).open()
    try:
        lay = rank_layout(cfg, shape, variant, mesh, microbatches)
        mode = FakeTensorMode()
        t0 = time.time()
        step, args, ctx = _build(model, shape, variant, mesh, lay, mode,
                                 microbatches)
        with mode, ctx:
            _, stats = op_analysis.trace(step, args,
                                         axis_names=mesh.axis_names(),
                                         table=save_trace)
        trace_s = time.time() - t0
    finally:
        mesh.close()
    rec = {
        "arch": arch, "shape": shape_name, "variant": variant,
        "mesh": mesh_name(multi_pod), "devices": mesh.world,
        "phase": shape.phase, "trace_s": round(trace_s, 2),
        "memory_analysis": stats.memory_analysis(),
        "cost_analysis": stats.cost_analysis(),
        "hlo": stats.hlo_block(),
        "layout": lay,
    }
    if save_trace:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{arch}_{shape_name}_{rec['mesh']}_"
                                     f"{variant}.ops.tsv")
        with open(path, "w") as f:
            f.write(stats.op_table())
    return rec


def _progress(every_s: float, label: str, stop: threading.Event) -> None:
    """Print the ops counted so far every ``every_s`` seconds until
    ``stop`` (a long recurrent trace runs for hours)."""
    t0 = time.time()
    while not stop.wait(every_s):
        c = op_analysis.active()
        n = c.stats.aten_ops if c is not None else 0
        print(f"[progress] {label}: {n} aten ops counted after "
              f"{time.time() - t0:.0f} s", file=sys.stderr, flush=True)


def record_name(arch: str, shape: str, mesh: str, variant: str) -> str:
    return f"{arch}_{shape}_{mesh}_{variant}.json"


def save_record(rec, out_dir: str = DRYRUN) -> str:
    os.makedirs(out_dir, exist_ok=True)
    name = record_name(rec["arch"], rec["shape"], rec["mesh"],
                       rec["variant"])
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1)
    return name


def main(argv=None, out_dir: str = DRYRUN) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="Trace one rank of the production mesh per (arch, "
                    "shape) on fake tensors and record its op analysis.")
    ap.add_argument("--arch", choices=ALL_ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--save-trace", action="store_true",
                    help="also write the per-op table (.ops.tsv)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--microbatches", type=int, default=MICROBATCHES)
    ap.add_argument("--progress", type=float, default=0.0, metavar="S",
                    help="print the ops counted so far every S seconds")
    ap.add_argument("--out", default=out_dir,
                    help=f"the records' directory (default {out_dir})")
    args = ap.parse_args(argv)
    out_dir = args.out

    if args.all:
        pairs = [(a, s) for a in ALL_ARCHS
                 for s in applicable_shapes(get_config(a))]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        pairs = [(args.arch, args.shape)]

    failures = 0
    mname = mesh_name(args.multi_pod)
    for arch, shape in pairs:
        fname = record_name(arch, shape, mname, args.variant)
        if args.skip_existing and os.path.exists(os.path.join(out_dir,
                                                              fname)):
            print(f"[skip] {fname}")
            continue
        stop = threading.Event()
        if args.progress > 0:
            threading.Thread(target=_progress, daemon=True, args=(
                args.progress, f"{arch} {shape} {mname} {args.variant}",
                stop)).start()
        try:
            rec = trace_pair(arch, shape, multi_pod=args.multi_pod,
                             variant=args.variant,
                             microbatches=args.microbatches,
                             save_trace=args.save_trace, out_dir=out_dir)
            save_record(rec, out_dir)
            mem = rec["memory_analysis"]
            print(f"[ok] {arch} {shape} {mname}: trace={rec['trace_s']}s "
                  f"args={mem['argument_size_in_bytes'] / 2**30:.2f}GiB "
                  f"temp={mem['temp_size_in_bytes'] / 2**30:.2f}GiB "
                  f"dotF={rec['hlo']['dot_flops_per_device']:.3e} "
                  f"wireB="
                  f"{rec['hlo']['collective_wire_bytes_per_device']:.3e}",
                  flush=True)
        except Exception as e:
            failures += 1
            print(f"[FAIL] {arch} {shape} {mname}: {type(e).__name__}: {e}",
                  flush=True)
            traceback.print_exc()
        finally:
            stop.set()
    if failures:
        raise SystemExit(f"{failures} dry-run failures")
    return 0


if __name__ == "__main__":
    main()
