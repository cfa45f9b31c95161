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

  * train ``baseline``: parameters replicated over the data axes; the
    dense FFNs split on the model axis (``layers.mlp_tp``, tp = 16) and
    the experts too (``moe_ffn(ep_axis=)``, ep = 16); attention,
    embeddings, norms and the LM head whole; Adam,
    ``make_train_step(microbatches=4)``, the dense psum DP edge over the
    data axes (``(pod, data)``: 32 ranks under ``--multi-pod``);
  * train ``zero1``: the same rank under the port's ``shard`` spec (f32
    master and moments in rows over the data axes,
    ``make_sharded_train_step``, which takes no micro-batches);
  * train ``comm_<compressor>``: ``make_comm_optimized_train_step`` with
    ``SyncConfig(compressor, algo="ring", bucket_bytes=0)`` on the data
    axes;
  * prefill / decode / long (``baseline``, ``mla_absorb``,
    ``moe_dispatch``, ``optimized``, ``chunkwise``): the batch split over
    the data axes where B > 1; a grouped-query attention stack under the
    reference's serve layout over the model axis (tp = 16,
    ``sharding_ctx.serve_region``: the rank's share of the parameters by
    ``convert.serve_slice``, head-parallel attention, the vocab-parallel
    embedding and head, the FFNs' ffn slice and the experts in blocks),
    its decode cache laid out as the reference's ``cache_spec`` lays it
    out (``convert.cache_slice``: kv heads or the length over the model
    axis, a batch-1 cache's length over the data axes too) and donated
    (``make_decode_step(donate=True)``); the other families (MLA, Mamba,
    xLSTM, the encoder-decoder) whole on the rank (``tp: 1`` and a
    ``tp_reason``); decode at ``pos = T - 1`` against a T-entry cache.

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
from repro_torch.convert import cache_slice, ep_slice, serve_slice, tp_slice
from repro_torch.launch import op_analysis
from repro_torch.launch.paths import DRYRUN
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.attention import cache_split, head_layout
from repro_torch.models.layers import TensorSpec
from repro_torch.models.model import Model
from repro_torch.models.sharding_ctx import (ServeAxes, ep_region,
                                             serve_region, tp_region)
from repro_torch.models.transformer import serve_tp_reason

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
    groups = _groups_of(cfg)
    lay: Dict[str, Any] = {
        "note": "the port has no SPMD partitioner: the record is what the "
                "port's rank 0 of this mesh runs under its own parallelism",
        "rank": 0, "mesh_axes": dict(zip(mesh.names, mesh.shape)),
        "axes": axis_layout(mesh.shape, mesh.names),
        "data_axes": list(data), "dp": dp}
    B = shape.global_batch
    if shape.phase == "train":
        moe = "experts" in groups
        lay["tp"] = MODEL_AXIS if "dense FFNs" in groups else 1
        lay["ep"] = MODEL_AXIS if moe else 1
        lay["batch_per_rank"] = B // dp
        split = ("dense FFNs", "experts")
        lay["unsharded"] = [k for k, sharded in groups.items()
                            if sharded and k not in split]
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
    reason = serve_tp_reason(cfg)
    if reason:
        lay.update({"tp": 1, "ep": 1, "batch_per_rank": b,
                    "tp_reason": reason,
                    "unsharded": [k for k, sharded in groups.items()
                                  if sharded]})
    else:
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


def serve_layout(cfg, shape, mesh: FakeMesh, b: int) -> Dict[str, Any]:
    """The serve layout of rank 0 over the model axis: what is split where
    (the reference's serve rules), the attention head blocks, and each
    attention layer kind's decode cache (``attention.cache_split``)."""
    tp = MODEL_AXIS
    hl = head_layout(cfg, tp, 0)
    moe = bool(cfg.num_experts)
    out = {"tp": tp, "ep": tp if moe else 1, "batch_per_rank": b,
           "attn_tp": hl.attn_tp, "heads_per_rank": hl.hl,
           "kv_heads_computed_per_rank": hl.kvl,
           "ranks_per_kv_head": tp * hl.kvl // cfg.num_kv_heads,
           "split_over_model": {
               "vocab (embedding, lm head)": "rows", "heads": "wq columns, "
               "wo rows", "kv": "wk / wv columns",
               "ffn": "dense FFNs' wi columns and wo rows",
               **({"experts": f"{cfg.num_experts // tp} whole experts a "
                              f"rank"} if moe else {})},
           "whole": ["norms"] + (["routers"] if moe else [])
           + (["q / k norms"] if cfg.qk_norm else []),
           "unsharded": []}
    if shape.phase == "prefill":
        return out
    data = mesh.data_axes() if shape.global_batch == 1 else ()
    sa = ServeAxes(mesh.groups["model"],
                   tuple(mesh.groups[a] for a in data), shape.seq_len)
    caches = {}
    for i in range(cfg.num_layers):
        spec = cfg.layer_spec(i)
        kind = f"window {spec.window}" if spec.window else "global"
        if kind in caches:
            continue
        split = cache_split(cfg, spec, shape.seq_len, sa)
        axes = (list(data) if split.data else []) + \
            (["model"] if split.model == "length" else [])
        caches[kind] = {"length": split.L,
                        "kv_heads": "model" if split.model == "kv" else None,
                        "length_over": axes,
                        "positions_per_rank": split.L // split.parts,
                        "kv_heads_per_rank": split.kvl}
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
    model_group = mesh.groups["model"]
    with mode:
        if lay["tp"] > 1:
            params = tp_slice(params, 0, lay["tp"])
        if lay["ep"] > 1:
            params = ep_slice(params, 0, lay["ep"])
    ctx = _regions(model_group if lay["tp"] > 1 else None,
                   model_group if lay["ep"] > 1 else None)
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
def _regions(tp=None, ep=None, serve=None):
    """The traced step's regions: tp and ep (train), or the serve layout
    (``(group, data groups, max_len)``)."""
    with tp_region(tp), ep_region(ep), \
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
            cache = cache_slice(model.init_cache(shape.global_batch,
                                                 shape.seq_len),
                                model.cfg, shape.global_batch, shape.seq_len,
                                0, lay["tp"], 0, dp)
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
