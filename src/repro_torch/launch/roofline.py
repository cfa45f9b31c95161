"""Roofline analysis of the port — the counterpart of
``repro/launch/roofline.py``: read the dry run's JSON records
(``artifacts/dryrun_torch/``) and derive three per-step terms per (arch,
shape, mesh), priced with the constants of the card the port runs on, an
NVIDIA H100 80GB HBM3 (SXM5, 700 W), from its data sheet:

    compute    = dot_FLOPs_per_device / 989.4e12   (bf16 tensor cores, dense)
    memory     = bytes_per_device     / 3.35e12    (HBM3)
    collective = sum over mesh axes of wire_bytes[axis] / bw(axis)
                 bw = 450e9 B/s (NVLink 4, one direction) for an axis whose
                 ranks sit in one node of 8 cards, 50e9 B/s (400 Gb/s NDR
                 InfiniBand per card) for an axis that crosses nodes

These are modeled, not measured: no time here comes from a run, and no
TPU constant remains.  A serve record under the model-axis layout
carries its all-reduces and all-gathers on the model axis (and, at batch
1, the split-KV combine on the data axes), priced by the same collective
term as a train record's.  ``MODEL_FLOPS`` = 6·N_active·tokens (train) or
2·N_active·tokens (prefill / decode), the useful-compute ratio, the
dominant term and a note on what would move it, as in the reference.
:func:`count_active_params`, :func:`model_flops_per_device`,
:func:`analytic_memory_bytes` (its tp = 16 included), ``NOTES``,
:func:`load_records` and :func:`render_table` are copies of the
reference's, held equal to it by ``tests/test_torch_roofline.py``.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh 16x16]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from repro_torch._tree import tree_leaves
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.paths import DRYRUN

# H100 80GB HBM3 SXM5 (NVIDIA data sheet)
PEAK_FLOPS_BF16 = 989.4e12        # per card, bf16 dense
HBM_BW = 3.35e12                  # bytes/s per card
NVLINK_BW = 450e9                 # bytes/s per card, one direction (NVLink 4)
NET_BW = 50e9                     # bytes/s per card across nodes (NDR)

_EXPERT_LEAVES = ("wi_gate", "wi_up", "wo")


def _expert_sizes(tree, n_of) -> list:
    """(numel, is_expert) of every leaf: an expert leaf is a
    ``wi_gate`` / ``wi_up`` / ``wo`` of an FFN that has a router (the
    reference's leaves with an "experts" axis; the shared experts and the
    router are not)."""
    out = []

    def walk(node):
        if isinstance(node, dict):
            moe = "router" in node
            for k in sorted(node):
                v = node[k]
                if moe and k in _EXPERT_LEAVES and not isinstance(v, dict):
                    out.append((n_of(v), True))
                else:
                    walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        else:
            out.append((n_of(node), False))

    walk(tree)
    return out


def count_active_params(cfg) -> int:
    """Parameters touched per token: routed experts scaled by top_k/E."""
    from repro_torch.models.model import Model
    total = 0
    for n, expert in _expert_sizes(Model(cfg).param_desc(),
                                   lambda d: int(np.prod(d.shape))):
        if expert:
            n = int(n * cfg.top_k / max(cfg.num_experts, 1))
        total += n
    return total


def model_flops_per_device(cfg, shape, devices: int) -> float:
    n_active = count_active_params(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.phase in
                                   ("train", "prefill") else 1)
    mult = 6.0 if shape.phase == "train" else 2.0
    return mult * n_active * tokens / devices


def analytic_memory_bytes(cfg, shape, devices: int) -> float:
    """The reference's HBM traffic model (fusion-aware napkin numbers; the
    traced byte counts in the records are upper bounds at fusion-less
    granularity).

      train:   params fwd+bwd reads (bf16) + grads f32 r/w + adam m,v f32
               r/w + param update w  ≈ 30 B/param(local)
               + remat-doubled activation traffic: 2 · L · tok_local · d
                 · 2 B · C  (C ≈ 12 block-sized tensor r/w per layer)
               + 4 gradient-accumulation microbatch re-reads of params
      prefill: params read + activation writes (single pass)
      decode:  params read + the whole KV cache / recurrent state read once
    """
    from repro_torch.models.model import Model
    n_params = cfg.num_params()
    tp = 16
    tokens_local = shape.global_batch * shape.seq_len / devices
    L, d = cfg.num_layers, cfg.d_model
    if shape.phase == "train":
        p_local = n_params / devices           # FSDP over all axes
        act = 2 * L * tokens_local * d * 2 * 12
        return 30 * p_local + 4 * 2 * p_local + act
    p_local = n_params * 2 / tp               # bf16, TP-only at serve time
    if shape.phase == "prefill":
        act = L * tokens_local * d * 2 * 12
        return p_local + act
    # decode: read the cache once per step
    model = Model(cfg)
    cache = model.init_cache(shape.global_batch, shape.seq_len,
                             src_len=shape.seq_len if cfg.is_encoder_decoder
                             else 0)
    cache_bytes = sum(int(np.prod(l.shape)) * l.dtype.itemsize
                      for l in tree_leaves(cache))
    shard = devices if shape.global_batch > 1 else tp
    return p_local + cache_bytes / shard


def axis_bw(rec, axis: str) -> float:
    """Bytes/s a card moves over mesh axis ``axis`` of a record: NVLink
    when the record's layout puts the axis's ranks in one node, the
    network otherwise (and for an axis the layout does not name)."""
    info = rec.get("layout", {}).get("axes", {}).get(axis)
    return NVLINK_BW if info and info.get("within_node") else NET_BW


def collective_s(rec) -> float:
    """Σ over axes of the wire bytes on the axis over its bandwidth; a
    record without the per-axis split is priced at the network's."""
    h = rec["hlo"]
    by_axis = h.get("collective_wire_bytes_by_axis")
    if by_axis is None:
        return h["collective_wire_bytes_per_device"] / NET_BW
    return sum(b / axis_bw(rec, a) for a, b in by_axis.items())


def terms(rec, cfg=None, shape=None) -> dict:
    h = rec["hlo"]
    compute = h["dot_flops_per_device"] / PEAK_FLOPS_BF16
    if cfg is not None and shape is not None:
        memory = analytic_memory_bytes(cfg, shape, rec["devices"]) / HBM_BW
    else:
        memory = h.get("memory_bytes_per_device", 0.0) / HBM_BW
    coll = collective_s(rec)
    dom = max(("compute", compute), ("memory", memory),
              ("collective", coll), key=lambda t: t[1])[0]
    return {"compute_s": compute, "memory_s": memory, "collective_s": coll,
            "dominant": dom,
            "hlo_memory_s_upper": h.get("memory_bytes_per_device", 0.0) / HBM_BW}


NOTES = {
    "compute": "compute-bound: reduce rectangle-waste in flash attention "
               "(triangular schedule) or shrink redundant remat recompute",
    "memory": "memory-bound: raise arithmetic intensity (fuse scans / larger "
              "chunk blocks, bf16 stacks, absorbed projections)",
    "collective": "collective-bound: compress the payload (§3.2), change the "
                  "algorithm (ring/hierarchical §4.1), or reshard to cut "
                  "all-gather volume",
}


def load_records(mesh: str, variant: str = "baseline"):
    recs = []
    for path in sorted(glob.glob(os.path.join(DRYRUN, f"*_{mesh}_{variant}.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def render_table(recs) -> str:
    lines = [
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "MODEL_TF/chip | useful ratio | HBM GiB |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for rec in recs:
        cfg = get_config(rec["arch"])
        shape = SHAPES[rec["shape"]]
        t = terms(rec, cfg, shape)
        mf = model_flops_per_device(cfg, shape, rec["devices"])
        hf = rec["hlo"]["dot_flops_per_device"]
        ratio = mf / hf if hf else float("nan")
        mem = rec["memory_analysis"]
        hbm = (mem.get("argument_size_in_bytes", 0)
               + mem.get("temp_size_in_bytes", 0)
               + mem.get("output_size_in_bytes", 0)) / 2**30
        lines.append(
            f"| {rec['arch']} | {rec['shape']} | {t['compute_s']:.3e} | "
            f"{t['memory_s']:.3e} | {t['collective_s']:.3e} | {t['dominant']} | "
            f"{mf/1e12:.2f} | {ratio:.2f} | {hbm:.1f} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.roofline")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--variant", default="baseline")
    args = ap.parse_args(argv)
    recs = load_records(args.mesh, args.variant)
    if not recs:
        raise SystemExit(f"no dry-run records for mesh {args.mesh} in {DRYRUN}")
    print(render_table(recs))
    print()
    for rec in recs:
        t = terms(rec, get_config(rec["arch"]), SHAPES[rec["shape"]])
        print(f"- {rec['arch']} x {rec['shape']}: dominant={t['dominant']} -> "
              f"{NOTES[t['dominant']]}")


if __name__ == "__main__":
    main()
