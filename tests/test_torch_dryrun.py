"""The port's dry run (``repro_torch.launch.dryrun``) at full width: one
rank of the ``16x16`` mesh traced on CPU fake tensors.

  * gemma-2b at train_4k, prefill_32k and decode_32k and
    qwen3-moe-30b-a3b at decode_32k, through the CLI's ``main`` in one
    subprocess, records written to ``tmp_path``: the reference's record
    keys and ``hlo`` sub-keys, the ``layout`` block (tp = ep = 16 and 16
    rows at train; at serve the batch split over data and the serve
    layout over the model axis, tp = 16), ``argument_size_in_bytes``
    equal to the reckoning from the shapes (the rank's bf16 parameters —
    the dense FFNs a sixteenth at train; at serve the vocabulary, the ffn
    dims and the experts a sixteenth, the query heads and the kv heads
    they read a head block — Adam's two f32 moments at train, the rank's
    sixteenth of the decode cache and the tokens), the donated decode
    cache as the alias, and the subprocess's host memory: its peak RSS
    at most ``HOST_MB`` above its RSS after the imports.  Train runs with
    ``--microbatches 1``: the per-micro-batch program is the same at 4
    micro-batches, whose trace takes 4x as long (~160 s here).
  * gemma2-9b's decode_32k at tp = 16: one head a rank (the kv head it
    reads on two ranks), each layer's cache split by length over the
    model axis (8 kv heads of 8 % 16 != 0), the wire on the model axis
    only.
  * ``repro_torch.launch.{dryrun,roofline,op_analysis}`` import nothing
    of ``repro`` or ``jax``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
HOST_MB = 400
PAIRS = [("gemma-2b", "train_4k"), ("gemma-2b", "prefill_32k"),
         ("gemma-2b", "decode_32k"), ("qwen3-moe-30b-a3b", "decode_32k")]

# the peak is this process image's VmHWM (``ru_maxrss`` keeps the parent's
# peak across fork and exec)
CHILD = """
import json, sys
from repro_torch.launch import dryrun
def status_mb(key):
    with open("/proc/self/status") as f:
        line = next(l for l in f if l.startswith(key + ":"))
    return int(line.split()[1]) / 1024
base = status_mb("VmRSS")
out = sys.argv[1]
for arch, shape in json.loads(sys.argv[2]):
    dryrun.main(["--arch", arch, "--shape", shape, "--microbatches", "1",
                 "--out", out])
print(json.dumps({"base_mb": base, "peak_mb": status_mb("VmHWM")}))
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", CHILD, str(out),
                        json.dumps(PAIRS)], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    mem = json.loads(p.stdout.strip().splitlines()[-1])
    recs = {(a, s): json.loads((out / f"{a}_{s}_16x16_baseline.json")
                               .read_text()) for a, s in PAIRS}
    return recs, mem, p.stdout


REF_KEYS = {"arch", "shape", "variant", "mesh", "devices", "phase",
            "memory_analysis", "cost_analysis", "hlo"}
HLO_KEYS = {"dot_flops_per_device", "memory_bytes_per_device",
            "collective_operand_bytes", "collective_wire_bytes_per_device",
            "collective_counts", "num_while_loops", "while_trip_counts_top"}
MEM_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes"}


def _reckoned_args(arch: str, shape: str) -> int:
    """The rank's argument bytes from ``count_params`` and the shapes."""
    import math

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models.layers import TensorSpec
    from repro_torch.models.model import Model, count_params
    from repro_torch._tree import tree_leaves
    cfg, sh = get_config(arch), SHAPES[shape]
    P = count_params(cfg)
    if sh.phase == "train":
        dense = sum(3 * cfg.d_model * cfg.d_ff
                    for i in range(cfg.num_layers)
                    if cfg.layer_spec(i).ffn == "dense")
        rank = P - dense + dense // 16
        return rank * (2 + 4 + 4) + (sh.global_batch // 16) * sh.seq_len * 4
    b = sh.global_batch // 16
    rank = _serve_rank_params(cfg, 16)
    assert rank < P
    if sh.phase == "prefill":
        return 2 * rank + b * sh.seq_len * 4
    return 2 * rank + _rank_cache(arch, shape) + b * 4


def _rank_cache(arch: str, shape: str) -> int:
    """The rank's sixteenth of its data shard's decode cache (kv heads or
    the length over the model axis: 16 parts either way here)."""
    import math

    from repro_torch._tree import tree_leaves
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models.layers import TensorSpec
    from repro_torch.models.model import Model
    sh = SHAPES[shape]
    b = sh.global_batch // 16
    leaves = tree_leaves(Model(get_config(arch)).init_cache(b, sh.seq_len))
    assert all(isinstance(s, TensorSpec) for s in leaves)
    return sum(math.prod(s.shape) * s.dtype.itemsize for s in leaves) // 16


def _serve_rank_params(cfg, tp: int) -> int:
    """The rank's parameters under the serve layout, from the widths: the
    vocabulary rows, ffn dims and experts a ``tp``-th; a head block of
    ``H / min(H, tp)`` query heads (wq columns, wo rows) and the kv heads
    they read; norms and routers whole."""
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    hl = H // min(H, tp)
    kvl = KV // min(H, tp) if KV % min(H, tp) == 0 else 1
    layer = 2 * d * hl * hd + 2 * d * kvl * hd + 2 * d
    if cfg.qk_norm:
        layer += 2 * hd
    total = 0
    for i in range(cfg.num_layers):
        if cfg.layer_spec(i).ffn == "moe":
            ff = cfg.moe_d_ff or cfg.d_ff
            total += layer + d * cfg.num_experts + \
                3 * (cfg.num_experts // tp) * d * ff
        else:
            total += layer + 3 * d * cfg.d_ff // tp
    heads = 1 if cfg.tie_embeddings else 2
    return total + heads * cfg.padded_vocab * d // tp + d


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_full_width_records(run, arch, shape):
    recs, _, log = run
    rec = recs[(arch, shape)]
    assert f"[ok] {arch} {shape} 16x16" in log
    assert REF_KEYS | {"trace_s", "layout"} == set(rec)
    assert HLO_KEYS <= set(rec["hlo"])
    assert set(rec["memory_analysis"]) == MEM_KEYS
    assert set(rec["cost_analysis"]) == {"flops", "bytes accessed"}
    assert (rec["mesh"], rec["devices"], rec["variant"]) == \
        ("16x16", 256, "baseline")
    assert rec["hlo"]["num_while_loops"] == 0
    assert rec["hlo"]["while_trip_counts_top"] == []
    assert rec["hlo"]["dot_flops_per_device"] > 0
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] == _reckoned_args(arch, shape)
    lay = rec["layout"]
    assert lay["rank"] == 0 and lay["dp"] == 16
    assert lay["mesh_axes"] == {"data": 16, "model": 16}
    assert lay["axes"]["model"] == {"size": 16, "stride": 1,
                                    "within_node": False}
    if rec["phase"] == "train":
        assert (lay["tp"], lay["ep"], lay["batch_per_rank"]) == (16, 1, 16)
        assert lay["microbatches"] == 1
        assert set(lay["unsharded"]) == {"embeddings", "attention"}
        # the Megatron wire on the model axis, the dense DP edge on data;
        # the in-place update is the port's donation
        by_axis = rec["hlo"]["collective_wire_bytes_by_axis"]
        assert set(by_axis) == {"model", "data"}
        assert mem["alias_size_in_bytes"] == \
            mem["argument_size_in_bytes"] - 16 * 4096 * 4
    else:
        moe = arch == "qwen3-moe-30b-a3b"
        assert (lay["tp"], lay["ep"]) == (16, 16 if moe else 1)
        assert "tp_reason" not in lay and lay["unsharded"] == []
        assert lay["attn_tp"] == {"gemma-2b": 8}.get(arch, 16)
        assert lay["batch_per_rank"] == {"prefill": 2, "decode": 8}[
            rec["phase"]]
        # the head blocks', the FFNs' and the vocabulary's collectives,
        # all on the model axis
        assert set(rec["hlo"]["collective_wire_bytes_by_axis"]) == {"model"}
        assert rec["hlo"]["collective_counts"]["all-reduce"] > 0
        assert mem["alias_size_in_bytes"] == (
            _rank_cache(arch, shape) if rec["phase"] == "decode" else 0)
    if shape == "prefill_32k":
        assert rec["hlo"]["kernel_calls"] == {"flash_attention": 18}


def test_gemma2_decode_records_the_length_split():
    """gemma2-9b decode_32k, rank 0 of 16x16 at tp = 16: the cache split
    by length over the model axis in both layer kinds, attention over 16
    head blocks, the donated cache the alias, the wire on the model axis
    only: per layer the head block's and the FFN's all-reduces, the
    split-KV combine's two (the row maximum, then the sums and the
    weighted values), the step's queries and new K/V gathered; one
    all-reduce for the embedding, one all-gather for the logits."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    if dist.is_initialized():           # another file's world-1 group
        dist.destroy_process_group()
    rec = dryrun.trace_pair("gemma2-9b", "decode_32k")
    lay = rec["layout"]
    assert (lay["tp"], lay["attn_tp"], lay["heads_per_rank"]) == (16, 16, 1)
    assert lay["ranks_per_kv_head"] == 2
    assert lay["cache"] == {
        "window 4096": {"length": 4096, "kv_heads": None,
                        "length_over": ["model"], "positions_per_rank": 256,
                        "kv_heads_per_rank": 8},
        "global": {"length": 32768, "kv_heads": None,
                   "length_over": ["model"], "positions_per_rank": 2048,
                   "kv_heads_per_rank": 8}}
    assert lay["cache_donated"] is True
    h = rec["hlo"]
    assert set(h["collective_wire_bytes_by_axis"]) == {"model"}
    assert h["collective_counts"] == {"all-reduce": 4 * 42 + 1,
                                      "all-gather": 2 * 42 + 1}
    mem = rec["memory_analysis"]
    assert mem["alias_size_in_bytes"] == _rank_cache("gemma2-9b",
                                                     "decode_32k")


def test_host_memory_is_bounded(run):
    _, mem, _ = run
    assert mem["peak_mb"] - mem["base_mb"] <= HOST_MB, mem


def test_no_reference_import():
    code = ("import sys\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.roofline, "
            "repro_torch.launch.op_analysis, repro_torch.launch.report\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') "
            "or m.startswith(('jax.', 'repro.', 'jaxlib')))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert p.returncode == 0, p.stdout + p.stderr
