"""The port's roofline and report tables (``repro_torch.launch.roofline``,
``repro_torch.launch.report``) against the JAX package's.

  * ``count_active_params``, ``model_flops_per_device`` and
    ``analytic_memory_bytes`` equal the reference's exactly for every
    architecture x applicable shape x mesh (256 and 512 devices);
  * ``render_table``, ``dryrun_table`` and ``variants_table`` give the
    reference's text for the same record dicts, each package's
    ``load_records`` pointed at the same temporary directory
    (``monkeypatch``; nothing of the reference is edited).  The one named
    difference: the port's dry-run table has a ``trace s`` column where
    the reference's has ``compile s`` (the port traces, it does not
    compile); and ``render_table``'s times are compared with the port's
    constants set to the reference's (its H100 constants give other times
    by design);
  * ``terms()`` prices with the H100 data sheet's constants and no TPU
    constant: compute at 989.4e12, memory at 3.35e12, the wire per mesh
    axis at 450e9 inside a node of 8 cards and 50e9 across nodes.
"""
from __future__ import annotations

import inspect
import json

import pytest

from repro_torch.configs import ALL_ARCHS, SHAPES, applicable_shapes
from repro_torch.configs import get_config as torch_config

PAIRS = [(a, s) for a in ALL_ARCHS for s in applicable_shapes(torch_config(a))]
DEVICES = (256, 512)


def test_applicable_shapes_match_the_reference():
    from repro.configs import applicable_shapes as ref_shapes
    from repro.configs import get_config
    for arch in ALL_ARCHS:
        assert applicable_shapes(torch_config(arch)) == \
            ref_shapes(get_config(arch)), arch


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_analytic_functions_equal_the_reference(arch, shape):
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_config
    from repro.launch import roofline as ref

    from repro_torch.launch import roofline as mine
    cfg, rcfg = torch_config(arch), get_config(arch)
    assert mine.count_active_params(cfg) == ref.count_active_params(rcfg)
    for devices in DEVICES:
        got = (mine.model_flops_per_device(cfg, SHAPES[shape], devices),
               mine.analytic_memory_bytes(cfg, SHAPES[shape], devices))
        want = (ref.model_flops_per_device(rcfg, REF_SHAPES[shape], devices),
                ref.analytic_memory_bytes(rcfg, REF_SHAPES[shape], devices))
        assert got == want, (arch, shape, devices)


def _record(arch, shape, mesh, variant, i):
    """A record dict with both packages' keys (the reference's
    ``compile_s`` and the port's ``trace_s``, the port's per-axis wire and
    layout), its numbers made from ``i``."""
    devices = 512 if mesh == "2x16x16" else 256
    wire = {"data": 1.5e9 * (i + 1), "model": 2.5e8 * (i + 2)}
    return {
        "arch": arch, "shape": shape, "variant": variant, "mesh": mesh,
        "devices": devices, "phase": SHAPES[shape].phase,
        "compile_s": 3.0 + i, "trace_s": 3.0 + i,
        "memory_analysis": {"argument_size_in_bytes": 2**33 + i * 2**28,
                            "output_size_in_bytes": 2**30,
                            "temp_size_in_bytes": 2**31 + i * 2**27,
                            "alias_size_in_bytes": 2**30},
        "cost_analysis": {"flops": 1e15, "bytes accessed": 1e12},
        "hlo": {"dot_flops_per_device": 1.25e15 * (i + 1),
                "memory_bytes_per_device": 4e12 + i * 1e11,
                "collective_operand_bytes": 1e9,
                "collective_wire_bytes_per_device": sum(wire.values()),
                "collective_counts": {"all-reduce": 10 + i,
                                      "all-to-all": i,
                                      "collective-permute": 2 * i},
                "num_while_loops": 0, "while_trip_counts_top": [],
                "collective_wire_bytes_by_axis": wire},
        "layout": {"axes": {"data": {"size": 16, "stride": 16,
                                     "within_node": False},
                            "model": {"size": 16, "stride": 1,
                                      "within_node": False}}},
    }


RECORDS = [("gemma-2b", "train_4k", "16x16", "baseline"),
           ("gemma-2b", "decode_32k", "16x16", "baseline"),
           ("qwen3-moe-30b-a3b", "prefill_32k", "16x16", "baseline"),
           ("xlstm-125m", "long_500k", "16x16", "baseline"),
           ("deepseek-v2-lite-16b", "decode_32k", "16x16", "baseline"),
           ("gemma-2b", "train_4k", "2x16x16", "baseline"),
           ("gemma-2b", "train_4k", "16x16", "zero1"),
           ("gemma-2b", "train_4k", "16x16", "comm_int8_fused"),
           ("deepseek-v2-lite-16b", "decode_32k", "16x16", "mla_absorb"),
           ("xlstm-125m", "train_4k", "16x16", "chunkwise")]


@pytest.fixture
def records(tmp_path, monkeypatch):
    """The same record files, both packages' readers pointed at them."""
    import repro.launch.report as ref_report
    import repro.launch.roofline as ref_roofline

    from repro_torch.launch import roofline
    for i, (arch, shape, mesh, variant) in enumerate(RECORDS):
        path = tmp_path / f"{arch}_{shape}_{mesh}_{variant}.json"
        path.write_text(json.dumps(_record(arch, shape, mesh, variant, i)))
    monkeypatch.setattr(ref_roofline, "ARTIFACTS", str(tmp_path))
    monkeypatch.setattr(ref_report, "ARTIFACTS", str(tmp_path))
    monkeypatch.setattr(roofline, "DRYRUN", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_render_table_gives_the_reference_text(records, monkeypatch, mesh):
    import repro.launch.roofline as ref

    from repro_torch.launch import roofline as mine
    for name, value in (("PEAK_FLOPS_BF16", ref.PEAK_FLOPS_BF16),
                        ("HBM_BW", ref.HBM_BW), ("NVLINK_BW", ref.ICI_BW),
                        ("NET_BW", ref.ICI_BW)):
        monkeypatch.setattr(mine, name, value)
    recs, ref_recs = mine.load_records(mesh), ref.load_records(mesh)
    assert recs == ref_recs and recs
    assert mine.render_table(recs) == ref.render_table(ref_recs)
    assert mine.NOTES == ref.NOTES


def test_dryrun_and_variants_tables_give_the_reference_text(records):
    import repro.launch.report as ref

    from repro_torch.launch import report as mine
    want = ref.dryrun_table().replace("| compile s |", "| trace s |")
    assert mine.dryrun_table() == want
    assert len(want.splitlines()) == 2 + 6      # both meshes' baselines
    assert mine.variants_table() == ref.variants_table()
    assert len(mine.variants_table().splitlines()) == 2 + 4


def test_variants_table_with_a_wireless_baseline(records):
    """A serving variant beside its baseline, neither moving a wire byte:
    the port writes "—" where the reference divides by zero."""
    from repro_torch.launch import report
    for i, variant in enumerate(("baseline", "optimized")):
        rec = _record("qwen3-moe-30b-a3b", "decode_32k", "16x16", variant, i)
        rec["hlo"]["collective_wire_bytes_per_device"] = 0.0
        (records / f"qwen3-moe-30b-a3b_decode_32k_16x16_{variant}.json"
         ).write_text(json.dumps(rec))
    rows = [r for r in report.variants_table().splitlines()
            if "qwen3-moe" in r]
    assert len(rows) == 1 and rows[0].endswith("| 0.000 | 10.4 | — |")


def test_terms_use_the_h100_constants_only():
    import repro.launch.mesh as tpu

    from repro_torch.launch import roofline
    assert (roofline.PEAK_FLOPS_BF16, roofline.HBM_BW, roofline.NVLINK_BW,
            roofline.NET_BW) == (989.4e12, 3.35e12, 450e9, 50e9)
    constants = {v for k, v in vars(roofline).items()
                 if k.isupper() and isinstance(v, float)}
    # (NDR's 50e9 B/s happens to equal the TPU's ICI link in value; the
    # module names no ICI constant)
    assert not constants & {tpu.PEAK_FLOPS_BF16, tpu.HBM_BW}
    assert "ICI" not in inspect.getsource(roofline)
    rec = _record("gemma-2b", "train_4k", "16x16", "baseline", 0)
    rec["layout"]["axes"]["model"]["within_node"] = True
    t = roofline.terms(rec)
    assert t["compute_s"] == 1.25e15 / 989.4e12
    assert t["memory_s"] == 4e12 / 3.35e12
    assert t["collective_s"] == 1.5e9 / 50e9 + 5e8 / 450e9
    assert t["dominant"] == "compute"           # 1.263 s over 1.194
    cfg = torch_config("gemma-2b")
    t = roofline.terms(rec, cfg, SHAPES["train_4k"])
    assert t["memory_s"] == roofline.analytic_memory_bytes(
        cfg, SHAPES["train_4k"], 256) / 3.35e12
    # an axis the layout does not name, or a record without the split,
    # is priced at the network's rate
    del rec["hlo"]["collective_wire_bytes_by_axis"]
    assert roofline.terms(rec)["collective_s"] == \
        rec["hlo"]["collective_wire_bytes_per_device"] / 50e9
