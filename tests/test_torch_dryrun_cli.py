"""The dry run's variants, its ``--multi-pod`` mesh and its CLI
(``repro_torch.launch.dryrun``).

  * Each variant's record: ``zero1`` and ``comm_int8_fused`` (gemma-2b
    train_4k) and ``chunkwise`` (xlstm-125m train_4k) with the
    configuration cut to one layer (``dryrun.get_config`` patched: the
    full-width variants take minutes), ``mla_absorb`` / ``optimized``
    (deepseek-v2-lite-16b) and ``moe_dispatch`` (qwen3-moe-30b-a3b) at
    decode_32k at full width.
  * ``--multi-pod``: the ``(pod, data, model)`` mesh of 512, the data edge
    over the 32 ranks of ``(pod, data)``.
  * The CLI: a width the port's tensor parallelism refuses (an FFN of
    1000 over 16 ranks, at train and under the serve layout) is the
    port's own ``ValueError``, listed as ``[FAIL]`` beside the pair that
    passes, and the run exits with the reference's message; ``--skip-existing``; ``--progress``; the per-op
    table of ``--save-trace``, whose rows sum to the record's dot FLOPs;
    an unknown variant.
"""
from __future__ import annotations

import dataclasses
import json

import pytest
import torch.distributed as dist

from repro_torch.launch import dryrun

GEMMA = "gemma-2b"
XLSTM = "xlstm-125m"


@pytest.fixture(autouse=True)
def _no_stale_group():
    """Other test files leave their world-1 gloo group behind in the
    worker process that runs this file next; the dry run and the fake
    worlds here make their own default group, so a stale one goes first."""
    if dist.is_initialized():
        dist.destroy_process_group()
    yield


@pytest.fixture
def one_layer(monkeypatch):
    orig = dryrun.get_config
    monkeypatch.setattr(dryrun, "get_config", lambda a: dataclasses.replace(
        orig(a), num_layers=1))


def test_zero1_and_comm_variants(one_layer):
    base = dryrun.trace_pair(GEMMA, "train_4k", microbatches=1)
    zero1 = dryrun.trace_pair(GEMMA, "train_4k", variant="zero1")
    comm = dryrun.trace_pair(GEMMA, "train_4k", variant="comm_int8_fused")
    assert (zero1["variant"], comm["variant"]) == ("zero1", "comm_int8_fused")
    assert zero1["layout"]["program"].startswith("make_sharded_train_step")
    assert comm["layout"]["program"].startswith(
        "make_comm_optimized_train_step(SyncConfig('int8_fused', "
        "algo='ring'")
    # the same rank's products; the moments and master in rows over data
    assert zero1["hlo"]["dot_flops_per_device"] == \
        comm["hlo"]["dot_flops_per_device"] == \
        base["hlo"]["dot_flops_per_device"]
    args = {r["variant"]: r["memory_analysis"]["argument_size_in_bytes"]
            for r in (base, zero1, comm)}
    params = (args["baseline"] - 16 * 4096 * 4) // 5      # bf16 of 2+4+4
    assert args["zero1"] < args["baseline"] < args["comm_int8_fused"]
    assert args["zero1"] - 16 * 4096 * 4 - 2 * params <= 12 * params // 2 / 16
    assert "all-gather" in zero1["hlo"]["collective_counts"]   # the rows
    calls = comm["hlo"]["kernel_calls"]
    assert calls["quantize_ef"] == calls["dequant_accum"] > 0
    assert comm["hlo"]["collective_counts"]["all-gather"] == \
        2 * calls["quantize_ef"]
    assert base["hlo"]["kernel_calls"] == {}


def test_expert_parallel_train_rank(one_layer):
    """qwen3-moe's rank at train: the experts split ep = 16 over the model
    axis (``sharding_ctx.ep_region``): per layer the dispatch and the
    combine all-to-all in the forward, again in the checkpoint's
    recomputation, and their transposes in the backward."""
    rec = dryrun.trace_pair("qwen3-moe-30b-a3b", "train_4k", microbatches=1)
    lay = rec["layout"]
    assert (lay["tp"], lay["ep"]) == (1, 16)       # every FFN is MoE
    assert "experts" not in lay["unsharded"]
    assert "routers" not in lay["unsharded"]
    counts = rec["hlo"]["collective_counts"]
    assert counts["all-to-all"] == 6
    assert set(rec["hlo"]["collective_wire_bytes_by_axis"]) == \
        {"model", "data"}


def test_chunkwise_variant(one_layer):
    rec = dryrun.trace_pair("xlstm-125m", "train_4k", variant="chunkwise",
                            microbatches=1)
    assert rec["variant"] == "chunkwise" and rec["phase"] == "train"
    assert rec["layout"]["tp"] == 1          # no dense FFN to split
    assert "mLSTM" in rec["layout"]["unsharded"]
    assert rec["hlo"]["dot_flops_per_device"] > 0


def test_decode_variants_at_full_width():
    base = dryrun.trace_pair("deepseek-v2-lite-16b", "decode_32k")
    absorb = dryrun.trace_pair("deepseek-v2-lite-16b", "decode_32k",
                               variant="mla_absorb")
    opt = dryrun.trace_pair("deepseek-v2-lite-16b", "decode_32k",
                            variant="optimized")
    qwen = dryrun.trace_pair("qwen3-moe-30b-a3b", "decode_32k",
                             variant="moe_dispatch")
    assert absorb["layout"]["program"] == \
        "make_decode_step(mla_absorb=True, moe_dispatch=False)"
    assert opt["layout"]["program"] == \
        "make_decode_step(mla_absorb=True, moe_dispatch=True)"
    assert qwen["layout"]["program"] == \
        "make_decode_step(mla_absorb=False, moe_dispatch=True)"
    flops = [r["hlo"]["dot_flops_per_device"] for r in (base, absorb, opt)]
    assert len(set(flops)) == 3, flops
    for r in (base, absorb, opt, qwen):
        assert r["memory_analysis"]["argument_size_in_bytes"] > 0
        assert r["layout"]["pos"] == 32767


def test_multi_pod_mesh(one_layer):
    dec = dryrun.trace_pair(GEMMA, "decode_32k", multi_pod=True)
    assert (dec["mesh"], dec["devices"]) == ("2x16x16", 512)
    lay = dec["layout"]
    assert lay["data_axes"] == ["pod", "data"] and lay["dp"] == 32
    assert lay["batch_per_rank"] == 4
    assert lay["axes"]["pod"] == {"size": 2, "stride": 256,
                                  "within_node": False}
    train = dryrun.trace_pair(GEMMA, "train_4k", multi_pod=True,
                              microbatches=1)
    assert train["layout"]["batch_per_rank"] == 8
    assert set(train["hlo"]["collective_wire_bytes_by_axis"]) == \
        {"pod", "data", "model"}


def test_cli_refusal_is_listed_as_fail(tmp_path, monkeypatch, capsys):
    """An FFN of 1000 splits over 16 ranks neither at train (tp = 16) nor
    under the serve layout: both of gemma-2b's pairs are the port's
    refusals, listed beside xlstm-125m's decode (whole on the rank), which
    passes and is then skipped."""
    orig = dryrun.get_config
    monkeypatch.setattr(dryrun, "get_config", lambda a: dataclasses.replace(
        orig(a), num_layers=1, d_ff=1000))
    monkeypatch.setattr(dryrun, "ALL_ARCHS", (GEMMA, XLSTM))
    monkeypatch.setattr(dryrun, "applicable_shapes",
                        lambda cfg: ("decode_32k",) if cfg.name == XLSTM
                        else ("train_4k", "decode_32k"))
    with pytest.raises(SystemExit, match="^2 dry-run failures$"):
        dryrun.main(["--all", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert (f"[FAIL] {GEMMA} train_4k 16x16: ValueError: dim -1 of shape "
            f"(2048, 1000) does not split over 16 ranks") in out
    assert (f"[FAIL] {GEMMA} decode_32k 16x16: ValueError: ffn dim of "
            f"(2048, 1000) does not split over tp=16") in out
    assert f"[ok] {XLSTM} decode_32k 16x16" in out
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == [f"{XLSTM}_decode_32k_16x16_baseline.json"]
    rec = json.loads((tmp_path / names[0]).read_text())
    assert rec["shape"] == "decode_32k"
    assert dryrun.main(["--arch", XLSTM, "--shape", "decode_32k",
                        "--skip-existing", "--out", str(tmp_path)]) == 0
    assert f"[skip] {names[0]}" in capsys.readouterr().out


def test_progress_and_save_trace(one_layer, tmp_path, capsys):
    assert dryrun.main(["--arch", GEMMA, "--shape", "prefill_32k",
                        "--progress", "0.05", "--save-trace",
                        "--out", str(tmp_path)]) == 0
    err = capsys.readouterr().err
    assert f"[progress] {GEMMA} prefill_32k 16x16 baseline: " in err
    rows = (tmp_path / f"{GEMMA}_prefill_32k_16x16_baseline.ops.tsv"
            ).read_text().splitlines()
    assert rows[0] == "op\tcalls\tdot_flops\tbytes"
    assert "kernel:flash_attention\t1\t" in rows[-1]
    rec = json.loads((tmp_path / f"{GEMMA}_prefill_32k_16x16_baseline"
                                 f".json").read_text())
    table_flops = sum(float(r.split("\t")[2]) for r in rows[1:])
    assert table_flops == rec["hlo"]["dot_flops_per_device"]


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="unknown variant"):
        dryrun.trace_pair(GEMMA, "decode_32k", variant="fsdp")
