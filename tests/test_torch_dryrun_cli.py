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
import math

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


@pytest.fixture
def two_layers(monkeypatch):
    orig = dryrun.get_config
    monkeypatch.setattr(dryrun, "get_config", lambda a: dataclasses.replace(
        orig(a), num_layers=2))


def test_expert_parallel_train_rank(two_layers):
    """deepseek-v2-lite's rank at train with the experts split ep = 16 over
    the model axis (``sharding_ctx.ep_region``; no dry-run record trains
    on it since every family trains under the train layout, so the step
    is traced here through the op analysis on the fake group), layer 1
    the one MoE layer (layer 0 dense): the dispatch and the combine
    all-to-all in the forward, again in the checkpoint's recomputation,
    and their transposes in the backward.  The rank holds 4 of the 64
    experts and the router whole, as the reference's train rules hold
    it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch._tree import tree_leaves, tree_map_with_path
    from repro_torch.configs import SHAPES
    from repro_torch.convert import ep_slice
    from repro_torch.launch import op_analysis
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.layers import ParamDesc
    from repro_torch.models.model import Model
    from repro_torch.models.sharding_ctx import ep_region
    from repro_torch.optim import make_optimizer
    cfg = dryrun.get_config("deepseek-v2-lite-16b")
    shape = SHAPES["train_4k"]
    model = Model(cfg)
    mesh = dryrun.FakeMesh(False).open()
    try:
        mode = FakeTensorMode()
        with mode:
            params = ep_slice(model.abstract_params(mode=mode), 0, 16)
            inputs = dryrun._materialize(model.input_specs(
                dataclasses.replace(shape, global_batch=16)), mode)
            opt = make_optimizer("adam", lr=1e-4)
            state = opt.init(params)
        step = make_train_step(model, opt, group=mesh.groups["data"])
        with mode, ep_region(mesh.groups["model"]):
            _, stats = op_analysis.trace(step, (params, state, inputs, 0),
                                         axis_names=mesh.axis_names())
    finally:
        mesh.close()
    ffn = params["stack"][1][0]["ffn"]
    assert ffn["wi_gate"].shape[-3] == cfg.num_experts // 16      # ep = 16
    # the leaves the reference's train rules put on the model axis that
    # the rank holds whole: not the experts (the shared experts are, as
    # under ep_slice); the router is not on the model axis
    paths = []
    tree_map_with_path(lambda path, _: paths.append(path), params)
    specs = tree_leaves(model.partition_specs("train"),
                        is_leaf=lambda x: isinstance(x, tuple))
    descs = tree_leaves(model.param_desc(),
                        is_leaf=lambda x: isinstance(x, ParamDesc))
    whole = [path for path, spec, t, d in zip(paths, specs,
                                              tree_leaves(params), descs)
             if "model" in spec and tuple(t.shape) == d.shape]
    experts = ("stack", 1, 0, "ffn")
    assert not [p for p in whole if p[:4] == experts and len(p) == 5]
    assert ffn["router"].shape == (cfg.d_model, cfg.num_experts)
    hlo = stats.hlo_block()
    assert hlo["collective_counts"]["all-to-all"] == 6
    assert hlo["collective_counts_by_axis"]["model"]["all-to-all"] == 6
    assert set(hlo["collective_wire_bytes_by_axis"]) == {"model", "data"}


def test_mla_train_rank_under_train_layout(two_layers):
    """deepseek-v2-lite's rank at train under the train layout over the
    model axis: one of its 16 heads a rank (``wq`` / ``w_ukv`` columns,
    ``wo`` rows), the latent projection whole and under the replica
    edge, 4 of the 64 experts and a sixteenth of the shared experts' and
    the dense FFN's ffn dim, the vocabulary in blocks of 6400 rows; every
    token routed on every rank, so no all-to-all; the rank's arguments
    are the rank's share, about a sixteenth of the whole model's."""
    from repro_torch.models.layers import ParamDesc
    from repro_torch.models.model import Model
    from repro_torch._tree import tree_leaves
    rec = dryrun.trace_pair("deepseek-v2-lite-16b", "train_4k",
                            microbatches=1)
    lay = rec["layout"]
    assert (lay["tp"], lay["ep"], lay["train_layout"]) == \
        (16, 16, "model axis")
    assert (lay["attn_tp"], lay["heads_per_rank"]) == (16, 1)
    assert lay["replica_edge"] == ["kv_norm", "w_dkv"]
    assert lay["unsharded"] == ["norms", "routers",
                                "MLA latent projection (w_dkv, kv_norm)"]
    assert lay["vocab_rows_per_rank"] == 6400
    assert "all-to-all" not in rec["hlo"]["collective_counts"]
    assert set(rec["hlo"]["collective_counts_by_axis"]["model"]) == \
        {"all-reduce"}
    cfg = dryrun.get_config("deepseek-v2-lite-16b")
    whole = sum(math.prod(d.shape) for d in tree_leaves(
        Model(cfg).param_desc(), is_leaf=lambda x: isinstance(x, ParamDesc)))
    # bf16 parameters, f32 moments: 10 bytes a parameter
    args = rec["memory_analysis"]["argument_size_in_bytes"]
    assert 10 * whole / 16 < args < 10 * whole / 12


def test_expert_parallel_train_rank_under_train_layout(one_layer):
    """qwen3-moe's rank at train, under the train layout over the model
    axis (``sharding_ctx.train_region``): the heads over tp = 16 and the
    experts in blocks of 8 over the same axis, every token routed on every
    rank (the model axis holds the same tokens), so no all-to-all: the
    expert block's sum and its inputs' sums are all-reduces on the model
    axis; the router and the QK-norm scales whole."""
    rec = dryrun.trace_pair("qwen3-moe-30b-a3b", "train_4k", microbatches=1)
    lay = rec["layout"]
    assert (lay["tp"], lay["ep"]) == (16, 16)
    assert "experts" not in lay["unsharded"]
    assert lay["unsharded"] == ["norms", "routers", "q / k norms"]
    counts = rec["hlo"]["collective_counts"]
    assert "all-to-all" not in counts
    assert set(rec["hlo"]["collective_wire_bytes_by_axis"]) == \
        {"model", "data"}


# arch: (layers, sequence length): the grouped-query families at
# train_4k's own length; the others at a short one (the recurrent loops
# trace every step), deepseek-v2-lite at two layers (layer 1 the MoE)
RECKONED = {"gemma3-4b": (1, None), "qwen3-moe-30b-a3b": (1, None),
            "deepseek-v2-lite-16b": (2, 64), "jamba-v0.1-52b": (1, 16),
            "xlstm-125m": (1, 16), "seamless-m4t-large-v2": (1, 64)}


@pytest.mark.parametrize("arch", list(RECKONED))
def test_train_layout_collectives_equal_the_reckoning(monkeypatch, arch):
    """A fake trace of one train step of rank 0 under the train layout
    (``RECKONED``'s layers and length, one micro-batch): its collectives
    on the model axis, counted by the op analysis, are
    ``dryrun.train_layout_collectives``' reckoning, in number of each
    kind and in wire bytes (the reference's ``2·b·(p−1)/p`` an
    all-reduce, ``b·(p−1)`` an all-gather); the data axis carries only
    the DP edge's, one a leaf and the loss's mean."""
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import SHAPES
    from repro_torch.launch.op_analysis import wire_formula
    from repro_torch.models.layers import ParamDesc
    from repro_torch.models.model import Model
    layers, seq = RECKONED[arch]
    orig = dryrun.get_config
    monkeypatch.setattr(dryrun, "get_config", lambda a: dataclasses.replace(
        orig(a), num_layers=layers, num_encoder_layers=layers
        if orig(a).is_encoder_decoder else 0))
    shape = SHAPES["train_4k"]
    seq = seq or shape.seq_len
    monkeypatch.setattr(dryrun, "SHAPES", dict(
        SHAPES, train_4k=dataclasses.replace(shape, seq_len=seq)))
    rec = dryrun.trace_pair(arch, "train_4k", microbatches=1)
    cfg = dryrun.get_config(arch)
    want = dryrun.train_layout_collectives(
        cfg, rec["layout"]["batch_per_rank"], seq, 16)
    kinds = {}
    for _, kind, _ in want:
        kinds[kind] = kinds.get(kind, 0) + 1
    by_axis = rec["hlo"]["collective_counts_by_axis"]
    assert by_axis["model"] == kinds
    assert rec["hlo"]["collective_wire_bytes_by_axis"]["model"] == \
        sum(wire_formula(kind, b, 16) for _, kind, b in want)
    leaves = len(tree_leaves(Model(cfg).param_desc(),
                             is_leaf=lambda x: isinstance(x, ParamDesc)))
    assert by_axis["data"] == {"all-reduce": leaves + 1}


def test_chunkwise_variant(one_layer):
    rec = dryrun.trace_pair("xlstm-125m", "train_4k", variant="chunkwise",
                            microbatches=1)
    assert rec["variant"] == "chunkwise" and rec["phase"] == "train"
    # the mLSTM over inner under the train layout: 96 channels and 24
    # rows of dh_v a rank, b_if and out_norm whole under the replica edge
    assert rec["layout"]["tp"] == 16
    assert (rec["layout"]["mlstm_inner_per_rank"],
            rec["layout"]["mlstm_dh_v_rows_per_rank"]) == (96, 24)
    assert rec["layout"]["unsharded"] == ["norms", "mLSTM b_if, out_norm"]
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
    """An FFN of 1000 splits over 16 ranks neither under the train layout
    nor under the serve layout (both cut by ``convert``'s one model-axis
    cut): both of gemma-2b's pairs are the port's refusals, listed beside
    xlstm-125m's decode (under the serve layout over ``inner`` at tp =
    16), which passes and is then skipped."""
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
    assert (f"[FAIL] {GEMMA} train_4k 16x16: ValueError: ffn dim of "
            f"(2048, 1000) does not split over tp=16") in out
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
