"""The port's op analysis (``repro_torch.launch.op_analysis``) against the
JAX package's HLO analysis (``repro/launch/hlo_analysis.py``).

  (a) World 1: the reference's ``analyze`` of the compiled step and the
      port's count of the same step (fake tensors, the same reduced
      config): gemma-2b and qwen3-moe-30b-a3b reduced (2 layers, d_model
      256), train at ``microbatches=2`` (4 x 64 tokens), prefill (2 x 64)
      and decode (2 rows against a 64-entry cache).  Prefill and decode
      dot FLOPs are equal exactly (rel 1e-12), flash's formula included.
      Training differs by two products the port runs and the reference's
      compiled program does not, each named and reckoned:
        * the cross-entropy chunk's logits, recomputed in the backward
          (the port checkpoints its one chunk; XLA merges the one-trip
          scan's rematerialization with the forward): 2·(B/M)·T·V·d per
          micro-batch;
        * the scores Q·Kᵀ, recomputed by the FlashAttention-2 backward
          (``models/attention._Flash``), one product per layer and
          micro-batch that the reference's custom VJP shares with the
          rematerialized forward: 2·(B/M)·H·T·T·hd.
      With them the two are equal exactly (rel 1e-12).
  (b) ``check_hlo_collective_parse``'s numbers: the sum of an (8, 1024)
      f32 array over 8 ranks is one all-reduce of 4096 operand bytes and
      2·4096·7/8 wire bytes, on a real gloo world of 8 (a ``FileStore``
      rendezvous, 8 spawned processes) and on the fake backend.
  (c) int8_fused on ``ring`` at world 8: the port's count of
      ``make_comm_optimized_train_step`` (fake backend, fake tensors) has
      the collective counts, operand bytes and wire bytes of the
      reference's ``analyze`` of its own step on 8 fake devices (a
      subprocess of this file), exactly.
  (d) Each kernel's formula against its plain version counted with the
      suspension off (``kernels="plain"``): flash's dot FLOPs equal, every
      formula's bytes equal to its inputs read once and outputs written
      once, never above the plain version's; one call per wrapper; a
      kernel called inside another is part of the outer call.
  (e) The pinned-memory staging of ``p2p.to_wire`` / ``permute`` and
      ``collectives.all_gather`` is never reached by fake CPU tensors on
      the fake backend.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("gemma-2b", "qwen3-moe-30b-a3b")
B_TRAIN, B_SERVE, T, M = 4, 2, 64, 2


@pytest.fixture(autouse=True)
def _no_stale_group():
    """Other test files leave their world-1 gloo group behind in the
    worker process that runs this file next; the dry run and the fake
    worlds here make their own default group, so a stale one goes first."""
    if dist.is_initialized():
        dist.destroy_process_group()
    yield


def _fake_store():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    return FakeStore()


@pytest.fixture
def fake_world(request):
    """A fake process group of ``request.param`` ranks (rank 0)."""
    dist.init_process_group("fake", store=_fake_store(), rank=0,
                            world_size=request.param)
    yield request.param
    dist.destroy_process_group()


# -- (a) the reference's analyze vs the port's count, world 1 -----------------

def _ref_stats(arch: str, phase: str):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config, reduced
    from repro.launch.hlo_analysis import analyze
    from repro.launch.steps import (make_decode_step, make_prefill_step,
                                    make_train_step)
    from repro.models import Model
    from repro.optim import make_optimizer
    model = Model(reduced(get_config(arch)))
    params = model.abstract_params()
    i32 = jnp.int32
    if phase == "train":
        opt = make_optimizer("adam", lr=1e-4)
        fn = make_train_step(model, opt, microbatches=M)
        args = (params, jax.eval_shape(opt.init, params),
                {"tokens": jax.ShapeDtypeStruct((B_TRAIN, T), i32)},
                jax.ShapeDtypeStruct((), i32))
    elif phase == "prefill":
        fn = make_prefill_step(model)
        args = (params, {"tokens": jax.ShapeDtypeStruct((B_SERVE, T), i32)})
    else:
        fn = make_decode_step(model)
        args = (params, jax.ShapeDtypeStruct((B_SERVE, 1), i32),
                model.init_cache(B_SERVE, T), jax.ShapeDtypeStruct((), i32))
    return analyze(jax.jit(fn).lower(*args).compile().as_text(),
                   total_devices=1)


def _port_stats(arch: str, phase: str):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch._tree import tree_map
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import op_analysis
    from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                          make_train_step)
    from repro_torch.models.layers import TensorSpec
    from repro_torch.models.model import Model
    from repro_torch.optim import make_optimizer
    model = Model(reduced(get_config(arch)))
    mode = FakeTensorMode()
    params = model.abstract_params(mode=mode)
    i32 = torch.int32
    with mode:
        if phase == "train":
            opt = make_optimizer("adam", lr=1e-4)
            fn = make_train_step(model, opt, microbatches=M)
            args = (params, opt.init(params),
                    {"tokens": torch.empty(B_TRAIN, T, dtype=i32)}, 0)
        elif phase == "prefill":
            fn = make_prefill_step(model)
            args = (params, {"tokens": torch.empty(B_SERVE, T, dtype=i32)})
        else:
            fn = make_decode_step(model)
            cache = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype),
                             model.init_cache(B_SERVE, T),
                             is_leaf=lambda x: isinstance(x, TensorSpec))
            args = (params, torch.empty(B_SERVE, 1, dtype=i32), cache, T - 1)
        _, stats = op_analysis.trace(fn, args)
    return model.cfg, stats


def _named_extras(cfg, phase: str) -> float:
    """The training products the port runs that the reference's compiled
    step does not (the module docstring, (a))."""
    if phase != "train":
        return 0.0
    mb = B_TRAIN // M
    xent = M * 2.0 * mb * T * cfg.padded_vocab * cfg.d_model
    scores = M * cfg.num_layers * 2.0 * mb * cfg.num_heads * T * T * cfg.hd
    return xent + scores


@pytest.mark.parametrize("fake_world", [1], indirect=True)
@pytest.mark.parametrize("phase", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dot_flops_match_the_reference_analyze(fake_world, arch, phase):
    ref = _ref_stats(arch, phase)
    cfg, mine = _port_stats(arch, phase)
    want = ref.dot_flops + _named_extras(cfg, phase)
    assert mine.dot_flops == pytest.approx(want, rel=1e-12), \
        (arch, phase, mine.dot_flops, ref.dot_flops)
    assert mine.while_trip_counts == []         # eager: no loop to fold
    assert mine.collective_counts == {} == ref.collective_counts
    if phase == "prefill":
        # flash's plain-version FLOPs, 4·B·T·H·S·hd a layer, by formula
        assert mine.kernel_calls == {"flash_attention": cfg.num_layers}
        assert mine.kernel_flops["flash_attention"] == \
            cfg.num_layers * 4.0 * B_SERVE * T * cfg.num_heads * T * cfg.hd


# -- (b) check_hlo_collective_parse's numbers ---------------------------------

def _parse_numbers(stats) -> None:
    assert stats.collective_counts == {"all-reduce": 1}
    assert stats.collective_operand_bytes == 4096.0
    assert abs(stats.collective_wire_bytes - 2 * 4096 * 7 / 8) < 1
    assert stats.collective_wire_bytes_by_axis == {"data": 2 * 4096 * 7 / 8}


def _sum_over_ranks(x):
    """The reference check's program on one rank: its (1, 1024) row of
    the (8, 1024) array summed over the rows, then over the ranks."""
    from repro_torch.core.collectives import allreduce
    return allreduce(x.sum(0), "psum")


def _gloo_worker(rank: int, store: str, out: str) -> None:
    from repro_torch.launch import op_analysis
    from repro_torch.launch.dist import init_group
    torch.set_num_threads(1)
    init_group(torch.device("cpu"), world_size=8, rank=rank,
               store_path=store)
    x = torch.full((1, 1024), float(rank + 1))
    y, stats = op_analysis.trace(_sum_over_ranks, (x,),
                                 axis_names={None: "data"})
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"counts": stats.collective_counts,
                   "operand": stats.collective_operand_bytes,
                   "wire": stats.collective_wire_bytes,
                   "by_axis": stats.collective_wire_bytes_by_axis,
                   "sum": float(y[0])}, f)
    dist.barrier()
    dist.destroy_process_group()


def test_collective_parse_numbers_on_a_gloo_world_of_8(tmp_path):
    import torch.multiprocessing as tmp
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=_gloo_worker,
                         args=(r, str(tmp_path / "store"), str(tmp_path)))
             for r in range(8)]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=120)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0] * 8
    for r in range(8):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert got["counts"] == {"all-reduce": 1}, r
        assert got["operand"] == 4096.0
        assert abs(got["wire"] - 2 * 4096 * 7 / 8) < 1
        assert got["by_axis"] == {"data": 2 * 4096 * 7 / 8}
        assert got["sum"] == 36.0               # 1 + 2 + ... + 8


@pytest.mark.parametrize("fake_world", [8], indirect=True)
def test_collective_parse_numbers_on_the_fake_backend(fake_world):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import op_analysis
    with FakeTensorMode():
        x = torch.empty(1, 1024)
        y, stats = op_analysis.trace(_sum_over_ranks, (x,),
                                     axis_names={None: "data"})
    assert tuple(y.shape) == (1024,)
    _parse_numbers(stats)


# -- (c) the int8_fused ring at world 8 ---------------------------------------

C_TOKENS = (8, 32)       # the global batch: one row of 32 tokens a rank


def _reference_comm(out: str) -> None:
    """The reference's analyze of its int8_fused ring step on 8 fake
    devices (run as ``python this_file.py --reference-comm OUT``)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs import get_config, reduced
    from repro.core import SyncConfig
    from repro.launch.hlo_analysis import analyze
    from repro.launch.steps import make_comm_optimized_train_step
    from repro.models import Model
    from repro.optim import make_optimizer
    model = Model(reduced(get_config("gemma-2b")))
    mesh = jax.make_mesh((8, 1), ("data", "model"))
    params = model.abstract_params()
    opt = make_optimizer("adam", lr=1e-4)
    st = jax.eval_shape(opt.init, params)
    step, _, init_sync = make_comm_optimized_train_step(
        model, opt, SyncConfig(compressor="int8_fused", algo="ring",
                               bucket_bytes=0), mesh, ("data",))
    ss = jax.eval_shape(init_sync, params)
    rep = NamedSharding(mesh, P())
    f = jax.jit(step, in_shardings=(
        jax.tree.map(lambda _: rep, params), jax.tree.map(lambda _: rep, st),
        jax.tree.map(lambda _: NamedSharding(mesh, P("data")), ss),
        {"tokens": NamedSharding(mesh, P("data", None))}, rep, rep))
    txt = f.lower(params, st, ss,
                  {"tokens": jax.ShapeDtypeStruct(C_TOKENS, jnp.int32)},
                  jax.ShapeDtypeStruct((), jnp.int32),
                  jax.ShapeDtypeStruct((2,), jnp.uint32)).compile().as_text()
    s = analyze(txt, total_devices=8)
    with open(out, "w") as fh:
        json.dump({"counts": s.collective_counts,
                   "operand": s.collective_operand_bytes,
                   "wire": s.collective_wire_bytes}, fh)


@pytest.mark.parametrize("fake_world", [8], indirect=True)
def test_int8_fused_ring_wire_matches_the_reference(fake_world, tmp_path):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.grad_sync import SyncConfig
    from repro_torch.launch import op_analysis
    from repro_torch.launch.steps import make_comm_optimized_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim import make_optimizer
    out = tmp_path / "reference.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref = subprocess.Popen([sys.executable, __file__, "--reference-comm",
                            str(out)], env=env, cwd=ROOT,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    model = Model(reduced(get_config("gemma-2b")))
    mode = FakeTensorMode()
    params = model.abstract_params(mode=mode)
    opt = make_optimizer("adam", lr=1e-4)
    step, _, init_sync = make_comm_optimized_train_step(
        model, opt, SyncConfig(compressor="int8_fused", algo="ring",
                               bucket_bytes=0), None)
    with mode:
        st, ss = opt.init(params), init_sync(params)
        tokens = torch.empty(C_TOKENS[0] // 8, C_TOKENS[1], dtype=torch.int32)
        _, mine = op_analysis.trace(step, (params, st, ss,
                                           {"tokens": tokens}, 0, None),
                                    axis_names={None: "data"})
    log, _ = ref.communicate(timeout=300)
    assert ref.returncode == 0, log
    want = json.loads(out.read_text())
    assert mine.collective_counts == want["counts"]
    assert mine.collective_operand_bytes == want["operand"]
    assert mine.collective_wire_bytes == pytest.approx(want["wire"],
                                                       rel=1e-12)
    n_leaves = mine.kernel_calls["quantize_ef"]
    assert mine.kernel_calls == {"quantize_ef": n_leaves,
                                 "dequant_accum": n_leaves}
    assert want["counts"]["all-gather"] == 2 * n_leaves


# -- (d) the kernels' formulas against their plain versions --------------------

def _kernel_cases():
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)
    n = 3000                                  # a ragged last tile
    return {
        "flash_attention": ((r(2, 96, 4, 32), r(2, 80, 2, 32),
                             r(2, 80, 2, 32)), {"causal": False}),
        "quantize_tiles": ((r(n, dtype=torch.bfloat16),), {"tile": 256}),
        "quantize_ef": ((r(n), r(n)), {}),
        "dequant_accum": ((torch.randint(-127, 128, (4, n), generator=g,
                                         dtype=torch.int8),
                           r(4, 3).abs()), {}),
        "topk_ef": ((r(n), r(n)), {"ratio": 0.05}),
        "topk_mask": ((r(n),), {"ratio": 0.05}),
        "nonfinite_tiles": ((r(2, 130, 2, 64),), {}),
    }


def _count_kernel(name, args, kw, kernels):
    from repro_torch.kernels import ops
    from repro_torch.launch import op_analysis
    fn = getattr(ops, name)
    with op_analysis.count(kernels=kernels) as c:
        out = fn(*args, **kw)
    return out, c.stats


@pytest.mark.parametrize("name", sorted(_kernel_cases()))
def test_kernel_formula_against_its_plain_version(name):
    from repro_torch.launch.op_analysis import _tensors, nbytes
    args, kw = _kernel_cases()[name]
    out, formula = _count_kernel(name, args, kw, "formula")
    _, plain = _count_kernel(name, args, kw, "plain")
    assert formula.kernel_calls == plain.kernel_calls == {name: 1}
    assert formula.aten_ops == 0 < plain.aten_ops
    moved = sum(nbytes(t) for t in args) + sum(nbytes(t)
                                               for t in _tensors(out))
    assert formula.memory_bytes == formula.kernel_bytes[name] == moved
    assert formula.memory_bytes <= plain.memory_bytes
    assert formula.dot_flops == plain.dot_flops
    if name == "flash_attention":
        q, k, _ = args
        B, T_, H, hd = q.shape
        assert formula.dot_flops == 4.0 * B * T_ * H * k.shape[1] * hd > 0


def test_a_kernel_inside_another_is_part_of_the_outer_call():
    from repro_torch.kernels import ops
    from repro_torch.launch import op_analysis
    args, _ = _kernel_cases()["flash_attention"]
    with op_analysis.count() as c:
        with op_analysis.kernel_call("flash_attention", *args) as box:
            ops.nonfinite_tiles(args[2])        # the card's pre-pass
            box.append(ops.flash_attention(*args, causal=False))
    assert c.stats.kernel_calls == {"flash_attention": 1}
    assert c.stats.aten_ops == 0


# -- (e) no staging through pinned memory on fake tensors ---------------------

@pytest.mark.parametrize("fake_world", [8], indirect=True)
def test_fake_tensors_never_reach_the_pinned_staging(fake_world, monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.collectives import (all_gather, all_to_all,
                                              allreduce, send_recv)
    from repro_torch.core.collectives import p2p

    def staged(x):
        raise AssertionError("a fake tensor was staged through host memory")
    monkeypatch.setattr(p2p, "_count", staged)
    with FakeTensorMode():
        x = torch.empty(8, 64)
        assert not p2p.is_staged(x, None)
        assert p2p.to_wire(x, None) is x
        for algo in ("psum", "ring", "tree"):
            assert allreduce(x.clone(), algo).shape == x.shape
        assert all_gather(x).shape == (8, 8, 64)
        assert all_to_all(x, None).shape == x.shape
        assert all_to_all(x, None, "ring").shape == x.shape
        assert send_recv(x, None, 1).shape == x.shape


if __name__ == "__main__":
    if sys.argv[1:2] == ["--reference-comm"]:
        _reference_comm(sys.argv[2])
