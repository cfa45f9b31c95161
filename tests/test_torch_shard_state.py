"""The port's shard layout (``repro_torch.core.shard_state``) against the
reference's (``repro.core.shard_state``), exactly: the nested chunk
lengths, ``chunk_rows`` / ``rows_to_flat`` round trips on ragged lengths
over one and two axes, ``ShardLayout`` built from one plan, its
``shard_rows`` / ``tree_from_rows``, ``reshard`` 8 → 6 → 8 and its errors,
``seg_rows``, ``param_bytes`` and ``opt_bytes_per_worker`` (adam, sgd with
and without momentum); and ``my_rows`` on a world-4 gloo group (4 spawned
processes), row w of ``shard_rows`` on rank w, with ``gather_tree`` giving
every rank the whole tree back."""
from __future__ import annotations

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from tiny_lm import TinyLM as JTinyLM

from repro.core import shard_state as jss
from repro.core.grad_sync import \
    sharded_plan_from_config as jsharded_plan_from_config
from repro.core import SyncConfig as JSyncConfig
from repro_torch.core import SyncConfig, shard_state as ss
from repro_torch.core.grad_sync import sharded_plan_from_config
from repro_torch.launch.dist import init_group, spawn
from repro_torch.optim import make_optimizer

LENGTHS = [1, 2, 7, 8, 9, 63, 64, 65, 1000, 1001]
AXES = [(1,), (4,), (8,), (6,), (2, 2), (2, 3), (4, 2)]


@pytest.mark.parametrize("axis_sizes", AXES, ids=str)
def test_nested_ms_and_chunk_round_trip(axis_sizes):
    for n in LENGTHS:
        assert ss.nested_ms(n, axis_sizes) == jss.nested_ms(n, axis_sizes)
        flat = np.arange(1, n + 1, dtype=np.float32) * 0.5
        rows = ss.chunk_rows(flat, axis_sizes)
        want = np.asarray(jss.chunk_rows(flat, axis_sizes))
        assert rows.dtype == want.dtype and np.array_equal(rows, want)
        assert rows.shape == (int(np.prod(axis_sizes)),
                              ss.nested_ms(n, axis_sizes)[-1])
        back = ss.rows_to_flat(rows, n, axis_sizes)
        assert np.array_equal(back, flat)
        assert np.array_equal(back, np.asarray(
            jss.rows_to_flat(want, n, axis_sizes)))


def _layouts(axis_sizes, **kw):
    jparams = JTinyLM().init(jax.random.PRNGKey(0))
    params = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    cfg = dict(dict(compressor="int8", algo="ring", bucket_bytes=2048), **kw)
    plan = sharded_plan_from_config(SyncConfig(**cfg), params)
    jplan = jsharded_plan_from_config(JSyncConfig(**cfg), jparams)
    return (ss.ShardLayout.from_plan(plan, params, axis_sizes), params,
            jss.ShardLayout.from_plan(jplan, jparams, axis_sizes), jparams)


def _same_geometry(lay, jlay):
    assert lay.axis_sizes == jlay.axis_sizes and lay.world == jlay.world
    assert lay.leaf_shapes == jlay.leaf_shapes
    assert lay.n_leaves == jlay.n_leaves
    assert [dataclasses.asdict(b) for b in lay.buckets] == \
        [dataclasses.asdict(b) for b in jlay.buckets]


@pytest.mark.parametrize("axis_sizes", [(1,), (4,), (8,), (2, 3)], ids=str)
def test_layout_rows_and_tree_match_reference(axis_sizes):
    lay, params, jlay, jparams = _layouts(axis_sizes)
    _same_geometry(lay, jlay)
    rows = lay.shard_rows(params)
    jrows = jlay.shard_rows(jparams)
    assert len(rows) == len(jrows) > 1
    for r, jr in zip(rows, jrows):
        assert np.array_equal(r.numpy(), np.asarray(jr))
    back = lay.tree_from_rows(rows, params)
    jback = jlay.tree_from_rows(jrows, jparams)
    for k in params:
        assert torch.equal(back[k], params[k])
        assert np.array_equal(back[k].numpy(), np.asarray(jback[k]))


def test_reshard_8_6_8_and_its_errors():
    lay, params, jlay, jparams = _layouts((8,))
    rows = lay.shard_rows(params)
    lay6, rows6 = lay.reshard(rows, (6,))
    jlay6, jrows6 = jlay.reshard(jlay.shard_rows(jparams), (6,))
    _same_geometry(lay6, jlay6)
    for r, jr in zip(rows6, jrows6):
        assert np.array_equal(r.numpy(), np.asarray(jr))
    lay8, rows8 = lay6.reshard(rows6, (8,))
    _same_geometry(lay8, lay)
    for a, b in zip(rows8, rows):
        assert torch.equal(a, b)
    back = lay6.tree_from_rows(rows6, params)
    for k in params:
        assert torch.equal(back[k], params[k])
    for bad in [(), (0,), (-2,), (2.5,), (4, 0)]:
        with pytest.raises(ValueError, match="cannot reshard") as e:
            lay.reshard(rows, bad)
        with pytest.raises(ValueError) as je:
            jlay.reshard(jlay.shard_rows(jparams), bad)
        assert str(e.value) == str(je.value)


@pytest.mark.parametrize("axis_sizes", [(1,), (4,), (3,), (2, 2)], ids=str)
def test_seg_rows_and_memory_accounting(axis_sizes):
    lay, params, jlay, _ = _layouts(axis_sizes)
    for j in range(len(lay.buckets)):
        got, want = lay.seg_rows(j), jlay.seg_rows(j)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert lay.param_bytes() == jlay.param_bytes() == \
        4 * sum(int(p.numel()) for p in params.values())
    for name, mom in (("adam", None), ("sgd", None), ("sgd", 1.0),
                      ("sgd", 0.0), ("lamb", None), ("lars", 1.0)):
        for sharded in (False, True):
            assert lay.opt_bytes_per_worker(name, sharded, moments=mom) == \
                jlay.opt_bytes_per_worker(name, sharded, moments=mom)
    # the measured counts: sgd with momentum carries one buffer, without
    # none, adam two
    for opt_name, kw, want in (("sgd", dict(momentum=0.9), 1),
                               ("sgd", {}, 0), ("adam", {}, 2)):
        state = make_optimizer(opt_name, lr=0.1, **kw).init(params)
        count = sum(int(x.numel()) for v in state.values()
                    for x in v.values()) / sum(int(p.numel())
                                               for p in params.values())
        assert count == want
        assert lay.opt_bytes_per_worker(opt_name, True, moments=count) == \
            (want + 1) * 4 * sum(b.m for b in lay.buckets)


def _my_rows_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    from repro_torch.launch.dist import mesh_axes
    torch.set_num_threads(1)
    init_group(torch.device("cpu"), world_size=world, rank=rank,
               store_path=store)
    lay, params, _, _ = _layouts((world,))
    res = {}
    for tag, axes, sizes in (("flat", None, (world,)),
                             ("mesh", tuple(mesh_axes((2, 2))), (2, 2))):
        lay = dataclasses.replace(lay, axis_sizes=sizes, buckets=tuple(
            dataclasses.replace(b, m=ss.nested_ms(b.n, sizes)[-1])
            for b in lay.buckets))
        mine = lay.my_rows(params, axes)
        every = lay.shard_rows(params)
        res[tag] = all(torch.equal(m, e[rank]) for m, e in zip(mine, every))
        back = lay.gather_tree(mine, params, axes)
        res[f"{tag}_gather"] = all(torch.equal(back[k], params[k])
                                   for k in params)
        # rows own their memory: never a view of a parameter
        res[f"{tag}_owned"] = all(
            m.untyped_storage().data_ptr() != p.untyped_storage().data_ptr()
            for m in mine for p in params.values())
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


def test_my_rows_is_this_ranks_row_at_world4(tmp_path):
    spawn(_my_rows_rank, 4, args=(str(tmp_path),), timeout=120)
    for r in range(4):
        res = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert res == {k: True for k in res} and len(res) == 6, (r, res)
