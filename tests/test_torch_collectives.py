"""The port's explicit collectives (``repro_torch.core.collectives``) and its
gradient synchronizer at world 8, against the JAX package's.

  * The reference runs once per module on 8 fake host devices, in a
    subprocess of this file (``XLA_FLAGS=--xla_force_host_platform_device_
    count=8``, as ``tests/multi_device_checks.py`` runs), and writes its
    per-rank outputs to ``.npz`` files.
  * The port runs once per module as a world-8 gloo group: 8 spawned
    processes, rendezvous through a ``FileStore`` under ``tmp_path``, one
    thread each, on the same numpy inputs.  The two run side by side.

Held (every rank's output, each against the reference's same rank):

  * ``check_collectives`` on a (4, 2) mesh ("data", "pod"): ring, tree,
    hierarchical, mesh2d and mesh2d_split BIT-EQUAL; psum within
    rtol 1e-6 (gloo sums in another order than XLA);
  * ring_fused on 8 ranks: all ranks agree bitwise; the result is
    bit-equal to the same schedule composed eagerly from the port's
    ``kernels/ref.py`` (bit-equal to ``repro/kernels/ref.py``); within
    rel 0.05 of the exact sum; and within one int8 step per hop,
    2·(p−1)·s/127 per element with s the largest tile scale of the sum,
    of the jitted reference (XLA rewrites ``s/127`` to ``s·(1/127)``
    under jit, which can flip a code at a hop, ROADMAP.md queue 3);
  * ``reduce_scatter`` and ``all_gather_shards`` on one and two axes with
    the nested chunking (n = 45, not a multiple of 8), ``all_to_all``
    in both variants and ``send_recv`` with shift ±1: bit-equal;
  * ``tree`` on a world that is not a power of two raises ``ValueError``;
  * ``check_grad_sync``'s 8 configurations through
    ``GradientSynchronizer`` (qsgd fed the reference's uniform draws):
    bit-equal for none/ring, topk_fused/ring, topk/ring and
    powersgd/mesh2d (its leaves stay dense).  int8_fused/ring,
    int8/hierarchical and qsgd/ring decode a scale divided by 127 (or by
    the levels), which XLA turns into a reciprocal multiply under jit
    (ROADMAP.md queue 3): they are held within 2 ulp of the largest
    gradient magnitude (measured: at most 0.33), and int8_fused/ring is
    also held bit-equal to the same wire composed eagerly from
    ``repro/kernels/ref.py``.  int8_fused/ring_fused is held within the
    ring_fused bound above of the reference, and bit-equal to the same
    wire composed eagerly on the port's plain versions (EF encode, local
    decode, the composed ring_fused schedule, division by 8).  The two gather wires run again on the (4, 2)
    mesh, where the gathered payloads stack pod-major as the reference's
    nested ``all_gather``s stack them.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
ALGOS = ("psum", "ring", "tree", "hierarchical", "mesh2d", "mesh2d_split",
         "ring_fused")
EXACT = ("ring", "tree", "hierarchical", "mesh2d", "mesh2d_split")
P = 8
RS_N = 45
GRAD_CONFIGS = {   # name: (compressor, algo, compressor_args)
    "none/ring": ("none", "ring", ()),
    "int8/hierarchical": ("int8", "hierarchical", ()),
    "qsgd/ring": ("qsgd", "ring", ()),
    "topk/ring": ("topk", "ring", (("ratio", 0.5),)),
    "powersgd/mesh2d": ("powersgd", "mesh2d", (("rank", 16),)),
    "int8_fused/ring": ("int8_fused", "ring", ()),
    "int8_fused/ring_fused": ("int8_fused", "ring_fused", ()),
    "topk_fused/ring": ("topk_fused", "ring", (("ratio", 0.25),)),
}
GRAD_BIT_EQUAL = ("none/ring", "topk_fused/ring", "topk/ring",
                  "powersgd/mesh2d")
# the gather wires again on the (4, 2) mesh: the payloads are gathered over
# "data", then "pod", so the ranks stack pod-major
GRAD_TWO_AXES = ("int8_fused/ring", "topk/ring")
ULP = 2.0 ** -23


def _inputs():
    """Every input of both sides, made from one seed."""
    rng = np.random.default_rng(0)
    return {
        "x": rng.standard_normal((P, 37)).astype(np.float32),
        "fused": rng.standard_normal((P, 5000)).astype(np.float32),
        "rs": rng.standard_normal((P, RS_N)).astype(np.float32),
        "shards1": rng.standard_normal((P, 6)).astype(np.float32),
        "shards2": rng.standard_normal((P, 6)).astype(np.float32),
        "a2a": rng.standard_normal((P, P, 3)).astype(np.float32),
        "sr": rng.standard_normal((P, 5)).astype(np.float32),
        "w": rng.standard_normal((P, 64, 32)).astype(np.float32),
        "b": rng.standard_normal((P, 33)).astype(np.float32),
    }


# ---------------------------------------------------------------------------
# The reference, on 8 fake devices (this file run as a script)
# ---------------------------------------------------------------------------

def _reference(out_dir: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import repro.compat  # noqa: F401  (shard_map shims on old JAX)
    from jax.sharding import AxisType
    from jax.sharding import PartitionSpec as Ps

    from repro.core import GradientSynchronizer, SyncConfig
    from repro.core.collectives import (all_gather_shards, allreduce,
                                        local_chunk, reduce_scatter,
                                        send_recv)
    from repro.core.collectives.api import all_to_all

    inp = _inputs()
    mesh2 = jax.make_mesh((4, 2), ("data", "pod"),
                          axis_types=(AxisType.Auto,) * 2)
    mesh1 = jax.make_mesh((P,), ("data",), axis_types=(AxisType.Auto,))
    out = {}

    def per_rank(fn, mesh, x, names):
        """fn on each rank's row of x; returns every rank's output."""
        spec = Ps(names if len(names) > 1 else names[0])
        f = jax.shard_map(lambda v: fn(v[0])[None], mesh=mesh,
                          in_specs=spec, out_specs=spec,
                          axis_names=set(names), check_vma=False)
        return np.asarray(jax.jit(f)(x))

    two, one = ("data", "pod"), ("data",)
    for algo in ALGOS:
        out[f"allreduce_{algo}"] = per_rank(
            lambda v, a=algo: allreduce(v, a, two), mesh2, inp["x"], two)
    out["ring_fused8"] = per_rank(
        lambda v: allreduce(v, "ring_fused", one), mesh1, inp["fused"], one)
    for tag, mesh, axes in (("one", mesh1, one), ("two", mesh2, two)):
        for algo in ("psum", "ring"):
            out[f"rs_{tag}_{algo}"] = per_rank(
                lambda v, a=algo, ax=axes: reduce_scatter(v, a, ax), mesh,
                inp["rs"], axes)
            shards = inp["shards1" if tag == "one" else "shards2"]
            out[f"ag_{tag}_{algo}"] = per_rank(
                lambda v, a=algo, ax=axes: all_gather_shards(v, RS_N, a, ax),
                mesh, shards, axes)
    out["local_chunk"] = per_rank(lambda v: local_chunk(v, two), mesh2,
                                  inp["rs"], two)
    for variant in ("direct", "ring"):
        out[f"a2a_{variant}"] = per_rank(
            lambda v, s=variant: all_to_all(v, "data", s), mesh1, inp["a2a"],
            one)
    for shift in (1, -1):
        out[f"sr_{shift}"] = per_rank(
            lambda v, s=shift: send_recv(v, "data", s), mesh1, inp["sr"], one)

    grads = {"w": inp["w"], "b": inp["b"]}
    runs = [(name, cfg, mesh1, one) for name, cfg in GRAD_CONFIGS.items()]
    runs += [(f"{name}@4x2", GRAD_CONFIGS[name], mesh2, two)
             for name in GRAD_TWO_AXES]
    for name, (comp, algo, args), mesh, axes in runs:
        sync = GradientSynchronizer(SyncConfig(compressor=comp, algo=algo,
                                               compressor_args=args), axes)

        def body(g, key, sync=sync):
            g = jax.tree.map(lambda x: x[0], g)
            synced, _ = sync(g, sync.init_state(g), key)
            return jax.tree.map(lambda x: x[None], synced)

        spec = Ps(axes if len(axes) > 1 else axes[0])
        f = jax.shard_map(body, mesh=mesh,
                          in_specs=({"w": spec, "b": spec}, Ps()),
                          out_specs={"w": spec, "b": spec},
                          axis_names=set(axes), check_vma=False)
        res = jax.jit(f)(grads, jax.random.PRNGKey(0))
        for k, v in res.items():
            out[f"grad_{name}_{k}"] = np.asarray(v)
    np.savez(os.path.join(out_dir, "reference.npz"), **out)


def _qsgd_draws() -> np.ndarray:
    """The uniforms the reference's qsgd bucket draws: its one packed
    bucket of 2081 elements, keyed by ``split(PRNGKey(0), 1)[0]``."""
    import jax
    key = jax.random.split(jax.random.PRNGKey(0), 1)[0]
    return np.asarray(jax.random.uniform(key, (64 * 32 + 33,)))


# ---------------------------------------------------------------------------
# The port, on a world-8 gloo group
# ---------------------------------------------------------------------------

def _port_worker(rank: int, store: str, out_dir: str,
                 draws: np.ndarray) -> None:
    import torch
    import torch.distributed as dist

    import repro_torch.core.compression.quantization as quantization
    from repro_torch.core import GradientSynchronizer, SyncConfig
    from repro_torch.core.collectives import (all_gather_shards, all_to_all,
                                              allreduce, local_chunk,
                                              my_chunk_index, reduce_scatter,
                                              send_recv)
    from repro_torch.launch.dist import init_group, mesh_axes

    torch.set_num_threads(1)
    init_group(torch.device("cpu"), world_size=P, rank=rank,
               store_path=store)
    two, one = mesh_axes((4, 2)), mesh_axes((P,))
    inp = _inputs()

    def mine(name):
        return torch.from_numpy(inp[name][rank].copy())

    out = {}
    for algo in ALGOS:
        out[f"allreduce_{algo}"] = allreduce(mine("x"), algo, two).numpy()
    out["ring_fused8"] = allreduce(mine("fused"), "ring_fused", one).numpy()
    for tag, axes in (("one", one), ("two", two)):
        for algo in ("psum", "ring"):
            out[f"rs_{tag}_{algo}"] = reduce_scatter(mine("rs"), algo,
                                                     axes).numpy()
            shards = mine("shards1" if tag == "one" else "shards2")
            out[f"ag_{tag}_{algo}"] = all_gather_shards(shards, RS_N, algo,
                                                        axes).numpy()
    out["local_chunk"] = local_chunk(mine("rs"), two).numpy()
    out["my_chunk_index"] = np.array(my_chunk_index(two))
    for variant in ("direct", "ring"):
        out[f"a2a_{variant}"] = all_to_all(mine("a2a"), one[0],
                                           variant).numpy()
    for shift in (1, -1):
        out[f"sr_{shift}"] = send_recv(mine("sr"), one[0], shift).numpy()

    # the world is 8: a 3-rank group has no tree schedule
    sub = dist.new_group([0, 1, 2])
    if rank < 3:
        try:
            allreduce(mine("x"), "tree", sub)
            out["tree3_raised"] = np.array(0)
        except ValueError:
            out["tree3_raised"] = np.array(1)

    # qsgd draws the reference's uniforms
    quantization.bernoulli = \
        lambda p, rng: torch.from_numpy(draws).reshape(p.shape) < p
    grads = {"w": mine("w"), "b": mine("b")}
    runs = [(name, cfg, one) for name, cfg in GRAD_CONFIGS.items()]
    runs += [(f"{name}@4x2", GRAD_CONFIGS[name], two)
             for name in GRAD_TWO_AXES]
    for name, (comp, algo, args), axes in runs:
        sync = GradientSynchronizer(SyncConfig(compressor=comp, algo=algo,
                                               compressor_args=args), axes)
        synced, _ = sync(grads, sync.init_state(grads), torch.Generator())
        for k, v in synced.items():
            out[f"grad_{name}_{k}"] = v.numpy()
    np.savez(os.path.join(out_dir, f"port-{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs, every rank's port outputs)."""
    import torch.multiprocessing as tmp
    out = tmp_path_factory.mktemp("collectives")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, __file__, "--reference", str(out)],
                           env=env, cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=_port_worker,
                         args=(r, str(out / "store"), str(out),
                               _qsgd_draws()))
             for r in range(P)]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=240)
        log, _ = ref.communicate(timeout=300)
    finally:
        ref.kill()
        for p in procs:
            if p.is_alive():
                p.kill()
    assert ref.returncode == 0, log
    assert [p.exitcode for p in procs] == [0] * P
    want = dict(np.load(out / "reference.npz"))
    got = [dict(np.load(out / f"port-{r}.npz")) for r in range(P)]
    return want, got


def _each_rank(runs, key):
    want, got = runs
    return [(r, g[key], want[key][r]) for r, g in enumerate(got)]


@pytest.mark.parametrize("algo", EXACT)
def test_explicit_schedules_bit_equal_on_4x2_mesh(runs, algo):
    for r, got, want in _each_rank(runs, f"allreduce_{algo}"):
        np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")


def test_psum_on_4x2_mesh(runs):
    for r, got, want in _each_rank(runs, "allreduce_psum"):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                   err_msg=f"rank {r}")


def _ring_fused_composed(xs: np.ndarray, tile: int = 1024,
                         streams: int = 2) -> np.ndarray:
    """The ring_fused schedule for all p ranks in one process, on the
    port's plain versions; returns rank 0's result (every rank decodes
    the same payloads)."""
    import torch

    from repro_torch.kernels import ref
    p, n = xs.shape
    bounds = [round(n * i / streams) for i in range(streams + 1)]
    out = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        m = -(-(hi - lo) // p)
        acc = np.zeros((p, p * m), np.float32)
        acc[:, :hi - lo] = xs[:, lo:hi]
        acc = torch.from_numpy(acc).view(p, p, m)      # rank, chunk, elem
        for s in range(p - 1):
            sends = [ref.quantize_tiles_ref(acc[r, (r - s) % p], tile=tile)
                     for r in range(p)]
            for r in range(p):
                q, sc = sends[(r - 1) % p]
                acc[r, (r - s - 1) % p] += ref.dequantize_ref(q, sc,
                                                              tile=tile)
        # chunk c is completed by rank (c-1) % p, which quantizes it once
        full = torch.cat([ref.dequantize_ref(
            *ref.quantize_tiles_ref(acc[(c - 1) % p, c], tile=tile),
            tile=tile) for c in range(p)])
        out.append(full[:hi - lo].numpy())
    return np.concatenate(out)


def _one_step_per_hop(exact: np.ndarray, p: int, tile: int = 1024) -> float:
    """2·(p−1)·s/127 with s the largest tile scale of the exact sum."""
    return 2 * (p - 1) * float(np.abs(exact).max()) / 127 * (1 + 1e-6)


def test_ring_fused_ranks_agree_bitwise(runs):
    _, got = runs
    for r in range(1, P):
        np.testing.assert_array_equal(got[r]["ring_fused8"],
                                      got[0]["ring_fused8"])


def test_ring_fused_bit_equal_to_eager_composition(runs):
    _, got = runs
    want = _ring_fused_composed(_inputs()["fused"])
    np.testing.assert_array_equal(got[0]["ring_fused8"], want)


def test_ring_fused_within_five_percent_of_exact_sum(runs):
    _, got = runs
    exact = _inputs()["fused"].sum(0)
    rel = np.abs(got[0]["ring_fused8"] - exact).max() / np.abs(exact).max()
    assert rel < 0.05, rel


def test_ring_fused_within_one_step_per_hop_of_jitted_reference(runs):
    want, got = runs
    exact = _inputs()["fused"].sum(0)
    d = np.abs(got[0]["ring_fused8"] - want["ring_fused8"][0]).max()
    assert d <= _one_step_per_hop(exact, P), d


@pytest.mark.parametrize("mesh", ["one", "two"])
@pytest.mark.parametrize("algo", ["psum", "ring"])
@pytest.mark.parametrize("edge", ["rs", "ag"])
def test_sharded_edges_bit_equal(runs, edge, algo, mesh):
    for r, got, want in _each_rank(runs, f"{edge}_{mesh}_{algo}"):
        assert got.shape == want.shape
        if algo == "psum" and edge == "rs":
            # gloo's all-reduce sums in another order than XLA's psum
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                       err_msg=f"rank {r}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")


def test_local_chunk_and_chunk_index_on_4x2_mesh(runs):
    # rank (d, p) of the (4, 2) mesh owns chunk d*2 + p of the nested
    # chunking, as the reference's local_chunk slices it
    for r, got, want in _each_rank(runs, "local_chunk"):
        np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")
    assert [int(g["my_chunk_index"]) for g in runs[1]] == list(range(P))


@pytest.mark.parametrize("sizes", [(8,), (4, 2), (2, 2, 2), (3,)])
@pytest.mark.parametrize("n", [1, 45, 64])
def test_nested_chunking_matches_reference(n, sizes):
    import jax.numpy as jnp
    import torch

    from repro.core.collectives import nested_shard_len as jlen
    from repro.core.collectives import pad_to_chunks as jpad
    from repro_torch.core.collectives import nested_shard_len, pad_to_chunks
    x = np.arange(1, n + 1, dtype=np.float32)
    assert nested_shard_len(n, sizes) == jlen(n, sizes)
    np.testing.assert_array_equal(
        pad_to_chunks(torch.from_numpy(x), sizes).numpy(),
        np.asarray(jpad(jnp.asarray(x), sizes)))


@pytest.mark.parametrize("variant", ["direct", "ring"])
def test_all_to_all_bit_equal(runs, variant):
    for r, got, want in _each_rank(runs, f"a2a_{variant}"):
        np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")


@pytest.mark.parametrize("shift", [1, -1])
def test_send_recv_bit_equal(runs, shift):
    for r, got, want in _each_rank(runs, f"sr_{shift}"):
        np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")
    edge = 0 if shift == 1 else P - 1
    assert not runs[1][edge][f"sr_{shift}"].any()


def test_tree_on_non_power_of_two_world_raises(runs):
    _, got = runs
    assert [int(got[r]["tree3_raised"]) for r in range(3)] == [1, 1, 1]


@pytest.mark.parametrize("name", list(GRAD_CONFIGS))
def test_grad_sync_world8_matches_reference(runs, name):
    inp = _inputs()
    g_max = max(np.abs(inp["w"]).max(), np.abs(inp["b"]).max())
    for k in ("w", "b"):
        for r, got, want in _each_rank(runs, f"grad_{name}_{k}"):
            assert got.shape == want.shape and got.dtype == np.float32
            if name in GRAD_BIT_EQUAL:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{k} rank {r}")
            elif name == "int8_fused/ring_fused":
                # the mean of the ring_fused sum of the decoded payloads
                exact = inp[k].sum(0)
                assert np.abs(got - want).max() <= \
                    _one_step_per_hop(exact, P) / P
            else:
                assert np.abs(got - want).max() <= 2 * ULP * g_max, \
                    f"{k} rank {r}"


@pytest.mark.parametrize("name", ["int8_fused/ring@4x2", "topk/ring@4x2"])
def test_grad_sync_gather_wire_on_two_axes_matches_reference(runs, name):
    inp = _inputs()
    g_max = max(np.abs(inp["w"]).max(), np.abs(inp["b"]).max())
    for k in ("w", "b"):
        for r, got, want in _each_rank(runs, f"grad_{name}_{k}"):
            if name.startswith("topk"):
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{k} rank {r}")
            else:
                assert np.abs(got - want).max() <= 2 * ULP * g_max


# (mesh, the ranks in the order the gather stacks them)
GATHER_ORDERS = {"": list(range(P)),
                 "@4x2": [d * 2 + p for p in range(2) for d in range(4)]}


@pytest.mark.parametrize("mesh", list(GATHER_ORDERS), ids=["8", "4x2"])
def test_int8_fused_gather_wire_bit_equal_to_eager_reference(runs, mesh):
    """Every rank's EF encode (``quantize_ef_ref``), the payloads stacked
    in the reference's gather order and decoded by ``dequant_accum_ref``,
    divided by 8: the int8_fused wire of ``repro/kernels/ref.py`` run
    eagerly, on the one packed bucket (leaves in backward order: w, then
    b).  The order decides the bits of the sum."""
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    inp = _inputs()
    bufs = [np.concatenate([inp["w"][r].reshape(-1), inp["b"][r]])
            for r in GATHER_ORDERS[mesh]]
    enc = [jref.quantize_ef_ref(jnp.asarray(b), jnp.zeros(b.shape))
           for b in bufs]
    total = np.asarray(jref.dequant_accum_ref(
        jnp.stack([e[0] for e in enc]), jnp.stack([e[2] for e in enc]))
        / 8.0)
    _, got = runs
    for r in range(P):
        np.testing.assert_array_equal(
            got[r][f"grad_int8_fused/ring{mesh}_w"].reshape(-1),
            total[:64 * 32])
        np.testing.assert_array_equal(
            got[r][f"grad_int8_fused/ring{mesh}_b"], total[64 * 32:])


def test_int8_fused_ring_fused_bit_equal_to_eager_composition(runs):
    """Every rank's EF encode (``quantize_ef_ref``) decoded locally
    (``dequantize_ref``), the decoded buffers summed by the ring_fused
    schedule composed eagerly (``_ring_fused_composed``) and divided by
    8: the int8_fused wire on ring_fused, on the port's plain versions,
    for the one packed bucket (w, then b).  The wire is deterministic, so
    every rank must match it bit for bit."""
    import torch

    from repro_torch.kernels import ref
    inp = _inputs()
    decoded = []
    for r in range(P):
        buf = torch.from_numpy(np.concatenate([inp["w"][r].reshape(-1),
                                               inp["b"][r]]))
        q, _, sc = ref.quantize_ef_ref(buf, torch.zeros_like(buf))
        decoded.append(ref.dequantize_ref(q, sc).numpy())
    total = _ring_fused_composed(np.stack(decoded)) / np.float32(P)
    assert total.dtype == np.float32
    _, got = runs
    for r in range(P):
        np.testing.assert_array_equal(
            got[r]["grad_int8_fused/ring_fused_w"].reshape(-1),
            total[:64 * 32], err_msg=f"rank {r}")
        np.testing.assert_array_equal(
            got[r]["grad_int8_fused/ring_fused_b"], total[64 * 32:],
            err_msg=f"rank {r}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--reference"]:
        _reference(sys.argv[2])
