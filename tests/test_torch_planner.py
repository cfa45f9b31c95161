"""The port's communication planner (``repro_torch.core.schedule``,
``core/parallelism.py``, ``core/pipeline.py``) against the JAX package's.

The port COPIES these pure-Python modules (any ``repro.*`` import runs
``repro/compat.py``, which imports jax), so each copy is pinned to its
original here, on the same seeded inputs:

  * the cost model, the topology, the overlap model, the pipeline schedule
    arithmetic and ``ParallelismSpec``: every number within rel 1e-12 of
    the LIVE reference function (not of ``tests/test_topology.py``'s ``==``
    pins, which miss in the last ulp on this tree), every structure equal;
  * the planner's DECISIONS exactly: ``plan``, ``plan_rounds``,
    ``serial_round_plan``, ``fixed_config_plan`` and ``plan_serving`` give
    the same winner, the same arm keys and the same buckets (leaves,
    algo, compressor, its args, bytes, pack) on seeded leaf-size profiles
    and on TinyLM's and reduced gemma-2b's real leaves, over the flat link
    presets, the three ``TOPOLOGY_PRESETS``, the two world-4 topologies of
    the card runs, and with a ``CompressionCostTable`` round-tripped through
    JSON (written by one package, read by the other); their modeled times
    within rel 1e-12;
  * ``payload_bits`` and ``aggregatable`` of every compressor the planner
    may pick, on the port's compressors (``cost.py`` takes them from
    there).
"""
from __future__ import annotations

import dataclasses
import functools
import json

import jax
import numpy as np
import pytest
from tiny_lm import TinyLM as JTinyLM

import repro.core.parallelism as j_par
import repro.core.pipeline as j_pipe
import repro.core.schedule.cost as j_cost
import repro.core.schedule.perf_model as j_perf
import repro.core.schedule.planner as j_plan
import repro.core.schedule.topology as j_topo
import repro_torch.core.parallelism as p_par
import repro_torch.core.pipeline as p_pipe
import repro_torch.core.schedule.cost as p_cost
import repro_torch.core.schedule.perf_model as p_perf
import repro_torch.core.schedule.planner as p_plan
import repro_torch.core.schedule.topology as p_topo
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.compression import get_compressor as jget_compressor
from repro.models import Model as JModel
from repro_torch.configs import get_config, reduced
from repro_torch.core.compression import REGISTRY, get_compressor
from repro_torch.models import Model

REL = 1e-12
SIDES = ((j_cost, j_topo), (p_cost, p_topo))

# (name, spec): a spec names a Topology; "flat:<preset>:<world>" a bare
# LinkParams at that world
NETS = [
    ("fast_ici@8", "flat:fast_ici:8"),
    ("datacenter@16", "flat:datacenter:16"),
    ("commodity@32", "flat:commodity:32"),
    ("commodity@4", "flat:commodity:4"),
    ("two_tier_pod", "two_tier_pod"),
    ("multi_pod", "multi_pod"),
    ("commodity_cluster", "commodity_cluster"),
    ("device4", "device:4@fast_ici"),
    ("node2xdevice2", "node:2@commodity,device:2@fast_ici"),
    ("one_tier_datacenter", "node:8@datacenter"),
]


def _net(side, spec: str):
    """(net, world) built from one package's own classes."""
    cost, topo = side
    if spec.startswith("flat:"):
        _, preset, world = spec.split(":")
        return cost.LINK_PRESETS[preset], int(world)
    t = topo.Topology.from_spec(spec)
    return t, t.world


def _close(a, b, what=""):
    assert a == pytest.approx(b, rel=REL, abs=0), what


def _seeded_sizes(seed: int, n: int = 14):
    rng = np.random.default_rng(seed)
    # f32 leaf bytes from a few hundred bytes to tens of MiB
    return [float(int(4 * 10 ** rng.uniform(1.5, 7.2))) for _ in range(n)]


# ---------------------------------------------------------------------------
# The copied modules, number by number
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,spec", NETS, ids=[n for n, _ in NETS])
def test_topology_matches_reference(name, spec):
    (jn, jw), (pn, pw) = _net(SIDES[0], spec), _net(SIDES[1], spec)
    assert jw == pw
    jt, pt = j_topo.as_topology(jn, jw), p_topo.as_topology(pn, pw)
    for attr in ("world", "n_tiers", "is_flat", "inner_size", "all_pow2"):
        assert getattr(jt, attr) == getattr(pt, attr), attr
    assert jt.spec() == pt.spec()
    for a, b in zip(jt.tiers, pt.tiers, strict=True):
        assert (a.name, a.size, a.link_name) == (b.name, b.size, b.link_name)
        assert (a.link.alpha_s, a.link.beta_s_per_byte) == \
            (b.link.alpha_s, b.link.beta_s_per_byte)
    for m in (0.0, 1e3, 1e6, 3e8):
        assert jt.bottleneck(m).name == pt.bottleneck(m).name
    for ti, tier in enumerate(jt.tiers):
        for size in (1, 2, 4, 8, 3):
            if tier.size % size:
                with pytest.raises(ValueError):
                    pt.place(size, ti)
                continue
            (ja, jr), (pa, pr) = jt.place(size, ti), pt.place(size, ti)
            assert (ja.name, ja.size) == (pa.name, pa.size)
            assert jr.spec() == pr.spec()


def test_topology_specs_and_errors_match_reference():
    for spec in ("node:4@datacenter,device:8@fast_ici", "a:2@commodity",
                 "pod:2@datacenter,chip:256@fast_ici", "x:3@fast_ici"):
        assert j_topo.Topology.from_spec(spec).spec() == \
            p_topo.Topology.from_spec(spec).spec()
    assert j_topo.TOPOLOGY_PRESETS == p_topo.TOPOLOGY_PRESETS
    for bad in ("node:4", "node:x@fast_ici", "node:4@nowhere", ""):
        with pytest.raises(Exception) as je:
            j_topo.Topology.from_spec(bad)
        with pytest.raises(je.type):
            p_topo.Topology.from_spec(bad)
    with pytest.raises(ValueError):
        p_topo.as_topology(p_topo.Topology.from_spec("device:4@fast_ici"), 8)


# ring_fused is priced per bucket only (bucket_sync_phases, below)
ALGOS = ("psum", "ring", "tree", "hierarchical", "mesh2d", "mesh2d_split")


@pytest.mark.parametrize("name,spec", NETS, ids=[n for n, _ in NETS])
def test_cost_model_matches_reference(name, spec):
    (jn, world), (pn, _) = _net(SIDES[0], spec), _net(SIDES[1], spec)
    rng = np.random.default_rng(len(name))
    sizes = [float(x) for x in 10 ** rng.uniform(2, 9, 6)]
    jt = j_topo.as_topology(jn, world)
    for n in sizes:
        for algo in ALGOS:
            if algo in ("mesh2d", "mesh2d_split") and jt.n_tiers > 2:
                continue
            _close(j_cost.allreduce_cost_s(algo, n, world, jn),
                   p_cost.allreduce_cost_s(algo, n, world, pn), algo)
            jp = j_cost.allreduce_phases(algo, n, world, jn)
            pp = p_cost.allreduce_phases(algo, n, world, pn)
            assert [t for t, _ in jp] == [t for t, _ in pp]
            for (_, a), (_, b) in zip(jp, pp):
                _close(a, b, algo)
            _close(j_cost.reduce_scatter_cost_s(algo, n, world, jn),
                   p_cost.reduce_scatter_cost_s(algo, n, world, pn), algo)
            _close(j_cost.shard_gather_cost_s(algo, n, world, jn),
                   p_cost.shard_gather_cost_s(algo, n, world, pn), algo)
        _close(j_cost.allgather_cost_s(n, world, jn),
               p_cost.allgather_cost_s(n, world, pn))
        _close(j_cost.p2p_cost_s(n, jn), p_cost.p2p_cost_s(n, pn))
        for variant in ("direct", "ring"):
            _close(j_cost.all_to_all_cost_s(n, world, jn, variant),
                   p_cost.all_to_all_cost_s(n, world, pn, variant))
        for tp in (1, 2, 4):
            # a tp group prices its allreduces on one tier's link
            jl = jt.innermost.link if tp > 1 else jn
            pl = p_topo.as_topology(pn, world).innermost.link if tp > 1 \
                else pn
            _close(j_cost.decode_step_cost_s(n, 18, 2048, 8, tp, jl),
                   p_cost.decode_step_cost_s(n, 18, 2048, 8, tp, pl))
    for mod, net in ((j_cost, jn), (p_cost, pn)):
        with pytest.raises(ValueError):
            mod.allreduce_phases("ring_fused", 1e6, world, net)
    for skew, rps in ((0.0, 1.0), (0.013, 1.0), (0.2, 0.25)):
        _close(j_cost.straggler_penalty_s(skew, rps),
               p_cost.straggler_penalty_s(skew, rps))


def _candidates(mod):
    return list(mod.DEFAULT_CANDIDATES) + [
        mod.Candidate("int8_fused", (), "tree"),
        mod.Candidate("topk_fused", (("ratio", 0.01),), "hierarchical")]


def _cost_tables():
    """A measured-cost table as the reference writes it (JSON), read by the
    port, and the port's own write read back by the reference."""
    rng = np.random.default_rng(7)
    entries = tuple((f"{c}/{s}", float(10 ** rng.uniform(9, 11)),
                     float(10 ** rng.uniform(-6, -4)))
                    for c in ("int8", "topk", "int8_fused", "topk_fused",
                              "qsgd", "sign")
                    for s in ("encode", "decode"))
    quality = tuple((k, 1e-6, 0.99, False) for k, _, _ in entries[:3])
    jt = j_cost.CompressionCostTable(entries=entries, cal_world=8,
                                     quality=quality)
    pt = p_cost.CompressionCostTable.from_json(
        json.loads(json.dumps(jt.to_json())))
    assert pt == p_cost.CompressionCostTable(entries=entries, cal_world=8,
                                             quality=quality)
    assert j_cost.CompressionCostTable.from_json(
        json.loads(json.dumps(pt.to_json()))) == jt
    return jt, pt


def test_cost_table_file_round_trip(tmp_path):
    jt, pt = _cost_tables()
    path = str(tmp_path / "costs.json")
    jt.save(path)
    assert p_cost.resolve_cost_table(path) == pt
    assert p_cost.resolve_cost_table(pt) is pt
    assert p_cost.resolve_cost_table(None) is None
    pt.save(path)
    assert j_cost.CompressionCostTable.load(path) == jt


@pytest.mark.parametrize("with_table", [False, True],
                         ids=["analytic", "cost_table"])
@pytest.mark.parametrize("name,spec", NETS, ids=[n for n, _ in NETS])
def test_bucket_costs_match_reference(name, spec, with_table):
    (jn, world), (pn, _) = _net(SIDES[0], spec), _net(SIDES[1], spec)
    jtab, ptab = _cost_tables() if with_table else (None, None)
    jt = j_topo.as_topology(jn, world)
    for jc, pc in zip(_candidates(j_plan), _candidates(p_plan)):
        if not j_plan._algo_usable(jc.algo, world, jn):
            continue
        assert p_plan._algo_usable(pc.algo, world, pn)
        for n in (2048.0, 65536.0, 3.1e6, 2.2e8):
            for shard in (False, True):
                a = j_cost.bucket_sync_cost_s(
                    jc.compressor, jc.compressor_args, jc.algo, n, world,
                    jn, shard_state=shard, cost_table=jtab)
                b = p_cost.bucket_sync_cost_s(
                    pc.compressor, pc.compressor_args, pc.algo, n, world,
                    pn, shard_state=shard, cost_table=ptab)
                _close(a, b, (jc.key, n, shard))
                jp = j_cost.bucket_sync_phases(
                    jc.compressor, jc.compressor_args, jc.algo, n, world,
                    jn, shard_state=shard, cost_table=jtab)
                pp = p_cost.bucket_sync_phases(
                    pc.compressor, pc.compressor_args, pc.algo, n, world,
                    pn, shard_state=shard, cost_table=ptab)
                assert [t for t, _ in jp] == [t for t, _ in pp]
                for (_, x), (_, y) in zip(jp, pp):
                    _close(x, y, (jc.key, n, shard))
    assert jt.world == world


def test_overlap_model_matches_reference():
    rng = np.random.default_rng(11)
    for trial in range(4):
        n = 3 + 4 * trial
        tb = rng.uniform(1e-4, 5e-3, n)
        gb = 10 ** rng.uniform(3, 8, n)
        jl = [j_perf.LayerProfile(float(a), float(b)) for a, b in zip(tb, gb)]
        pl = [p_perf.LayerProfile(float(a), float(b)) for a, b in zip(tb, gb)]
        for alpha, beta in ((1e-6, 1 / 50e9), (5e-5, 1 / 1.25e9)):
            _close(j_perf.comm_time(1e6, alpha, beta),
                   p_perf.comm_time(1e6, alpha, beta))
            for fn in ("iteration_time_fifo", "iteration_time_wfbp",
                       "iteration_time_tic", "iteration_time_tac"):
                _close(getattr(j_perf, fn)(jl, alpha, beta),
                       getattr(p_perf, fn)(pl, alpha, beta), fn)
            for bb in (0.0, 1e6, 3.2e7):
                _close(j_perf.iteration_time_mg_wfbp(jl, alpha, beta, bb),
                       p_perf.iteration_time_mg_wfbp(pl, alpha, beta, bb))
            for sb in (1e5, 4e6):
                _close(j_perf.iteration_time_p3(jl, alpha, beta, sb),
                       p_perf.iteration_time_p3(pl, alpha, beta, sb))
            assert j_perf.wfbp_case(jl, alpha, beta) == \
                p_perf.wfbp_case(pl, alpha, beta)


def test_pipeline_arithmetic_matches_reference():
    rng = np.random.default_rng(5)
    for S in (1, 2, 3, 4, 8):
        for M in (1, 4, 7, 32):
            _close(j_pipe.bubble_fraction(S, M), p_pipe.bubble_fraction(S, M))
            assert j_pipe.schedule_1f1b(S, M) == p_pipe.schedule_1f1b(S, M)
            assert j_pipe.aligned_ticks(S, M) == p_pipe.aligned_ticks(S, M)
            assert j_pipe.aligned_order(S, M) == p_pipe.aligned_order(S, M)
            tf, tb, ts = (float(x) for x in rng.uniform(1e-4, 1e-2, 3))
            _close(j_pipe.simulate_1f1b(S, M, tf, tb, ts),
                   p_pipe.simulate_1f1b(S, M, tf, tb, ts))
        costs = [float(x) for x in 10 ** rng.uniform(3, 8, 11)]
        assert j_pipe.balanced_cuts(costs, S) == \
            p_pipe.balanced_cuts(costs, S)
        cuts = j_pipe.balanced_cuts(costs, S)
        for a, b in zip(j_pipe.stage_costs(costs, cuts),
                        p_pipe.stage_costs(costs, cuts), strict=True):
            _close(a, b)
        for a, b in zip(j_pipe.stage_param_bytes(costs, S),
                        p_pipe.stage_param_bytes(costs, S), strict=True):
            _close(a, b)
    assert j_pipe.PIPE_FWD_FRACTION == p_pipe.PIPE_FWD_FRACTION
    with pytest.raises(ValueError):
        p_pipe.balanced_cuts([1.0, 2.0], 3)
    with pytest.raises(ValueError):
        p_pipe.bubble_fraction(2, 0)


SPECS = ["dp=4,tp=2@fast_ici,pp=2@node,micro=8", "ep=2@device,shard",
         "tp=8@device", "pp=4,micro=16", "shard", "", "dp=2", "tp=2,ep=2"]


@pytest.mark.parametrize("spec", SPECS, ids=[s or "trivial" for s in SPECS])
def test_parallelism_spec_matches_reference(spec):
    js, ps = j_par.ParallelismSpec.from_spec(spec), \
        p_par.ParallelismSpec.from_spec(spec)
    assert dataclasses.asdict(js) == dataclasses.asdict(ps)
    for attr in ("is_trivial", "model_world"):
        assert getattr(js, attr) == getattr(ps, attr), attr
    assert js.spec() == ps.spec() and js.describe() == ps.describe()
    assert js.to_record() == ps.to_record()
    assert p_par.ParallelismSpec.from_record(ps.to_record()) == \
        p_par.ParallelismSpec.coerce(ps.spec())
    for net in (8, 16, "node:4@datacenter,device:8@fast_ici",
                "node:2@commodity,device:2@fast_ici"):
        jnet = j_topo.Topology.from_spec(net) if isinstance(net, str) \
            else net
        pnet = p_topo.Topology.from_spec(net) if isinstance(net, str) \
            else net
        try:
            want = dataclasses.asdict(js.resolve(jnet))
        except ValueError:
            with pytest.raises(ValueError):
                ps.resolve(pnet)
            continue
        assert dataclasses.asdict(ps.resolve(pnet)) == want


def test_parallelism_legacy_coerce_and_errors_match_reference():
    for kw in (dict(), dict(shard_state=True), dict(pipeline_stages=4,
                                                    micro_batches=8),
               dict(pipeline_stages=2, micro_batches=1, pipe_tier="node")):
        assert dataclasses.asdict(j_par.ParallelismSpec.legacy(**kw)) == \
            dataclasses.asdict(p_par.ParallelismSpec.legacy(**kw))
    assert p_par.ParallelismSpec.coerce(None) == p_par.ParallelismSpec()
    for bad in ("tp=0", "dp=4,dp=2", "zz=2", "tp=x", "micro=-1"):
        try:
            j_par.ParallelismSpec.from_spec(bad)
        except Exception as e:        # the reference's own error type
            with pytest.raises(type(e)):
                p_par.ParallelismSpec.from_spec(bad)
        else:
            assert dataclasses.asdict(
                j_par.ParallelismSpec.from_spec(bad)) == dataclasses.asdict(
                p_par.ParallelismSpec.from_spec(bad))


# ---------------------------------------------------------------------------
# payload_bits / aggregatable
# ---------------------------------------------------------------------------

COMPRESSOR_ARGS = {"topk": (("ratio", 0.01),), "qsgd": (("levels", 127),),
                   "topk_fused": (("ratio", 0.01),), "randomk":
                   (("ratio", 0.05),), "threshold": (("tau", 0.01),),
                   "powersgd": (("rank", 4),)}


def test_payload_bits_match_reference_for_every_candidate():
    names = sorted({c.compressor for c in p_plan.DEFAULT_CANDIDATES}
                   | set(REGISTRY))
    assert {c.compressor for c in p_plan.DEFAULT_CANDIDATES} <= set(names)
    for name in names:
        kw = dict(COMPRESSOR_ARGS.get(name, ()))
        pc, jc = get_compressor(name, **kw), jget_compressor(name, **kw)
        assert pc.aggregatable == jc.aggregatable, name
        for shape in ((1,), (1000,), (1024,), (1025,), (65536,),
                      (524288000,), (64, 33), (256, 2048)):
            assert pc.payload_bits(shape) == jc.payload_bits(shape), \
                (name, shape)
    for c in p_plan.DEFAULT_CANDIDATES:
        for n in (7, 4096, 10 ** 7):
            assert p_cost.compressed_wire_bytes(
                c.compressor, c.compressor_args, n) == \
                j_cost.compressed_wire_bytes(c.compressor,
                                             c.compressor_args, n)


# ---------------------------------------------------------------------------
# Planner decisions
# ---------------------------------------------------------------------------

def _bucket_key(b):
    return (tuple(b.leaves), b.algo, b.compressor, tuple(b.compressor_args),
            int(b.bucket_bytes), b.pack, b.fused, b.error_feedback)


def _assert_same_comm(jc, pc, what=""):
    assert [_bucket_key(b) for b in jc.buckets] == \
        [_bucket_key(b) for b in pc.buckets], what
    assert (jc.world, jc.mean, jc.shard_state) == \
        (pc.world, pc.mean, pc.shard_state), what
    if jc.modeled_step_s == jc.modeled_step_s:
        _close(jc.modeled_step_s, pc.modeled_step_s, what)


def _assert_same_arm(ja, pa, what=""):
    assert ja.key == pa.key, what
    assert ja.schedule == j_plan.RoundSchedule(**dataclasses.asdict(
        pa.schedule)), what
    for f in ("pipeline_stages", "micro_batches", "pipe_tier", "tp",
              "tp_tier", "ep", "ep_tier", "shard_state"):
        assert getattr(ja, f) == getattr(pa, f), (what, f)
    for f in ("modeled_step_s", "round_cost_s", "t_backward_s", "bubble",
              "pipe_p2p_s", "model_comm_s", "opt_mem_bytes"):
        a, b = getattr(ja, f), getattr(pa, f)
        if a != a:
            assert b != b, (what, f)
        else:
            _close(a, b, (what, f))
    assert ja.parallelism.to_record() == pa.parallelism.to_record()
    _assert_same_comm(ja.comm, pa.comm, what)


def assert_same_rounds(jres, pres, what=""):
    """``plan_rounds``'s (best, arms): the same winner and arms.  A winner
    that differs only through a tie within rel 1e-12 is reported as such."""
    (jb, jarms), (pb, parms) = jres, pres
    assert sorted(jarms) == sorted(parms), what
    for k in jarms:
        _assert_same_arm(jarms[k], parms[k], (what, k))
    if jb.key != pb.key:
        tie = jb.modeled_step_s == pytest.approx(pb.modeled_step_s,
                                                 rel=REL)
        raise AssertionError(f"{what}: winner {jb.key} vs {pb.key}"
                             + (" (a tie within rel 1e-12)" if tie else ""))
    _assert_same_arm(jb, pb, what)


@functools.lru_cache(maxsize=None)
def _leaf_sizes():
    """name -> f32 leaf bytes in tree order: seeded profiles, TinyLM's
    leaves and reduced gemma-2b's (from each package's own tree)."""
    jtiny = JTinyLM(vocab=512, d=96).init(jax.random.PRNGKey(0))
    jgemma = jax.eval_shape(JModel(jreduced(jget_config("gemma-2b"))).init,
                            jax.random.PRNGKey(0))
    pgemma = Model(reduced(get_config("gemma-2b"))).param_desc()
    j_sizes = [int(np.prod(x.shape)) * 4 for x in jax.tree.leaves(jgemma)]
    p_sizes = [p.grad_bytes for p in p_plan.profiles_from_grads(pgemma, 1.0)]
    assert p_sizes == j_sizes          # the port's leaf order is the tree's
    return {"seeded0": _seeded_sizes(0), "seeded1": _seeded_sizes(1, 40),
            "tinylm": [int(np.prod(x.shape)) * 4
                       for x in jax.tree.leaves(jtiny)],
            "gemma2b_reduced": j_sizes}


LEAF_SETS = ("gemma2b_reduced", "seeded0", "seeded1", "tinylm")
PLAN_NETS = [n for n in NETS if n[0] not in ("multi_pod",)]


def _profiles(sizes, t_bwd):
    return (j_plan.profiles_from_sizes(sizes, t_bwd),
            p_plan.profiles_from_sizes(sizes, t_bwd))


@pytest.mark.parametrize("leaves", LEAF_SETS)
@pytest.mark.parametrize("name,spec", PLAN_NETS,
                         ids=[n for n, _ in PLAN_NETS])
def test_plan_and_round_plan_decisions_match_reference(leaves, name, spec):
    (jn, world), (pn, _) = _net(SIDES[0], spec), _net(SIDES[1], spec)
    for t_bwd in (1e-3, 0.05):
        jp, pp = _profiles(_leaf_sizes()[leaves], t_bwd)
        _assert_same_comm(j_plan.plan(jp, jn, world),
                          p_plan.plan(pp, pn, world), ("plan", t_bwd))
        _assert_same_comm(j_plan.serial_round_plan(jp, jn, world),
                          p_plan.serial_round_plan(pp, pn, world),
                          ("serial_round_plan", t_bwd))
        _close(j_plan.plan_cost_s(j_plan.plan(jp, jn, world), jp, jn, world),
               p_plan.plan_cost_s(p_plan.plan(pp, pn, world), pp, pn, world))
        for comp, algo, cargs in j_plan.FIXED_BASELINES.values():
            for bb in (0, 2**20, 32 * 2**20):
                _assert_same_comm(
                    j_plan.fixed_config_plan(jp, jn, world, comp, algo,
                                             compressor_args=cargs,
                                             bucket_bytes=bb),
                    p_plan.fixed_config_plan(pp, pn, world, comp, algo,
                                             compressor_args=cargs,
                                             bucket_bytes=bb),
                    ("fixed", comp, algo, bb))
    assert j_plan.FIXED_BASELINES == p_plan.FIXED_BASELINES


def _axes(mod, tokens, d_model, layers):
    return dict(pipeline=mod.PipelineAxis(tokens, d_model * 4.0),
                tensor=mod.TensorAxis(tokens, d_model * 4.0, layers),
                expert=mod.ExpertAxis(tokens, 2 * d_model * 4.0, layers,
                                      expert_fraction=0.6))


ROUNDS = [  # (leaves, net, t_bwd, optimizer, extra plan_rounds kwargs)
    ("gemma2b_reduced", "commodity_cluster", 0.01, "adam", {}),
    ("gemma2b_reduced", "commodity_cluster", 0.05, "adam", {}),
    ("gemma2b_reduced", "two_tier_pod", 0.01, "adam", {}),
    ("gemma2b_reduced", "device:4@fast_ici", 1e-3, "sgd", {}),
    ("gemma2b_reduced", "node:2@commodity,device:2@fast_ici", 0.01, "sgd",
     {}),
    ("gemma2b_reduced", "node:2@commodity,device:2@fast_ici", 1e-3, "sgd",
     {"tau_grid": (1,)}),                       # a pipeline winner
    ("gemma2b_reduced", "node:16@datacenter", 0.01, "adam",
     {"memory_budget_bytes": 0.2}),     # x the model's f32 bytes
    ("seeded1", "flat:commodity:32", 0.02, "adam", {}),
    ("seeded0", "flat:datacenter:16", 0.002, "sgd",
     {"shard_grid": (True,)}),
    ("seeded0", "node:8@datacenter", 0.002, "adam",
     {"parallelism": "tp=2"}),
    ("tinylm", "flat:fast_ici:8", 1e-4, "adam", {"straggler_s": 0.003}),
    ("tinylm", "node:2@commodity,device:2@fast_ici", 1e-4, "adam",
     {"cost_table": True}),
]


@pytest.mark.parametrize("leaves,spec,t_bwd,opt,extra", ROUNDS,
                         ids=[f"{r[0]}-{r[1]}-{r[2]}-{i}"
                              for i, r in enumerate(ROUNDS)])
def test_plan_rounds_decisions_match_reference(leaves, spec, t_bwd, opt,
                                               extra):
    (jn, world), (pn, _) = _net(SIDES[0], spec), _net(SIDES[1], spec)
    sizes = _leaf_sizes()[leaves]
    jp, pp = _profiles(sizes, t_bwd)
    jkw, pkw = dict(extra), dict(extra)
    if "memory_budget_bytes" in extra:
        jkw["memory_budget_bytes"] = pkw["memory_budget_bytes"] = \
            extra["memory_budget_bytes"] * sum(sizes)
    if extra.get("cost_table"):
        jkw["cost_table"], pkw["cost_table"] = _cost_tables()
    if "parallelism" in extra:
        pkw["parallelism"] = p_par.ParallelismSpec.from_spec(
            extra["parallelism"])
    tokens, d_model, layers = 2048.0, 256, 4
    jres = j_plan.plan_rounds(jp, jn, world, opt_name=opt,
                              **_axes(j_plan, tokens, d_model, layers), **jkw)
    pres = p_plan.plan_rounds(pp, pn, world, opt_name=opt,
                              **_axes(p_plan, tokens, d_model, layers), **pkw)
    assert_same_rounds(jres, pres, (leaves, spec, t_bwd))
    if extra.get("tau_grid") == (1,):
        assert pres[0].pipeline_stages > 1      # the case is what it says
    if "memory_budget_bytes" in extra:
        assert pres[0].key == "every_step_sharded"
    jarm = j_plan.local_sgd_arm(jres[0].comm, t_bwd, 4)
    parm = p_plan.local_sgd_arm(pres[0].comm, t_bwd, 4)
    _assert_same_arm(jarm, parm, "local_sgd_arm")


def test_world1_plans_one_dense_bucket_as_reference():
    jp, pp = _profiles(_leaf_sizes()["gemma2b_reduced"], 0.01)
    link = "fast_ici"
    _assert_same_comm(j_plan.plan(jp, j_cost.LINK_PRESETS[link], 1),
                      p_plan.plan(pp, p_cost.LINK_PRESETS[link], 1))
    cp = p_plan.plan(pp, p_cost.LINK_PRESETS[link], 1)
    assert cp.n_buckets == 1 and cp.buckets[0].compressor == "none"
    assert_same_rounds(
        j_plan.plan_rounds(jp, j_cost.LINK_PRESETS[link], 1),
        p_plan.plan_rounds(pp, p_cost.LINK_PRESETS[link], 1), "world 1")


@pytest.mark.parametrize("spec", ["two_tier_pod", "commodity_cluster",
                                  "multi_pod", "flat:datacenter:8",
                                  "device:4@fast_ici"])
@pytest.mark.parametrize("budget", [None, 2e-4], ids=["free", "budget"])
def test_plan_serving_decisions_match_reference(spec, budget):
    (jn, world), (pn, _) = _net(SIDES[0], spec), _net(SIDES[1], spec)
    pb = 2.0 * get_config("gemma-2b").num_params()
    for batch in (1, 8, 64):
        jb, jarms = j_plan.plan_serving(jn, world, pb, 18, 2048, batch,
                                        latency_budget_s=budget)
        pbest, parms = p_plan.plan_serving(pn, world, pb, 18, 2048, batch,
                                           latency_budget_s=budget)
        assert jb.key() == pbest.key()
        assert [a.key() for a in jarms] == [a.key() for a in parms]
        for a, b in zip(jarms, parms):
            assert (a.tp, a.tp_tier, a.replicas) == (b.tp, b.tp_tier,
                                                     b.replicas)
            _close(a.step_s, b.step_s)
            _close(a.tokens_per_s, b.tokens_per_s)
    with pytest.raises(ValueError):
        p_plan.plan_serving(pn, world, pb, 18, 2048, 8, tp_grid=(3 * world,))


def test_profiles_from_converted_bf16_params_match_reference():
    """The port's parameter tree, converted from the reference's and cast
    to bf16 as on the card, profiles leaf for leaf like the reference's
    f32 tree: f32 bytes per leaf (numel x 4), in the reference's order."""
    import torch

    from repro_torch._tree import tree_map
    from repro_torch.convert import params_from_jax
    jparams = JModel(jreduced(jget_config("gemma-2b"))).init(
        jax.random.PRNGKey(0))
    params = tree_map(lambda t: t.to(torch.bfloat16), params_from_jax(
        jax.tree.map(np.asarray, jparams), reduced(get_config("gemma-2b")),
        device="cpu"))
    got = p_plan.profiles_from_grads(params, 0.02)
    want = j_plan.profiles_from_grads(jparams, 0.02)
    assert [p.grad_bytes for p in got] == [p.grad_bytes for p in want]
    for a, b in zip(got, want, strict=True):
        _close(a.t_backward_s, b.t_backward_s)


@pytest.mark.parametrize("argv", [
    ["--plan"], ["--plan", "--topology", "commodity_cluster", "--batch", "8"],
    ["--plan", "--topology", "node:2@datacenter,device:4@fast_ici",
     "--latency-budget-ms", "0.05", "--no-reduced"]],
    ids=["two_tier_pod", "commodity_cluster", "budget"])
def test_serve_plan_table_matches_reference(argv, capsys):
    """``serve --plan`` prints the reference's serving placement table."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(argv)
    jargs = jserve.build_parser().parse_args(argv)
    cfg = get_config(args.arch)
    jcfg = jget_config(jargs.arch)
    if args.reduced:
        cfg, jcfg = reduced(cfg), jreduced(jcfg)
    best = serve.print_plan(cfg, args)
    got = capsys.readouterr().out
    jbest = jserve._print_plan(jcfg, jargs)
    want = capsys.readouterr().out
    assert got == want and best.key() == jbest.key()
