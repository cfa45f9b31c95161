"""The port's elastic runtime (``repro_torch.elastic``, ``--elastic`` /
``--fault-trace``) against the JAX package's, on the CPU.

  * ``faults.py`` and ``reshard.py`` are copies: their code equals the
    reference's line for line (docstring and imports aside), and they
    give the same schedules, specs, JSON traces, world replays, surviving
    topologies and error messages;
  * the runtime runs the reference's four scenarios (``tests/
    test_elastic.py``: the 8 → 6 → 8 conformance trace, re-planning on a
    reshard, local-SGD backpressure, the re-plan escalation) at reduced
    gemma-2b, batch 2 x seq 16, from the reference's parameters: events
    field for field, the ``render_elastic_events`` text and the round
    counters equal, and the losses within rtol 1e-4, the tolerance
    ``tests/test_torch_training.py`` holds the replicated session's
    three steps to (the jitted reference sums in another order);
  * a faulted run equals its unfaulted run bit for bit (vanilla Adam,
    int8_fused without error feedback, ``--parallelism shard``);
  * the runtime's gates (continuity, divergence, the schedule's world)
    and the release of the old session before the factory builds the
    next one, which changes no event, counter or loss;
  * the CLI: the reference's refusals and messages, its events table and
    final line, and ``--data-parallel 2`` on gloo, where both ranks share
    one checkpoint directory and report the same events and losses.

Bit-equality of two runs on the CPU needs one intra-op thread (the
embedding backward accumulates over threads in no fixed order), so the
module runs on one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import weakref
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.elastic as jelastic
from repro.api import SessionConfig as JSessionConfig
from repro.api import TrainSession as JTrainSession
from repro.core import SyncStrategy as JSyncStrategy
from repro.core.schedule import Topology as JTopology
from repro.core.strategy import get_scheduler as jget_scheduler
from repro.launch import report as jreport
from repro.launch import train as jtrain
from repro_torch import elastic
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.api import SessionConfig, TrainSession
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core import SyncStrategy
from repro_torch.core.schedule import Topology
from repro_torch.core.strategy import get_scheduler
from repro_torch.launch import report, train
from repro_torch.launch.dist import init_group, spawn

ROOT = Path(__file__).resolve().parents[1]
CFG = reduced(get_config("gemma-2b"))
KW = dict(arch="gemma-2b", reduced=True, batch=2, seq=16, seed=0)
TOPO8 = "node:2@datacenter,device:4@fast_ici"
TRACE8 = "kill:3@3,kill:7@3,restore:3@6,restore:7@6"
LOSS_RTOL = 1e-4     # tests/test_torch_training.py's replicated session
PORT_BASE = ["--device", "cpu", "--arch", "gemma-2b", "--reduced",
             "--batch", "2", "--seq", "16", "--log-every", "0"]
REF_BASE = ["--arch", "gemma-2b", "--reduced", "--batch", "2", "--seq", "16",
            "--log-every", "100"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    init_group(torch.device("cpu"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cli_tmp(tmp_path, monkeypatch):
    """The CLIs' ``mkdtemp`` checkpoint directories under ``tmp_path``."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


# ---------------------------------------------------------------------------
# The copies: faults.py and reshard.py
# ---------------------------------------------------------------------------

def _code(path: Path) -> list:
    """The module's lines after its docstring, imports of either package
    left out."""
    text = path.read_text()
    body = text.split('"""', 2)[2]
    return [line for line in body.splitlines()
            if not line.startswith(("from repro.", "from repro_torch."))]


@pytest.mark.parametrize("name", ["faults.py", "reshard.py"])
def test_copies_equal_their_originals(name):
    assert _code(ROOT / "src/repro_torch/elastic" / name) == \
        _code(ROOT / "src/repro/elastic" / name)


def test_fault_schedule_spec_roundtrip_and_order():
    spec = "restore:3@9,kill:3@5,slow:1x4@3,slow:2x2.5@3"
    s, js = (elastic.FaultSchedule.from_spec(spec, world=8),
             jelastic.FaultSchedule.from_spec(spec, world=8))
    assert [e.describe() for e in s.events] == \
        [e.describe() for e in js.events] == \
        ["slow:1x4@3", "slow:2x2.5@3", "kill:3@5", "restore:3@9"]
    assert s.spec() == js.spec()
    assert elastic.FaultSchedule.from_spec(s.spec(), world=8) == s
    assert s.last_step == js.last_step == 9
    for step in range(11):
        assert [e.describe() for e in s.events_at(step)] == \
            [e.describe() for e in js.events_at(step)]
    assert s.to_json() == js.to_json()
    assert elastic.FaultSchedule.from_json(s.to_json()) == s


BAD_TRACES = [("kill:8@1", 8), ("kill:1@1,kill:1@2", 4), ("restore:1@1", 4),
              ("kill:0@1,kill:1@1", 2), ("kill:1@1,slow:1x2@2", 4),
              ("kill3@", 4), ("pause:1@1", 4), ("slow:1x1@1", 4),
              ("kill:-1@1", 4), ("kill:1@-2", 4), ("slow:1xfast@1", 4),
              ("kill:1", 4), ("", 0)]


@pytest.mark.parametrize("spec,world", BAD_TRACES,
                         ids=[f"{s or 'empty'}-w{w}" for s, w in BAD_TRACES])
def test_fault_schedule_validation_messages(spec, world):
    with pytest.raises(ValueError) as want:
        jelastic.FaultSchedule.from_spec(spec, world=world)
    with pytest.raises(ValueError) as got:
        elastic.FaultSchedule.from_spec(spec, world=world)
    assert str(got.value) == str(want.value)


def test_fault_schedule_random_equals_reference():
    for seed in range(4):
        for world in (2, 4, 8):
            for steps in (3, 10, 40):
                for n in (0, 1, 6):
                    got = elastic.FaultSchedule.random(world, steps, n, seed)
                    want = jelastic.FaultSchedule.random(world, steps, n,
                                                         seed)
                    assert got.spec() == want.spec(), (seed, world, steps, n)
                    assert got.to_json() == want.to_json()
                    assert elastic.replay_world_sizes(got, steps) == \
                        jelastic.replay_world_sizes(want, steps)


def test_replay_world_sizes():
    s = elastic.FaultSchedule.from_spec(TRACE8, world=8)
    assert elastic.replay_world_sizes(s, 10) == \
        ([8, 8, 8, 6, 6, 6, 8, 8, 8, 8], [3, 6]) == \
        jelastic.replay_world_sizes(
            jelastic.FaultSchedule.from_spec(TRACE8, world=8), 10)


def test_json_traces_cross_both_ways(tmp_path):
    spec = "slow:1x3@1,kill:3@2,kill:7@2,restore:3@4"
    for src, dst in ((jelastic, elastic), (elastic, jelastic)):
        path = tmp_path / f"{src.__name__}.json"
        path.write_text(json.dumps(
            src.FaultSchedule.from_spec(spec, world=8).to_json()))
        back = dst.FaultSchedule.from_json(str(path))
        assert back.spec() == spec
        assert back == dst.FaultSchedule.from_spec(spec, world=8)


# ---------------------------------------------------------------------------
# surviving_topology
# ---------------------------------------------------------------------------

TOPOLOGIES = {"flat": "device:8@fast_ici", "two": TOPO8,
              "three": "pod:2@commodity,node:2@datacenter,device:4@fast_ici",
              "four_groups": "node:4@datacenter,device:2@fast_ici"}
DEAD = {"none": [], "uniform": ["first_of_each"], "whole": ["last_group"],
        "all_but_one": ["all_but_first_group"], "irregular": [5],
        "out_of_range": ["world"], "negative": [-1], "all": ["every"]}


def _dead_set(topo, which):
    inner = topo.inner_size if not topo.is_flat else 1
    groups = topo.tiers[0].size
    out = set()
    for d in which:
        if d == "first_of_each":
            out |= {g * inner for g in range(groups)}
        elif d == "last_group":
            out |= set(range((groups - 1) * inner, groups * inner))
        elif d == "all_but_first_group":
            out |= set(range(inner, topo.world))
        elif d == "world":
            out.add(topo.world)
        elif d == "every":
            out |= set(range(topo.world))
        else:
            out.add(d)
    return out


def _tiers(topo):
    return [(t.name, t.size, t.link.alpha_s, t.link.beta_s_per_byte,
             t.link_name) for t in topo.tiers]


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
@pytest.mark.parametrize("dead", sorted(DEAD))
def test_surviving_topology_matches_reference(topo, dead):
    t, jt = (Topology.from_spec(TOPOLOGIES[topo]),
             JTopology.from_spec(TOPOLOGIES[topo]))
    dead_set = _dead_set(t, DEAD[dead])
    try:
        want = jelastic.surviving_topology(jt, dead_set)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            elastic.surviving_topology(t, dead_set)
        assert str(got.value) == str(e)
        return
    got = elastic.surviving_topology(t, dead_set)
    assert got.spec() == want.spec()
    assert _tiers(got) == _tiers(want)
    assert (got is t) == (want is jt)


# ---------------------------------------------------------------------------
# The port against itself: a faulted run is its unfaulted run, bit for bit
# ---------------------------------------------------------------------------

WIRES = {"vanilla": ["--sync", "vanilla"],
         "int8_fused_no_ef": ["--sync", "comm", "--compressor", "int8_fused",
                              "--no-error-feedback"],
         "shard": ["--sync", "vanilla", "--parallelism", "shard"]}


@pytest.mark.parametrize("wire", list(WIRES))
def test_faulted_run_is_bit_equal_to_unfaulted(wire, cli_tmp, capsys):
    flags = PORT_BASE + ["--steps", "8"] + WIRES[wire]
    rt = train.main(flags + ["--elastic", "--topology", TOPO8,
                             "--fault-trace", TRACE8])
    whole = train.main(flags)
    assert [e.kind for e in rt.events] == ["reshard", "reshard"]
    assert rt.losses == whole.losses
    assert rt.grad_rounds == whole.grad_rounds == 8
    for a, b in zip(tree_leaves(rt.session.params), tree_leaves(whole.params),
                    strict=True):
        assert torch.equal(a, b)
    got, want = rt.session.full_opt_state(), whole.full_opt_state()
    assert sorted(got) == sorted(want)
    for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
        assert torch.equal(a, b)
    assert (rt.session.layout is not None) == (wire == "shard")


# ---------------------------------------------------------------------------
# The runtime's own gates and the release of the old session
# ---------------------------------------------------------------------------

def _small_factory():
    def factory():
        return TrainSession(SessionConfig(device="cpu", steps=4, **KW))
    return factory


def _tampered_load(monkeypatch, value):
    """``load_checkpoint`` followed by every parameter set to ``value``
    times itself (a restore bug)."""
    inner = TrainSession.load_checkpoint

    def load(self, path):
        step = inner(self, path)
        self._params = tree_map(lambda p: p * value, self._params)
        return step
    monkeypatch.setattr(TrainSession, "load_checkpoint", load)


def test_continuity_gate_raises_on_a_tampered_restore(monkeypatch, tmp_path):
    _tampered_load(monkeypatch, 40.0)
    rt = elastic.ElasticRuntime(
        _small_factory(), elastic.FaultSchedule.from_spec("kill:1@1", 8),
        elastic.ElasticConfig(topology=TOPO8, checkpoint_dir=str(tmp_path)))
    with pytest.raises(RuntimeError,
                       match=r"loss discontinuity across reshard at step 1: "
                             r".* — restore bug"):
        rt.run(2)


def test_divergence_gate_raises_on_a_non_finite_loss(monkeypatch, tmp_path):
    _tampered_load(monkeypatch, float("nan"))
    rt = elastic.ElasticRuntime(
        _small_factory(), elastic.FaultSchedule.from_spec("kill:1@1", 8),
        elastic.ElasticConfig(topology=TOPO8, checkpoint_dir=str(tmp_path)))
    with pytest.raises(RuntimeError,
                       match=r"loss diverged to nan at step 1 \(world 7\)"):
        rt.run(2)


def test_world_mismatch_raises_the_reference_message(tmp_path):
    with pytest.raises(ValueError) as want:
        jelastic.ElasticRuntime(
            None, jelastic.FaultSchedule.from_spec("", 4),
            jelastic.ElasticConfig(topology=TOPO8,
                                   checkpoint_dir=str(tmp_path)))
    with pytest.raises(ValueError) as got:
        elastic.ElasticRuntime(
            None, elastic.FaultSchedule.from_spec("", 4),
            elastic.ElasticConfig(topology=TOPO8,
                                  checkpoint_dir=str(tmp_path)))
    assert str(got.value) == str(want.value)
    assert "fault schedule is against world=4" in str(got.value)


def test_old_session_is_released_before_the_factory_runs(monkeypatch,
                                                         tmp_path):
    """Every earlier generation is gone (its weakref dead) when the factory
    builds the next; keeping them alive instead, as the reference does,
    gives the same events, counters and losses."""
    refs, dead_at_call = [], []

    def factory():
        dead_at_call.append([r() is None for r in refs])
        s = _small_factory()()
        refs.append(weakref.ref(s))
        return s

    def run(f):
        rt = elastic.ElasticRuntime(
            f, elastic.FaultSchedule.from_spec("kill:3@1,restore:3@2", 8),
            elastic.ElasticConfig(topology=TOPO8,
                                  checkpoint_dir=str(tmp_path)))
        rt.run(3)
        return ([dataclasses.asdict(e) for e in rt.events], rt.losses,
                (rt.grad_rounds, rt.param_rounds, rt.control_rounds))

    released = run(factory)
    assert dead_at_call == [[], [True], [True, True]]

    kept = []

    def keep_alive(self):
        kept.append(self.session)
        self.session = None
    monkeypatch.setattr(elastic.ElasticRuntime, "_release", keep_alive)
    assert run(_small_factory()) == released
    assert len(kept) == 2


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    ["--elastic"],
    ["--elastic", "--topology", TOPO8, "--parallelism", "pp=2"],
    ["--elastic", "--topology", TOPO8, "--parallelism", "micro=2"],
    ["--elastic", "--topology", TOPO8, "--fault-trace", "{trace}"],
    ["--fault-trace", "kill:1@1"]],
    ids=["no-topology", "pipeline", "micro", "trace-world", "no-elastic"])
def test_cli_refusals_match_reference(extra, tmp_path):
    trace = tmp_path / "w4.json"
    trace.write_text(json.dumps(
        jelastic.FaultSchedule.from_spec("kill:1@1", 4).to_json()))
    extra = [str(trace) if a == "{trace}" else a for a in extra]
    with pytest.raises(SystemExit) as want:
        jtrain.main(REF_BASE + ["--steps", "2"] + extra)
    with pytest.raises(SystemExit) as got:
        train.main(PORT_BASE + ["--steps", "2"] + extra)
    assert str(got.value) == str(want.value) and str(got.value)


FINAL = re.compile(r"final loss \d+\.\d{4} \(first \d+\.\d{4}\) \| "
                   r"(steps \d+, comm rounds \d+ \(grad \d+, param \d+\), "
                   r"\d+ elastic events)$")


def _events_and_final(text):
    lines = text.strip().splitlines()
    i = next(i for i, line in enumerate(lines)
             if line.startswith("elastic events ("))
    n = int(lines[i].split("(")[1].split(")")[0])
    m = FINAL.match(lines[-1])
    assert m, lines[-1]
    return lines[i:i + 3 + n], m.group(1)


def _dp2_child(rank, world, store, argv, par_spec, checkpoint_dir, out_dir):
    """``train._rank_main`` with its runtime's events, losses, round
    counters and checkpoint directory written to ``rank{r}.json``."""
    inner = train.run_elastic

    def recorded(*a, **k):
        rt = inner(*a, **k)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"events": [dataclasses.asdict(e) for e in rt.events],
                       "losses": rt.losses, "dir": rt.cfg.checkpoint_dir,
                       "rounds": [rt.grad_rounds, rt.param_rounds],
                       "world": rt.session.world}, f)
        return rt
    train.run_elastic = recorded
    train._rank_main(rank, world, store, argv, par_spec, checkpoint_dir)


def test_cli_data_parallel_2_shares_one_directory(cli_tmp, monkeypatch):
    """``--data-parallel 2`` on gloo: ``main`` makes the checkpoint
    directory before the ranks spawn, rank 0 writes there and both ranks
    read it back; both report the same events and losses."""
    out = cli_tmp / "ranks"
    out.mkdir()

    def spawn_recorded(fn, world, args):
        assert fn is train._rank_main
        spawn(_dp2_child, world, args=(*args, str(out)), timeout=240)
    monkeypatch.setattr(train, "spawn", spawn_recorded)
    train.main(PORT_BASE + ["--steps", "4", "--data-parallel", "2",
                            "--elastic", "--topology", TOPO8,
                            "--fault-trace", "kill:3@1,restore:3@3"])
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(2)]
    assert ranks[0] == ranks[1]
    assert ranks[0]["world"] == 2 and ranks[0]["rounds"] == [4, 0]
    assert [(e["step"], e["old_world"], e["new_world"])
            for e in ranks[0]["events"]] == [(1, 8, 7), (3, 7, 8)]
    assert all(np.isfinite(ranks[0]["losses"]))
    ckpt = Path(ranks[0]["dir"])
    assert ckpt.parent == cli_tmp and ckpt.name.startswith("elastic_")
    assert sorted(os.listdir(ckpt)) == ["elastic.json", "elastic.npz"]


# ---------------------------------------------------------------------------
# The runtime against the reference's: four scenarios
# ---------------------------------------------------------------------------

SCENARIOS = {   # the reference's tests/test_elastic.py scenarios
    # :178, through the reference CLI's factory configuration (steps = 8)
    "conformance": dict(trace=TRACE8, topology=TOPO8, steps=8, run=8),
    # :199
    "plan": dict(trace="kill:3@2,kill:7@2", topology=TOPO8, steps=4, run=4,
                 cfg=dict(plan=True, t_backward_s=0.05)),
    # :237
    "backpressure": dict(trace="slow:1x4@1", topology=TOPO8, steps=6, run=6,
                         period=2),
    # :285
    "replan": dict(trace="slow:1x6@1", topology="device:8@fast_ici",
                   steps=6, run=5, cfg=dict(plan=True, t_backward_s=0.5)),
}


def _summary(rt, render, record) -> dict:
    """What both packages' runtimes must agree on, as JSON: the events,
    their table, the round counters, the installed plan and scheduler,
    the plan record's world and topology, and the losses."""
    s = rt.session
    sched = s.strategy.scheduler if s.strategy is not None else None
    out = {"events": [dataclasses.asdict(e) for e in rt.events],
           "render": render(rt.events), "losses": list(rt.losses),
           "step": s.step, "alive": sorted(rt.alive),
           "slow": sorted(rt.slow.items()),
           "scheduler": sched and [
               sched.name, getattr(getattr(sched, "cfg", None), "period",
                                   None)],
           **{k: getattr(rt, k) for k in (
               "grad_rounds", "param_rounds", "control_rounds",
               "comm_rounds", "plan_key")}}
    if s.planned:
        rec = record(s.planned["strategy_plan"].comm)
        out["record"] = [rec["world"], rec.get("topology", {}).get("spec")]
    return json.loads(json.dumps(out))


def _reference_cli(argv):
    """The reference CLI in this process: (its runtime, its stdout)."""
    made = []

    class Recorded(jelastic.ElasticRuntime):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(jelastic, "ElasticRuntime", Recorded)
        jtrain.main(argv)
    return made[0], out.getvalue()


# the reference's scenarios in two subprocesses, each a share of the time
REFERENCE_GROUPS = (("conformance",), ("plan", "backpressure", "replan"))


def _reference_scenarios(out_dir: str, names: str) -> None:
    """The scenarios ``names`` (comma-joined) in the reference (the
    conformance one through its CLI), their summaries, with the CLI's
    output, written to ``reference-<names>.json``."""
    tempfile.tempdir = out_dir        # the reference CLI's mkdtemp
    out = {}
    for name in names.split(","):
        sc = SCENARIOS[name]
        skw = dict(KW, steps=sc["steps"])
        if name == "conformance":
            jrt, out["cli"] = _reference_cli(
                REF_BASE + ["--steps", str(sc["steps"]), "--elastic",
                            "--topology", TOPO8, "--fault-trace", TRACE8])
        else:
            def jfactory(period=sc.get("period")):
                s = JTrainSession(JSessionConfig(**skw))
                if period:
                    s.strategy = JSyncStrategy(scheduler=jget_scheduler(
                        "local_sgd", period=period))
                return s
            jrt = jelastic.ElasticRuntime(
                jfactory, jelastic.FaultSchedule.from_spec(sc["trace"], 8),
                jelastic.ElasticConfig(
                    topology=sc["topology"],
                    checkpoint_dir=os.path.join(out_dir, name),
                    **sc.get("cfg", {})))
            jrt.run(sc["run"])
        out[name] = _summary(jrt, jreport.render_elastic_events,
                             jreport.comm_plan_record)
    with open(os.path.join(out_dir, f"reference-{names}.json"), "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module", autouse=True)
def reference_run(tmp_path_factory):
    """The reference's scenarios in subprocesses of this file, started
    with the module so that they run beside the port's tests."""
    out = tmp_path_factory.mktemp("elastic_reference")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = {}
    for group in REFERENCE_GROUPS:
        names = ",".join(group)
        with open(out / f"log-{names}.txt", "w") as log:
            procs[names] = subprocess.Popen(
                [sys.executable, __file__, "--reference", str(out), names],
                env=env, cwd=ROOT / "tests", stdout=log,
                stderr=subprocess.STDOUT)
    yield procs, out
    for proc in procs.values():
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def scenarios(reference_run, tmp_path_factory):
    """(the port's summaries, the reference's): each scenario once in each
    package, the port's sessions on the reference's initial parameters."""
    start = jax.tree.map(np.asarray,
                         JTrainSession(JSessionConfig(**KW))._params)
    got = {}
    for name, sc in SCENARIOS.items():
        skw = dict(KW, steps=sc["steps"])

        def factory(skw=skw, period=sc.get("period")):
            s = TrainSession(SessionConfig(device="cpu", **skw),
                             params=params_from_jax(start, CFG, device="cpu"))
            if period:
                s.strategy = SyncStrategy(scheduler=get_scheduler(
                    "local_sgd", period=period))
            return s
        rt = elastic.ElasticRuntime(
            factory, elastic.FaultSchedule.from_spec(sc["trace"], 8),
            elastic.ElasticConfig(
                topology=sc["topology"],
                checkpoint_dir=str(tmp_path_factory.mktemp(name)),
                **sc.get("cfg", {})))
        rt.run(sc["run"])
        got[name] = _summary(rt, report.render_elastic_events,
                             report.comm_plan_record)
    procs, out = reference_run
    want = {}
    for names, proc in procs.items():
        proc.wait(timeout=900)
        assert proc.returncode == 0, \
            (out / f"log-{names}.txt").read_text()[-4000:]
        want.update(json.loads((out / f"reference-{names}.json").read_text()))
    return got, want


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_runtime_events_match_reference(scenarios, name):
    got, want = scenarios
    assert got[name]["events"] and \
        got[name]["events"] == want[name]["events"]
    assert got[name]["render"] == want[name]["render"]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_runtime_counters_and_losses_match_reference(scenarios, name):
    """Everything of :func:`_summary` equal, the losses within
    ``LOSS_RTOL``."""
    got, want = (dict(d[name]) for d in scenarios)
    np.testing.assert_allclose(got.pop("losses"), want.pop("losses"),
                               rtol=LOSS_RTOL)
    assert got == want
    assert got["step"] == SCENARIOS[name]["run"]


def test_conformance_scenario_reshards_8_6_8(scenarios):
    got = scenarios[0]["conformance"]
    assert [(e["step"], e["kind"], e["old_world"], e["new_world"],
             e["topology"]) for e in got["events"]] == [
        (3, "reshard", 8, 6, "node:2@datacenter,device:3@fast_ici"),
        (6, "reshard", 6, 8, TOPO8)]
    assert got["grad_rounds"] == 8 and got["scheduler"] is None


def test_plan_scenario_record_carries_the_surviving_topology(scenarios):
    got = scenarios[0]["plan"]
    assert got["record"] == [6, "node:2@datacenter,device:3@fast_ici"]
    assert got["events"][0]["plan_key"] != ""


def test_backpressure_scenario_stretches_tau(scenarios):
    got = scenarios[0]["backpressure"]
    assert [e["kind"] for e in got["events"]] == ["backpressure"]
    assert "local_sgd" in got["events"][0]["note"]
    assert got["scheduler"] == ["local_sgd", 4]


def test_replan_scenario_installs_local_sgd(scenarios):
    got = scenarios[0]["replan"]
    assert [e["kind"] for e in got["events"]] == ["replan"]
    assert "installed" in got["events"][0]["note"]
    assert got["scheduler"][0] == "local_sgd"


def test_cli_events_table_and_final_line_match_reference(scenarios, cli_tmp,
                                                         capsys):
    """The port's CLI on the conformance trace read from a JSON file the
    reference wrote prints the reference CLI's events table and final
    line (the reference CLI's run is the conformance scenario)."""
    trace = cli_tmp / "trace8.json"
    trace.write_text(json.dumps(
        jelastic.FaultSchedule.from_spec(TRACE8, 8).to_json()))
    capsys.readouterr()
    rt = train.main(PORT_BASE + ["--steps", "8", "--elastic", "--topology",
                                 TOPO8, "--fault-trace", str(trace)])
    table, final = _events_and_final(capsys.readouterr().out)
    jtable, jfinal = _events_and_final(scenarios[1]["cli"])
    assert table == jtable and final == jfinal
    assert final == "steps 8, comm rounds 8 (grad 8, param 0), 2 elastic " \
        "events"
    assert rt.cfg.checkpoint_dir.startswith(str(cli_tmp / "elastic_"))


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _reference_scenarios(sys.argv[2], sys.argv[3])
