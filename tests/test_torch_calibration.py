"""Calibration and drift re-planning of the port
(``repro_torch/core/schedule/calibration.py``, the session's
``calibrate`` / ``plan_auto(calibration=)`` / ``replan_now`` /
``drift_report``, ``launch/report.py``'s calibration and drift blocks and
``render_drift_table``, the CLI's ``--calibrate`` / ``--replan-*``)
against the JAX package's, on ``tests/test_calibration.py``'s cases.

  * The pure parts are copies: the fits, the link fit, the degenerate
    tier, ``CalibratedTopology`` and its JSON, the drift math and
    ``plan_comm_error_s`` are held to the live reference functions with
    injected (fake-fabric) timers at rel 1e-12, and the JSON reads
    across both packages both ways.
  * ``render_drift_table`` is text-equal to the reference's on the same
    record; the plan record keeps its key set without calibration and
    gains exactly the two blocks with it, as the reference's does.
  * Sessions on reduced gemma-2b (the reference's weights), planned on a
    calibrated flat fabric and on a 4-rank planning topology: the same
    plan; ``replan_now(straggler_s=)`` records the reference's event
    (every key but the measured step time) and installs the same arm.
  * Real timers: ``measure_compression_costs`` on the CPU at small sizes
    records its fits' quality; ``calibrate_topology`` on a gloo world of
    4 (4 spawned processes) fits finite coefficients from psum and ring
    timings at every rank, and refuses a topology of another world.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

import repro.launch.paths as j_paths
import repro_torch.launch.paths as p_paths
from repro.core.schedule import calibration as jcal
from repro.core.schedule import Topology as JTopology
from repro.launch import report as jreport
from repro_torch.core.schedule import calibration as pcal
from repro_torch.core.schedule import (LinkParams, Topology,
                                       allreduce_cost_s, plan)
from repro_torch.core.schedule.perf_model import LayerProfile
from repro_torch.launch import report as preport
from repro_torch.launch import train
from repro_torch.launch.dist import init_group

TWO_TIER = "node:4@datacenter,device:8@fast_ici"
TRUTH = {"node": (5e-6, 1e-10), "device": (1e-6, 2e-11)}


@pytest.fixture(scope="module", autouse=True)
def world1():
    init_group(torch.device("cpu"))


def _fabric_timer(links, phase_coeffs, noise_s=0.0, seed=0):
    """The reference test's fake fabric: exact phase-formula timings from
    known per-tier (α, β) plus seeded additive gaussian noise."""
    rng = np.random.RandomState(seed)

    def timer(algo, tier, p, n_bytes):
        a, b = links[tier]
        ca, cb = phase_coeffs(algo, p, n_bytes) or (1.0, 0.0)
        return ca * a + cb * b + (rng.normal(0.0, noise_s)
                                  if noise_s else 0.0)

    return timer


def _same_fit(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, float) and math.isfinite(x):
            assert x == pytest.approx(y, rel=1e-12, abs=1e-300), f.name
        else:
            assert x == y, f.name


# ---------------------------------------------------------------------------
# Fits
# ---------------------------------------------------------------------------

FIT_POINTS = {
    "line": [(x, 2e-10 * x + 5e-5) for x in (1e4, 1e5, 1e6, 1e7)],
    "noisy": [(x, 1e-10 * x + 2e-4 + e) for x, e in zip(
        np.logspace(4, 7, 12), np.random.RandomState(7).normal(0, 2e-5, 12))],
    "two_points": [(1.0, 1.0), (2.0, 2.0)],
}


@pytest.mark.parametrize("name", list(FIT_POINTS))
def test_fit_affine_matches_reference(name):
    _same_fit(pcal.fit_affine(FIT_POINTS[name]),
              jcal.fit_affine(FIT_POINTS[name]))


def test_fit_clamp_warns_and_matches_reference():
    pts = [(1e6, 3e-3), (2e6, 2e-3), (8e6, 2.5e-3)]     # non-monotone
    with pytest.warns(UserWarning, match="degenerated"):
        got = pcal._fit(pts)
    with pytest.warns(UserWarning, match="degenerated"):
        want = jcal._fit(pts)
    assert got[:2] == pytest.approx(want[:2], rel=1e-12)
    assert got[2].degenerate and want[2].degenerate


@pytest.mark.parametrize("noise", [0.0, 2e-7], ids=["exact", "noisy"])
def test_calibrate_topology_matches_reference(noise):
    got = pcal.calibrate_topology(
        Topology.from_spec(TWO_TIER),
        timer=_fabric_timer(TRUTH, pcal._phase_coeffs, noise))
    want = jcal.calibrate_topology(
        JTopology.from_spec(TWO_TIER),
        timer=_fabric_timer(TRUTH, jcal._phase_coeffs, noise))
    assert got.topology.spec() == want.topology.spec()
    assert [n for n, _ in got.fits] == [n for n, _ in want.fits]
    for (_, a), (_, b) in zip(got.fits, want.fits):
        _same_fit(a, b)
    assert got.samples == want.samples
    assert got.describe() == want.describe()
    for n, p in ((1 << 20, 32), (1 << 24, 8), (1 << 20, 1)):
        assert got.allreduce_error_s(n, p) == pytest.approx(
            want.allreduce_error_s(n, p), rel=1e-12)
    # a CalibratedTopology is a net of the copied cost model
    from repro.core.schedule import allreduce_cost_s as jallreduce_cost_s
    assert allreduce_cost_s("ring", 1 << 20, 32, got) == pytest.approx(
        jallreduce_cost_s("ring", 1 << 20, 32, want), rel=1e-12)
    if not noise:
        assert allreduce_cost_s("ring", 1 << 20, 32, got) == pytest.approx(
            2 * 31 * (5e-6 + (1 << 20) / 32 * 1e-10), rel=1e-6)


def test_one_rank_tier_fits_degenerate_as_reference():
    def timer(algo, tier, p, n):
        return 1e-5 + n * 1e-12
    got = pcal.calibrate_topology(Topology.flat(1, LinkParams(), name="solo"),
                                  timer=timer)
    want = jcal.calibrate_topology(
        JTopology.flat(1, jcal.LinkParams(), name="solo"), timer=timer)
    assert got.fit_for("solo").degenerate
    _same_fit(got.fit_for("solo"), want.fit_for("solo"))


def test_calibrate_world_mismatch_raises():
    big = Topology.flat(2, LinkParams(), name="data")
    with pytest.raises(ValueError, match="cannot calibrate"):
        pcal.calibrate_topology(big)          # default timer, world 1


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_calibrated_topology_json_across_packages(tmp_path, direction):
    timer_p = _fabric_timer(TRUTH, pcal._phase_coeffs, 2e-7)
    timer_j = _fabric_timer(TRUTH, jcal._phase_coeffs, 2e-7)
    got = pcal.calibrate_topology(Topology.from_spec(TWO_TIER), timer=timer_p)
    want = jcal.calibrate_topology(JTopology.from_spec(TWO_TIER),
                                   timer=timer_j)
    path = str(tmp_path / "fabric.cal.json")
    if direction == "port_to_reference":
        got.save(path)
        back = jcal.resolve_calibration(path)
        assert back.fits == want.fits and back.samples == want.samples
    else:
        want.save(path)
        back = pcal.resolve_calibration(path)
        assert back.fits == got.fits and back.samples == got.samples
        assert back.topology == got.topology
    with open(path) as f:
        assert json.load(f) == want.to_json()


# ---------------------------------------------------------------------------
# Drift math and the drift table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("modeled,measured", [(10e-3, 12e-3), (2.0, 1.5),
                                              (1.0, 1.0), (3e-3, 7e-2)])
def test_drift_math_matches_reference(modeled, measured):
    assert pcal.drift_fraction(modeled, measured) == \
        jcal.drift_fraction(modeled, measured)
    assert pcal.modeled_wall_step_s(modeled, measured) == \
        jcal.modeled_wall_step_s(modeled, measured)
    with pytest.raises(ValueError):
        pcal.drift_fraction(0.0, measured)


def test_plan_comm_error_matches_reference():
    from repro.core.schedule import LayerProfile as JLayerProfile
    from repro.core.schedule import plan as jplan
    got = pcal.calibrate_topology(
        Topology.from_spec(TWO_TIER),
        timer=_fabric_timer(TRUTH, pcal._phase_coeffs, 2e-7))
    want = jcal.calibrate_topology(
        JTopology.from_spec(TWO_TIER),
        timer=_fabric_timer(TRUTH, jcal._phase_coeffs, 2e-7))
    cp = plan([LayerProfile(t_backward_s=1e-3, grad_bytes=4 << 20)
               for _ in range(4)], got.topology, 32)
    jcp = jplan([JLayerProfile(t_backward_s=1e-3, grad_bytes=4 << 20)
                 for _ in range(4)], want.topology, 32)
    err = pcal.plan_comm_error_s(cp, got)
    assert err > 0 and err == pytest.approx(
        jcal.plan_comm_error_s(jcp, want), rel=1e-12)
    assert pcal.plan_comm_error_s(cp, None) == 0.0


DRIFT = {
    "plan_key": "every_step", "modeled_step_s": 8e-3,
    "modeled_wall_step_s": 10e-3, "measured_step_s": 12e-3,
    "steps_measured": 5, "drift_frac": 0.2, "drift_pct": 20.0,
    "comm_fit_err_s": 1e-4, "t_backward_err_s": 5e-4,
    "measured_spread_s": 2e-3, "fit_error_s": 2.6e-3,
    "within_fit_error": True, "replans": 1,
    "replan_events": [{"step": 25, "drift_frac": 0.2,
                       "new_key": "every_step", "applied": False,
                       "note": "re-plan kept the incumbent arm"},
                      {"step": 50, "drift_frac": -0.4,
                       "new_key": "local_sgd/tau4", "applied": True,
                       "note": ""}],
    "arms": {"every_step": {"modeled_step_s": 8e-3,
                            "modeled_wall_step_s": 10e-3,
                            "drift_pct": 20.0},
             "local_sgd/tau4": {"modeled_step_s": 5e-3,
                                "modeled_wall_step_s": 7e-3,
                                "drift_pct": 71.4}}}


@pytest.mark.parametrize("within", [True, False])
def test_render_drift_table_text_equal_to_reference(within):
    drift = dict(DRIFT, within_fit_error=within)
    txt = preport.render_drift_table(drift)
    assert txt == jreport.render_drift_table(drift)
    assert "every_step ←" in txt and "replan @step 25" in txt


# ---------------------------------------------------------------------------
# Sessions: calibrated planning, drift report, replan_now, the record
# ---------------------------------------------------------------------------

SESSION = dict(arch="gemma-2b", reduced=True, batch=2, seq=16, lr=3e-3,
               warmup=2, steps=8)


def _pair():
    from repro.api import SessionConfig as JSessionConfig
    from repro.api import TrainSession as JTrainSession
    from repro_torch.api import SessionConfig, TrainSession
    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import params_from_jax
    jsess = JTrainSession(JSessionConfig(**SESSION))
    start = jax.tree.map(np.asarray, jsess._params)
    sess = TrainSession(SessionConfig(device="cpu", **SESSION),
                        params=params_from_jax(
                            start, reduced(get_config("gemma-2b")),
                            device="cpu"))
    return jsess, sess


@pytest.fixture(scope="module")
def calibrated_pair(world1):
    jsess, sess = _pair()
    links = {"data": (5e-6, 1e-10)}
    jsess.plan_auto(calibration=jcal.calibrate_topology(
        JTopology.flat(1, jcal.LinkParams(), name="data"),
        timer=_fabric_timer(links, jcal._phase_coeffs)), t_backward_s=0.02)
    sess.plan_auto(calibration=pcal.calibrate_topology(
        Topology.flat(1, LinkParams(), name="data"),
        timer=_fabric_timer(links, pcal._phase_coeffs)), t_backward_s=0.02)
    jsess.run(steps=3)
    sess.run(steps=3)
    return jsess, sess


def test_plan_auto_consumes_calibration_as_reference(calibrated_pair):
    jsess, sess = calibrated_pair
    assert sess.topology.innermost.link_name == "calibrated"
    assert sess.topology.spec() == jsess.topology.spec()
    sp, jsp = sess.planned["strategy_plan"], jsess.planned["strategy_plan"]
    assert sp.key == jsp.key
    assert sp.modeled_step_s == pytest.approx(jsp.modeled_step_s, rel=1e-12)
    assert sorted(sess.planned["arms"]) == sorted(jsess.planned["arms"])


def test_drift_report_math(calibrated_pair):
    _, sess = calibrated_pair
    d = sess.drift_report()
    sp = sess.planned["strategy_plan"]
    wall = pcal.modeled_wall_step_s(sp.modeled_step_s, sp.t_backward_s)
    assert d["modeled_wall_step_s"] == wall
    assert d["measured_step_s"] == sess.measured_step_s() > 0
    assert d["drift_frac"] == pcal.drift_fraction(wall, d["measured_step_s"])
    assert d["drift_pct"] == d["drift_frac"] * 100.0
    assert d["steps_measured"] == 2
    assert d["fit_error_s"] >= d["comm_fit_err_s"]
    assert set(d["arms"]) == set(sess.planned["arms"])


def test_drift_report_keys_match_reference(calibrated_pair):
    jsess, sess = calibrated_pair
    d, jd = sess.drift_report(), jsess.drift_report()
    assert set(d) == set(jd)
    assert set(d["arms"]) == set(jd["arms"])
    for k in ("plan_key", "steps_measured", "replans"):
        assert d[k] == jd[k], k
    for k in ("modeled_step_s", "modeled_wall_step_s", "comm_fit_err_s"):
        assert d[k] == pytest.approx(jd[k], rel=1e-12), k


def test_plan_record_key_sets_match_reference(calibrated_pair, tmp_path,
                                              monkeypatch):
    jsess, sess = calibrated_pair
    monkeypatch.setattr(p_paths, "COMM_PLANS", str(tmp_path / "port"))
    monkeypatch.setattr(j_paths, "COMM_PLANS", str(tmp_path / "ref"))
    recs = {}
    for tag, s, rep in (("port", sess, preport), ("ref", jsess, jreport)):
        sp = s.planned["strategy_plan"]
        with open(rep.save_strategy_plan(sp, "base")) as f:
            base = json.load(f)
        with open(rep.save_strategy_plan(
                sp, "cal", calibration=s.calibration,
                drift=s.drift_report())) as f:
            cal = json.load(f)
        recs[tag] = (base, cal)
    (base, cal), (jbase, jcal_rec) = recs["port"], recs["ref"]
    assert set(base) == set(jbase)
    assert set(cal) == set(base) | {"calibration", "drift"}
    assert set(cal) == set(jcal_rec)
    assert set(cal["calibration"]) == set(jcal_rec["calibration"])
    assert set(cal["drift"]) == set(jcal_rec["drift"])
    assert "samples" not in cal["calibration"]
    assert cal["calibration"]["tiers"][0]["alpha_s"] == pytest.approx(
        jcal_rec["calibration"]["tiers"][0]["alpha_s"], rel=1e-12)
    assert {k: v for k, v in cal.items()
            if k not in ("calibration", "drift")} == base


def test_replan_now_records_the_reference_event(capsys):
    jsess, sess = _pair()
    kw = dict(topology="device:4@fast_ici", t_backward_s=0.02)
    jsess.plan_auto(**kw)
    sess.plan_auto(**kw)
    jsess.run(steps=2)
    sess.run(steps=2)
    jev = jsess.replan_now(straggler_s=0.05, t_backward_s=0.02)
    ev = sess.replan_now(straggler_s=0.05, t_backward_s=0.02)
    assert set(ev) == set(jev)
    for k in ev:
        if k != "measured_step_s":
            assert ev[k] == jev[k], k
    assert ev["measured_step_s"] == sess.measured_step_s()
    assert ev["applied"] and ev["new_key"] != ev["old_key"]
    assert sess.strategy.describe() == jsess.strategy.describe()
    assert sess.replans == jsess.replans == 1
    out = capsys.readouterr().out
    assert f"replan @step 2: drift +0.0%, straggler 50.0 ms -> " \
        f"{ev['new_key']} (installed)" in out
    # the swapped arm runs
    losses = sess.run(steps=1)
    assert np.isfinite(losses).all()
    assert sess.planned["executed"].key == ev["new_key"]


def test_replan_now_needs_a_plan():
    _, sess = _pair()
    with pytest.raises(RuntimeError, match="needs a prior plan_auto"):
        sess.replan_now()


def test_cli_calibrate_and_replan_write_the_blocks(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.setattr(p_paths, "COMM_PLANS", str(tmp_path))
    train.main(["--device", "cpu", "--reduced", "--steps", "5", "--batch",
                "2", "--seq", "16", "--sync", "auto", "--calibrate",
                "--replan-drift-pct", "1e-9", "--replan-every", "2",
                "--plan-backward-ms", "5"])
    out = capsys.readouterr().out
    assert "calibrated topology: data:1@calibrated" in out
    assert "modeled vs measured (4 steps" in out
    assert "| arm | modeled ms | wall ms | measured ms | drift |" in out
    assert out.count("replan @step 3") == 2   # the log and the table
    rec = json.loads((tmp_path / "gemma-2b.json").read_text())
    assert {"calibration", "drift"} <= set(rec)
    assert rec["drift"]["replans"] == 1        # max_replans
    assert rec["calibration"]["world"] == 1


def test_cli_replan_refusals():
    with pytest.raises(SystemExit, match="requires --sync auto"):
        train.main(["--device", "cpu", "--reduced", "--steps", "1",
                    "--sync", "comm", "--replan-drift-pct", "5"])


def test_cli_calibrate_without_auto_warns(capsys):
    train.main(["--device", "cpu", "--reduced", "--steps", "1", "--batch",
                "2", "--seq", "16", "--calibrate"])
    out = capsys.readouterr().out
    assert "warning: --calibrate fits the link model --sync auto plans" in out
    assert "calibrated topology: data:1@calibrated" in out


# ---------------------------------------------------------------------------
# Real timers
# ---------------------------------------------------------------------------

def test_measure_compression_costs_on_cpu():
    tab = pcal.measure_compression_costs(
        compressors=(("int8", ()), ("int8_fused", ()),
                     ("topk_fused", (("ratio", 0.01),))),
        sizes=(1 << 12, 1 << 13, 1 << 14), repeats=1, device="cpu")
    assert tab.cal_world == pcal.CAL_WORLD == jcal.CAL_WORLD
    for name in ("int8", "int8_fused", "topk_fused"):
        for stage in ("encode", "decode"):
            assert tab.stage_s(name, stage, 1e6) is not None
            rms, r2, deg = tab.fit_quality(f"{name}/{stage}")
            assert rms >= 0 and isinstance(deg, bool)
    assert pcal.CALIBRATION_SET == jcal.CALIBRATION_SET
    assert (pcal.CAL_SIZES, pcal.CAL_LINK_SIZES, pcal.CAL_LINK_ALGOS,
            pcal.CAL_LINK_REPEATS) == (jcal.CAL_SIZES, jcal.CAL_LINK_SIZES,
                                       jcal.CAL_LINK_ALGOS,
                                       jcal.CAL_LINK_REPEATS)


def _w4_calibrate(rank: int, world: int, store: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    init_group(torch.device("cpu"), world_size=world, rank=rank,
               store_path=store)
    cal = pcal.calibrate_topology(sizes=(1 << 8, 1 << 10, 1 << 12),
                                  repeats=2)
    tiered = pcal.calibrate_topology(
        Topology.from_spec("node:2@commodity,device:2@fast_ici"),
        sizes=(1 << 8, 1 << 10, 1 << 12), repeats=2)
    with open(os.path.join(out_dir, f"cal-{rank}.json"), "w") as f:
        json.dump({"flat": cal.to_json(), "tiered": tiered.to_json()}, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def test_calibrate_topology_on_a_gloo_world_of_4(tmp_path):
    from repro_torch.launch.dist import spawn
    spawn(_w4_calibrate, 4, args=(str(tmp_path),), timeout=120)
    for r in range(4):
        rec = json.loads((tmp_path / f"cal-{r}.json").read_text())
        for kind, tiers in (("flat", [("data", 4)]),
                            ("tiered", [("node", 2), ("device", 2)])):
            obj = rec[kind]
            assert [(t["name"], t["size"]) for t in obj["tiers"]] == tiers
            for t in obj["tiers"]:
                assert math.isfinite(t["alpha_s"]) and t["alpha_s"] >= 0
                assert math.isfinite(t["beta_s_per_byte"])
                assert t["n_samples"] == 2 * 3
            assert {(s["algo"], s["p"]) for s in obj["samples"]} == \
                {(a, p) for a in ("psum", "ring") for _, p in tiers}
            assert all(s["seconds"] > 0 for s in obj["samples"])
