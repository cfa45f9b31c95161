"""Plan tables and plan records of the port's ``--sync auto`` and
``serve --plan`` paths: the part of ``repro/launch/report.py`` that the
planner calls (the per-tier cost breakdown, the markdown plan tables, the
JSON plan record), the per-worker memory line of a sharded run and the
stage table of a pipeline run, and the elastic runtime's event table
(:func:`render_elastic_events`).
Records go to ``artifacts/comm_plans_torch/<arch>.json``
(``launch/paths.py``), with the calibration and drift blocks of a
``--calibrate`` / ``--replan-drift-pct`` run and its drift table
(:func:`render_drift_table`).  The dry run's tables:
:func:`dryrun_table` and :func:`variants_table` over the records of
``launch/dryrun.py`` (``artifacts/dryrun_torch/``), and :func:`main`, which
prints them with the roofline table (``launch/roofline.py``):

    PYTHONPATH=src python -m repro_torch.launch.report
"""
from __future__ import annotations

import glob
import json
import os


def _gbps(link) -> float:
    """A link's bandwidth in GB/s; infinite for β = 0, which a calibrated
    one-rank tier fits when its timings fall with size (the reference
    divides by zero there)."""
    b = link.beta_s_per_byte
    return 1.0 / b / 1e9 if b > 0 else float("inf")


def tier_cost_breakdown(plan) -> dict:
    """Serial per-tier cost of a plan's buckets: sum each bucket's phase
    costs (``cost.bucket_sync_phases``) grouped by the tier the phase
    traverses, plus the ``"compute"`` compress/decompress time — the
    per-tier rows of the plan table and the plan record (DESIGN.md §10).
    Keys follow tier order (outermost first), then compute."""
    from repro_torch.core.schedule import Topology
    from repro_torch.core.schedule.cost import bucket_sync_phases

    out: dict = {}
    if isinstance(plan.link, Topology):
        for t in plan.link.tiers:
            out[t.name] = 0.0
    for b in plan.buckets:
        for name, secs in bucket_sync_phases(
                b.compressor, b.compressor_args, b.algo, b.bucket_bytes,
                plan.world, plan.link, shard_state=plan.shard_state):
            out[name] = out.get(name, 0.0) + secs
    return out


def render_comm_plan(plan, baselines=None, t_backward_s=None,
                     total_label="modeled iteration",
                     auto_step_s=None) -> str:
    """Markdown rendering of a ``CommPlan`` (``--sync auto``, DESIGN.md §6):
    one row per bucket plus the plan's modeled time next to the fixed
    baselines the planner had to beat.  ``total_label`` names what
    ``plan.modeled_step_s`` is (an iteration for every-step plans, one
    reduce round for τ>1 round plans); ``auto_step_s`` overrides the
    denominator of the speedup column (the composite's AMORTIZED per-step
    time — dividing iteration baselines by a single round cost would
    overstate the win).

    On a tiered topology (DESIGN.md §10) the header lists every tier's
    (α, β) and the table grows PER-TIER BREAKDOWN rows: the serial sum
    of each bucket phase's cost, grouped by the tier it traverses (plus
    the compress/decompress compute) — the survey's "which link is the
    bottleneck" question answered per plan."""
    from repro_torch.core.schedule import Topology
    from repro_torch.core.schedule.cost import bucket_sync_cost_s

    world, link = plan.world, plan.link
    tiered = isinstance(link, Topology) and not link.is_flat
    lines = ["### Communication plan (auto-tuned)", ""]
    if tiered:
        tier_txt = " → ".join(
            f"{t.name}:{t.size} (α={t.link.alpha_s:.2e} s, "
            f"β⁻¹={_gbps(t.link):.2f} GB/s)"
            for t in link.tiers)
        lines.append(f"world={world}, topology {tier_txt}"
                     + (f", measured backward {t_backward_s * 1e3:.1f} ms"
                        if t_backward_s else ""))
        lines.append("")
    elif link is not None:
        if isinstance(link, Topology):
            link = link.tiers[0].link      # flat topology: one tier's link
        lines.append(f"world={world}, α={link.alpha_s:.2e} s, "
                     f"β⁻¹={_gbps(link):.2f} GB/s"
                     + (f", measured backward {t_backward_s * 1e3:.1f} ms"
                        if t_backward_s else ""))
        lines.append("")
    lines += ["| bucket | leaves | MiB | strategy | modeled comm |",
              "|---|---|---|---|---|"]
    for j, b in enumerate(plan.buckets):
        cost = ""
        if link is not None:
            # shard_state matters: sharded dense buckets pay the (half)
            # reduce-scatter inside the overlap window, not the allreduce
            c = bucket_sync_cost_s(b.compressor, b.compressor_args, b.algo,
                                   b.bucket_bytes, world, link,
                                   shard_state=plan.shard_state)
            cost = f"{c * 1e6:.1f} µs"
        lines.append(f"| {j} | {len(b.leaves)} | "
                     f"{b.bucket_bytes / 2**20:.2f} | "
                     f"{b.algo}/{b.compressor} | {cost} |")
    if tiered:
        for name, secs in tier_cost_breakdown(plan).items():
            lines.append(f"| — | — | — | tier {name} (all buckets, serial) "
                         f"| {secs * 1e6:.1f} µs |")
    if plan.shard_state and link is not None:
        from repro_torch.core.schedule.planner import shard_gather_tail_s
        tail = shard_gather_tail_s(plan, link, world)
        lines.append(f"| — | — | — | params all-gather tail (serial) | "
                     f"{tail * 1e6:.1f} µs |")
    lines += ["", f"{total_label}: {plan.modeled_step_s * 1e3:.3f} ms"]
    if baselines:
        step_s = plan.modeled_step_s if auto_step_s is None else auto_step_s
        lines += ["", "| fixed config | modeled iteration | auto speedup |",
                  "|---|---|---|"]
        for name, bp in sorted(baselines.items()):
            ratio = bp.modeled_step_s / max(step_s, 1e-12)
            lines.append(f"| {name} | {bp.modeled_step_s * 1e3:.3f} ms | "
                         f"{ratio:.2f}× |")
    return "\n".join(lines)


def render_strategy_plan(sp, arms=None, baselines=None,
                         t_backward_s=None) -> str:
    """Markdown rendering of a composite ``StrategyPlan`` (``--sync auto``
    over rounds × bits × overlap, DESIGN.md §7): the rounds-axis arms the
    planner scored, then the winning per-bucket comm plan next to the fixed
    baselines it must beat."""
    # only local_sgd arms carry a distinct per-round cost; for every_step /
    # pinned lag / push-pull the comm plan's time IS the iteration
    round_like = sp.schedule.kind == "local_sgd"
    detail = (f"one reduce round: {sp.round_cost_s * 1e3:.3f} ms, "
              if round_like else "")
    shard = " + shard_state (optimizer state 1/p)" if sp.shard_state else ""
    lines = ["### Sync strategy (auto-tuned: rounds × bits × overlap"
             " × shard × parallelism)", "",
             f"chosen arm: **{sp.key}{shard}** — "
             f"modeled {sp.modeled_step_s * 1e3:.3f} ms/step "
             f"({detail}backward {sp.t_backward_s * 1e3:.3f} ms)"]
    if sp.tp > 1 or sp.ep > 1:
        ax, n, tier = (("tp", sp.tp, sp.tp_tier) if sp.tp > 1
                       else ("ep", sp.ep, sp.ep_tier))
        wire = ("4 activation allreduces/layer, Megatron wire"
                if ax == "tp" else "4 all-to-alls/MoE layer "
                "(dispatch+combine, fwd+bwd)")
        placed = f" placed on tier {tier!r}" if tier else ""
        lines.append(
            f"parallelism: {sp.parallelism.spec()} — {ax}={n}{placed}, "
            f"model-axis comm {sp.model_comm_s * 1e3:.3f} ms/step "
            f"({wire}); the comm plan below is the DP edge over "
            f"world/{ax} replicas")
    if sp.pipeline_stages > 1:
        placed = (f" (pipe axis placed on tier {sp.pipe_tier!r}, DP edge "
                  f"on the remaining tiers)" if sp.pipe_tier else "")
        lines.append(
            f"pipeline: {sp.pipeline_stages} stages × {sp.micro_batches} "
            f"micro-batches — bubble {sp.bubble:.1%} "
            f"((S−1)/(S−1+M)), boundary p2p "
            f"{sp.pipe_p2p_s * 1e3:.3f} ms/step{placed}, per-stage opt "
            f"state {sp.opt_mem_bytes / 2**20:.1f} MiB/worker; the comm "
            f"plan below is the DP edge of the heaviest stage over "
            f"world/S replicas")
    if sp.shard_state and sp.opt_mem_bytes == sp.opt_mem_bytes:
        repl = (arms or {}).get("every_step")
        vs = (f" (replicated would be {repl.opt_mem_bytes / 2**20:.1f} MiB)"
              if repl is not None and repl.opt_mem_bytes ==
              repl.opt_mem_bytes else "")
        lines.append(f"optimizer state/worker: "
                     f"{sp.opt_mem_bytes / 2**20:.1f} MiB{vs}")

    def _mem(a):
        return (f"{a.opt_mem_bytes / 2**20:.1f} MiB"
                if a.opt_mem_bytes == a.opt_mem_bytes else "—")

    if arms and len(arms) > 1:
        lines += ["", "| arm | round cost | modeled /step | "
                  "opt state/worker |", "|---|---|---|---|"]
        for key, a in sorted(arms.items(),
                             key=lambda kv: kv[1].modeled_step_s):
            mark = " ←" if key == sp.key else ""
            lines.append(f"| {key}{mark} | {a.round_cost_s * 1e3:.3f} ms | "
                         f"{a.modeled_step_s * 1e3:.3f} ms | {_mem(a)} |")
    lines += ["", render_comm_plan(
        sp.comm, baselines=baselines, t_backward_s=t_backward_s,
        total_label=("modeled reduce round" if round_like
                     else "modeled iteration"),
        auto_step_s=sp.modeled_step_s)]
    return "\n".join(lines)


def render_serving_plan(best, arms, arch: str = "", batch: int = 0,
                        latency_budget_s=None) -> str:
    """Markdown rendering of a serving placement search
    (``planner.plan_serving``, DESIGN.md §12): every tp × tier arm the
    planner priced, best-throughput arm marked."""
    hdr = f" — {arch}" if arch else ""
    budget = (f", latency budget {latency_budget_s * 1e3:.2f} ms/step"
              if latency_budget_s is not None else "")
    lines = [f"### Serving placement (tp × tier × replicas){hdr}", "",
             f"chosen arm: **{best.key()}** — {best.step_s * 1e3:.3f} "
             f"ms/step, {best.tokens_per_s:,.0f} tok/s"
             f" at decode batch {batch}{budget}" if batch else
             f"chosen arm: **{best.key()}** — {best.step_s * 1e3:.3f} "
             f"ms/step, {best.tokens_per_s:,.0f} tok/s{budget}",
             "", "| arm | step | aggregate tok/s |", "|---|---|---|"]
    for a in sorted(arms, key=lambda a: -a.tokens_per_s):
        mark = " ←" if a.key() == best.key() else ""
        lines.append(f"| {a.key()}{mark} | {a.step_s * 1e3:.3f} ms | "
                     f"{a.tokens_per_s:,.0f} |")
    return "\n".join(lines)


def render_sharded_memory(layout, opt_name: str, moments=None) -> str:
    """One-line per-worker memory report for a sharded-DP run (the ZeRO
    identity): partitioned moments + f32 master shards vs the replicated
    moments footprint.  ``moments`` is the session's MEASURED buffer
    count (overrides the per-name default)."""
    rep = layout.opt_bytes_per_worker(opt_name, sharded=False,
                                      moments=moments)
    sh = layout.opt_bytes_per_worker(opt_name, sharded=True,
                                     moments=moments)
    if sh <= rep:
        verdict = f"{rep / max(sh, 1):.2f}× smaller"
    elif rep <= 0:
        # e.g. sgd with momentum=0: no replicated moment state at all —
        # a ratio is meaningless, the master shard is the whole cost
        verdict = ("pure master-shard cost (this optimizer keeps no "
                   "moment state)")
    else:
        # small worlds: the f32 master copy is added with little or no 1/p
        # benefit to divide it by — say so instead of "0.67x smaller"
        verdict = (f"{sh / max(rep, 1):.2f}× LARGER (world="
                   f"{layout.world}: the f32 master shard outweighs the "
                   f"1/p split)")
    return (f"optimizer state/worker: {sh / 2**20:.2f} MiB sharded "
            f"(master+moments over world={layout.world}) vs "
            f"{rep / 2**20:.2f} MiB replicated — {verdict}; params "
            f"{layout.param_bytes() / 2**20:.2f} MiB f32")


def render_moe_drops(dropped: float, routed: float,
                     capacity_factor: float) -> str:
    """One-line MoE capacity report of a training run: the routed
    token-choices that overflowed an expert's capacity buffer and were
    dropped (the reference's line)."""
    if routed <= 0:
        return "moe capacity: no tokens routed"
    frac = dropped / routed
    verdict = ("no overflow" if dropped == 0 else
               f"raise capacity_factor ({capacity_factor:g}) to shed drops")
    return (f"moe capacity: dropped {dropped:.0f}/{routed:.0f} routed "
            f"token-choices ({frac:.1%}) — {verdict}")


def render_pipeline_stages(staged, params_split, micro_batches: int,
                           moments=None) -> str:
    """Per-stage rows for an EXECUTED pipeline run (DESIGN.md §9): stage
    parameter / optimizer bytes (homogeneous stages: every stage holds
    R/S identical rows plus the shared cells) and the 1F1B bubble of the
    configured (S, M).  ``params_split`` is this stage's ``{"shared",
    "rows"}`` tree; the reference's table, line for line."""
    from repro_torch._tree import tree_leaves
    from repro_torch.core.pipeline import bubble_fraction

    lay = staged.layout
    S, M = lay.n_stages, int(micro_batches)
    mom = 2.0 if moments is None else float(moments)
    shared_b = sum(x.numel() * x.element_size()
                   for x in tree_leaves(params_split["shared"]))
    rows_b = S * sum(x.numel() * x.element_size()
                     for x in tree_leaves(params_split["rows"]))
    per_stage = rows_b / S + shared_b
    lines = [f"pipeline: {S} stages × {lay.rows_per_stage} layer rows, "
             f"{M} micro-batches — bubble {bubble_fraction(S, M):.1%} "
             f"((S−1)/(S−1+M))",
             "| stage | layer rows | params MiB | opt state MiB |",
             "|---|---|---|---|"]
    for s in range(S):
        lines.append(f"| {s} | {lay.rows_per_stage} | "
                     f"{per_stage / 2**20:.2f} | "
                     f"{mom * per_stage / 2**20:.2f} |")
    lines.append(f"(each stage replicates the shared cells — "
                 f"{shared_b / 2**20:.2f} MiB of embed/norm/head — and "
                 f"holds {rows_b / S / 2**20:.2f} MiB of its own rows)")
    return "\n".join(lines)


def _write_plan_record(rec: dict, arch: str) -> str:
    from repro_torch.launch.paths import COMM_PLANS
    os.makedirs(COMM_PLANS, exist_ok=True)
    path = os.path.join(COMM_PLANS, f"{arch}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


def save_comm_plan(plan, arch: str) -> str:
    """Write the plan record under artifacts/comm_plans_torch/ (called by the
    ``--sync auto`` path); returns the file path."""
    return _write_plan_record(comm_plan_record(plan), arch)


def save_strategy_plan(sp, arch: str, calibration=None, drift=None) -> str:
    """Write the composite-strategy record (rounds schedule + comm plan)
    under artifacts/comm_plans_torch/; returns the file path.
    ``calibration`` (a ``CalibratedTopology``) and ``drift``
    (``TrainSession.drift_report()``) add their blocks ONLY when present,
    so records written without them keep the exact pre-calibration
    schema."""
    rec = comm_plan_record(sp.comm)
    rec["schedule"] = {"kind": sp.schedule.kind, "period": sp.schedule.period}
    rec["modeled_step_s"] = sp.modeled_step_s
    rec["round_cost_s"] = sp.round_cost_s
    rec["t_backward_s"] = sp.t_backward_s
    rec["shard_state"] = sp.shard_state
    if sp.pipeline_stages > 1:
        rec["pipeline"] = {"stages": sp.pipeline_stages,
                           "micro_batches": sp.micro_batches,
                           "bubble_fraction": sp.bubble,
                           "p2p_cost_s": sp.pipe_p2p_s}
        if sp.pipe_tier:
            rec["pipeline"]["pipe_tier"] = sp.pipe_tier
    par = sp.parallelism
    if not par.is_trivial:
        # additive block (DESIGN.md §14): pure-dp records keep their exact
        # pre-existing key set (the schema-compat rule)
        rec["parallelism"] = par.to_record()
        if sp.model_comm_s:
            rec["parallelism"]["model_comm_s"] = sp.model_comm_s
    if sp.opt_mem_bytes == sp.opt_mem_bytes:   # not NaN
        rec["opt_mem_bytes_per_worker"] = sp.opt_mem_bytes
    if calibration is not None:
        cal = calibration.to_json()
        cal.pop("samples", None)    # raw timings live in the .cal file
        rec["calibration"] = cal
    if drift is not None:
        rec["drift"] = drift
    return _write_plan_record(rec, arch)


def render_drift_table(drift: dict) -> str:
    """The modeled↔measured closing table (``--calibrate`` /
    ``--replan-drift-pct`` epilogue): per-arm predicted wall step vs this
    run's measured median, drift %, and the error-budget verdict."""
    meas = drift["measured_step_s"]
    lines = [f"modeled vs measured ({drift['steps_measured']} steps, "
             f"median {meas * 1e3:.1f} ms/step):",
             "| arm | modeled ms | wall ms | measured ms | drift |",
             "|---|---|---|---|---|"]
    chosen = drift["plan_key"]
    for key, a in sorted(drift["arms"].items(),
                         key=lambda kv: kv[1]["modeled_wall_step_s"]):
        mark = " ←" if key == chosen else ""
        lines.append(f"| {key}{mark} | {a['modeled_step_s'] * 1e3:.1f} | "
                     f"{a['modeled_wall_step_s'] * 1e3:.1f} | "
                     f"{meas * 1e3:.1f} | {a['drift_pct']:+.1f}% |")
    err = drift["fit_error_s"]
    verdict = "within" if drift["within_fit_error"] else "OUTSIDE"
    lines.append(
        f"chosen arm drift {drift['drift_pct']:+.1f}% — {verdict} the "
        f"±{err * 1e3:.1f} ms error budget (comm fit "
        f"{drift['comm_fit_err_s'] * 1e3:.2f} + backward spread "
        f"{drift['t_backward_err_s'] * 1e3:.1f} + measurement spread "
        f"{drift['measured_spread_s'] * 1e3:.1f})")
    if drift["replans"]:
        for e in drift["replan_events"]:
            lines.append(f"replan @step {e['step']}: drift "
                         f"{e['drift_frac'] * 100:+.1f}% → {e['new_key']}"
                         + (" (installed)" if e["applied"]
                            else f" ({e['note']})"))
    return "\n".join(lines)


def render_elastic_events(events) -> str:
    """The elastic runtime's decision log (``--elastic`` epilogue): every
    reshard, backpressure demotion, and straggler re-plan with the world
    transition and surviving topology (DESIGN.md §15)."""
    if not events:
        return "elastic: no membership changes or straggler actions"
    lines = [f"elastic events ({len(events)}):",
             "| step | event | world | topology / plan | note |",
             "|---|---|---|---|---|"]
    for e in events:
        world = (f"{e.old_world}→{e.new_world}"
                 if e.new_world != e.old_world else f"{e.old_world}")
        what = e.topology or e.plan_key or "—"
        lines.append(f"| {e.step} | {e.kind} | {world} | {what} | "
                     f"{e.note} |")
    return "\n".join(lines)

def comm_plan_record(plan) -> dict:
    """JSON-serialisable record of a plan (written by ``save_comm_plan``).
    Tiered plans additionally record the topology and the per-tier cost
    breakdown; flat plans keep the exact pre-topology schema."""
    from repro_torch.core.schedule import Topology

    rec = {
        "world": plan.world,
        "modeled_step_s": plan.modeled_step_s,
        "shard_state": plan.shard_state,
        "n_buckets": plan.n_buckets,
        "buckets": [{
            "leaves": list(b.leaves),
            "bytes": b.bucket_bytes,
            "compressor": b.compressor,
            "compressor_args": dict(b.compressor_args),
            "algo": b.algo,
            "pack": b.pack,
        } for b in plan.buckets],
    }
    if isinstance(plan.link, Topology) and not plan.link.is_flat:
        rec["topology"] = {
            "spec": plan.link.spec(),
            "tiers": [{"name": t.name, "size": t.size,
                       "alpha_s": t.link.alpha_s,
                       "beta_s_per_byte": t.link.beta_s_per_byte}
                      for t in plan.link.tiers],
            "tier_cost_s": tier_cost_breakdown(plan),
        }
    return rec


# ---------------------------------------------------------------------------
# The dry run's tables (reference report.py:18, 40)
# ---------------------------------------------------------------------------

def dryrun_table() -> str:
    """One row per record of both meshes: the trace's seconds (the
    reference's compile seconds), HBM a rank (arguments + temp), dot
    TFLOP, wire GB and the collectives' counts."""
    from repro_torch.launch.roofline import load_records
    lines = ["| arch | shape | mesh | trace s | HBM/chip GiB (args+temp) | "
             "dot TF/chip | wire GB/chip | collectives (AG/AR/RS/A2A/CP) |",
             "|---|---|---|---|---|---|---|---|"]
    for mesh in ("16x16", "2x16x16"):
        for rec in load_records(mesh):
            mem = rec["memory_analysis"]
            hbm = (mem.get("argument_size_in_bytes", 0)
                   + mem.get("temp_size_in_bytes", 0)) / 2**30
            cc = rec["hlo"]["collective_counts"]
            counts = "/".join(str(cc.get(k, 0)) for k in (
                "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute"))
            lines.append(
                f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} | "
                f"{rec['trace_s']:.0f} | {hbm:.1f} | "
                f"{rec['hlo']['dot_flops_per_device']/1e12:.2f} | "
                f"{rec['hlo']['collective_wire_bytes_per_device']/1e9:.2f} | "
                f"{counts} |")
    return "\n".join(lines)


def variants_table() -> str:
    """Baseline vs every other traced variant at ``16x16``; "—" where the
    baseline moves no wire (a serving step)."""
    from repro_torch.launch import roofline
    lines = ["| arch | shape | variant | dot TF/chip | wire GB/chip | "
             "HBM GiB | Δwire vs baseline |",
             "|---|---|---|---|---|---|---|"]
    base = {}
    rows = []
    for path in sorted(glob.glob(os.path.join(roofline.DRYRUN,
                                              "*_16x16_*.json"))):
        with open(path) as f:
            rec = json.load(f)
        key = (rec["arch"], rec["shape"])
        if rec["variant"] == "baseline":
            base[key] = rec
        else:
            rows.append(rec)
    for rec in rows:
        key = (rec["arch"], rec["shape"])
        b = base.get(key)
        mem = rec["memory_analysis"]
        hbm = (mem.get("argument_size_in_bytes", 0)
               + mem.get("temp_size_in_bytes", 0)) / 2**30
        wire = rec["hlo"]["collective_wire_bytes_per_device"]
        delta = ""
        if b:
            bw = b["hlo"]["collective_wire_bytes_per_device"]
            if bw == 0:            # no ratio (the reference divides by 0)
                delta = "—"
            else:
                delta = f"{bw / wire:.0f}× less" if wire < bw else \
                    f"{wire / bw:.2f}× more"
        lines.append(
            f"| {rec['arch']} | {rec['shape']} | {rec['variant']} | "
            f"{rec['hlo']['dot_flops_per_device']/1e12:.3f} | "
            f"{wire/1e9:.3f} | {hbm:.1f} | {delta} |")
    return "\n".join(lines)


CARD_BYTES = 80e9        # an H100 80GB HBM3's memory


def rank_bytes(rec) -> int:
    """What a record's rank holds at its peak: arguments + temp + the
    outputs not written in place over an argument."""
    m = rec["memory_analysis"]
    return (m.get("argument_size_in_bytes", 0)
            + m.get("temp_size_in_bytes", 0)
            + m.get("output_size_in_bytes", 0)
            - m.get("alias_size_in_bytes", 0))


def layout_cells(rec) -> tuple:
    """The record's layout in three cells: tp (and the head blocks where
    attention runs over fewer), the decode cache's split per layer kind
    ("kv": kv heads over the model axis, "L/<axes>": the length over
    them, "whole") with the positions a rank holds, and ep."""
    lay = rec.get("layout", {})
    tp = str(lay.get("tp", 1))
    if lay.get("attn_tp", lay.get("tp", 1)) != lay.get("tp", 1):
        tp += f" (attn {lay['attn_tp']})"
    cache = []
    for kind, c in (lay.get("cache") or {}).items():
        where = "kv" if c["kv_heads"] else \
            "L/" + "×".join(c["length_over"]) if c["length_over"] else "whole"
        cache.append(f"{kind}: {where} {c['positions_per_rank']}")
    return tp, "; ".join(cache) or "—", str(lay.get("ep", 1))


def summary_table(mesh: str = "16x16") -> str:
    """One row per baseline record: the trace's seconds on the host, the
    rank's layout (:func:`layout_cells`), the rank's GB and whether it
    fits one card's 80 GB, dot TFLOP, wire GB, and the roofline terms
    (modeled, with ``launch/roofline.py``'s H100 constants; ``memory s``
    from the reference's analytic traffic model, ``traced bytes s`` from
    the rank's fusion-less bytes, ``collective s`` from the wire on each
    mesh axis, serve records as train ones)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.roofline import load_records, terms
    lines = ["| arch | shape | trace s | tp | cache split, positions a rank "
             "| ep | rank GB | fits 80 GB | dot TF | "
             "wire GB | compute s | memory s | traced bytes s | "
             "collective s | dominant |",
             "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for rec in load_records(mesh):
        t = terms(rec, get_config(rec["arch"]), SHAPES[rec["shape"]])
        need = rank_bytes(rec)
        tp, cache, ep = layout_cells(rec)
        lines.append(
            f"| {rec['arch']} | {rec['shape']} | {rec['trace_s']:.1f} | "
            f"{tp} | {cache} | {ep} | "
            f"{need / 1e9:.1f} | {'yes' if need <= CARD_BYTES else 'no'} | "
            f"{rec['hlo']['dot_flops_per_device'] / 1e12:.1f} | "
            f"{rec['hlo']['collective_wire_bytes_per_device'] / 1e9:.2f} | "
            f"{t['compute_s']:.3g} | {t['memory_s']:.3g} | "
            f"{t['hlo_memory_s_upper']:.3g} | {t['collective_s']:.3g} | "
            f"{t['dominant']} |")
    return "\n".join(lines)


def main(argv=None) -> None:
    """Print the dry-run table, the roofline table with its notes at
    ``16x16``, and the variants table (the reference's ``main`` writes
    them into its EXPERIMENTS.md, which this repository does not have),
    then the per-rank summary (:func:`summary_table`)."""
    import argparse

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.roofline import (load_records, render_table,
                                             terms)
    argparse.ArgumentParser(prog="python -m repro_torch.launch.report"
                            ).parse_args(argv)
    recs = load_records("16x16")
    notes = "\n".join(
        f"- **{r['arch']} × {r['shape']}**: dominant="
        f"{terms(r, get_config(r['arch']), SHAPES[r['shape']])['dominant']}"
        for r in recs)
    print("### Dry run\n\n" + dryrun_table() + "\n")
    print("### Roofline (modeled: H100 data-sheet constants)\n\n"
          + render_table(recs) + "\n\n" + notes + "\n")
    print("### All traced variants vs baseline\n\n" + variants_table() + "\n")
    print("### Per rank at 16x16 (roofline modeled with the H100 data-sheet "
          "constants)\n\n" + summary_table())


if __name__ == "__main__":
    main()
