"""Plan tables and plan records of the port's ``--sync auto`` and
``serve --plan`` paths: the part of ``repro/launch/report.py`` that the
planner calls (the per-tier cost breakdown, the markdown plan tables, the
JSON plan record).  Records go to ``artifacts/comm_plans_torch/<arch>.json``
(``launch/paths.py``).  The dry-run and roofline tables are ROADMAP.md
queue 1, item 14; the calibration and drift blocks, item 11.
"""
from __future__ import annotations

import json
import os


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
            f"β⁻¹={1 / t.link.beta_s_per_byte / 1e9:.2f} GB/s)"
            for t in link.tiers)
        lines.append(f"world={world}, topology {tier_txt}"
                     + (f", measured backward {t_backward_s * 1e3:.1f} ms"
                        if t_backward_s else ""))
        lines.append("")
    elif link is not None:
        if isinstance(link, Topology):
            link = link.tiers[0].link      # flat topology: one tier's link
        lines.append(f"world={world}, α={link.alpha_s:.2e} s, "
                     f"β⁻¹={1 / link.beta_s_per_byte / 1e9:.2f} GB/s"
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


def save_strategy_plan(sp, arch: str) -> str:
    """Write the composite-strategy record (rounds schedule + comm plan)
    under artifacts/comm_plans_torch/; returns the file path."""
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
    return _write_plan_record(rec, arch)


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
