"""α-β (latency-bandwidth) communication cost model (survey §4.1/§4.3); a
copy of ``repro/core/schedule/cost.py`` with ``resolve_cost_table`` from
``calibration.py``, held to it by ``tests/test_torch_planner.py``.  The
compressed wires take ``payload_bits`` / ``aggregatable`` from the port's
compressors.

This module is the single home of the analytic cost model: the survey's
Fig. 10/12 comparisons and the §4.3 protocol study are parameter sweeps over
it, and the communication planner (``schedule/planner.py``) uses it as the
objective when choosing a per-bucket sync strategy.  It used to live inside
``collectives/api.py``; the dispatch module re-exports it for compatibility.

Every cost function takes a *network* argument ``net`` that is either a
bare :class:`LinkParams` (one flat link — the historical model) or a
:class:`~repro_torch.core.schedule.topology.Topology` (ordered tiers, outermost
first).  Each algorithm phase is priced on the tier it actually traverses
(DESIGN.md §10):

  * ring / psum / gather — lockstep flat traversals: every synchronous
    step is gated by the slowest link the embedded ring crosses, i.e. the
    topology's bottleneck tier (Zhang et al. 2020);
  * tree — log2(size) doubling rounds per tier, full payload each;
  * hierarchical — inner ring on the innermost (fast) tier, the shard
    ring on the outermost (slow) tier (Jia et al. 2018);
  * mesh2d — one ring phase per perpendicular axis: the first on the
    inner tier, the second on the outer (Ying et al. 2018);
  * p2p — the tier the pipe axis lands on (outermost by default).

On ``Topology.flat`` (or a bare ``LinkParams``) every formula reduces to
the pre-topology expression BIT-FOR-BIT — ``tests/test_topology.py`` pins
this, and it is what keeps the committed ``benchmarks/baselines/*.json``
green.

Message libraries and protocols (§4.2/§4.3) appear only through their α
(per-message latency) and β (inverse bandwidth) parameters — on TPU the
"protocol" layer is ICI and lives below XLA (DESIGN.md §5).

Costs for *compressed* exchanges are priced at the survey's wire metric —
``Compressor.payload_bits`` — i.e. the bytes an ideal message library would
move.  See DESIGN.md §5 for how the reference executor realises each wire
pattern.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core.schedule.topology import Tier, Topology, as_topology


@dataclasses.dataclass(frozen=True)
class LinkParams:
    alpha_s: float = 1e-6       # per-message latency (s)
    beta_s_per_byte: float = 1.0 / 50e9   # inverse link bandwidth (s/B)


# Canonical network regimes (survey Fig. 8/10/12 sweeps).  Benchmarks and the
# planner share these so the "fast_ici" of one table is the "fast_ici" of
# another — previously each bench re-typed its own (α, β) literals.
LINK_PRESETS: Dict[str, LinkParams] = {
    "fast_ici": LinkParams(alpha_s=1e-6, beta_s_per_byte=1 / 50e9),
    "datacenter": LinkParams(alpha_s=5e-6, beta_s_per_byte=1 / 10e9),
    "commodity": LinkParams(alpha_s=50e-6, beta_s_per_byte=1 / 1.25e9),
}

Net = Union[LinkParams, Topology]


def allreduce_phases(algo: str, n_bytes: float, p: int, net: Net,
                     k: Optional[int] = None) -> List[Tuple[str, float]]:
    """Per-phase costs of one allreduce: ``[(tier_name, seconds), ...]``,
    each phase on the tier it traverses.  The totals below are the
    left-fold sum of these phases, so breakdown and total always agree."""
    if p <= 1:
        return []
    topo = as_topology(net, p)
    if algo == "ring" or algo == "psum":
        t = topo.bottleneck(n_bytes / p)
        a, b = t.link.alpha_s, t.link.beta_s_per_byte
        return [(t.name, 2 * (p - 1) * (a + (n_bytes / p) * b))]
    if algo == "tree":
        return [(t.name, 2 * np.log2(t.size)
                 * (t.link.alpha_s + n_bytes * t.link.beta_s_per_byte))
                for t in topo.tiers if t.size > 1]
    if algo == "hierarchical":
        inner_t = topo.innermost
        # k defaults to the innermost tier (the executed inner ring runs
        # on exactly that axis); an explicit k is a flat-network knob
        k = k or (int(np.sqrt(p)) if topo.is_flat else inner_t.size)
        ai, bi = inner_t.link.alpha_s, inner_t.link.beta_s_per_byte
        phases = [(inner_t.name, 2 * (k - 1) * (ai + (n_bytes / k) * bi))]
        if topo.is_flat:
            ao, bo = ai, bi
            phases.append((inner_t.name, 2 * (p // k - 1)
                           * (ao + (n_bytes / k / (p // k)) * bo)))
        else:
            # the n/k shard rings over EVERY outer tier in turn (matching
            # hierarchical_allreduce's outer loop), innermost outer first
            # — pricing only the outermost would hide middle tiers
            for t in reversed(topo.tiers[:-1]):
                at, bt = t.link.alpha_s, t.link.beta_s_per_byte
                phases.append((t.name, 2 * (t.size - 1)
                               * (at + (n_bytes / k / t.size) * bt)))
        phases.append((inner_t.name, 2 * (k - 1) * ai))  # broadcast latency
        return phases
    if algo in ("mesh2d", "mesh2d_split"):
        if topo.n_tiers > 2:
            # mesh2d is 2-D by construction (execution raises too); the
            # planner filters these candidates out (_algo_usable)
            raise ValueError(f"mesh2d is a two-axis collective; topology "
                             f"{topo.spec()} has {topo.n_tiers} tiers")
        inner_t, outer_t = topo.innermost, topo.outermost
        px = int(np.sqrt(p)) if topo.is_flat else topo.inner_size
        py = p // px
        ai, bi = inner_t.link.alpha_s, inner_t.link.beta_s_per_byte
        ao, bo = outer_t.link.alpha_s, outer_t.link.beta_s_per_byte
        div = 2 if algo == "mesh2d_split" else 1
        return [(inner_t.name,
                 2 * (px - 1) * (ai + (n_bytes / px) * bi) / div),
                (outer_t.name,
                 2 * (py - 1) * (ao + (n_bytes / px / py) * bo) / div)]
    raise ValueError(algo)


def allreduce_cost_s(algo: str, n_bytes: float, p: int, net: Net,
                     k: Optional[int] = None) -> float:
    """Predicted wall time of one allreduce of n_bytes over p ranks.

    ring:          2(p-1) steps of n/p bytes (on the bottleneck tier)
    tree (PS):     2 log2(size) steps of n bytes per tier
    hierarchical:  intra ring over k on the inner tier + inter ring over
                   p/k on n/k shards on the outer tier
                   (Jia et al.: 4(k-1) + 2(p/k - 1) steps)
    mesh2d:        two perpendicular ring phases (inner axis on the inner
                   tier, outer axis on the outer tier)
    """
    return sum((c for _, c in allreduce_phases(algo, n_bytes, p, net, k)),
               0.0)


def reduce_scatter_cost_s(algo: str, n_bytes: float, p: int,
                          net: Net) -> float:
    """One reduce-scatter of ``n_bytes`` (each rank keeps 1/p): (p-1)
    steps of n/p — the bandwidth-optimal (p-1)/p·n edge that ZeRO-style
    sharded DP pays instead of the allreduce's 2(p-1)/p·n.

    Priced as the RING reduce half for EVERY algo, because that is what
    ``collectives.reduce_scatter`` executes: explicit algos run the ring
    (nested per axis), and the psum algo delegates to XLA, whose
    reduce-scatter is ring-equivalent.  Pricing the named algo's allreduce
    half instead would let the planner pick e.g. a latency-optimal tree
    bucket whose sharded execution is actually a (p-1)-hop ring — the
    modeled/executed gap the conformance work exists to prevent."""
    del algo
    return allreduce_cost_s("ring", n_bytes, p, net) / 2.0


def shard_gather_cost_s(algo: str, n_bytes: float, p: int,
                        net: Net) -> float:
    """All-gather of partitioned state totalling ``n_bytes`` (each rank
    contributes n/p) — the forward-edge params gather of sharded DP.
    Ring-priced for every algo, mirroring :func:`reduce_scatter_cost_s`
    (the executed gather is a ring / XLA's ring-equivalent)."""
    del algo
    return allreduce_cost_s("ring", n_bytes, p, net) / 2.0


def p2p_cost_s(n_bytes: float, net: Net,
               tier: Optional[Union[int, str]] = None) -> float:
    """One point-to-point transfer of ``n_bytes`` (α + nβ) — the pipeline
    boundary edge: one micro-batch of activations (forward) or
    grad-activations (backward) crossing one stage cut (DESIGN.md §9).
    On a tiered network the edge is priced on the tier the ``pipe`` axis
    lands on — ``tier`` by index or name, defaulting to the OUTERMOST
    (pipeline across nodes, the placement that keeps the dense gradient
    ring on the fast tier)."""
    if isinstance(net, Topology):
        t = net.outermost
        if tier is not None:
            if isinstance(tier, str):
                match = [x for x in net.tiers if x.name == tier]
                if not match:
                    raise ValueError(f"no tier named {tier!r} in "
                                     f"{net.spec()}")
                t = match[0]
            else:
                t = net.tiers[tier]
        link = t.link
    else:
        link = net
    return link.alpha_s + n_bytes * link.beta_s_per_byte


def allgather_cost_s(n_bytes: float, p: int, net: Net) -> float:
    """Ring all-gather where every rank contributes ``n_bytes``: (p-1) steps
    each moving one rank's payload (the gather-based compressor wire
    pattern of 1-bit SGD / DGC, DESIGN.md §5) — a lockstep flat traversal,
    gated by the bottleneck tier like the ring."""
    if p <= 1:
        return 0.0
    link = as_topology(net, p).bottleneck(n_bytes).link
    return (p - 1) * (link.alpha_s + n_bytes * link.beta_s_per_byte)


def straggler_penalty_s(skew_s: float, rounds_per_step: float = 1.0) -> float:
    """Per-step cost of a straggling worker under a given round cadence
    (survey §3.1.2 — the stale-synchronous motivation): a lockstep
    collective waits for its slowest member, so every ROUND that actually
    runs pays the measured worst-vs-median step-time skew ``skew_s``.  A
    schedule running ``rounds_per_step`` global rounds per step therefore
    pays ``skew_s · rounds_per_step``: every-step BSP eats the full skew
    each step, a local-SGD τ arm amortizes it τ× — which is exactly the
    cadence-demotion lever the elastic runtime's backpressure exercises
    (``plan_rounds(..., straggler_s=)`` adds this term to every arm, so a
    persistent straggler can flip the planner's winner; DESIGN.md §15).
    Zero skew prices to exactly 0.0, keeping straggler-free plans
    bit-identical to the committed baselines."""
    if skew_s <= 0.0:
        return 0.0
    return float(skew_s) * max(float(rounds_per_step), 0.0)


def _resolve_tier(topo: Topology, tier: Optional[Union[int, str]],
                  m_bytes: float) -> Tier:
    """Tier selection shared by the placed-axis cost functions: by index
    or name when the caller placed the axis, else the bottleneck tier of
    a flat traversal moving ``m_bytes`` per step."""
    if tier is None:
        return topo.bottleneck(m_bytes)
    if isinstance(tier, str):
        match = [t for t in topo.tiers if t.name == tier]
        if not match:
            raise ValueError(f"no tier named {tier!r} in {topo.spec()}")
        return match[0]
    return topo.tiers[tier]


def all_to_all_cost_s(n_bytes: float, p: int, net: Net,
                      variant: str = "direct",
                      tier: Optional[Union[int, str]] = None) -> float:
    """One all-to-all where every rank holds ``n_bytes`` total and sends
    an equal ``n_bytes/p`` chunk to each peer — the expert dispatch /
    combine edge of MoE expert parallelism (survey §4; DESIGN.md §14).

      * ``direct`` — all pairs exchange concurrently (XLA's fused
        all-to-all): one launch latency, but a rank's NIC still serialises
        its (p-1) outgoing chunks: α + (p-1)·(n/p)·β.
      * ``ring`` — (p-1) ppermute rotations of one chunk each (what
        ``collectives.api.all_to_all(variant="ring")`` executes):
        (p-1)·(α + (n/p)·β) — the same bytes, (p-2) extra message
        latencies, so direct ≤ ring always and the gap is α-dominated
        (the planner's variant choice is a latency/topology call, not a
        bandwidth one).

    On a tiered network the edge is priced on the tier the ``ep`` axis
    was placed on (``tier`` by index or name — ``Topology.place``
    semantics), defaulting to the bottleneck tier of a flat traversal."""
    if p <= 1:
        return 0.0
    if variant not in ("direct", "ring"):
        raise ValueError(f"unknown all_to_all variant {variant!r}; "
                         f"known: ('direct', 'ring')")
    # like p2p_cost_s, the net here may be a FULL topology whose world
    # exceeds p (the ep axis is a placed sub-group of it) — resolve the
    # tier directly instead of as_topology's world check
    inner = getattr(net, "topology", None)
    if isinstance(inner, Topology):
        net = inner
    topo = net if isinstance(net, Topology) else Topology.flat(p, net)
    t = _resolve_tier(topo, tier, n_bytes / p)
    a, b = t.link.alpha_s, t.link.beta_s_per_byte
    chunk = n_bytes / p
    if variant == "ring":
        return (p - 1) * (a + chunk * b)
    return a + (p - 1) * chunk * b


# Effective HBM bandwidth for weight-streaming decode (B/s).  Incremental
# decode is memory-bound: every step reads the full (TP-sharded) parameter
# set once, so compute time is param_bytes / bandwidth, not a FLOP count.
DECODE_HBM_BW = 800e9


def decode_step_cost_s(param_bytes: float, n_layers: int, d_model: int,
                       batch: int, tp: int, net: Net, *,
                       act_bytes: int = 2,
                       hbm_bw: float = DECODE_HBM_BW) -> float:
    """Predicted wall time of ONE batched decode step under ``tp``-way
    tensor parallelism (DESIGN.md §12).

    Compute is weight streaming — each rank reads its ``param_bytes/tp``
    shard once per token — and communication is the Megatron pattern: two
    allreduces per layer of the ``(batch, d_model)`` activations, priced
    by :func:`allreduce_cost_s` on whatever tier ``net`` places the TP
    group on.  Tiny payloads make this α-dominated, which is why the
    serving planner pins TP groups to the fastest tier."""
    if tp < 1:
        raise ValueError("tp must be >= 1")
    step = param_bytes / (tp * hbm_bw)
    if tp > 1:
        act = float(batch) * d_model * act_bytes
        step += 2 * n_layers * allreduce_cost_s("ring", act, tp, net)
    return step


def compressed_wire_bytes(compressor: str, compressor_args: Tuple[Tuple[str, Any], ...],
                          n_elems: int) -> float:
    """Per-rank wire bytes for one fused bucket of ``n_elems`` f32 values
    under ``compressor`` — ``payload_bits`` / 8, the survey's metric."""
    from repro_torch.core.compression import get_compressor
    comp = get_compressor(compressor, **dict(compressor_args))
    return comp.payload_bits((int(n_elems),)) / 8.0


# Effective processing bandwidth of the compress/decompress kernels (B/s of
# dense input).  Compression is NOT free: quantize/top-k are memory-bound
# passes over the bucket, and pricing them is what makes the planner prefer
# dense exchanges on fast links (where the α-β savings cannot pay for the
# extra passes) and compression on slow ones — the survey's Fig. 7/8 story.
COMPRESS_PROC_BW = 30e9

# Phase label for compress/decompress time in per-tier breakdowns: it is
# device compute, not wire time on any tier.
COMPUTE_PHASE = "compute"

# Per-tile f32 scale overhead of the fused int8 wire (DESIGN.md §11) —
# shared with the ring_fused hop pricing below.
FUSED_TILE = 8 * 128


@dataclasses.dataclass(frozen=True)
class CompressionCostTable:
    """MEASURED compression-compute costs — the first measured input into
    the planner (Zhang et al. 2020: modeled α-β costs diverge from
    measurement exactly where per-step compute overheads dominate).

    ``entries`` holds linear fits ``seconds = n_bytes / bw + c0`` keyed
    ``"{compressor}/{encode|decode}"`` against the DENSE bucket bytes:

      * ``encode`` — the full send-side pass (EF add + compress + residual
        update for EF wires);
      * ``decode`` — the full receive-side pass at the calibration world
        size (``calibration.CAL_WORLD``): one decompress for aggregatable
        wires, the decompress+accumulate over all gathered payloads for
        gather-pattern wires (scaled linearly in p when priced at other
        world sizes).

    Produced by ``schedule.calibration.measure_compression_costs`` (and
    recorded by ``benchmarks/bench_collectives.py``); consumed by
    :func:`bucket_sync_phases` via the ``cost_table`` argument, replacing
    the hand-waved ``COMPRESS_PROC_BW`` term for compressors it covers.

    ``quality`` carries per-key fit diagnostics — ``(key, rms_s, r2,
    degenerate)`` — so a table whose fits degenerated under timing noise
    says so (DESIGN.md §13); it rides separately from ``entries`` to keep
    every existing 3-tuple consumer intact.  Recorded files are VERSIONED
    (``SCHEMA_VERSION``): v2+ files require ``cal_world`` — the
    gather-decode rescale in :func:`_compute_cost_s` is wrong at any
    other world, so a stale hand-edited file must fail loudly; legacy
    unversioned files warn and keep the historical default.
    """
    SCHEMA_VERSION = 2

    entries: Tuple[Tuple[str, float, float], ...] = ()
    cal_world: int = 8
    quality: Tuple[Tuple[str, float, float, bool], ...] = ()

    def stage_s(self, compressor: str, stage: str,
                n_bytes: float) -> Optional[float]:
        key = f"{compressor}/{stage}"
        for k, bw, c0 in self.entries:
            if k == key:
                return float(n_bytes) / bw + c0
        return None

    def fit_quality(self, key: str) -> Optional[Tuple[float, float, bool]]:
        """(rms_s, r2, degenerate) of the fit behind ``key``, if the
        table recorded it."""
        for k, rms, r2, deg in self.quality:
            if k == key:
                return rms, r2, deg
        return None

    def to_json(self) -> Dict[str, Any]:
        q = {k: (rms, r2, deg) for k, rms, r2, deg in self.quality}
        entries = []
        for k, bw, c0 in self.entries:
            e: Dict[str, Any] = {"key": k, "bw_bytes_per_s": bw,
                                 "overhead_s": c0}
            if k in q:
                rms, r2, deg = q[k]
                e.update(fit_rms_s=rms, fit_r2=r2, fit_degenerate=deg)
            entries.append(e)
        return {"version": self.SCHEMA_VERSION,
                "cal_world": self.cal_world, "entries": entries}

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "CompressionCostTable":
        import warnings
        version = int(obj.get("version", 1))
        if version >= 2:
            if "cal_world" not in obj:
                raise ValueError(
                    "compression cost table (schema v2+) is missing the "
                    "required 'cal_world' field; the gather-decode rescale "
                    "is wrong without the calibration world — re-record "
                    "with bench_collectives --write-compression-costs")
            cal_world = int(obj["cal_world"])
        elif "cal_world" in obj:
            cal_world = int(obj["cal_world"])
        else:
            warnings.warn(
                "legacy compression-cost table has no 'cal_world'; "
                "assuming the historical default 8 — gather-decode costs "
                "may be rescaled from the wrong world, re-record the "
                "table", stacklevel=2)
            cal_world = 8
        entries, quality = [], []
        for e in obj.get("entries", []):
            entries.append((e["key"], float(e["bw_bytes_per_s"]),
                            float(e["overhead_s"])))
            if "fit_rms_s" in e:
                quality.append((e["key"], float(e["fit_rms_s"]),
                                float(e.get("fit_r2", float("nan"))),
                                bool(e.get("fit_degenerate", False))))
        return cls(entries=tuple(entries), cal_world=cal_world,
                   quality=tuple(quality))

    def save(self, path: str) -> None:
        import json
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "CompressionCostTable":
        import json
        with open(path) as f:
            return cls.from_json(json.load(f))


def resolve_cost_table(spec) -> Optional[CompressionCostTable]:
    """Coerce a ``compression_costs`` argument — ``None``, an existing
    table, or a path to a recorded JSON — into a table."""
    if spec is None or isinstance(spec, CompressionCostTable):
        return spec
    return CompressionCostTable.load(spec)


def bucket_sync_cost_s(compressor: str, compressor_args: Tuple[Tuple[str, Any], ...],
                       algo: str, n_bytes: float, p: int, net: Net,
                       proc_bw: float = COMPRESS_PROC_BW,
                       shard_state: bool = False,
                       cost_table: Optional[CompressionCostTable] = None
                       ) -> float:
    """Predicted wall time to synchronise ONE fused gradient bucket of
    ``n_bytes`` (dense f32) across ``p`` ranks with the given strategy.

      * dense ("none"):         one allreduce of n_bytes on ``algo``
      * aggregatable payloads:  one allreduce of the compressed bytes, plus
                                one compress + one decompress pass
      * gather-based payloads:  ring all-gather of the compressed bytes,
                                plus one compress pass and p per-rank
                                decompress/accumulate passes over the
                                compact payloads (the DGC pattern)

    ``shard_state=True`` prices the sharded-DP SCATTER edge instead: dense
    exchanges become reduce-scatters (half the allreduce — each rank only
    needs its owned chunk of the sum); compressed exchanges are unchanged
    (gather-based payloads already all-gather the compressed bytes, and
    aggregatable factorizations must be fully visible on every rank to
    rebuild the approximation — sharding only changes which slice a rank
    keeps).  The params all-gather on the forward edge is priced separately
    (``shard_gather_cost_s``) because it cannot overlap the backward.

    Defined as the sum of :func:`bucket_sync_phases` — ONE copy of the
    wire-pattern branching, so the per-tier breakdown rows in the plan
    report always reconcile with the modeled totals exactly."""
    return sum((s for _, s in bucket_sync_phases(
        compressor, compressor_args, algo, n_bytes, p, net,
        proc_bw=proc_bw, shard_state=shard_state,
        cost_table=cost_table)), 0.0)


def _compute_cost_s(compressor: str, n_bytes: float, p: int,
                    aggregatable: bool, c_bytes: float, proc_bw: float,
                    cost_table: Optional[CompressionCostTable]) -> float:
    """The compress/decompress compute term of one bucket sync: the
    MEASURED fit when ``cost_table`` covers the compressor (encode +
    decode, the latter scaled linearly from the calibration world to p
    for gather-pattern wires whose decode walks all p payloads), else the
    analytic ``COMPRESS_PROC_BW`` pass-count model."""
    if cost_table is not None:
        enc = cost_table.stage_s(compressor, "encode", n_bytes)
        dec = cost_table.stage_s(compressor, "decode", n_bytes)
        if enc is not None and dec is not None:
            if not aggregatable:
                dec = dec * (p / float(max(cost_table.cal_world, 1)))
            return enc + dec
    if aggregatable:
        return 2 * n_bytes / proc_bw
    return (n_bytes + p * c_bytes) / proc_bw


def bucket_sync_phases(compressor: str,
                       compressor_args: Tuple[Tuple[str, Any], ...],
                       algo: str, n_bytes: float, p: int, net: Net,
                       proc_bw: float = COMPRESS_PROC_BW,
                       shard_state: bool = False,
                       cost_table: Optional[CompressionCostTable] = None
                       ) -> List[Tuple[str, float]]:
    """Per-tier breakdown of :func:`bucket_sync_cost_s` — one
    ``(tier_name, seconds)`` entry per wire phase plus a ``"compute"``
    entry for compress/decompress time.  Feeds the per-tier rows of the
    plan report and the plan record (DESIGN.md §10).

    ``cost_table`` (a :class:`CompressionCostTable`) replaces the analytic
    ``proc_bw`` compute term with measured per-compressor fits — the
    planner's first measured input (``plan_auto(compression_costs=...)``).
    """
    if p <= 1:
        return []
    topo = as_topology(net, p)
    if algo == "ring_fused":
        # Compressed ring (collectives/ring_fused.py): the ring's wire
        # phases at the int8 payload size (~n/4 + per-tile scales, per-hop
        # requantization included in the wire bytes), with the per-hop
        # compress/decompress OVERLAPPED against the permutes by the
        # double-buffered schedule — the compute term charges only the
        # pipeline fill (1/p of the bucket's encode+decode), measured
        # from the int8_fused fits when a cost table is supplied.
        n_elems = max(int(n_bytes // 4), 1)
        ring_bytes = n_elems * 1.0 + 4.0 * float(-(-n_elems // FUSED_TILE))
        phases = allreduce_phases("ring", ring_bytes, p, net)
        fill = _compute_cost_s("int8_fused", n_bytes, p, True, ring_bytes,
                               proc_bw, cost_table) / p
        return phases + [(COMPUTE_PHASE, fill)]
    if compressor == "none":
        if shard_state:
            # reduce-scatter = the ring reduce half, on the ring's tier
            return [(name, c / 2.0) for name, c
                    in allreduce_phases("ring", n_bytes, p, net)]
        return allreduce_phases(algo, n_bytes, p, net)
    from repro_torch.core.compression import get_compressor
    comp = get_compressor(compressor, **dict(compressor_args))
    n_elems = int(n_bytes // 4)
    c_bytes = comp.payload_bits((max(n_elems, 1),)) / 8.0
    compute = _compute_cost_s(compressor, n_bytes, p, comp.aggregatable,
                              c_bytes, proc_bw, cost_table)
    if comp.aggregatable:
        return (allreduce_phases(algo, c_bytes, p, net)
                + [(COMPUTE_PHASE, compute)])
    return [(topo.bottleneck(c_bytes).name, allgather_cost_s(c_bytes, p, net)),
            (COMPUTE_PHASE, compute)]
