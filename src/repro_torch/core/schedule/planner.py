"""Communication planner: per-bucket auto-tuned sync strategies (§3.3 + §4.1);
a copy of ``repro/core/schedule/planner.py`` whose decisions
``tests/test_torch_planner.py`` holds equal to the reference's.

The survey's central observation is that the best communication strategy is a
function of message size, topology, and link parameters — compression wins on
slow links and big tensors, latency-optimal collectives win on small messages,
and the right fusion granularity (MG-WFBP, Shi et al. 2019) depends on the
α/β balance.  This module closes that loop: it turns the α-β cost model
(``schedule/cost.py``) and the WFBP overlap simulation (``schedule/
perf_model.py``) from analysis-only code into the runtime's decision engine.

A ``CommPlan`` is an ordered list of ``BucketPlan`` entries, each naming the
gradient leaves it fuses plus the (compressor × collective algo) pair chosen
for that bucket.  ``plan()`` searches candidate strategies per bucket across
a grid of fusion granularities and keeps the granularity whose simulated
iteration time (backward-overlap aware, generalised MG-WFBP) is smallest.
``repro_torch.core.grad_sync.PlanExecutor`` executes the result; DESIGN.md §6
documents the schema and the ``--sync auto`` flow.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch._tree import tree_leaves

from repro_torch.core.parallelism import ParallelismSpec
from repro_torch.core.schedule.cost import (CompressionCostTable, LinkParams,
                                      all_to_all_cost_s, allreduce_cost_s,
                                      bucket_sync_cost_s,
                                      shard_gather_cost_s,
                                      straggler_penalty_s)
from repro_torch.core.schedule.perf_model import LayerProfile
from repro_torch.core.schedule.topology import Topology, as_topology

# Every ``link`` parameter below accepts either a bare LinkParams (flat
# network, the historical model) or a Topology (tiered network, DESIGN.md
# §10) — the cost layer prices each algorithm phase on the tier it
# traverses, so the same search discovers hierarchical/2D arms exactly
# when the network is tiered.

# Buckets smaller than this stay dense: at these sizes the exchange is
# latency-bound, so compression saves nothing and only adds bias (the
# survey's "small tensors are free" observation; also PowerSGD's dense
# fallback for non-matrix leaves).
DENSE_SMALL_BYTES = 64 * 1024

# Fusion granularities searched by ``plan`` (f32 bytes).  0 is excluded —
# per-leaf plans come out of the 1 MiB entry naturally when leaves are big.
BUCKET_GRID = tuple(int(m * 2**20) for m in (1, 4, 16, 32, 64, 256))


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One (compressor × algo) strategy the planner may assign to a bucket."""
    compressor: str = "none"
    compressor_args: Tuple[Tuple[str, Any], ...] = ()
    algo: str = "psum"

    @property
    def key(self) -> str:
        return f"{self.algo}/{self.compressor}"


# The fixed single-strategy baselines the auto plan is held against (the
# acceptance criterion) — shared by launch/train.py's printed table/assert
# and benchmarks/bench_planner.py so they always compare the same configs.
# Every entry must stay inside DEFAULT_CANDIDATES for the planner's
# uniform-plan sweep to guarantee auto <= fixed.
FIXED_BASELINES: Dict[str, Tuple[str, str, Tuple[Tuple[str, Any], ...]]] = {
    "psum/dense": ("none", "psum", ()),
    "ring/topk": ("topk", "ring", (("ratio", 0.01),)),
    "ring/int8": ("int8", "ring", ()),
}

DEFAULT_CANDIDATES: Tuple[Candidate, ...] = (
    Candidate("none", (), "psum"),
    Candidate("none", (), "ring"),
    Candidate("none", (), "tree"),
    Candidate("none", (), "hierarchical"),
    Candidate("int8", (), "ring"),
    Candidate("int8", (), "tree"),          # latency-bound slow links
    Candidate("qsgd", (("levels", 127),), "ring"),
    Candidate("qsgd", (("levels", 127),), "tree"),
    Candidate("topk", (("ratio", 0.01),), "ring"),
    Candidate("sign", (), "ring"),
    # fused Pallas wires (DESIGN.md §11): the same bits as int8/topk but
    # one kernel pass per direction; int8_fused/ring_fused additionally
    # overlaps per-hop compression with the permutes inside the ring
    Candidate("int8_fused", (), "ring"),
    Candidate("int8_fused", (), "ring_fused"),
    Candidate("topk_fused", (("ratio", 0.01),), "ring"),
)

# The NON-tier-aware traversals: what a flat ring / XLA allreduce can do
# on any network.  The tiered-network benches and the CI topology suite
# both assert the tier-aware pick against a plan restricted to this pool
# — defined once here so the asserted bound and the tracked baseline
# cannot drift apart.
FLAT_RING_CANDIDATES: Tuple[Candidate, ...] = tuple(
    c for c in DEFAULT_CANDIDATES if c.algo in ("ring", "psum"))


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Sync strategy for one fused gradient bucket.

    ``leaves`` are indices into the flattened gradient pytree, listed in the
    order they are packed.  ``pack=False`` buckets hold exactly one leaf and
    operate on it in its natural shape (no flatten/concat) so tensor-parallel
    sharding and shape-aware compressors (PowerSGD) survive.
    """
    leaves: Tuple[int, ...]
    compressor: str = "none"
    compressor_args: Tuple[Tuple[str, Any], ...] = ()
    algo: str = "psum"
    bucket_bytes: int = 0          # dense f32 bytes fused in this bucket
    pack: bool = True
    error_feedback: bool = True
    ef_decay: float = 1.0
    # Dispatch to the compressor's fused one-pass kernels when it has them
    # (compression/fused.py; DESIGN.md §11).  False forces the decomposed
    # reference op chain — the comparison arm of the fused-vs-unfused
    # bit-trajectory checks.  No-op for compressors without fused hooks.
    fused: bool = True


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """An ordered per-bucket communication schedule (DESIGN.md §6).

    ``shard_state=True`` marks the sharded-DP execution mode (DESIGN.md
    §8): gradients reduce-scatter to canonical per-bucket owners, optimizer
    moments and f32 master params are partitioned 1/world, and the updated
    params all-gather back on the forward edge.  ``modeled_step_s`` then
    includes the (un-overlappable) gather tail."""
    buckets: Tuple[BucketPlan, ...]
    mean: bool = True              # divide by world size after reduce
    modeled_step_s: float = float("nan")   # simulated iteration time
    world: int = 1
    link: Optional[Any] = None     # LinkParams | Topology (the net priced)
    shard_state: bool = False

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    def describe(self) -> str:
        rows = []
        for j, b in enumerate(self.buckets):
            rows.append(f"bucket {j}: {len(b.leaves)} leaves, "
                        f"{b.bucket_bytes / 2**20:.2f} MiB, "
                        f"{b.algo}/{b.compressor}")
        return "\n".join(rows)


# ---------------------------------------------------------------------------
# Profiles
# ---------------------------------------------------------------------------

def profiles_from_sizes(leaf_bytes: Sequence[float],
                        t_backward_s: float) -> List[LayerProfile]:
    """LayerProfiles in *leaf (tree) order* from per-leaf gradient bytes and
    a measured total backward time, apportioned proportionally to bytes (the
    profiling granularity ``--sync auto`` actually has — XLA fuses the real
    per-layer times away)."""
    total = float(sum(leaf_bytes)) or 1.0
    return [LayerProfile(t_backward_s=t_backward_s * (b / total),
                         grad_bytes=float(b))
            for b in leaf_bytes]


def profiles_from_grads(grads, t_backward_s: float) -> List[LayerProfile]:
    """Like :func:`profiles_from_sizes`, from a gradient (or param) tree of
    anything with a ``.shape`` (tensors, arrays, ``param_desc`` entries),
    walked in the reference's leaf order (sorted dict keys, as
    ``jax.tree.leaves``).  Bytes are f32 bytes per leaf (``numel × 4``)
    whatever the leaf's dtype: the wire carries f32 buckets."""
    sizes = [math.prod(int(d) for d in g.shape) * 4
             for g in tree_leaves(grads)]
    return profiles_from_sizes(sizes, t_backward_s)


# ---------------------------------------------------------------------------
# Plan simulation (generalised MG-WFBP with per-bucket strategies)
# ---------------------------------------------------------------------------

def _bucket_cost_s(b: BucketPlan, world: int, link,
                   shard_state: bool = False,
                   cost_table: Optional[CompressionCostTable] = None
                   ) -> float:
    return bucket_sync_cost_s(b.compressor, b.compressor_args, b.algo,
                              b.bucket_bytes, world, link,
                              shard_state=shard_state, cost_table=cost_table)


def shard_gather_tail_s(plan: CommPlan, link,
                        world: int) -> float:
    """Serial cost of the params all-gather a sharded plan pays after the
    optimizer step: the updated 1/p master shards must be whole on every
    rank before the next forward, so nothing hides this edge."""
    if world <= 1:
        return 0.0
    return sum(shard_gather_cost_s(b.algo, b.bucket_bytes, world, link)
               for b in plan.buckets)


def plan_cost_s(plan: CommPlan, layers: Sequence[LayerProfile],
                link, world: int,
                cost_table: Optional[CompressionCostTable] = None) -> float:
    """Simulated iteration time of ``plan`` on one shared link.

    Backward produces leaf gradients last-layer-first (WFBP); a bucket is
    ready when its last-produced leaf exists; ready buckets go out on the
    link in readiness order.  This is ``iteration_time_mg_wfbp`` generalised
    to heterogeneous per-bucket communication costs.  Sharded plans pay the
    (cheaper) reduce-scatter per bucket inside the overlap window plus the
    serial params-gather tail after it."""
    n = len(layers)
    produce_at = [0.0] * n
    t = 0.0
    for i in reversed(range(n)):          # backward order: leaf n-1 first
        t += layers[i].t_backward_s
        produce_at[i] = t
    t_total = t

    events = sorted(
        (max(produce_at[i] for i in b.leaves), j)
        for j, b in enumerate(plan.buckets))
    link_free = 0.0
    for ready, j in events:
        start = max(ready, link_free)
        link_free = start + _bucket_cost_s(plan.buckets[j], world, link,
                                           plan.shard_state,
                                           cost_table=cost_table)
    base = max(t_total, link_free)
    if plan.shard_state:
        base += shard_gather_tail_s(plan, link, world)
    return base


# ---------------------------------------------------------------------------
# The search
# ---------------------------------------------------------------------------

def form_bucket_indices(leaf_bytes: Sequence[float],
                        bucket_bytes: float) -> List[Tuple[int, ...]]:
    """THE greedy tensor-fusion rule, shared by ``grad_sync.bucketize`` and
    the planner (the auto-vs-fixed comparison is only valid while both form
    identical bucket boundaries): walk leaves in backward order (reversed),
    close the current bucket when adding the next leaf would exceed
    ``bucket_bytes``; ``bucket_bytes <= 0`` means one bucket per leaf."""
    order = list(range(len(leaf_bytes)))[::-1]
    buckets: List[Tuple[int, ...]] = []
    cur: List[int] = []
    cur_bytes = 0.0
    for i in order:
        sz = leaf_bytes[i]
        if cur and (bucket_bytes <= 0 or cur_bytes + sz > bucket_bytes):
            buckets.append(tuple(cur))
            cur, cur_bytes = [], 0.0
        cur.append(i)
        cur_bytes += sz
    if cur:
        buckets.append(tuple(cur))
    return buckets


def _form_buckets(layers: Sequence[LayerProfile],
                  bucket_bytes: int) -> List[Tuple[int, ...]]:
    return form_bucket_indices([l.grad_bytes for l in layers], bucket_bytes)


def _algo_usable(algo: str, world: int, net) -> bool:
    """Can ``algo`` actually execute at this world/topology?  The tree
    collective's distance doubling needs a power-of-two size on every
    axis (``tree.py`` raises ValueError at trace time), and mesh2d is a
    two-axis collective (both pricing and execution reject 3+-tier
    topologies) — the planner self-filters such candidates up front
    instead of returning a plan that errors at execution."""
    if algo == "tree":
        return as_topology(net, world).all_pow2
    if algo in ("mesh2d", "mesh2d_split"):
        return as_topology(net, world).n_tiers <= 2
    return True


def _usable_candidates(candidates: Sequence[Candidate], world: int,
                       net) -> List[Candidate]:
    out = [c for c in candidates if _algo_usable(c.algo, world, net)]
    if not out:
        raise ValueError(
            f"no candidate strategy can execute at world={world} "
            f"(of {[c.key for c in candidates]})")
    return out


def _pick_candidate(n_bytes: float, world: int, link,
                    candidates: Sequence[Candidate],
                    dense_small_bytes: float,
                    cost_table: Optional[CompressionCostTable] = None
                    ) -> Tuple[Candidate, float]:
    """Cheapest strategy for one bucket; small/latency-bound buckets fall
    back to dense (compression cannot help a latency-bound message and its
    bias is pure loss there)."""
    pool = candidates
    if n_bytes < dense_small_bytes:
        pool = [c for c in candidates if c.compressor == "none"] \
            or list(candidates)
    best, best_cost = None, float("inf")
    for c in pool:
        cost = bucket_sync_cost_s(c.compressor, c.compressor_args, c.algo,
                                  n_bytes, world, link,
                                  cost_table=cost_table)
        if cost < best_cost:
            best, best_cost = c, cost
    return best, best_cost


def plan(layer_profiles: Sequence[LayerProfile], link, world: int,
         candidates: Sequence[Candidate] = DEFAULT_CANDIDATES,
         bucket_grid: Sequence[int] = BUCKET_GRID,
         dense_small_bytes: float = DENSE_SMALL_BYTES,
         mean: bool = True, shard_state: bool = False,
         cost_table: Optional[CompressionCostTable] = None) -> CommPlan:
    """Search (compressor × algo × fusion granularity) per bucket.

    ``layer_profiles`` must be in leaf (tree) order — index i is flattened
    leaf i; backward produces them in reverse, like ``bucketize``.  Returns
    the plan with the smallest simulated iteration time; ``modeled_step_s``
    carries that time so callers can compare against fixed configurations.
    ``shard_state`` prices (and marks) the sharded-DP execution mode.
    ``link`` may be a tiered :class:`Topology`; candidates that cannot
    execute on it (tree on non-power-of-two axes) are filtered up front.
    ``cost_table`` replaces the analytic compression-compute term with
    MEASURED per-compressor encode/decode fits (``schedule/calibration.py``,
    recorded by ``benchmarks/bench_collectives.py --write-compression-costs``)
    — the planner's first measured input.
    """
    if world <= 1:
        # Degenerate world: communication is free; one dense bucket.
        buckets = (BucketPlan(
            leaves=tuple(range(len(layer_profiles)))[::-1],
            compressor="none", algo="psum",
            bucket_bytes=int(sum(l.grad_bytes for l in layer_profiles))),)
        t = sum(l.t_backward_s for l in layer_profiles)
        return CommPlan(buckets=buckets, mean=mean, modeled_step_s=t,
                        world=world, link=link, shard_state=shard_state)

    candidates = _usable_candidates(candidates, world, link)
    best_plan: Optional[CommPlan] = None

    def consider(p: CommPlan):
        nonlocal best_plan
        t = plan_cost_s(p, layer_profiles, link, world,
                        cost_table=cost_table)
        if best_plan is None or t < best_plan.modeled_step_s:
            best_plan = dataclasses.replace(p, modeled_step_s=t)

    for bb in bucket_grid:
        bucket_leaves = _form_buckets(layer_profiles, bb)
        sizes = [sum(layer_profiles[i].grad_bytes for i in leaves)
                 for leaves in bucket_leaves]
        # heterogeneous plan: cheapest strategy per bucket, small buckets
        # falling back to dense
        bps = []
        for leaves, n_bytes in zip(bucket_leaves, sizes):
            cand, _ = _pick_candidate(n_bytes, world, link, candidates,
                                      dense_small_bytes,
                                      cost_table=cost_table)
            bps.append(BucketPlan(
                leaves=leaves, compressor=cand.compressor,
                compressor_args=cand.compressor_args, algo=cand.algo,
                bucket_bytes=int(n_bytes)))
        consider(CommPlan(buckets=tuple(bps), mean=mean, world=world,
                          link=link, shard_state=shard_state))
        # uniform plans: one candidate everywhere — exactly the plan a fixed
        # SyncConfig induces.  Including them in the min GUARANTEES the
        # returned plan is never modeled slower than any fixed config built
        # from the candidate set at a granularity in the grid.  (In corner
        # cases — e.g. a model whose every bucket is latency-bound — a
        # uniform compressed plan can shave a few α off the heterogeneous
        # dense-fallback plan and win; the fallback is a preference of the
        # per-bucket search, not a hard constraint on the final min.)
        for cand in candidates:
            consider(CommPlan(buckets=tuple(
                BucketPlan(leaves=leaves, compressor=cand.compressor,
                           compressor_args=cand.compressor_args,
                           algo=cand.algo, bucket_bytes=int(n_bytes))
                for leaves, n_bytes in zip(bucket_leaves, sizes)),
                mean=mean, world=world, link=link, shard_state=shard_state))
    return best_plan


# ---------------------------------------------------------------------------
# The rounds axis (survey §3.1 composed with §3.2-3.3)
# ---------------------------------------------------------------------------

# Local-SGD periods searched by ``plan_rounds``.  τ=1 is the every-step arm.
TAU_GRID = (1, 2, 4, 8, 16)

# Statistical-efficiency surcharge for τ>1: local SGD needs more steps to
# reach the same loss (survey §3.1.2 — convergence holds only for bounded τ),
# which a pure wall-clock model cannot see; without it the rounds search
# degenerates to "communicate never" (τ→∞ always minimizes time/step).  Each
# τ-averaged step is charged ``1 + γ·(1 - 1/τ)`` of its modeled time — a
# crude, documented stand-in (γ ≈ 5% more steps at large τ) that makes
# every-step win when communication is already hidden by backward overlap
# and lets τ>1 win exactly when communication dominates compute.
LOCAL_SGD_STEP_INFLATION = 0.05


@dataclasses.dataclass(frozen=True)
class RoundSchedule:
    """The rounds lever of a composite strategy: WHEN reduce rounds run."""
    kind: str = "every_step"       # 'every_step' | 'local_sgd'
    period: int = 1                # τ (local_sgd); 1 for every_step

    @property
    def key(self) -> str:
        return f"{self.kind}/tau{self.period}" if self.kind == "local_sgd" \
            else self.kind


@dataclasses.dataclass(frozen=True)
class StrategyPlan:
    """A composite strategy: rounds schedule × per-bucket comm plan.

    ``modeled_step_s`` is the amortized per-step time (every-step: the
    overlap-simulated iteration; local_sgd: backward + round_cost/τ, with
    the statistical surcharge).  ``comm.modeled_step_s`` keeps its own
    meaning for the every-step arm; for τ>1 arms ``round_cost_s`` is the
    serial cost of one averaging round.  ``shard_state`` mirrors
    ``comm.shard_state`` (the memory axis of the search);
    ``opt_mem_bytes`` is the modeled per-worker optimizer-state footprint
    under that choice.

    The PARALLELISM axis (DESIGN.md §9): ``pipeline_stages > 1`` marks a
    pipeline(S, M) arm — ``comm`` then describes the DP edge of ONE stage
    (1/S of the leaves over world/S replicas), ``bubble`` carries
    (S-1)/(S-1+M), and ``pipe_p2p_s`` the per-device boundary-activation
    traffic per step.  On a tiered topology ``pipe_tier`` records the
    AXIS PLACEMENT the planner chose — which tier the pipe axis consumes
    (DESIGN.md §10): ``@node`` means "pipeline across nodes, gradient
    ring inside them"; empty means a flat network (the historical arm).

    ``tp > 1`` / ``ep > 1`` mark the intra-layer model-parallel arms
    (DESIGN.md §14): ``comm`` is the shrunken DP edge (1/tp of the grad
    bytes over world/tp replicas, or the expert-sharded equivalent),
    ``model_comm_s`` the SERIAL per-step activation traffic the mode adds
    (Megatron's per-layer activation allreduces for TP, the expert
    dispatch/combine all-to-alls for EP — nothing hides either in a
    synchronous layer stack), and ``tp_tier`` / ``ep_tier`` the tier the
    axis consumes.  The per-knob fields are consolidated in the
    :class:`~repro_torch.core.parallelism.ParallelismSpec` view (``.parallelism``)
    — new code should read that."""
    schedule: RoundSchedule
    comm: CommPlan
    modeled_step_s: float
    round_cost_s: float
    t_backward_s: float
    shard_state: bool = False
    opt_mem_bytes: float = float("nan")
    pipeline_stages: int = 1
    micro_batches: int = 0
    bubble: float = 0.0
    pipe_p2p_s: float = 0.0
    pipe_tier: str = ""
    tp: int = 1
    tp_tier: str = ""
    ep: int = 1
    ep_tier: str = ""
    model_comm_s: float = 0.0

    @property
    def key(self) -> str:
        """Arm key in ``plan_rounds``'s arms dict (and the report table)."""
        if self.tp > 1:
            at = f"@{self.tp_tier}" if self.tp_tier else ""
            return f"tp({self.tp}){at}"
        if self.ep > 1:
            at = f"@{self.ep_tier}" if self.ep_tier else ""
            return f"ep({self.ep}){at}"
        if self.pipeline_stages > 1:
            at = f"@{self.pipe_tier}" if self.pipe_tier else ""
            return (f"pipeline(S={self.pipeline_stages},"
                    f"M={self.micro_batches}){at}")
        return self.schedule.key + ("_sharded" if self.shard_state else "")

    @property
    def parallelism(self) -> ParallelismSpec:
        """The arm's factorization as one :class:`ParallelismSpec` — the
        consolidated view ``SyncStrategy`` / ``TrainSession`` / the plan
        record speak (DESIGN.md §14)."""
        pp = int(self.pipeline_stages)
        return ParallelismSpec(
            dp=max(int(self.comm.world), 1), tp=int(self.tp),
            pp=pp, ep=int(self.ep),
            tp_tier=self.tp_tier if self.tp > 1 else "",
            pp_tier=self.pipe_tier if pp > 1 else "",
            ep_tier=self.ep_tier if self.ep > 1 else "",
            micro_batches=int(self.micro_batches) if pp > 1 else 0,
            shard_state=self.shard_state)

    def describe(self) -> str:
        shard = " [shard_state 1/p]" if self.shard_state else ""
        pipe = ""
        if self.pipeline_stages > 1:
            placed = (f", pipe axis on tier {self.pipe_tier!r}"
                      if self.pipe_tier else "")
            pipe = (f" [bubble {self.bubble:.1%}, "
                    f"p2p {self.pipe_p2p_s * 1e3:.3f} ms{placed}]")
        if self.tp > 1 or self.ep > 1:
            ax = "tp" if self.tp > 1 else "ep"
            tier = self.tp_tier if self.tp > 1 else self.ep_tier
            placed = f" on tier {tier!r}" if tier else ""
            pipe = (f" [{ax} activation comm "
                    f"{self.model_comm_s * 1e3:.3f} ms{placed}]")
        return (f"{self.key}{shard}{pipe}: "
                f"{self.modeled_step_s * 1e3:.3f} ms/step"
                f" (round {self.round_cost_s * 1e3:.3f} ms, "
                f"{self.comm.n_buckets} buckets)")


# f32 moment buffers per parameter for the registered optimizers (sharded
# mode adds the partitioned f32 master copy on top).  This is the
# worst-case DEFAULT per name; the session passes the measured count
# instead (sgd with momentum=0.0 carries NO moment state, so the name
# alone over-counts it).
OPT_MOMENTS: Dict[str, int] = {"sgd": 1, "adam": 2, "lamb": 2, "lars": 1}


def opt_state_bytes_per_worker(opt_name: str, param_bytes: float, world: int,
                               shard_state: bool,
                               moments: Optional[float] = None) -> float:
    """Modeled per-worker optimizer-state footprint: ``moments`` f32
    buffers replicated, or (moments + the f32 master copy) over the 1/p
    shard when partitioned — the ZeRO memory identity the report prints.
    ``moments`` overrides the per-name default with the measured buffer
    count (actual state bytes / param bytes)."""
    mom = OPT_MOMENTS.get(opt_name, 2) if moments is None else moments
    if not shard_state:
        return float(mom) * param_bytes
    return (mom + 1.0) * param_bytes / max(int(world), 1)


def serial_round_plan(layer_profiles: Sequence[LayerProfile],
                      link, world: int,
                      candidates: Sequence[Candidate] = DEFAULT_CANDIDATES,
                      bucket_grid: Sequence[int] = BUCKET_GRID,
                      dense_small_bytes: float = DENSE_SMALL_BYTES,
                      mean: bool = True,
                      cost_table: Optional[CompressionCostTable] = None
                      ) -> CommPlan:
    """Per-bucket plan for one UNOVERLAPPED reduce round (a local-SGD
    parameter-averaging round runs at a barrier after the optimizer step, so
    nothing hides it): minimize the serial sum of bucket costs instead of
    the WFBP-simulated iteration time.  ``modeled_step_s`` on the returned
    plan is that serial round cost."""
    if world <= 1:
        buckets = (BucketPlan(
            leaves=tuple(range(len(layer_profiles)))[::-1],
            compressor="none", algo="psum",
            bucket_bytes=int(sum(l.grad_bytes for l in layer_profiles))),)
        return CommPlan(buckets=buckets, mean=mean, modeled_step_s=0.0,
                        world=world, link=link)

    candidates = _usable_candidates(candidates, world, link)
    best: Optional[CommPlan] = None

    def consider(bps) -> None:
        nonlocal best
        total = sum(_bucket_cost_s(b, world, link, cost_table=cost_table)
                    for b in bps)
        if best is None or total < best.modeled_step_s:
            best = CommPlan(buckets=tuple(bps), mean=mean,
                            modeled_step_s=total, world=world, link=link)

    for bb in bucket_grid:
        bucket_leaves = _form_buckets(layer_profiles, bb)
        sizes = [sum(layer_profiles[i].grad_bytes for i in leaves)
                 for leaves in bucket_leaves]
        greedy = []
        for leaves, n_bytes in zip(bucket_leaves, sizes):
            cand, _ = _pick_candidate(n_bytes, world, link, candidates,
                                      dense_small_bytes,
                                      cost_table=cost_table)
            greedy.append(BucketPlan(
                leaves=leaves, compressor=cand.compressor,
                compressor_args=cand.compressor_args, algo=cand.algo,
                bucket_bytes=int(n_bytes)))
        consider(greedy)
        # uniform sweeps: the greedy pick restricts small buckets to dense;
        # keep the min over unrestricted uniform plans so the round is never
        # modeled slower than any fixed config
        for cand in candidates:
            consider([BucketPlan(leaves=leaves, compressor=cand.compressor,
                                 compressor_args=cand.compressor_args,
                                 algo=cand.algo, bucket_bytes=int(n_bytes))
                      for leaves, n_bytes in zip(bucket_leaves, sizes)])
    return best


def local_sgd_arm(round_plan: CommPlan, t_backward_s: float, tau: int,
                  inflation: float = LOCAL_SGD_STEP_INFLATION) -> StrategyPlan:
    """The τ>1 composite arm: one serial averaging round (``round_plan``,
    from :func:`serial_round_plan`, whose ``modeled_step_s`` is the round
    cost) amortized over τ steps, with the statistical surcharge.  THE
    amortization formula — shared by :func:`plan_rounds` and the pinned
    ``--local-sgd`` path so auto and pinned runs score identically."""
    rc = round_plan.modeled_step_s
    per_step = (t_backward_s + rc / tau) * (1.0 + inflation * (1 - 1 / tau))
    return StrategyPlan(
        schedule=RoundSchedule(kind="local_sgd", period=int(tau)),
        comm=round_plan, modeled_step_s=per_step, round_cost_s=rc,
        t_backward_s=t_backward_s)


# ---------------------------------------------------------------------------
# The parallelism axis (survey §3.1.3/§3.3: pipeline × data, DESIGN.md §9)
# ---------------------------------------------------------------------------

# Stage counts and micro-batch counts searched by ``plan_rounds`` when a
# ``PipelineAxis`` is supplied.  S must divide the world (the 2-D pipe×data
# mesh) and leave at least 2 DP replicas per stage.
PIPE_GRID = (2, 4, 8)
MICRO_GRID = (4, 8, 16, 32)


@dataclasses.dataclass(frozen=True)
class PipelineAxis:
    """What the planner needs to price pipeline(S, M) arms: the boundary
    activation traffic.  ``global_tokens`` is batch × seq per step;
    ``bytes_per_token`` the boundary activation row (d_model × 4 for the
    f32 reference wire).  One micro-batch crossing one stage cut moves
    ``global_tokens / (world/S) / M × bytes_per_token`` bytes."""
    global_tokens: float
    bytes_per_token: float
    pipe_grid: Tuple[int, ...] = PIPE_GRID
    micro_grid: Tuple[int, ...] = MICRO_GRID


def pipeline_placements(net, world: int, n_stages: int
                        ) -> List[Tuple[str, Any, Any]]:
    """The AXIS-PLACEMENT alternatives for a pipeline(S) arm: which tier
    the pipe axis consumes (DESIGN.md §10).  Returns
    ``[(pipe_tier_name, dp_net, p2p_net), ...]`` — ``dp_net`` is the
    network the DP edge (world/S replicas) sees after the pipe axis took
    its ranks, ``p2p_net`` the link the boundary activations cross.

    On a flat network (bare LinkParams, or a one-tier Topology) there is
    exactly one placement and the name is "" — the historical arm.  On a
    tiered topology every tier whose size S divides is a placement:
    "pipeline across nodes, dense ring inside" is S on the outer tier;
    pipelining inside the node keeps p2p on the fast tier but forces the
    gradient ring across the slow one.  May return [] when S divides no
    tier (that S is simply not expressible on this topology)."""
    S = int(n_stages)
    if not isinstance(net, Topology):
        return [("", net, net)]
    if net.world != world:
        raise ValueError(f"topology world {net.world} != world {world}")
    out = []
    for ti, tier in enumerate(net.tiers):
        if tier.size % S != 0:
            continue
        placed, rest = net.place(S, ti)
        out.append(("" if net.is_flat else tier.name, rest, placed.link))
    return out


def pipeline_dp_plan(layer_profiles: Sequence[LayerProfile],
                     link, world: int, n_stages: int,
                     candidates: Sequence[Candidate] = DEFAULT_CANDIDATES,
                     bucket_grid: Sequence[int] = BUCKET_GRID,
                     dense_small_bytes: float = DENSE_SMALL_BYTES,
                     mean: bool = True,
                     dp_net=None,
                     cost_table: Optional[CompressionCostTable] = None
                     ) -> Tuple[CommPlan, List[float]]:
    """The M-independent half of a pipeline arm: balanced stage cuts plus
    the overlap-planned DP edge of the HEAVIEST stage (its leaves over
    world/S replicas).  Returns ``(dp_plan, per_stage_bytes)`` so
    :func:`plan_rounds` computes it once per S, not once per (S, M).
    ``dp_net`` is the network the DP edge sees (a placement's remaining
    topology); default: ``link`` itself (the flat arm)."""
    from repro_torch.core.pipeline import balanced_cuts, stage_costs

    S = int(n_stages)
    if S < 2:
        raise ValueError(f"pipeline arm needs n_stages >= 2, got {S}")
    if world % S != 0 or world // S < 2:
        raise ValueError(f"world {world} does not factor into pipe({S}) x "
                         f"data(>=2)")
    if len(layer_profiles) < S:
        raise ValueError(f"cannot cut {len(layer_profiles)} leaves into "
                         f"{S} stages")
    t_bwd = sum(l.t_backward_s for l in layer_profiles)
    bytes_ = [l.grad_bytes for l in layer_profiles]
    cuts = balanced_cuts(bytes_, S)
    per_stage = stage_costs(bytes_, cuts)
    heavy = int(max(range(S), key=lambda s: per_stage[s]))
    sub = list(layer_profiles[cuts[heavy]:cuts[heavy + 1]])
    # each device still computes the full t_bwd per step (its 1/S of the
    # layers over S× micro-batches) — rescale the slice's backward times so
    # the overlap window the DP-edge plan sees stays t_bwd
    sub_t = sum(l.t_backward_s for l in sub) or 1.0
    scale = t_bwd / sub_t
    sub = [LayerProfile(t_backward_s=l.t_backward_s * scale,
                        grad_bytes=l.grad_bytes) for l in sub]
    cp = plan(sub, dp_net if dp_net is not None else link, world // S,
              candidates=candidates, bucket_grid=bucket_grid,
              dense_small_bytes=dense_small_bytes, mean=mean,
              cost_table=cost_table)
    return cp, per_stage


def pipeline_arm(layer_profiles: Sequence[LayerProfile], link,
                 world: int, n_stages: int, micro_batches: int,
                 act_bytes_mb: float,
                 candidates: Sequence[Candidate] = DEFAULT_CANDIDATES,
                 bucket_grid: Sequence[int] = BUCKET_GRID,
                 dense_small_bytes: float = DENSE_SMALL_BYTES,
                 mean: bool = True, opt_name: str = "adam",
                 opt_moments: Optional[float] = None,
                 dp_plan: Optional[Tuple[CommPlan, List[float]]] = None,
                 placement: Optional[Tuple[str, Any, Any]] = None,
                 cost_table: Optional[CompressionCostTable] = None
                 ) -> StrategyPlan:
    """Price one pipeline(S, M) composite on a pipe(S) × data(world/S) mesh.

    Per-device compute is unchanged (1/S of the layers × S× the per-replica
    batch), so the arm pays three things on top of the DP arm's backward:

      * the DP edge shrinks: each pipe rank syncs only its stage's leaves
        (the HEAVIEST stage under the balanced cut — the critical path)
        over world/S replicas, overlap-planned by the same :func:`plan`
        search, so per-bucket compression composes on the DP dimension;
      * the 1F1B bubble: the timeline stretches to (M+S-1)/M of the
        compute, so the idle charged ON TOP of the backward is
        ``(S-1)/M`` of (forward + backward) — i.e. ``bubble/(1-bubble)``
        of compute, where ``bubble = (S-1)/(S-1+M)`` is the reported
        timeline fraction (forward priced at ``PIPE_FWD_FRACTION`` ×
        backward);
      * boundary p2p: 2M transfers of one micro-batch of activations per
        device per step (M forward sends + M grad-activation sends),
        α + bytes·β each — nothing hides them in the lockstep executor.

    Memory: moments × the heaviest stage's param bytes (replicated over
    the stage's DP group) — the pipeline arm is also a memory lever, and
    can win through ``memory_budget_bytes`` like the shard arm.

    ``dp_plan`` takes a precomputed :func:`pipeline_dp_plan` result (the
    M-independent half) so grid sweeps don't redo the bucket search.
    ``placement`` is one :func:`pipeline_placements` entry — the axis→tier
    assignment of the pipe dimension on a tiered topology; default: the
    outermost-tier placement (pipeline across nodes), or the flat arm on
    a flat network.
    """
    from repro_torch.core.pipeline import PIPE_FWD_FRACTION, bubble_fraction
    from repro_torch.core.schedule.cost import p2p_cost_s

    S, M = int(n_stages), int(micro_batches)
    if placement is None:
        options = pipeline_placements(link, world, S)
        if not options:
            raise ValueError(f"pipeline(S={S}) fits no tier of "
                             f"{link.spec()}")
        placement = options[0]
    pipe_tier, dp_net, p2p_net = placement
    if dp_plan is None:
        dp_plan = pipeline_dp_plan(
            layer_profiles, link, world, S, candidates=candidates,
            bucket_grid=bucket_grid, dense_small_bytes=dense_small_bytes,
            mean=mean, dp_net=dp_net, cost_table=cost_table)
    cp, per_stage = dp_plan
    t_bwd = sum(l.t_backward_s for l in layer_profiles)
    bub = bubble_fraction(S, M)
    # idle relative to compute = bubble/(1-bubble) = (S-1)/M — charging
    # bubble·compute instead would under-price small-M arms by M/(M+S-1)
    idle = (S - 1) / M * (1.0 + PIPE_FWD_FRACTION) * t_bwd
    p2p = 2.0 * M * p2p_cost_s(act_bytes_mb, p2p_net)
    modeled = cp.modeled_step_s + idle + p2p
    mom = OPT_MOMENTS.get(opt_name, 2) if opt_moments is None \
        else opt_moments
    return StrategyPlan(
        schedule=RoundSchedule(), comm=cp, modeled_step_s=modeled,
        round_cost_s=sum(_bucket_cost_s(b, world // S, dp_net,
                                        cost_table=cost_table)
                         for b in cp.buckets),
        t_backward_s=t_bwd, pipeline_stages=S, micro_batches=M, bubble=bub,
        pipe_p2p_s=p2p, pipe_tier=pipe_tier,
        opt_mem_bytes=float(mom) * max(per_stage))


# ---------------------------------------------------------------------------
# The intra-layer model-parallel axes: tensor + expert (DESIGN.md §14)
# ---------------------------------------------------------------------------

# TP/EP group sizes searched by ``plan_rounds`` when the matching axis
# descriptor is supplied.  The group must divide the world and (on a tiered
# topology) some tier.
TP_GRID = (2, 4, 8)
EP_GRID = (2, 4, 8)


@dataclasses.dataclass(frozen=True)
class TensorAxis:
    """What the planner needs to price tp arms: the per-layer activation
    allreduce traffic.  ``global_tokens`` is batch × seq per step;
    ``bytes_per_token`` one activation row (d_model × 4 for the f32
    reference wire).  A tp group processes its DP replica's share —
    ``global_tokens / (world/tp)`` tokens — and pays the Megatron pattern:
    4 activation allreduces per layer per step (2 forward + 2 backward,
    one per column→row pair) over the tp axis, serial (the synchronous
    layer stack hides none of them)."""
    global_tokens: float
    bytes_per_token: float
    n_layers: int
    tp_grid: Tuple[int, ...] = TP_GRID


@dataclasses.dataclass(frozen=True)
class ExpertAxis:
    """What the planner needs to price ep arms: the expert dispatch /
    combine all-to-all traffic plus how much of the model the ep axis
    actually shards.  ``bytes_per_token`` is the dispatched activation
    row including the top-k fan-out (k × d_model × 4 for the f32 wire);
    ``expert_fraction`` the share of parameter bytes living in expert
    weights (sharded 1/ep — the rest stays replicated across ep and pays
    an extra ep-axis reduction).  Each rank dispatches its own
    ``global_tokens / world`` tokens: 4 all-to-alls per MoE layer per
    step (dispatch + combine, forward + backward)."""
    global_tokens: float
    bytes_per_token: float
    n_moe_layers: int
    expert_fraction: float = 0.9
    ep_grid: Tuple[int, ...] = EP_GRID
    variant: str = "direct"


def model_axis_placements(net, world: int, size: int
                          ) -> List[Tuple[str, Any, Any]]:
    """Tier placements for a tp/ep group of ``size`` ranks:
    ``[(tier_name, group_net, dp_net), ...]`` — ``group_net`` prices the
    group's activation collectives (the placed tier's link), ``dp_net``
    is the topology the remaining world/size DP replicas see.  Flat
    networks have the single historical placement (name "").  Mirrors
    :func:`pipeline_placements` / :func:`serving_placements`; may return
    ``[]`` when ``size`` divides no tier."""
    size = int(size)
    if size == 1 or not isinstance(net, Topology):
        return [("", net, net)]
    if net.world != world:
        raise ValueError(f"topology world {net.world} != world {world}")
    out = []
    for ti, tier in enumerate(net.tiers):
        if tier.size % size != 0:
            continue
        placed, rest = net.place(size, ti)
        out.append(("" if net.is_flat else tier.name, placed.link, rest))
    return out


def tensor_parallel_arm(layer_profiles: Sequence[LayerProfile], link,
                        world: int, tp: int, axis: TensorAxis,
                        candidates: Sequence[Candidate] = DEFAULT_CANDIDATES,
                        bucket_grid: Sequence[int] = BUCKET_GRID,
                        dense_small_bytes: float = DENSE_SMALL_BYTES,
                        mean: bool = True, opt_name: str = "adam",
                        opt_moments: Optional[float] = None,
                        placement: Optional[Tuple[str, Any, Any]] = None,
                        cost_table: Optional[CompressionCostTable] = None
                        ) -> StrategyPlan:
    """Price one tp-way tensor-parallel composite on a tp × data mesh.

    Per-rank compute is unchanged (1/tp of every matmul × tp× the tokens
    of its dp group), so the arm trades three things against plain DP:

      * the DP edge shrinks tp×: each rank owns 1/tp of every weight, so
        gradient sync moves 1/tp of the bytes over world/tp replicas, on
        the topology REMAINING after the tp axis took its tier — the
        same overlap-planned :func:`plan` search, so compression
        composes on the shrunken edge;
      * the activation edges appear: 4 allreduces per layer per step of
        the group's ``(tokens, d_model)`` activations over the tp axis
        (Megatron's column→row f/g pattern, DESIGN.md §14), priced on
        the PLACED tier and charged serially — the synchronous layer
        stack hides none of them, which is exactly why TP belongs on the
        fastest tier;
      * optimizer state shrinks tp×: moments × param_bytes/tp per rank —
        TP is a memory lever and competes through ``memory_budget_bytes``
        like the shard and pipeline arms.
    """
    tp = int(tp)
    if tp < 2:
        raise ValueError(f"tensor-parallel arm needs tp >= 2, got {tp}")
    if world % tp != 0:
        raise ValueError(f"tp={tp} does not divide world {world}")
    if placement is None:
        options = model_axis_placements(link, world, tp)
        if not options:
            raise ValueError(f"tp={tp} fits no tier of {link.spec()}")
        placement = options[0]
    tier_name, group_net, dp_net = placement
    dp = world // tp
    shards = [LayerProfile(t_backward_s=l.t_backward_s,
                           grad_bytes=l.grad_bytes / tp)
              for l in layer_profiles]
    cp = plan(shards, dp_net, dp, candidates=candidates,
              bucket_grid=bucket_grid, dense_small_bytes=dense_small_bytes,
              mean=mean, cost_table=cost_table)
    act_bytes = axis.global_tokens / dp * axis.bytes_per_token
    act_s = 4.0 * axis.n_layers * allreduce_cost_s("ring", act_bytes, tp,
                                                   group_net)
    t_bwd = sum(l.t_backward_s for l in layer_profiles)
    pb = float(sum(l.grad_bytes for l in layer_profiles))
    mom = OPT_MOMENTS.get(opt_name, 2) if opt_moments is None \
        else opt_moments
    return StrategyPlan(
        schedule=RoundSchedule(), comm=cp,
        modeled_step_s=cp.modeled_step_s + act_s,
        round_cost_s=sum(_bucket_cost_s(b, dp, dp_net,
                                        cost_table=cost_table)
                         for b in cp.buckets),
        t_backward_s=t_bwd, tp=tp, tp_tier=tier_name, model_comm_s=act_s,
        opt_mem_bytes=float(mom) * pb / tp)


def expert_parallel_arm(layer_profiles: Sequence[LayerProfile], link,
                        world: int, ep: int, axis: ExpertAxis,
                        candidates: Sequence[Candidate] = DEFAULT_CANDIDATES,
                        bucket_grid: Sequence[int] = BUCKET_GRID,
                        dense_small_bytes: float = DENSE_SMALL_BYTES,
                        mean: bool = True, opt_name: str = "adam",
                        opt_moments: Optional[float] = None,
                        placement: Optional[Tuple[str, Any, Any]] = None,
                        cost_table: Optional[CompressionCostTable] = None
                        ) -> StrategyPlan:
    """Price one ep-way expert-parallel composite.

    The ep axis shards the expert weights (``axis.expert_fraction`` of
    the param bytes) 1/ep while every rank keeps its own tokens, so:

      * the DP edge shrinks on the expert fraction: per-leaf grad bytes
        scale by ``frac/ep + (1-frac)`` over world/ep replica groups on
        the remaining topology (each expert exists on world/ep ranks);
      * the non-expert grads must ALSO cross the ep axis (they are
        replicated over it but fed by different tokens): one serial ring
        allreduce of ``(1-frac)·param_bytes`` over ep on the placed tier;
      * the dispatch/combine edges appear: 4 all-to-alls per MoE layer
        per step of each rank's ``global_tokens/world`` token rows over
        the ep axis (``cost.all_to_all_cost_s``, ring or direct variant),
        charged serially on the placed tier;
      * optimizer state shrinks on the expert fraction:
        moments × pb × (frac/ep + 1-frac).
    """
    ep = int(ep)
    if ep < 2:
        raise ValueError(f"expert-parallel arm needs ep >= 2, got {ep}")
    if world % ep != 0:
        raise ValueError(f"ep={ep} does not divide world {world}")
    if not 0.0 <= axis.expert_fraction <= 1.0:
        raise ValueError(f"expert_fraction must be in [0, 1], "
                         f"got {axis.expert_fraction}")
    if placement is None:
        options = model_axis_placements(link, world, ep)
        if not options:
            raise ValueError(f"ep={ep} fits no tier of {link.spec()}")
        placement = options[0]
    tier_name, group_net, dp_net = placement
    dp = world // ep
    frac = axis.expert_fraction
    scale = frac / ep + (1.0 - frac)
    shards = [LayerProfile(t_backward_s=l.t_backward_s,
                           grad_bytes=l.grad_bytes * scale)
              for l in layer_profiles]
    cp = plan(shards, dp_net, dp, candidates=candidates,
              bucket_grid=bucket_grid, dense_small_bytes=dense_small_bytes,
              mean=mean, cost_table=cost_table)
    pb = float(sum(l.grad_bytes for l in layer_profiles))
    a2a_bytes = axis.global_tokens / world * axis.bytes_per_token
    model_s = 4.0 * axis.n_moe_layers * all_to_all_cost_s(
        a2a_bytes, ep, group_net, axis.variant)
    if frac < 1.0:
        model_s += allreduce_cost_s("ring", (1.0 - frac) * pb, ep,
                                    group_net)
    t_bwd = sum(l.t_backward_s for l in layer_profiles)
    mom = OPT_MOMENTS.get(opt_name, 2) if opt_moments is None \
        else opt_moments
    return StrategyPlan(
        schedule=RoundSchedule(), comm=cp,
        modeled_step_s=cp.modeled_step_s + model_s,
        round_cost_s=sum(_bucket_cost_s(b, dp, dp_net,
                                        cost_table=cost_table)
                         for b in cp.buckets),
        t_backward_s=t_bwd, ep=ep, ep_tier=tier_name, model_comm_s=model_s,
        opt_mem_bytes=float(mom) * pb * scale)


def plan_rounds(layer_profiles: Sequence[LayerProfile], link,
                world: int,
                candidates: Sequence[Candidate] = DEFAULT_CANDIDATES,
                bucket_grid: Sequence[int] = BUCKET_GRID,
                tau_grid: Sequence[int] = TAU_GRID,
                dense_small_bytes: float = DENSE_SMALL_BYTES,
                inflation: float = LOCAL_SGD_STEP_INFLATION,
                mean: bool = True,
                opt_name: str = "adam",
                shard_grid: Sequence[bool] = (False, True),
                memory_budget_bytes: Optional[float] = None,
                opt_moments: Optional[float] = None,
                pipeline: Optional[PipelineAxis] = None,
                tensor: Optional[TensorAxis] = None,
                expert: Optional[ExpertAxis] = None,
                parallelism=None,
                cost_table: Optional[CompressionCostTable] = None,
                straggler_s: float = 0.0
                ) -> Tuple[StrategyPlan, Dict[str, StrategyPlan]]:
    """Search the rounds axis × the bits axis × the shard axis: every
    candidate composite is a (RoundSchedule, CommPlan) pair; returns
    (best, all_arms_by_key).

    The every-step arm reuses :func:`plan` (overlap-simulated, with its
    uniform-plan guarantee), so the winner is never modeled slower than any
    fixed single-strategy config — the planner's acceptance invariant
    carries over to composites.  τ>1 arms amortize one serial averaging
    round over τ steps and pay the ``LOCAL_SGD_STEP_INFLATION`` surcharge.

    The SHARD axis (``every_step_sharded``) trades the params-gather tail
    against per-worker optimizer memory: sharded is never modeled faster on
    wall clock (the tail cannot overlap), so it wins only through
    ``memory_budget_bytes`` — arms whose modeled per-worker optimizer state
    exceeds the budget are dropped (schedulers with diverging per-worker
    params — local SGD — inherently carry replicated-size state and drop
    with them).  If nothing fits, the minimum-memory arm is returned
    anyway (the budget is advisory, the decision record is honest).

    The PARALLELISM axis (``pipeline(S,M)``, priced when a
    :class:`PipelineAxis` is supplied): S-stage pipelining shrinks the DP
    edge S× (each pipe rank syncs 1/S of the leaves over world/S replicas)
    at the cost of the 1F1B bubble plus boundary activation p2p — it wins
    on wall clock exactly when gradient communication still dominates the
    overlapped backward AFTER the bits axis did its best, which is the
    big-model / slow-link corner both surveys call out (DESIGN.md §9).

    On a tiered :class:`Topology` the pipeline arms additionally search
    the AXIS PLACEMENT (DESIGN.md §10): one arm per (S, M, tier) with the
    pipe axis consuming that tier — p2p priced on its link, the DP edge
    planned on the remaining topology — so "pipeline across nodes, dense
    ring inside" competes directly with "hierarchical allreduce across
    both" and with pipelining inside the node.

    The MODEL axes (``tp(N)@tier`` / ``ep(N)@tier``, priced when a
    :class:`TensorAxis` / :class:`ExpertAxis` is supplied): one arm per
    (size, tier placement) via :func:`tensor_parallel_arm` /
    :func:`expert_parallel_arm` — the TP×PP×DP×EP search space of
    DESIGN.md §14, every arm priced by the same α-β model under the same
    memory budget.  (Combined tp×pp / tp×ep arms are NOT in the search
    space — each model axis competes against the others, not with them.)

    ``parallelism`` (a :class:`~repro_torch.core.parallelism.ParallelismSpec`,
    spec string, or None) PINS the factorization instead of searching it:
    pinned axes collapse their grids to the requested (size, tier), the
    final pool is filtered to arms matching the spec exactly, and an
    unreachable spec — axis without its descriptor, size off every grid,
    tier it doesn't divide — raises loudly rather than silently planning
    something else.  ``arms`` still carries every priced arm for the
    decision record.

    ``straggler_s`` (the elastic runtime's measured worst-vs-median
    step-time skew) adds ``cost.straggler_penalty_s(straggler_s,
    rounds/step)`` to every arm: schedules that sync every step pay the
    full skew per step, local-SGD τ arms pay skew/τ — a persistent
    straggler thereby demotes the winning cadence instead of stalling the
    bus (DESIGN.md §15).  The default 0.0 prices to exactly zero, keeping
    straggler-free plans bit-identical.
    """
    if isinstance(link, Topology) and link.world != world:
        raise ValueError(f"topology world {link.world} ({link.spec()}) != "
                         f"world {world}; derive world from the topology")
    spec = None
    if parallelism is not None:
        spec = ParallelismSpec.coerce(parallelism).resolve(
            link if isinstance(link, Topology) else world)
        if spec.tp > 1 and tensor is None:
            raise ValueError(
                f"parallelism spec {spec.spec()!r} pins tp={spec.tp} but no "
                f"TensorAxis was supplied — the planner cannot price the "
                f"activation edges (pass tensor=TensorAxis(...))")
        if spec.ep > 1 and expert is None:
            raise ValueError(
                f"parallelism spec {spec.spec()!r} pins ep={spec.ep} but no "
                f"ExpertAxis was supplied — the planner cannot price the "
                f"dispatch/combine edges (pass expert=ExpertAxis(...))")
        if spec.pp > 1 and pipeline is None:
            raise ValueError(
                f"parallelism spec {spec.spec()!r} pins pp={spec.pp} but no "
                f"PipelineAxis was supplied — the planner cannot price the "
                f"bubble/p2p edges (pass pipeline=PipelineAxis(...))")
        if spec.shard_state:
            shard_grid = tuple(s for s in shard_grid if s) or (True,)
    t_bwd = sum(l.t_backward_s for l in layer_profiles)
    pb = float(sum(l.grad_bytes for l in layer_profiles))   # f32 param bytes
    arms: Dict[str, StrategyPlan] = {}
    for shard in shard_grid:
        every = plan(layer_profiles, link, world, candidates=candidates,
                     bucket_grid=bucket_grid,
                     dense_small_bytes=dense_small_bytes, mean=mean,
                     shard_state=shard, cost_table=cost_table)
        key = "every_step_sharded" if shard else "every_step"
        arms[key] = StrategyPlan(
            schedule=RoundSchedule(), comm=every,
            modeled_step_s=every.modeled_step_s,
            round_cost_s=sum(_bucket_cost_s(b, world, link, shard,
                                            cost_table=cost_table)
                             for b in every.buckets),
            t_backward_s=t_bwd, shard_state=shard,
            opt_mem_bytes=opt_state_bytes_per_worker(opt_name, pb, world,
                                                     shard, opt_moments))
    if world > 1 and any(not s for s in shard_grid):
        rp = serial_round_plan(layer_profiles, link, world,
                               candidates=candidates,
                               bucket_grid=bucket_grid,
                               dense_small_bytes=dense_small_bytes,
                               mean=mean, cost_table=cost_table)
        mem = opt_state_bytes_per_worker(opt_name, pb, world, False,
                                         opt_moments)
        for tau in tau_grid:
            if tau <= 1:
                continue
            arm = local_sgd_arm(rp, t_bwd, tau, inflation)
            arms[arm.schedule.key] = dataclasses.replace(
                arm, opt_mem_bytes=mem)
    if pipeline is not None and world > 1:
        pipe_grid = pipeline.pipe_grid
        micro_grid = pipeline.micro_grid
        if spec is not None and spec.pp > 1:
            pipe_grid = (spec.pp,)
            if spec.micro_batches:
                micro_grid = (spec.micro_batches,)
        for S in pipe_grid:
            if S < 2 or world % S != 0 or world // S < 2 \
                    or len(layer_profiles) < S:
                continue
            placements = pipeline_placements(link, world, S)
            if spec is not None and spec.pp_tier:
                placements = [p for p in placements if p[0] == spec.pp_tier]
            for placement in placements:
                # the stage cuts + DP-edge bucket search depend only on
                # (S, placement); only bubble/p2p vary with M
                dp = pipeline_dp_plan(
                    layer_profiles, link, world, S, candidates=candidates,
                    bucket_grid=bucket_grid,
                    dense_small_bytes=dense_small_bytes, mean=mean,
                    dp_net=placement[1], cost_table=cost_table)
                for M in micro_grid:
                    act = (pipeline.global_tokens / (world // S) / M
                           * pipeline.bytes_per_token)
                    arm = pipeline_arm(
                        layer_profiles, link, world, S, M, act,
                        opt_name=opt_name, opt_moments=opt_moments,
                        dp_plan=dp, placement=placement,
                        cost_table=cost_table)
                    arms[arm.key] = arm
    if tensor is not None and world > 1:
        tp_grid = tensor.tp_grid
        if spec is not None and spec.tp > 1:
            tp_grid = (spec.tp,)
        for tp in tp_grid:
            if tp < 2 or world % tp != 0:
                continue
            placements = model_axis_placements(link, world, tp)
            if spec is not None and spec.tp_tier:
                placements = [p for p in placements if p[0] == spec.tp_tier]
            for placement in placements:
                arm = tensor_parallel_arm(
                    layer_profiles, link, world, tp, tensor,
                    candidates=candidates, bucket_grid=bucket_grid,
                    dense_small_bytes=dense_small_bytes, mean=mean,
                    opt_name=opt_name, opt_moments=opt_moments,
                    placement=placement, cost_table=cost_table)
                arms[arm.key] = arm
    if expert is not None and world > 1:
        ep_grid = expert.ep_grid
        if spec is not None and spec.ep > 1:
            ep_grid = (spec.ep,)
        for ep in ep_grid:
            if ep < 2 or world % ep != 0:
                continue
            placements = model_axis_placements(link, world, ep)
            if spec is not None and spec.ep_tier:
                placements = [p for p in placements if p[0] == spec.ep_tier]
            for placement in placements:
                arm = expert_parallel_arm(
                    layer_profiles, link, world, ep, expert,
                    candidates=candidates, bucket_grid=bucket_grid,
                    dense_small_bytes=dense_small_bytes, mean=mean,
                    opt_name=opt_name, opt_moments=opt_moments,
                    placement=placement, cost_table=cost_table)
                arms[arm.key] = arm
    if straggler_s > 0.0:
        # price the straggler on every arm (the decision record stays
        # honest): rounds/step is 1 except for local-SGD's 1/τ cadence
        for key, a in list(arms.items()):
            rps = (1.0 / max(a.schedule.period, 1)
                   if a.schedule.kind == "local_sgd" else 1.0)
            arms[key] = dataclasses.replace(
                a, modeled_step_s=a.modeled_step_s
                + straggler_penalty_s(straggler_s, rps))
    pool = list(arms.values())
    if spec is not None:
        pool = [a for a in pool if _arm_matches_spec(a, spec)]
        if not pool:
            raise ValueError(
                f"parallelism spec {spec.spec()!r} matches no priced arm "
                f"on world={world} ({link.spec() if isinstance(link, Topology) else link}) "
                f"— the requested factorization is outside the search "
                f"space (combined tp×pp/tp×ep placements are not searched; "
                f"check the axis grids and tier divisibility)")
    if memory_budget_bytes is not None:
        fits = [a for a in pool if a.opt_mem_bytes <= memory_budget_bytes]
        pool = fits or [min(pool, key=lambda s: s.opt_mem_bytes)]
    best = min(pool, key=lambda s: s.modeled_step_s)
    return best, arms


def _arm_matches_spec(arm: StrategyPlan, spec: "ParallelismSpec") -> bool:
    """Exact-match filter for a pinned :class:`ParallelismSpec`: the arm
    must carry the requested (tp, pp, ep, shard) sizes, the named tiers
    when given, and the micro-batch count when set.  every_step / local
    SGD arms only match the trivial (pure-dp) spec."""
    if (arm.tp, arm.pipeline_stages, arm.ep) != (spec.tp, spec.pp, spec.ep):
        return False
    if arm.shard_state != spec.shard_state:
        return False
    if spec.tp > 1 and spec.tp_tier and arm.tp_tier != spec.tp_tier:
        return False
    if spec.ep > 1 and spec.ep_tier and arm.ep_tier != spec.ep_tier:
        return False
    if spec.pp > 1:
        if spec.pp_tier and arm.pipe_tier != spec.pp_tier:
            return False
        if spec.micro_batches and arm.micro_batches != spec.micro_batches:
            return False
    return True


def fixed_config_plan(layer_profiles: Sequence[LayerProfile],
                      link, world: int, compressor: str,
                      algo: str,
                      compressor_args: Tuple[Tuple[str, Any], ...] = (),
                      bucket_bytes: int = 32 * 2**20,
                      mean: bool = True,
                      shard_state: bool = False,
                      cost_table: Optional[CompressionCostTable] = None
                      ) -> CommPlan:
    """The degenerate plan a single global ``SyncConfig`` induces — every
    bucket gets the same strategy.  Used to score fixed baselines with the
    same simulator the planner optimises."""
    bps = []
    for leaves in _form_buckets(layer_profiles, bucket_bytes):
        n_bytes = sum(layer_profiles[i].grad_bytes for i in leaves)
        bps.append(BucketPlan(
            leaves=leaves, compressor=compressor,
            compressor_args=compressor_args, algo=algo,
            bucket_bytes=int(n_bytes)))
    p = CommPlan(buckets=tuple(bps), mean=mean, world=world, link=link,
                 shard_state=shard_state)
    return dataclasses.replace(
        p, modeled_step_s=plan_cost_s(p, layer_profiles, link, world,
                                      cost_table=cost_table))


# ---------------------------------------------------------------------------
# Serving placement (DESIGN.md §12)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServingPlan:
    """One serving arm: ``tp``-way sharded decode with its collectives on
    ``tp_tier``, replicated ``replicas`` times over the remaining world."""
    tp: int
    tp_tier: str                # "" on a flat network
    replicas: int
    step_s: float               # one decode step of one replica
    tokens_per_s: float         # batch * replicas / step_s

    def key(self) -> str:
        tier = self.tp_tier or "flat"
        return f"tp{self.tp}@{tier}x{self.replicas}"

    def describe(self) -> str:
        return (f"{self.key()}: step {self.step_s*1e3:.3f} ms, "
                f"{self.tokens_per_s:,.0f} tok/s")


def serving_placements(net, world: int, tp: int) -> List[Tuple[str, Any]]:
    """Tier placements for a tp-way decode group: ``[(tier_name,
    tp_net), ...]`` where ``tp_net`` prices the group's allreduces.  Flat
    networks have the single historical placement; on a tiered topology
    every tier tp divides is an arm (TP across nodes is expressible —
    and the planner will duly price it out of contention)."""
    if tp == 1:
        return [("", net)]
    if not isinstance(net, Topology):
        return [("", net)]
    if net.world != world:
        raise ValueError(f"topology world {net.world} != world {world}")
    out = []
    for ti, tier in enumerate(net.tiers):
        if tier.size % tp != 0:
            continue
        placed, _ = net.place(tp, ti)
        out.append(("" if net.is_flat else tier.name, placed.link))
    return out


def plan_serving(net, world: int, param_bytes: float, n_layers: int,
                 d_model: int, batch: int,
                 tp_grid: Sequence[int] = (1, 2, 4, 8, 16),
                 latency_budget_s: Optional[float] = None,
                 act_bytes: int = 2
                 ) -> Tuple[ServingPlan, List[ServingPlan]]:
    """Choose the decode sharding for a serving fleet of ``world`` chips:
    search tp degree x tier placement, price one batched decode step via
    :func:`~repro_torch.core.schedule.cost.decode_step_cost_s`, replicate the
    chosen group over the rest of the world, and keep the arm with the
    highest aggregate tokens/s (optionally subject to a per-step latency
    budget).  Returns ``(best, all_arms)`` — the arms feed
    ``launch/report.render_serving_plan``."""
    from repro_torch.core.schedule.cost import decode_step_cost_s
    arms: List[ServingPlan] = []
    for tp in tp_grid:
        if tp > world or world % tp != 0:
            continue
        for tier_name, tp_net in serving_placements(net, world, tp):
            step = decode_step_cost_s(param_bytes, n_layers, d_model,
                                      batch, tp, tp_net,
                                      act_bytes=act_bytes)
            replicas = world // tp
            arms.append(ServingPlan(
                tp=tp, tp_tier=tier_name, replicas=replicas, step_s=step,
                tokens_per_s=batch * replicas / step))
    if not arms:
        raise ValueError(f"no serving arm fits world={world} "
                         f"with tp_grid={tuple(tp_grid)}")
    pool = arms
    if latency_budget_s is not None:
        fits = [a for a in pool if a.step_s <= latency_budget_s]
        pool = fits or [min(pool, key=lambda a: a.step_s)]
    best = max(pool, key=lambda a: a.tokens_per_s)
    return best, arms
