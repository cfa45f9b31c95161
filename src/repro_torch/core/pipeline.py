"""The pipeline schedule arithmetic the planner prices with (survey
§3.1.3 / §3.3; GPipe, PipeDream): a copy of the host-side half of
``repro/core/pipeline.py``, held to it by ``tests/test_torch_planner.py``.

  * :func:`balanced_cuts` — contiguous S-way partition of per-cell costs
    minimizing the max stage cost (per-cell FLOPs taken ∝ parameter
    bytes, as ``profiles_from_sizes`` does for backward time);
  * :func:`schedule_1f1b` — the canonical one-forward-one-backward order
    per stage (warmup ``S-1-s`` forwards, steady 1F/1B, drain);
  * :func:`simulate_1f1b` — dependency-driven timeline of that order;
  * :func:`bubble_fraction` — ``(S-1)/(S-1+M)``, the idle fraction the
    simulation realises for uniform stages;
  * :func:`aligned_ticks` / :func:`aligned_order` — the SPMD slot grid of
    the reference's pipeline executor (DESIGN.md §9);
  * :func:`stage_param_bytes` — per-stage parameter bytes under the
    balanced cut;
  * :class:`StageLayout` / :class:`StagedModel` — the model cut into
    homogeneous stages of layer rows, the surface the 1F1B train step
    (``launch/steps.py:make_pipeline_train_step``) runs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._tree import tree_map

# t_forward / t_backward for the matmul-dominated stacks this repo models:
# profile_backward() returns 2/3 of a grad step as backward, so forward is
# half the backward.  The 1F1B bubble idles BOTH passes, which is why the
# planner's pipeline arm charges bubble * (1 + PIPE_FWD_FRACTION) * t_bwd.
PIPE_FWD_FRACTION = 0.5


def bubble_fraction(n_stages: int, micro_batches: int) -> float:
    """Idle fraction of the canonical 1F1B (and GPipe) timeline with
    uniform stages: (S-1)/(S-1+M)."""
    s, m = int(n_stages), int(micro_batches)
    if s <= 1:
        return 0.0
    if m < 1:
        raise ValueError(f"micro_batches must be >= 1, got {m}")
    return (s - 1) / (s - 1 + m)


# ---------------------------------------------------------------------------
# Stage-cut search
# ---------------------------------------------------------------------------

def balanced_cuts(costs: Sequence[float], n_stages: int) -> List[int]:
    """Contiguous partition of ``costs`` into ``n_stages`` parts minimizing
    the maximum part sum (the classic linear-partition DP) — the stage-cut
    search.  Returns boundaries ``cuts`` with ``len == n_stages + 1``,
    ``cuts[0] == 0``, ``cuts[-1] == len(costs)``; stage s covers cells
    ``costs[cuts[s]:cuts[s+1]]``.  Parts are never empty (requires
    ``len(costs) >= n_stages``)."""
    n, s = len(costs), int(n_stages)
    if s < 1:
        raise ValueError(f"n_stages must be >= 1, got {s}")
    if n < s:
        raise ValueError(f"cannot cut {n} cells into {s} stages")
    prefix = np.concatenate([[0.0], np.cumsum(np.asarray(costs, float))])
    # dp[k][i] = minimal max-part-sum splitting costs[:i] into k parts
    INF = float("inf")
    dp = [[INF] * (n + 1) for _ in range(s + 1)]
    cut = [[0] * (n + 1) for _ in range(s + 1)]
    dp[0][0] = 0.0
    for k in range(1, s + 1):
        for i in range(k, n - (s - k) + 1):
            for j in range(k - 1, i):
                if dp[k - 1][j] == INF:
                    continue
                cand = max(dp[k - 1][j], prefix[i] - prefix[j])
                if cand < dp[k][i]:
                    dp[k][i] = cand
                    cut[k][i] = j
    bounds = [n]
    i = n
    for k in range(s, 0, -1):
        i = cut[k][i]
        bounds.append(i)
    return bounds[::-1]


def stage_costs(costs: Sequence[float], cuts: Sequence[int]) -> List[float]:
    """Per-stage cost sums under ``cuts`` (from :func:`balanced_cuts`)."""
    return [float(sum(costs[cuts[s]:cuts[s + 1]]))
            for s in range(len(cuts) - 1)]


# ---------------------------------------------------------------------------
# The 1F1B schedule
# ---------------------------------------------------------------------------

def schedule_1f1b(n_stages: int, micro_batches: int
                  ) -> List[List[Tuple[str, int]]]:
    """Canonical non-interleaved 1F1B order (PipeDream-flush): stage ``s``
    runs ``S-1-s`` warmup forwards, then alternates one-forward-one-backward
    while forwards remain, then drains the outstanding backwards.  Returns
    one op list per stage, ops as ``("F", m)`` / ``("B", m)``; every stage
    emits exactly M forwards and M backwards, with at most ``S - s``
    micro-batches in flight (the memory bound that is 1F1B's point)."""
    S, M = int(n_stages), int(micro_batches)
    if S < 1 or M < 1:
        raise ValueError((S, M))
    out: List[List[Tuple[str, int]]] = []
    for s in range(S):
        warmup = min(S - 1 - s, M)
        ops: List[Tuple[str, int]] = [("F", m) for m in range(warmup)]
        nf, nb = warmup, 0
        while nb < M:
            if nf < M:
                ops.append(("F", nf))
                nf += 1
            ops.append(("B", nb))
            nb += 1
        out.append(ops)
    return out


def simulate_1f1b(n_stages: int, micro_batches: int, t_f: float, t_b: float,
                  t_send: float = 0.0) -> float:
    """Dependency-driven makespan of the canonical 1F1B order: F(m)@s needs
    F(m)@(s-1) (+ one activation send), B(m)@s needs B(m)@(s+1) (+ one
    grad-activation send) and its own F(m); each stage executes its
    :func:`schedule_1f1b` list in order on one execution unit.  For uniform
    stages and ``t_send=0`` this lands exactly on
    ``(M + S - 1) * (t_f + t_b)`` — i.e. :func:`bubble_fraction` of the
    timeline is idle."""
    S, M = int(n_stages), int(micro_batches)
    sched = schedule_1f1b(S, M)
    ptr = [0] * S
    free = [0.0] * S
    end: Dict[Tuple[str, int, int], float] = {}
    remaining = sum(len(ops) for ops in sched)
    while remaining:
        best_s, best_start = -1, float("inf")
        for s in range(S):
            if ptr[s] >= len(sched[s]):
                continue
            op, m = sched[s][ptr[s]]
            if op == "F":
                # activation arrives from the left neighbour (one send)
                dep = 0.0 if s == 0 else end.get(("F", s - 1, m))
                hop = t_send if s > 0 else 0.0
            elif s == S - 1:
                # last stage seeds the backward from its own forward
                dep = end.get(("F", s, m))
                hop = 0.0
            else:
                # grad-activation arrives from the right neighbour
                dep = end.get(("B", s + 1, m))
                hop = t_send
            if dep is None:
                continue                     # dependency not yet scheduled
            start = max(free[s], dep + hop)
            if start < best_start:
                best_s, best_start = s, start
        if best_s < 0:
            raise RuntimeError("1F1B schedule deadlocked (bug)")
        s = best_s
        op, m = sched[s][ptr[s]]
        dur = t_f if op == "F" else t_b
        end[(op, s, m)] = best_start + dur
        free[s] = best_start + dur
        ptr[s] += 1
        remaining -= 1
    return max(free)


def aligned_ticks(n_stages: int, micro_batches: int) -> int:
    """Number of slot-grid ticks the SPMD executor runs: the boundary
    ppermutes are collective rendezvous, so F-slots and B-slots are globally
    aligned; earliest-start on that grid puts F(m)@s at tick ``m + s`` and
    B(m)@s at tick ``m + 2(S-1) - s`` — T = M + 2(S-1) ticks, at most
    ``2(S-1-s) + 1`` micro-batches in flight at stage s (still O(S); see
    DESIGN.md §9)."""
    S, M = int(n_stages), int(micro_batches)
    return M + 2 * (S - 1)


def aligned_order(n_stages: int, micro_batches: int
                  ) -> List[List[Tuple[str, int]]]:
    """Per-stage op order realized by the aligned slot grid (for tests:
    same relative F order, same relative B order, F(m) before B(m) as
    :func:`schedule_1f1b`, deeper warmup)."""
    S, M = int(n_stages), int(micro_batches)
    out = []
    for s in range(S):
        ops: List[Tuple[str, int]] = []
        for k in range(aligned_ticks(S, M)):
            mf = k - s
            if 0 <= mf < M:
                ops.append(("F", mf))
            mb = k - 2 * (S - 1) + s
            if 0 <= mb < M:
                ops.append(("B", mb))
        out.append(ops)
    return out


# ---------------------------------------------------------------------------
# Staged models
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StageLayout:
    """Static geometry of a staged model: ``rows`` layer rows split into
    ``n_stages`` equal groups of ``rows_per_stage`` (homogeneous stages:
    every pipe rank runs the same program on its own rows)."""
    n_stages: int
    rows: int
    rows_per_stage: int


class StagedModel:
    """Pipeline adapter for a ``repro_torch.models.Model`` (the
    reference's ``StagedModel``).

    Params split into a SHARED part (embed, final norm, lm head; every
    stage holds it, stage 0 owning the embedding's gradient and stage S-1
    the loss tail's) and the stack's layer ROWS: the single segment's
    ``(R, ...)`` leaves cut into S groups of R/S rows.  Staging needs a
    decoder-only model whose stack is ONE segment (a homogeneous period)
    with ``repeats % S == 0``: every stage runs the same program on its
    own rows.  Anything else is refused with the reference's errors."""

    def __init__(self, model, n_stages: int):
        self.model = model
        self.cfg = model.cfg
        S = int(n_stages)
        if self.cfg.is_encoder_decoder:
            raise ValueError("pipeline staging supports decoder-only "
                             "models; encoder-decoder stacks have no single "
                             "layer chain to cut")
        plan = model.plan
        if len(plan) != 1:
            raise ValueError(
                f"pipeline staging requires a homogeneous scannable stack "
                f"(one segment); {self.cfg.name!r} lowers to {len(plan)} "
                f"segments {[(len(s.period), s.repeats) for s in plan]}")
        seg = plan[0]
        R = seg.repeats
        if R % S != 0:
            raise ValueError(f"stack repeats {R} not divisible by "
                             f"n_stages {S}")
        if R == 1 and S != 1:
            raise ValueError(f"single-row stack cannot be cut into {S} "
                             f"stages")
        self.seg = seg
        self.layout = StageLayout(n_stages=S, rows=R, rows_per_stage=R // S)
        self.aux_coef = float(self.cfg.router_aux_coef)

    # -- params --------------------------------------------------------------

    def split(self, params, stage: Optional[int] = None):
        """params -> (shared, rows).  ``stage=None``: every stage's rows,
        leaves reshaped (R, ...) -> (S, R/S, ...) (views).  ``stage=s``:
        only stage s's (R/S, ...) rows, copied out of the stack so that
        the whole stack can be freed — the process of one stage keeps no
        other stage's rows."""
        shared = {k: v for k, v in params.items() if k != "stack"}
        stack = params["stack"][0]          # the single segment
        S, rps = self.layout.n_stages, self.layout.rows_per_stage
        if self.layout.rows == 1:
            stack = tree_map(lambda x: x[None], stack)
        if stage is None:
            return shared, tree_map(
                lambda x: x.reshape((S, rps) + tuple(x.shape[1:])), stack)
        if not 0 <= stage < S:
            raise ValueError(f"stage {stage} of {S}")
        lo = stage * rps
        return shared, tree_map(
            lambda x: x if S == 1 else x[lo:lo + rps].clone(), stack)

    def init_stage(self, generator: torch.Generator, stage: int, dtype=None):
        """Stage ``stage``'s ``(shared, rows)``, equal to ``split(
        model.init(generator, dtype), stage=stage)`` — the same draws in
        the same leaf order — with each stack leaf cut to the stage's rows
        as soon as it is drawn: no other stage's rows outlive the drawing
        of one leaf."""
        S, rps = self.layout.n_stages, self.layout.rows_per_stage
        if S == 1 or not 0 <= stage < S:
            raise ValueError(f"stage {stage} of {S}")
        params = self.model.init(generator, dtype,
                                 rows=slice(stage * rps, (stage + 1) * rps))
        shared = {k: v for k, v in params.items() if k != "stack"}
        return shared, params["stack"][0]

    def merge(self, shared, rows_stacked):
        """Inverse of :meth:`split` with ``stage=None``: (S, R/S, ...) rows
        back to the stack's (R, ...) leaves."""
        R = self.layout.rows
        if R == 1:
            stack = tree_map(lambda x: x[0, 0], rows_stacked)
        else:
            stack = tree_map(
                lambda x: x.reshape((R,) + tuple(x.shape[2:])), rows_stacked)
        out = dict(shared)
        out["stack"] = [stack]
        return out

    # -- stage programs ------------------------------------------------------

    def embed_mb(self, shared, tokens):
        """Input cell: the token embedding of one micro-batch (stage 0)."""
        return self.model._embed(shared, tokens)

    def stage_apply(self, rows, h):
        """One stage: its ``rows_per_stage`` period rows in sequence, every
        block checkpointed while autograd records (the policy of
        ``transformer.stack_train``).  Returns (h, aux): the blocks' MoE
        aux losses summed in f32 in layer order (a zero for dense
        blocks)."""
        from repro_torch.models import transformer
        cfg, seg = self.cfg, self.seg
        positions = torch.arange(h.shape[1], device=h.device)[None, :]
        remat = torch.is_grad_enabled()
        aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
        for period in transformer._unstack(rows, self.layout.rows_per_stage):
            for spec, p in zip(seg.period, period):
                def blk(x, p=p, spec=spec):
                    return transformer.block_train(p, cfg, spec, x,
                                                   positions)
                h, aux = transformer.checkpointed(blk, h) if remat \
                    else blk(h)
                aux_total = aux_total + aux
        return h, aux_total

    def loss_tail(self, shared, h, tokens):
        """Head cell: final norm + chunked cross-entropy (stage S-1), with
        ``Model.loss``'s label convention (the last position masked)."""
        from repro_torch.models.layers import rmsnorm
        labels = torch.cat([tokens[:, 1:], -torch.ones_like(tokens[:, :1])],
                           dim=1)
        h = rmsnorm(shared["final_norm"], h, eps=self.cfg.norm_eps)
        return self.model._chunked_xent(shared, h, labels)


def stage_param_bytes(leaf_bytes: Sequence[float], n_stages: int
                      ) -> List[float]:
    """Per-stage parameter bytes under the balanced cut of ``leaf_bytes``
    (the planner's stage-memory and DP-edge model — leaves in tree order
    are treated as the cuttable cells)."""
    cuts = balanced_cuts(leaf_bytes, n_stages)
    return stage_costs(leaf_bytes, cuts)
