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
    balanced cut.

The executor itself (``StagedModel`` and the 1F1B train step) is ROADMAP
queue 1, item 9; until then the planner prices pipeline arms and the
session runs the best arm that needs no pipeline mesh.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

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


def stage_param_bytes(leaf_bytes: Sequence[float], n_stages: int
                      ) -> List[float]:
    """Per-stage parameter bytes under the balanced cut of ``leaf_bytes``
    (the planner's stage-memory and DP-edge model — leaves in tree order
    are treated as the cuttable cells)."""
    cuts = balanced_cuts(leaf_bytes, n_stages)
    return stage_costs(leaf_bytes, cuts)
