"""The plan types of the communication planner, copied from
``repro/core/schedule/planner.py``: ``BucketPlan``, ``CommPlan`` and the
greedy tensor-fusion rule ``form_bucket_indices``.  The planner's search
(``--sync auto``) is not ported yet (ROADMAP.md queue 1, item 7), nor is
``BucketPlan.fused``, which only the planner sets to False: the port's
buckets always run the compressors' fused hooks."""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Sync strategy for one fused gradient bucket.

    ``leaves`` are indices into the flattened gradient tree, listed in the
    order they are packed.  ``pack=False`` buckets hold exactly one leaf and
    operate on it in its natural shape (no flatten/concat).
    """
    leaves: Tuple[int, ...]
    compressor: str = "none"
    compressor_args: Tuple[Tuple[str, Any], ...] = ()
    algo: str = "psum"
    bucket_bytes: int = 0          # dense f32 bytes fused in this bucket
    pack: bool = True
    error_feedback: bool = True
    ef_decay: float = 1.0


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """An ordered per-bucket communication schedule (DESIGN.md §6)."""
    buckets: Tuple[BucketPlan, ...]
    mean: bool = True              # divide by world size after reduce
    modeled_step_s: float = float("nan")   # simulated iteration time
    world: int = 1
    link: Optional[Any] = None
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


def form_bucket_indices(leaf_bytes: Sequence[float],
                        bucket_bytes: float) -> List[Tuple[int, ...]]:
    """THE greedy tensor-fusion rule: walk leaves in backward order
    (reversed), close the current bucket when adding the next leaf would
    exceed ``bucket_bytes``; ``bucket_bytes <= 0`` means one bucket per
    leaf."""
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
