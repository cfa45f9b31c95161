"""Shard layout for sharded data parallelism (ZeRO-style, DESIGN.md §8) —
the port of ``repro/core/shard_state.py``.

Sharded DP partitions the per-bucket flat state — f32 master parameters
and optimizer moments — over the data axes: the canonical owner of chunk
w of a bucket is the rank at row-major mesh position w over the axes
(``collectives.my_chunk_index``).  This module is the single source of
truth for that layout:

  * the NESTED chunking rule (pad to p1 chunks of m1 = ceil(n/p1), each of
    those to p2 chunks of m2 = ceil(m1/p2), ...) — the host-side twin of
    ``collectives.pad_to_chunks``, so state initialised here lands
    exactly where the reduce-scatter edge delivers gradient chunks;
  * host-side pack / shard / unshard conversions on numpy (``shard_rows``,
    ``tree_from_rows``, ``reshard``: every rank's rows at once, for tests
    and checkpoint resharding);
  * the rank's own rows on its device (:meth:`ShardLayout.my_rows`) and
    the collective inverse (:meth:`ShardLayout.gather_tree`): one process
    is one worker, so a rank holds only its (m,) row of each bucket, where
    the reference holds every rank's (world, m) rows in one program;
  * per-element leaf segment ids (layerwise optimizers — LAMB/LARS trust
    ratios need per-LAYER norms, which a shard only partially sees);
  * the optimizer-memory accounting the planner and report use.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch._tree import tree_leaves
from repro_torch.core.collectives.api import (Axes, all_gather_shards,
                                              local_chunk)
from repro_torch.core.grad_sync import _unflatten
from repro_torch.core.schedule.planner import OPT_MOMENTS, CommPlan


def nested_ms(n: int, axis_sizes: Sequence[int]) -> List[int]:
    """Per-level chunk lengths [m1, m2, ...]; the last entry is the
    per-rank shard length."""
    ms, cur = [], int(n)
    for p in axis_sizes:
        cur = -(-cur // int(p))
        ms.append(cur)
    return ms


def chunk_rows(flat: np.ndarray, axis_sizes: Sequence[int]) -> np.ndarray:
    """Host twin of ``collectives.pad_to_chunks``: (n,) -> (world, m) with
    row w = the canonical chunk owned by rank w."""
    arr = np.asarray(flat).reshape(1, -1)
    for p in axis_sizes:
        p = int(p)
        n = arr.shape[-1]
        m = -(-n // p)
        arr = np.pad(arr, [(0, 0)] * (arr.ndim - 1) + [(0, p * m - n)])
        arr = arr.reshape(arr.shape[:-1] + (p, m))
    return arr.reshape(-1, arr.shape[-1])


def rows_to_flat(rows: np.ndarray, n: int,
                 axis_sizes: Sequence[int]) -> np.ndarray:
    """Inverse of :func:`chunk_rows`: (world, m) canonical rows -> (n,)."""
    sizes = [int(p) for p in axis_sizes]
    ms = nested_ms(n, sizes)
    lens = [int(n)] + ms[:-1]
    arr = np.asarray(rows).reshape(tuple(sizes) + (ms[-1],))
    for ln in reversed(lens):
        arr = arr.reshape(arr.shape[:-2] + (arr.shape[-2] * arr.shape[-1],))
        arr = arr[..., :ln]
    return arr.reshape(-1)


def _np_f32(t: torch.Tensor) -> np.ndarray:
    """A tensor as a flat f32 numpy array (bf16 widened exactly)."""
    return t.detach().to("cpu", torch.float32).reshape(-1).numpy()


@dataclasses.dataclass(frozen=True)
class BucketShard:
    """Static shard geometry of one fused bucket."""
    leaves: Tuple[int, ...]        # leaf ids, in packed order
    sizes: Tuple[int, ...]         # element count per packed leaf
    n: int                         # unpadded bucket elements
    m: int                         # per-rank shard elements (nested ceil)


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """Canonical sharded layout of a ``CommPlan``'s buckets over the data
    axes (``axis_sizes`` in axis order; world = their product)."""
    axis_sizes: Tuple[int, ...]
    buckets: Tuple[BucketShard, ...]
    leaf_shapes: Tuple[Tuple[int, ...], ...]
    leaf_dtypes: Tuple[Any, ...]

    @property
    def world(self) -> int:
        w = 1
        for p in self.axis_sizes:
            w *= int(p)
        return w

    @property
    def n_leaves(self) -> int:
        return len(self.leaf_shapes)

    @classmethod
    def from_plan(cls, plan: CommPlan, params,
                  axis_sizes: Sequence[int]) -> "ShardLayout":
        leaves = tree_leaves(params)
        sizes = tuple(int(np.prod(tuple(l.shape))) for l in leaves)
        buckets = []
        for b in plan.buckets:
            bs = tuple(sizes[i] for i in b.leaves)
            n = int(sum(bs))
            buckets.append(BucketShard(
                leaves=tuple(b.leaves), sizes=bs, n=n,
                m=nested_ms(n, axis_sizes)[-1] if n else 0))
        claimed = sorted(i for b in buckets for i in b.leaves)
        if claimed != list(range(len(leaves))):
            raise ValueError(f"plan does not cover the pytree: {claimed} "
                             f"vs {len(leaves)} leaves")
        return cls(axis_sizes=tuple(int(p) for p in axis_sizes),
                   buckets=tuple(buckets),
                   leaf_shapes=tuple(tuple(l.shape) for l in leaves),
                   leaf_dtypes=tuple(l.dtype for l in leaves))

    # -- host-side conversions (tests / checkpoint resharding) ---------------

    def _pack_np(self, leaves, b: BucketShard) -> np.ndarray:
        return np.concatenate([_np_f32(leaves[i]) for i in b.leaves])

    def shard_rows(self, tree) -> List[torch.Tensor]:
        """Pack a leaf-shaped tree into per-bucket canonical shard rows
        [(world, m_b) f32, on the host]: every rank's rows at once."""
        leaves = tree_leaves(tree)
        return [torch.from_numpy(chunk_rows(self._pack_np(leaves, b),
                                            self.axis_sizes))
                for b in self.buckets]

    def tree_from_rows(self, rows, like) -> Any:
        """Inverse of :func:`shard_rows`: reassemble the full leaf-shaped
        tree (f32, on the host) from every rank's per-bucket rows.
        ``like`` supplies the tree structure; values come entirely from
        ``rows``."""
        out: List[Any] = [None] * len(tree_leaves(like))
        for b, r in zip(self.buckets, rows):
            flat = rows_to_flat(_np_f32(r).reshape(self.world, -1), b.n,
                                self.axis_sizes)
            off = 0
            for i, sz in zip(b.leaves, b.sizes):
                out[i] = torch.from_numpy(
                    flat[off:off + sz].reshape(self.leaf_shapes[i]).copy())
                off += sz
        return _unflatten(like, out)

    def reshard(self, rows, new_axis_sizes: Sequence[int]
                ) -> Tuple["ShardLayout", List[torch.Tensor]]:
        """Move saved shard rows to a different mesh shape (checkpoint
        restore on a new world size): returns (new_layout, new_rows).
        Full state round-trips bit-equal because both layouts chunk the
        same canonical flat buffer — including NON-DIVISOR world changes
        (8 → 6 → 8): nested ceil-chunking only pads the tail, it never
        requires the old and new worlds to divide each other.  Invalid
        target shapes (empty, zero or negative axes, non-integers) fail
        loudly here instead of producing silently misaligned rows."""
        sizes = tuple(new_axis_sizes)
        if not sizes or any(int(p) != p or int(p) < 1 for p in sizes):
            raise ValueError(
                f"cannot reshard to axis sizes {sizes!r}: every axis must "
                f"be a positive integer (world = their product)")
        new = dataclasses.replace(
            self, axis_sizes=tuple(int(p) for p in new_axis_sizes),
            buckets=tuple(dataclasses.replace(
                b, m=nested_ms(b.n, new_axis_sizes)[-1])
                for b in self.buckets))
        out = []
        for b, r in zip(self.buckets, rows):
            flat = rows_to_flat(_np_f32(r).reshape(self.world, -1), b.n,
                                self.axis_sizes)
            out.append(torch.from_numpy(chunk_rows(flat, new.axis_sizes)))
        return new, out

    # -- this rank's rows (the port: one process is one worker) --------------

    def my_rows(self, tree, axes: Axes) -> List[torch.Tensor]:
        """This rank's (m_b,) f32 row of every bucket of a leaf-shaped
        tree, on the tree's device: each bucket is packed there and its
        canonical chunk (``collectives.local_chunk``) kept, so no host
        copy of every rank's rows is ever made.  The rows own their
        memory (never views of a parameter)."""
        leaves = tree_leaves(tree)
        rows = []
        for b in self.buckets:
            flat = torch.cat([leaves[i].detach().reshape(-1)
                              .to(torch.float32) for i in b.leaves])
            row = local_chunk(flat, axes, self.axis_sizes)
            rows.append(row if row.numel() == flat.numel() else row.clone())
            del flat
        return rows

    def gather_tree(self, rows, like, axes: Axes) -> Any:
        """The full leaf-shaped f32 tree of per-bucket rows (a collective:
        every rank calls it, every rank gets the tree), on the rows'
        device; ``like`` supplies the structure."""
        out: List[Any] = [None] * len(tree_leaves(like))
        for b, r in zip(self.buckets, rows):
            flat = all_gather_shards(r, b.n, "psum", axes)
            off = 0
            for i, sz in zip(b.leaves, b.sizes):
                out[i] = flat[off:off + sz].reshape(self.leaf_shapes[i])
                off += sz
        return _unflatten(like, out)

    # -- layerwise-optimizer support -----------------------------------------

    def seg_rows(self, b_idx: int) -> np.ndarray:
        """(world, m) int32 leaf-segment id per padded slot of bucket
        ``b_idx`` (padding slots get the sentinel id ``n_leaves``): rank w
        indexes row w to segment-sum its partial per-layer norms."""
        b = self.buckets[b_idx]
        ids = np.concatenate([np.full(sz, i, np.int32)
                              for i, sz in zip(b.leaves, b.sizes)])
        rows = chunk_rows(ids.astype(np.float64) + 1.0, self.axis_sizes)
        # padding became 0.0 under chunk_rows; shift back so real ids are
        # exact and padding maps to the sentinel
        rows = rows.astype(np.int64) - 1
        rows[rows < 0] = self.n_leaves
        return rows.astype(np.int32)

    # -- memory accounting (the report's headline number) --------------------

    def param_bytes(self) -> int:
        """Dense f32 bytes of the full parameter set."""
        return 4 * sum(b.n for b in self.buckets)

    def opt_bytes_per_worker(self, opt_name: str, sharded: bool,
                             moments: float = None) -> float:
        """f32 optimizer-state bytes per worker: ``moments`` buffers
        replicated, or (moments + the f32 master copy) over the 1/p shard
        (padded) when partitioned.  ``moments`` overrides the per-name
        worst-case default with the measured buffer count (sgd with
        momentum=0.0 carries none)."""
        mom = OPT_MOMENTS.get(opt_name, 2) if moments is None else moments
        if not sharded:
            return mom * self.param_bytes()
        return (mom + 1) * 4 * sum(b.m for b in self.buckets)


__all__ = ["nested_ms", "chunk_rows", "rows_to_flat", "BucketShard",
           "ShardLayout"]
