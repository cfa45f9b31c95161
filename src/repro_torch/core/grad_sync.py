"""Gradient synchronization — the port of ``repro/core/grad_sync.py``.

Every data-parallel training step runs

    grads -> [bucket] -> [error-feedback + compress] -> collective
          -> [decompress/aggregate] -> synced grads

``PlanExecutor`` takes a ``CommPlan`` (an ordered list of per-bucket
``BucketPlan(leaves, compressor, algo, ...)`` entries) and runs it over a
``torch.distributed`` process group, the port's counterpart of the
reference's manual ``shard_map`` data axes; the world size is the group's
size.  ``plan_from_config`` lowers one global ``SyncConfig`` to that plan
and ``GradientSynchronizer`` keeps the reference's single-config API.

Ported: the ``none``, ``int8_fused`` and ``topk_fused`` compressors, packed
and unpacked buckets, error feedback through the compressors' fused hooks
(the CUDA kernels on the card), the ``psum`` all-reduce, and the payload
all-gather with the fused decode.  Waiting (ROADMAP.md queue 1, item 2):
PowerSGD, ``sync_shards`` and ``sharded_plan_from_config`` (sharded DP,
item 8), the other collective algorithms, and the reference's
``BucketPlan.fused=False`` arm (the decomposed EF chain and the per-rank
decode loop), which only the planner sets (item 7).

Wire semantics (DESIGN.md §5): gather-pattern compressors all-gather their
compact payloads and every rank decompresses and averages; aggregatable
ones (``topk_fused``, dense) all-reduce directly.  EF residuals are
per-process state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.core.collectives import all_gather, allreduce, world_size
from repro_torch.core.collectives.api import check_algo
from repro_torch.core.compression import get_compressor
from repro_torch.core.schedule.planner import (BucketPlan, CommPlan,
                                               form_bucket_indices)

Group = Optional[dist.ProcessGroup]


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    compressor: str = "none"
    compressor_args: Tuple[Tuple[str, Any], ...] = ()
    algo: str = "psum"
    error_feedback: bool = True
    ef_decay: float = 1.0
    bucket_bytes: int = 32 * 1024 * 1024   # MG-WFBP fusion granularity
    mean: bool = True                      # divide by world size after reduce

    def make_compressor(self):
        return get_compressor(self.compressor, **dict(self.compressor_args))


def _numel(t: torch.Tensor) -> int:
    return int(t.numel())


def _div(x: torch.Tensor, denom: float) -> torch.Tensor:
    """``x / denom`` as one IEEE division per element on any device (on
    CUDA, PyTorch turns a division by a Python scalar into a reciprocal
    multiply)."""
    if denom == 1.0:
        return x
    return x / torch.tensor(denom, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# Bucketing (tensor fusion, MG-WFBP / Horovod-style)
# ---------------------------------------------------------------------------

def bucketize(grads, bucket_bytes: int):
    """Split the flattened gradient tree into ~bucket_bytes buckets in
    backward order (last layer first).  Returns (bucket_defs, pack, unpack)
    where bucket_defs is a list of lists of (leaf_index, size)."""
    leaves = tree_leaves(grads)
    sizes = [_numel(g) for g in leaves]
    buckets = [[(i, sizes[i]) for i in idxs]
               for idxs in form_bucket_indices([s * 4 for s in sizes],
                                               bucket_bytes)]

    def pack(gs):
        ls = tree_leaves(gs)
        return [torch.cat([ls[i].reshape(-1).to(torch.float32)
                           for i, _ in b]) for b in buckets]

    def unpack(bufs):
        out = [None] * len(leaves)
        for buf, b in zip(bufs, buckets):
            off = 0
            for i, sz in b:
                out[i] = buf[off:off + sz].reshape(leaves[i].shape).to(
                    leaves[i].dtype)
                off += sz
        return _unflatten(grads, out)

    return buckets, pack, unpack


def _unflatten(like, leaves: List[Any]):
    """A tree shaped like ``like`` holding ``leaves`` in leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def plan_from_config(cfg: SyncConfig, grads) -> CommPlan:
    """The one-strategy ``CommPlan`` a global ``SyncConfig`` induces:

      * ``compressor='none'`` — one dense bucket, leaves synced in their
        natural shapes;
      * ``bucket_bytes <= 0`` — per-leaf unpacked buckets in tree order;
      * otherwise             — ``bucketize`` fusion in backward order.

    (The reference's PowerSGD branch waits with PowerSGD.)"""
    leaves = tree_leaves(grads)
    sizes = [_numel(g) for g in leaves]
    if cfg.compressor == "none":
        buckets: Tuple[BucketPlan, ...] = (BucketPlan(
            leaves=tuple(range(len(leaves))), compressor="none",
            algo=cfg.algo, bucket_bytes=4 * sum(sizes), pack=False,
            error_feedback=False),)
    elif cfg.bucket_bytes <= 0:
        buckets = tuple(BucketPlan(
            leaves=(i,), compressor=cfg.compressor,
            compressor_args=cfg.compressor_args, algo=cfg.algo,
            bucket_bytes=4 * sizes[i], pack=False,
            error_feedback=cfg.error_feedback, ef_decay=cfg.ef_decay)
            for i in range(len(leaves)))
    else:
        defs, _, _ = bucketize(grads, cfg.bucket_bytes)
        buckets = tuple(BucketPlan(
            leaves=tuple(i for i, _ in b), compressor=cfg.compressor,
            compressor_args=cfg.compressor_args, algo=cfg.algo,
            bucket_bytes=4 * sum(sz for _, sz in b), pack=True,
            error_feedback=cfg.error_feedback, ef_decay=cfg.ef_decay)
            for b in defs)
    return CommPlan(buckets=buckets, mean=cfg.mean)


# ---------------------------------------------------------------------------
# The executor
# ---------------------------------------------------------------------------

class PlanExecutor:
    """Executes a ``CommPlan`` over a process group: per-bucket
    error-feedback + compression + collective exchange.

    State is carried per bucket: ``error`` holds the EF residual (a flat
    f32 buffer for packed buckets, leaf-shaped otherwise), None for buckets
    without EF; the key is omitted when no bucket uses EF.  A call writes
    the new residuals into the state's buffers in place (the reference
    donates them; the kernels write them there directly): at full width a
    second copy of the residuals, as large as the f32 parameters, would not
    fit beside the first."""

    def __init__(self, plan: CommPlan, group: Group = None):
        self.plan = plan
        self.group = group
        for b in plan.buckets:
            check_algo(b.algo)
        self.comps = [get_compressor(b.compressor, **dict(b.compressor_args))
                      for b in plan.buckets]
        for j, b in enumerate(plan.buckets):
            if not b.pack and b.compressor != "none" and len(b.leaves) != 1:
                raise ValueError(
                    f"bucket {j}: pack=False buckets operate on one leaf in "
                    f"its natural shape, got leaves={b.leaves}")
        for b, comp in zip(plan.buckets, self.comps):
            if (self._bucket_uses_ef(b) and comp.fused_ef_compress is None) \
                    or (b.compressor != "none" and not comp.aggregatable
                        and comp.fused_decode_sum is None):
                raise NotImplementedError(
                    f"compressor {b.compressor!r} has no fused hooks; the "
                    f"decomposed EF chain and per-rank decode are not "
                    f"ported yet (ROADMAP.md queue 1, item 2)")

    @staticmethod
    def _bucket_uses_ef(b: BucketPlan) -> bool:
        return b.error_feedback and b.compressor != "none"

    def _check_cover(self, n_leaves: int) -> None:
        """Every leaf must be claimed by exactly one bucket."""
        claimed = sorted(i for b in self.plan.buckets for i in b.leaves)
        if claimed != list(range(n_leaves)):
            raise ValueError(
                f"CommPlan does not cover the gradient tree exactly: "
                f"{n_leaves} leaves, bucket indices {claimed}")

    @staticmethod
    def _pack_bucket(leaves, idxs) -> torch.Tensor:
        return torch.cat([leaves[i].reshape(-1).to(torch.float32)
                          for i in idxs])

    @staticmethod
    def _unpack_bucket(buf, leaves, idxs, out) -> None:
        off = 0
        for i in idxs:
            sz = _numel(leaves[i])
            out[i] = buf[off:off + sz].reshape(leaves[i].shape).to(
                leaves[i].dtype)
            off += sz

    # -- state ---------------------------------------------------------------

    def init_state(self, grads) -> Dict[str, Any]:
        leaves = tree_leaves(grads)
        self._check_cover(len(leaves))
        state: Dict[str, Any] = {"step": 0}
        errors: List[Optional[torch.Tensor]] = []
        for b in self.plan.buckets:
            if not self._bucket_uses_ef(b):
                errors.append(None)
                continue
            dev = leaves[b.leaves[0]].device
            shape = ((sum(_numel(leaves[i]) for i in b.leaves),) if b.pack
                     else tuple(leaves[b.leaves[0]].shape))
            errors.append(torch.zeros(shape, dtype=torch.float32, device=dev))
        if any(e is not None for e in errors):
            state["error"] = errors
        return state

    # -- wire statistics (static) ---------------------------------------------

    def payload_bits(self, grads) -> int:
        """Bits leaving one rank per step (the survey's comparison metric)."""
        leaves = tree_leaves(grads)
        total = 0
        for b, comp in zip(self.plan.buckets, self.comps):
            if b.pack and len(b.leaves) > 1:
                sz = sum(_numel(leaves[i]) for i in b.leaves)
                total += comp.payload_bits((sz,))
            else:
                total += sum(comp.payload_bits(tuple(leaves[i].shape))
                             for i in b.leaves)
        return total

    # -- sync ------------------------------------------------------------------

    def _world(self) -> int:
        return world_size(self.group)

    def __call__(self, grads, state, rng=None):
        """Returns (synced_grads, new_state).  ``rng`` is accepted for the
        reference's signature; the ported compressors are deterministic."""
        plan = self.plan
        leaves = tree_leaves(grads)
        self._check_cover(len(leaves))
        denom = float(self._world()) if plan.mean else 1.0
        nb = len(plan.buckets)
        errors = state.get("error", [None] * nb)

        out: List[Optional[torch.Tensor]] = [None] * len(leaves)
        new_errors: List[Optional[torch.Tensor]] = []
        for j, (b, comp) in enumerate(zip(plan.buckets, self.comps)):
            if b.compressor == "none":
                if b.pack and len(b.leaves) > 1:
                    # fused dense exchange: ONE collective for the bucket
                    buf = self._pack_bucket(leaves, b.leaves)
                    synced = _div(allreduce(buf, b.algo, self.group), denom)
                    self._unpack_bucket(synced, leaves, b.leaves, out)
                else:
                    # unfused: leaves keep their natural shape (f32 out)
                    for i in b.leaves:
                        buf = leaves[i].to(torch.float32, copy=True)
                        out[i] = _div(allreduce(buf, b.algo, self.group),
                                      denom)
                new_errors.append(errors[j])
            elif not b.pack:
                out[b.leaves[0]] = self._sync_buffer(    # f32, leaf-shaped
                    leaves[b.leaves[0]].to(torch.float32), errors[j], b,
                    comp, denom)
                new_errors.append(errors[j])
            else:
                buf = self._pack_bucket(leaves, b.leaves)
                synced = self._sync_buffer(buf, errors[j], b, comp, denom)
                self._unpack_bucket(synced, leaves, b.leaves, out)
                new_errors.append(errors[j])
                del buf, synced

        new_state: Dict[str, Any] = {"step": state["step"] + 1}
        if "error" in state:
            new_state["error"] = new_errors
        return _unflatten(grads, out), new_state

    # EF + compress of one flat/leaf-shaped f32 buffer: with EF, the
    # compressor's fused one-pass hook, which writes the new residual into
    # e's buffer; without, its compress.  Both run the CUDA kernels on the
    # card.
    def _compress_with_ef(self, buf, e, b: BucketPlan, comp):
        if self._bucket_uses_ef(b):
            payload, meta, _ = comp.fused_ef_compress(buf, e, b.ef_decay)
            return payload, meta
        return comp.compress(buf, None)

    # EF + compress + exchange of one flat/leaf-shaped f32 buffer; returns
    # the synced f32 buffer.
    def _sync_buffer(self, buf, e, b: BucketPlan, comp, denom):
        payload, meta = self._compress_with_ef(buf, e, b, comp)
        if comp.aggregatable:
            reduced = comp.decompress(payload, meta).to(torch.float32)
            if reduced is buf:        # never all-reduce the caller's input
                reduced = reduced.clone()
            return _div(allreduce(reduced, b.algo, self.group), denom)
        return self._gather_mean(comp, payload, meta, denom)

    def _gather_mean(self, comp, payload, meta, denom):
        """All-gather the compact payloads over the group; every rank runs
        the compressor's fused decode (ONE dequantize + accumulate kernel
        pass over the gathered payloads) and divides (1-bit SGD / DGC wire
        pattern).  Payload tensors are gathered one by one, so the wire
        carries int8 and scales, not dense f32.  Static metadata (shapes)
        passes through."""
        def gather(x):
            return all_gather(x, self.group) \
                if isinstance(x, torch.Tensor) else x

        gathered = tree_map(gather, payload)
        return _div(comp.fused_decode_sum(gathered, meta), denom)


# ---------------------------------------------------------------------------
# Legacy single-config front-end (degenerate one-strategy plan)
# ---------------------------------------------------------------------------

class GradientSynchronizer:
    """One global ``SyncConfig`` applied to every bucket: lowers the config
    to a degenerate ``CommPlan`` and lets ``PlanExecutor`` run it."""

    def __init__(self, cfg: SyncConfig, group: Group = None):
        self.cfg = cfg
        self.group = group
        # eager validation: an unknown compressor or algo fails here
        self.comp = cfg.make_compressor()
        check_algo(cfg.algo)
        self._executor: Optional[PlanExecutor] = None
        self._plan_key = None

    def _exec_for(self, grads) -> PlanExecutor:
        # plans depend on the leaves' shapes (bucketize)
        key = tuple(tuple(g.shape) for g in tree_leaves(grads))
        if self._executor is None or key != self._plan_key:
            self._executor = PlanExecutor(plan_from_config(self.cfg, grads),
                                          self.group)
            self._plan_key = key
        return self._executor

    @property
    def plan(self) -> Optional[CommPlan]:
        return None if self._executor is None else self._executor.plan

    def init_state(self, grads) -> Dict[str, Any]:
        return self._exec_for(grads).init_state(grads)

    def payload_bits(self, grads) -> int:
        return self._exec_for(grads).payload_bits(grads)

    def __call__(self, grads, state, rng=None):
        return self._exec_for(grads)(grads, state, rng)


__all__ = ["SyncConfig", "bucketize", "plan_from_config", "PlanExecutor",
           "GradientSynchronizer"]
