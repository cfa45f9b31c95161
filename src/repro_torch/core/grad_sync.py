"""Gradient synchronization — the port of ``repro/core/grad_sync.py``.

Every data-parallel training step runs

    grads -> [bucket] -> [error-feedback + compress] -> collective
          -> [decompress/aggregate] -> synced grads

``PlanExecutor`` takes a ``CommPlan`` (an ordered list of per-bucket
``BucketPlan(leaves, compressor, algo, ...)`` entries) and runs it over the
data axes, given as ``group``: a tuple of ``torch.distributed`` process
groups, the port's counterpart of the reference's manual ``shard_map``
axes (``launch/dist.py:mesh_axes``), or one group for a one-axis mesh
(the default group when None).  The world size is the product
of the axes' sizes.  ``plan_from_config`` lowers one global ``SyncConfig``
to that plan and ``GradientSynchronizer`` keeps the reference's
single-config API.

Every compressor and every collective algorithm of the reference runs
here, with error feedback, PowerSGD's warm-started factors and the
compressors' fused hooks (the CUDA kernels on the card); a compressor
without fused hooks, or a bucket with ``BucketPlan.fused=False``, runs the
decomposed EF chain and the per-rank decode loop, as the reference does.
The planner (``core/schedule/planner.py``) mixes compressors, algorithms
and ``pack`` bucket by bucket in one plan.  Sharded data parallelism
(DESIGN.md §8) runs the same plan through :meth:`PlanExecutor.sync_shards`,
which returns this rank's canonical shard of each bucket's synced
gradient (the reduce-scatter edge), and ``sharded_plan_from_config``
lowers a ``SyncConfig`` to the packed plan that edge needs.

Wire semantics (DESIGN.md §5): gather-pattern compressors all-gather their
compact payloads and every rank decompresses and sums them in the
reference's rank order; aggregatable ones (PowerSGD's factors,
``topk_fused``, dense) all-reduce on the bucket's algorithm, and so does a
gather-pattern payload on ``ring_fused``, which reconstructs it locally
first.  EF residuals are per-process state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.core.collectives import all_gather, allreduce, world_size
from repro_torch.core.collectives.api import (Axes, as_axes, check_algo,
                                              local_chunk, reduce_scatter)
from repro_torch.core.compression import get_compressor
from repro_torch.core.compression import lowrank
from repro_torch.core.schedule.planner import (BucketPlan, CommPlan,
                                               form_bucket_indices)

DENSE_SMALL = 4096  # leaves smaller than this stay dense inside PowerSGD


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    compressor: str = "none"
    compressor_args: Tuple[Tuple[str, Any], ...] = ()
    algo: str = "psum"
    error_feedback: bool = True
    ef_decay: float = 1.0
    bucket_bytes: int = 32 * 1024 * 1024   # MG-WFBP fusion granularity
    mean: bool = True                      # divide by world size after reduce
    # one sharing class a leaf under the train layout over the model axis
    # (``convert.train_classes``): a packed bucket never holds two
    classes: Optional[Tuple[int, ...]] = None

    def make_compressor(self):
        return get_compressor(self.compressor, **dict(self.compressor_args))


def _numel(t: torch.Tensor) -> int:
    return int(t.numel())


def _div(x: torch.Tensor, denom: float, inplace: bool = False
         ) -> torch.Tensor:
    """``x / denom`` as one IEEE division per element on any device (on
    CUDA, PyTorch turns a division by a Python scalar into a reciprocal
    multiply); ``inplace`` writes it into ``x``."""
    if denom == 1.0:
        return x
    d = torch.tensor(denom, dtype=x.dtype, device=x.device)
    return x.div_(d) if inplace else x / d


# ---------------------------------------------------------------------------
# Bucketing (tensor fusion, MG-WFBP / Horovod-style)
# ---------------------------------------------------------------------------

def _class_bucket_indices(leaf_bytes, bucket_bytes: int, classes=None):
    """``form_bucket_indices``, or with ``classes`` (one key a leaf) the
    same rule within each class apart, the classes in the backward order
    of their last leaves: no bucket holds two classes."""
    if classes is None:
        return form_bucket_indices(leaf_bytes, bucket_bytes)
    out = []
    for c in dict.fromkeys(reversed(classes)):
        idx = [i for i, k in enumerate(classes) if k == c]
        out += [tuple(idx[j] for j in b) for b in form_bucket_indices(
            [leaf_bytes[i] for i in idx], bucket_bytes)]
    return out


def bucketize(grads, bucket_bytes: int, classes=None):
    """Split the flattened gradient tree into ~bucket_bytes buckets in
    backward order (last layer first).  Returns (bucket_defs, pack, unpack)
    where bucket_defs is a list of lists of (leaf_index, size).
    ``classes``: one key a leaf; leaves of two keys never share a bucket
    (``SyncConfig.classes``)."""
    leaves = tree_leaves(grads)
    sizes = [_numel(g) for g in leaves]
    buckets = [[(i, sizes[i]) for i in idxs]
               for idxs in _class_bucket_indices([s * 4 for s in sizes],
                                                 bucket_bytes, classes)]

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
      * ``powersgd``          — per-leaf unpacked buckets in tree order
        (the factorization is shape-aware), always with error feedback;
      * ``bucket_bytes <= 0`` — per-leaf unpacked buckets in tree order;
      * otherwise             — ``bucketize`` fusion in backward order,
        never packing leaves of two ``cfg.classes`` together (a lossy wire
        codes a tile from all its elements, so a leaf that every rank of
        the model axis holds the same must not share a tile with one
        that each holds its own block of)."""
    leaves = tree_leaves(grads)
    sizes = [_numel(g) for g in leaves]
    if cfg.compressor == "none":
        buckets: Tuple[BucketPlan, ...] = (BucketPlan(
            leaves=tuple(range(len(leaves))), compressor="none",
            algo=cfg.algo, bucket_bytes=4 * sum(sizes), pack=False,
            error_feedback=False),)
    elif cfg.compressor == "powersgd":
        buckets = tuple(BucketPlan(
            leaves=(i,), compressor="powersgd",
            compressor_args=cfg.compressor_args, algo=cfg.algo,
            bucket_bytes=4 * sizes[i], pack=False, error_feedback=True,
            ef_decay=cfg.ef_decay) for i in range(len(leaves)))
    elif cfg.bucket_bytes <= 0:
        buckets = tuple(BucketPlan(
            leaves=(i,), compressor=cfg.compressor,
            compressor_args=cfg.compressor_args, algo=cfg.algo,
            bucket_bytes=4 * sizes[i], pack=False,
            error_feedback=cfg.error_feedback, ef_decay=cfg.ef_decay)
            for i in range(len(leaves)))
    else:
        if cfg.classes is not None and len(cfg.classes) != len(leaves):
            raise ValueError(f"SyncConfig.classes names {len(cfg.classes)} "
                             f"leaves, the gradients have {len(leaves)}")
        defs, _, _ = bucketize(grads, cfg.bucket_bytes, cfg.classes)
        buckets = tuple(BucketPlan(
            leaves=tuple(i for i, _ in b), compressor=cfg.compressor,
            compressor_args=cfg.compressor_args, algo=cfg.algo,
            bucket_bytes=4 * sum(sz for _, sz in b), pack=True,
            error_feedback=cfg.error_feedback, ef_decay=cfg.ef_decay)
            for b in defs)
    return CommPlan(buckets=buckets, mean=cfg.mean)


def sharded_plan_from_config(cfg: SyncConfig, grads) -> CommPlan:
    """The plan sharded DP induces from a global ``SyncConfig``: like
    :func:`plan_from_config`, but dense buckets are PACKED at the config's
    fusion granularity, because the reduce-scatter edge operates on fused
    flat buffers (a bucket is the scatter unit).

    Bit-compat note (DESIGN.md §8): ring-allreduce sums each chunk in a
    ring order determined by the chunk's position, so replicated-vs-sharded
    exactness holds per BUCKET BOUNDARY — executing this same plan on the
    replicated path (``PlanExecutor.__call__``) is the reference the
    conformance tests compare against."""
    if cfg.compressor != "none":
        return dataclasses.replace(plan_from_config(cfg, grads),
                                   shard_state=True)
    bb = cfg.bucket_bytes if cfg.bucket_bytes > 0 else 32 * 2**20
    defs, _, _ = bucketize(grads, bb)
    buckets = tuple(BucketPlan(
        leaves=tuple(i for i, _ in b), compressor="none", algo=cfg.algo,
        bucket_bytes=4 * sum(sz for _, sz in b), pack=True,
        error_feedback=False) for b in defs)
    return CommPlan(buckets=buckets, mean=cfg.mean, shard_state=True)


def _own(x: torch.Tensor) -> torch.Tensor:
    """``x``, copied when it is a view into a larger buffer: a shard kept
    across the step must not hold the whole bucket's memory."""
    if x.untyped_storage().nbytes() > x.numel() * x.element_size():
        return x.clone()
    return x


# ---------------------------------------------------------------------------
# The executor
# ---------------------------------------------------------------------------

class PlanExecutor:
    """Executes a ``CommPlan`` over the data axes: per-bucket
    error-feedback + compression + collective exchange.

    State is carried per bucket: ``error`` holds the EF residual (a flat
    f32 buffer for packed buckets, leaf-shaped otherwise), ``q`` the
    PowerSGD warm-start factor; entries are None for buckets that need
    neither, and a key is omitted when no bucket uses it.  A call writes
    the new residuals into the state's buffers in place (the reference
    donates them; the kernels write them there directly): at full width a
    second copy of the residuals, as large as the f32 parameters, would not
    fit beside the first."""

    def __init__(self, plan: CommPlan, group: Axes = None):
        self.plan = plan
        self.axes = as_axes(group)
        for b in plan.buckets:
            check_algo(b.algo)
        self.comps = [get_compressor(b.compressor, **dict(b.compressor_args))
                      for b in plan.buckets]
        for j, b in enumerate(plan.buckets):
            if (b.compressor == "powersgd" or
                    (not b.pack and b.compressor != "none")) \
                    and len(b.leaves) != 1:
                raise ValueError(
                    f"bucket {j}: pack=False / powersgd buckets operate on "
                    f"one leaf in its natural shape, got leaves={b.leaves}")

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
        """The bucket's leaves as one flat f32 buffer; a bucket of one f32
        leaf is a view of it (no copy: the wire reads the buffer and never
        writes it)."""
        if len(idxs) == 1:
            return leaves[idxs[0]].reshape(-1).to(torch.float32)
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

    @staticmethod
    def _init_q(g: torch.Tensor, compressor_args) -> torch.Tensor:
        """PowerSGD's warm start for leaf ``g``: (0,) for a leaf that stays
        dense, else a (d, r) normal draw seeded as the reference keys it
        (``g.ndim * 7919 + d``, from a CPU generator)."""
        if g.ndim < 2 or _numel(g) < DENSE_SMALL:
            return torch.zeros((0,), dtype=torch.float32, device=g.device)
        rank = dict(compressor_args).get("rank", 4)
        n, d = g.shape[0], _numel(g) // g.shape[0]
        seed = torch.Generator().manual_seed(g.ndim * 7919 + d)
        return lowrank.normal((d, min(rank, n, d)), seed, g.device)

    def init_state(self, grads) -> Dict[str, Any]:
        leaves = tree_leaves(grads)
        self._check_cover(len(leaves))
        state: Dict[str, Any] = {"step": 0}
        errors: List[Optional[torch.Tensor]] = []
        qs: List[Optional[torch.Tensor]] = []
        for b in self.plan.buckets:
            g = leaves[b.leaves[0]]
            qs.append(self._init_q(g, b.compressor_args)
                      if b.compressor == "powersgd" else None)
            if not self._bucket_uses_ef(b):
                errors.append(None)
                continue
            shape = ((sum(_numel(leaves[i]) for i in b.leaves),) if b.pack
                     else tuple(g.shape))
            errors.append(torch.zeros(shape, dtype=torch.float32,
                                      device=g.device))
        if any(e is not None for e in errors):
            state["error"] = errors
        if any(q is not None for q in qs):
            state["q"] = qs
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
        return world_size(self.axes)

    def __call__(self, grads, state, rng: Optional[torch.Generator] = None):
        """Returns (synced_grads, new_state).  ``rng`` is the generator the
        stochastic compressors draw from (terngrad, qsgd, randomk)."""
        plan = self.plan
        leaves = tree_leaves(grads)
        self._check_cover(len(leaves))
        denom = float(self._world()) if plan.mean else 1.0
        nb = len(plan.buckets)
        errors = state.get("error", [None] * nb)
        qs = state.get("q", [None] * nb)

        out: List[Optional[torch.Tensor]] = [None] * len(leaves)
        new_qs: List[Optional[torch.Tensor]] = []
        for j, (b, comp) in enumerate(zip(plan.buckets, self.comps)):
            new_qs.append(qs[j])
            if b.compressor == "none":
                if b.pack and len(b.leaves) > 1:
                    # fused dense exchange: ONE collective for the bucket
                    buf = self._pack_bucket(leaves, b.leaves)
                    synced = _div(allreduce(buf, b.algo, self.axes), denom,
                                  inplace=True)
                    self._unpack_bucket(synced, leaves, b.leaves, out)
                else:
                    # unfused: leaves keep their natural shape (f32 out)
                    for i in b.leaves:
                        buf = leaves[i].to(torch.float32, copy=True)
                        out[i] = _div(allreduce(buf, b.algo, self.axes),
                                      denom)
            elif b.compressor == "powersgd":
                i = b.leaves[0]
                out[i], new_qs[j] = self._sync_powersgd_leaf(
                    leaves[i], errors[j], qs[j], b, comp, denom)
            elif not b.pack:
                out[b.leaves[0]] = self._sync_buffer(    # f32, leaf-shaped
                    leaves[b.leaves[0]].to(torch.float32), errors[j], rng,
                    b, comp, denom)
            else:
                # the packed buffer is handed over: _sync_buffer frees it
                # once it is encoded
                synced = self._sync_buffer(
                    self._pack_bucket(leaves, b.leaves), errors[j], rng, b,
                    comp, denom)
                self._unpack_bucket(synced, leaves, b.leaves, out)
                del synced

        new_state: Dict[str, Any] = {"step": state["step"] + 1}
        if "error" in state:
            new_state["error"] = errors
        if "q" in state:
            new_state["q"] = new_qs
        return _unflatten(grads, out), new_state

    # -- sharded-DP sync (the reduce-scatter edge, DESIGN.md §8) -------------

    def sync_shards(self, grads, state, rng: Optional[torch.Generator] = None):
        """Sharded-DP gradient exchange: per bucket, this rank's CANONICAL
        shard of exactly the synced gradient ``__call__`` would return.

          * dense buckets: ``reduce_scatter`` (ring / nested ring; ``psum``
            is an all-reduce and a local slice) — chunk values are
            bit-equal to the matching slices of the all-reduce;
          * PowerSGD: the factors are all-reduced as in ``__call__`` and
            the reconstructed approximation is sliced locally (no extra
            wire);
          * aggregatable compressed (``topk_fused``, qsgd): error feedback
            and compression as in ``__call__`` (the fused hook: the
            ``topk_ef`` kernel on the card), then the decompressed
            ``g_hat`` goes out as a reduce-scatter instead of an
            all-reduce;
          * gather-pattern compressed (``int8_fused``, int8, sign, top-k):
            the replicated exchange verbatim (``quantize_ef`` and
            ``dequant_accum`` on the card, ``quantize_tiles`` on every
            ``ring_fused`` hop), then this rank's slice of the sum — so the
            EF residuals evolve exactly as in replicated mode (the residual
            corrects what this worker SENT, which sharding does not
            change).

        Returns ``(bucket_shards, new_state)``: ``bucket_shards[j]`` is the
        (m_j,) f32 mean-gradient shard of plan bucket j, and ``new_state``
        has ``__call__``'s schema (residuals written in place)."""
        plan = self.plan
        leaves = tree_leaves(grads)
        self._check_cover(len(leaves))
        denom = float(self._world()) if plan.mean else 1.0
        nb = len(plan.buckets)
        errors = state.get("error", [None] * nb)
        qs = state.get("q", [None] * nb)

        shards: List[torch.Tensor] = []
        new_qs: List[Optional[torch.Tensor]] = []
        for j, (b, comp) in enumerate(zip(plan.buckets, self.comps)):
            new_qs.append(qs[j])
            if b.compressor == "none":
                buf = self._pack_bucket(leaves, b.leaves)
                shard = _div(reduce_scatter(buf, b.algo, self.axes), denom)
            elif b.compressor == "powersgd":
                i = b.leaves[0]
                synced, new_qs[j] = self._sync_powersgd_leaf(
                    leaves[i], errors[j], qs[j], b, comp, denom)
                # the factors were all-reduced: the whole approximation is
                # here on every rank, so slice it (no extra collective)
                shard = local_chunk(synced.reshape(-1).to(torch.float32),
                                    self.axes)
            else:
                buf = (self._pack_bucket(leaves, b.leaves) if b.pack
                       else leaves[b.leaves[0]].to(torch.float32))
                if comp.aggregatable:
                    # as _sync_buffer (fused hook included), but the dense
                    # decompressed sum goes out as a reduce-scatter
                    payload, meta, g_hat = self._compress_with_ef(
                        buf, errors[j], rng, b, comp)
                    del buf
                    if g_hat is None:
                        g_hat = comp.decompress(payload, meta)
                    del payload, meta
                    shard = _div(reduce_scatter(
                        g_hat.to(torch.float32).reshape(-1), b.algo,
                        self.axes), denom)
                    del g_hat
                else:
                    # gather-pattern wire: the replicated exchange
                    # verbatim, then the owner's slice of the sum
                    synced = self._sync_buffer(buf, errors[j], rng, b, comp,
                                               denom)
                    shard = local_chunk(synced.reshape(-1), self.axes)
                    del synced
            shards.append(_own(shard))
            del shard

        new_state: Dict[str, Any] = {"step": state["step"] + 1}
        if "error" in state:
            new_state["error"] = errors
        if "q" in state:
            new_state["q"] = new_qs
        return shards, new_state

    # EF + compress of one flat/leaf-shaped f32 buffer; the new residual
    # goes into e's buffer.  With EF, a fused hook and ``b.fused``, the
    # compressor's one-pass hook (the CUDA kernels on the card); otherwise
    # the decomposed chain EF add -> compress -> decompress -> residual.
    # Returns (payload, meta, g_hat), g_hat None after the fused hook.
    def _compress_with_ef(self, buf, e, rng, b: BucketPlan, comp):
        use_ef = self._bucket_uses_ef(b)
        if b.fused and use_ef and comp.fused_ef_compress is not None:
            payload, meta, _ = comp.fused_ef_compress(buf, e, b.ef_decay)
            return payload, meta, None
        corrected = buf + b.ef_decay * e if use_ef else buf
        payload, meta = comp.compress(corrected, rng)
        g_hat = comp.decompress(payload, meta)
        if use_ef:
            e.copy_(corrected - g_hat)
        return payload, meta, g_hat

    # EF + compress + exchange of one flat/leaf-shaped f32 buffer; returns
    # the synced f32 buffer.  A caller that hands ``buf`` over (keeps no
    # reference) lets it go before the exchange of a dense sum.
    def _sync_buffer(self, buf, e, rng, b: BucketPlan, comp, denom):
        payload, meta, g_hat = self._compress_with_ef(buf, e, rng, b, comp)
        if comp.aggregatable or b.algo == "ring_fused":
            # ring_fused needs a dense f32 operand (it re-compresses per
            # hop), so a gather-pattern payload is reconstructed locally
            # and rides the compressed ring instead of the all-gather
            if g_hat is None:
                g_hat = comp.decompress(payload, meta)
            del payload, meta
            reduced = g_hat.to(torch.float32)
            if reduced is buf:        # never all-reduce the caller's input
                reduced = reduced.clone()
            del g_hat, buf
            # the sum is ours (``reduced`` or a new tensor): divide in place
            return _div(allreduce(reduced, b.algo, self.axes), denom,
                        inplace=True)
        return self._gather_mean(comp, payload, meta, buf, denom,
                                 fused=b.fused)

    # PowerSGD: all-reduce the (P, Q) factors directly (aggregatable).
    # Returns (synced leaf in g's dtype, new Q); the residual goes into
    # e's buffer.
    def _sync_powersgd_leaf(self, g, e, q, b: BucketPlan, comp, denom):
        gf = g.to(torch.float32, copy=True)
        if q.numel() == 0:      # small leaf: dense all-reduce
            return _div(allreduce(gf, b.algo, self.axes), denom).to(
                g.dtype), q
        corrected = gf + b.ef_decay * e
        (p_f, q_f), (shape, _) = comp.compress(corrected, q_prev=q)
        p_f = _div(allreduce(p_f, b.algo, self.axes), denom)
        q_f = _div(allreduce(q_f, b.algo, self.axes), denom)
        approx = comp.decompress((p_f, q_f), (shape, None))
        e.copy_(corrected - approx)
        return approx.to(g.dtype), q_f

    def _gather_mean(self, comp, payload, meta, buf, denom,
                     fused: bool = True):
        """All-gather the compact payloads over the axes, in order, and sum
        every rank's decode (1-bit SGD / DGC wire pattern).  The gathered
        leading axis lists the ranks as the reference stacks them: the
        last axis outermost.  With the compressor's fused decode (and
        ``fused``) that is ONE dequantize + accumulate pass (the CUDA
        kernel on the card), else a decompress per rank added in that
        order.  Payload tensors
        are gathered one by one, so the wire carries int8, indices and
        scales, not dense f32; static metadata (shapes) passes through."""
        def gather(x):
            if not isinstance(x, torch.Tensor):
                return x
            orig = tuple(x.shape)
            for ax in self.axes:
                x = all_gather(x, ax)
            return x.reshape((-1,) + orig)

        gathered = tree_map(gather, payload)
        gathered_meta = tree_map(gather, meta)
        if fused and comp.fused_decode_sum is not None:
            total = comp.fused_decode_sum(gathered, gathered_meta)
            del gathered, gathered_meta
            return _div(total, denom, inplace=True)

        def index(x, i):
            return x[i] if isinstance(x, torch.Tensor) else x

        total = torch.zeros_like(buf)          # f32, the bucket's shape
        for i in range(self._world()):
            total = total + comp.decompress(
                tree_map(lambda x: index(x, i), gathered),
                tree_map(lambda x: index(x, i), gathered_meta))
        return _div(total, denom)


# ---------------------------------------------------------------------------
# Legacy single-config front-end (degenerate one-strategy plan)
# ---------------------------------------------------------------------------

class GradientSynchronizer:
    """One global ``SyncConfig`` applied to every bucket: lowers the config
    to a degenerate ``CommPlan`` and lets ``PlanExecutor`` run it."""

    def __init__(self, cfg: SyncConfig, group: Axes = None):
        self.cfg = cfg
        self.axes = as_axes(group)
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
                                          self.axes)
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


__all__ = ["SyncConfig", "bucketize", "plan_from_config",
           "sharded_plan_from_config", "PlanExecutor",
           "GradientSynchronizer"]
