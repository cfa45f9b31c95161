"""Op analysis of one traced rank — the port's counterpart of
``repro/launch/hlo_analysis.py``.

The reference parses the compiled HLO text of a step for three roofline
inputs.  The port has no HLO: it runs the step eagerly (on CPU fake
tensors in the dry run, on the card in ``chip_smoke.py``) and records the
ops as they run.  :func:`count` is a context manager that counts one call
(:func:`trace` counts ``fn(*args)``); its :class:`OpStats` has
``HLOStats``'s fields plus ``collective_wire_bytes_by_axis``,
``collective_counts_by_axis`` and the hand-written kernels' calls.

The counting rules:

  * **dot FLOPs** — every ``aten.mm``, ``bmm``, ``addmm``, ``baddbmm``
    and ``_scaled_mm`` (and ``mv``, ``addmv``, ``dot``, the same products
    at other ranks) at ``2·|out|·K`` for the contracted length K, the
    reference's ``_dot_flops`` rule, seen by a ``TorchDispatchMode``;
  * **memory bytes** — operand bytes plus output bytes of every other
    aten op, the reference's upper bound at fusion-less granularity (the
    reference's ``_instruction_mem_bytes`` also counts a dot's operands
    and output; here a product counts its FLOPs only).  Skipped:
    view ops (``OpOverload.is_view``: ``view``, ``t``, ``transpose``,
    ``expand``, ``select``, ``slice``, ``unbind``, ``split``, ``detach``,
    ``alias``, ``lift_fresh``, ...), the alias ``_unsafe_view``,
    allocations that write nothing (``empty``, ``empty_like``,
    ``empty_strided``, ``empty_permuted``, ``new_empty``,
    ``new_empty_strided``) and the metadata queries ``sym_size``,
    ``sym_stride``, ``sym_numel``, ``sym_storage_offset`` and the ``prim``
    queries (``prim.device``: a fake tensor's device);
  * **collectives** — at the port's own transports, not in the c10d
    dispatcher: ``collectives.api._psum`` (``allreduce``'s psum, one
    all-reduce per axis) and ``allreduce_max`` (the split-KV decode's row
    maximum, an all-reduce per axis too), ``all_gather``, the direct ``all_to_all`` and
    ``p2p.permute`` (a hop).  Every other entry point is counted through
    them: ``reduce_scatter`` on psum is an all-reduce and a slice in the
    port (so its wire is the all-reduce's), ``all_gather_shards`` on psum
    an all-gather per axis, ``send_recv``, the ring ``all_to_all`` and
    the explicit ``ring`` / ``tree`` / ``hierarchical`` / ``mesh2d`` /
    ``ring_fused`` schedules their hops, as ``collective-permute`` — as
    the reference's explicit schedules lower.  The wire formulas are the
    reference's ``_collective_bytes``: all-reduce ``2·b·(p−1)/p``,
    all-gather ``b·(p−1)``, reduce-scatter and all-to-all ``b·(p−1)/p``,
    a permute hop ``b``, for ``b`` operand bytes and ``p`` the group's
    size; the wire is attributed to the group's mesh-axis name;
  * **the hand-written kernels** (``kernels/ops.py``: ``flash_attention``,
    ``quantize_tiles``, ``quantize_ef``, ``dequant_accum``, ``topk_ef``,
    ``topk_mask``, ``nonfinite_tiles``) — each call counts by a formula of
    its arguments' shapes (:func:`kernel_cost`), once, under its own
    name: flash's dot FLOPs are the ones its plain version issues at that
    shape (every key of every query, ``4·B·T·H·S·hd``), and every
    kernel's bytes are its inputs read once and its outputs written once.
    While a wrapper runs, the dispatch-mode counting inside it is
    suspended (``kernels="formula"``), so a fake-tensor trace (the plain
    versions) and a step on the card (the kernels) count the same; a
    kernel called inside another (flash's pre-pass ``nonfinite_tiles``
    on the card) is part of the outer call.  ``kernels="plain"`` counts
    the plain versions' own ops instead (the check of the formulas);
  * **staging** — a card tensor on a gloo group crosses through pinned
    host memory (``core/collectives/p2p.py``); those copies run under
    :func:`uncounted`, so a step counts the same on gloo, on NCCL and on
    the fake backend;
  * **loops** — the port runs eagerly, so every op is counted where it
    runs, each step of a recurrence and each micro-batch: there is no
    ``while`` to correct for, ``num_while_loops`` is 0 and
    ``while_trip_counts_top`` is ``[]``.

What stands in for ``memory_analysis()`` (:meth:`OpStats.memory_analysis`)
is computed from the same trace: the call's arguments, its outputs (what
it returns and the arguments it writes in place), the peak of live
intermediate bytes (storages made during the call, freed when their
tensor dies, through weakref finalizers; a kernel's plain version counts
only the outputs it returns, what the kernel allocates) and the arguments
written in place (the port's analogue of donation).

This module imports torch only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from typing import Any, Dict, Iterator, List, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

# each product's left operand (its last dim is the contracted length K)
_DOT = {aten.mm: 0, aten.bmm: 0, aten.addmm: 1, aten.baddbmm: 1,
        aten._scaled_mm: 0, aten.mv: 0, aten.addmv: 1, aten.dot: 0}
_ALLOC = {aten.empty, aten.empty_like, aten.empty_strided,
          aten.empty_permuted, aten.new_empty, aten.new_empty_strided}
_META = {aten.sym_size, aten.sym_stride, aten.sym_numel,
         aten.sym_storage_offset, aten._unsafe_view}

@dataclasses.dataclass
class OpStats:
    """``HLOStats``'s fields (reference ``hlo_analysis.py:177``), plus the
    wire per mesh axis and the kernels' calls, FLOPs and bytes; and the
    trace's memory reckoning (:meth:`memory_analysis`)."""
    dot_flops: float = 0.0
    collective_operand_bytes: float = 0.0
    collective_wire_bytes: float = 0.0
    memory_bytes: float = 0.0
    collective_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    while_trip_counts: List[int] = dataclasses.field(default_factory=list)
    collective_wire_bytes_by_axis: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_counts_by_axis: Dict[str, Dict[str, int]] = \
        dataclasses.field(default_factory=dict)
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernel_flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    aten_ops: int = 0
    op_counts: Dict[str, List[float]] = dataclasses.field(
        default_factory=dict)
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_temp_bytes: int = 0
    alias_bytes: int = 0

    def op_table(self) -> str:
        """The per-op table (kept with ``table=True``): op, calls, dot
        FLOPs, bytes, largest bytes first; the kernels' rows by name."""
        rows = sorted(self.op_counts.items(), key=lambda kv: -kv[1][2])
        lines = ["op\tcalls\tdot_flops\tbytes"]
        lines += [f"{op}\t{int(c)}\t{f:.0f}\t{b:.0f}"
                  for op, (c, f, b) in rows]
        lines += [f"kernel:{k}\t{n}\t{self.kernel_flops.get(k, 0.0):.0f}\t"
                  f"{self.kernel_bytes.get(k, 0.0):.0f}"
                  for k, n in sorted(self.kernel_calls.items())]
        return "\n".join(lines) + "\n"

    def memory_analysis(self) -> Dict[str, int]:
        """The reference's ``_mem_dict`` keys that the trace gives: no
        ``generated_code_size_in_bytes`` (no code is generated)."""
        return {"argument_size_in_bytes": int(self.argument_bytes),
                "output_size_in_bytes": int(self.output_bytes),
                "temp_size_in_bytes": int(self.peak_temp_bytes),
                "alias_size_in_bytes": int(self.alias_bytes)}

    def cost_analysis(self) -> Dict[str, float]:
        """The op analysis' totals under ``cost_analysis()``'s keys: dot
        FLOPs (the kernels' included) and the fusion-less bytes.  These
        are not XLA's numbers (XLA counts every op's FLOPs and its fused
        bytes)."""
        return {"flops": float(self.dot_flops),
                "bytes accessed": float(self.memory_bytes)}

    def hlo_block(self) -> Dict[str, Any]:
        """The record's ``hlo`` block: the reference's sub-keys, then the
        per-axis wire and the kernels' calls."""
        return {
            "dot_flops_per_device": self.dot_flops,
            "memory_bytes_per_device": self.memory_bytes,
            "collective_operand_bytes": self.collective_operand_bytes,
            "collective_wire_bytes_per_device": self.collective_wire_bytes,
            "collective_counts": dict(self.collective_counts),
            "num_while_loops": len(self.while_trip_counts),
            "while_trip_counts_top": sorted(self.while_trip_counts)[-8:],
            "collective_wire_bytes_by_axis":
                dict(self.collective_wire_bytes_by_axis),
            "collective_counts_by_axis": {
                a: dict(c) for a, c in self.collective_counts_by_axis.items()},
            "kernel_calls": dict(self.kernel_calls),
            "aten_ops": self.aten_ops,
        }


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a nest of tuples, lists and dicts (an op's arguments
    or results; a step's argument tree)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    out: List[torch.Tensor] = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None


def kernel_cost(name: str, *args, out=None) -> tuple:
    """(dot FLOPs, bytes) of one call of kernel ``name`` on ``args`` (the
    wrapper's own arguments), from their shapes: FLOPs only for flash (its
    plain version's two products over every key); bytes = inputs read
    once + outputs written once (``out``: the call's result)."""
    if name == "flash_attention":
        q, k, v = args[:3]
        B, T, H, hd = q.shape
        S = k.shape[1]
        return (4.0 * B * T * H * S * hd,
                float(2 * nbytes(q) + nbytes(k) + nbytes(v)))
    moved = sum(nbytes(t) for t in args if isinstance(t, torch.Tensor))
    moved += sum(nbytes(t) for t in _tensors(out))
    return 0.0, float(moved)


class OpCounter(TorchDispatchMode):
    """The dispatch mode and hook target behind :func:`count`."""

    def __init__(self, stats: OpStats, axis_names=None,
                 kernels: str = "formula", table: bool = False):
        super().__init__()
        self.table = table
        if kernels not in ("formula", "plain"):
            raise ValueError(f"kernels={kernels!r}: 'formula' or 'plain'")
        self.stats = stats
        self.kernels = kernels
        self.axis_names = {id(dist.group.WORLD if g is None else g): n
                           for g, n in (axis_names or {}).items()}
        self.suspended = 0
        self._live = 0
        self._seen: Dict[int, int] = {}      # id(storage) -> bytes (0: arg)
        self._args: Dict[int, int] = {}      # id(storage) -> bytes of args
        self._written: set = set()
        self._mutable: Dict[Any, tuple] = {}
        # finalizers run on the thread where a tensor dies (the autograd
        # engine's, on the card), beside the thread that counts
        self._lock = threading.Lock()

    # -- memory reckoning ---------------------------------------------------

    def register_args(self, tree) -> None:
        for t in _tensors(tree):
            s = _storage(t)
            if s is None or id(s) in self._args:
                continue
            self._args[id(s)] = nbytes(t)
            self._seen[id(s)] = 0
            self.stats.argument_bytes += nbytes(t)

    def _free(self, sid: int, n: int) -> None:
        with self._lock:
            if self._seen.pop(sid, None) is not None:
                self._live -= n

    def _track(self, outs) -> None:
        for t in outs:
            s = _storage(t)
            if s is None:
                continue
            with self._lock:
                if id(s) in self._seen:
                    continue
                n = s.nbytes()
                self._seen[id(s)] = n
                self._live += n
                if self._live > self.stats.peak_temp_bytes:
                    self.stats.peak_temp_bytes = self._live
            weakref.finalize(s, self._free, id(s), n)

    def finish(self, result) -> None:
        """Outputs: what the call returns and the arguments it wrote in
        place (the reference's donated outputs, also its aliases, as is
        an argument returned as it is: a donated cache that this rank's
        step did not write); the peak less the outputs made during the
        call."""
        made = out = 0
        done = set()
        for t in _tensors(result):
            s = _storage(t)
            if s is None or id(s) in done:
                continue
            done.add(id(s))
            out += nbytes(t)
            if self._seen.get(id(s)):
                made += nbytes(t)
        alias = sum(self._args[sid] for sid in
                    self._written | (done & set(self._args)))
        out += sum(self._args[sid] for sid in self._written
                   if sid not in done)
        self.stats.alias_bytes = alias
        self.stats.output_bytes = out
        self.stats.peak_temp_bytes = max(self.stats.peak_temp_bytes - made,
                                         0)

    def _mutated(self, func) -> tuple:
        m = self._mutable.get(func)
        if m is None:
            m = tuple(i for i, a in enumerate(func._schema.arguments)
                      if a.alias_info is not None and a.alias_info.is_write)
            self._mutable[func] = m
        return m

    # -- the dispatch mode --------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":
            # prim.device / prim.layout: a tensor subclass's metadata query
            return out
        for i in self._mutated(func):
            # in-place writes to the arguments, a kernel's plain version's
            # included (the kernel writes them too)
            if i < len(args):
                for t in _tensors(args[i]):
                    s = _storage(t)
                    if s is not None and id(s) in self._args:
                        self._written.add(id(s))
        if self.suspended:
            return out
        st = self.stats
        st.aten_ops += 1
        packet = func.overloadpacket
        outs = _tensors(out)
        self._track(outs)
        flops = moved = 0.0
        lhs = _DOT.get(packet)
        if lhs is not None:
            a = args[lhs]
            k = a.shape[-1] if a.dim() else 1
            flops = 2.0 * sum(o.numel() for o in outs) * k
            st.dot_flops += flops
        elif not (func.is_view or packet in _ALLOC or packet in _META):
            moved = float(sum(nbytes(t) for t in _tensors((args, kwargs)))
                          + sum(nbytes(t) for t in outs))
            st.memory_bytes += moved
        if self.table:
            row = st.op_counts.setdefault(str(func), [0, 0.0, 0.0])
            row[0] += 1
            row[1] += flops
            row[2] += moved
        return out

    # -- hooks ----------------------------------------------------------------

    def axis_name(self, group) -> str:
        g = dist.group.WORLD if group is None else group
        name = self.axis_names.get(id(g))
        if name is None:
            name = "world" if g is dist.group.WORLD else \
                f"group{dist.get_world_size(g)}"
        return name

    def collective(self, kind: str, x: torch.Tensor, group) -> None:
        if self.suspended:
            return
        st = self.stats
        b = float(nbytes(x))
        wire = wire_formula(kind, b, dist.get_world_size(
            dist.group.WORLD if group is None else group))
        st.collective_counts[kind] = st.collective_counts.get(kind, 0) + 1
        st.collective_operand_bytes += b
        st.collective_wire_bytes += wire
        axis = self.axis_name(group)
        st.collective_wire_bytes_by_axis[axis] = \
            st.collective_wire_bytes_by_axis.get(axis, 0.0) + wire
        counts = st.collective_counts_by_axis.setdefault(axis, {})
        counts[kind] = counts.get(kind, 0) + 1

    @contextlib.contextmanager
    def kernel(self, name: str, args: tuple) -> Iterator[list]:
        """Count one call of kernel ``name``; the body's result goes into
        the yielded list, whose first element is the call's result."""
        if self.suspended:
            yield []
            return
        st = self.stats
        st.kernel_calls[name] = st.kernel_calls.get(name, 0) + 1
        box: list = []
        if self.kernels == "plain":
            yield box
            return
        self.suspended += 1
        try:
            yield box
        finally:
            self.suspended -= 1
        result = box[0] if box else None
        flops, moved = kernel_cost(name, *args, out=result)
        st.dot_flops += flops
        st.memory_bytes += moved
        st.kernel_flops[name] = st.kernel_flops.get(name, 0.0) + flops
        st.kernel_bytes[name] = st.kernel_bytes.get(name, 0.0) + moved
        self._track(_tensors(result))


_ACTIVE: List[OpCounter] = []


def active() -> Optional[OpCounter]:
    return _ACTIVE[-1] if _ACTIVE else None


def record_collective(kind: str, x: torch.Tensor, group) -> None:
    """Hook of the collectives' transports: one ``kind`` op of ``x`` over
    ``group`` (a no-op outside :func:`count`)."""
    c = active()
    if c is not None:
        c.collective(kind, x, group)


@contextlib.contextmanager
def uncounted() -> Iterator[None]:
    """Leave the ops of the block out of the active count: the copies of a
    card tensor through pinned host memory that a gloo group needs
    (``p2p.to_wire`` / ``from_wire``), which the program on NCCL, or on
    the fake backend, does not run."""
    c = active()
    if c is None:
        yield
        return
    c.suspended += 1
    try:
        yield
    finally:
        c.suspended -= 1


@contextlib.contextmanager
def kernel_call(name: str, *args) -> Iterator[list]:
    """Hook of the kernel wrappers: ``with kernel_call(name, *args) as box:
    ...; box.append(result)``.  Outside :func:`count` it does nothing."""
    c = active()
    if c is None:
        yield []
        return
    with c.kernel(name, args) as box:
        yield box


@contextlib.contextmanager
def count(args=None, axis_names=None, kernels: str = "formula",
          table: bool = False) -> Iterator[OpCounter]:
    """Count the ops run inside the block; yields the :class:`OpCounter`,
    whose ``stats`` is the :class:`OpStats`.  ``args``: the call's
    argument tree (its bytes, and the in-place writes to it);
    ``axis_names``: {process group (None: the default group): mesh-axis
    name}; ``table``: keep the per-op table.  ``counter.finish(result)``
    completes the output and temp reckoning (:func:`trace` does both)."""
    c = OpCounter(OpStats(), axis_names, kernels, table)
    if args is not None:
        c.register_args(args)
    _ACTIVE.append(c)
    try:
        with c:
            yield c
    finally:
        _ACTIVE.remove(c)


def trace(fn, args: tuple, axis_names=None, kernels: str = "formula",
          table: bool = False):
    """``fn(*args)`` counted: returns (result, OpStats) with the memory
    reckoning finished."""
    with count(args, axis_names, kernels, table) as c:
        result = fn(*args)
    c.finish(result)
    return result, c.stats


def wire_formula(kind: str, b: float, p: int) -> float:
    """The reference's wire bytes a device of one ``kind`` op of ``b``
    operand bytes over ``p`` ranks (``hlo_analysis._collective_bytes``)."""
    if kind == "all-reduce":
        return 2.0 * b * (p - 1) / p
    if kind == "all-gather":
        return float(b) * (p - 1)
    if kind in ("reduce-scatter", "all-to-all"):
        return float(b) * (p - 1) / p
    return float(b)


__all__ = ["OpStats", "OpCounter", "count", "trace", "kernel_call",
           "record_collective", "kernel_cost", "wire_formula", "uncounted"]
