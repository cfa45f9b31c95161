"""Paged KV-cache manager of the port — counterpart of
``repro/serve/kv_cache.py``.

The decode cache's leaves split two ways (``transformer.stack_cache_meta``):

  * **paged** leaves (attention K/V) have a per-position length dim.
    Positions live in a global pool of fixed-size pages ``(n_pages,
    page_size, ...)`` (stacked segments: ``(R, n_pages, page_size, ...)``),
    and each serving slot owns a host-side page table mapping logical page
    -> physical page.  Pages are allocated at admission (enough for
    ``prompt + max_new`` tokens) and freed at retirement.
  * **state** leaves (the recurrent mixers' states) are carried whole
    per slot.  A model with no paged leaf (xlstm-125m) has no allocator:
    every admission fits, and int8 quantizes nothing.

The encoder-decoder is refused, as in the reference: it is served through
one-shot ``launch/serve.generate`` only.

Page 0 is the reserved TRASH page: unallocated table entries point at it
and masked (inactive-slot) writes land on it.  Its garbage is never read —
the decode validity masks give stale scores exactly 0 weight.

``quantize="int8"`` stores paged leaves as ``{"q": int8, "s": f32
per-token scales}`` through ``kernels/ops.quantize_tiles`` — one tile per
cached token entry (tile = head_dim), one call per leaf for all of a
segment's stacked layers.  On a CUDA pool that call is the Hopper kernel.
Quantized serving is lossy.

Unlike the reference's pure functions, ``write_prefill`` and
``scatter_token`` update the pool tensors in place (``index_put_``, as
``tensor[idx] = value``) where JAX used ``.at[].set``, and return the pool
tree holding the same tensors.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

import numpy as np
import torch

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models.layers import TensorSpec
from repro_torch.models.model import resolve_dtype
from repro_torch.models.transformer import (CacheLeafMeta, materialize_cache,
                                            stack_cache_meta)

TRASH_PAGE = 0


class PageAllocator:
    """Host-side page bookkeeping for ONE table group (all cache leaves
    sharing length ``length``): a LIFO free list over the global pool plus
    per-slot page tables.  Invariants (``check()``): page 0 is never
    handed out, no page is owned twice, and free + owned + trash always
    partition the pool."""

    def __init__(self, n_pages: int, page_size: int, length: int,
                 max_batch: int):
        if length % page_size:
            raise ValueError(f"page_size {page_size} must divide cache "
                             f"length {length}")
        if n_pages < 2:
            raise ValueError("pool needs at least one page beyond trash")
        self.page_size = int(page_size)
        self.length = int(length)
        self.pages_per_slot = length // page_size
        self.n_pages = int(n_pages)
        self.max_batch = int(max_batch)
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._owned: List[List[int]] = [[] for _ in range(max_batch)]
        self._table = np.full((max_batch, self.pages_per_slot), TRASH_PAGE,
                              np.int32)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_needed(self, n_tokens: int) -> int:
        """Pages to cover ``n_tokens`` positions — capped at the group's
        table width (ring/window groups wrap instead of growing)."""
        return min(-(-int(n_tokens) // self.page_size), self.pages_per_slot)

    def can_admit(self, n_tokens: int) -> bool:
        return self.pages_needed(n_tokens) <= len(self._free)

    def alloc(self, slot: int, n_tokens: int) -> List[int]:
        if self._owned[slot]:
            raise RuntimeError(f"slot {slot} already owns pages "
                               f"{self._owned[slot]}")
        n = self.pages_needed(n_tokens)
        if n > len(self._free):
            raise RuntimeError(f"out of pages: need {n}, free "
                               f"{len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        self._owned[slot] = pages
        self._table[slot] = TRASH_PAGE
        self._table[slot, :n] = pages
        return pages

    def free(self, slot: int) -> int:
        pages = self._owned[slot]
        self._owned[slot] = []
        self._free.extend(reversed(pages))
        self._table[slot] = TRASH_PAGE
        return len(pages)

    def live_pages(self) -> Set[int]:
        return {p for owned in self._owned for p in owned}

    def owned(self, slot: int) -> List[int]:
        return list(self._owned[slot])

    def table(self) -> np.ndarray:
        """(max_batch, pages_per_slot) int32 logical->physical map;
        unallocated entries point at the trash page."""
        return self._table.copy()

    def check(self) -> None:
        live = self.live_pages()
        if TRASH_PAGE in live:
            raise AssertionError("trash page was handed out")
        if TRASH_PAGE in self._free:
            raise AssertionError("trash page on the free list")
        if len(live) + len(self._free) + 1 != self.n_pages:
            raise AssertionError(
                f"page leak: {len(live)} live + {len(self._free)} free + "
                f"trash != {self.n_pages}")
        flat = [p for owned in self._owned for p in owned]
        if len(flat) != len(set(flat)):
            raise AssertionError("page owned by two slots")


def _quant(x: torch.Tensor):
    """Symmetric int8 through ``ops.quantize_tiles``: one tile per
    last-axis row (tile = trailing dim).  Returns (q ``x.shape`` int8,
    scales ``x.shape[:-1]`` f32).  The reference casts x to f32 first; the
    kernel reads bf16 directly, which gives the same bits (bf16 -> f32 is
    exact)."""
    q, s = ops.quantize_tiles(x.reshape(-1), tile=x.shape[-1])
    return q.reshape(x.shape), s.reshape(x.shape[:-1])


def _dequant(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse through ``ops.dequantize``: q ``(..., rest)`` int8, s
    ``(...)`` per-row scales."""
    flat = ops.dequantize(q.reshape(-1), s.reshape(-1), tile=q.shape[-1])
    return flat.reshape(q.shape).to(dtype)


def _is_meta(x) -> bool:
    return isinstance(x, CacheLeafMeta)


class PagedDecodeCache:
    """Device pool + host allocators for one model's decode cache.

    ``gather`` / ``write_prefill`` / ``scatter_token`` take the pool tree
    as an argument; the allocators are plain host state driving admission
    control.
    """

    def __init__(self, model, max_batch: int, max_len: int, page_size: int,
                 n_pages: Optional[int] = None, dtype=None,
                 quantize: Optional[str] = None, build_pool: bool = True,
                 device: DeviceLike = None):
        cfg = model.cfg
        if cfg.is_encoder_decoder:
            raise NotImplementedError("paged serving covers decoder-only "
                                      "stacks (no cross-attention cache)")
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown KV quantization {quantize!r}")
        dtype = dtype or resolve_dtype(cfg.compute_dtype)
        self.model = model
        self.max_batch = int(max_batch)
        self.max_len = int(max_len)
        self.page_size = int(page_size)
        self.quantize = quantize
        self.dtype = dtype
        self.device = resolve_device(device) if build_pool else None
        self.specs = model.init_cache(max_batch, max_len, dtype=dtype)
        self.meta = stack_cache_meta(cfg, model.plan, max_batch, max_len,
                                     dtype)

        lengths = sorted({m.length for m in tree_leaves(self.meta,
                                                        is_leaf=_is_meta)
                          if m.kind == "paged"})
        self.allocators: Dict[int, PageAllocator] = {}
        for L in lengths:
            full = 1 + max_batch * (L // page_size)
            self.allocators[L] = PageAllocator(
                n_pages if n_pages is not None else full,
                page_size, L, max_batch)
        self.pool = self._build_pool() if build_pool else None

    # -- pool construction --------------------------------------------------

    def _leaf_map(self, fn, *trees):
        """tree_map over (meta, *aligned trees) with meta leaves opaque."""
        return tree_map(fn, self.meta, *trees, is_leaf=_is_meta)

    def paged_leaves(self) -> int:
        """Number of paged cache leaves — the ``quantize_tiles`` calls per
        prefill write and per decode tick when ``quantize="int8"``."""
        return sum(m.kind == "paged"
                   for m in tree_leaves(self.meta, is_leaf=_is_meta))

    def _build_pool(self):
        page = self.page_size

        def pool_spec(m, s):
            if m.kind == "state":
                return s
            np_ = self.allocators[m.length].n_pages
            if m.batch_axis == 1:
                shape = (s.shape[0], np_, page) + s.shape[3:]
            else:
                shape = (np_, page) + s.shape[2:]
            return TensorSpec(shape, s.dtype)

        pool = materialize_cache(self._leaf_map(pool_spec, self.specs),
                                 self.device)
        if self.quantize == "int8":
            def quantized(m, p):
                if m.kind == "state":
                    return p
                return {"q": torch.zeros(p.shape, dtype=torch.int8,
                                         device=self.device),
                        "s": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                         device=self.device)}
            pool = self._leaf_map(quantized, pool)
        return pool

    def can_admit(self, n_tokens: int) -> bool:
        return all(a.can_admit(n_tokens) for a in self.allocators.values())

    def alloc(self, slot: int, n_tokens: int) -> None:
        for a in self.allocators.values():
            a.alloc(slot, n_tokens)

    def free(self, slot: int) -> int:
        return sum(a.free(slot) for a in self.allocators.values())

    def tables(self) -> Dict[int, torch.Tensor]:
        """{length: (max_batch, pages_per_slot) int64} device page tables
        — one table per length group, shared by every leaf of that L."""
        return {L: torch.as_tensor(a.table(), dtype=torch.int64,
                                   device=self.device)
                for L, a in self.allocators.items()}

    def check(self) -> None:
        for a in self.allocators.values():
            a.check()

    # -- device functions ---------------------------------------------------

    def _split(self, p, m):
        """(values_leaf, scales_leaf_or_None) view of a pool leaf."""
        if self.quantize == "int8" and m.kind == "paged":
            return p["q"], p["s"]
        return p, None

    def gather(self, pool, tables):
        """Pool -> linear ``(max_batch, L, ...)`` cache view through the
        page tables: the tree ``model.decode_step`` consumes.  State leaves
        pass through; garbage gathered from trash/beyond-``pos`` pages is
        neutralized by the decode validity masks."""
        B = self.max_batch

        def g(m, p):
            if m.kind == "state":
                return p
            vals, scales = self._split(p, m)
            t = tables[m.length]                       # (B, pps)
            if m.batch_axis == 1:
                x = vals[:, t]                         # (R, B, pps, page, ...)
                out = x.reshape((x.shape[0], B, m.length) + x.shape[4:])
                if scales is not None:
                    s = scales[:, t].reshape(out.shape[:-1])
                    out = _dequant(out, s, self.dtype)
                return out
            x = vals[t]                                # (B, pps, page, ...)
            out = x.reshape((B, m.length) + x.shape[3:])
            if scales is not None:
                s = scales[t].reshape(out.shape[:-1])
                out = _dequant(out, s, self.dtype)
            return out

        return self._leaf_map(g, pool)

    def write_prefill(self, pool, cache_row, table_row, slot: int):
        """Write one request's prefill cache (linear, batch=1) into its
        pages and state row, in place.  ``table_row``: {length: (pps,)
        int64 tensor}.  Unallocated table entries point at trash, so short
        allocations spill harmlessly."""
        page = self.page_size

        def w(m, p, c):
            if m.kind == "state":
                if m.batch_axis == 1:
                    p[:, slot] = c[:, 0].to(p.dtype)
                else:
                    p[slot] = c[0].to(p.dtype)
                return p
            tr = table_row[m.length]                   # (pps,)
            pps = tr.shape[0]
            vals, scales = self._split(p, m)
            if m.batch_axis == 1:
                rows = c[:, 0]                         # (R, L, ...)
                rows = rows.reshape((rows.shape[0], pps, page)
                                    + rows.shape[2:])
            else:
                rows = c[0].reshape((pps, page) + c.shape[2:])
            if scales is None:
                if m.batch_axis == 1:
                    p[:, tr] = rows.to(p.dtype)
                else:
                    p[tr] = rows.to(p.dtype)
                return p
            q, s = _quant(rows)
            if m.batch_axis == 1:
                vals[:, tr] = q
                scales[:, tr] = s
            else:
                vals[tr] = q
                scales[tr] = s
            return p

        return self._leaf_map(w, pool, cache_row)

    def scatter_token(self, pool, linear, pos, tables, active):
        """Write the decode step's new entries back, in place: paged leaves
        scatter the per-row entry at ``pos[b] % L`` into ``(page, offset)``
        through the table — inactive rows are routed to the trash page —
        and state leaves adopt the updated linear rows wholesale."""
        B = self.max_batch
        page = self.page_size
        rows = torch.arange(B, device=pos.device)

        def s_(m, p, lin):
            if m.kind == "state":
                p.copy_(lin)
                return p
            L = m.length
            slot = pos % L                              # (B,)
            page_idx = slot // page
            off = slot % page
            t = tables[L]
            phys = torch.gather(t, 1, page_idx[:, None])[:, 0]
            phys = torch.where(active, phys, TRASH_PAGE)
            vals, scales = self._split(p, m)
            if m.batch_axis == 1:
                entry = lin[:, rows, slot]              # (R, B, ...)
            else:
                entry = lin[rows, slot]                 # (B, ...)
            if scales is None:
                if m.batch_axis == 1:
                    p[:, phys, off] = entry.to(p.dtype)
                else:
                    p[phys, off] = entry.to(p.dtype)
                return p
            q, s = _quant(entry)
            if m.batch_axis == 1:
                vals[:, phys, off] = q
                scales[:, phys, off] = s
            else:
                vals[phys, off] = q
                scales[phys, off] = s
            return p

        return self._leaf_map(s_, pool, linear)
