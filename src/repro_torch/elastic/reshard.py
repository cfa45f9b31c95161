"""Topology survival: rebuild the fabric description after preemption;
a copy of ``repro/elastic/reshard.py``, held to it by
``tests/test_torch_elastic.py``.

When workers die the planner must re-search on the fabric that is
actually left, not the one the job launched with (DESIGN.md §15).  This
module maps (old Topology, dead ranks) → surviving Topology, preserving
as much tier structure as the loss pattern allows:

  * flat fabric — just shrink the single tier;
  * uniform loss, d dead per outermost group (d < inner) — every group
    keeps the same shrunken inner stack, so the tiered shape survives
    with the inner size reduced (the inner tiers collapse to one tier of
    the survivors on the innermost — fastest — link, because a partial
    group no longer factorizes over the inner tier product);
  * whole groups lost — drop them, keep the inner stack intact, shrink
    (or drop) the outer tier;
  * anything irregular — fall back to a single flat tier of all
    survivors on the OUTERMOST (slowest) link: a conservative model, it
    over-prices but never under-prices the surviving fabric.

Ranks are row-major over the tier sizes outermost-first, matching
``Topology``'s convention: rank // inner_size = outermost group index.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Set

from repro_torch.core.schedule.topology import Tier, Topology


def surviving_topology(topo: Topology, dead: Iterable[int]) -> Topology:
    """Topology of the survivors after removing ranks ``dead``."""
    dead_set: Set[int] = {int(d) for d in dead}
    world = topo.world
    bad = sorted(d for d in dead_set if d < 0 or d >= world)
    if bad:
        raise ValueError(f"dead ranks {bad} out of range for "
                         f"world={world}")
    n_live = world - len(dead_set)
    if n_live < 1:
        raise ValueError("no survivors: cannot build a topology of 0 "
                         "workers")
    if not dead_set:
        return topo

    if topo.is_flat:
        t = topo.tiers[0]
        return Topology(tiers=(dataclasses.replace(t, size=n_live),))

    outer = topo.tiers[0]
    inner = topo.inner_size               # product of tiers[1:]
    per_group = [0] * outer.size
    for d in dead_set:
        per_group[d // inner] += 1

    uniq = set(per_group)
    innermost = topo.tiers[-1]
    if len(uniq) == 1:
        # uniform partial loss: every group keeps inner - d survivors
        d = per_group[0]                  # 0 < d < inner (dead_set nonempty)
        return Topology(tiers=(
            outer,
            Tier(name=innermost.name, size=inner - d,
                 link=innermost.link, link_name=innermost.link_name,
                 fit=innermost.fit)))
    if uniq <= {0, inner}:
        # whole groups gone, the rest untouched
        live_groups = sum(1 for d in per_group if d == 0)
        if live_groups == 1:
            return Topology(tiers=topo.tiers[1:])
        return Topology(tiers=(dataclasses.replace(outer,
                                                   size=live_groups),)
                        + topo.tiers[1:])

    # irregular loss: conservative flat fallback on the slowest link
    return Topology(tiers=(
        Tier(name="survivors", size=n_live, link=outer.link,
             link_name=outer.link_name, fit=outer.fit),))
