"""Tiered network topology — the first-class network model (survey §4.1.2);
a copy of ``repro/core/schedule/topology.py``, held to it by
``tests/test_torch_planner.py``.

Real clusters are *tiered*: a fast intra-node interconnect (NVLink / TPU
ICI) under a slower inter-node fabric (Ethernet / IB).  The survey's
network-level chapter exists because collective algorithms differ in WHICH
links each phase traverses — hierarchical allreduce (Jia et al. 2018) and
2D-torus allreduce (Ying et al. 2018) were designed so the bandwidth-heavy
phases stay on the fast tier — and Zhang et al. 2020 show the flat-ring
vs hierarchical crossover only appears when inter-node bandwidth is
modeled separately.  A single ``LinkParams`` cannot express any of this.

A :class:`Topology` is an ordered tuple of :class:`Tier` entries,
**outermost (slowest, cross-node) first**, each ``(name, size, link)``.
The world size is the product of tier sizes.  ``Topology.flat(world,
link)`` is the degenerate single-tier network every pre-topology call
site used implicitly — the cost model reproduces the flat numbers
bit-for-bit on it (``tests/test_topology.py`` pins this).

The axis→tier mapping of *executed* collectives: each tier is one mesh
axis named after the tier (``launch.mesh.make_topology_mesh``), and
collectives take the axis names innermost-first
(``collectives.api.axes_for_topology``) so ``hierarchical``'s inner ring
runs on the fast tier exactly as the cost model prices it.  DESIGN.md §10.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union


@dataclasses.dataclass(frozen=True)
class Tier:
    """One level of the network: ``size`` members joined by ``link``.

    ``fit`` (a ``schedule.calibration.LinkFit``) is attached when the
    link was FITTED from measured collectives rather than taken from a
    preset — it carries the confidence bounds and residual the drift
    report propagates; it never participates in equality (two tiers with
    the same (α, β) price identically regardless of provenance)."""
    name: str
    size: int
    link: "LinkParams"              # repro_torch.core.schedule.cost.LinkParams
    link_name: str = dataclasses.field(default="", compare=False)
    fit: Optional[object] = dataclasses.field(default=None, compare=False,
                                              repr=False)

    def describe(self) -> str:
        ln = self.link_name or (f"a={self.link.alpha_s:.0e}:"
                                f"b={1 / self.link.beta_s_per_byte / 1e9:g}")
        return f"{self.name}:{self.size}@{ln}"


# Canonical tiered networks, joining ``LINK_PRESETS`` the way the flat
# presets join the benchmarks: the spec strings below are what
# ``--topology`` accepts, and every ``@link`` names a LINK_PRESETS entry.
TOPOLOGY_PRESETS = {
    # the acceptance-criterion network: 4 nodes of 8 fast-ICI devices
    # under a datacenter fabric (world 32)
    "two_tier_pod": "node:4@datacenter,device:8@fast_ici",
    # two TPU pods joined by a datacenter fabric (world 512)
    "multi_pod": "pod:2@datacenter,chip:256@fast_ici",
    # a commodity cluster: 32 8-GPU boxes on slow Ethernet (world 256)
    "commodity_cluster": "node:32@commodity,device:8@fast_ici",
}


@dataclasses.dataclass(frozen=True)
class Topology:
    """An ordered stack of network tiers, outermost first.

    The single object every layer of the network surface shares: the α-β
    cost model prices each collective phase on the tier it traverses, the
    planner searches axis→tier placements over it, ``TrainSession`` builds
    the executable mesh from it, and the CLI parses it from
    ``--topology``.
    """
    tiers: Tuple[Tier, ...]

    def __post_init__(self):
        if not self.tiers:
            raise ValueError("a Topology needs at least one tier")
        names = [t.name for t in self.tiers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names: {names}")
        for t in self.tiers:
            if int(t.size) < 1:
                raise ValueError(f"tier {t.name!r} has size {t.size}")

    # -- views ---------------------------------------------------------------

    @property
    def world(self) -> int:
        w = 1
        for t in self.tiers:
            w *= int(t.size)
        return w

    @property
    def n_tiers(self) -> int:
        return len(self.tiers)

    @property
    def is_flat(self) -> bool:
        return len(self.tiers) == 1

    @property
    def outermost(self) -> Tier:
        return self.tiers[0]

    @property
    def innermost(self) -> Tier:
        return self.tiers[-1]

    @property
    def inner_size(self) -> int:
        """Product of all tiers below the outermost — the natural ``k``
        of hierarchical allreduce (the intra-node ring size)."""
        w = 1
        for t in self.tiers[1:]:
            w *= int(t.size)
        return w

    @property
    def all_pow2(self) -> bool:
        """Every tier size a power of two — required by the tree
        collective (distance doubling runs per axis)."""
        return all(t.size & (t.size - 1) == 0 for t in self.tiers)

    def bottleneck(self, m_bytes: float) -> Tier:
        """The tier that gates a lockstep flat traversal (ring / gather)
        moving ``m_bytes`` per step: max α + m·β.  A ring embedded across
        nodes crosses the slow fabric every step, so each synchronous step
        is paid at the slowest link it touches (Zhang et al. 2020's
        flat-ring observation).  Ties go to the outermost tier."""
        return max(self.tiers,
                   key=lambda t: (t.link.alpha_s
                                  + m_bytes * t.link.beta_s_per_byte))

    def spec(self) -> str:
        return ",".join(t.describe() for t in self.tiers)

    def describe(self) -> str:
        return self.spec()

    # -- construction --------------------------------------------------------

    @staticmethod
    def flat(world: int, link, name: str = "link",
             link_name: str = "") -> "Topology":
        """The degenerate single-tier network a bare ``LinkParams``
        denotes — reproduces the pre-topology cost model bit-for-bit."""
        return Topology((Tier(name, int(world), link, link_name),))

    @classmethod
    def from_spec(cls, spec: str) -> "Topology":
        """Parse ``"node:4@datacenter,device:8@fast_ici"`` (outermost
        first; each ``@link`` is a ``LINK_PRESETS`` name) or a
        ``TOPOLOGY_PRESETS`` key."""
        from repro_torch.core.schedule.cost import LINK_PRESETS
        spec = spec.strip()
        if spec in TOPOLOGY_PRESETS:
            spec = TOPOLOGY_PRESETS[spec]
        tiers = []
        for part in spec.split(","):
            part = part.strip()
            try:
                name_size, link_name = part.split("@")
                name, size = name_size.split(":")
                size = int(size)
            except ValueError:
                raise ValueError(
                    f"bad tier spec {part!r} (want name:size@link, e.g. "
                    f"node:4@datacenter)") from None
            if link_name not in LINK_PRESETS:
                raise ValueError(f"unknown link preset {link_name!r} in "
                                 f"{part!r}; known: {sorted(LINK_PRESETS)}")
            tiers.append(Tier(name.strip(), size, LINK_PRESETS[link_name],
                              link_name))
        return cls(tuple(tiers))

    # -- axis placement ------------------------------------------------------

    def place(self, axis_size: int, tier_index: int
              ) -> Tuple[Tier, "Topology"]:
        """Consume an axis of ``axis_size`` ranks from tier
        ``tier_index``: returns ``(placed, remaining)`` where ``placed``
        is a tier of that size on the host tier's link (what the placed
        axis' traffic pays — e.g. pipeline p2p) and ``remaining`` is the
        topology the OTHER axes see (the tier shrunk or removed).  This
        is the planner's axis-placement primitive: "pipeline across
        nodes, dense ring inside" is ``place(S, 0)``."""
        t = self.tiers[tier_index]
        if axis_size < 1 or t.size % axis_size != 0:
            raise ValueError(f"axis of {axis_size} does not divide tier "
                             f"{t.name}:{t.size}")
        placed = Tier(t.name, int(axis_size), t.link, t.link_name, t.fit)
        rest = t.size // axis_size
        tiers = list(self.tiers)
        if rest == 1:
            del tiers[tier_index]
        else:
            tiers[tier_index] = Tier(t.name, rest, t.link, t.link_name,
                                     t.fit)
        if not tiers:        # fully consumed: a 1-rank degenerate network
            tiers = [Tier(t.name, 1, t.link, t.link_name, t.fit)]
        return placed, Topology(tuple(tiers))


def as_topology(net: Union[Topology, "LinkParams"], world: int) -> Topology:
    """Normalize the ``net`` argument every cost function takes: a
    ``Topology`` must agree with ``world`` (the deprecated ``plan_world``
    path resolves the disagreement BEFORE pricing — see api.plan_auto); a
    bare
    ``LinkParams`` becomes the flat single-tier topology.  A
    ``schedule.calibration.CalibratedTopology`` (anything carrying a
    ``.topology``) unwraps to its fitted topology, so calibrated fabrics
    drop into every cost function unchanged."""
    inner = getattr(net, "topology", None)
    if isinstance(inner, Topology):
        net = inner
    if isinstance(net, Topology):
        if net.world != int(world):
            raise ValueError(
                f"topology world {net.world} ({net.spec()}) != requested "
                f"world {world}; derive world from the topology")
        return net
    return Topology.flat(world, net)
