"""ParallelismSpec — the one object naming HOW the world is factored; a
copy of ``repro/core/parallelism.py`` (the port imports nothing of the
JAX package), held to it by ``tests/test_torch_planner.py``.

The planner grew one axis at a time — ``shard_state``, pipeline
``(stages, micro_batches)``, the plan-side ``pipe_tier`` placement, and
tensor/expert parallelism — each as its own knob on
``SyncStrategy`` / ``StrategyPlan`` / the CLI.  Wei et al. 2024
(PAPERS.md) frame 3D-parallelism × topology co-design as ONE decision;
this dataclass is that decision's schema: the per-axis group sizes
(``dp × tp × pp × ep`` must tile the world), the tier each model axis is
placed on (``Topology.place`` semantics, DESIGN.md §10), the pipeline's
micro-batch count, and the ZeRO shard-state flag — everything execution
and pricing need to agree on the factorization.

The spec string mirrors ``Topology.from_spec``'s grammar::

    dp=4,tp=2@fast_ici,pp=2@node,micro=8
    ep=2@device,shard

Each entry is ``axis=size[@tier]`` (``@tier`` names the topology tier
the axis consumes; meaningless for ``dp``, which takes whatever ranks
remain), plus the standalone tokens ``micro=M`` (pipeline micro-batches)
and ``shard`` (ZeRO-style optimizer-state sharding over the dp axis).
``dp=0`` (the default) means "infer": :meth:`resolve` fills it from the
world size.  DESIGN.md §14 documents the schema and the deprecation
table for the per-knob surface this replaces.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Union

_AXES = ("dp", "tp", "pp", "ep")


@dataclasses.dataclass(frozen=True)
class ParallelismSpec:
    """How the world factors into dp × tp × pp × ep (+ placements).

    ``dp=0`` means *inferred*: :meth:`resolve` divides the world by the
    model axes.  ``micro_batches=0`` means the executor's default (8 for
    a real pipeline, 1 otherwise).  ``*_tier`` names the topology tier
    the axis consumes (empty = let the planner search placements / flat
    network).  ``shard_state`` is the ZeRO memory mode of the dp axis —
    it rides here because it is the same decision space (how optimizer
    state is laid out across the factored world), and because it is
    mutually exclusive with ``pp > 1`` (each is its own answer to the
    optimizer-memory axis, DESIGN.md §9)."""
    dp: int = 0
    tp: int = 1
    pp: int = 1
    ep: int = 1
    tp_tier: str = ""
    pp_tier: str = ""
    ep_tier: str = ""
    micro_batches: int = 0
    shard_state: bool = False

    def __post_init__(self):
        if self.dp < 0:
            raise ValueError(f"dp must be >= 1 (or 0 = inferred), "
                             f"got {self.dp}")
        for ax in ("tp", "pp", "ep"):
            n = int(getattr(self, ax))
            if n < 1:
                raise ValueError(f"{ax} must be >= 1, got {n}")
            tier = getattr(self, f"{ax}_tier")
            if tier and n == 1:
                raise ValueError(f"{ax}_tier={tier!r} is meaningless with "
                                 f"{ax}=1")
        if self.micro_batches < 0:
            raise ValueError(f"micro_batches must be >= 0, "
                             f"got {self.micro_batches}")
        if self.pp > 1 and self.shard_state:
            raise ValueError(
                "pp > 1 composes with replicated DP only: the sharded "
                "forward-edge all-gather and the pipeline's boundary sends "
                "are competing answers to the same memory axis — pick one "
                "(DESIGN.md §9)")

    # -- views ---------------------------------------------------------------

    @property
    def model_world(self) -> int:
        """Ranks one model replica spans: tp × pp × ep."""
        return int(self.tp) * int(self.pp) * int(self.ep)

    @property
    def world(self) -> int:
        """Total ranks (requires a resolved dp)."""
        if self.dp < 1:
            raise ValueError(f"spec {self.spec()!r} has unresolved dp=0; "
                             f"call resolve(world_or_topology) first")
        return self.dp * self.model_world

    @property
    def is_trivial(self) -> bool:
        """Pure replicated data parallelism, no micro-batching, no shard."""
        return (self.model_world == 1 and not self.shard_state
                and self.micro_batches in (0, 1))

    @property
    def has_model_axes(self) -> bool:
        return self.model_world > 1

    def spec(self) -> str:
        """The canonical spec string (``from_spec`` round-trips it)."""
        parts = []
        if self.dp:
            parts.append(f"dp={self.dp}")
        for ax in ("tp", "pp", "ep"):
            n = getattr(self, ax)
            tier = getattr(self, f"{ax}_tier")
            if n > 1:
                parts.append(f"{ax}={n}" + (f"@{tier}" if tier else ""))
        if self.micro_batches:
            parts.append(f"micro={self.micro_batches}")
        if self.shard_state:
            parts.append("shard")
        return ",".join(parts)

    def describe(self) -> str:
        return self.spec() or "dp (replicated)"

    # -- construction --------------------------------------------------------

    @classmethod
    def from_spec(cls, spec: str) -> "ParallelismSpec":
        """Parse ``"dp=4,tp=2@fast_ici,pp=2@node,micro=8"`` (mirrors
        ``Topology.from_spec``'s grammar and error style)."""
        kw: Dict[str, Any] = {}

        def put(key, value, part):
            if key in kw:
                raise ValueError(f"duplicate axis in parallelism spec: "
                                 f"{part!r}")
            kw[key] = value

        for part in str(spec).split(","):
            part = part.strip()
            if not part:
                continue
            if part == "shard":
                put("shard_state", True, part)
                continue
            body, _, tier = part.partition("@")
            try:
                axis, size = body.split("=")
                axis, size = axis.strip(), int(size)
            except ValueError:
                raise ValueError(
                    f"bad parallelism entry {part!r} (want axis=size[@tier]"
                    f", e.g. tp=2@fast_ici, or the tokens micro=M / shard)"
                ) from None
            if axis == "micro":
                if tier:
                    raise ValueError(f"micro takes no tier placement: "
                                     f"{part!r}")
                put("micro_batches", size, part)
            elif axis in _AXES:
                put(axis, size, part)
                if tier:
                    if axis == "dp":
                        raise ValueError(
                            f"dp takes no tier placement ({part!r}): it "
                            f"spans whatever ranks the model axes leave")
                    put(f"{axis}_tier", tier.strip(), part)
            else:
                raise ValueError(f"unknown parallelism axis {axis!r} in "
                                 f"{part!r}; known: "
                                 f"{', '.join(_AXES)}, micro")
        return cls(**kw)

    @classmethod
    def coerce(cls, value: Union["ParallelismSpec", str, None]
               ) -> "ParallelismSpec":
        """``None`` → trivial spec; a string → :meth:`from_spec`."""
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        return cls.from_spec(value)

    # -- validation ----------------------------------------------------------

    def resolve(self, net) -> "ParallelismSpec":
        """Validate against a world size (int) or a
        :class:`~repro_torch.core.schedule.topology.Topology` and return the
        spec with ``dp`` filled in.  Raises loudly when the axis product
        does not tile the world or a named tier does not exist / cannot
        host the axis — the planner's divisibility guard."""
        world = int(net) if isinstance(net, int) else int(net.world)
        mw = self.model_world
        if world % mw:
            raise ValueError(
                f"parallelism spec {self.spec()!r}: model axes tp×pp×ep = "
                f"{mw} do not divide world {world}")
        dp = world // mw
        if self.dp and self.dp != dp:
            raise ValueError(
                f"parallelism spec {self.spec()!r}: dp={self.dp} × "
                f"tp={self.tp} × pp={self.pp} × ep={self.ep} = "
                f"{self.dp * mw} != world {world}")
        if not isinstance(net, int):
            names = [t.name for t in net.tiers]
            for ax in ("tp", "pp", "ep"):
                tier = getattr(self, f"{ax}_tier")
                if not tier:
                    continue
                match = [t for t in net.tiers if t.name == tier]
                if not match:
                    raise ValueError(
                        f"parallelism spec {self.spec()!r}: no tier named "
                        f"{tier!r} in topology {net.spec()} "
                        f"(tiers: {names})")
                size = int(getattr(self, ax))
                if match[0].size % size:
                    raise ValueError(
                        f"parallelism spec {self.spec()!r}: {ax}={size} "
                        f"does not divide tier {tier}:{match[0].size}")
        return dataclasses.replace(self, dp=dp)

    def validate(self, net) -> None:
        self.resolve(net)

    # -- legacy bridge (the per-knob surface) ---------------------------------

    @classmethod
    def legacy(cls, shard_state: bool = False, pipeline_stages: int = 1,
               micro_batches: int = 1, pipe_tier: str = "") -> \
            "ParallelismSpec":
        """Build a spec from the deprecated per-knob trio (+ the plan-side
        ``pipe_tier``) — what the warned CLI shims and the
        ``SyncStrategy`` pass-through constructor produce."""
        pp = max(int(pipeline_stages), 1)
        micro = int(micro_batches)
        if pp == 1 and micro <= 1:
            micro = 0       # the executor default, not an explicit pin
        return cls(pp=pp, pp_tier=pipe_tier if pp > 1 else "",
                   micro_batches=micro, shard_state=bool(shard_state))

    # -- record schema (DESIGN.md §14) ---------------------------------------

    def to_record(self) -> Dict[str, Any]:
        """The plan-record ``parallelism`` block: additive, emitted only
        for non-trivial specs so pre-existing records keep their exact
        key set (the schema-compat rule)."""
        rec: Dict[str, Any] = {"spec": self.spec(), "dp": int(self.dp),
                               "tp": int(self.tp), "pp": int(self.pp),
                               "ep": int(self.ep)}
        for ax in ("tp", "pp", "ep"):
            tier = getattr(self, f"{ax}_tier")
            if tier:
                rec[f"{ax}_tier"] = tier
        if self.micro_batches:
            rec["micro_batches"] = int(self.micro_batches)
        if self.shard_state:
            rec["shard_state"] = True
        return rec

    @classmethod
    def from_record(cls, rec: Dict[str, Any]) -> "ParallelismSpec":
        return cls(dp=int(rec.get("dp", 0)), tp=int(rec.get("tp", 1)),
                   pp=int(rec.get("pp", 1)), ep=int(rec.get("ep", 1)),
                   tp_tier=rec.get("tp_tier", ""),
                   pp_tier=rec.get("pp_tier", ""),
                   ep_tier=rec.get("ep_tier", ""),
                   micro_batches=int(rec.get("micro_batches", 0)),
                   shard_state=bool(rec.get("shard_state", False)))
