"""Shared model substrate of the port: parameter descriptors, RMSNorm, RoPE,
the gated MLP, the embedding and the cross-entropy — counterparts of
``repro/models/layers.py``.

Parameters are nested dicts of tensors laid out exactly as the JAX
package's parameter tree (``repro_torch.convert.params_from_jax`` carries
one over leaf by leaf).  Descriptors keep the shape, the init kind and
the reference's logical axis names; :func:`sharding_rules` and
:func:`partition_specs` map those names onto mesh axes as the reference
does, and ``convert.serve_slice`` cuts a tree to one model-axis rank's
share by them (the port has no partitioner).  :func:`embed_tp` and
:func:`logits_tp` are the vocab-parallel embedding and LM head of
serving under ``sharding_ctx.serve_region``; :func:`embed_tp` (with
``train_algo``), :func:`softmax_xent_tp`, :func:`replica_edge`, and the
recurrent mixers' differentiable f32 sum :func:`sum_f32` and gather
:func:`gather_tp` the train layout's under ``sharding_ctx.train_region``,
and :func:`fan`, :func:`tree_sum`, :func:`mlp_blocked` and
:func:`softmax_xent_blocked` its control's.  :class:`Lanes` runs a split
mixer's work as one rank or as the control with the same arithmetic.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch._tree import tree_leaves, tree_map

# ---------------------------------------------------------------------------
# Parameter descriptors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamDesc:
    """Abstract parameter: shape, init kind (``normal``: N(0,1) /
    sqrt(fan_in); ``small``: N(0,1) * 0.02; ``zeros``; ``ones``), the
    reference's logical axis name per dim (None: replicated), and
    ``parts``: the number of tensors packed side by side on the dim that
    the serve rules put on the model axis (Mamba's ``in_proj`` [x | z]:
    2; the sLSTM's ``w_in``, head x {i, f, z, o} x dh: 4·H).  A rank's
    share of such a leaf is its block of every part, not one contiguous
    block of the dim (``convert.serve_slice``)."""
    shape: Tuple[int, ...]
    init: str = "normal"
    scale: Optional[float] = None     # overrides the default fan-in scale
    axes: Optional[Tuple[Optional[str], ...]] = None
    parts: int = 1

    def __post_init__(self):
        if self.axes is not None and len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} do not name the dims of "
                             f"{self.shape}")


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a tensor not yet allocated (the port's
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _is_desc(x) -> bool:
    return isinstance(x, ParamDesc)


def stack_desc(tree, n: int):
    """Prepend a stacked "layers" dim of size n to every descriptor."""
    return tree_map(lambda d: ParamDesc((n,) + d.shape, d.init, d.scale,
                                        ("layers",) + (d.axes or (None,) * len(d.shape)),
                                        d.parts),
                    tree, is_leaf=_is_desc)


# Leaves of more elements than this are drawn one leading-axis slice at a
# time: the f32 draw of a whole leaf is a transient of 4 bytes an element
# beside the leaves already drawn, 38.7 GB for one of qwen3-moe-30b-a3b's
# stacked expert leaves (48, 128, 2048, 768).  Every leaf of gemma-2b,
# gemma2-9b and gemma3-4b lies below it, so their draws are unchanged.
SLICED_DRAW_ELEMENTS = 2**31


def _init_leaf(d: ParamDesc, generator: torch.Generator, dtype):
    """One leaf drawn from ``generator`` in f32, scaled and cast to
    ``dtype``.  A leaf of more than ``SLICED_DRAW_ELEMENTS`` (2**31)
    elements is drawn one leading-axis slice at a time, so that its f32
    transient is one slice, not the whole leaf (see the constant)."""
    device = generator.device
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else max(d.shape[-1], 1)
    scale = d.scale if d.scale is not None else 1.0 / math.sqrt(fan_in)
    if d.init == "small":
        scale = 0.02
    if math.prod(d.shape) > SLICED_DRAW_ELEMENTS:
        out = torch.empty(d.shape, dtype=dtype, device=device)
        for i in range(d.shape[0]):
            out[i] = torch.randn(d.shape[1:], generator=generator,
                                 dtype=torch.float32, device=device).mul_(scale)
        return out
    x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.mul_(scale).to(dtype)


def materialize(tree, generator: torch.Generator, dtype=torch.float32,
                post=None):
    """Concrete parameter values for a descriptor tree, drawn in the tree's
    leaf order from ``generator`` on the generator's device.  The values
    differ from ``jax.random``'s for the same seed.  ``post(x)``, when
    given, replaces each leaf as soon as it is drawn (before the next
    draw)."""
    def leaf(d):
        x = _init_leaf(d, generator, dtype)
        return x if post is None else post(x)
    return tree_map(leaf, tree, is_leaf=_is_desc)


def desc_leaves(tree):
    return tree_leaves(tree, is_leaf=_is_desc)


# ---------------------------------------------------------------------------
# Logical axes -> mesh axes (reference ``layers.py:70-104``)
# ---------------------------------------------------------------------------

def partition_specs(tree, rules: Dict[str, object]):
    """Map every descriptor's logical axes to mesh axes through ``rules``
    (name -> mesh axis, a tuple of them, or None); unknown names map to
    None (replicated).  When two dims of one leaf resolve to the same mesh
    axis (an (experts, embed, ffn) MoE weight with experts -> model and
    ffn -> model), only the first keeps it: a mesh axis shards at most
    one dim.  Each leaf's spec is a tuple, one entry per dim (the
    reference's ``PartitionSpec``)."""
    def f(d: ParamDesc):
        used = set()
        out = []
        for a in d.axes or (None,) * len(d.shape):
            r = rules.get(a) if a is not None else None
            flat = tuple(r) if isinstance(r, tuple) else (r,)
            if r is not None and not (set(flat) & used):
                used.update(flat)
                out.append(r)
            else:
                out.append(None)
        return tuple(out)
    return tree_map(f, tree, is_leaf=_is_desc)


def sharding_rules(phase: str, multi_pod: bool = False) -> Dict[str, object]:
    """The reference's logical-axis -> mesh-axis rules: at train the
    d_model ("embed") dim goes over the data axes too (FSDP); at serve
    parameters are replicated over data and split over the model axis
    only."""
    data = ("pod", "data") if multi_pod else "data"
    tp = "model"
    if phase == "train":
        return {"vocab": tp, "embed": data, "heads": tp, "kv": tp, "ffn": tp,
                "experts": tp, "layers": None, "lora": None, "state": None,
                "inner": tp}
    return {"vocab": tp, "embed": None, "heads": tp, "kv": tp, "ffn": tp,
            "experts": tp, "layers": None, "lora": None, "state": None,
            "inner": tp}


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_desc(d: int) -> Dict[str, ParamDesc]:
    return {"scale": ParamDesc((d,), "zeros", axes=(None,))}


def rmsnorm(params, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the scale stored as a zero-initialized delta, applied as
    (1 + w).  Statistics in f32, result cast back to the input dtype."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    y = y * (1.0 + params["scale"].to(torch.float32))
    return y.to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., T, H, hd); positions: broadcastable to (..., T).  The head
    dim is split into halves (not interleaved pairs), computed in f32."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)          # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs        # (..., T, hd/2)
    angles = angles[..., None, :]                                  # (..., T, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def mlp_desc(d: int, d_ff: int) -> Dict[str, ParamDesc]:
    return {
        "wi_gate": ParamDesc((d, d_ff), axes=("embed", "ffn")),
        "wi_up": ParamDesc((d, d_ff), axes=("embed", "ffn")),
        "wo": ParamDesc((d_ff, d), axes=("ffn", "embed")),
    }


def _activation(name: str):
    if name == "swiglu":
        return F.silu
    # jax.nn.gelu defaults to the tanh approximation
    return lambda t: F.gelu(t, approximate="tanh")


def mlp(params, x: torch.Tensor, activation: str = "swiglu") -> torch.Tensor:
    act = _activation(activation)
    gate = act(x @ params["wi_gate"])
    up = x @ params["wi_up"]
    return (gate * up) @ params["wo"]


# ---------------------------------------------------------------------------
# Tensor-parallel MLP: the Megatron f/g operator pair
# ---------------------------------------------------------------------------
#
# Column-parallel wi then row-parallel wo: each tp rank holds a 1/tp slice
# of the ffn dim and computes its partial output; one all-reduce per MLP in
# the forward (tp_out) and one in the backward (tp_in's).  The pair is two
# autograd Functions on a tp process group, so the wire is the port's own:
# the forward reduction goes through ``collectives.api.allreduce`` (any
# algorithm), and the backward reduction of the input cotangent makes every
# parameter outside the MLP get the same gradient on every tp rank, so the
# gradient sync reduces over the data axes only.

class _TpIn(torch.autograd.Function):
    """Megatron's ``f``: identity forward, sum over the tp group in the
    backward."""

    @staticmethod
    def forward(ctx, x, group, algo):
        ctx.group, ctx.algo = group, algo
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.core.collectives.api import allreduce
        return (allreduce(g.contiguous().clone(), ctx.algo, (ctx.group,)),
                None, None)


class _TpOut(torch.autograd.Function):
    """Megatron's ``g``: all-reduce over the tp group in the forward (into
    a buffer of its own: ``psum`` sums in place), identity backward."""

    @staticmethod
    def forward(ctx, x, group, algo):
        from repro_torch.core.collectives.api import allreduce
        return allreduce(x.contiguous().clone(), algo, (group,))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def tp_in(x: torch.Tensor, group, algo: str = "psum") -> torch.Tensor:
    """Wrap the activations entering a column-parallel block: identity
    forward; the backward sums the partial input cotangents that each
    rank's weight slice produced over ``group`` (a process group) with
    ``collectives.api.allreduce(g, algo, (group,))``."""
    return _TpIn.apply(x, group, algo)


def tp_out(x: torch.Tensor, group, algo: str = "psum") -> torch.Tensor:
    """All-reduce a row-parallel partial output over ``group`` with
    ``collectives.api.allreduce(x, algo, (group,))``; identity backward
    (the output cotangent is already whole on every rank)."""
    return _TpOut.apply(x, group, algo)


def gather_cat(x: torch.Tensor, groups, dim: int) -> torch.Tensor:
    """Every rank's ``x`` over the process ``groups`` (outermost first),
    concatenated on ``dim`` in block order: the group's rank index major,
    as a dim split over ``(data, model)`` lays its blocks.  One
    all-gather a group, innermost first."""
    from repro_torch.core.collectives.api import all_gather
    for g in reversed(tuple(groups)):
        x = torch.cat(all_gather(x.contiguous(), g).unbind(0), dim=dim)
    return x


def psum_f32(part: torch.Tensor, group, dtype) -> torch.Tensor:
    """The sum over ``group`` of the ranks' f32 partial products ``part``
    (bf16 operands multiply exactly in f32), all-reduced in f32 and
    rounded once to ``dtype``: as the unsharded GEMM accumulates in f32
    and rounds once, where the recurrences would amplify the extra
    roundings of a sum of bf16 partials."""
    from repro_torch.core.collectives.api import allreduce
    part = part.to(torch.float32).contiguous()
    return allreduce(part, "psum", (group,)).to(dtype)


def mlp_tp(params, x: torch.Tensor, activation: str = "swiglu", *, group,
           algo: str = "psum") -> torch.Tensor:
    """Tensor-parallel gated MLP: ``params`` hold this rank's 1/tp slice of
    the ffn dim (wi_gate / wi_up cut on their output features, wo on its
    input features; ``convert.tp_slice``); both sums on ``algo``.
    Bit-equal to :func:`mlp_blocked` with ``tp`` blocks at tp = 2 (float
    addition is commutative) and on ``tree`` at any tp."""
    act = _activation(activation)
    xin = tp_in(x, group, algo)
    gate = act(xin @ params["wi_gate"])
    up = xin @ params["wi_up"]
    return tp_out((gate * up) @ params["wo"], group, algo)


# ---------------------------------------------------------------------------
# The train layout's pieces over the model axis, and its control
# ---------------------------------------------------------------------------
#
# A rank of the train layout (``sharding_ctx.train_region``) reads a leaf
# that several ranks hold the same (a kv head shared by several head
# blocks, a head block held by several ranks, the QK-norm scales) only
# through its own heads, so its cotangent there is a partial sum:
# ``replica_edge`` sums it over the ranks that hold the block.  The
# control (``sharding_ctx.blocked_region``) runs the ranks' blocks in one
# process: ``fan`` hands one input to each block and sums the blocks'
# cotangents, and ``tree_sum`` sums the blocks' partial outputs, both in
# the order the ``tree`` all-reduce sums the ranks.

def tree_sum(xs):
    """The sum of ``xs`` in the ``tree`` all-reduce's order over as many
    ranks (``core/collectives/tree.py``: each rank absorbs its neighbour
    at distance 1, 2, 4, ...): adjacent pairs, level by level.  For two
    terms any all-reduce's order."""
    xs = list(xs)
    if len(xs) & (len(xs) - 1):
        raise ValueError(f"the tree order sums a power of two of terms, "
                         f"got {len(xs)}")
    while len(xs) > 1:
        xs = [xs[i] + xs[i + 1] for i in range(0, len(xs), 2)]
    return xs[0]


class _Fan(torch.autograd.Function):
    """``n`` identity views of ``x``; the backward sums their cotangents
    by :func:`tree_sum`: the control's stand-in for ``tp_in`` and for the
    replica edge."""

    @staticmethod
    def forward(ctx, x, n):
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *gs):
        return tree_sum(gs), None


def fan(x: torch.Tensor, n: int):
    """``n`` views of ``x`` whose cotangents are summed in the tree
    order (a tuple)."""
    return _Fan.apply(x, n)


def mlp_blocked(params, x: torch.Tensor, activation: str = "swiglu",
                blocks: int = 2) -> torch.Tensor:
    """The tensor-parallel checks' reference: the contraction of
    :func:`mlp` in ``blocks`` contiguous ffn slices (as tp ranks hold
    them: the matmul of a strided operand may take another kernel), the
    arithmetic of a tp group on one device.  Each block reads ``x``
    through its own view of :func:`fan` (the reference's optimization
    barrier), so that the block's two input-cotangent contributions are
    summed before the blocks' are, as a tp rank sums its two before the
    all-reduce; the blocks' outputs and input cotangents add by
    :func:`tree_sum` (for two blocks, any all-reduce's order), whole
    before they meet another use of ``x`` by the caller (a residual).
    Left to itself autograd would fold every contribution into ``x`` in
    its own order."""
    act = _activation(activation)
    d_ff = params["wi_gate"].shape[-1]
    if d_ff % blocks:
        raise ValueError(f"d_ff={d_ff} does not split into {blocks} blocks")
    gates = torch.chunk(params["wi_gate"], blocks, dim=-1)
    ups = torch.chunk(params["wi_up"], blocks, dim=-1)
    wos = torch.chunk(params["wo"], blocks, dim=-2)
    parts = []
    for xb, wg, wu, wo in zip(fan(x, blocks), gates, ups, wos):
        parts.append((act(xb @ wg.contiguous()) * (xb @ wu.contiguous()))
                     @ wo.contiguous())
    return tree_sum(parts)


class _ReplicaEdge(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over the ranks
    that hold the same block: each rank puts its cotangent at row
    ``index`` of ``blocks`` zero rows, one all-reduce over the group sums
    them, and the rank keeps its row (a rank that holds no other adds
    exact zeros to it)."""

    @staticmethod
    def forward(ctx, x, group, algo, blocks, index):
        ctx.args = (group, algo, blocks, index)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.core.collectives.api import allreduce
        group, algo, blocks, index = ctx.args
        if blocks == 1:
            return allreduce(g.contiguous().clone(), algo,
                             (group,)), None, None, None, None
        buf = torch.zeros((blocks,) + tuple(g.shape), dtype=g.dtype,
                          device=g.device)
        buf[index] = g
        return (allreduce(buf, algo, (group,))[index], None, None, None,
                None)


def replica_edge(x: torch.Tensor, group, algo: str = "psum",
                 blocks: int = 1, index: int = 0) -> torch.Tensor:
    """Wrap a leaf that several ranks of ``group`` hold the same but each
    reads only through its own share of the work (the replica edge): the
    leaf is one of ``blocks`` distinct blocks over the group, this rank's
    being block ``index``; the backward sums the rank's partial cotangent
    with those of the other ranks holding block ``index``."""
    return _ReplicaEdge.apply(x, group, algo, blocks, index)


class _Muted(torch.autograd.Function):
    """Zeros in both directions, the graph kept: a replica head block's
    ``wo`` partial, which must add nothing, yet whose backward must run
    the same collectives as the block's first holder."""

    @staticmethod
    def forward(ctx, x):
        return torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g)


def muted(x: torch.Tensor, mute: bool) -> torch.Tensor:
    """``x``, or zeros of its shape that keep it in the graph."""
    return _Muted.apply(x) if mute else x


def replica_edges(params, edges, ta):
    """``params`` (one mixer's leaves, stacked or not) with each leaf named
    in ``edges`` (name -> (blocks, index), as ``attention.edge_blocks``
    gives them; a name the mixer lacks is skipped) wrapped in
    :func:`replica_edge` over the train layout's group (``ta``:
    ``sharding_ctx.TrainAxes``); a norm's ``scale`` inside its dict."""
    out = dict(params)
    for name, (blocks, index) in edges.items():
        if name not in params:
            continue

        def edge(t, blocks=blocks, index=index):
            return replica_edge(t, ta.tp, ta.algo, blocks, index)
        out[name] = ({"scale": edge(params[name]["scale"])}
                     if isinstance(params[name], dict) else
                     edge(params[name]))
    return out


# ---------------------------------------------------------------------------
# The recurrent mixers' sums and gathers under the train layout, and the
# lanes that run a split mixer as one rank or as the control
# ---------------------------------------------------------------------------
#
# Mamba's x_proj and the mLSTM's q / k / v / gates are partial products of
# the rank's channels whose sum every rank then reads through its own
# channels (:func:`sum_f32`); the mLSTM's h and the sLSTM's gates are the
# rank's blocks gathered whole (:func:`gather_tp`).  The sums run in f32
# and round once, as serving's ``psum_f32`` does.

class _SumF32(torch.autograd.Function):
    """The f32 all-reduce of the ranks' partials, rounded once to
    ``dtype``; the backward all-reduces the cotangent in f32 (each rank
    reads the sum through its own share, so its cotangent is partial)."""

    @staticmethod
    def forward(ctx, part, group, algo, dtype):
        from repro_torch.core.collectives.api import allreduce
        ctx.args = (group, algo, part.dtype)
        buf = part.to(torch.float32, copy=True).contiguous()
        return allreduce(buf, algo, (group,)).to(dtype)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.core.collectives.api import allreduce
        group, algo, dtype = ctx.args
        g = allreduce(g.to(torch.float32, copy=True).contiguous(), algo,
                      (group,))
        return g.to(dtype), None, None, None


def sum_f32(part: torch.Tensor, group, algo: str = "psum",
            dtype=None) -> torch.Tensor:
    """``tp_in(tp_out(part))`` in f32: the sum over ``group`` of the
    ranks' f32 partial products ``part``, rounded once to ``dtype`` (the
    part's by default), whose every rank reads it through its own share
    of the work; the backward sums the ranks' partial cotangents in f32.
    Both all-reduces on ``algo``."""
    return _SumF32.apply(part, group, algo, dtype or part.dtype)


class _GatherTp(torch.autograd.Function):
    """:func:`gather_cat` over one group; the backward keeps the rank's
    block of the cotangent, all-reduced first where it is partial."""

    @staticmethod
    def forward(ctx, x, group, algo, dim, partial):
        from repro_torch.core.collectives.p2p import axis_index
        ctx.args = (group, algo, dim, partial, x.shape[dim],
                    axis_index(group))
        return gather_cat(x, (group,), dim)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.core.collectives.api import allreduce
        group, algo, dim, partial, n, rank = ctx.args
        if partial:
            g = allreduce(g.contiguous().clone(), algo, (group,))
        return g.narrow(dim, rank * n, n), None, None, None, None


def gather_tp(x: torch.Tensor, group, algo: str = "psum", dim: int = -1,
              partial: bool = True) -> torch.Tensor:
    """Every rank's block ``x`` of ``group`` concatenated on ``dim`` in
    rank order, differentiable.  ``partial``: the gathered tensor's
    consumers are split over the ranks, so its cotangent is partial and
    the backward is a reduce-scatter to the rank's block (the all-reduce
    on ``algo`` and the rank's slice, as ``collectives.reduce_scatter``
    runs it on psum, so that the ranks on ``tree`` sum in the control's
    order); otherwise every rank computes the same from it with the same
    cotangent, and the backward is the rank's own block, no collective."""
    return _GatherTp.apply(x, group, algo, dim, partial)


class Lanes:
    """A split mixer's work under the train layout, as one rank runs it
    (``group``: one lane, the rank's share of the parameters, the pieces'
    collectives over the group on ``algo``) or as the control
    (``sharding_ctx.blocked_region``: no group, one lane for each of
    ``ranks``, the first holder of each distinct block, on the whole
    parameters cut as that rank holds them, every sum in the ``tree``
    all-reduce's order): the ranks' arithmetic in one process.
    ``ranks`` is the rank's own index on a rank; ``tp`` the group's
    size."""

    def __init__(self, ranks, tp: int, group=None, algo: str = "psum"):
        self.ranks, self.tp = tuple(ranks), tp
        self.group, self.algo = group, algo

    def share(self, params, cfg, desc, fanned=()):
        """Each lane's parameters: the rank's share as given, or in the
        control each lane's rank's cut of the whole ``params``
        (``convert.train_share`` by the mixer's descriptors ``desc``),
        the whole leaves ``fanned`` (read by every lane) through
        :func:`fan`, every other whole leaf as it is."""
        if self.group is not None:
            return [params]
        from repro_torch.convert import train_share
        cuts = [train_share(params, desc, cfg, r, self.tp)
                for r in self.ranks]
        for name in fanned:
            leaf = params[name]
            views = fan(leaf["scale"] if isinstance(leaf, dict) else leaf,
                        len(cuts))
            for c, v in zip(cuts, views):
                c[name] = {"scale": v} if isinstance(leaf, dict) else v
        return cuts

    def enter(self, x: torch.Tensor):
        """``x`` (whole, the same on every rank) into the lanes: ``tp_in``
        on a rank, :func:`fan` in the control."""
        if self.group is not None:
            return [tp_in(x, self.group, self.algo)]
        return list(fan(x, len(self.ranks)))

    def out(self, parts, mute: bool = False) -> torch.Tensor:
        """The lanes' partial outputs summed: ``tp_out`` (of zeros that
        keep the graph where ``mute``: a replica head block), or
        :func:`tree_sum`."""
        if self.group is not None:
            return tp_out(muted(parts[0], mute), self.group, self.algo)
        return tree_sum(parts)

    def out_f32(self, parts, dtype) -> torch.Tensor:
        """The lanes' partial outputs summed in f32 and rounded once to
        ``dtype``."""
        parts = [p.to(torch.float32) for p in parts]
        if self.group is not None:
            return tp_out(parts[0], self.group, self.algo).to(dtype)
        return tree_sum(parts).to(dtype)

    def sum_f32(self, parts, dtype):
        """:func:`sum_f32` of the lanes' partials, one view a lane."""
        if self.group is not None:
            return [sum_f32(parts[0], self.group, self.algo, dtype)]
        whole = tree_sum([p.to(torch.float32) for p in parts])
        return [v.to(dtype) for v in fan(whole, len(parts))]

    def gather_split(self, parts, dim: int):
        """The lanes' blocks concatenated on ``dim``, one view a lane (the
        consumers are split: :func:`gather_tp` with ``partial``)."""
        if self.group is not None:
            return [gather_tp(parts[0], self.group, self.algo, dim)]
        return list(fan(torch.cat(parts, dim), len(parts)))

    def gather_whole(self, parts, dim: int) -> torch.Tensor:
        """The lanes' blocks concatenated on ``dim``, one tensor that every
        rank reads whole (:func:`gather_tp` without ``partial``)."""
        if self.group is not None:
            return gather_tp(parts[0], self.group, self.algo, dim,
                             partial=False)
        return torch.cat(parts, dim)


def train_lanes(blocks) -> Optional["Lanes"]:
    """The active train layout's :class:`Lanes`, or its control's
    (``blocks(tp)``: the ranks whose work the control's lanes do), or
    None outside both."""
    from repro_torch.models.sharding_ctx import blocked_tp, train_axes
    ta = train_axes()
    if ta is not None:
        from repro_torch.core.collectives.p2p import axis_index, axis_size
        return Lanes((axis_index(ta.tp),), axis_size(ta.tp), ta.tp, ta.algo)
    tp = blocked_tp()
    return None if tp is None else Lanes(blocks(tp), tp)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embedding_desc(vocab: int, d: int) -> Dict[str, ParamDesc]:
    return {"table": ParamDesc((vocab, d), "small", axes=("vocab", "embed"))}


def embed(params, tokens: torch.Tensor, *, scale: bool, d: int) -> torch.Tensor:
    x = params["table"][tokens]
    if scale:
        # sqrt(d) is rounded to the parameter dtype before the multiply
        # (bf16: sqrt(2048) -> 45.25), as in the reference
        x = x * torch.tensor(math.sqrt(d), dtype=x.dtype, device=x.device)
    return x


def embed_tp(params, tokens: torch.Tensor, *, scale: bool, d: int,
             group, train_algo: Optional[str] = None) -> torch.Tensor:
    """Vocab-parallel :func:`embed`: ``params["table"]`` holds this rank's
    block of the vocabulary rows (block ``axis_index(group)``); a token
    outside it gives exact zeros, and one all-reduce over ``group`` sums
    the ranks' rows, at most one of them non-zero, so the result equals
    :func:`embed` of the whole table bit for bit.  ``train_algo`` (the
    train layout): the sum is ``tp_out`` on that algo, an autograd node
    with an identity backward, so each rank's table gradient is exactly
    its own rows'."""
    from repro_torch.core.collectives.api import allreduce
    from repro_torch.core.collectives.p2p import axis_index
    table = params["table"]
    vl = table.shape[0]
    local = tokens - axis_index(group) * vl
    hit = (local >= 0) & (local < vl)
    x = table[torch.clamp(local, 0, vl - 1)]
    x = torch.where(hit[..., None], x, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
    if scale:
        x = x * torch.tensor(math.sqrt(d), dtype=x.dtype, device=x.device)
    if train_algo is not None:
        return tp_out(x, group, train_algo)
    return allreduce(x.contiguous(), "psum", (group,))


def logits_tp(table: torch.Tensor, h: torch.Tensor, group,
              softcap: Optional[float] = None) -> torch.Tensor:
    """Vocab-parallel LM head: this rank's block of the logits
    ``h @ table.T`` (``table``: its vocab rows), all-gathered over
    ``group`` into whole rows in vocabulary order, then the final softcap
    on the whole row (the same on every rank)."""
    from repro_torch.core.collectives.api import all_gather
    part = (h @ table.T).contiguous()                       # (..., V/tp)
    parts = all_gather(part, group)                         # (tp, ..., V/tp)
    logits = torch.movedim(parts, 0, -2).reshape(
        *part.shape[:-1], parts.shape[0] * part.shape[-1])
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def _masked_mean(nll: torch.Tensor, mask: Optional[torch.Tensor]):
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy in f32.  labels: int ids; mask optional."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return _masked_mean(logz - gold, mask)


def _xent_terms(z: torch.Tensor, m: torch.Tensor, labels: torch.Tensor,
                lo: int) -> torch.Tensor:
    """One vocabulary block's terms of the cross-entropy, stacked (2,
    ...): the sum of ``exp(z - m)`` over the block (``z``: its f32
    logits, ``m``: the whole row's maximum) and the gold logit, exactly
    zero where the label lies outside the block ``[lo, lo + V_block)``."""
    vl = z.shape[-1]
    local = labels - lo
    hit = (local >= 0) & (local < vl)
    gold = torch.gather(z, -1, torch.clamp(local, 0, vl - 1)[..., None])
    gold = torch.where(hit, gold[..., 0], torch.zeros((), dtype=z.dtype,
                                                      device=z.device))
    return torch.stack([torch.exp(z - m[..., None]).sum(-1), gold])


def _xent_of(terms: torch.Tensor, m: torch.Tensor, mask):
    """The masked mean nll from the whole row's summed terms."""
    return _masked_mean(torch.log(terms[0]) + m - terms[1], mask)


def softmax_xent_tp(logits: torch.Tensor, labels: torch.Tensor,
                    mask: Optional[torch.Tensor], group,
                    algo: str = "psum") -> torch.Tensor:
    """Vocab-parallel :func:`softmax_xent` (the train layout): ``logits``
    is this rank's block of the vocabulary (block ``axis_index(group)``,
    the final softcap applied, which is elementwise).  The row maximum
    goes through ``collectives.allreduce_max``, the block's sum of
    exponentials and gold logit through one f32 all-reduce on ``algo``
    (``tp_out``: identity backward), so the backward is the block's
    softmax minus the one-hot of the labels in the block; the whole
    logits are never gathered.  The same value on every rank."""
    from repro_torch.core.collectives.api import allreduce_max
    from repro_torch.core.collectives.p2p import axis_index
    z = logits.to(torch.float32)
    m = allreduce_max(z.detach().amax(-1).contiguous(), (group,))
    terms = _xent_terms(z, m, labels, axis_index(group) * z.shape[-1])
    return _xent_of(tp_out(terms, group, algo), m, mask)


def softmax_xent_blocked(blocks, labels: torch.Tensor,
                         mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The control of :func:`softmax_xent_tp`: ``blocks`` are the
    vocabulary blocks' logits in order, each block's terms computed apart
    and summed by :func:`tree_sum`."""
    zs = [b.to(torch.float32) for b in blocks]
    m = zs[0].detach().amax(-1)
    for z in zs[1:]:
        m = torch.maximum(m, z.detach().amax(-1))
    vl = zs[0].shape[-1]
    terms = tree_sum([_xent_terms(z, m, labels, i * vl)
                      for i, z in enumerate(zs)])
    return _xent_of(terms, m, mask)
