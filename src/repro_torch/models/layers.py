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
serving under ``sharding_ctx.serve_region``.
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
    sqrt(fan_in); ``small``: N(0,1) * 0.02; ``zeros``; ``ones``) and the
    reference's logical axis name per dim (None: replicated)."""
    shape: Tuple[int, ...]
    init: str = "normal"
    scale: Optional[float] = None     # overrides the default fan-in scale
    axes: Optional[Tuple[Optional[str], ...]] = None

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
                                        ("layers",) + (d.axes or (None,) * len(d.shape))),
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
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.core.collectives.api import allreduce
        return allreduce(g.contiguous().clone(), "psum", (ctx.group,)), None


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


def tp_in(x: torch.Tensor, group) -> torch.Tensor:
    """Wrap the activations entering a column-parallel block: identity
    forward; the backward sums the partial input cotangents that each
    rank's weight slice produced over ``group`` (a process group)."""
    return _TpIn.apply(x, group)


def tp_out(x: torch.Tensor, group, algo: str = "psum") -> torch.Tensor:
    """All-reduce a row-parallel partial output over ``group`` with
    ``collectives.api.allreduce(x, algo, (group,))``; identity backward
    (the output cotangent is already whole on every rank)."""
    return _TpOut.apply(x, group, algo)


def mlp_tp(params, x: torch.Tensor, activation: str = "swiglu", *, group,
           algo: str = "psum") -> torch.Tensor:
    """Tensor-parallel gated MLP: ``params`` hold this rank's 1/tp slice of
    the ffn dim (wi_gate / wi_up cut on their output features, wo on its
    input features; ``convert.tp_slice``).  Bit-equal at tp = 2 to
    :func:`mlp_blocked` with 2 blocks (float addition is commutative)."""
    act = _activation(activation)
    xin = tp_in(x, group)
    gate = act(xin @ params["wi_gate"])
    up = xin @ params["wi_up"]
    return tp_out((gate * up) @ params["wo"], group, algo)


class _Block(torch.autograd.Function):
    """Identity in both directions, as a node of its own: the cotangents of
    a block's uses of ``x`` are summed in this node before they reach
    ``x``."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g


def mlp_blocked(params, x: torch.Tensor, activation: str = "swiglu",
                blocks: int = 2) -> torch.Tensor:
    """The tensor-parallel checks' reference: the contraction of
    :func:`mlp` in ``blocks`` ffn slices, summed in order: the arithmetic
    of a tp group, on one device.  Each block reads ``x`` through a node
    of its own (the reference's optimization barrier), so that the block's
    two input-cotangent contributions are summed before the blocks are,
    as a tp rank sums its two before the all-reduce across ranks; and the
    blocks read it through one more node, ``tp_in``'s place, so that their
    sum is whole before it meets another use of ``x`` by the caller (a
    residual).  Left to itself autograd would fold every contribution into
    ``x`` in its own order."""
    act = _activation(activation)
    x = _Block.apply(x)
    d_ff = params["wi_gate"].shape[-1]
    if d_ff % blocks:
        raise ValueError(f"d_ff={d_ff} does not split into {blocks} blocks")
    # each slice contiguous, as a tp rank holds it (the matmul of a strided
    # operand may take another kernel)
    gates = [w.contiguous() for w in torch.chunk(params["wi_gate"], blocks,
                                                 dim=-1)]
    ups = [w.contiguous() for w in torch.chunk(params["wi_up"], blocks,
                                               dim=-1)]
    wos = torch.chunk(params["wo"], blocks, dim=-2)
    out = None
    for wg, wu, wo in zip(gates, ups, wos):
        xb = _Block.apply(x)
        part = (act(xb @ wg) * (xb @ wu)) @ wo
        out = part if out is None else out + part
    return out


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
             group) -> torch.Tensor:
    """Vocab-parallel :func:`embed`: ``params["table"]`` holds this rank's
    block of the vocabulary rows (block ``axis_index(group)``); a token
    outside it gives exact zeros, and one all-reduce over ``group`` sums
    the ranks' rows, at most one of them non-zero, so the result equals
    :func:`embed` of the whole table bit for bit."""
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


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy in f32.  labels: int ids; mask optional."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
