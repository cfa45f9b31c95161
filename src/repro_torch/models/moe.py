"""Mixture-of-Experts FFN of the port — counterpart of
``repro/models/moe.py``: top-k routing, shared experts, capacity-based
dispatch and the switch-style load-balance auxiliary loss.

Dispatch is the reference's sort-free capacity scheme: each token's k
choices get a slot in the chosen expert's capacity buffer from a
cumulative sum over the one-hot routing matrix, in token-major
``(token, choice)`` order; choices that overflow an expert's capacity
are dropped (they land in one extra row, which is cropped).  The three
expert einsums run on the ``(G, E, cap, d)`` buffer; the outputs are
gathered back, weighted and summed per token in choice order.

Expert parallelism (``ep_axis``, a process group): each rank holds its
``E/ep`` block of the experts (``convert.ep_slice``), routes its own
tokens over all E experts, and exchanges the capacity buffer with the
differentiable all-to-all (``collectives.all_to_all_grad``): dispatch
to the experts' owners, the local einsums, the reverse exchange to
combine.  Its backward is the same pair of exchanges in reverse.

Serving under the model axis (``tp_axis``, a process group): the
activations are the same on every rank, so each rank routes every token
with the whole router and runs only its block of ``E/tp`` whole experts
(``convert.serve_slice``); a choice of another rank's expert adds an
exact zero, and one all-reduce over the group sums the ranks' partial
outputs.  No all-to-all; capacity and drops are the unsharded layer's.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.collectives.api import all_to_all_grad
from repro_torch.core.collectives.p2p import axis_index, axis_size
from repro_torch.models.layers import ParamDesc, mlp, mlp_desc, tp_out


# ---------------------------------------------------------------------------
# Dropped-token tap
# ---------------------------------------------------------------------------
#
# Capacity dispatch drops the token-choices that overflow an expert's
# buffer; the tap counts them so that the loss does not hide it.  The
# dropped count is a running device tensor (no host sync per layer); the
# routed count is known from the shapes.  ``drain_drop_tap`` reads both
# with one sync, once per training step.  A checkpointed block's
# recomputation in the backward runs under ``drop_tap_paused`` and is not
# counted twice.

_DROP_TAP = {"enabled": False, "paused": False, "dropped": None,
             "routed": 0.0}


def enable_drop_tap(enable: bool = True) -> bool:
    """Turn the tap on or off; returns the previous state."""
    old = _DROP_TAP["enabled"]
    _DROP_TAP["enabled"] = bool(enable)
    return old


def drain_drop_tap() -> Tuple[float, float]:
    """``(dropped, routed)`` token-choice counts since the last drain, and
    reset (one host sync when anything was dropped on a device)."""
    d, r = _DROP_TAP["dropped"], _DROP_TAP["routed"]
    _DROP_TAP["dropped"], _DROP_TAP["routed"] = None, 0.0
    return (0.0 if d is None else float(d)), r


class drop_tap_paused:
    """Context in which ``moe_ffn`` leaves the tap alone (a block's
    recomputation under activation checkpointing)."""

    def __enter__(self):
        self._old = _DROP_TAP["paused"]
        _DROP_TAP["paused"] = True

    def __exit__(self, *exc):
        _DROP_TAP["paused"] = self._old


def _tap(keep: torch.Tensor) -> None:
    if not _DROP_TAP["enabled"] or _DROP_TAP["paused"]:
        return
    dropped = (~keep).sum()
    prev = _DROP_TAP["dropped"]
    _DROP_TAP["dropped"] = dropped if prev is None else prev + dropped
    _DROP_TAP["routed"] += float(keep.numel())


# ---------------------------------------------------------------------------
# Parameters and routing
# ---------------------------------------------------------------------------

def moe_desc(cfg: ModelConfig) -> Dict[str, ParamDesc]:
    d = cfg.d_model
    ff = cfg.moe_d_ff or cfg.d_ff
    E = cfg.num_experts
    desc = {
        "router": ParamDesc((d, E), "small", axes=("embed", None)),
        "wi_gate": ParamDesc((E, d, ff), axes=("experts", "embed", "ffn")),
        "wi_up": ParamDesc((E, d, ff), axes=("experts", "embed", "ffn")),
        "wo": ParamDesc((E, ff, d), axes=("experts", "ffn", "embed")),
    }
    if cfg.num_shared_experts:
        desc["shared"] = mlp_desc(d, ff * cfg.num_shared_experts)
    return desc


def _route(cfg: ModelConfig, logits: torch.Tensor):
    """logits (N, E) -> (weights (N, k) f32, experts (N, k), aux f32):
    softmax in f32, top-k, renormalized with a 1e-9 floor; aux is the
    switch loss E · Σ_e f_e · p_e over the first choice."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    weights, experts = torch.topk(probs, cfg.top_k, dim=-1)
    weights = weights / torch.clamp_min(weights.sum(-1, keepdim=True), 1e-9)
    E = logits.shape[-1]
    f = F.one_hot(experts[..., 0], E).to(torch.float32).mean(0)
    p = probs.mean(0)
    aux = E * torch.sum(f * p)
    return weights, experts, aux


def dispatch_plan(experts: torch.Tensor, E: int, G: int, cap: int):
    """Capacity slots of the flattened (token, choice) list, per group:
    experts (N, k) -> (dest (G, ng·k), keep (G, ng·k)).  ``dest`` is the
    row ``expert · cap + slot`` of a kept choice and ``E · cap`` of a
    dropped one."""
    eg = experts.reshape(G, -1)
    onehot = F.one_hot(eg, E)                                   # (G, n, E)
    slot = (torch.cumsum(onehot, dim=1) - 1) * onehot
    flat_slot = slot.sum(-1)
    keep = flat_slot < cap
    dest = torch.where(keep, eg * cap + flat_slot,
                       torch.full_like(eg, E * cap))
    return dest, keep


def moe_ffn(params, cfg: ModelConfig, x: torch.Tensor, *,
            groups: Optional[int] = None,
            ep_axis=None, a2a_variant: str = "direct", tp_axis=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, d) -> (out (B, T, d), aux f32).

    Capacity is per token group: ``cap = int(max(1, ng·k/E·capacity_
    factor))`` for ``ng = N / G`` tokens a group.  The reference makes one
    group per data shard (``num_batch_shards()``); in the port each
    data-parallel rank holds its local batch, which IS its shard, so the
    default is one group over the tokens given.  ``groups`` overrides it
    (G falls back to 1 when it does not divide the tokens).

    The scatter into the capacity buffer sends every dropped choice to
    row ``E·cap``, cropped before the experts run: the gradient of a
    scattered copy is the gather of the cotangent, which is zero there.
    A token's k weighted outputs are summed in choice order in the
    compute dtype (the reference's scatter-add order), not through
    ``index_add_``, whose atomics on CUDA sum in no fixed order.

    ``ep_axis`` (a process group of ep ranks) runs expert parallelism:
    ``params`` hold this rank's block of ``E/ep`` experts (the router
    replicated; routing stays over all E), chunk s of the capacity buffer
    goes to ep rank s (``a2a_variant``: ``direct`` or ``ring``), the local
    experts run, and the reverse exchange returns every output to its
    token's rank in global expert order.  Chunks move verbatim, so the
    step equals the same math on one device with the ep ranks' tokens as
    ``groups``.  The drop tap counts this rank's drops.

    ``tp_axis`` (a process group, serving) runs this rank's block of
    ``E/tp`` experts on every token's choices and sums the ranks' outputs
    with one all-reduce (``params``: the rank's expert block, its slice
    of the shared experts' ffn dim)."""
    B, T, d = x.shape
    N = B * T
    E, k = cfg.num_experts, cfg.top_k
    cdt = x.dtype
    G = groups if groups is not None else 1
    if N % G:
        G = 1
    ng = N // G
    cap = int(max(1, ng * k / E * cfg.capacity_factor))
    ep = 1
    if ep_axis is not None:
        ep = axis_size(ep_axis)
        if G != 1:
            raise ValueError(f"ep_axis={ep_axis!r} wants one token group "
                             f"per rank, got G={G} (the rank IS the group)")
        if E % ep:
            raise ValueError(f"num_experts={E} not divisible by "
                             f"ep={ep} ({ep_axis!r})")
        if params["wi_gate"].shape[0] != E // ep:
            raise ValueError(
                f"expert-parallel moe_ffn wants the LOCAL expert block "
                f"({E // ep} of {E}), got params with "
                f"{params['wi_gate'].shape[0]} experts")
    e0 = _expert_block(params, E, tp_axis)

    xf = x.reshape(N, d)
    weights, experts, aux = _route(cfg, xf @ params["router"])
    dest, keep = dispatch_plan(experts, E, G, cap)
    _tap(keep)

    # each token's row repeated k times, in (token, choice) order
    src = xf.reshape(G, ng, 1, d).expand(G, ng, k, d).reshape(G, ng * k, d)
    buf = torch.zeros((G, E * cap + 1, d), dtype=cdt, device=x.device)
    buf = buf.scatter(1, dest[..., None].expand(G, ng * k, d), src)
    buf = buf[:, :E * cap].reshape(G, E, cap, d)

    if ep_axis is not None:
        El = E // ep
        # dispatch: chunk s of the capacity buffer is the payload for ep
        # rank s (its expert block; global expert order is rank-major)
        b = all_to_all_grad(buf.reshape(ep, El * cap, d), ep_axis,
                            a2a_variant)
        b = b.reshape(ep, El, cap, d)        # row s: source rank s's tokens
        h_gate = F.silu(torch.einsum("secd,edf->secf", b,
                                     params["wi_gate"]))
        h_up = torch.einsum("secd,edf->secf", b, params["wi_up"])
        h_mid = (h_gate * h_up).to(cdt)
        out_b = torch.einsum("secf,efd->secd", h_mid, params["wo"])
        # combine: the reverse exchange returns each output to its token's
        # rank, the (E, cap, d) buffer in global order again
        out_flat = all_to_all_grad(out_b.reshape(ep, El * cap, d), ep_axis,
                                   a2a_variant).reshape(G, E * cap, d)
    elif tp_axis is not None:
        El = params["wi_gate"].shape[0]
        b = buf[:, e0:e0 + El]
        h_gate = F.silu(torch.einsum("gecd,edf->gecf", b,
                                     params["wi_gate"]))
        h_up = torch.einsum("gecd,edf->gecf", b, params["wi_up"])
        h_mid = (h_gate * h_up).to(cdt)
        out_b = torch.einsum("gecf,efd->gecd", h_mid, params["wo"])
        # the other ranks' experts' rows are zeros here
        out_buf = torch.zeros((G, E, cap, d), dtype=out_b.dtype,
                              device=x.device)
        out_buf[:, e0:e0 + El] = out_b
        out_flat = out_buf.reshape(G, E * cap, d)
    else:
        h_gate = F.silu(torch.einsum("gecd,edf->gecf", buf,
                                     params["wi_gate"]))
        h_up = torch.einsum("gecd,edf->gecf", buf, params["wi_up"])
        h_mid = (h_gate * h_up).to(cdt)
        out_buf = torch.einsum("gecf,efd->gecd", h_mid, params["wo"])
        out_flat = out_buf.reshape(G, E * cap, d)

    idx = torch.clamp_max(dest, E * cap - 1)
    gathered = torch.gather(out_flat, 1, idx[..., None].expand(G, ng * k, d))
    gathered = torch.where(keep[..., None], gathered,
                           torch.zeros((), dtype=gathered.dtype,
                                       device=x.device))
    wg = weights.reshape(G, ng * k)
    contrib = (gathered * wg[..., None].to(gathered.dtype)).reshape(
        G, ng, k, d)
    out = contrib[:, :, 0]
    for j in range(1, k):
        out = out + contrib[:, :, j]
    out = out.to(cdt).reshape(N, d)

    if cfg.num_shared_experts:
        out = out + mlp(params["shared"], xf, cfg.activation)
    if tp_axis is not None:
        out = tp_out(out, tp_axis)
    return out.reshape(B, T, d), aux


def _expert_block(params, E: int, tp_axis) -> int:
    """The first expert of this rank's block under ``tp_axis`` (0 without
    one); raises unless ``params`` hold the block of ``E/tp``."""
    if tp_axis is None:
        return 0
    tp = axis_size(tp_axis)
    if E % tp or params["wi_gate"].shape[0] != E // tp:
        raise ValueError(f"serving over tp={tp} wants blocks of {E}/{tp} "
                         f"experts, got params with "
                         f"{params['wi_gate'].shape[0]}")
    return axis_index(tp_axis) * (E // tp)


def moe_decode_ffn(params, cfg: ModelConfig, x: torch.Tensor,
                   tp_axis=None) -> torch.Tensor:
    """One token a row, x (B, 1, d): gather the k chosen experts' weights
    per token instead of capacity dispatch — no drops; the gather is
    (B, k, d, ff) a matrix, cheap at decode batch sizes.  Under
    ``tp_axis`` (serving) a rank gathers from its block of the experts, a
    choice outside it adds an exact zero, and one all-reduce sums the
    ranks."""
    B, _, d = x.shape
    xf = x.reshape(B, d)
    weights, experts, _ = _route(cfg, xf @ params["router"])      # (B, k)
    idx = experts
    if tp_axis is not None:
        El = params["wi_gate"].shape[0]
        local = experts - _expert_block(params, cfg.num_experts, tp_axis)
        mine = (local >= 0) & (local < El)
        idx = torch.clamp(local, 0, El - 1)
    wg = params["wi_gate"][idx]                                   # (B,k,d,ff)
    wu = params["wi_up"][idx]
    wo = params["wo"][idx]                                        # (B,k,ff,d)
    h = F.silu(torch.einsum("bd,bkdf->bkf", xf, wg)) * torch.einsum(
        "bd,bkdf->bkf", xf, wu)
    out = torch.einsum("bkf,bkfd->bkd", h, wo)
    if tp_axis is not None:
        out = torch.where(mine[..., None], out,
                          torch.zeros((), dtype=out.dtype, device=x.device))
    out = torch.einsum("bkd,bk->bd", out, weights.to(out.dtype))
    if cfg.num_shared_experts:
        out = out + mlp(params["shared"], xf, cfg.activation)
    if tp_axis is not None:
        out = tp_out(out, tp_axis)
    return out.reshape(B, 1, d)
