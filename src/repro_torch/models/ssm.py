"""Mamba (selective SSM) block of the Jamba hybrid — counterpart of
``repro/models/ssm.py``.

Training and prefill run the selective scan as a sequential loop over time
(:func:`scan_utils.chunked_scan`); decode is the O(1) single-step state
update.  The recurrent state (B, d_inner, d_state) f32 and the conv tail
(B, K - 1, d_inner) are the layer's "cache" (per-slot state in the paged
serving pool, never paged).  No kernel of its own: the reference has no
Pallas kernel for the scan either (ROADMAP.md, queue 2, the
recurrent-scan kernel).

The reference's rounding is kept: the prefill step upcasts x, dt, B and
C to f32 and casts each y to the compute dtype before it is stacked; the
decode multiplies dt·B·x in the compute dtype and casts to f32 only
afterwards.

Under ``sharding_ctx.serve_region`` a model-axis rank runs its block of
``d_inner`` (the reference's serve rules put ``inner`` on the model
axis; ``convert.serve_slice`` cuts ``in_proj``'s x and z each by it):
the conv, ``dt_proj``, ``A_log``, ``D`` and the scan are per channel and
run on the rank's channels; ``x_proj`` holds the rank's input rows, so
(dt, B, C) is a partial sum and one all-reduce over the tp group makes
it whole; ``out_proj`` holds its rows and one all-reduce sums the layer's
output.  Both sums run in f32 and round once (``layers.psum_f32``): the
recurrence amplifies every extra rounding of a sum of bf16 partials.
Under ``sharding_ctx.train_region`` the training forward runs the same
split with differentiable sums (:func:`_mamba_train`).
The state ``h`` and the conv tail hold the rank's channels, as the
reference's ``cache_spec`` splits them (their widest dim, d_inner, over
the model axis).  At batch 1 with d_inner >= 4096 that spec splits
``h``'s channels over the data axes too (data index major): then the
decode all-gathers the step's dA and dB·x over tp, updates the rank's
block of ``h`` and all-gathers the block's y over the data axes and tp.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (ParamDesc, TensorSpec, gather_cat,
                                       psum_f32, train_lanes)
from repro_torch.models.scan_utils import chunked_scan
from repro_torch.models.sharding_ctx import leaf_share, serve_axes


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) at every x.  (``F.softplus``
    returns x itself above its threshold, 20 by default, and its log1p(exp)
    overflows without one.)"""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba_desc(cfg: ModelConfig) -> Dict[str, ParamDesc]:
    d, di, ds, dt = cfg.d_model, cfg.d_inner, cfg.ssm_d_state, cfg.dt_rank
    return {
        # [x | z]: each cut by its own inner block
        "in_proj": ParamDesc((d, 2 * di), axes=("embed", "inner"), parts=2),
        "conv_w": ParamDesc((cfg.ssm_conv, di), "small",
                            axes=(None, "inner")),
        "conv_b": ParamDesc((di,), "zeros", axes=("inner",)),
        "x_proj": ParamDesc((di, dt + 2 * ds), axes=("inner", None)),
        "dt_proj_w": ParamDesc((dt, di), "small", axes=(None, "inner")),
        "dt_proj_b": ParamDesc((di,), "ones", axes=("inner",)),
        "A_log": ParamDesc((di, ds), "small", axes=("inner", "state")),
        "D": ParamDesc((di,), "ones", axes=("inner",)),
        "out_proj": ParamDesc((di, d), axes=("inner", "embed")),
    }


def _conv1d_causal(params, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time. x: (B, T, di)."""
    K = params["conv_w"].shape[0]
    T = x.shape[1]
    pads = F.pad(x, (0, 0, K - 1, 0))
    out = sum(pads[:, i:i + T, :] * params["conv_w"][i] for i in range(K))
    return out + params["conv_b"]


def _sel_params(params, cfg: ModelConfig, x: torch.Tensor, group=None):
    """x: (..., di) -> (dt (..., di), B (..., ds), C (..., ds)); under
    ``group`` (a tp process group) x holds the rank's channels and
    ``x_proj`` its rows, and the partial projection is all-reduced."""
    if group is None:
        proj = x @ params["x_proj"]
    else:
        proj = psum_f32(_x_proj_part(params, x), group, x.dtype)
    return _sel_split(params, cfg, proj)


def _x_proj_part(params, x: torch.Tensor) -> torch.Tensor:
    """The f32 partial projection of the rank's channels ``x``."""
    return x.to(torch.float32) @ params["x_proj"].to(torch.float32)


def _sel_split(params, cfg: ModelConfig, proj: torch.Tensor):
    """(dt, B, C) from the whole projection (dt_rank + 2 d_state)."""
    ds, dtr = cfg.ssm_d_state, cfg.dt_rank
    dt_in, Bc, Cc = torch.split(proj, [dtr, ds, ds], dim=-1)
    dt = softplus(dt_in @ params["dt_proj_w"] + params["dt_proj_b"])
    return dt, Bc, Cc


def _mamba_in(params, x: torch.Tensor):
    """(the pre-conv x, the conv's features, z) of the channels that
    ``params`` hold."""
    xin_raw, z = torch.chunk(x @ params["in_proj"], 2, dim=-1)
    return xin_raw, F.silu(_conv1d_causal(params, xin_raw)), z


def _mamba_scan(params, cfg: ModelConfig, xin, z, dt, Bc, Cc, out_dtype):
    """The selective scan of ``xin``'s channels: (the gated output y
    before ``out_proj``, the final state h)."""
    B, T, di = xin.shape
    f32 = torch.float32
    A = -torch.exp(params["A_log"].to(f32))                # (di, ds)

    def step(h, inp):
        x_t, dt_t, B_t, C_t = (t.to(f32) for t in inp)
        dA = torch.exp(dt_t[..., None] * A)                 # (B, di, ds)
        dBx = dt_t[..., None] * B_t[:, None, :] * x_t[..., None]
        h = h * dA + dBx
        y = torch.einsum("bds,bs->bd", h, C_t)
        return h, y.to(out_dtype)          # the stacked ys stay small

    h0 = torch.zeros((B, di, cfg.ssm_d_state), dtype=f32, device=xin.device)
    # the stacks stay in the compute dtype; the step upcasts
    xs = tuple(t.transpose(0, 1) for t in (xin, dt, Bc, Cc))
    h_final, ys = chunked_scan(step, h0, xs, chunk=128)
    y = ys.transpose(0, 1).to(out_dtype)
    y = y + xin * params["D"]
    return y * F.silu(z), h_final


def mamba_forward(params, cfg: ModelConfig, x: torch.Tensor,
                  return_state: bool = False):
    """x: (B, T, d) -> (B, T, d) [, final state {"h", "conv"}].  Under
    ``sharding_ctx.train_region`` (or its control, ``blocked_region``)
    :func:`_mamba_train`."""
    if not return_state:
        lanes = train_lanes(range)
        if lanes is not None:
            return _mamba_train(params, cfg, x, lanes)
    B, T, _ = x.shape
    sa = serve_axes()
    group = None if sa is None else sa.tp
    xin_raw, xin, z = _mamba_in(params, x)
    dt, Bc, Cc = _sel_params(params, cfg, xin, group)
    y, h_final = _mamba_scan(params, cfg, xin, z, dt, Bc, Cc, x.dtype)
    out = _out_proj(params, y, group)
    if return_state:
        K = cfg.ssm_conv
        # left-padded when the prompt is shorter than the conv's tail
        tail = F.pad(xin_raw, (0, 0, max(0, K - 1 - T), 0))[:, -(K - 1):, :]
        if sa is not None:
            share = _h_share(cfg, B, sa)
            if share.data:
                # the block the reference's spec gives this rank
                whole = gather_cat(h_final, (sa.tp,), 1)
                n = cfg.d_inner // share.parts
                h_final = whole[:, share.index * n:(share.index + 1) * n]
        return out, {"h": h_final.contiguous(), "conv": tail}
    return out


def _mamba_train(params, cfg: ModelConfig, x: torch.Tensor, lanes):
    """The train layout's Mamba (``lanes``: ``layers.Lanes``, a rank or
    the control): ``x`` (after ``norm1``) through ``tp_in``; ``in_proj``'s
    x and z parts, the conv, ``dt_proj``, ``A_log``, ``D`` and the scan
    on the rank's ``inner`` channels; ``x_proj``'s f32 partial summed by
    ``layers.sum_f32`` (dt, B and C feed every rank's channels, so the
    backward sums their cotangent too); ``out_proj``'s f32 partial summed
    by ``tp_out`` in f32 and rounded once.  Every collective lies outside
    the scan's checkpointed steps."""
    ps = lanes.share(params, cfg, mamba_desc(cfg))
    ins = [_mamba_in(p, xb) for p, xb in zip(ps, lanes.enter(x))]
    projs = lanes.sum_f32([_x_proj_part(p, xin) for p, (_, xin, _)
                           in zip(ps, ins)], x.dtype)
    parts = []
    for p, (_, xin, z), proj in zip(ps, ins, projs):
        dt, Bc, Cc = _sel_split(p, cfg, proj)
        y, _ = _mamba_scan(p, cfg, xin, z, dt, Bc, Cc, x.dtype)
        parts.append(y.to(torch.float32) @ p["out_proj"].to(torch.float32))
    return lanes.out_f32(parts, x.dtype)


def _out_proj(params, y: torch.Tensor, group) -> torch.Tensor:
    """y @ out_proj; under ``group`` the rank's rows' f32 partial summed
    over the tp ranks and rounded once."""
    if group is None:
        return y @ params["out_proj"]
    return psum_f32(y.to(torch.float32) @ params["out_proj"].to(torch.float32),
                    group, y.dtype)


def _h_share(cfg: ModelConfig, batch: int, sa):
    """The rank's share of the state ``h`` and a check that the conv
    tail's is the rank's channels; raises for a layout the rank's
    channels cannot run (a state the reference keeps whole)."""
    di, ds, K = cfg.d_inner, cfg.ssm_d_state, cfg.ssm_conv
    share = leaf_share("h", (batch, di, ds), sa)
    conv = leaf_share("conv", (batch, K - 1, di), sa)
    if share is None or share.dim != 1 or conv is None or conv.dim != 2 \
            or conv.data:
        raise ValueError(f"{cfg.name}: Mamba's state over tp runs with "
                         f"d_inner={di} split over the model axis; the "
                         f"reference's cache_spec gives h {share}, conv "
                         f"{conv}")
    return share


def init_mamba_state(cfg: ModelConfig, batch: int, dtype):
    di, ds, K = cfg.d_inner, cfg.ssm_d_state, cfg.ssm_conv
    return {"h": TensorSpec((batch, di, ds), torch.float32),
            "conv": TensorSpec((batch, K - 1, di), dtype)}


def mamba_decode(params, cfg: ModelConfig, x: torch.Tensor,
                 state) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step. x: (B, 1, d); state: {"h", "conv"}.  Returns (out
    (B, 1, d), new state); the input state is not modified."""
    f32 = torch.float32
    sa = serve_axes()
    group = None if sa is None else sa.tp
    xin, z = torch.chunk(x[:, 0] @ params["in_proj"], 2, dim=-1)
    window = torch.cat([state["conv"], xin[:, None, :]], dim=1)  # (B, K, di)
    conv = torch.einsum("bkd,kd->bd", window, params["conv_w"]) \
        + params["conv_b"]
    xin_c = F.silu(conv)
    dt, Bc, Cc = _sel_params(params, cfg, xin_c, group)
    A = -torch.exp(params["A_log"].to(f32))
    dA = torch.exp(dt[..., None].to(f32) * A)
    # multiplied in the compute dtype, cast afterwards (the reference's
    # rounding)
    dBx = (dt[..., None] * Bc[:, None, :] * xin_c[..., None]).to(f32)
    share = None if sa is None else _h_share(cfg, x.shape[0], sa)
    if share is not None and share.data:
        # h holds block ``index`` of d_inner's (data x model) blocks: its
        # channels' dA and dB·x from the tp ranks, and y of every block
        n = cfg.d_inner // share.parts
        lo = share.index * n
        upd = gather_cat(torch.stack([dA, dBx]), (sa.tp,), 2)
        h = state["h"] * upd[0, :, lo:lo + n] + upd[1, :, lo:lo + n]
        y_blk = torch.einsum("bds,bs->bd", h, Cc.to(f32)).to(x.dtype)
        y = gather_cat(y_blk, sa.data + (sa.tp,), 1)
        from repro_torch.core.collectives.p2p import axis_index
        di = xin_c.shape[-1]
        rank = axis_index(sa.tp)
        y = y[:, rank * di:(rank + 1) * di]
    else:
        h = state["h"] * dA + dBx
        y = torch.einsum("bds,bs->bd", h, Cc.to(f32)).to(x.dtype)
    y = y + xin_c * params["D"]
    y = y * F.silu(z)
    out = _out_proj(params, y, group)[:, None, :]
    return out, {"h": h, "conv": window[:, 1:, :]}
