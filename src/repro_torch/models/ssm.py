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
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamDesc, TensorSpec
from repro_torch.models.scan_utils import chunked_scan


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) at every x.  (``F.softplus``
    returns x itself above its threshold, 20 by default, and its log1p(exp)
    overflows without one.)"""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba_desc(cfg: ModelConfig) -> Dict[str, ParamDesc]:
    d, di, ds, dt = cfg.d_model, cfg.d_inner, cfg.ssm_d_state, cfg.dt_rank
    return {
        "in_proj": ParamDesc((d, 2 * di)),
        "conv_w": ParamDesc((cfg.ssm_conv, di), "small"),
        "conv_b": ParamDesc((di,), "zeros"),
        "x_proj": ParamDesc((di, dt + 2 * ds)),
        "dt_proj_w": ParamDesc((dt, di), "small"),
        "dt_proj_b": ParamDesc((di,), "ones"),
        "A_log": ParamDesc((di, ds), "small"),
        "D": ParamDesc((di,), "ones"),
        "out_proj": ParamDesc((di, d)),
    }


def _conv1d_causal(params, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time. x: (B, T, di)."""
    K = params["conv_w"].shape[0]
    T = x.shape[1]
    pads = F.pad(x, (0, 0, K - 1, 0))
    out = sum(pads[:, i:i + T, :] * params["conv_w"][i] for i in range(K))
    return out + params["conv_b"]


def _sel_params(params, cfg: ModelConfig, x: torch.Tensor):
    """x: (..., di) -> (dt (..., di), B (..., ds), C (..., ds))."""
    ds, dtr = cfg.ssm_d_state, cfg.dt_rank
    proj = x @ params["x_proj"]
    dt_in, Bc, Cc = torch.split(proj, [dtr, ds, ds], dim=-1)
    dt = softplus(dt_in @ params["dt_proj_w"] + params["dt_proj_b"])
    return dt, Bc, Cc


def mamba_forward(params, cfg: ModelConfig, x: torch.Tensor,
                  return_state: bool = False):
    """x: (B, T, d) -> (B, T, d) [, final state {"h", "conv"}]."""
    B, T, _ = x.shape
    di, ds = cfg.d_inner, cfg.ssm_d_state
    f32 = torch.float32
    xin_raw, z = torch.chunk(x @ params["in_proj"], 2, dim=-1)
    xin = F.silu(_conv1d_causal(params, xin_raw))
    dt, Bc, Cc = _sel_params(params, cfg, xin)
    A = -torch.exp(params["A_log"].to(f32))                # (di, ds)
    out_dtype = x.dtype

    def step(h, inp):
        x_t, dt_t, B_t, C_t = (t.to(f32) for t in inp)
        dA = torch.exp(dt_t[..., None] * A)                 # (B, di, ds)
        dBx = dt_t[..., None] * B_t[:, None, :] * x_t[..., None]
        h = h * dA + dBx
        y = torch.einsum("bds,bs->bd", h, C_t)
        return h, y.to(out_dtype)          # the stacked ys stay small

    h0 = torch.zeros((B, di, ds), dtype=f32, device=x.device)
    # the stacks stay in the compute dtype; the step upcasts
    xs = tuple(t.transpose(0, 1) for t in (xin, dt, Bc, Cc))
    h_final, ys = chunked_scan(step, h0, xs, chunk=128)
    y = ys.transpose(0, 1).to(x.dtype)
    y = y + xin * params["D"]
    y = y * F.silu(z)
    out = y @ params["out_proj"]
    if return_state:
        K = cfg.ssm_conv
        # left-padded when the prompt is shorter than the conv's tail
        tail = F.pad(xin_raw, (0, 0, max(0, K - 1 - T), 0))[:, -(K - 1):, :]
        return out, {"h": h_final, "conv": tail}
    return out


def init_mamba_state(cfg: ModelConfig, batch: int, dtype):
    di, ds, K = cfg.d_inner, cfg.ssm_d_state, cfg.ssm_conv
    return {"h": TensorSpec((batch, di, ds), torch.float32),
            "conv": TensorSpec((batch, K - 1, di), dtype)}


def mamba_decode(params, cfg: ModelConfig, x: torch.Tensor,
                 state) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step. x: (B, 1, d); state: {"h", "conv"}.  Returns (out
    (B, 1, d), new state); the input state is not modified."""
    f32 = torch.float32
    xin, z = torch.chunk(x[:, 0] @ params["in_proj"], 2, dim=-1)
    window = torch.cat([state["conv"], xin[:, None, :]], dim=1)  # (B, K, di)
    conv = torch.einsum("bkd,kd->bd", window, params["conv_w"]) \
        + params["conv_b"]
    xin_c = F.silu(conv)
    dt, Bc, Cc = _sel_params(params, cfg, xin_c)
    A = -torch.exp(params["A_log"].to(f32))
    dA = torch.exp(dt[..., None].to(f32) * A)
    # multiplied in the compute dtype, cast afterwards (the reference's
    # rounding)
    dBx = (dt[..., None] * Bc[:, None, :] * xin_c[..., None]).to(f32)
    h = state["h"] * dA + dBx
    y = torch.einsum("bds,bs->bd", h, Cc.to(f32)).to(x.dtype)
    y = y + xin_c * params["D"]
    y = y * F.silu(z)
    out = (y @ params["out_proj"])[:, None, :]
    return out, {"h": h, "conv": window[:, 1:, :]}
