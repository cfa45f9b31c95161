"""xLSTM blocks [arXiv:2405.04517] — counterpart of ``repro/models/xlstm.py``:
mLSTM (matrix memory, exponential gating) and sLSTM (scalar memory with
recurrent gate connections).

Both recurrences use the paper's max-stabilizer ``m`` (starting at -1e30)
for the exponential gates and run as exact sequential loops over time
(:func:`scan_utils.chunked_scan`); decode is the O(1) single-step update
on the carried state.  :func:`mlstm_chunkwise` is the chunkwise-parallel
mLSTM (``cfg.mlstm_parallel``).  No kernel of its own: the reference has
no Pallas kernel for these recurrences.

Kept from the reference: ``k`` is divided by sqrt(dh) rounded to the
compute dtype (bf16: 19.625 for dh = 384), as a tensor on k's device so
that the division is a true one; ``v`` is projected from the pre-conv
``xm``; log sigmoid(f) is -softplus(-f) with softplus = logaddexp(x, 0);
the sLSTM's FFN uses the tanh approximation of GELU (``jax.nn.gelu``).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamDesc, TensorSpec, norm_desc, rmsnorm
from repro_torch.models.scan_utils import chunked_scan
from repro_torch.models.ssm import softplus

MLSTM_PF = 2          # mLSTM up-projection factor
SLSTM_FF_PF = 4 / 3   # sLSTM post-block gated FFN factor
M_INIT = -1e30        # the stabilizer's start


def _heads(cfg: ModelConfig, d: int) -> Tuple[int, int]:
    H = cfg.num_heads
    return H, d // H


def _sqrt_dh(dh: int, like: torch.Tensor) -> torch.Tensor:
    """sqrt(dh) computed in ``like``'s dtype (``jnp.sqrt(jnp.asarray(dh,
    dtype))``) as a 0-dim tensor on its device: dividing by it is a true
    division on CUDA too, where a Python or CPU scalar divisor becomes a
    multiply by its reciprocal."""
    return torch.sqrt(torch.tensor(dh, dtype=like.dtype, device=like.device))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_desc(cfg: ModelConfig) -> Dict[str, ParamDesc]:
    d = cfg.d_model
    di = MLSTM_PF * d
    return {
        "norm": norm_desc(d),
        "up": ParamDesc((d, 2 * di), axes=("embed", "inner")),
        "conv_w": ParamDesc((cfg.ssm_conv, di), "small",
                            axes=(None, "inner")),
        "conv_b": ParamDesc((di,), "zeros", axes=("inner",)),
        "wq": ParamDesc((di, di), axes=("inner", "inner")),
        "wk": ParamDesc((di, di), axes=("inner", "inner")),
        "wv": ParamDesc((di, di), axes=("inner", "inner")),
        "w_if": ParamDesc((di, 2 * cfg.num_heads), "small",
                          axes=("inner", None)),
        "b_if": ParamDesc((2 * cfg.num_heads,), "zeros", axes=(None,)),
        "out_norm": norm_desc(di),
        "down": ParamDesc((di, d), axes=("inner", "embed")),
    }


def _mlstm_pre(params, cfg: ModelConfig, x: torch.Tensor):
    di = MLSTM_PF * cfg.d_model
    H, dh = _heads(cfg, di)
    u = rmsnorm(params["norm"], x, eps=cfg.norm_eps) @ params["up"]
    xm, z = torch.chunk(u, 2, dim=-1)
    return xm, z, H, dh


def _mlstm_gates(params, conv: torch.Tensor):
    """(log_i, log_f) in f32 from the conv features."""
    gates = (conv @ params["w_if"] + params["b_if"]).to(torch.float32)
    log_i, f_raw = torch.chunk(gates, 2, dim=-1)
    return log_i, -softplus(-f_raw)                       # log sigmoid(f)


def _mlstm_update(C, n, m, q, k, v, log_i, log_f):
    """One step of the stabilized mLSTM on f32 (B, H, ...) tensors.
    Returns (C, n, m, h)."""
    m_new = torch.maximum(log_f + m, log_i)
    i_p = torch.exp(log_i - m_new)
    f_p = torch.exp(log_f + m - m_new)
    C = C * f_p[..., None, None] + i_p[..., None, None] * (
        v[..., :, None] * k[..., None, :])
    n = n * f_p[..., None] + i_p[..., None] * k
    num = torch.einsum("bhvk,bhk->bhv", C, q)
    den = torch.clamp_min(torch.abs(torch.einsum("bhk,bhk->bh", n, q)), 1.0)
    return C, n, m_new, num / den[..., None]


def mlstm_forward(params, cfg: ModelConfig, x: torch.Tensor,
                  return_state: bool = False):
    """x: (B, T, d) -> (B, T, d) [, final state {"C", "n", "m", "conv"}]."""
    B, T, _ = x.shape
    f32 = torch.float32
    xm, z, H, dh = _mlstm_pre(params, cfg, x)
    K = params["conv_w"].shape[0]
    padded = F.pad(xm, (0, 0, K - 1, 0))
    conv = sum(padded[:, i:i + T, :] * params["conv_w"][i] for i in range(K))
    conv = F.silu(conv + params["conv_b"])

    q = (conv @ params["wq"]).reshape(B, T, H, dh)
    k = (conv @ params["wk"]).reshape(B, T, H, dh) / _sqrt_dh(dh, x)
    v = (xm @ params["wv"]).reshape(B, T, H, dh)
    log_i, log_f = _mlstm_gates(params, conv)             # (B, T, H)
    out_dtype = x.dtype

    def step(carry, inp):
        q_t, k_t, v_t, li_t, lf_t = inp
        C, n, m, h = _mlstm_update(*carry, q_t.to(f32), k_t.to(f32),
                                   v_t.to(f32), li_t, lf_t)
        return (C, n, m), h.to(out_dtype)

    dev = x.device
    init = (torch.zeros((B, H, dh, dh), dtype=f32, device=dev),
            torch.zeros((B, H, dh), dtype=f32, device=dev),
            torch.full((B, H), M_INIT, dtype=f32, device=dev))
    if cfg.mlstm_parallel and T % cfg.mlstm_chunk == 0:
        hs, final = mlstm_chunkwise(q, k, v, log_i, log_f, init,
                                    chunk=cfg.mlstm_chunk)
        h = hs.to(out_dtype).reshape(B, T, H * dh)
    else:
        # the q, k, v stacks stay in the compute dtype; the step upcasts
        # before touching the f32 matrix state
        xs = tuple(t.transpose(0, 1) for t in (q, k, v, log_i, log_f))
        final, hs = chunked_scan(step, init, xs, chunk=cfg.mlstm_chunk)
        h = hs.transpose(0, 1).reshape(B, T, H * dh)
    h = rmsnorm(params["out_norm"], h, eps=cfg.norm_eps)
    h = h * F.silu(z)
    out = h @ params["down"]
    if return_state:
        C, n, m = final
        tail = F.pad(xm, (0, 0, max(0, K - 1 - T), 0))[:, -(K - 1):, :]
        return out, {"C": C, "n": n, "m": m, "conv": tail}
    return out


def mlstm_chunkwise(q, k, v, log_i, log_f, init, chunk: int):
    """Chunkwise-parallel mLSTM recurrence (the xLSTM appendix / GLA form):
    per chunk of length c one (c, c) masked score product and one (c, dh)
    value product intra-chunk, plus the carried matrix state's inter-chunk
    contribution, with the exponential gates' stabilizer carried in ``m``.

    q, k, v: (B, T, H, dh) (k pre-scaled by 1/sqrt(dh)); log_i, log_f:
    (B, T, H) f32.  Returns (hs (B, T, H, dh) f32, final (C, n, m))."""
    B, T, H, dh = q.shape
    if T % chunk:
        raise ValueError(f"chunk {chunk} does not divide T={T}")
    nc, c = T // chunk, chunk
    f32 = torch.float32

    def resh(x):
        return x.reshape(B, nc, c, *x.shape[2:]).transpose(0, 1)
    qc, kc, vc = resh(q.to(f32)), resh(k.to(f32)), resh(v.to(f32))
    lic, lfc = resh(log_i), resh(log_f)                   # (nc, B, c, H)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    neg_inf = torch.tensor(-math.inf, dtype=f32, device=q.device)

    C_prev, n_prev, m_prev = init
    hs = []
    for j in range(nc):
        qt, kt, vt, li, lf = qc[j], kc[j], vc[j], lic[j], lfc[j]
        a = torch.cumsum(lf, dim=1)                       # (B, c, H)
        a_tot = a[:, -1]                                  # (B, H)
        # log-weight of source s seen from target t: a_t - a_s + li_s
        lw = a[:, :, None, :] - a[:, None, :, :] + li[:, None, :, :]
        lw = torch.where(tri[None, :, :, None], lw, neg_inf)   # (B,t,s,H)
        m_intra = torch.amax(lw, dim=2)                   # (B, c, H)
        m_t = torch.maximum(a + m_prev[:, None, :], m_intra)
        w = torch.exp(lw - m_t[:, :, None, :])
        e_inter = torch.exp(a + m_prev[:, None, :] - m_t)

        s_qk = torch.einsum("bthd,bshd->btsh", qt, kt)
        num = (e_inter[..., None] * torch.einsum("bhvk,bthk->bthv", C_prev,
                                                 qt)
               + torch.einsum("btsh,bshv->bthv", w * s_qk, vt))
        den = (e_inter * torch.einsum("bhk,bthk->bth", n_prev, qt)
               + torch.einsum("btsh,btsh->bth", w, s_qk))
        hs.append(num / torch.clamp_min(torch.abs(den), 1.0)[..., None])

        # chunk-end state
        lw_end = a_tot[:, None, :] - a + li               # (B, s, H)
        m_new = torch.maximum(a_tot + m_prev, torch.amax(lw_end, dim=1))
        decay = torch.exp(a_tot + m_prev - m_new)         # (B, H)
        src = torch.exp(lw_end - m_new[:, None, :])       # (B, s, H)
        C_prev = (decay[:, :, None, None] * C_prev
                  + torch.einsum("bsh,bshv,bshk->bhvk", src, vt, kt))
        n_prev = decay[..., None] * n_prev + torch.einsum("bsh,bshk->bhk",
                                                          src, kt)
        m_prev = m_new
    h = torch.stack(hs).transpose(0, 1).reshape(B, T, H, dh)
    return h, (C_prev, n_prev, m_prev)


def init_mlstm_state(cfg: ModelConfig, batch: int, dtype):
    di = MLSTM_PF * cfg.d_model
    H, dh = _heads(cfg, di)
    K = cfg.ssm_conv
    f32 = torch.float32
    return {"C": TensorSpec((batch, H, dh, dh), f32),
            "n": TensorSpec((batch, H, dh), f32),
            "m": TensorSpec((batch, H), f32),
            "conv": TensorSpec((batch, K - 1, di), dtype)}


def mlstm_decode(params, cfg: ModelConfig, x: torch.Tensor, state):
    """One-token step. x: (B, 1, d).  Returns (out (B, 1, d), new state);
    the input state is not modified."""
    B = x.shape[0]
    f32 = torch.float32
    xm, z, H, dh = _mlstm_pre(params, cfg, x)
    xm, z = xm[:, 0], z[:, 0]
    window = torch.cat([state["conv"], xm[:, None, :]], dim=1)
    conv = F.silu(torch.einsum("bkd,kd->bd", window, params["conv_w"])
                  + params["conv_b"])
    q = (conv @ params["wq"]).reshape(B, H, dh).to(f32)
    k = ((conv @ params["wk"]).reshape(B, H, dh) / _sqrt_dh(dh, x)).to(f32)
    v = (xm @ params["wv"]).reshape(B, H, dh).to(f32)
    log_i, log_f = _mlstm_gates(params, conv)
    C, n, m, h = _mlstm_update(state["C"], state["n"], state["m"], q, k, v,
                               log_i, log_f)
    h = h.reshape(B, H * dh).to(x.dtype)
    h = rmsnorm(params["out_norm"], h, eps=cfg.norm_eps) * F.silu(z)
    out = (h @ params["down"])[:, None, :]
    return out, {"C": C, "n": n, "m": m, "conv": window[:, 1:, :]}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_desc(cfg: ModelConfig) -> Dict[str, ParamDesc]:
    d = cfg.d_model
    H, dh = _heads(cfg, d)
    ff = int(round(SLSTM_FF_PF * d / 64) * 64)
    return {
        "norm": norm_desc(d),
        "w_in": ParamDesc((d, 4 * d),                  # i, f, z, o pre-acts
                          axes=("embed", "inner")),
        "r": ParamDesc((H, dh, 4 * dh), "small",       # block-diag recurrent
                       axes=(None, None, None)),
        "b": ParamDesc((4 * d,), "zeros", axes=(None,)),
        "out_norm": norm_desc(d),
        "up": ParamDesc((d, 2 * ff), axes=("embed", "ffn")),
        "down": ParamDesc((ff, d), axes=("ffn", "embed")),
    }


def _slstm_cell(params, cfg: ModelConfig, x_proj_t: torch.Tensor, carry):
    """One sLSTM time step.  x_proj_t: (B, 4d) pre-activations W x_t;
    carry: (c, n, m, h), each (B, H, dh) f32."""
    c, n, m, h = carry
    B = x_proj_t.shape[0]
    H, dh = _heads(cfg, cfg.d_model)
    f32 = torch.float32
    rec = torch.einsum("bhd,hdk->bhk", h, params["r"].to(f32))
    pre = (x_proj_t.reshape(B, H, 4 * dh).to(f32) + rec
           + params["b"].reshape(H, 4 * dh).to(f32))
    i_raw, f_raw, z_raw, o_raw = torch.chunk(pre, 4, dim=-1)
    log_i = i_raw
    log_f = -softplus(-f_raw)                   # sigmoid-form forget gate
    m_new = torch.maximum(log_f + m, log_i)
    i_p = torch.exp(log_i - m_new)
    f_p = torch.exp(log_f + m - m_new)
    z = torch.tanh(z_raw)
    o = torch.sigmoid(o_raw)
    c_new = f_p * c + i_p * z
    n_new = f_p * n + i_p
    h_new = o * c_new / torch.clamp_min(n_new, 1.0)
    return c_new, n_new, m_new, h_new


def _slstm_ffn(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(params["out_norm"], h, eps=cfg.norm_eps)
    gate, up = torch.chunk(h @ params["up"], 2, dim=-1)
    return (_gelu(gate) * up) @ params["down"]


def slstm_forward(params, cfg: ModelConfig, x: torch.Tensor,
                  return_state: bool = False):
    """x: (B, T, d) -> (B, T, d) [, final state {"c", "n", "m", "h"}]."""
    B, T, d = x.shape
    H, dh = _heads(cfg, d)
    f32 = torch.float32
    u = rmsnorm(params["norm"], x, eps=cfg.norm_eps)
    x_proj = u @ params["w_in"]                          # (B, T, 4d)
    out_dtype = x.dtype

    def step(carry, xp_t):
        new = _slstm_cell(params, cfg, xp_t, carry)
        return new, new[3].to(out_dtype)

    zeros = torch.zeros((B, H, dh), dtype=f32, device=x.device)
    init = (zeros, zeros, torch.full((B, H, dh), M_INIT, dtype=f32,
                                     device=x.device), zeros)
    final, hs = chunked_scan(step, init, x_proj.transpose(0, 1),
                             chunk=cfg.mlstm_chunk)
    out = _slstm_ffn(params, cfg, hs.transpose(0, 1).reshape(B, T, d))
    if return_state:
        c, n, m, hf = final
        return out, {"c": c, "n": n, "m": m, "h": hf}
    return out


def init_slstm_state(cfg: ModelConfig, batch: int, dtype):
    H, dh = _heads(cfg, cfg.d_model)
    s = TensorSpec((batch, H, dh), torch.float32)
    return {"c": s, "n": s, "m": s, "h": s}


def slstm_decode(params, cfg: ModelConfig, x: torch.Tensor, state):
    """One-token step. x: (B, 1, d).  Returns (out (B, 1, d), new
    state)."""
    B = x.shape[0]
    u = rmsnorm(params["norm"], x[:, 0], eps=cfg.norm_eps)
    carry = (state["c"], state["n"], state["m"], state["h"])
    c, n, m, h = _slstm_cell(params, cfg, u @ params["w_in"], carry)
    hv = h.reshape(B, cfg.d_model).to(x.dtype)
    out = _slstm_ffn(params, cfg, hv)[:, None, :]
    return out, {"c": c, "n": n, "m": m, "h": h}
