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

Under ``sharding_ctx.serve_region`` a model-axis rank holds its block of
``inner`` (the reference's serve rules) and the reference's cache split:

  * mLSTM: ``up`` (xm and z each), the conv and the conv tail on the
    rank's channels; ``wq`` / ``wk`` / ``wv`` / ``w_if`` on their input
    rows (``("inner", "inner")`` puts the first dim on the model axis),
    so q, k, v and the gates are partial sums, made whole by one
    all-reduce of the four stacked.  ``C`` holds the rank's rows of
    ``dh_v`` (its widest dim's first), ``n`` and ``m`` are whole: the
    rank updates its rows of C and the whole n, and computes its rows of
    every head's h.  Those rows are not the rank's contiguous block of
    d_inner that ``z`` and ``down`` use, and ``out_norm`` takes its RMS
    over the whole d_inner, so one all-gather of h regroups it; ``down``
    holds its rows and one all-reduce sums the output.
  * sLSTM: ``w_in`` holds the rank's block of dh of every head's every
    gate (the cache splits h on dh), so x_proj is all-gathered (at decode
    together with the rank's block of h: one all-gather), the cell runs
    whole on every rank (``r``, ``b``, c, n and m are whole) and the rank
    keeps its block of h; the FFN runs on its ffn slice (``up``'s gate
    and up each cut by it, ``down`` by rows) with one all-reduce.

The all-reduces sum f32 partials and round once (``layers.psum_f32``):
the recurrences amplify every extra rounding of a sum of bf16 partials.
Under ``sharding_ctx.train_region`` the training forward runs the same
splits with differentiable sums and gathers (:func:`_mlstm_train`,
:func:`_slstm_train`; C by the rank's block of ``dh_v`` rows).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (ParamDesc, TensorSpec, gather_cat,
                                       norm_desc, psum_f32, rmsnorm,
                                       train_lanes)
from repro_torch.models.scan_utils import chunked_scan
from repro_torch.models.sharding_ctx import leaf_share, serve_axes
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
        "up": ParamDesc((d, 2 * di), axes=("embed", "inner"),
                        parts=2),                      # [xm | z]
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


def _mlstm_gates(params, conv: torch.Tensor, pre=None):
    """(log_i, log_f) in f32 from the conv features (``pre``: their
    projection ``conv @ w_if``, when already made)."""
    pre = conv @ params["w_if"] if pre is None else pre
    gates = (pre + params["b_if"]).to(torch.float32)
    log_i, f_raw = torch.chunk(gates, 2, dim=-1)
    return log_i, -softplus(-f_raw)                       # log sigmoid(f)


def _mlstm_proj(params, conv, xm, group):
    """(q, k, v, conv @ w_if) unscaled; under ``group`` the rank's input
    rows' f32 partial sums, stacked, all-reduced once and rounded once."""
    if group is None:
        return [conv @ params["wq"], conv @ params["wk"], xm @ params["wv"],
                conv @ params["w_if"]]
    sizes = [params[w].shape[-1] for w in ("wq", "wk", "wv", "w_if")]
    whole = psum_f32(_mlstm_proj_parts(params, conv, xm), group, conv.dtype)
    return list(torch.split(whole, sizes, dim=-1))


def _mlstm_rows(cfg: ModelConfig, batch: int, sa):
    """(first row, rows) of ``dh_v`` that the rank's ``C`` holds (all of
    it outside the serve region); raises where the reference's spec
    splits C on another dim."""
    H, dh = _heads(cfg, MLSTM_PF * cfg.d_model)
    if sa is None:
        return 0, dh
    share = leaf_share("C", (batch, H, dh, dh), sa)
    conv = leaf_share("conv", (batch, cfg.ssm_conv - 1, MLSTM_PF * cfg.d_model),
                      sa)
    if share is None or share.dim != 2 or share.data or conv is None \
            or conv.dim != 2 or conv.data:
        raise ValueError(f"{cfg.name}: the mLSTM over tp runs with C split "
                         f"on dh_v and the conv tail on d_inner; the "
                         f"reference's cache_spec gives C {share}, conv "
                         f"{conv}")
    n = dh // share.parts
    return share.index * n, n


def _mlstm_out(params, cfg: ModelConfig, h, z, sa):
    """out_norm(h) * silu(z) @ down; under the region ``h`` (..., H, rows)
    holds the rank's rows of every head and is all-gathered whole, the
    rank keeps its block of d_inner and all-reduces its ``down``
    partial."""
    if sa is None:
        h = rmsnorm(params["out_norm"], h.flatten(-2), eps=cfg.norm_eps)
        return (h * F.silu(z)) @ params["down"]
    from repro_torch.core.collectives.p2p import axis_index
    h = gather_cat(h, (sa.tp,), -1).flatten(-2)
    h = rmsnorm(params["out_norm"], h, eps=cfg.norm_eps)
    di = z.shape[-1]
    rank = axis_index(sa.tp)
    h = (h[..., rank * di:(rank + 1) * di] * F.silu(z)).to(torch.float32)
    return psum_f32(h @ params["down"].to(torch.float32), sa.tp, z.dtype)


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


def _mlstm_conv(params, xm: torch.Tensor) -> torch.Tensor:
    """The causal depthwise conv of the channels of ``xm``, SiLU'd."""
    K, T = params["conv_w"].shape[0], xm.shape[1]
    padded = F.pad(xm, (0, 0, K - 1, 0))
    conv = sum(padded[:, i:i + T, :] * params["conv_w"][i] for i in range(K))
    return F.silu(conv + params["conv_b"])


def _mlstm_proj_parts(params, conv, xm) -> torch.Tensor:
    """The f32 partial products of the rank's input rows of ``wq`` /
    ``wk`` / ``wv`` / ``w_if``, side by side."""
    f32 = torch.float32
    c, x = conv.to(f32), xm.to(f32)
    return torch.cat([c @ params["wq"].to(f32), c @ params["wk"].to(f32),
                      x @ params["wv"].to(f32), c @ params["w_if"].to(f32)],
                     dim=-1)


def mlstm_forward(params, cfg: ModelConfig, x: torch.Tensor,
                  return_state: bool = False):
    """x: (B, T, d) -> (B, T, d) [, final state {"C", "n", "m", "conv"}].
    Under ``sharding_ctx.train_region`` (or its control,
    ``blocked_region``) :func:`_mlstm_train`."""
    if not return_state:
        lanes = train_lanes(range)
        if lanes is not None:
            return _mlstm_train(params, cfg, x, lanes)
    B, T, _ = x.shape
    sa = serve_axes()
    xm, z, H, dh = _mlstm_pre(params, cfg, x)
    r0, rows = _mlstm_rows(cfg, B, sa)
    K = params["conv_w"].shape[0]
    conv = _mlstm_conv(params, xm)
    q, k, v, pre_if = _mlstm_proj(params, conv, xm,
                                  None if sa is None else sa.tp)
    h, final = _mlstm_recur(params, cfg, conv, q, k, v, pre_if, r0, rows,
                            x.dtype)
    out = _mlstm_out(params, cfg, h, z, sa)
    if return_state:
        C, n, m = final
        tail = F.pad(xm, (0, 0, max(0, K - 1 - T), 0))[:, -(K - 1):, :]
        return out, {"C": C, "n": n, "m": m, "conv": tail}
    return out


def _mlstm_recur(params, cfg: ModelConfig, conv, q, k, v, pre_if, r0: int,
                 rows: int, out_dtype):
    """The mLSTM recurrence on rows ``[r0, r0 + rows)`` of every head's
    ``dh_v`` (the whole q, k and gates): (h (B, T, H, rows), the final
    (C, n, m)); the sequential scan, or the chunkwise form
    (``cfg.mlstm_parallel``) where the chunk tiles T."""
    B, T, _ = conv.shape
    f32 = torch.float32
    H, dh = _heads(cfg, MLSTM_PF * cfg.d_model)
    q = q.reshape(B, T, H, dh)
    k = k.reshape(B, T, H, dh) / _sqrt_dh(dh, k)
    # the rank's rows of every head's value (all of them without tp)
    v = v.reshape(B, T, H, dh)[..., r0:r0 + rows]
    log_i, log_f = _mlstm_gates(params, conv, pre_if)     # (B, T, H)

    def step(carry, inp):
        q_t, k_t, v_t, li_t, lf_t = inp
        C, n, m, h = _mlstm_update(*carry, q_t.to(f32), k_t.to(f32),
                                   v_t.to(f32), li_t, lf_t)
        return (C, n, m), h.to(out_dtype)

    dev = conv.device
    init = (torch.zeros((B, H, rows, dh), dtype=f32, device=dev),
            torch.zeros((B, H, dh), dtype=f32, device=dev),
            torch.full((B, H), M_INIT, dtype=f32, device=dev))
    if cfg.mlstm_parallel and T % cfg.mlstm_chunk == 0:
        hs, final = mlstm_chunkwise(q, k, v, log_i, log_f, init,
                                    chunk=cfg.mlstm_chunk)
        return hs.to(out_dtype), final
    # the q, k, v stacks stay in the compute dtype; the step upcasts
    # before touching the f32 matrix state
    xs = tuple(t.transpose(0, 1) for t in (q, k, v, log_i, log_f))
    final, hs = chunked_scan(step, init, xs, chunk=cfg.mlstm_chunk)
    return hs.transpose(0, 1), final                      # (B, T, H, rows)


def _mlstm_train(params, cfg: ModelConfig, x: torch.Tensor, lanes):
    """The train layout's mLSTM (``lanes``: ``layers.Lanes``, a rank or
    the control).  ``norm`` runs whole and its output enters through
    ``tp_in`` (so its scale's gradient is whole); ``up``'s xm and z, the
    conv and the input rows of ``wq`` / ``wk`` / ``wv`` / ``w_if`` are the
    rank's ``inner`` block, and their f32 partials sum through
    ``layers.sum_f32``.  ``b_if`` is added after that sum, so its
    cotangent is the rank's partial: it takes the replica edge
    (:func:`mlstm_edge_blocks`).  C holds the rank's rows of ``dh_v``
    (block ``rank`` of ``tp``), n and m are whole; the rank's rows of h
    are gathered whole (``layers.gather_tp``, the backward a
    reduce-scatter: ``out_norm`` reads the whole h and the rank keeps its
    block of d_inner, so the cotangent is partial; ``out_norm``'s
    gradient, partial the same way, takes the replica edge); ``down``'s
    f32 partial is summed by ``tp_out`` in f32."""
    H, dh = _heads(cfg, MLSTM_PF * cfg.d_model)
    if dh % lanes.tp:
        raise ValueError(f"{cfg.name}: the mLSTM's dh_v={dh} does not "
                         f"split over tp={lanes.tp}")
    rows = dh // lanes.tp
    u = rmsnorm(params["norm"], x, eps=cfg.norm_eps)
    ps = lanes.share(params, cfg, mlstm_desc(cfg),
                     fanned=("b_if", "out_norm"))
    pre = []
    for p, ub in zip(ps, lanes.enter(u)):
        xm, z = torch.chunk(ub @ p["up"], 2, dim=-1)
        conv = _mlstm_conv(p, xm)
        pre.append((z, conv, _mlstm_proj_parts(p, conv, xm)))
    wholes = lanes.sum_f32([part for _, _, part in pre], x.dtype)
    hs = []
    for p, r, (_, conv, _), whole in zip(ps, lanes.ranks, pre, wholes):
        q, k, v, pre_if = torch.split(whole, [w.shape[-1] for w in (
            p["wq"], p["wk"], p["wv"], p["w_if"])], dim=-1)
        hs.append(_mlstm_recur(p, cfg, conv, q, k, v, pre_if, r * rows,
                               rows, x.dtype)[0])
    parts = []
    for p, r, (z, _, _), h in zip(ps, lanes.ranks, pre,
                                  lanes.gather_split(hs, -1)):
        h = rmsnorm(p["out_norm"], h.flatten(-2), eps=cfg.norm_eps)
        di = z.shape[-1]
        h = (h[..., r * di:(r + 1) * di] * F.silu(z)).to(torch.float32)
        parts.append(h @ p["down"].to(torch.float32))
    return lanes.out_f32(parts, x.dtype)


def mlstm_edge_blocks(cfg: ModelConfig, tp: int, rank: int):
    """The replica edge of an mLSTM layer's leaves (as
    ``attention.edge_blocks``): ``b_if`` and ``out_norm``, whole on every
    rank and read through the rank's share."""
    return {"b_if": (1, 0), "out_norm": (1, 0)}


def mlstm_chunkwise(q, k, v, log_i, log_f, init, chunk: int):
    """Chunkwise-parallel mLSTM recurrence (the xLSTM appendix / GLA form):
    per chunk of length c one (c, c) masked score product and one (c, dh)
    value product intra-chunk, plus the carried matrix state's inter-chunk
    contribution, with the exponential gates' stabilizer carried in ``m``.

    q, k: (B, T, H, dh) (k pre-scaled by 1/sqrt(dh)); v: (B, T, H, dv),
    the rows of C carried (dh, or a tp rank's block of them); log_i,
    log_f: (B, T, H) f32.  Returns (hs (B, T, H, dh) f32, final (C, n, m))."""
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
    h = torch.stack(hs).transpose(0, 1).reshape(B, T, H, v.shape[-1])
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
    sa = serve_axes()
    xm, z, H, dh = _mlstm_pre(params, cfg, x)
    xm, z = xm[:, 0], z[:, 0]
    r0, rows = _mlstm_rows(cfg, B, sa)
    window = torch.cat([state["conv"], xm[:, None, :]], dim=1)
    conv = F.silu(torch.einsum("bkd,kd->bd", window, params["conv_w"])
                  + params["conv_b"])
    q, k, v, pre_if = _mlstm_proj(params, conv, xm,
                                  None if sa is None else sa.tp)
    q = q.reshape(B, H, dh).to(f32)
    k = (k.reshape(B, H, dh) / _sqrt_dh(dh, x)).to(f32)
    v = v.reshape(B, H, dh)[..., r0:r0 + rows].to(f32)
    log_i, log_f = _mlstm_gates(params, conv, pre_if)
    C, n, m, h = _mlstm_update(state["C"], state["n"], state["m"], q, k, v,
                               log_i, log_f)
    out = _mlstm_out(params, cfg, h.to(x.dtype), z, sa)[:, None, :]
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
        # i, f, z, o pre-acts, laid out head x gate x dh: a rank holds
        # its block of dh of every head's every gate
        "w_in": ParamDesc((d, 4 * d), axes=("embed", "inner"), parts=4 * H),
        "r": ParamDesc((H, dh, 4 * dh), "small",       # block-diag recurrent
                       axes=(None, None, None)),
        "b": ParamDesc((4 * d,), "zeros", axes=(None,)),
        "out_norm": norm_desc(d),
        "up": ParamDesc((d, 2 * ff), axes=("embed", "ffn"),
                        parts=2),                      # [gate | up]
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


def _slstm_ffn(params, cfg: ModelConfig, h: torch.Tensor,
               group=None) -> torch.Tensor:
    """out_norm, the gated GELU FFN; under ``group`` on the rank's ffn
    slice with one all-reduce."""
    h = rmsnorm(params["out_norm"], h, eps=cfg.norm_eps)
    gate, up = torch.chunk(h @ params["up"], 2, dim=-1)
    if group is None:
        return (_gelu(gate) * up) @ params["down"]
    mid = (_gelu(gate) * up).to(torch.float32)
    return psum_f32(mid @ params["down"].to(torch.float32), group, h.dtype)


def _slstm_cols(cfg: ModelConfig, batch: int, sa):
    """(first, count) of dh that the rank's ``w_in`` columns and its
    block of ``h`` hold (all of it outside the serve region)."""
    H, dh = _heads(cfg, cfg.d_model)
    if sa is None:
        return 0, dh
    share = leaf_share("h", (batch, H, dh), sa)
    if share is None or share.dim != 2 or share.data:
        raise ValueError(f"{cfg.name}: the sLSTM over tp runs with h split "
                         f"on dh; the reference's cache_spec gives "
                         f"{share}")
    n = dh // share.parts
    return share.index * n, n


def _slstm_scan(params, cfg: ModelConfig, x_proj: torch.Tensor, out_dtype):
    """The sLSTM cell over the whole gates ``x_proj`` (B, T, 4d): (h (B, T,
    d), the final (c, n, m, h))."""
    B, T, _ = x_proj.shape
    H, dh = _heads(cfg, cfg.d_model)
    f32 = torch.float32

    def step(carry, xp_t):
        new = _slstm_cell(params, cfg, xp_t, carry)
        return new, new[3].to(out_dtype)

    zeros = torch.zeros((B, H, dh), dtype=f32, device=x_proj.device)
    init = (zeros, zeros, torch.full((B, H, dh), M_INIT, dtype=f32,
                                     device=x_proj.device), zeros)
    final, hs = chunked_scan(step, init, x_proj.transpose(0, 1),
                             chunk=cfg.mlstm_chunk)
    return hs.transpose(0, 1).reshape(B, T, cfg.d_model), final


def slstm_forward(params, cfg: ModelConfig, x: torch.Tensor,
                  return_state: bool = False):
    """x: (B, T, d) -> (B, T, d) [, final state {"c", "n", "m", "h"}].
    Under ``sharding_ctx.train_region`` (or its control,
    ``blocked_region``) :func:`_slstm_train`."""
    if not return_state:
        lanes = train_lanes(range)
        if lanes is not None:
            return _slstm_train(params, cfg, x, lanes)
    B, T, d = x.shape
    H, dh = _heads(cfg, d)
    sa = serve_axes()
    c0, cols = _slstm_cols(cfg, B, sa)
    u = rmsnorm(params["norm"], x, eps=cfg.norm_eps)
    x_proj = u @ params["w_in"]                          # (B, T, 4d)
    if sa is not None:
        # the rank's dh block of every head's gates, gathered whole
        x_proj = gather_cat(x_proj.reshape(B, T, H, 4, cols), (sa.tp,),
                            -1).reshape(B, T, 4 * d)
    hs, final = _slstm_scan(params, cfg, x_proj, x.dtype)
    out = _slstm_ffn(params, cfg, hs, None if sa is None else sa.tp)
    if return_state:
        c, n, m, hf = final
        return out, {"c": c, "n": n, "m": m,
                     "h": hf[..., c0:c0 + cols].contiguous()}
    return out


def _slstm_train(params, cfg: ModelConfig, x: torch.Tensor, lanes):
    """The train layout's sLSTM (``lanes``: ``layers.Lanes``, a rank or
    the control): ``norm`` whole, its output through ``tp_in`` into the
    rank's ``w_in`` columns (its block of dh of every head's every
    gate), the gates gathered whole (``layers.gather_tp`` with the rank's
    own block as the backward: every rank runs the same cell on them);
    the cell (``r``, ``b``) and ``out_norm`` whole on every rank, whose
    output enters the FFN through ``tp_in``, so that h's cotangent, and
    with it the cell's gradients, is whole and the same on every rank;
    the FFN on the rank's ffn slice, its f32 partial summed by ``tp_out``
    in f32."""
    B, T, d = x.shape
    H, dh = _heads(cfg, d)
    if dh % lanes.tp:
        raise ValueError(f"{cfg.name}: the sLSTM's dh={dh} does not split "
                         f"over tp={lanes.tp}")
    cols = dh // lanes.tp
    u = rmsnorm(params["norm"], x, eps=cfg.norm_eps)
    ps = lanes.share(params, cfg, slstm_desc(cfg))
    x_proj = lanes.gather_whole(
        [(ub @ p["w_in"]).reshape(B, T, H, 4, cols)
         for p, ub in zip(ps, lanes.enter(u))], -1).reshape(B, T, 4 * d)
    hs, _ = _slstm_scan(params, cfg, x_proj, x.dtype)
    h = rmsnorm(params["out_norm"], hs, eps=cfg.norm_eps)
    parts = []
    for p, hb in zip(ps, lanes.enter(h)):
        gate, up = torch.chunk(hb @ p["up"], 2, dim=-1)
        parts.append((_gelu(gate) * up).to(torch.float32)
                     @ p["down"].to(torch.float32))
    return lanes.out_f32(parts, x.dtype)


def init_slstm_state(cfg: ModelConfig, batch: int, dtype):
    H, dh = _heads(cfg, cfg.d_model)
    s = TensorSpec((batch, H, dh), torch.float32)
    return {"c": s, "n": s, "m": s, "h": s}


def slstm_decode(params, cfg: ModelConfig, x: torch.Tensor, state):
    """One-token step. x: (B, 1, d).  Returns (out (B, 1, d), new
    state)."""
    B = x.shape[0]
    H, dh = _heads(cfg, cfg.d_model)
    sa = serve_axes()
    c0, cols = _slstm_cols(cfg, B, sa)
    u = rmsnorm(params["norm"], x[:, 0], eps=cfg.norm_eps)
    x_proj, h = u @ params["w_in"], state["h"]
    if sa is not None:
        # one all-gather: the rank's x_proj columns and its block of h,
        # side by side in f32 (x_proj's dtype widened, exactly)
        both = torch.cat([x_proj.reshape(B, H, 4, cols).to(torch.float32),
                          h[:, :, None]], dim=2)
        both = gather_cat(both, (sa.tp,), -1)            # (B, H, 5, dh)
        x_proj = both[:, :, :4].reshape(B, 4 * cfg.d_model).to(u.dtype)
        h = both[:, :, 4]
    carry = (state["c"], state["n"], state["m"], h)
    c, n, m, h = _slstm_cell(params, cfg, x_proj, carry)
    hv = h.reshape(B, cfg.d_model).to(x.dtype)
    out = _slstm_ffn(params, cfg, hv, None if sa is None else sa.tp)
    return out[:, None, :], {"c": c, "n": n, "m": m,
                             "h": h[..., c0:c0 + cols].contiguous()}
