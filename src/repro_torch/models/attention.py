"""Attention of the port: GQA/MQA with RoPE, QK-norm, sliding windows and
logit softcap, DeepSeek-V2's multi-head latent attention (MLA), and
single-token KV-cache decoding — counterparts of
``repro/models/attention.py``.

Two full-sequence paths:

  * **prefill** (:func:`attn_prefill`: the engine's admissions,
    ``GenerateSession.generate``, ``Model.prefill``) is forward only and
    calls ``kernels/ops.flash_attention``: on a CUDA tensor the Hopper
    kernel ``csrc/flash_attention.cu`` (the port of the Pallas kernel
    ``repro/kernels/flash_attention.py``), on a CPU tensor its plain
    version;
  * **training** (:func:`attn_forward`) keeps :func:`flash_attention`, the
    chunked streaming-softmax forward of the reference's pure-jnp twin
    (``_flash_fwd_impl``) as plain PyTorch ops over query and key blocks,
    with the reference's FlashAttention-2 custom VJP (``_flash_bwd``) as a
    ``torch.autograd.Function`` (:class:`_Flash`) whose backward recomputes
    the probabilities per block from the saved log-sum-exp.  The JAX
    training path runs this twin too: the Pallas kernel has no backward
    and writes no log-sum-exp, so its port serves only the forward.

Scores and the softmax are computed in f32 on both paths, as the
reference's ``preferred_element_type=jnp.float32``.

Under ``sharding_ctx.serve_region`` the grouped-query layer runs the
reference's serve layout over the model axis (:func:`head_layout`): a
rank projects and attends its block of the query heads and the kv heads
they read, applies its rows of ``wo``, and one all-reduce sums the
blocks.  The decode cache is laid out as the reference's ``cache_spec``
lays it out (:func:`cache_split`): kv heads over the model axis, or the
length over it (and over the data axes at batch 1), where the decode
all-gathers the step's queries and new K/V, scores every head against
the rank's own positions and combines the partial softmaxes by the
split-KV rule in f32 (:func:`_split_softmax`).  MLA runs its head block
(``wq``, ``w_ukv``, ``wo``) on the whole latents, which every rank
computes, and keeps its block of their positions; its decode combines
every head's partial softmax the same way (:func:`_mla_decode_tp`).

Under ``sharding_ctx.train_region`` the training layer runs the
reference's train layout over the model axis: the same head blocks with
the chunked attention and its backward between ``layers.tp_in`` and
``tp_out`` (:func:`_attn_train_tp`; bidirectional for the encoder), and
the replica edge over the leaves a head block reads but shares
(:func:`attn_replica_edge`); ``blocked_region`` runs its control on the
whole weights (:func:`_attn_blocked`, :func:`head_lanes`).  MLA trains
on its head block over the whole latents (:func:`mla_forward`, its edge
:func:`mla_edge_blocks`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (ParamDesc, TensorSpec, apply_rope,
                                       fan, muted, norm_desc, replica_edges,
                                       rmsnorm, tp_in, tp_out, train_lanes,
                                       tree_sum)
from repro_torch.models.sharding_ctx import (blocked_tp, cache_leaf_spec,
                                             leaf_share, serve_axes,
                                             train_axes)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Chunked (flash-style) full-sequence attention
# ---------------------------------------------------------------------------

def _block_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window):
    m = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    return m


def _masked_scores(qc, kc, qp, kp, scale, softcap, causal, window):
    """(B,KV,G,cq,hd) x (B,KV,ck,hd) -> capped+masked scores (f32)."""
    s = torch.einsum("bkgqh,bkch->bkgqc", qc.to(torch.float32),
                     kc.to(torch.float32)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if causal:
        mask = _block_mask(qp, kp, window)
        s = torch.where(mask[None, None, None], s, NEG_INF)
    elif window is not None:
        mask = (qp[:, None] - kp[None, :]).abs() < window
        s = torch.where(mask[None, None, None], s, NEG_INF)
    return s


def _flash_fwd_impl(qg, kg, vg, causal, window, softcap, q_chunk, kv_chunk,
                    q_offset):
    """qg: (B,KV,G,T,hd); kg/vg: (B,KV,S,hd).  Returns (out (B,KV,G,T,hd),
    lse (B,KV,G,T) f32); only the backward reads the log-sum-exp."""
    B, KV, G, T, hd = qg.shape
    S = kg.shape[2]
    scale = 1.0 / math.sqrt(hd)
    nq, nk = T // q_chunk, S // kv_chunk
    dev = qg.device
    q_positions = q_offset + torch.arange(T, device=dev)
    k_positions = torch.arange(S, device=dev)
    outs, lses = [], []
    for qi in range(nq):
        qsl = slice(qi * q_chunk, (qi + 1) * q_chunk)
        qc, qp = qg[:, :, :, qsl], q_positions[qsl]
        m = torch.full((B, KV, G, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, G, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, G, q_chunk, hd), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            ksl = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            kc, vc, kp = kg[:, :, ksl], vg[:, :, ksl], k_positions[ksl]
            s = _masked_scores(qc, kc, qp, kp, scale, softcap, causal, window)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqc,bkch->bkgqh", p.to(vc.dtype).to(torch.float32),
                vc.to(torch.float32))
            m = m_new
        l = torch.clamp_min(l, 1e-30)
        outs.append((acc / l[..., None]).to(qg.dtype))
        lses.append(m + torch.log(l))
    return torch.cat(outs, dim=3), torch.cat(lses, dim=3)


def _flash_bwd_impl(qg, kg, vg, out, lse, do, causal, window, softcap,
                    q_chunk, kv_chunk, q_offset):
    """FlashAttention-2 backward of the reference (``_flash_bwd``): for
    each (kv, q) block pair recompute P from the saved log-sum-exp, then
    accumulate dV, dK over q blocks and dQ over kv blocks, all in f32.
    Memory is O(block), not O(T·S)."""
    B, KV, G, T, hd = qg.shape
    S = kg.shape[2]
    scale = 1.0 / math.sqrt(hd)
    nq, nk = T // q_chunk, S // kv_chunk
    dev = qg.device
    f32 = torch.float32
    q_positions = q_offset + torch.arange(T, device=dev)
    k_positions = torch.arange(S, device=dev)
    do = do.to(f32)
    delta = torch.sum(do * out.to(f32), dim=-1)                 # (B,KV,G,T)
    dq = torch.zeros((B, KV, G, T, hd), dtype=f32, device=dev)
    dks, dvs = [], []
    for ki in range(nk):
        ksl = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
        kc, vc, kp = kg[:, :, ksl], vg[:, :, ksl], k_positions[ksl]
        kc32, vc32 = kc.to(f32), vc.to(f32)
        dk = torch.zeros((B, KV, kv_chunk, hd), dtype=f32, device=dev)
        dv = torch.zeros((B, KV, kv_chunk, hd), dtype=f32, device=dev)
        dq_chunks = []
        for qi in range(nq):
            qsl = slice(qi * q_chunk, (qi + 1) * q_chunk)
            qc32, qp = qg[:, :, :, qsl].to(f32), q_positions[qsl]
            lse_c, do_c, dl_c = lse[..., qsl], do[:, :, :, qsl], delta[..., qsl]
            s = torch.einsum("bkgqh,bkch->bkgqc", qc32, kc32) * scale
            if softcap is not None:
                t = torch.tanh(s / softcap)
                s = softcap * t
            if causal:
                mask = _block_mask(qp, kp, window)
            elif window is not None:
                mask = (qp[:, None] - kp[None, :]).abs() < window
            else:
                mask = torch.ones(s.shape[-2:], dtype=torch.bool, device=dev)
            p = torch.where(mask[None, None, None],
                            torch.exp(s - lse_c[..., None]), 0.0)
            dv = dv + torch.einsum("bkgqc,bkgqh->bkch", p, do_c)
            dp = torch.einsum("bkgqh,bkch->bkgqc", do_c, vc32)
            ds = p * (dp - dl_c[..., None])
            if softcap is not None:
                ds = ds * (1.0 - t * t)
            ds = ds * scale
            dq_chunks.append(torch.einsum("bkgqc,bkch->bkgqh", ds, kc32))
            dk = dk + torch.einsum("bkgqc,bkgqh->bkch", ds, qc32)
        dq = dq + torch.cat(dq_chunks, dim=3)
        dks.append(dk)
        dvs.append(dv)
    return (dq.to(qg.dtype), torch.cat(dks, dim=2).to(kg.dtype),
            torch.cat(dvs, dim=2).to(vg.dtype))


class _Flash(torch.autograd.Function):
    """Chunked attention with the FlashAttention-2 backward (the
    reference's ``_flash`` custom VJP)."""

    @staticmethod
    def forward(ctx, qg, kg, vg, causal, window, softcap, q_chunk, kv_chunk,
                q_offset):
        out, lse = _flash_fwd_impl(qg, kg, vg, causal, window, softcap,
                                   q_chunk, kv_chunk, q_offset)
        ctx.save_for_backward(qg, kg, vg, out, lse)
        ctx.static = (causal, window, softcap, q_chunk, kv_chunk, q_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        qg, kg, vg, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(qg, kg, vg, out, lse, do, *ctx.static)
        return (dq, dk, dv) + (None,) * 6


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None, q_chunk: int = 512,
                    kv_chunk: int = 1024, q_offset: int = 0) -> torch.Tensor:
    """q: (B, T, H, hd); k, v: (B, S, KV, hd) with H = KV * G.  Returns
    (B, T, H, hd), differentiable through :class:`_Flash`.  ``q_offset``
    is the absolute position of q[0]."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    q_chunk = min(q_chunk, T)
    kv_chunk = min(kv_chunk, S)
    if T % q_chunk or S % kv_chunk:
        raise ValueError(f"chunks must tile the sequence: T={T} S={S} "
                         f"q_chunk={q_chunk} kv_chunk={kv_chunk}")
    qg = q.reshape(B, T, KV, G, hd).permute(0, 2, 3, 1, 4)
    kg = k.permute(0, 2, 1, 3)
    vg = v.permute(0, 2, 1, 3)
    out = _Flash.apply(qg, kg, vg, causal, window, softcap, q_chunk,
                       kv_chunk, q_offset)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, hd)


# ---------------------------------------------------------------------------
# Standard GQA attention layer
# ---------------------------------------------------------------------------

def attn_desc(cfg: ModelConfig) -> Dict[str, ParamDesc]:
    d, hd = cfg.d_model, cfg.hd
    desc = {
        "wq": ParamDesc((d, cfg.num_heads * hd), axes=("embed", "heads")),
        "wk": ParamDesc((d, cfg.num_kv_heads * hd), axes=("embed", "kv")),
        "wv": ParamDesc((d, cfg.num_kv_heads * hd), axes=("embed", "kv")),
        "wo": ParamDesc((cfg.num_heads * hd, d), axes=("heads", "embed")),
    }
    if cfg.qk_norm:
        desc["q_norm"] = norm_desc(hd)
        desc["k_norm"] = norm_desc(hd)
    return desc


def _project_qkv(params, cfg: ModelConfig, x, positions):
    """q (B, T, H, hd), k and v (B, T, KV, hd) with QK-norm and RoPE; the
    head counts are those of ``params`` (a model-axis rank's columns hold
    its block of the heads)."""
    B, T, _ = x.shape
    hd = cfg.hd
    q = (x @ params["wq"]).reshape(B, T, -1, hd)
    k = (x @ params["wk"]).reshape(B, T, -1, hd)
    v = (x @ params["wv"]).reshape(B, T, -1, hd)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, eps=cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, eps=cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_train(params, cfg: ModelConfig, spec: LayerSpec, x, positions,
                causal: bool = True):
    B, T, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = flash_attention(q, k, v, causal=causal, window=spec.window,
                          softcap=cfg.attn_logit_softcap)
    return out.reshape(B, T, -1) @ params["wo"]


def attn_forward(params, cfg: ModelConfig, spec: LayerSpec, x, positions,
                 causal: bool = True):
    """Full-sequence attention (training), causal or bidirectional (the
    encoder). x: (B, T, d).  Under ``sharding_ctx.train_region`` the
    rank's head block (:func:`_attn_train_tp`), under ``blocked_region``
    the control (:func:`_attn_blocked`)."""
    ta = train_axes()
    if ta is not None:
        return _attn_train_tp(params, cfg, spec, x, positions, ta, causal)
    tp = blocked_tp()
    if tp is not None:
        return _attn_blocked(params, cfg, spec, x, positions, tp, causal)
    return _attn_train(params, cfg, spec, x, positions, causal)


def attn_prefill(params, cfg: ModelConfig, spec: LayerSpec, x, positions,
                 max_len: int):
    """Full-sequence attention that also emits the decode cache, through
    ``ops.flash_attention`` (the Hopper kernel on CUDA, forward only).

    Full-attention layers cache all T entries (padded to ``max_len``);
    sliding-window layers keep a ring buffer of the last ``window``
    entries, rolled so that the entry for position p sits at slot
    p % window.
    """
    B, T, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = ops.flash_attention(q, k, v, causal=True, window=spec.window,
                              softcap=cfg.attn_logit_softcap)
    out = out.reshape(B, T, -1) @ params["wo"]
    sa = serve_axes()

    def to_cache(arr):
        if spec.window and spec.window < max_len:
            W = min(spec.window, T)
            tail = arr[:, T - W:]
            if T > W:
                tail = torch.roll(tail, shifts=(T - W) % W, dims=1)
            L = min(spec.window, max_len)
            return torch.nn.functional.pad(tail, (0, 0, 0, 0, 0, L - W))
        return torch.nn.functional.pad(arr, (0, 0, 0, 0, 0, max_len - T))

    if sa is None:
        return out, {"k": to_cache(k), "v": to_cache(v)}
    lay = head_layout(cfg, *_tp_of(sa))
    split = cache_split(cfg, spec, max_len, sa)
    kv = _to_decode_layout(torch.stack([to_cache(k), to_cache(v)]), cfg, lay,
                           split, sa)
    return _heads_out(out, lay, sa), {"k": kv[0], "v": kv[1]}


def init_attn_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                    max_len: int, dtype):
    """Cache shapes for one attention layer.  Sliding-window layers keep a
    ring buffer of ``window`` entries instead of the full context."""
    L = min(max_len, spec.window) if spec.window else max_len
    shape = (batch, L, cfg.num_kv_heads, cfg.hd)
    return {"k": TensorSpec(shape, dtype), "v": TensorSpec(shape, dtype)}


def attn_decode(params, cfg: ModelConfig, spec: LayerSpec, x, cache, pos,
                inplace: bool = False):
    """One-token decode.  x: (B, 1, d); cache: {'k','v'} (B, L, KV, hd);
    pos: an int — number of tokens already in the cache — or a (B,) int
    tensor of per-row positions (the serving engine's continuous batch,
    where every slot sits at its own depth).  Returns (out, new cache);
    the input cache is not modified, unless ``inplace``: then the new
    token's K/V are written into it (the reference's donated buffer) and
    it is returned.  Under ``serve_region`` the rank's share runs
    (:func:`_attn_decode_tp`)."""
    sa = serve_axes()
    if sa is not None:
        return _attn_decode_tp(params, cfg, spec, x, cache, pos, sa, inplace)
    B = x.shape[0]
    hd = cfg.hd
    dev = x.device
    vec = isinstance(pos, torch.Tensor) and pos.ndim == 1
    if vec:
        pos = pos.to(device=dev, dtype=torch.int64)
        positions = pos[:, None]
    else:
        pos = int(pos)
        positions = torch.full((B, 1), pos, dtype=torch.int64, device=dev)
    q, k, v = _project_qkv(params, cfg, x, positions)
    L = cache["k"].shape[1]
    slot = pos % L if spec.window else pos
    if vec:
        k_cache = _store_rows(cache["k"], k, slot, inplace)
        v_cache = _store_rows(cache["v"], v, slot, inplace)
    else:
        k_cache = _dynamic_store(cache["k"], k, slot, inplace)
        v_cache = _dynamic_store(cache["v"], v, slot, inplace)

    # positions actually stored in each cache slot (ring-aware); valid is
    # (B, L) on the vector path, (L,) on the scalar path
    idx = torch.arange(L, device=dev)
    p_row = pos[:, None] if vec else pos
    if spec.window:
        # slot i holds position p with p % L == i and p <= pos; invalid if
        # p > pos or evicted (pos - p >= window)
        base = p_row - (p_row % L)
        cand = torch.where(idx <= (p_row % L), base + idx, base - L + idx)
        valid = (cand >= 0) & (cand <= p_row) & ((p_row - cand) < spec.window)
    else:
        valid = idx <= p_row
    vmask = (valid[:, None, None, None, :] if vec
             else valid[None, None, None, None, :])

    qg = q.reshape(B, 1, cfg.num_kv_heads, -1, hd)
    s = torch.einsum("btkgh,blkh->bkgtl", qg.to(torch.float32),
                     k_cache.to(torch.float32)) / math.sqrt(hd)
    if cfg.attn_logit_softcap is not None:
        s = cfg.attn_logit_softcap * torch.tanh(s / cfg.attn_logit_softcap)
    s = torch.where(vmask, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgtl,blkh->btkgh", p, v_cache).reshape(B, 1, -1)
    return out @ params["wo"], {"k": k_cache, "v": v_cache}


def _dynamic_store(cache, new, slot: int, inplace: bool = False):
    """cache[:, slot] = new[:, 0] on a copy (``inplace``: into ``cache``
    itself); ``slot`` is clamped into range as ``lax.dynamic_update_slice``
    clamps it."""
    slot = min(max(int(slot), 0), cache.shape[1] - 1)
    out = cache if inplace else cache.clone()
    out[:, slot] = new[:, 0].to(cache.dtype)
    return out


def _store_rows(cache, new, slot, inplace: bool = False):
    """Per-row store on a copy (``inplace``: into ``cache`` itself):
    new[b, 0] lands at cache[b, slot[b]] — the vector-``pos`` twin of
    :func:`_dynamic_store`; a row whose slot lies outside [0, L) writes
    nothing.  cache: (B, L, ...); new: (B, 1, ...); slot: (B,) int."""
    L = cache.shape[1]
    if inplace:
        rows = torch.arange(cache.shape[0], device=cache.device)
        at = torch.clamp(slot, 0, L - 1)
        hit = ((slot >= 0) & (slot < L)).reshape(
            (-1,) + (1,) * (cache.ndim - 2))
        cache[rows, at] = torch.where(hit, new[:, 0].to(cache.dtype),
                                      cache[rows, at])
        return cache
    hit = torch.arange(L, device=cache.device)[None, :] == slot[:, None]
    hit = hit.reshape(hit.shape + (1,) * (cache.ndim - 2))
    return torch.where(hit, new.to(cache.dtype), cache)


# ---------------------------------------------------------------------------
# The serve layout over the model axis
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HeadLayout:
    """One model-axis rank's share of a grouped-query attention layer: of
    ``tp`` ranks, the ``attn_tp`` head blocks (``tp``, or H where H <
    tp: each block then held by ``tp // H`` ranks, of which only
    ``replica`` 0 adds its ``wo`` partial), this rank's query heads
    ``[h0, h0 + hl)`` and the kv heads ``[kv0, kv0 + kvl)`` they read."""
    tp: int
    rank: int
    attn_tp: int
    block: int
    replica: int
    h0: int
    hl: int
    kv0: int
    kvl: int


def head_layout(cfg: ModelConfig, tp: int, rank: int) -> HeadLayout:
    """The head block of model-axis rank ``rank`` of ``tp``; raises where
    H and tp do not divide one another, or where a block's heads would
    read kv heads that are not one whole group layout."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    if H % tp == 0:
        attn_tp = tp
    elif tp % H == 0:
        attn_tp = H
    else:
        raise ValueError(f"{cfg.name}: {H} heads do not split over tp={tp}"
                         f" (nor tp over the heads)")
    block, replica = divmod(rank, tp // attn_tp)
    hl = H // attn_tp
    h0 = block * hl
    G = H // KV
    kv0 = h0 // G
    kvl = (h0 + hl - 1) // G + 1 - kv0
    if hl % kvl or any((h0 + i) // G - kv0 != i // (hl // kvl)
                       for i in range(hl)):
        raise ValueError(f"{cfg.name}: heads [{h0}, {h0 + hl}) read kv heads "
                         f"[{kv0}, {kv0 + kvl}) in no grouped layout")
    return HeadLayout(tp, rank, attn_tp, block, replica, h0, hl, kv0, kvl)


def _tp_of(sa) -> Tuple[int, int]:
    from repro_torch.core.collectives.p2p import axis_index, axis_size
    return axis_size(sa.tp), axis_index(sa.tp)


@dataclasses.dataclass(frozen=True)
class CacheSplit:
    """How one attention layer's decode cache lies on a rank: the global
    length ``L``; ``model`` ("kv", "length" or None: whole over the model
    axis); the length in ``parts`` blocks, this rank holding block
    ``index`` (data index major, model index minor, as the reference's
    ``("data", "model")``); and the kv heads ``[kv0, kv0 + kvl)``
    held."""
    L: int
    model: Optional[str]
    data: bool
    parts: int
    index: int
    kv0: int
    kvl: int


def cache_split(cfg: ModelConfig, spec: LayerSpec, max_len: int,
                sa) -> CacheSplit:
    """The reference's ``cache_spec`` for this layer's K/V leaf, with the
    tp group's size as the model axis' and the region's data groups (set
    only for a batch-1 cache) as its data axes."""
    from repro_torch.core.collectives.p2p import axis_index, axis_size
    if max_len is None:
        raise ValueError("the serve region needs the cache's max_len")
    tp, rank = _tp_of(sa)
    L = min(max_len, spec.window) if spec.window else max_len
    KV = cfg.num_kv_heads
    names = tuple(f"d{i}" for i in range(len(sa.data)))
    batch = 1 if sa.data else 2
    leaf = cache_leaf_spec("k", (batch, L, KV, cfg.hd), batch, model_n=tp,
                           data=names)
    length = leaf[1] if isinstance(leaf[1], tuple) else (leaf[1],)
    model = "kv" if leaf[2] == "model" else         "length" if "model" in length else None
    data = bool(names) and names[0] in length
    parts, index = 1, 0
    if data:
        for g in sa.data:
            parts, index = parts * axis_size(g), index * axis_size(g) +                 axis_index(g)
    if model == "length":
        parts, index = parts * tp, index * tp + rank
    if L % parts:
        raise ValueError(f"cache length {L} does not split into {parts}")
    if model == "kv":
        lay = head_layout(cfg, tp, rank)
        kv0, kvl = lay.kv0, lay.kvl
    else:
        kv0, kvl = 0, KV
    return CacheSplit(L, model, data, parts, index, kv0, kvl)


def _assemble_kv(rows: torch.Tensor, cfg: ModelConfig, tp: int):
    """Every kv head from a gather over the tp ranks (``rows``: (tp, ...,
    kvl, hd), row j the kv heads rank j computed), each from the first
    rank that holds it: (..., KV, hd)."""
    parts = []
    for h in range(cfg.num_kv_heads):
        for j in range(tp):
            lay = head_layout(cfg, tp, j)
            if lay.kv0 <= h < lay.kv0 + lay.kvl:
                parts.append(rows[j, ..., h - lay.kv0, :])
                break
    return torch.stack(parts, dim=-2)


def _to_decode_layout(kv: torch.Tensor, cfg: ModelConfig, lay: HeadLayout,
                      split: CacheSplit, sa) -> torch.Tensor:
    """The prefill's cache (``kv``: K and V stacked, (2, B, L, kvl, hd),
    the kv heads this rank computed at every position) as decode holds
    it: a batch-1 cache keeps its data block of the length; under the
    length split one all-to-all over tp regroups the kv heads by
    positions, and a cache whole over tp is all-gathered (neither where
    the rank computed every kv head)."""
    from repro_torch.core.collectives.api import all_gather, all_to_all
    KV = cfg.num_kv_heads
    if split.data:
        dparts = split.parts // (lay.tp if split.model == "length" else 1)
        block = split.L // dparts
        d = split.index // (lay.tp if split.model == "length" else 1)
        kv = kv.narrow(2, d * block, block)
    if split.model == "length":
        Lt = kv.shape[2] // lay.tp
        if lay.kvl == KV:
            return kv.narrow(2, lay.rank * Lt, Lt).contiguous()
        chunks = kv.reshape(2, kv.shape[1], lay.tp, Lt, lay.kvl,
                            kv.shape[-1]).movedim(2, 0).contiguous()
        return _assemble_kv(all_to_all(chunks, sa.tp), cfg, lay.tp)
    if split.model is None and lay.kvl < KV:
        return _assemble_kv(all_gather(kv.contiguous(), sa.tp), cfg, lay.tp)
    return kv.contiguous()


def _heads_out(partial: torch.Tensor, lay: HeadLayout, sa) -> torch.Tensor:
    """The layer's output from the ranks' ``wo`` partials: one all-reduce
    over tp, to which only replica 0 of a head block adds its partial
    (the others add zeros), so each block counts once."""
    if lay.replica:
        partial = torch.zeros_like(partial)
    return tp_out(partial, sa.tp)


# ---------------------------------------------------------------------------
# The train layout over the model axis
# ---------------------------------------------------------------------------

def _attn_train_tp(params, cfg: ModelConfig, spec: LayerSpec, x, positions,
                   ta, causal: bool = True):
    """One rank of the train layout: ``x`` through ``tp_in``, the rank's
    head block (``params``: its columns of ``wq`` / ``wk`` / ``wv``, its
    rows of ``wo``; ``convert.train_slice``) through the chunked
    attention with its FlashAttention-2 backward, and the ``wo`` partials
    summed by ``tp_out``, to which only replica 0 of a head block adds
    (a replica's partial is muted, its backward kept for the collectives
    every rank runs)."""
    lay = head_layout(cfg, *_tp_of(ta))
    out = _attn_train(params, cfg, spec, tp_in(x, ta.tp, ta.algo),
                      positions, causal)
    return tp_out(muted(out, lay.replica > 0), ta.tp, ta.algo)


def head_ranks(cfg: ModelConfig, tp: int):
    """The first holder of each distinct head block at ``tp``: the ranks
    whose work the control computes."""
    return range(0, tp, tp // min(tp, cfg.num_heads))


def head_lanes(params, cfg: ModelConfig, tp: int):
    """The control's lanes of a grouped-query layer at ``tp`` (one a
    distinct head block, :func:`head_ranks`), each a dict of its block's
    parameters: contiguous copies of its ``wq`` columns and ``wo`` rows,
    its kv heads' ``wk`` / ``wv`` columns read through :func:`fan` among
    the blocks that read them, and the QK-norm scales through
    :func:`fan` (a leaf the layer lacks is left out)."""
    hd = cfg.hd
    lays = [head_layout(cfg, tp, r) for r in head_ranks(cfg, tp)]
    kv_readers = {}
    for lay in lays:
        kv_readers.setdefault(lay.kv0, []).append(lay)
    kv_views = {}
    for kv0, readers in kv_readers.items():
        kvl = readers[0].kvl
        kv_views[kv0] = {
            name: iter(fan(params[name].narrow(-1, kv0 * hd, kvl * hd)
                           .contiguous(), len(readers)))
            for name in ("wk", "wv")}
    norms = {name: iter(fan(params[name]["scale"], len(lays)))
             for name in ("q_norm", "k_norm") if name in params}
    lanes = []
    for lay in lays:
        p = {"wq": params["wq"].narrow(-1, lay.h0 * hd, lay.hl * hd)
             .contiguous(),
             "wo": params["wo"].narrow(-2, lay.h0 * hd, lay.hl * hd)
             .contiguous()}
        p.update({name: next(v) for name, v in kv_views[lay.kv0].items()})
        p.update({name: {"scale": next(v)} for name, v in norms.items()})
        lanes.append(p)
    return lanes


def _attn_blocked(params, cfg: ModelConfig, spec: LayerSpec, x, positions,
                  tp: int, causal: bool = True):
    """The control of :func:`_attn_train_tp` at ``tp``, on the whole
    parameters: each head block (:func:`head_lanes`) computed apart,
    reading ``x`` through :func:`fan`, and the blocks' ``wo`` partials
    added by :func:`tree_sum`: the arithmetic of the tp ranks on
    ``tree`` (a replica's zero partials and zero cotangents add
    nothing)."""
    lanes = head_lanes(params, cfg, tp)
    return tree_sum([_attn_train(p, cfg, spec, xb, positions, causal)
                     for xb, p in zip(fan(x, len(lanes)), lanes)])


def edge_blocks(cfg: ModelConfig, tp: int, rank: int):
    """The replica edge of an attention layer's leaves on rank ``rank`` of
    ``tp``: leaf name -> (blocks, index), the leaf's distinct blocks over
    the group and the rank's, for each leaf that more ranks hold than
    there are blocks: the kv columns where kv heads are shared, the query
    columns and ``wo`` rows where a head block is held by several ranks
    (H < tp), and the QK-norm scales, which every rank holds whole."""
    lay = head_layout(cfg, tp, rank)
    out = {}
    kv_blocks = cfg.num_kv_heads // lay.kvl
    if kv_blocks < tp:
        out.update({"wk": (kv_blocks, lay.kv0 // lay.kvl),
                    "wv": (kv_blocks, lay.kv0 // lay.kvl)})
    if lay.attn_tp < tp:
        out.update({"wq": (lay.attn_tp, lay.block),
                    "wo": (lay.attn_tp, lay.block)})
    if cfg.qk_norm:
        out.update({"q_norm": (1, 0), "k_norm": (1, 0)})
    return out


def attn_replica_edge(params, cfg: ModelConfig, ta):
    """``params`` (one attention layer's leaves, stacked or not; the
    encoder-decoder's cross-attention too) with every leaf of
    :func:`edge_blocks` wrapped in ``layers.replica_edge`` over the train
    layout's group (``ta``: ``sharding_ctx.TrainAxes``); the rest as it
    is."""
    return replica_edges(params, edge_blocks(cfg, *_tp_of(ta)), ta)


def _store_block(cache, new, slot, lo: int, inplace: bool):
    """Write ``new`` (B, 1, ...) at global slot ``slot`` (an int or (B,))
    into the rank's block of positions ``[lo, lo + cache.shape[1])``:
    only a rank whose block holds the slot writes."""
    Ll = cache.shape[1]
    if isinstance(slot, torch.Tensor):
        return _store_rows(cache, new, slot - lo, inplace)
    if not lo <= slot < lo + Ll:
        return cache
    return _dynamic_store(cache, new, slot - lo, inplace)


def _attn_decode_tp(params, cfg: ModelConfig, spec: LayerSpec, x, cache,
                    pos, sa, inplace: bool):
    """One-token decode of a model-axis rank (see :func:`attn_decode`),
    against its share of the cache (:func:`cache_split`)."""
    from repro_torch.core.collectives.api import all_gather
    B = x.shape[0]
    hd = cfg.hd
    dev = x.device
    H, KV = cfg.num_heads, cfg.num_kv_heads
    vec = isinstance(pos, torch.Tensor) and pos.ndim == 1
    if vec:
        pos = pos.to(device=dev, dtype=torch.int64)
        positions = pos[:, None]
    else:
        pos = int(pos)
        positions = torch.full((B, 1), pos, dtype=torch.int64, device=dev)
    q, k, v = _project_qkv(params, cfg, x, positions)
    lay = head_layout(cfg, *_tp_of(sa))
    split = cache_split(cfg, spec, sa.max_len, sa)
    L = split.L
    Ll = L // split.parts
    lo = split.index * Ll
    if tuple(cache["k"].shape[1:3]) != (Ll, split.kvl):
        raise ValueError(f"the rank's cache is {tuple(cache['k'].shape)}; "
                         f"its layout holds {Ll} positions of {split.kvl} "
                         f"kv heads")
    new = torch.stack([k, v])                     # (2, B, 1, kvl, hd)
    if split.kvl > lay.kvl:
        new = _assemble_kv(all_gather(new.contiguous(), sa.tp), cfg, lay.tp)
    if split.model == "length":
        # every head scores against this rank's positions
        rows = all_gather(q.contiguous(), sa.tp)  # (tp, B, 1, hl, hd)
        q = torch.cat([rows[b * (lay.tp // lay.attn_tp)]
                       for b in range(lay.attn_tp)], dim=2)
        kv0, kvl = 0, KV
    else:
        kv0, kvl = lay.kv0 - split.kv0, lay.kvl
    slot = pos % L if spec.window else pos
    k_cache = _store_block(cache["k"], new[0], slot, lo, inplace)
    v_cache = _store_block(cache["v"], new[1], slot, lo, inplace)

    idx = lo + torch.arange(Ll, device=dev)
    p_row = pos[:, None] if vec else pos
    if spec.window:
        base = p_row - (p_row % L)
        cand = torch.where(idx <= (p_row % L), base + idx, base - L + idx)
        valid = (cand >= 0) & (cand <= p_row) & ((p_row - cand) < spec.window)
    else:
        valid = idx <= p_row
    vmask = (valid[:, None, None, None, :] if vec
             else valid[None, None, None, None, :])
    kc = k_cache[:, :, kv0:kv0 + kvl]
    vc = v_cache[:, :, kv0:kv0 + kvl]
    qg = q.reshape(B, 1, kvl, -1, hd)
    s = torch.einsum("btkgh,blkh->bkgtl", qg.to(torch.float32),
                     kc.to(torch.float32)) / math.sqrt(hd)
    if cfg.attn_logit_softcap is not None:
        s = cfg.attn_logit_softcap * torch.tanh(s / cfg.attn_logit_softcap)
    s = torch.where(vmask, s, NEG_INF)
    groups = ((sa.tp,) if split.model == "length" else ()) + \
        (sa.data if split.data else ())
    if groups:
        out = _split_softmax(s, lambda p: torch.einsum(
            "bkgtl,blkh->bkgth", p.to(vc.dtype).to(torch.float32),
            vc.to(torch.float32)), groups).to(vc.dtype)
        out = out.permute(0, 3, 1, 2, 4)            # (B, 1, kvl, g, hd)
    else:
        p = torch.softmax(s, dim=-1).to(vc.dtype)
        out = torch.einsum("bkgtl,blkh->btkgh", p, vc)
    out = out.reshape(B, 1, -1, hd)
    if split.model == "length":
        out = out[:, :, lay.h0:lay.h0 + lay.hl]
    out = out.reshape(B, 1, -1) @ params["wo"]
    return _heads_out(out, lay, sa), {"k": k_cache, "v": v_cache}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------
#
# Queries and keys have head dim qk_nope_dim + qk_rope_dim; the cache holds
# the normalized latent c_kv (kv_lora_rank) and one shared RoPE key per
# position.  The full-sequence paths up-project the latents to per-head
# K_nope and V, pad V to the q/k head dim so that one attention function
# applies (the softmax scale stays 1/sqrt(q/k head dim)), and crop.

def mla_desc(cfg: ModelConfig) -> Dict[str, ParamDesc]:
    d, H = cfg.d_model, cfg.num_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "wq": ParamDesc((d, H * qk), axes=("embed", "heads")),
        "w_dkv": ParamDesc((d, cfg.kv_lora_rank + cfg.qk_rope_dim),
                           axes=("embed", "lora")),
        "kv_norm": norm_desc(cfg.kv_lora_rank),
        "w_ukv": ParamDesc((cfg.kv_lora_rank,
                            H * (cfg.qk_nope_dim + cfg.v_head_dim)),
                           axes=("lora", "heads")),
        "wo": ParamDesc((H * cfg.v_head_dim, d), axes=("heads", "embed")),
    }


def _mla_qkv(params, cfg: ModelConfig, x, positions):
    """x (B, T, d) -> q_nope (B, T, H, nope), q_rope (B, T, H, rope) with
    RoPE, c_kv (B, T, lora) normalized, k_rope (B, T, 1, rope) with RoPE."""
    B, T, _ = x.shape
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = (x @ params["wq"]).reshape(B, T, -1, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    latent = x @ params["w_dkv"]
    c_kv = rmsnorm(params["kv_norm"], latent[..., :cfg.kv_lora_rank],
                   eps=cfg.norm_eps)
    k_rope = apply_rope(latent[..., None, cfg.kv_lora_rank:], positions,
                        cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def _mla_expand_kv(params, cfg: ModelConfig, c_kv):
    """Up-project latents (B, L, lora) to per-head K_nope and V (the heads
    of ``params["w_ukv"]``'s columns)."""
    B, L, _ = c_kv.shape
    nope, vdim = cfg.qk_nope_dim, cfg.v_head_dim
    kv = (c_kv @ params["w_ukv"]).reshape(B, L, -1, nope + vdim)
    return kv[..., :nope], kv[..., nope:]


def _mla_full_qkv(params, cfg: ModelConfig, x, positions):
    """The full-sequence q, k (B, T, H, nope + rope) and v padded to that
    head dim, plus the latents the cache keeps."""
    B, T, _ = x.shape
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, cfg, x, positions)
    k_nope, v = _mla_expand_kv(params, cfg, c_kv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, T, q.shape[2],
                                         cfg.qk_rope_dim)], dim=-1)
    v_p = torch.nn.functional.pad(v, (0, q.shape[-1] - cfg.v_head_dim))
    return q, k, v_p, c_kv, k_rope


def _mla_train(params, cfg: ModelConfig, x, positions):
    B, T, _ = x.shape
    q, k, v_p, _, _ = _mla_full_qkv(params, cfg, x, positions)
    out = flash_attention(q, k, v_p, causal=True)[..., :cfg.v_head_dim]
    return out.reshape(B, T, -1) @ params["wo"]


def mla_forward(params, cfg: ModelConfig, spec: LayerSpec, x, positions):
    """Full-sequence causal MLA (training), through the differentiable
    chunked attention.  Under ``sharding_ctx.train_region`` the rank's
    head block (``wq`` and ``w_ukv`` columns, ``wo`` rows) reads ``x``
    through ``tp_in`` and computes the whole latents and ``k_rope`` from
    ``w_dkv`` and ``kv_norm``, which every rank holds whole and reads
    only through its own heads (their replica edge, :func:`mla_edge_blocks`,
    sums their gradients); ``tp_out`` sums the ``wo`` partials, a replica
    block's muted.  Under ``blocked_region`` the control
    (``layers.Lanes``)."""
    lanes = train_lanes(lambda tp: head_ranks(cfg, tp))
    if lanes is None:
        return _mla_train(params, cfg, x, positions)
    ps = lanes.share(params, cfg, mla_desc(cfg), fanned=("w_dkv", "kv_norm"))
    outs = [_mla_train(p, cfg, xb, positions)
            for p, xb in zip(ps, lanes.enter(x))]
    mute = lanes.group is not None and head_layout(
        cfg, lanes.tp, lanes.ranks[0]).replica > 0
    return lanes.out(outs, mute)


def mla_edge_blocks(cfg: ModelConfig, tp: int, rank: int):
    """The replica edge of an MLA layer's leaves on rank ``rank`` of
    ``tp`` (as :func:`edge_blocks`): ``w_dkv`` and ``kv_norm``, whole on
    every rank, and the head block's ``wq`` / ``w_ukv`` columns and
    ``wo`` rows where several ranks hold it (H < tp)."""
    lay = head_layout(cfg, tp, rank)
    out = {"w_dkv": (1, 0), "kv_norm": (1, 0)}
    if lay.attn_tp < tp:
        out.update({name: (lay.attn_tp, lay.block)
                    for name in ("wq", "w_ukv", "wo")})
    return out


def mla_prefill(params, cfg: ModelConfig, spec: LayerSpec, x, positions,
                max_len: int):
    """Full-sequence MLA through ``ops.flash_attention`` (the Hopper kernel
    on CUDA: bf16 at q/k head dim 192 takes the wgmma route, v padded to
    192 as the reference pads it; f32 takes the SIMT route),
    emitting the latent cache ``{"c_kv": (B, max_len, lora), "k_rope":
    (B, max_len, 1, rope)}``.  Under ``serve_region`` the rank runs its
    head block (``wq``, ``w_ukv`` and ``wo`` cut by heads; ``w_dkv`` and
    ``kv_norm`` whole, so it computes the whole latents) with one
    all-reduce, and keeps its block of the latents' positions
    (:func:`_mla_share`), which needs no collective."""
    B, T, _ = x.shape
    q, k, v_p, c_kv, k_rope = _mla_full_qkv(params, cfg, x, positions)
    out = ops.flash_attention(q, k, v_p, causal=True)[..., :cfg.v_head_dim]
    out = out.reshape(B, T, -1) @ params["wo"]
    pad = max_len - T
    cache = {"c_kv": torch.nn.functional.pad(c_kv, (0, 0, 0, pad)),
             "k_rope": torch.nn.functional.pad(k_rope, (0, 0, 0, 0, 0, pad))}
    sa = serve_axes()
    if sa is None:
        return out, cache
    lay = head_layout(cfg, *_tp_of(sa))
    lo, Ll, _ = _mla_share(cfg, B, max_len, sa)
    cache = {k_: t.narrow(1, lo, Ll).contiguous() for k_, t in cache.items()}
    return _heads_out(out, lay, sa), cache


def _mla_share(cfg: ModelConfig, batch: int, max_len: int, sa):
    """(first position, positions, share) of the rank's block of MLA's
    latents: the reference's ``cache_spec`` splits them by length over
    the model axis where it divides and L >= 2048, and a batch-1 cache's
    length over the data axes too (``share`` None: whole)."""
    if max_len is None:
        raise ValueError("the serve region needs the cache's max_len")
    share = leaf_share("c_kv", (batch, max_len, cfg.kv_lora_rank), sa)
    if share is None:
        return 0, max_len, None
    Ll = max_len // share.parts
    return share.index * Ll, Ll, share


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype):
    return {"c_kv": TensorSpec((batch, max_len, cfg.kv_lora_rank), dtype),
            "k_rope": TensorSpec((batch, max_len, 1, cfg.qk_rope_dim), dtype)}


def mla_decode(params, cfg: ModelConfig, spec: LayerSpec, x, cache, pos,
               absorb: bool = False, inplace: bool = False):
    """One-token MLA decode against the latent cache; ``pos`` an int or a
    (B,) tensor of per-row positions, as :func:`attn_decode`.

    ``absorb=False`` up-projects every cached latent each step;
    ``absorb=True`` folds W_uk into the query and W_uv into the output, so
    that attention runs in the latent space without the (L, H, nope + v)
    expansion.  Returns (out, new cache); the input cache is not
    modified, unless ``inplace`` (the donated cache, written and
    returned).  Under ``serve_region`` the rank's share runs
    (:func:`_mla_decode_tp`)."""
    sa = serve_axes()
    if sa is not None:
        return _mla_decode_tp(params, cfg, x, cache, pos, absorb, inplace,
                              sa)
    B = x.shape[0]
    H, nope, rope = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    vdim = cfg.v_head_dim
    dev = x.device
    f32 = torch.float32
    vec = isinstance(pos, torch.Tensor) and pos.ndim == 1
    if vec:
        pos = pos.to(device=dev, dtype=torch.int64)
        positions = pos[:, None]
    else:
        pos = int(pos)
        positions = torch.full((B, 1), pos, dtype=torch.int64, device=dev)
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(params, cfg, x, positions)
    if vec:
        c_cache = _store_rows(cache["c_kv"], c_kv_new, pos, inplace)
        r_cache = _store_rows(cache["k_rope"], k_rope_new, pos, inplace)
    else:
        c_cache = _dynamic_store(cache["c_kv"], c_kv_new, pos, inplace)
        r_cache = _dynamic_store(cache["k_rope"], k_rope_new, pos, inplace)
    L = c_cache.shape[1]
    idx = torch.arange(L, device=dev)
    valid = ((idx[None, :] <= pos[:, None])[:, None, None, :] if vec
             else (idx <= pos)[None, None, None, :])

    w_ukv = params["w_ukv"].reshape(cfg.kv_lora_rank, H, nope + vdim)
    w_uk, w_uv = w_ukv[..., :nope], w_ukv[..., nope:]
    if absorb:
        q_lat = torch.einsum("bthn,lhn->bthl", q_nope, w_uk)
        s = torch.einsum("bthl,bLl->bhtL", q_lat.to(f32), c_cache.to(f32))
        s = s + torch.einsum("bthr,bLkr->bhtL", q_rope.to(f32),
                             r_cache.to(f32))
        s = s / math.sqrt(nope + rope)
        p = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
        o_lat = torch.einsum("bhtL,bLl->bthl", p.to(c_cache.dtype), c_cache)
        out = torch.einsum("bthl,lhv->bthv", o_lat, w_uv)
    else:
        k_nope, v = _mla_expand_kv(params, cfg, c_cache)    # (B, L, H, .)
        s = torch.einsum("bthn,bLhn->bhtL", q_nope.to(f32), k_nope.to(f32))
        s = s + torch.einsum("bthr,bLkr->bhtL", q_rope.to(f32),
                             r_cache.to(f32))
        s = s / math.sqrt(nope + rope)
        p = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
        out = torch.einsum("bhtL,bLhv->bthv", p.to(v.dtype), v)
    out = out.reshape(B, 1, H * vdim) @ params["wo"]
    return out, {"c_kv": c_cache, "k_rope": r_cache}


def _split_softmax(s, values, groups):
    """softmax(s) @ values where the keys of the scores ``s`` (..., L) lie
    split over the process ``groups`` (split-KV): the row maximum over
    every rank's keys, then the rank's weighted values ``values(p)`` (in
    f32, laid out as ``s`` without its key dim, then the value dim) and
    the sums under that maximum, all-reduced in f32 and divided."""
    from repro_torch.core.collectives.api import allreduce, allreduce_max
    m = allreduce_max(s.amax(dim=-1, keepdim=True).contiguous(), groups)
    p = torch.exp(s - m)
    both = torch.cat([values(p), p.sum(dim=-1, keepdim=True)], dim=-1)
    both = allreduce(both.contiguous(), "psum", groups)
    return both[..., :-1] / both[..., -1:]


def _mla_decode_tp(params, cfg: ModelConfig, x, cache, pos, absorb: bool,
                   inplace: bool, sa):
    """One-token MLA decode of a model-axis rank (see :func:`mla_decode`).
    The rank holds its head block of ``wq`` / ``w_ukv`` / ``wo`` and its
    block of the latents' positions (:func:`_mla_share`).  Where the
    latents are split over the model axis every rank holds positions of
    every head: the naive decode all-gathers ``w_ukv`` and the step's
    queries (one all-gather) and expands only its own positions; the
    absorbed decode all-gathers ``q_lat`` and the RoPE queries (one
    all-gather) and scores every head against its latents.  Both combine
    the partial softmaxes over the split's groups in f32
    (:func:`_split_softmax`) and keep the rank's heads.  Only the rank
    holding ``pos`` writes the new latent."""
    from repro_torch.core.collectives.api import all_gather
    B = x.shape[0]
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    vdim, lora = cfg.v_head_dim, cfg.kv_lora_rank
    dev = x.device
    f32 = torch.float32
    vec = isinstance(pos, torch.Tensor) and pos.ndim == 1
    if vec:
        pos = pos.to(device=dev, dtype=torch.int64)
        positions = pos[:, None]
    else:
        pos = int(pos)
        positions = torch.full((B, 1), pos, dtype=torch.int64, device=dev)
    q_nope, q_rope, c_new, r_new = _mla_qkv(params, cfg, x, positions)
    tp, rank = _tp_of(sa)
    lay = head_layout(cfg, tp, rank)
    lo, Ll, share = _mla_share(cfg, B, sa.max_len, sa)
    if cache["c_kv"].shape[1] != Ll:
        raise ValueError(f"the rank's latents are {tuple(cache['c_kv'].shape)}"
                         f"; its layout holds {Ll} positions")
    c_cache = _store_block(cache["c_kv"], c_new, pos, lo, inplace)
    r_cache = _store_block(cache["k_rope"], r_new, pos, lo, inplace)
    idx = lo + torch.arange(Ll, device=dev)
    valid = ((idx[None, :] <= pos[:, None])[:, None, None, :] if vec
             else (idx <= pos)[None, None, None, :])
    every = share is not None and share.model      # every head scores here
    groups = ((sa.tp,) if every else ()) + \
        (sa.data if share is not None and share.data else ())
    reps = [b * (tp // lay.attn_tp) for b in range(lay.attn_tp)]

    def heads_of(rows):
        """(tp, ..., hl, n) gathered rows -> (..., H, n), each head block
        from its first rank."""
        return torch.cat([rows[j] for j in reps], dim=-2)

    w_ukv = params["w_ukv"]
    scale = math.sqrt(nope + rope)
    if absorb:
        w = w_ukv.reshape(lora, -1, nope + vdim)
        w_uk, w_uv = w[..., :nope], w[..., nope:]
        q_lat = torch.einsum("bthn,lhn->bthl", q_nope, w_uk)
        q_all = torch.cat([q_lat, q_rope.to(q_lat.dtype)], dim=-1)
        if every:
            q_all = heads_of(all_gather(q_all.contiguous(), sa.tp))
        q_lat, q_rope = q_all[..., :lora], q_all[..., lora:]
        s = torch.einsum("bthl,bLl->bhtL", q_lat.to(f32), c_cache.to(f32))
        s = s + torch.einsum("bthr,bLkr->bhtL", q_rope.to(f32),
                             r_cache.to(f32))
        s = torch.where(valid, s / scale, NEG_INF)
        if groups:
            o_lat = _split_softmax(s, lambda p: torch.einsum(
                "bhtL,bLl->bhtl", p.to(c_cache.dtype).to(f32),
                c_cache.to(f32)), groups).to(c_cache.dtype).transpose(1, 2)
        else:
            p = torch.softmax(s, dim=-1)
            o_lat = torch.einsum("bhtL,bLl->bthl", p.to(c_cache.dtype),
                                 c_cache)
        if every:
            o_lat = o_lat[:, :, lay.h0:lay.h0 + lay.hl]
        out = torch.einsum("bthl,lhv->bthv", o_lat, w_uv)
    else:
        q = torch.cat([q_nope, q_rope], dim=-1)              # (B, 1, hl, .)
        if every:
            # one all-gather: the step's queries and w_ukv, side by side
            flat = torch.cat([q.reshape(-1), w_ukv.reshape(-1)])
            rows = all_gather(flat.contiguous(), sa.tp)
            nq = q.numel()
            q = heads_of(rows[:, :nq].reshape((tp,) + tuple(q.shape)))
            w_ukv = heads_of(rows[:, nq:].reshape(
                tp, lora, lay.hl, nope + vdim)).reshape(lora, -1)
        k_nope, v = _mla_expand_kv({"w_ukv": w_ukv}, cfg, c_cache)
        s = torch.einsum("bthn,bLhn->bhtL", q[..., :nope].to(f32),
                         k_nope.to(f32))
        s = s + torch.einsum("bthr,bLkr->bhtL", q[..., nope:].to(f32),
                             r_cache.to(f32))
        s = torch.where(valid, s / scale, NEG_INF)
        if groups:
            out = _split_softmax(s, lambda p: torch.einsum(
                "bhtL,bLhv->bhtv", p.to(v.dtype).to(f32), v.to(f32)),
                groups).to(v.dtype).transpose(1, 2)
        else:
            p = torch.softmax(s, dim=-1)
            out = torch.einsum("bhtL,bLhv->bthv", p.to(v.dtype), v)
        if every:
            out = out[:, :, lay.h0:lay.h0 + lay.hl]
    out = out.reshape(B, 1, -1) @ params["wo"]
    return _heads_out(out, lay, sa), {"c_kv": c_cache, "k_rope": r_cache}
