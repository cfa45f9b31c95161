"""Encoder-decoder stack of SeamlessM4T-large-v2 — counterpart of
``repro/models/encdec.py``.

The speech frontend (mel-spectrogram + conformer feature extractor) is
the modality stub: the encoder consumes precomputed frame embeddings
(B, S, d_model).  The encoder is a bidirectional transformer, the decoder
a causal one with cross-attention over the encoder memory.  Decode caches
the self-attention K/V and the (constant) projected cross K/V.

Attention runs where the decoder-only stack runs it: at inference
(``encode``, ``decode_prefill``, ``decode_step_stack``) the encoder's
self-attention and every cross-attention go through
``kernels/ops.flash_attention`` with ``causal=False`` (the Hopper kernel
on CUDA; T = 1 at decode), the decoder's self-attention through
``attn_prefill`` / ``attn_decode``; in training through the
differentiable ``models/attention.flash_attention``.

Under ``sharding_ctx.serve_region`` every attention runs on the rank's
head block (H / tp heads; the encoder's and the decoder's self-attention
as ``transformer`` / ``attention`` run them), ``cross_kv`` computes the
rank's kv heads of the memory, the cross cache holds them (the
reference's ``cache_spec`` splits ``cross_k`` / ``cross_v`` on the kv-head
dim; where it keeps them whole the rank all-gathers the others), the
cross-attention's ``wo`` rows end in one all-reduce, and every FFN runs
its ffn slice (``mlp_tp``).  The frames are whole on every rank.

Under ``sharding_ctx.train_region`` training runs the same head blocks
with their backward: the encoder's bidirectional attention
(``attention.attn_forward``), the decoder's self-attention, the
cross-attention (:func:`cross_train`) reading the memory that entered
the model axis once (:func:`memory_in`), the FFNs on ``mlp_tp``, and the
replica edge over each stack's shared attention leaves.

dtype promotion, as the reference's ``jnp`` promotes: f32 frames against
bf16 weights run the encoder in f32 (each layer's weights upcast, which is
exact), so the memory and the cross K/V are f32; the cross-attention
casts q up to the memory's dtype and its output back to the decoder's.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch._tree import tree_map
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models.layers import (ParamDesc, TensorSpec, fan, mlp,
                                       mlp_desc, mlp_tp, muted, norm_desc,
                                       rmsnorm, stack_desc, tp_in, tp_out,
                                       tree_sum)
from repro_torch.models.sharding_ctx import (blocked_tp, leaf_share,
                                             serve_axes, train_axes)
from repro_torch.models.transformer import (_ffn, _index, _stack, _unstack,
                                            block_desc, block_train,
                                            checkpointed)

# the encoder's blocks and the decoder's self-attention: global attention
# with a dense FFN
CROSS_SPEC = LayerSpec(mixer="attn", window=None, ffn="dense")


def _promoted(a: torch.Tensor, b: torch.Tensor) -> torch.dtype:
    return torch.promote_types(a.dtype, b.dtype)


def cross_attn_desc(cfg: ModelConfig) -> Dict[str, ParamDesc]:
    d, hd = cfg.d_model, cfg.hd
    return {
        "wq": ParamDesc((d, cfg.num_heads * hd), axes=("embed", "heads")),
        "wk": ParamDesc((d, cfg.num_kv_heads * hd), axes=("embed", "kv")),
        "wv": ParamDesc((d, cfg.num_kv_heads * hd), axes=("embed", "kv")),
        "wo": ParamDesc((cfg.num_heads * hd, d), axes=("heads", "embed")),
    }


def cross_kv(params, cfg: ModelConfig, memory: torch.Tensor):
    """The memory's cross K, V (B, S, KV, hd) in the promoted dtype of the
    memory and the weights (the kv heads of ``params``' columns: a
    model-axis rank's)."""
    B, S, _ = memory.shape
    dt = _promoted(memory, params["wk"])
    m = memory.to(dt)
    k = (m @ params["wk"].to(dt)).reshape(B, S, -1, cfg.hd)
    v = (m @ params["wv"].to(dt)).reshape(B, S, -1, cfg.hd)
    return k, v


def cross_split(cfg: ModelConfig, batch: int, src_len: int, sa):
    """The rank's share of the cross cache (``attention.CacheSplit``):
    its kv heads where the reference's ``cache_spec`` splits
    ``cross_k`` / ``cross_v`` on them, else every kv head; a cross cache
    split by length (KV not divisible by tp and S >= 2048, or batch 1
    and S >= 4096) raises: no registered shape gives one."""
    KV = cfg.num_kv_heads
    share = leaf_share("cross_k", (batch, src_len, KV, cfg.hd), sa)
    lay = attn.head_layout(cfg, *attn._tp_of(sa))
    if share is None:
        return lay, attn.CacheSplit(src_len, None, False, 1, 0, 0, KV)
    if share.dim == 2 and not share.data:
        return lay, attn.CacheSplit(src_len, "kv", False, 1, 0, lay.kv0,
                                    lay.kvl)
    raise NotImplementedError(
        f"{cfg.name}: the cross cache of {src_len} entries split by length "
        f"({share}) is not run over the model axis; the port runs it split "
        f"by kv heads or whole")


def cross_attend(params, cfg: ModelConfig, x: torch.Tensor, k, v,
                 kernel: bool):
    """x: (B, T, d); k, v: (B, S, KV, hd).  No mask, no RoPE.  ``kernel``
    picks ``ops.flash_attention`` (inference) over the differentiable
    chunked attention (training).  Under ``serve_region`` the rank's
    heads (``params``' columns) attend the kv heads they read (``k`` /
    ``v``: the rank's cross cache, :func:`cross_split`), and one
    all-reduce sums the ``wo`` partials."""
    B, T, _ = x.shape
    q = (x @ params["wq"]).reshape(B, T, -1, cfg.hd)
    sa = serve_axes() if kernel else None
    if sa is not None:
        lay, split = cross_split(cfg, B, k.shape[1], sa)
        lo = lay.kv0 - split.kv0
        k, v = k[:, :, lo:lo + lay.kvl], v[:, :, lo:lo + lay.kvl]
    dt = _promoted(q, k)
    fn = ops.flash_attention if kernel else attn.flash_attention
    out = fn(q.to(dt), k.to(dt), v.to(dt), causal=False).to(x.dtype)
    out = out.reshape(B, T, -1) @ params["wo"]
    return out if sa is None else attn._heads_out(out, lay, sa)


def dec_block_desc(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "norm1": norm_desc(cfg.d_model),
        "self": attn.attn_desc(cfg),
        "norm_x": norm_desc(cfg.d_model),
        "cross": cross_attn_desc(cfg),
        "norm2": norm_desc(cfg.d_model),
        "ffn": mlp_desc(cfg.d_model, cfg.d_ff),
    }


def _cross_ffn(params, cfg: ModelConfig, x, k, v):
    """The block's tail after self-attention at inference: cross-attention
    and FFN."""
    h = rmsnorm(params["norm_x"], x, eps=cfg.norm_eps)
    x = x + cross_attend(params["cross"], cfg, h, k, v, kernel=True)
    h = rmsnorm(params["norm2"], x, eps=cfg.norm_eps)
    sa = serve_axes()
    if sa is not None:
        return x + mlp_tp(params["ffn"], h, cfg.activation, group=sa.tp)
    return x + mlp(params["ffn"], h, cfg.activation)


def _cross_train(params, cfg: ModelConfig, x, memory):
    """Training's cross-attention of ``x`` over ``memory``, on the heads
    of ``params``' columns."""
    k, v = cross_kv(params, cfg, memory)
    return cross_attend(params, cfg, x, k, v, kernel=False)


def cross_train(params, cfg: ModelConfig, x, memory):
    """Training's cross-attention; under ``sharding_ctx.train_region`` the
    rank's head block (``wq`` by heads, ``wk`` / ``wv`` by kv heads,
    ``wo`` by rows) reads ``x`` through ``tp_in`` and ``memory`` as the
    decoder's stack gives it (``memory`` entered the model axis once,
    :func:`memory_in`), its ``wo`` partial summed by ``tp_out`` (muted on
    a replica block); under ``blocked_region`` the control, ``memory``
    one view a head block."""
    ta = train_axes()
    if ta is not None:
        lay = attn.head_layout(cfg, *attn._tp_of(ta))
        out = _cross_train(params, cfg, tp_in(x, ta.tp, ta.algo), memory)
        return tp_out(muted(out, lay.replica > 0), ta.tp, ta.algo)
    tp = blocked_tp()
    if tp is not None:
        lanes = attn.head_lanes(params, cfg, tp)
        return tree_sum([_cross_train(p, cfg, xb, mb) for p, xb, mb in
                         zip(lanes, fan(x, len(lanes)), memory)])
    return _cross_train(params, cfg, x, memory)


def memory_in(memory: torch.Tensor, cfg: ModelConfig):
    """The encoder's memory as the decoder's cross-attentions read it:
    under the train layout through one ``tp_in`` (every decoder layer's
    split ``wk`` / ``wv`` read it, so its cotangent, summed over the
    layers first, is the rank's partial: one all-reduce, not one a
    layer); under ``blocked_region`` one :func:`fan` view a head block
    (a tuple); else itself."""
    ta = train_axes()
    if ta is not None:
        return tp_in(memory, ta.tp, ta.algo)
    tp = blocked_tp()
    if tp is not None:
        return fan(memory, len(attn.head_ranks(cfg, tp)))
    return memory


def dec_block_train(params, cfg: ModelConfig, x, positions, memory):
    h = rmsnorm(params["norm1"], x, eps=cfg.norm_eps)
    x = x + attn.attn_forward(params["self"], cfg, CROSS_SPEC, h, positions)
    h = rmsnorm(params["norm_x"], x, eps=cfg.norm_eps)
    x = x + cross_train(params["cross"], cfg, h, memory)
    return _ffn(params, cfg, CROSS_SPEC, x, train=train_axes(),
                blocked=blocked_tp())[0]


def dec_block_prefill(params, cfg: ModelConfig, x, positions, memory,
                      max_len: int):
    h = rmsnorm(params["norm1"], x, eps=cfg.norm_eps)
    a, self_cache = attn.attn_prefill(params["self"], cfg, CROSS_SPEC, h,
                                      positions, max_len)
    k, v = cross_kv(params["cross"], cfg, memory)
    sa = serve_axes()
    if sa is not None:
        # the rank's cross cache: its kv heads, or every one gathered
        B, S = memory.shape[:2]
        lay, split = cross_split(cfg, B, S, sa)
        kv = attn._to_decode_layout(torch.stack([k, v]), cfg, lay, split, sa)
        k, v = kv[0], kv[1]
    x = _cross_ffn(params, cfg, x + a, k, v)
    return x, {"self": self_cache, "cross_k": k, "cross_v": v}


def dec_block_cache(cfg: ModelConfig, batch: int, max_len: int,
                    src_len: int, dtype):
    self_cache = attn.init_attn_cache(cfg, CROSS_SPEC, batch, max_len, dtype)
    kv = TensorSpec((batch, src_len, cfg.num_kv_heads, cfg.hd), dtype)
    return {"self": self_cache, "cross_k": kv, "cross_v": kv}


def dec_block_decode(params, cfg: ModelConfig, x, cache, pos,
                     inplace: bool = False):
    h = rmsnorm(params["norm1"], x, eps=cfg.norm_eps)
    sa, self_cache = attn.attn_decode(params["self"], cfg, CROSS_SPEC, h,
                                      cache["self"], pos, inplace=inplace)
    x = _cross_ffn(params, cfg, x + sa, cache["cross_k"], cache["cross_v"])
    return x, {"self": self_cache, "cross_k": cache["cross_k"],
               "cross_v": cache["cross_v"]}


# ---------------------------------------------------------------------------
# Stacks (uniform layers, every leaf stacked over the layers)
# ---------------------------------------------------------------------------

def encdec_desc(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "enc_stack": stack_desc(block_desc(cfg, CROSS_SPEC),
                                cfg.num_encoder_layers),
        "enc_norm": norm_desc(cfg.d_model),
        "dec_stack": stack_desc(dec_block_desc(cfg), cfg.num_layers),
        "dec_norm": norm_desc(cfg.d_model),
    }


def encode(params, cfg: ModelConfig, src: torch.Tensor,
           training: bool = False) -> torch.Tensor:
    """src: (B, S, d) precomputed frame embeddings (the frontend stub).
    Runs in the promoted dtype of ``src`` and the weights.  ``training``
    checkpoints every layer and takes the differentiable attention;
    otherwise the encoder's attention is ``ops.flash_attention``."""
    S = src.shape[1]
    dt = _promoted(src, params["enc_norm"]["scale"])
    positions = torch.arange(S, device=src.device)[None, :]
    x = src.to(dt)
    stack = params["enc_stack"]
    ta = train_axes() if training else None
    if ta is not None:
        # the replica edge on each stacked attention leaf, once a step
        stack = dict(stack, mixer=attn.attn_replica_edge(stack["mixer"], cfg,
                                                         ta))
    for p in _unstack(stack, cfg.num_encoder_layers):
        def blk(h, p=p):
            pd = tree_map(lambda t: t.to(dt), p)
            return block_train(pd, cfg, CROSS_SPEC, h, positions, causal=False,
                               kernel=not training)[0]
        x = checkpointed(blk, x) if training else blk(x)
    return rmsnorm(params["enc_norm"], x, eps=cfg.norm_eps)


def decode_train(params, cfg: ModelConfig, x, positions, memory):
    """The decoder stack (training), each layer checkpointed.  Under the
    train layout the self- and cross-attention leaves that ranks share
    take the replica edge once a step, and ``memory`` enters the model
    axis once (:func:`memory_in`)."""
    stack = params["dec_stack"]
    ta = train_axes()
    if ta is not None:
        stack = dict(stack, **{k: attn.attn_replica_edge(stack[k], cfg, ta)
                               for k in ("self", "cross")})
    memory = memory_in(memory, cfg)
    for p in _unstack(stack, cfg.num_layers):
        def blk(h, p=p):
            return dec_block_train(p, cfg, h, positions, memory)
        x = checkpointed(blk, x)
    return rmsnorm(params["dec_norm"], x, eps=cfg.norm_eps)


def decode_prefill(params, cfg: ModelConfig, x, positions, memory,
                   max_len: int):
    """Returns (normed hidden, cache stacked over the decoder layers)."""
    caches = []
    for i in range(cfg.num_layers):
        x, c = dec_block_prefill(_index(params["dec_stack"], i), cfg, x,
                                 positions, memory, max_len)
        caches.append(c)
    return rmsnorm(params["dec_norm"], x, eps=cfg.norm_eps), _stack(caches)


def decode_step_stack(params, cfg: ModelConfig, x, caches, pos,
                      inplace: bool = False):
    """One token through the decoder layers.  Returns (normed hidden, new
    cache); the cross K/V pass through unchanged, the input cache is not
    modified, unless ``inplace``: then each layer's self-attention entry
    is written into its row of ``caches`` itself (a view of the stacked
    leaf), and ``caches`` is returned — the reference's donated cache,
    held once."""
    selfs = []
    for i in range(cfg.num_layers):
        x, c = dec_block_decode(_index(params["dec_stack"], i), cfg, x,
                                _index(caches, i), pos, inplace)
        selfs.append(c["self"])
    h = rmsnorm(params["dec_norm"], x, eps=cfg.norm_eps)
    if inplace:
        return h, caches
    return h, {"self": _stack(selfs), "cross_k": caches["cross_k"],
               "cross_v": caches["cross_v"]}
