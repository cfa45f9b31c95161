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
from repro_torch.models.layers import (ParamDesc, TensorSpec, mlp, mlp_desc,
                                       norm_desc, rmsnorm, stack_desc)
from repro_torch.models.transformer import (_index, _stack, _unstack,
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
    memory and the weights."""
    B, S, _ = memory.shape
    dt = _promoted(memory, params["wk"])
    m = memory.to(dt)
    k = (m @ params["wk"].to(dt)).reshape(B, S, cfg.num_kv_heads, cfg.hd)
    v = (m @ params["wv"].to(dt)).reshape(B, S, cfg.num_kv_heads, cfg.hd)
    return k, v


def cross_attend(params, cfg: ModelConfig, x: torch.Tensor, k, v,
                 kernel: bool):
    """x: (B, T, d); k, v: (B, S, KV, hd).  No mask, no RoPE.  ``kernel``
    picks ``ops.flash_attention`` (inference) over the differentiable
    chunked attention (training)."""
    B, T, _ = x.shape
    q = (x @ params["wq"]).reshape(B, T, cfg.num_heads, cfg.hd)
    dt = _promoted(q, k)
    fn = ops.flash_attention if kernel else attn.flash_attention
    out = fn(q.to(dt), k.to(dt), v.to(dt), causal=False).to(x.dtype)
    return out.reshape(B, T, -1) @ params["wo"]


def dec_block_desc(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "norm1": norm_desc(cfg.d_model),
        "self": attn.attn_desc(cfg),
        "norm_x": norm_desc(cfg.d_model),
        "cross": cross_attn_desc(cfg),
        "norm2": norm_desc(cfg.d_model),
        "ffn": mlp_desc(cfg.d_model, cfg.d_ff),
    }


def _cross_ffn(params, cfg: ModelConfig, x, k, v, kernel: bool):
    """The block's tail after self-attention: cross-attention and FFN."""
    h = rmsnorm(params["norm_x"], x, eps=cfg.norm_eps)
    x = x + cross_attend(params["cross"], cfg, h, k, v, kernel)
    h = rmsnorm(params["norm2"], x, eps=cfg.norm_eps)
    return x + mlp(params["ffn"], h, cfg.activation)


def dec_block_train(params, cfg: ModelConfig, x, positions, memory):
    h = rmsnorm(params["norm1"], x, eps=cfg.norm_eps)
    x = x + attn.attn_forward(params["self"], cfg, CROSS_SPEC, h, positions)
    k, v = cross_kv(params["cross"], cfg, memory)
    return _cross_ffn(params, cfg, x, k, v, kernel=False)


def dec_block_prefill(params, cfg: ModelConfig, x, positions, memory,
                      max_len: int):
    h = rmsnorm(params["norm1"], x, eps=cfg.norm_eps)
    sa, self_cache = attn.attn_prefill(params["self"], cfg, CROSS_SPEC, h,
                                       positions, max_len)
    k, v = cross_kv(params["cross"], cfg, memory)
    x = _cross_ffn(params, cfg, x + sa, k, v, kernel=True)
    return x, {"self": self_cache, "cross_k": k, "cross_v": v}


def dec_block_cache(cfg: ModelConfig, batch: int, max_len: int,
                    src_len: int, dtype):
    self_cache = attn.init_attn_cache(cfg, CROSS_SPEC, batch, max_len, dtype)
    kv = TensorSpec((batch, src_len, cfg.num_kv_heads, cfg.hd), dtype)
    return {"self": self_cache, "cross_k": kv, "cross_v": kv}


def dec_block_decode(params, cfg: ModelConfig, x, cache, pos):
    h = rmsnorm(params["norm1"], x, eps=cfg.norm_eps)
    sa, self_cache = attn.attn_decode(params["self"], cfg, CROSS_SPEC, h,
                                      cache["self"], pos)
    x = _cross_ffn(params, cfg, x + sa, cache["cross_k"], cache["cross_v"],
                   kernel=True)
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
    for p in _unstack(params["enc_stack"], cfg.num_encoder_layers):
        def blk(h, p=p):
            pd = tree_map(lambda t: t.to(dt), p)
            return block_train(pd, cfg, CROSS_SPEC, h, positions, causal=False,
                               kernel=not training)[0]
        x = checkpointed(blk, x) if training else blk(x)
    return rmsnorm(params["enc_norm"], x, eps=cfg.norm_eps)


def decode_train(params, cfg: ModelConfig, x, positions, memory):
    for p in _unstack(params["dec_stack"], cfg.num_layers):
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


def decode_step_stack(params, cfg: ModelConfig, x, caches, pos):
    """One token through the decoder layers.  Returns (normed hidden, new
    cache); the cross K/V pass through unchanged, the input cache is not
    modified."""
    selfs = []
    for i in range(cfg.num_layers):
        x, c = dec_block_decode(_index(params["dec_stack"], i), cfg, x,
                                _index(caches, i), pos)
        selfs.append(c["self"])
    return (rmsnorm(params["dec_norm"], x, eps=cfg.norm_eps),
            {"self": _stack(selfs), "cross_k": caches["cross_k"],
             "cross_v": caches["cross_v"]})
