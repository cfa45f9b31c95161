"""Model facade of the port — counterpart of ``repro/models/model.py`` for
decoder-only stacks (attention / MLA / Mamba / xLSTM blocks with dense or
MoE FFNs) and the encoder-decoder (``cfg.is_encoder_decoder``; batches
carry ``"src"`` frame embeddings):

  * ``param_desc`` / ``init(generator, dtype)`` / ``partition_specs`` /
    ``partition_dims``
  * ``loss(params, batch)``                      (train; + the MoE aux loss)
  * ``prefill(params, batch, max_len)``          (inference prefill)
  * ``init_cache`` / ``decode_step(params, tokens, cache, pos,
    mla_absorb, moe_dispatch, inplace)``
  * ``abstract_params`` / ``input_specs(shape)`` /
    ``input_partition_specs(shape)``  (the dry run)

Under ``sharding_ctx.serve_region`` the prefill and the decode step run
the reference's serve layout over the model axis on the rank's share of
the parameters (``convert.serve_slice``): the embedding and the LM head
vocab-parallel (``layers.embed_tp`` / ``logits_tp``), the stack as
``transformer`` says (the encoder-decoder's as ``encdec`` says), the
cache laid out by
``input_partition_specs``' rule with the tp group's size as the model
axis' (``convert.cache_slice``).  Under ``sharding_ctx.train_region`` the
training loss runs the reference's train layout on the rank's share
(``convert.train_slice``) for every family: the vocab-parallel
embedding (``embed_tp`` with its autograd sum) and the vocab-parallel
cross-entropy (``layers.softmax_xent_tp``), the same loss on every rank
of the group, and the stack as ``transformer`` (the encoder-decoder's as
``encdec``) says; ``blocked_region`` runs its control.
:func:`train_edges` lists the leaves that take the replica edge.

The encoder-decoder keeps the reference's unused ``final_norm`` (its
decoder ends in ``dec_norm``), so that converted trees match.

Parameters are the JAX package's tree of tensors.  Cross-entropy is
computed in sequence chunks of ``XENT_CHUNK``, each checkpointed, so the
full (B, T, vocab) logits tensor is never kept for the backward.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._tree import tree_map, tree_map_with_path
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.layers import (ParamDesc, TensorSpec, desc_leaves,
                                       embed, embed_tp, embedding_desc, fan,
                                       logits_tp, materialize, norm_desc,
                                       partition_specs, rmsnorm,
                                       sharding_rules, softmax_xent,
                                       softmax_xent_blocked, softmax_xent_tp,
                                       tp_in)
from repro_torch.models.sharding_ctx import (blocked_tp, cache_leaf_spec,
                                             serve_axes, train_axes)

XENT_CHUNK = 512

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.plan = cfg.stack_plan()

    # -- parameters ---------------------------------------------------------

    def param_desc(self) -> Dict[str, Any]:
        cfg = self.cfg
        desc: Dict[str, Any] = {
            "embed": embedding_desc(cfg.padded_vocab, cfg.d_model),
            "final_norm": norm_desc(cfg.d_model),
        }
        if cfg.is_encoder_decoder:
            desc["encdec"] = encdec.encdec_desc(cfg)
        else:
            desc["stack"] = transformer.stack_desc_tree(cfg, self.plan)
        if not cfg.tie_embeddings:
            desc["lm_head"] = embedding_desc(cfg.padded_vocab, cfg.d_model)
        return desc

    def init(self, generator: Optional[torch.Generator] = None, dtype=None,
             device: DeviceLike = None, rows: Optional[slice] = None):
        """Random parameters drawn from ``generator`` (on its device).
        Without a generator, one seeded with 0 is made on ``device``
        (default: CUDA; raises when there is none).  ``rows`` keeps only
        those rows of every stack leaf, each leaf cut as soon as it is
        drawn: the values of the whole draw, without the other rows
        (one pipeline stage's, ``StagedModel.init_stage``)."""
        if generator is None:
            generator = torch.Generator(resolve_device(device)).manual_seed(0)
        dtype = dtype or resolve_dtype(self.cfg.param_dtype)
        desc = self.param_desc()
        if rows is None:
            return materialize(desc, generator, dtype)
        # the leaf order of materialize(desc): the keys sorted
        return {k: materialize(desc[k], generator, dtype,
                               post=(lambda x: x[rows].clone())
                               if k == "stack" else None)
                for k in sorted(desc)}

    def partition_specs(self, phase: str, multi_pod: bool = False):
        """Each leaf's mesh axes per dim under the reference's rules for
        ``phase`` (``layers.sharding_rules``): a tree of tuples, the
        reference's ``PartitionSpec``s."""
        return partition_specs(self.param_desc(),
                               sharding_rules(phase, multi_pod))

    def partition_dims(self, phase: str = "serve"):
        """Each leaf's dim on the model axis under ``phase``'s rules, or
        None for a leaf whole on every model-axis rank."""
        def dim(spec):
            return next((i for i, a in enumerate(spec) if a == "model"),
                        None)
        return tree_map(dim, self.partition_specs(phase),
                        is_leaf=lambda x: isinstance(x, tuple))

    def abstract_params(self, dtype=None, mode=None):
        """CPU fake tensors of ``param_desc``'s shapes in ``dtype`` (the
        reference's ``ShapeDtypeStruct`` stand-ins, concrete enough to run
        a step on with no storage): made under ``mode``, a
        ``FakeTensorMode`` (a new one when None), under which the step that
        reads them must run."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        dtype = dtype or resolve_dtype(self.cfg.param_dtype)
        mode = mode if mode is not None else FakeTensorMode()
        with mode:
            return tree_map(lambda d: torch.empty(d.shape, dtype=dtype,
                                                  device="cpu"),
                            self.param_desc(),
                            is_leaf=lambda x: isinstance(x, ParamDesc))

    # -- shared pieces ------------------------------------------------------

    def _embed(self, params, tokens):
        sa, ta = serve_axes(), train_axes()
        if sa is not None:
            x = embed_tp(params["embed"], tokens, scale=self.cfg.embed_scale,
                         d=self.cfg.d_model, group=sa.tp)
        elif ta is not None:
            x = embed_tp(params["embed"], tokens, scale=self.cfg.embed_scale,
                         d=self.cfg.d_model, group=ta.tp,
                         train_algo=ta.algo)
        else:
            x = embed(params["embed"], tokens, scale=self.cfg.embed_scale,
                      d=self.cfg.d_model)
        return x.to(resolve_dtype(self.cfg.compute_dtype))

    def _lm_table(self, params):
        return params["embed" if self.cfg.tie_embeddings else "lm_head"]["table"]

    def _logits(self, params, h):
        cfg = self.cfg
        sa = serve_axes()
        if sa is not None:
            return logits_tp(self._lm_table(params), h, sa.tp,
                             cfg.final_logit_softcap)
        return self._capped(h @ self._lm_table(params).T)

    def _backbone_train(self, params, batch):
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        if self.cfg.is_encoder_decoder:
            memory = encdec.encode(params["encdec"], self.cfg, batch["src"],
                                   training=True)
            h = encdec.decode_train(params["encdec"], self.cfg, x, positions,
                                    memory)
            return h, torch.zeros((), dtype=torch.float32, device=h.device)
        h, aux = transformer.stack_train(params["stack"], self.cfg,
                                         self.plan, x, positions)
        return rmsnorm(params["final_norm"], h, eps=self.cfg.norm_eps), aux

    def _capped(self, logits):
        cap = self.cfg.final_logit_softcap
        return cap * torch.tanh(logits / cap) if cap else logits

    def _chunk_nll(self, params, hc, lc):
        """(masked mean nll, label count) of one sequence chunk.  Under
        the train region the rank's vocabulary block of the logits and
        the vocab-parallel loss (``layers.softmax_xent_tp``), the whole
        logits never gathered; under ``blocked_region`` its control."""
        mc = lc >= 0
        labels = torch.clamp_min(lc, 0)
        ta, blocks = train_axes(), blocked_tp()
        table = self._lm_table(params)
        if ta is not None:
            logits = self._capped(tp_in(hc, ta.tp, ta.algo) @ table.T)
            nll = softmax_xent_tp(logits, labels, mc, ta.tp, ta.algo)
        elif blocks is not None:
            parts = [self._capped(hb @ t.contiguous().T) for hb, t in zip(
                fan(hc, blocks), torch.chunk(table, blocks, dim=0))]
            nll = softmax_xent_blocked(parts, labels, mc)
        else:
            nll = softmax_xent(self._logits(params, hc), labels, mc)
        return nll, torch.sum(mc.to(torch.float32))

    def _chunked_xent(self, params, h, labels):
        """h: (B, T, d); labels: (B, T).  Loops over T chunks, each
        checkpointed: the (B, c, vocab) logits are recomputed in the
        backward instead of kept."""
        T = h.shape[1]
        c = min(XENT_CHUNK, T)
        n = T // c
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        cnt = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(n):
            sl = slice(i * c, (i + 1) * c)
            nll, k = checkpoint(self._chunk_nll, params, h[:, sl],
                                labels[:, sl], use_reentrant=False)
            tot, cnt = tot + nll * k, cnt + k
        if T - n * c:
            nll, k = self._chunk_nll(params, h[:, n * c:], labels[:, n * c:])
            tot, cnt = tot + nll * k, cnt + k
        return tot / torch.clamp_min(cnt, 1.0)

    # -- training -----------------------------------------------------------

    def loss(self, params, batch):
        """Next-token LM loss plus ``router_aux_coef`` x the MoE aux loss
        (zero without MoE blocks).  Labels are tokens shifted left; the
        final position is masked with -1."""
        tokens = batch["tokens"]
        labels = torch.cat([tokens[:, 1:], -torch.ones_like(tokens[:, :1])],
                           dim=1)
        h, aux = self._backbone_train(params, batch)
        nll = self._chunked_xent(params, h, labels)
        return nll + self.cfg.router_aux_coef * aux

    # -- inference ----------------------------------------------------------

    def prefill(self, params, batch, max_len: Optional[int] = None):
        """batch: {"tokens": (B, T) int[, "src": (B, S, d) frames]}.
        Returns (last-token logits (B, 1, vocab), cache)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, T = tokens.shape
        max_len = max_len or T
        x = self._embed(params, tokens)
        positions = torch.arange(T, device=tokens.device)[None, :]
        if cfg.is_encoder_decoder:
            memory = encdec.encode(params["encdec"], cfg, batch["src"])
            h, cache = encdec.decode_prefill(params["encdec"], cfg, x,
                                             positions, memory, max_len)
        else:
            h, _, cache = transformer.stack_prefill(params["stack"], cfg,
                                                    self.plan, x, positions,
                                                    max_len)
            h = rmsnorm(params["final_norm"], h, eps=cfg.norm_eps)
        return self._logits(params, h[:, -1:]), cache

    def init_cache(self, batch: int, max_len: int, src_len: int = 0,
                   dtype=None):
        """TensorSpec tree of the decode cache (see
        ``transformer.materialize_cache`` for the zero tensors); the
        encoder-decoder's holds ``src_len`` cross entries per layer."""
        cfg = self.cfg
        dtype = dtype or resolve_dtype(cfg.compute_dtype)
        if cfg.is_encoder_decoder:
            one = encdec.dec_block_cache(cfg, batch, max_len, src_len, dtype)
            return tree_map(lambda s: TensorSpec((cfg.num_layers,) + s.shape,
                                                 s.dtype), one)
        return transformer.stack_cache(cfg, self.plan, batch, max_len, dtype)

    def decode_step(self, params, tokens, cache, pos, mla_absorb: bool = False,
                    moe_dispatch: bool = False, inplace: bool = False):
        """tokens: (B, 1) int; pos: an int (tokens already cached) or a
        (B,) int tensor of per-row depths (continuous batching).
        ``mla_absorb`` / ``moe_dispatch`` pick MLA's absorbed decode and
        the MoE capacity dispatch (``transformer.block_decode``).  Returns
        (logits (B, 1, vocab), new_cache); the input cache is not
        modified, unless ``inplace``: then the new entries are written
        into it and it is returned (the decode step's donated cache,
        ``launch/steps.make_decode_step(donate=True)``)."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        if cfg.is_encoder_decoder:
            h, new_cache = encdec.decode_step_stack(params["encdec"], cfg, x,
                                                    cache, pos, inplace)
            return self._logits(params, h), new_cache
        h, new_cache = transformer.stack_decode(params["stack"], cfg,
                                                self.plan, x, cache, pos,
                                                mla_absorb, moe_dispatch,
                                                inplace)
        h = rmsnorm(params["final_norm"], h, eps=cfg.norm_eps)
        return self._logits(params, h), new_cache


    # -- dry-run specs ------------------------------------------------------

    def input_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """TensorSpec stand-ins for every step-function input, the
        reference's shapes and dtypes: train / prefill ``{"tokens": (B, T)
        int32[, "src": (B, T, d) frames]}``; decode ``{"tokens": (B, 1)
        int32, "cache": <a T-entry cache>, "pos": () int32}``."""
        cfg = self.cfg
        B, T = shape.global_batch, shape.seq_len
        cdt = resolve_dtype(cfg.compute_dtype)
        if shape.phase in ("train", "prefill"):
            specs = {"tokens": TensorSpec((B, T), torch.int32)}
            if cfg.is_encoder_decoder:
                specs["src"] = TensorSpec((B, T, cfg.d_model), cdt)
            return specs
        src_len = T if cfg.is_encoder_decoder else 0
        return {"tokens": TensorSpec((B, 1), torch.int32),
                "cache": self.init_cache(B, T, src_len=src_len, dtype=cdt),
                "pos": TensorSpec((), torch.int32)}

    def input_partition_specs(self, shape: ShapeConfig,
                              multi_pod: bool = False, model_n: int = 16):
        """The mesh axes of ``input_specs(shape)``'s leaves, per dim (the
        reference's ``input_partition_specs``): the batch over the data
        axes where B > 1, and the decode cache by
        ``sharding_ctx.cache_leaf_spec`` (``model_n``: the model axis'
        size, the reference's 16)."""
        data = ("pod", "data") if multi_pod else ("data",)
        B = shape.global_batch
        batch_axis = (data if multi_pod else data[0]) if B > 1 else None
        if shape.phase in ("train", "prefill"):
            specs = {"tokens": (batch_axis, None)}
            if self.cfg.is_encoder_decoder:
                specs["src"] = (batch_axis, None, None)
            return specs
        cache = tree_map_with_path(
            lambda path, s: cache_leaf_spec(
                next((p for p in reversed(path) if isinstance(p, str)), ""),
                s.shape, B, model_n, data),
            self.init_cache(B, shape.seq_len, src_len=shape.seq_len
                            if self.cfg.is_encoder_decoder else 0))
        return {"tokens": (batch_axis, None), "cache": cache, "pos": ()}


def train_edges(cfg: ModelConfig, tp: int, rank: int):
    """The replica edge of the whole parameter tree on model-axis rank
    ``rank`` of ``tp``: the path of each subtree whose leaves take it
    (a block's ``mixer``; the encoder's attention, the decoder's
    ``self`` and ``cross``) -> leaf name -> (blocks, index)
    (``transformer.mixer_edges``)."""
    if cfg.is_encoder_decoder:
        e = transformer.mixer_edges(cfg, "attn", tp, rank)
        return {("encdec", "enc_stack", "mixer"): e,
                ("encdec", "dec_stack", "self"): e,
                ("encdec", "dec_stack", "cross"): e}
    return {("stack", i, j, "mixer"): transformer.mixer_edges(
        cfg, spec.mixer, tp, rank)
        for i, seg in enumerate(cfg.stack_plan())
        for j, spec in enumerate(seg.period)}


def count_params(cfg: ModelConfig) -> int:
    total = 0
    for d in desc_leaves(Model(cfg).param_desc()):
        n = 1
        for s in d.shape:
            n *= s
        total += n
    return total
