"""Config system: architecture configs, input shapes, layer stacking plans.

Every architecture is a ``ModelConfig`` in ``repro_torch.configs.<id>``;
``get_config(name)`` resolves them, ``reduced(cfg)`` builds the CPU-smoke
variant (2 layers, d_model<=512, <=4 experts) of the same family.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Layer specs & stacking plans
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LayerSpec:
    """One layer of the stack: a (token-)mixer plus an optional FFN."""
    mixer: str = "attn"           # attn | mla | mamba | slstm | mlstm
    window: Optional[int] = None  # sliding-window size; None = global attention
    ffn: str = "dense"            # dense | moe | none


@dataclass(frozen=True)
class Segment:
    """``repeats`` copies of a (possibly heterogeneous) ``period`` of layers.

    The port keeps the stacked layout: every parameter and cache leaf of a
    segment has a leading ``repeats`` axis, and the stack loops over it.
    """
    period: Tuple[LayerSpec, ...]
    repeats: int

    @property
    def num_layers(self) -> int:
        return len(self.period) * self.repeats


def plan_from_pattern(pattern: Sequence[LayerSpec], num_layers: int) -> Tuple[Segment, ...]:
    """Tile ``pattern`` to ``num_layers``, emitting a scanned segment for the
    divisible part plus an unrolled remainder segment."""
    p = len(pattern)
    reps, rem = divmod(num_layers, p)
    segs = []
    if reps:
        segs.append(Segment(tuple(pattern), reps))
    if rem:
        segs.append(Segment(tuple(pattern[:rem]), 1))
    return tuple(segs)


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # default: d_model // num_heads
    activation: str = "swiglu"        # swiglu | geglu
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    qk_norm: bool = False             # chameleon / gemma3
    attn_logit_softcap: Optional[float] = None   # gemma2: 50.0
    final_logit_softcap: Optional[float] = None  # gemma2: 30.0
    embed_scale: bool = False         # gemma family: x *= sqrt(d_model)
    norm_offset: bool = False         # gemma RMSNorm (1 + w)

    # attention pattern: e.g. ("local","global") alternating; "local" uses window
    attn_pattern: Tuple[str, ...] = ("global",)
    window_size: int = 4096

    # MoE
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                 # per-expert hidden; 0 -> use d_ff
    moe_every: int = 1                # MoE FFN every k-th layer (jamba: 2)
    moe_offset: int = 0               # phase of the MoE layers within the period
    first_dense: int = 0              # first N layers use dense FFN (deepseek-v2)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # MLA (deepseek-v2)
    use_mla: bool = False
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # SSM / hybrid
    ssm_d_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0              # 0 -> ceil(d_model/16)
    attn_every: int = 0               # jamba: attention layer every k-th (else mamba)
    attn_offset: int = 0              # index within period that is attention

    # xLSTM
    slstm_every: int = 0              # sLSTM every k-th layer (else mLSTM)
    mlstm_chunk: int = 256            # chunk length (both recurrence forms)
    mlstm_parallel: bool = False      # chunkwise-PARALLEL mLSTM (MXU matmuls)

    # encoder-decoder (audio)
    num_encoder_layers: int = 0
    is_encoder_decoder: bool = False
    # modality frontend stub: inputs are precomputed embeddings (B, S, d_model)
    embedding_inputs: bool = False

    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # sub-quadratic? (drives long_500k applicability)
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        return int(math.ceil(self.vocab_size / 256) * 256)

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or int(math.ceil(self.d_model / 16))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def layer_spec(self, i: int) -> LayerSpec:
        """Spec of layer ``i`` (decoder stack)."""
        if self.family == "ssm":  # xLSTM
            mixer = "slstm" if (self.slstm_every and i % self.slstm_every == self.slstm_every - 1) else "mlstm"
            return LayerSpec(mixer=mixer, ffn="none")
        if self.attn_every:  # hybrid (jamba)
            mixer = "attn" if i % self.attn_every == self.attn_offset else "mamba"
        elif self.use_mla:
            mixer = "mla"
        else:
            mixer = "attn"
        window = None
        if mixer == "attn" and self.attn_pattern:
            kind = self.attn_pattern[i % len(self.attn_pattern)]
            window = self.window_size if kind == "local" else None
        if (self.num_experts and i >= self.first_dense
                and i % self.moe_every == self.moe_offset % self.moe_every):
            ffn = "moe"
        else:
            ffn = "dense"
        return LayerSpec(mixer=mixer, window=window, ffn=ffn)

    def stack_plan(self) -> Tuple[Segment, ...]:
        """Group the per-layer specs into scannable segments."""
        specs = [self.layer_spec(i) for i in range(self.num_layers)]
        # find the shortest period that tiles the prefix-free part
        period = self._period_len()
        segs = []
        i = 0
        # leading irregular layers (e.g. deepseek-v2 first dense layer)
        while i < self.num_layers and i < self.first_dense:
            segs.append(Segment((specs[i],), 1))
            i += 1
        rest = specs[i:]
        if rest:
            p = period
            reps, rem = divmod(len(rest), p)
            if reps:
                segs.append(Segment(tuple(rest[:p]), reps))
            if rem:
                segs.append(Segment(tuple(rest[reps * p:]), 1))
        return tuple(segs)

    def _period_len(self) -> int:
        cands = [1]
        if len(self.attn_pattern) > 1:
            cands.append(len(self.attn_pattern))
        if self.attn_every:
            cands.append(self.attn_every)
        if self.num_experts and self.moe_every > 1:
            cands.append(self.moe_every)
        if self.slstm_every:
            cands.append(self.slstm_every)
        l = 1
        for c in cands:
            l = l * c // math.gcd(l, c)
        return l

    def num_params(self) -> int:
        """Analytic parameter count (exact for our implementation)."""
        from repro_torch.models.model import count_params  # lazy import
        return count_params(self)


def reduced(cfg: ModelConfig, seq_cap: int = 128) -> ModelConfig:
    """CPU-smoke variant of the same family: 2 layers, d_model<=512, <=4 experts."""
    d = min(cfg.d_model, 256)
    heads = min(cfg.num_heads, 4)
    kv = max(1, min(cfg.num_kv_heads, heads))
    upd = dict(
        name=cfg.name + "-reduced",
        num_layers=2 if not cfg.attn_every else min(cfg.num_layers, cfg.attn_every),
        d_model=d,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=64 if cfg.head_dim else None,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else cfg.d_ff,
        vocab_size=min(cfg.vocab_size, 1024),
        window_size=min(cfg.window_size, 32),
        param_dtype="float32",
        compute_dtype="float32",
    )
    if cfg.num_experts:
        upd.update(num_experts=4, top_k=min(cfg.top_k, 2),
                   moe_d_ff=min(cfg.moe_d_ff or cfg.d_ff, 128),
                   num_shared_experts=min(cfg.num_shared_experts, 1))
    if cfg.use_mla:
        upd.update(kv_lora_rank=64, qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32)
    if cfg.attn_every:
        upd.update(num_layers=cfg.attn_every)  # one full hybrid period
    if cfg.is_encoder_decoder:
        upd.update(num_encoder_layers=2)
    if cfg.family == "ssm":
        upd.update(num_layers=max(2, cfg.slstm_every or 2), mlstm_chunk=16)
    return dataclasses.replace(cfg, **upd)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    phase: str                # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
