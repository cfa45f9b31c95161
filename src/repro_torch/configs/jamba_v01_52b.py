"""Jamba v0.1 52B — Mamba:attention 7:1 interleave, MoE 16e top-2 every other
layer [arXiv:2403.19887]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    activation="swiglu",
    attn_every=8,            # one attention layer per 8-layer Jamba block
    attn_offset=3,
    num_experts=16,
    top_k=2,
    moe_d_ff=14336,
    moe_every=2,             # MoE replaces the MLP on every other layer
    moe_offset=1,
    ssm_d_state=16,
    ssm_conv=4,
    ssm_expand=2,
    subquadratic=True,       # only 4/32 layers carry KV caches
)
