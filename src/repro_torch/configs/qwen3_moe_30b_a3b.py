"""Qwen3-MoE 30B-A3B — 128 experts, top-8, QK-norm [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    activation="swiglu",
    qk_norm=True,
    rope_theta=1000000.0,
    num_experts=128,
    top_k=8,
    moe_d_ff=768,
    moe_every=1,
)
