"""Gemma-3 4B — 5:1 local:global attention, 128k context [hf:google/gemma-3-1b-pt family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    activation="geglu",
    qk_norm=True,
    attn_pattern=("local", "local", "local", "local", "local", "global"),
    window_size=1024,
    embed_scale=True,
    norm_offset=True,
    rope_theta=1000000.0,
    subquadratic=True,  # only 1/6 layers carry a full-length KV cache
)
