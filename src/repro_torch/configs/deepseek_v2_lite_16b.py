"""DeepSeek-V2-Lite 16B — MLA (kv_lora=512), 2 shared + 64 routed top-6 [arXiv:2405.04434]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    activation="swiglu",
    use_mla=True,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    num_experts=64,
    top_k=6,
    num_shared_experts=2,
    moe_d_ff=1408,
    moe_every=1,
    first_dense=1,
)
