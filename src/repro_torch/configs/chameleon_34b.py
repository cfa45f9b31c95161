"""Chameleon-34B — early-fusion VLM; VQ image tokens share the 65536 vocab,
so the backbone consumes token ids directly (the VQ tokenizer is the allowed
modality-frontend stub). QK-norm per the paper. [arXiv:2405.09818]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    activation="swiglu",
    qk_norm=True,
)
