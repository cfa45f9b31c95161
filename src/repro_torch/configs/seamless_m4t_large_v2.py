"""SeamlessM4T-large v2 — encoder-decoder, multimodal (speech) [arXiv:2308.11596].

The mel-spectrogram + conformer feature extractor is the allowed modality
frontend STUB: ``input_specs()`` supplies precomputed frame embeddings of
shape (batch, frames, d_model) to the 24-layer text/decoder transformer.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,            # decoder layers
    num_encoder_layers=24,
    is_encoder_decoder=True,
    embedding_inputs=True,    # encoder consumes precomputed frame embeddings
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,        # padded to 256256 internally for TP divisibility
    activation="geglu",
)
