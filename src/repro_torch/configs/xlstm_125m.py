"""xLSTM-125M — sLSTM + mLSTM blocks (3:1), attention-free [arXiv:2405.04517]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,                 # xLSTM blocks carry their own up/down projections
    vocab_size=50304,
    slstm_every=4,          # layers 3, 7, 11 are sLSTM; others mLSTM
    mlstm_chunk=64,         # bounds per-chunk carry memory of the (dh, dh) matrix state
    subquadratic=True,      # O(1) recurrent state
)
