"""xLSTM 125M — sLSTM + mLSTM blocks (attention-free).

[arXiv:2405.04517] 12L d_model=768 4H vocab=50304, d_ff=0 (blocks carry
their own up/down projections).  3:1 mLSTM:sLSTM interleave.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=50304, tie_embeddings=True,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    ssm_expand=2,
)
