"""Whisper medium — encoder-decoder; conv frontend is a STUB.

[arXiv:2212.04356] 24+24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865.
``input_specs`` supplies precomputed mel-frame embeddings (B, 1500, d).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab_size=51865,
    is_encoder_decoder=True, n_encoder_layers=24,
    frontend="audio", frontend_seq=1500,
)
