"""InternVL2 76B — VLM; InternViT frontend is a STUB (patch embeddings).

[arXiv:2404.16821] 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256
(LLaMA-3-70B backbone). ``input_specs`` supplies patch embeddings
(B, 256, d) prefixing the token stream.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab_size=128256, rope_theta=5e5,
    frontend="vision", frontend_seq=256,
)
