"""MiniCPM3-4B — dense with MLA (multi-head latent attention).

[hf:openbmb/MiniCPM3-4B] 62L d_model=2560 40H d_ff=6400 vocab=73448,
MLA: q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32, v_head=64.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=6400,
    vocab_size=73448,
    attention="mla", q_lora_rank=768, kv_lora_rank=256,
    qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
    block_pattern=("attn",) * 2,   # 62 = 31 groups x 2
)
