"""Qwen1.5/2-MoE A2.7B — 60 routed experts top-4 + 4 shared experts.

[hf:Qwen/Qwen1.5-MoE-A2.7B] 24L d_model=2048 16H (kv=16) expert d_ff=1408
vocab=151936. Shared-expert hidden = 4 x 1408 = 5632.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=151936,
    n_experts=60, experts_per_token=4, n_shared_experts=4, moe_d_ff=1408,
)
