"""Architecture registry: the ten assigned configs + shape cells.

``get_config(arch_id)`` returns the full published config;
``reduced_config(cfg)`` shrinks it family-preservingly for CPU smoke tests
(same block pattern / attention type / MoE topology, tiny dims).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from .base import ModelConfig

from .jamba_v01_52b import CONFIG as _jamba
from .mixtral_8x7b import CONFIG as _mixtral
from .qwen2_moe_a27b import CONFIG as _qwen2moe
from .deepseek_67b import CONFIG as _deepseek
from .minicpm3_4b import CONFIG as _minicpm3
from .phi3_mini_38b import CONFIG as _phi3
from .smollm_360m import CONFIG as _smollm
from .xlstm_125m import CONFIG as _xlstm
from .whisper_medium import CONFIG as _whisper
from .internvl2_76b import CONFIG as _internvl2

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in (
        _jamba, _mixtral, _qwen2moe, _deepseek, _minicpm3, _phi3, _smollm,
        _xlstm, _whisper, _internvl2)
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHS)}")
    return ARCHS[arch_id]


def list_archs():
    return sorted(ARCHS)


# ---------------------------------------------------------------------------
# shape cells (assigned input shapes)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def cell_is_runnable(cfg: ModelConfig, shape: ShapeCell) -> Tuple[bool, str]:
    """Whether an (arch × shape) cell runs, per the assignment's skip rules."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("long_500k needs sub-quadratic attention; "
                       f"{cfg.name} is pure full-attention (see DESIGN.md)")
    return True, ""


# ---------------------------------------------------------------------------
# reduced configs for smoke tests
# ---------------------------------------------------------------------------
def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving tiny config: one pattern group, small dims."""
    n_heads = min(cfg.n_heads, 4)
    # preserve the GQA grouping ratio where possible
    ratio = max(1, cfg.n_heads // cfg.n_kv_heads)
    n_kv = max(1, n_heads // ratio)
    n_heads = n_kv * ratio
    d_head = 16
    d_model = max(n_heads * d_head, 32)
    updates = dict(
        n_layers=cfg.group_size * (2 if cfg.n_layers >= 2 * cfg.group_size
                                   else 1),
        d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv, d_head=d_head,
        d_ff=0 if cfg.d_ff == 0 else 4 * d_model,
        vocab_size=128,
        scan_chunk=32,
    )
    if cfg.is_moe:
        updates.update(n_experts=min(cfg.n_experts, 4),
                       experts_per_token=min(cfg.experts_per_token, 2),
                       moe_d_ff=2 * d_model if cfg.moe_d_ff else 0,
                       n_shared_experts=min(cfg.n_shared_experts, 1))
    if cfg.attention == "mla":
        updates.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                       qk_rope_dim=8, v_head_dim=16)
    if cfg.window is not None:
        updates.update(window=32)
    if cfg.is_encoder_decoder:
        updates.update(n_encoder_layers=2)
    if cfg.frontend is not None:
        updates.update(frontend_seq=8)
    return dataclasses.replace(cfg, **updates)
