"""Model/architecture configuration schema.

One dataclass covers the ten assigned architecture families (dense / MoE /
hybrid SSM / xLSTM / enc-dec audio / VLM).  Every field is static so configs
hash cleanly into jit caches.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                 # 0 → d_model // n_heads

    # --- attention ---------------------------------------------------------
    attention: str = "gqa"          # gqa | mla
    window: Optional[int] = None    # sliding-window size (SWA)
    rope_theta: float = 10_000.0
    # MLA (DeepSeek/MiniCPM3 style multi-head latent attention)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0              # routed experts (0 → dense FFN)
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0               # per-expert hidden dim (0 → d_ff)
    moe_every: int = 1              # MoE FFN every k-th layer (Jamba: 2)
    capacity_factor: float = 1.25

    # --- hybrid / SSM --------------------------------------------------------
    # mixer pattern within a layer group; scanned over n_layers/len(pattern)
    # entries: "attn" | "mamba" | "mlstm" | "slstm"
    block_pattern: Tuple[str, ...] = ("attn",)
    ssm_state_dim: int = 16
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0                # 0 → ceil(d_model / 16)

    # --- encoder-decoder / multimodal frontends ------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    frontend: Optional[str] = None  # "audio" | "vision" (stub embeddings)
    frontend_seq: int = 0           # frames / image patches fed to backbone

    # --- misc -----------------------------------------------------------------
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"         # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True
    scan_chunk: int = 1024          # SSM sequential-scan chunk length
    mlstm_chunk: int = 128          # mLSTM chunkwise-parallel chunk length
    attn_q_chunk: int = 256         # XLA-attention query streaming chunk
    scan_unroll: bool = False       # unroll layer-group scan (roofline runs)
    use_flash: Optional[bool] = None  # None → Pallas on TPU, XLA elsewhere
    mla_absorb: bool = False        # absorbed MLA decode (beyond-paper opt)
    kv_quant: bool = False          # int8 KV cache w/ per-vector scales

    # -------------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def group_size(self) -> int:
        return len(self.block_pattern)

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.group_size == 0, (
            f"{self.name}: n_layers {self.n_layers} not divisible by "
            f"pattern length {self.group_size}")
        return self.n_layers // self.group_size

    @property
    def sub_quadratic(self) -> bool:
        """Bounded per-token decode state (SSM/hybrid/windowed attention)."""
        kinds = set(self.block_pattern)
        if kinds <= {"mamba", "mlstm", "slstm"}:
            return True
        if "attn" in kinds and self.window is not None:
            return True  # SWA bounds the KV window
        return kinds.isdisjoint({"attn"})

    def decode_cache_len(self, seq_len: int) -> int:
        """Per-layer attention cache length for a decode cell."""
        if self.window is not None:
            return min(self.window, seq_len)
        return seq_len

    def param_count(self) -> int:
        """Analytic parameter count (for 6·N·D roofline math)."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        h, hk, dh = self.n_heads, self.n_kv_heads, self.head_dim
        for li in range(self.n_layers):
            kind = self.block_pattern[li % self.group_size]
            if kind == "attn":
                if self.attention == "mla":
                    qd = self.qk_nope_dim + self.qk_rope_dim
                    total += d * self.q_lora_rank
                    total += self.q_lora_rank * h * qd
                    total += d * (self.kv_lora_rank + self.qk_rope_dim)
                    total += self.kv_lora_rank * h * (self.qk_nope_dim
                                                      + self.v_head_dim)
                    total += h * self.v_head_dim * d
                else:
                    total += d * h * dh + 2 * d * hk * dh + h * dh * d
            elif kind == "mamba":
                din = self.ssm_expand * d
                total += d * 2 * din + din * self.ssm_conv_width
                dtr = self.dt_rank or -(-d // 16)
                total += din * (dtr + 2 * self.ssm_state_dim)
                total += dtr * din + din * self.ssm_state_dim + din
                total += din * d
            elif kind in ("mlstm", "slstm"):
                din = self.ssm_expand * d
                total += d * din * 4 + din * d  # q/k/v/gates + out proj
            # FFN
            if kind in ("mlstm", "slstm") or self.d_ff == 0:
                continue
            if self.is_moe and (li % self.moe_every == self.moe_every - 1):
                f = self.expert_d_ff
                total += d * self.n_experts  # router
                total += self.n_experts * 3 * d * f
                total += self.n_shared_experts * 3 * d * f
            else:
                total += 3 * d * self.d_ff
        if self.is_encoder_decoder:
            # encoder self-attn + FFN, decoder cross-attn
            enc = self.n_encoder_layers * (
                d * h * dh + 2 * d * hk * dh + h * dh * d + 3 * d * self.d_ff)
            cross = self.n_layers * (d * h * dh + 2 * d * hk * dh + h * dh * d)
            total += enc + cross
        return total

    def active_param_count(self) -> int:
        """Active (per-token) parameters — MoE counts top-k experts only."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        f = self.expert_d_ff
        n_moe_layers = sum(
            1 for li in range(self.n_layers)
            if self.block_pattern[li % self.group_size] not in
            ("mlstm", "slstm")
            and li % self.moe_every == self.moe_every - 1)
        inactive = (self.n_experts - self.experts_per_token)
        return self.param_count() - n_moe_layers * inactive * 3 * d * f
