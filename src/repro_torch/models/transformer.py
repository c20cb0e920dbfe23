"""Model composition: layers → a stack → a full LM.

Ports ``src/repro/models/transformer.py`` for every architecture family of
``ModelConfig``: decoder-only dense/GQA/SWA/MLA, MoE FFNs, hybrid
Mamba+attention groups (Jamba), xLSTM stacks, encoder-decoder with stub
audio frames (Whisper) and VLM token streams prefixed by stub patch
embeddings (InternVL2).  The reference stacks one group of
``cfg.block_pattern`` per ``lax.scan`` step over parameters carrying a
leading ``n_groups`` axis; here the layers are one ``nn.ModuleList`` in
order (layer ``g * group_size + i`` is the reference's
``decoder/layer_{i}[g]``, of kind ``block_pattern[i]``) run by a Python
loop, and a cache is a list of per-layer dicts in the same order.

``LM(cfg, generator, device)`` is the reference's ``init_lm`` and
``LM.forward`` its ``apply_lm``: ``tokens (B, S) → (logits (B, S, V)``
in float32, the new cache in ``prefill`` and ``decode``, the MoE metrics
summed over the layers``)``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.context import DeviceLike, resolve_device
from . import ssm, xlstm
from .layers import (MLA, MLP, Attention, Cache, RMSNorm, compute_dtype,
                     dense_param)
from .moe import METRICS, MoE

Metrics = Dict[str, torch.Tensor]


class Caches(list):
    """Per-layer decode caches in layer order; ``enc_out`` carries an
    encoder-decoder's encoder output from the prefill to every decode
    step (the reference's ``cache["enc_out"]``)."""

    enc_out: Optional[torch.Tensor] = None


def layer_has_moe(cfg: ModelConfig, i: int, kind: str) -> bool:
    """``i`` is the index in the block pattern, not the layer number."""
    if not cfg.is_moe or cfg.d_ff == 0 or kind in ("mlstm", "slstm"):
        return False
    return i % cfg.moe_every == cfg.moe_every - 1


def layer_has_ffn(cfg: ModelConfig, kind: str) -> bool:
    return cfg.d_ff > 0 and kind not in ("mlstm", "slstm")


_MIXERS = {"mamba": ssm.Mamba, "mlstm": xlstm.MLSTM, "slstm": xlstm.SLSTM}


class Layer(nn.Module):
    """One layer of kind ``block_pattern[i]``: its mixer, cross-attention
    in an encoder-decoder, then a MoE or SwiGLU FFN where it has one."""

    def __init__(self, cfg: ModelConfig, kind: str, i: int, cross: bool,
                 generator: torch.Generator, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.kind = kind
        if kind == "attn":
            mixer = MLA if cfg.attention == "mla" else Attention
        elif kind in _MIXERS:
            mixer = _MIXERS[kind]
        else:
            raise ValueError(kind)
        self.mixer = mixer(cfg, generator, dtype, device)
        self.cross = (Attention(cfg, generator, dtype, device) if cross
                      else None)
        if layer_has_moe(cfg, i, kind):
            self.ffn = MoE(cfg, generator, dtype, device)
        elif layer_has_ffn(cfg, kind):
            self.ffn = MLP(cfg, generator, dtype, device)
        else:
            self.ffn = None

    def forward(self, x, *, mode: str, cache: Optional[Cache], positions,
                enc_out=None, causal: bool = True, cache_len: int = 0):
        """→ (x, new cache, metrics or None)."""
        if isinstance(self.mixer, Attention):
            dx, new_cache = self.mixer(x, positions=positions, mode=mode,
                                       cache=cache, causal=causal,
                                       cache_len=cache_len)
        elif isinstance(self.mixer, MLA):
            dx, new_cache = self.mixer(x, positions=positions, mode=mode,
                                       cache=cache, cache_len=cache_len)
        else:
            dx, new_cache = self.mixer(x, mode=mode, cache=cache)
        x = x + dx
        if self.cross is not None:
            cdx, _ = self.cross(x, positions=positions, mode="train",
                                kv_source=enc_out, causal=False)
            x = x + cdx
        metrics = None
        if isinstance(self.ffn, MoE):
            dff, metrics = self.ffn(x)
            x = x + dff
        elif self.ffn is not None:
            x = x + self.ffn(x)
        return x, new_cache, metrics


def build_stack(cfg: ModelConfig, cross: bool, generator: torch.Generator,
                dtype: torch.dtype, device: torch.device) -> nn.ModuleList:
    return nn.ModuleList(
        Layer(cfg, kind, i, cross, generator, dtype, device)
        for _ in range(cfg.n_groups)
        for i, kind in enumerate(cfg.block_pattern))


def apply_stack(layers: nn.ModuleList, x, *, mode: str, caches, positions,
                enc_out=None, causal: bool = True, cache_len: int = 0,
                remat_group: int = 0):
    """→ (x, per-layer new caches, metrics summed over the layers).

    ``remat_group`` > 0 (training with ``cfg.remat``, grad enabled):
    each run of that many consecutive layers — one repetition of the
    block pattern, the reference's scan step under ``jax.checkpoint`` —
    keeps only its input for the backward pass and recomputes the rest.
    """
    def run(x, lo, hi):
        ncs, ms = [], []
        for j in range(lo, hi):
            x, nc, m = layers[j](
                x, mode=mode, cache=caches[j] if caches is not None else None,
                positions=positions, enc_out=enc_out, causal=causal,
                cache_len=cache_len)
            ncs.append(nc)
            ms.append(m)
        return x, ncs, ms

    aux = {k: torch.zeros((), dtype=torch.float32, device=x.device)
           for k in METRICS}
    new_caches = []
    step = remat_group or len(layers)
    for lo in range(0, len(layers), step):
        hi = min(lo + step, len(layers))
        if remat_group:
            x, ncs, ms = checkpoint(run, x, lo, hi, use_reentrant=False)
        else:
            x, ncs, ms = run(x, lo, hi)
        new_caches += ncs
        for m in ms:
            if m is not None:
                aux = {k: aux[k] + m[k] for k in METRICS}
    return x, new_caches, aux


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(
        cfg, n_layers=cfg.n_encoder_layers, block_pattern=("attn",),
        n_experts=0, window=None)


def remat_layers(cfg: ModelConfig) -> int:
    """Layers a rematerialized group holds: one repetition of the block
    pattern when ``cfg.remat`` is set and autograd records, else 0."""
    return cfg.group_size if cfg.remat and torch.is_grad_enabled() else 0


class LM(nn.Module):
    """The reference's LM with its parameters drawn from ``generator`` on
    ``device`` (``None``: the card), stored in ``param_dtype``: the
    compute dtype ``cfg.dtype`` by default (serving), float32 masters for
    training (``cfg.param_dtype``).  Leaves the reference uses uncast are
    float32 either way."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device: DeviceLike = None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        dev = resolve_device(device)
        dt = param_dtype or compute_dtype(cfg)
        self.cfg = cfg
        self.embed = dense_param((cfg.vocab_size, cfg.d_model), generator, dt,
                                 dev, fan_in=cfg.d_model)
        self.final_norm = RMSNorm(cfg.d_model, dt, dev)
        self.layers = build_stack(cfg, cfg.is_encoder_decoder, generator, dt,
                                  dev)
        self.lm_head = (None if cfg.tie_embeddings else
                        dense_param((cfg.d_model, cfg.vocab_size), generator,
                                    dt, dev))
        if cfg.is_encoder_decoder:
            self.encoder = build_stack(encoder_config(cfg), False, generator,
                                       dt, dev)
            self.enc_norm = RMSNorm(cfg.d_model, dt, dev)

    @classmethod
    def from_state_dict(cls, cfg: ModelConfig, state_dict,
                        device: DeviceLike = None) -> "LM":
        """The model with ``state_dict``'s weights (say, a trainer's
        float32 masters) on ``device``, stored in the compute dtype:
        built on the meta device, so no random weights are drawn first."""
        model = cls(cfg, torch.Generator(), "meta")
        model = model.to_empty(device=resolve_device(device))
        with torch.no_grad():
            model.load_state_dict(
                {k: v.detach() for k, v in state_dict.items()})
        return model

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def encode(self, frontend_embeds: torch.Tensor) -> torch.Tensor:
        """Audio frames (B, F, d) → encoder output: a non-causal stack run
        in ``train`` mode, as the reference's ``_encode``."""
        f = frontend_embeds.shape[1]
        pos = torch.arange(f, dtype=torch.int32, device=frontend_embeds.device)
        h, _, _ = apply_stack(self.encoder, frontend_embeds, mode="train",
                              caches=None, positions=pos, causal=False,
                              remat_group=remat_layers(
                                  encoder_config(self.cfg)))
        return self.enc_norm(h, self.cfg.norm_eps)

    def forward(self, tokens: torch.Tensor, *, mode: str = "train",
                cache: Optional[Caches] = None,
                positions: Optional[torch.Tensor] = None,
                frontend_embeds: Optional[torch.Tensor] = None,
                cache_len: int = 0, last_logit_only: bool = False,
                ) -> Tuple[torch.Tensor, Optional[Caches], Metrics]:
        """tokens (B, S) → (logits (B, S, V) float32, new cache, metrics).

        ``frontend_embeds``: audio frames (encoder-decoder) or image
        patches (VLM, prepended to the token stream).  ``positions``
        default to ``arange(S)`` (train/prefill) and must be given for
        decode.  ``last_logit_only``: serving prefill needs the final
        position's logits only, so the head runs on one row.
        """
        cfg = self.cfg
        dtype = compute_dtype(cfg)
        x = self.embed[tokens].to(dtype)

        enc_out = None
        if cfg.is_encoder_decoder:
            enc_out = (cache.enc_out if mode == "decode"
                       else self.encode(frontend_embeds.to(dtype)))
        elif cfg.frontend == "vision" and mode != "decode":
            # VLM: image patch embeddings prefix the token stream
            x = torch.cat([frontend_embeds.to(dtype), x], dim=1)
        if positions is None:
            positions = torch.arange(x.shape[1], dtype=torch.int32,
                                     device=x.device)

        x, layer_caches, aux = apply_stack(
            self.layers, x, mode=mode, caches=cache, positions=positions,
            enc_out=enc_out, cache_len=cache_len,
            remat_group=remat_layers(cfg) if mode == "train" else 0)

        if last_logit_only:
            x = x[:, -1:]
        x = self.final_norm(x, cfg.norm_eps)
        head = self.embed.T if cfg.tie_embeddings else self.lm_head
        logits = x @ head.to(dtype)
        new_cache = None
        if mode in ("prefill", "decode"):
            new_cache = Caches(layer_caches)
            new_cache.enc_out = enc_out
        return logits.to(torch.float32), new_cache, aux


def init_group_cache(cfg: ModelConfig, batch: int, cache_len: int,
                     dtype: torch.dtype, device: torch.device) -> Caches:
    """Empty decode cache of one group (one dict per pattern entry)."""
    out = Caches()
    for kind in cfg.block_pattern:
        if kind == "attn" and cfg.attention == "mla":
            mix: Cache = {
                "c_kv": torch.zeros((batch, cache_len, cfg.kv_lora_rank),
                                    dtype=dtype, device=device),
                "k_rope": torch.zeros((batch, 1, cache_len, cfg.qk_rope_dim),
                                      dtype=dtype, device=device),
                "pos": torch.full((cache_len,), -1, dtype=torch.int32,
                                  device=device),
                "cursor": 0}
        elif kind == "attn":
            length = cfg.decode_cache_len(cache_len)
            hk, dh = cfg.n_kv_heads, cfg.head_dim
            kv_dt = torch.int8 if cfg.kv_quant else dtype
            mix = {"k": torch.zeros((batch, hk, length, dh), dtype=kv_dt,
                                    device=device),
                   "v": torch.zeros((batch, hk, length, dh), dtype=kv_dt,
                                    device=device),
                   "pos": torch.full((length,), -1, dtype=torch.int32,
                                     device=device),
                   "cursor": 0}
            if cfg.kv_quant:
                for name in ("k_s", "v_s"):
                    mix[name] = torch.full((batch, hk, length, 1), 1e-8,
                                           dtype=torch.float32, device=device)
        elif kind == "mamba":
            mix = ssm.init_mamba_cache(cfg, batch, dtype, device)
        elif kind == "mlstm":
            mix = xlstm.init_mlstm_cache(cfg, batch, device)
        else:
            mix = xlstm.init_slstm_cache(cfg, batch, device)
        out.append(mix)
    return out


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype: torch.dtype, device: DeviceLike = None) -> Caches:
    """Empty decode cache of every layer, in layer order."""
    dev = resolve_device(device)
    return Caches(c for _ in range(cfg.n_groups)
                  for c in init_group_cache(cfg, batch, cache_len, dtype,
                                            dev))
