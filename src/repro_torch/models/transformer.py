"""Model composition: attention layers → a stack → a decoder-only LM.

Ports the ``attn``-only part of ``src/repro/models/transformer.py``: dense
decoder-only LMs with GQA (and sliding-window) attention and SwiGLU FFNs,
with or without tied embeddings.  The reference stacks one group of
``cfg.block_pattern`` per ``lax.scan`` step over parameters carrying a
leading ``n_groups`` axis; here the layers are one ``nn.ModuleList`` in
order (layer ``g * group_size + i`` is the reference's
``decoder/layer_{i}[g]``) run by a Python loop, and a cache is a list of
per-layer dicts in the same order.

``LM(cfg, generator, device)`` is the reference's ``init_lm`` and
``LM.forward`` its ``apply_lm``: ``tokens (B, S) → logits
(B, S, V)`` in float32, plus the new cache in ``prefill`` and ``decode``.
Mixers, FFNs and frontends of later slices raise ``NotImplementedError``
naming their ROADMAP item.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..core.context import DeviceLike, resolve_device
from .layers import MLP, Attention, Cache, RMSNorm, compute_dtype, dense_param

Caches = List[Cache]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the parts of the reference this slice does not port."""
    later = []
    if cfg.attention == "mla":
        later.append("MLA attention: ROADMAP Queue 1 item 10b")
    if cfg.is_moe:
        later.append("MoE FFN: ROADMAP Queue 1 item 10c")
    mixers = sorted(set(cfg.block_pattern) - {"attn"})
    if mixers:
        later.append(f"{'/'.join(mixers)} mixers: ROADMAP Queue 1 item 10d")
    if cfg.is_encoder_decoder or cfg.frontend is not None:
        later.append("encoder-decoder and vision/audio frontends: ROADMAP "
                     "Queue 1 item 10e")
    if later:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet — " + "; ".join(later))


class Layer(nn.Module):
    """One decoder layer: attention mixer, then the SwiGLU FFN."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.mixer = Attention(cfg, generator, dtype, device)
        self.ffn = MLP(cfg, generator, dtype, device) if cfg.d_ff > 0 else None

    def forward(self, x, *, mode: str, cache: Optional[Cache], positions,
                cache_len: int = 0):
        dx, new_cache = self.mixer(x, positions=positions, mode=mode,
                                   cache=cache, cache_len=cache_len)
        x = x + dx
        if self.ffn is not None:
            x = x + self.ffn(x)
        return x, new_cache


class LM(nn.Module):
    """Decoder-only LM with the reference's parameters, in ``cfg.dtype``,
    drawn from ``generator`` on ``device`` (``None``: the card)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device: DeviceLike = None):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        dt = compute_dtype(cfg)
        self.cfg = cfg
        self.embed = dense_param((cfg.vocab_size, cfg.d_model), generator, dt,
                                 dev, fan_in=cfg.d_model)
        self.final_norm = RMSNorm(cfg.d_model, dt, dev)
        self.layers = nn.ModuleList(Layer(cfg, generator, dt, dev)
                                    for _ in range(cfg.n_layers))
        self.lm_head = (None if cfg.tie_embeddings else
                        dense_param((cfg.d_model, cfg.vocab_size), generator,
                                    dt, dev))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: torch.Tensor, *, mode: str = "train",
                cache: Optional[Caches] = None,
                positions: Optional[torch.Tensor] = None, cache_len: int = 0,
                last_logit_only: bool = False,
                ) -> Tuple[torch.Tensor, Optional[Caches]]:
        """tokens (B, S) → (logits (B, S, V) float32, new cache).

        ``positions`` default to ``arange(S)`` (train/prefill) and must be
        given for decode.  ``last_logit_only``: serving prefill needs the
        final position's logits only, so the head runs on one row.
        """
        cfg = self.cfg
        dtype = compute_dtype(cfg)
        b, s = tokens.shape
        x = self.embed[tokens].to(dtype)
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32, device=x.device)

        new_caches = []
        for i, layer in enumerate(self.layers):
            x, nc = layer(x, mode=mode,
                          cache=cache[i] if cache is not None else None,
                          positions=positions, cache_len=cache_len)
            new_caches.append(nc)

        if last_logit_only:
            x = x[:, -1:]
        x = self.final_norm(x, cfg.norm_eps)
        head = self.embed.T if cfg.tie_embeddings else self.lm_head
        logits = x @ head.to(dtype)
        new_cache = new_caches if mode in ("prefill", "decode") else None
        return logits.to(torch.float32), new_cache


def init_group_cache(cfg: ModelConfig, batch: int, cache_len: int,
                     dtype: torch.dtype, device: torch.device) -> Caches:
    """Empty decode cache of one group (one dict per pattern entry)."""
    check_supported(cfg)
    out = []
    for _ in cfg.block_pattern:
        length = cfg.decode_cache_len(cache_len)
        hk, dh = cfg.n_kv_heads, cfg.head_dim
        kv_dt = torch.int8 if cfg.kv_quant else dtype
        mix: Cache = {
            "k": torch.zeros((batch, hk, length, dh), dtype=kv_dt,
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
        out.append(mix)
    return out


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype: torch.dtype, device: DeviceLike = None) -> Caches:
    """Empty decode cache of every layer, in layer order."""
    dev = resolve_device(device)
    return [c for _ in range(cfg.n_groups)
            for c in init_group_cache(cfg, batch, cache_len, dtype, dev)]
