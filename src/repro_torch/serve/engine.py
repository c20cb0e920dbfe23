"""Serving engine: batched prefill + lockstep decode with KV caches.

Ports ``src/repro/serve/engine.py`` for every model of
``repro_torch.models``.  The prefill builds each layer's cache (full KV,
a sliding-window ring, the MLA latent, Mamba conv + SSM state, xLSTM
matrix or scalar state; an encoder-decoder's cache also carries the
encoder output) and the decode loop steps every sequence in lockstep
(equal lengths), writing one token per layer into the KV and latent
caches in place.  A VLM's image patches prefix the prompt, so its decode
positions start after them.  Everything runs eagerly under
``torch.inference_mode()``; the steps are the model's own forward, no
``jit`` stands between.

Greedy decoding is ``argmax`` (the first index wins ties, as in
``jnp.argmax``).  Sampling at a temperature draws from a
``torch.Generator``; its numbers are not ``jax.random``'s.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..models.transformer import LM, Caches


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 512
    temperature: float = 0.0          # 0 → greedy
    eos_id: int = -1                  # -1 → never stop early


def make_prefill_step(model: LM, cache_len: int):
    def prefill(tokens: torch.Tensor,
                frontend_embeds: Optional[torch.Tensor] = None):
        logits, cache, _ = model(tokens, mode="prefill", cache_len=cache_len,
                                 frontend_embeds=frontend_embeds,
                                 last_logit_only=True)
        return logits[:, -1], cache

    return prefill


def make_decode_step(model: LM, temperature: float = 0.0):
    def decode(cache: Caches, token: torch.Tensor, pos: torch.Tensor,
               generator: Optional[torch.Generator] = None):
        logits, new_cache, _ = model(token, mode="decode", cache=cache,
                                     positions=pos.reshape(1))
        return sample(logits[:, -1], generator, temperature), new_cache

    return decode


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
           temperature: float = 0.0) -> torch.Tensor:
    """(B, V) logits → (B, 1) int32 tokens."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)


class Engine:
    """Batched generation over a model's prefill and decode steps."""

    def __init__(self, model: LM, serve_cfg: ServeConfig):
        self.model = model
        self.scfg = serve_cfg
        self._prefill = make_prefill_step(model, serve_cfg.max_len)
        self._decode = make_decode_step(model, serve_cfg.temperature)

    def _tokens(self, prompts) -> torch.Tensor:
        return torch.as_tensor(np.asarray(prompts), dtype=torch.int32).to(
            self.model.device)

    def _frontend(self, frontend_embeds) -> Optional[torch.Tensor]:
        if frontend_embeds is None:
            return None
        return torch.as_tensor(frontend_embeds).to(self.model.device)

    @torch.inference_mode()
    def prefill(self, prompts, frontend_embeds=None):
        """prompts (B, S) → (last-position logits (B, V), cache)."""
        return self._prefill(self._tokens(prompts),
                             self._frontend(frontend_embeds))

    @torch.inference_mode()
    def generate(self, prompts, n_tokens: int,
                 generator: Optional[torch.Generator] = None,
                 frontend_embeds=None) -> np.ndarray:
        """prompts (B, S) int32 → generated (B, n_tokens) int32.

        ``frontend_embeds`` (B, F, d): audio frames of an encoder-decoder
        or image patches of a VLM."""
        cfg = self.model.cfg
        dev = self.model.device
        if generator is None and self.scfg.temperature > 0.0:
            generator = torch.Generator(device=dev).manual_seed(0)
        tokens = self._tokens(prompts)
        last_logits, cache = self._prefill(tokens,
                                           self._frontend(frontend_embeds))
        token = sample(last_logits, generator, self.scfg.temperature)
        out = [token]
        prefix = cfg.frontend_seq if cfg.frontend == "vision" else 0
        pos = tokens.shape[1] + prefix
        for _ in range(n_tokens - 1):
            token, cache = self._decode(
                cache, token,
                torch.full((1,), pos, dtype=torch.int32, device=dev),
                generator)
            out.append(token)
            pos += 1
            if self.scfg.eos_id >= 0 and bool((token == self.scfg.eos_id)
                                              .all()):
                break
        return torch.cat(out, dim=1).cpu().numpy()
