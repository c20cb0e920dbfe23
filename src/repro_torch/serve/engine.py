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

On a mesh of ranks (an ``Engine`` built under a bound
``sharding.axes.GroupMesh``, whose binding it keeps) the model holds
this rank's blocks (``launch/cells.py:serve_cell``): each data
coordinate takes its rows of the global prompts, greedy decoding reads
the vocab-split logits through ``array_ops.vocab_argmax``, sampling
gathers the global batch's last logits and draws from a generator
seeded alike on every rank (so it draws what one card would), the EOS
stop is agreed over the batch axes, and ``generate`` returns the global
tokens on every rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import array_ops
from ..models.transformer import LM, Caches
from ..sharding import axes as shard_axes
from ..sharding import partition


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
        return sample(logits[:, -1], generator, temperature,
                      model.cfg.vocab_size), new_cache

    return decode


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
           temperature: float = 0.0,
           vocab_size: Optional[int] = None) -> torch.Tensor:
    """(B, V) logits → (B, 1) int32 tokens.

    Under a bound mesh the logits are this rank's rows, and its vocab
    block when narrower than ``vocab_size``: greedy takes the global
    argmax over the vocab axis, sampling draws over the global batch's
    gathered logits and keeps this rank's rows."""
    mesh = shard_axes.group_mesh()
    v_axis = shard_axes.current_rules()["vocab"]
    split = (mesh is not None and vocab_size is not None
             and logits.shape[-1] != vocab_size)
    if temperature <= 0.0:
        if split:
            return array_ops.vocab_argmax(logits, mesh, v_axis).to(
                torch.int32)[:, None]
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    if mesh is not None:
        if split:
            logits = array_ops.axis_all_gather(logits, mesh, v_axis, -1)
        logits = partition.gather_rows(logits, mesh)
    probs = torch.softmax(logits / temperature, dim=-1)
    out = torch.multinomial(probs, 1, generator=generator).to(torch.int32)
    return out if mesh is None else partition.batch_rows(out, mesh)


class Engine:
    """Batched generation over a model's prefill and decode steps."""

    def __init__(self, model: LM, serve_cfg: ServeConfig):
        self.model = model
        self.scfg = serve_cfg
        self.mesh = shard_axes.group_mesh()
        self._rules = shard_axes.current_rules()
        self._prefill = make_prefill_step(model, serve_cfg.max_len)
        self._decode = make_decode_step(model, serve_cfg.temperature)

    def _bound(self):
        if self.mesh is None:
            return contextlib.nullcontext()
        return shard_axes.logical_binding(self.mesh, self._rules)

    def _local(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.mesh is None else partition.batch_rows(x, self.mesh)

    def _tokens(self, prompts) -> torch.Tensor:
        return self._local(torch.as_tensor(
            np.asarray(prompts), dtype=torch.int32).to(self.model.device))

    def _frontend(self, frontend_embeds) -> Optional[torch.Tensor]:
        if frontend_embeds is None:
            return None
        return self._local(torch.as_tensor(frontend_embeds).to(
            self.model.device))

    @torch.inference_mode()
    def prefill(self, prompts, frontend_embeds=None):
        """prompts (B, S) → (last-position logits (B, V), cache); on a
        mesh, this rank's rows (and vocab block) of the logits and its
        cache blocks."""
        with self._bound():
            return self._prefill(self._tokens(prompts),
                                 self._frontend(frontend_embeds))

    def _all_stopped(self, token: torch.Tensor) -> bool:
        """Every sequence's last token is EOS — on a mesh, the ranks of
        the batch axes agree (one all-reduce an axis), so none leaves the
        loop alone."""
        done = (token == self.scfg.eos_id).all().to(torch.int32)
        if self.mesh is not None:
            for a in shard_axes.batch_axes():
                done = array_ops.axis_all_reduce(done, self.mesh, a, "min")
        return bool(done)

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
        with self._bound():
            tokens = self._tokens(prompts)
            last_logits, cache = self._prefill(
                tokens, self._frontend(frontend_embeds))
            token = sample(last_logits, generator, self.scfg.temperature,
                           cfg.vocab_size)
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
                if self.scfg.eos_id >= 0 and self._all_stopped(token):
                    break
            out = torch.cat(out, dim=1)
            if self.mesh is not None:
                out = partition.gather_rows(out, self.mesh)
        return out.cpu().numpy()
