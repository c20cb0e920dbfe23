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

On a mesh of ranks (a bound ``sharding.axes.GroupMesh``) the model's
parameters are this rank's blocks (``sharding/partition.py``) and
``LM.forward`` takes this rank's batch rows: the embedding goes through
``embed_lookup``, each layer's FSDP blocks (:attr:`LM.fsdp`) are
all-gathered over ``data`` just before the layer runs — inside its remat
group, so the backward gathers them again and reduce-scatters their
gradients — the layers run tensor parallel over ``model``
(``layers.py``, ``moe.py``), and the head is vocab-split over ``model``:
the logits are this rank's vocab columns.  In ``prefill`` and
``decode`` the cache is this rank's blocks by ``cache_specs``
(:func:`init_cache` under the binding allocates only those).  Only
dense and MoE GQA decoders run on a mesh; every other family raises,
naming its ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core import array_ops
from ..core.context import DeviceLike, resolve_device
from ..sharding import axes as shard_axes
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
                dtype: torch.dtype, device: torch.device, keep=None,
                prefix: str = "layers") -> nn.ModuleList:
    """The stack's layers in order; ``keep(f"{prefix}.{j}", layer)`` is
    called on each layer as soon as it is drawn (see :class:`LM`)."""
    layers = nn.ModuleList()
    for _ in range(cfg.n_groups):
        for i, kind in enumerate(cfg.block_pattern):
            layer = Layer(cfg, kind, i, cross, generator, dtype, device)
            if keep is not None:
                keep(f"{prefix}.{len(layers)}", layer)
            layers.append(layer)
    return layers


def apply_stack(layers: nn.ModuleList, x, *, mode: str, caches, positions,
                enc_out=None, causal: bool = True, cache_len: int = 0,
                remat_group: int = 0, fetch=None):
    """→ (x, per-layer new caches, metrics summed over the layers).

    ``remat_group`` > 0 (training with ``cfg.remat``, grad enabled):
    each run of that many consecutive layers — one repetition of the
    block pattern, the reference's scan step under ``jax.checkpoint`` —
    keeps only its input for the backward pass and recomputes the rest.
    ``fetch(j)``, when given, returns the tensors layer ``j`` runs with in
    place of its own parameters (by name within the layer): the FSDP
    gathers, made inside the remat group.  The mesh binding in force is
    re-entered there, since a recompute may run on autograd's thread.
    """
    binding = (shard_axes.current_mesh(), shard_axes.current_rules())

    def run(x, lo, hi):
        ncs, ms = [], []
        with shard_axes.logical_binding(*binding):
            for j in range(lo, hi):
                kw = dict(mode=mode,
                          cache=caches[j] if caches is not None else None,
                          positions=positions, enc_out=enc_out,
                          causal=causal, cache_len=cache_len)
                if fetch is None:
                    x, nc, m = layers[j](x, **kw)
                else:
                    x, nc, m = torch.func.functional_call(
                        layers[j], fetch(j), (x,), kw)
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


def refuse_on_mesh(cfg: ModelConfig) -> None:
    """Families outside the mesh slice raise, naming their ROADMAP item."""
    kinds = set(cfg.block_pattern) - {"attn"}
    what = ("MLA attention" if cfg.attention == "mla" else
            f"{'/'.join(sorted(kinds))} mixers" if kinds else
            "an encoder-decoder" if cfg.is_encoder_decoder else
            f"a {cfg.frontend} frontend" if cfg.frontend else None)
    if what is not None:
        raise NotImplementedError(
            f"{cfg.name}: {what} on a mesh of ranks is not ported (ROADMAP "
            f"Queue 1 item 11b, rest: MLA, Mamba, xLSTM, encoder-decoder "
            f"and VLM); dense and MoE GQA decoders train and serve on a "
            f"mesh")


class LM(nn.Module):
    """The reference's LM with its parameters drawn from ``generator`` on
    ``device`` (``None``: the card), stored in ``param_dtype``: the
    compute dtype ``cfg.dtype`` by default (serving), float32 masters for
    training (``cfg.param_dtype``).  Leaves the reference uses uncast are
    float32 either way.

    ``keep(prefix, module)``, when given, is called as each part is drawn
    — each layer (``layers.3``), then the model itself (``""``) — and may
    replace the module's new parameters (a rank keeping its blocks of
    each drawn leaf, so the full model never exists at once).  The draws
    are the same either way.

    :attr:`fsdp` maps a parameter's name to the dimension its block splits
    over ``data`` (set by the sharded train step; empty otherwise)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device: DeviceLike = None,
                 param_dtype: Optional[torch.dtype] = None, keep=None):
        super().__init__()
        dev = resolve_device(device)
        dt = param_dtype or compute_dtype(cfg)
        self.cfg = cfg
        self.fsdp: Dict[str, int] = {}
        self.embed = dense_param((cfg.vocab_size, cfg.d_model), generator, dt,
                                 dev, fan_in=cfg.d_model)
        self.final_norm = RMSNorm(cfg.d_model, dt, dev)
        self.layers = build_stack(cfg, cfg.is_encoder_decoder, generator, dt,
                                  dev, keep)
        self.lm_head = (None if cfg.tie_embeddings else
                        dense_param((cfg.d_model, cfg.vocab_size), generator,
                                    dt, dev))
        if cfg.is_encoder_decoder:
            self.encoder = build_stack(encoder_config(cfg), False, generator,
                                       dt, dev, keep, "encoder")
            self.enc_norm = RMSNorm(cfg.d_model, dt, dev)
        if keep is not None:
            keep("", self)

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
        mesh = shard_axes.group_mesh()
        if mesh is not None:
            refuse_on_mesh(cfg)
        dtype = compute_dtype(cfg)
        b = tokens.shape[0]
        x = shard_axes.embed_lookup(self.embed, tokens, cfg.d_model).to(dtype)
        shard_axes.constrain(x, "batch", "seq", "embed", shape=(
            shard_axes.global_dim(b, "batch"), x.shape[1], cfg.d_model))

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
            remat_group=remat_layers(cfg) if mode == "train" else 0,
            fetch=None if mesh is None else self._fetch(mesh))

        if last_logit_only:
            x = x[:, -1:]
        x = self.final_norm(x, cfg.norm_eps)
        split = False
        if mesh is None:
            head = self.embed.T if cfg.tie_embeddings else self.lm_head
        else:
            head, split = self._head(mesh)
            if split:       # this rank's vocab columns
                x = array_ops.copy_to_axis(
                    x, mesh, shard_axes.current_rules()["vocab"])
        logits = x @ head.to(dtype)
        if split:
            shard_axes.constrain(logits, "batch", "seq", "vocab", shape=(
                shard_axes.global_dim(b, "batch"), x.shape[1],
                cfg.vocab_size))
        new_cache = None
        if mode in ("prefill", "decode"):
            new_cache = Caches(layer_caches)
            new_cache.enc_out = enc_out
        return logits.to(torch.float32), new_cache, aux

    # -- on a mesh of ranks -------------------------------------------------
    def _gathered(self, name: str, p: torch.Tensor, mesh) -> torch.Tensor:
        """``p``'s FSDP blocks gathered over ``data`` (``p`` itself when
        it is not split there)."""
        dim = self.fsdp.get(name)
        if dim is None:
            return p
        return array_ops.axis_all_gather(p, mesh, "data", dim)

    def _fetch(self, mesh, prefix: str = "layers"):
        """Layer ``j``'s gathered FSDP leaves, by name within the layer."""
        def fetch(j):
            pre = f"{prefix}.{j}."
            return {name[len(pre):]: self._gathered(name,
                                                    self.get_parameter(name),
                                                    mesh)
                    for name in self.fsdp if name.startswith(pre)}
        return fetch

    def _head(self, mesh) -> Tuple[torch.Tensor, bool]:
        """The head ``(d, V/M)`` over the vocab axis's ``M`` ranks when
        ``M`` divides the vocabulary (→ ``True``), else ``(d, V)``."""
        cfg = self.cfg
        rules = shard_axes.current_rules()
        v_axis, d_axis = rules.get("vocab"), rules.get("embed_d")
        m = mesh.get(v_axis, 1) if isinstance(v_axis, str) else 1
        split = m > 1 and cfg.vocab_size % m == 0
        if not cfg.tie_embeddings:
            head = self._gathered("lm_head", self.lm_head, mesh)
            return head, head.shape[1] != cfg.vocab_size
        e = self.embed
        if e.shape[1] != cfg.d_model:        # d split over embed_d
            if split and d_axis != v_axis:
                raise NotImplementedError(
                    f"a tied head needs embed_d and vocab on one axis, not "
                    f"{d_axis!r} and {v_axis!r}")
            # each rank's vocab rows feed its own logits: gradients summed
            e = array_ops.axis_all_gather(
                e, mesh, d_axis, 1,
                backward="reduce_scatter" if split else "slice")
        elif split:
            # the replicated table's rows feed different ranks' logits
            e = array_ops.copy_to_axis(e, mesh, v_axis)
        if split:
            v = cfg.vocab_size // m
            e = e.narrow(0, mesh.coords[v_axis] * v, v)
        return e.T, split


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
    """Empty decode cache of every layer, in layer order; under a bound
    :class:`~repro_torch.sharding.axes.GroupMesh`, this rank's blocks of
    it (``batch`` is the global batch)."""
    dev = resolve_device(device)
    mesh = shard_axes.group_mesh()
    if mesh is not None:
        from ..sharding import partition
        return partition.init_cache_blocks(cfg, batch, cache_len, dtype,
                                           mesh, dev)
    return Caches(c for _ in range(cfg.n_groups)
                  for c in init_group_cache(cfg, batch, cache_len, dtype,
                                            dev))
