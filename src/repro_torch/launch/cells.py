"""Serving cells: the reference's prefill and decode steps, placed on a
mesh of ranks.

Ports the serving half of ``src/repro/launch/cells.py``: ``cell_rules``,
``input_specs``, ``make_prefill_fn`` and ``make_decode_fn``, and what
``lower_cell``'s prefill and decode branches set up — the parameters
placed by ``param_specs`` and the cache by ``cache_specs`` — as
:func:`serve_cell`, which runs the steps on this rank's blocks instead of
lowering them.  The reference jits a global program that the partitioner
splits; here every rank holds its blocks and the model code runs the
collectives (``models/``, ``sharding/``).

The rank's parameters are drawn as ``train/train_step.py:
init_sharded_state`` draws them: every rank draws the whole model from
the seed layer by layer (``LM(..., keep=...)``) and keeps its blocks, so
the gathered weights are a one-card ``LM``'s from the same seed and the
whole model never exists on a rank.

The lowering itself, ``roofline_config``, ``slstm_flops_correction`` and
the train cells' micro-batch rule stay with ROADMAP Queue 1 item 11d.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from ..configs import ShapeCell
from ..configs.base import ModelConfig
from ..core.context import DeviceLike, resolve_device
from ..models.layers import compute_dtype
from ..models.transformer import LM, Caches, init_cache, refuse_on_mesh
from ..serve.engine import sample
from ..sharding import axes as axes_mod
from ..sharding import partition


def cell_rules(cfg: ModelConfig, cell: ShapeCell,
               overrides: Optional[Dict] = None) -> Dict:
    """The cell's logical→mesh rules: a global batch of 1 (long-context
    decode) leaves ``batch`` unsharded."""
    rules = dict(axes_mod.DEFAULT_RULES)
    if cell.global_batch == 1:
        rules["batch"] = None
    if overrides:
        rules.update(overrides)
    return rules


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, torch.Tensor]:
    """Meta tensors of every model input of this cell (global shapes)."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    b, s = cell.global_batch, cell.seq_len
    if cell.kind in ("train", "prefill"):
        text = s - (cfg.frontend_seq if cfg.frontend == "vision" else 0)
        out = {"tokens": meta((b, text), torch.int32),
               "labels": meta((b, text), torch.int32)}
        if cfg.frontend is not None or cfg.is_encoder_decoder:
            out["frontend"] = meta((b, cfg.frontend_seq, cfg.d_model),
                                   torch.float32)
        if cell.kind == "prefill":
            out.pop("labels")
        return out
    # decode: one new token against a cache of length s
    return {"token": meta((b, 1), torch.int32),
            "pos": meta((1,), torch.int32)}


def make_prefill_fn(cfg: ModelConfig, cache_len: int):
    def prefill_step(model: LM, batch: Mapping[str, torch.Tensor]):
        logits, cache, _ = model(
            batch["tokens"], mode="prefill",
            frontend_embeds=batch.get("frontend"), cache_len=cache_len,
            last_logit_only=True)
        return logits[:, -1], cache

    return prefill_step


def make_decode_fn(cfg: ModelConfig):
    def serve_step(model: LM, cache: Caches, token: torch.Tensor,
                   pos: torch.Tensor):
        logits, new_cache, _ = model(token, mode="decode", cache=cache,
                                     positions=pos)
        next_token = sample(logits[:, -1], vocab_size=cfg.vocab_size)
        return next_token[:, 0], new_cache

    return serve_step


@dataclasses.dataclass
class ServeCell:
    """One cell on this rank: the model holding the rank's parameter
    blocks and the steps, run under the cell's binding.  Inputs and
    outputs are the rank's rows (``rows``), logits its vocab block."""
    cfg: ModelConfig
    cell: ShapeCell
    mesh: object            # sharding.axes.GroupMesh
    rules: Dict
    model: LM

    def binding(self):
        return axes_mod.logical_binding(self.mesh, self.rules)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch-leading tensor."""
        with self.binding():
            return partition.batch_rows(x, self.mesh)

    @torch.inference_mode()
    def prefill(self, batch: Mapping[str, torch.Tensor]):
        """→ (last logits, cache blocks) of the rank's rows."""
        with self.binding():
            return make_prefill_fn(self.cfg, self.cell.seq_len)(
                self.model, batch)

    @torch.inference_mode()
    def decode(self, cache: Caches, token: torch.Tensor, pos: torch.Tensor):
        """→ (next greedy token (B_loc,) int32, the updated cache)."""
        with self.binding():
            return make_decode_fn(self.cfg)(self.model, cache, token, pos)

    def init_cache(self) -> Caches:
        """The rank's blocks of an empty cache of the cell's length."""
        with self.binding():
            return init_cache(self.cfg, self.cell.global_batch,
                              self.cell.seq_len, compute_dtype(self.cfg),
                              self.model.device)

    def cache_specs(self, cache: Caches) -> Caches:
        """Each leaf's spec of the rank's ``cache`` blocks (``pos`` is
        replicated, so it gives the cache length)."""
        with self.binding():
            b = axes_mod.global_dim(cache[0]["k"].shape[0], "batch")
        whole = Caches(
            {k: torch.empty((b, self.cfg.n_kv_heads, layer["pos"].shape[0],
                             v.shape[-1]), device="meta")
             if k in ("k", "v", "k_s", "v_s") else v
             for k, v in layer.items()} for layer in cache)
        return partition.cache_specs(whole, self.cfg, self.mesh, self.rules)

    def gather_cache(self, cache: Caches) -> Caches:
        """The whole cache on every rank from the ranks' blocks (a
        collective; for checks)."""
        return partition.gather_cache(cache, self.cache_specs(cache),
                                      self.mesh)


def serve_cell(cfg: ModelConfig, cell: ShapeCell, mesh, seed: int = 0,
               device: DeviceLike = None,
               params: Optional[Mapping[str, object]] = None) -> ServeCell:
    """The cell on this rank of ``mesh``: its parameter blocks by
    ``param_specs`` under :func:`cell_rules`, drawn from ``seed`` (or cut
    from the whole leaves ``params``, say a JAX model's through
    ``models/params.py:params_from_jax``), in the compute dtype.  Decode
    runs without remat, as the reference's decode cell does."""
    refuse_on_mesh(cfg)
    cfg = dataclasses.replace(cfg, remat=False)
    dev = resolve_device(device)
    rules = cell_rules(cfg, cell)
    skeleton = LM(cfg, torch.Generator(), "meta")
    with axes_mod.logical_binding(mesh, rules):
        specs = partition.param_specs(dict(skeleton.named_parameters()),
                                      cfg, mesh, rules)
    if params is None:
        keep, _ = partition.block_keeper(specs, mesh)
        model = LM(cfg, torch.Generator(device=dev).manual_seed(seed), dev,
                   keep=keep)
    else:
        model = skeleton
        for name, full in params.items():
            block = partition.shard_tensor(torch.as_tensor(full),
                                           specs[name], mesh)
            owner, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(owner), leaf, nn.Parameter(
                block.to(dev, model.get_parameter(name).dtype).contiguous(),
                requires_grad=False))
    fsdp_axis = rules.get("fsdp")
    model.fsdp = {k: sp.index(fsdp_axis) for k, sp in specs.items()
                  if fsdp_axis in sp}
    return ServeCell(cfg, cell, mesh, rules, model)
