"""Train-step factory: loss, gradient accumulation, the AdamW step.

Ports ``src/repro/train/train_step.py`` for one card.  A ``TrainState``
holds the float32 masters (``nn.Parameter``\\s that require grad, keyed
by the model's parameter names) and the optimizer state.  The step is a
function of ``(state, batch)``, as the reference's: it binds the
state's masters into a model skeleton built on the meta device (no
storage of its own), so the forward, every rematerialized recompute and
the backward read exactly the state's tensors.  The forward runs in
``cfg.dtype`` (the casts at every use); gradients are float32.

The reference's ``make_sharded_train_step`` (``pjit`` over a device
mesh) is not ported: it waits for the mesh shardings and shards across
cards.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..configs.base import ModelConfig
from ..core.context import DeviceLike, resolve_device
from ..models.moe import METRICS
from ..models.params import params_from_jax, reference_ndim
from ..models.transformer import LM
from .optimizer import OptimizerConfig, OptState, adamw_update, init_opt_state


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = OptimizerConfig()
    micro_batches: int = 1
    moe_aux_coef: float = 0.01
    router_z_coef: float = 1e-3


class TrainState(NamedTuple):
    params: Dict[str, nn.Parameter]
    opt: OptState


def as_masters(params: Mapping[str, torch.Tensor],
               device: DeviceLike = None) -> Dict[str, nn.Parameter]:
    """float32 ``nn.Parameter`` masters on ``device`` that require grad."""
    dev = resolve_device(device)
    return {k: nn.Parameter(v.detach().to(dev, torch.float32),
                            requires_grad=True)
            for k, v in params.items()}


def place_state(state: TrainState, device: DeviceLike = None) -> TrainState:
    """``state`` (say, host tensors from a checkpoint or
    :func:`train_state_from_jax`) as a trainable state on ``device``."""
    dev = resolve_device(device)
    opt = state.opt
    return TrainState(
        params=as_masters(state.params, dev),
        opt=OptState(mu={k: v.to(dev, torch.float32)
                         for k, v in opt.mu.items()},
                     nu={k: v.to(dev, torch.float32)
                         for k, v in opt.nu.items()},
                     count=opt.count.to(dev, torch.int32)))


def train_state_from_jax(state, cfg: ModelConfig) -> TrainState:
    """A JAX ``TrainState`` (``params``, ``opt = OptState(mu, nu,
    count)``) → the port's host ``TrainState`` in float32: masters,
    ``mu``, ``nu`` under the port's names and ``count`` int32
    (:func:`place_state` makes it trainable on a device)."""
    def tree(t):
        return {k: v.to(torch.float32)
                for k, v in params_from_jax(t, cfg).items()}

    opt = state.opt
    return TrainState(
        params=tree(state.params),
        opt=OptState(mu=tree(opt.mu), nu=tree(opt.nu),
                     count=torch.tensor(int(np.asarray(opt.count)),
                                        dtype=torch.int32)))


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     device: DeviceLike = None) -> TrainState:
    """Random float32 masters (the reference's ``init_lm`` scheme, numbers
    from ``generator``) and zero optimizer state."""
    model = LM(cfg, generator, device, param_dtype=torch.float32)
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return TrainState(params=params, opt=init_opt_state(params))


def skeleton(cfg: ModelConfig) -> LM:
    """The model's modules with meta-device parameters: a forward runs
    only after :func:`bind` puts real tensors in their place."""
    return LM(cfg, torch.Generator(), "meta", param_dtype=torch.float32)


def bind(model: LM, params: Mapping[str, nn.Parameter]) -> LM:
    """Make ``params`` the model's own parameters (no copy)."""
    for name, p in params.items():
        owner, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(owner), leaf, p)
    return model


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked next-token CE; labels == -1 are ignored → (loss, acc).

    The reference takes the gold logit as a one-hot contraction, a
    sum over the vocab that partitions with vocab-sharded logits.  On
    one card a ``gather`` gives the same value and gradient and saves
    the one-hot tensor (1.6 GB of float32 at 8 x 1024 x 49152).
    Accuracy compares the gold logit with the row max, as there.
    """
    mask = labels >= 0
    safe = torch.clamp(labels, min=0).to(torch.int64)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    logz = torch.logsumexp(logits, dim=-1)
    nll = (logz - gold) * mask
    denom = torch.clamp(mask.sum(), min=1)
    loss = torch.sum(nll) / denom
    row_max = torch.amax(logits, dim=-1)
    acc = torch.sum((gold >= row_max) & mask) / denom
    return loss, acc


_KEEP_F32 = ("router", "a_log", "dt_bias", "b_gates", "scale", "b")


def cast_params_for_compute(params: Mapping[str, torch.Tensor],
                            dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The reference's cast of the masters before the FSDP gather: every
    leaf to ``dtype`` but the precision-critical names of ``_KEEP_F32``
    and the leaves of reference rank < 2 — the reference's rank, so the
    stacked ``conv_b`` and ``d_skip`` are cast."""
    out = {}
    for name, p in params.items():
        leaf = name.rpartition(".")[2]
        keep = leaf in _KEEP_F32 or reference_ndim(name, p.ndim) < 2
        out[name] = p if keep else p.to(dtype)
    return out


def loss_fn(model: LM, cfg: ModelConfig, tcfg: TrainConfig,
            batch: Mapping[str, torch.Tensor],
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, _, aux = model(batch["tokens"], mode="train",
                           frontend_embeds=batch.get("frontend"))
    labels = batch["labels"]
    if cfg.frontend == "vision":
        # image prefix positions carry no LM loss
        pad = torch.full(labels.shape[:1] + (cfg.frontend_seq,), -1,
                         dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    ce, acc = cross_entropy(logits, labels)
    total = (ce + tcfg.moe_aux_coef * aux["moe_aux_loss"]
             + tcfg.router_z_coef * aux["router_z_loss"])
    return total, {"loss": ce, "accuracy": acc, **aux}


def compute_grads(model: LM, cfg: ModelConfig, tcfg: TrainConfig, batch,
                  params: Mapping[str, nn.Parameter]):
    """→ (float32 gradients of ``loss_fn`` by name, detached metrics);
    ``params`` are the model's bound masters."""
    total, metrics = loss_fn(model, cfg, tcfg, batch)
    names = list(params)
    gs = torch.autograd.grad(total, [params[n] for n in names],
                             allow_unused=True)
    grads = {n: torch.zeros_like(params[n]) if g is None else g
             for n, g in zip(names, gs)}
    return grads, {k: v.detach() for k, v in metrics.items()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    model: Optional[LM] = None):
    """Returns ``train_step(state, batch) → (state, metrics)``.

    ``model``: the skeleton to bind the masters into (default: a new
    :func:`skeleton`).  With ``micro_batches`` = m > 1 the batch is split
    into m slices along its first axis; float32 gradients and metrics
    are summed over them in order and divided by m, as the reference's
    ``lax.scan`` does.
    """
    model = model if model is not None else skeleton(cfg)

    def train_step(state: TrainState, batch):
        bind(model, state.params)
        m = tcfg.micro_batches
        if m == 1:
            grads, metrics = compute_grads(model, cfg, tcfg, batch,
                                           state.params)
        else:
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in state.params.items()}
            dev = next(iter(grads.values())).device
            metrics = {k: torch.zeros((), dtype=torch.float32, device=dev)
                       for k in ("loss", "accuracy") + METRICS}
            for i in range(m):
                micro = {k: v.reshape((m, v.shape[0] // m) + v.shape[1:])[i]
                         for k, v in batch.items()}
                g, met = compute_grads(model, cfg, tcfg, micro,
                                       state.params)
                for k in grads:
                    grads[k] += g[k]
                for k in metrics:
                    metrics[k] = metrics[k] + met[k]
                del g
            grads = {k: g / m for k, g in grads.items()}
            metrics = {k: v / m for k, v in metrics.items()}
        params, opt, opt_metrics = adamw_update(
            tcfg.optimizer, state.params, grads, state.opt)
        metrics.update(opt_metrics)
        return TrainState(params, opt), metrics

    return train_step
