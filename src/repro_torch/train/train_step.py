"""Train-step factory: loss, gradient accumulation, the AdamW step.

Ports ``src/repro/train/train_step.py`` for one card.  A ``TrainState``
holds the float32 masters (``nn.Parameter``\\s that require grad, keyed
by the model's parameter names) and the optimizer state.  The step is a
function of ``(state, batch)``, as the reference's: it binds the
state's masters into a model skeleton built on the meta device (no
storage of its own), so the forward, every rematerialized recompute and
the backward read exactly the state's tensors.  The forward runs in
``cfg.dtype`` (the casts at every use); gradients are float32.

:func:`make_sharded_train_step` is the reference's ``pjit`` step on a
mesh of ranks (``sharding.axes.GroupMesh``): each rank holds its blocks
of the masters and moments, FSDP over ``data`` x tensor/expert parallel
over ``model`` as ``sharding/partition.py:param_specs`` places them, and
steps on its data-parallel rows of the global batch (:func:`local_batch`).
The forward gathers each layer's FSDP blocks just before the layer runs,
under the same remat by layer as the one-card step, and the backward
reduce-scatters their gradients; the gradients of leaves that are not
split over a DP axis are summed over it explicitly.  The cross-entropy
runs on vocab-split logits (max and sum over ``model``) and the loss and
accuracy divide by the global count of labels ≥ 0, so the step is the
one-card step's function.  The masters are not cast before the gathers
(``cast_params_for_compute``), as the reference's sharded step does not.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..configs.base import ModelConfig
from ..core import array_ops
from ..core.context import DeviceLike, resolve_device
from ..models.moe import METRICS
from ..models.params import params_from_jax, reference_ndim
from ..models.transformer import LM
from ..sharding import axes as shard_axes
from ..sharding import partition
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
    nll, correct, count = cross_entropy_sums(logits, labels)
    denom = torch.clamp(count, min=1)
    return nll / denom, correct / denom


def cross_entropy_sums(logits: torch.Tensor, labels: torch.Tensor,
                       mesh=None, vocab: Optional[int] = None):
    """The masked CE's sums over ``logits``' rows → (sum of nll, count of
    rows whose gold logit is the row max, count of labels ≥ 0).

    With ``mesh``, ``logits`` may be this rank's columns of a ``vocab``
    split over the vocab axis (fewer than ``vocab``): the gold logit and
    the normalizer's sum of exponentials are summed over the axis, the
    row max is its max (no gradient, as the reference's ``logsumexp``)."""
    mask = labels >= 0
    safe = torch.clamp(labels, min=0).to(torch.int64)
    vl = logits.shape[-1]
    if mesh is None or vl == vocab:
        gold = torch.gather(logits, -1, safe[..., None])[..., 0]
        logz = torch.logsumexp(logits, dim=-1)
        row_max = torch.amax(logits, dim=-1)
    else:
        axis = shard_axes.current_rules()["vocab"]
        local = safe - mesh.coords[axis] * vl
        mine = (local >= 0) & (local < vl)
        gold = torch.gather(logits, -1,
                            torch.clamp(local, 0, vl - 1)[..., None])[..., 0]
        gold = array_ops.reduce_from_axis(torch.where(mine, gold, 0.0),
                                          mesh, axis)
        row_max = array_ops.axis_all_reduce(
            torch.amax(logits.detach(), dim=-1), mesh, axis, "max")
        se = torch.sum(torch.exp(logits - row_max[..., None]), dim=-1)
        logz = row_max + torch.log(array_ops.reduce_from_axis(se, mesh,
                                                              axis))
    nll = (logz - gold) * mask
    return torch.sum(nll), torch.sum((gold >= row_max) & mask), mask.sum()


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


# ---------------------------------------------------------------------------
# the sharded step on a mesh of ranks
# ---------------------------------------------------------------------------
def meta_state(cfg: ModelConfig) -> TrainState:
    """A state of meta tensors: the global shapes, no storage (the
    template :func:`make_sharded_train_step` reads)."""
    params = dict(skeleton(cfg).named_parameters())
    return TrainState(params=params, opt=init_opt_state(params))


def _state_of(params: Dict[str, torch.Tensor],
              mu: Optional[Dict[str, torch.Tensor]] = None,
              nu: Optional[Dict[str, torch.Tensor]] = None,
              count: Optional[torch.Tensor] = None) -> TrainState:
    masters = {k: nn.Parameter(v.detach().to(torch.float32),
                               requires_grad=True) for k, v in params.items()}
    zeros = init_opt_state(masters)
    dev = next(iter(masters.values())).device
    return TrainState(masters, OptState(
        mu if mu is not None else zeros.mu,
        nu if nu is not None else zeros.nu,
        (count if count is not None else zeros.count).to(dev, torch.int32)))


def init_sharded_state(cfg: ModelConfig, generator: torch.Generator, mesh,
                       specs: Mapping[str, tuple],
                       device: DeviceLike = None) -> TrainState:
    """This rank's blocks of :func:`init_train_state`'s masters (zero
    optimizer state): every rank draws the same global parameters from
    ``generator``, layer by layer, and keeps its blocks, so the blocks are
    the one-card init's bit for bit and no rank holds the whole model."""
    keep, kept = partition.block_keeper(specs, mesh)
    LM(cfg, generator, device, param_dtype=torch.float32, keep=keep)
    return _state_of(kept)


def shard_state(state: TrainState, specs: Mapping[str, tuple], mesh,
                device: DeviceLike = None) -> TrainState:
    """A global state (say, :func:`train_state_from_jax`'s) → this rank's
    trainable blocks on ``device``."""
    dev = resolve_device(device)

    def blocks(tree):
        return {k: v.to(dev, torch.float32) for k, v in
                partition.shard_params(tree, specs, mesh).items()}

    return _state_of(blocks(state.params), blocks(state.opt.mu),
                     blocks(state.opt.nu), state.opt.count)


def gather_state(state: TrainState, specs: Mapping[str, tuple],
                 mesh) -> TrainState:
    """Every rank's blocks → the global state on every rank (for tests
    and checks; a collective)."""
    opt = state.opt
    return TrainState(partition.gather_params(state.params, specs, mesh),
                      OptState(partition.gather_params(opt.mu, specs, mesh),
                               partition.gather_params(opt.nu, specs, mesh),
                               opt.count))


def local_batch(batch: Mapping[str, torch.Tensor], mesh,
                micro_batches: int = 1) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch under the bound rules' batch
    spec: micro-batch ``i`` of the global batch (rows ``i * B/m ..``, the
    reference's split) gives each DP rank its block of ``B / (m * DP)``
    rows, and the rank's micro-blocks follow each other.  With one
    micro-batch that is the batch spec's block."""
    dp = tuple(a for a in shard_axes.batch_axes() if a in mesh)
    n = shard_axes.axes_size(mesh, dp)
    i = partition.block_index(dp, mesh)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % (micro_batches * n):
            raise ValueError(f"batch {k}: {v.shape[0]} rows do not split "
                             f"into {micro_batches} micro-batches over "
                             f"{n} data-parallel ranks")
        rows = v.shape[0] // (micro_batches * n)
        v = v.reshape((micro_batches, n, rows) + tuple(v.shape[1:]))
        out[k] = v[:, i].reshape((micro_batches * rows,) + tuple(v.shape[3:]))
    return out


def _reduce_dp(x: torch.Tensor, mesh, dp) -> torch.Tensor:
    """Sum over the DP axes; the identity backward (each rank
    differentiates its own share)."""
    for a in dp:
        x = array_ops.reduce_from_axis(x, mesh, a)
    return x


def sharded_loss_fn(model: LM, cfg: ModelConfig, tcfg: TrainConfig, batch,
                    mesh) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`loss_fn` on this rank's rows: the loss and accuracy over the
    global batch's labels on every rank (the forward sums them over the
    DP axes, the backward leaves each rank its own share)."""
    dp = shard_axes.batch_axes()
    logits, _, aux = model(batch["tokens"], mode="train")
    nll, correct, count = cross_entropy_sums(
        logits, batch["labels"], mesh, cfg.vocab_size)
    denom = torch.clamp(_reduce_dp(count.detach(), mesh, dp), min=1)
    ce = _reduce_dp(nll / denom, mesh, dp)
    acc = _reduce_dp(correct / denom, mesh, dp).detach()
    total = (ce + tcfg.moe_aux_coef * aux["moe_aux_loss"]
             + tcfg.router_z_coef * aux["router_z_loss"])
    return total, {"loss": ce.detach(), "accuracy": acc,
                   **{k: v.detach() for k, v in aux.items()}}


def sharded_model(cfg: ModelConfig, specs: Mapping[str, tuple],
                  rules=None) -> LM:
    """A :func:`skeleton` whose :attr:`LM.fsdp` names each leaf's
    dimension split over the FSDP axis (bind the rank's blocks to run)."""
    fsdp_axis = (rules or {}).get("fsdp", shard_axes.DEFAULT_RULES["fsdp"])
    model = skeleton(cfg)
    model.fsdp = {k: sp.index(fsdp_axis) for k, sp in specs.items()
                  if fsdp_axis in sp}
    return model


def compute_sharded_grads(model: LM, cfg: ModelConfig, tcfg: TrainConfig,
                          batch, params: Mapping[str, nn.Parameter], mesh,
                          specs: Mapping[str, tuple]):
    """The sharded step's gradients of this rank's blocks → (float32
    gradients, each summed over the DP axes its leaf is not split over
    and divided by the micro-batch count; the global batch's metrics).
    ``model`` is a :func:`sharded_model` bound to ``params``; call under
    the mesh's binding."""
    dp = shard_axes.batch_axes()
    bind(model, params)
    m = tcfg.micro_batches
    names = list(params)
    grads, metrics = None, None
    for i in range(m):
        micro = {k: v.reshape((m, v.shape[0] // m) + v.shape[1:])[i]
                 for k, v in batch.items()}
        total, met = sharded_loss_fn(model, cfg, tcfg, micro, mesh)
        gs = torch.autograd.grad(total, [params[k] for k in names],
                                 allow_unused=True)
        gs = {k: torch.zeros_like(params[k]) if g is None else g
              for k, g in zip(names, gs)}
        if grads is None:
            grads, metrics = gs, met
        else:
            grads = {k: grads[k] + gs[k] for k in names}
            metrics = {k: metrics[k] + met[k] for k in metrics}
        del gs, total
    with torch.no_grad():
        for k in names:
            split = partition.sharded_axes(specs[k])
            for a in dp:
                if a not in split:
                    grads[k] = array_ops.axis_all_reduce(grads[k], mesh, a)
    if m > 1:
        grads = {k: g / m for k, g in grads.items()}
        metrics = {k: v / m for k, v in metrics.items()}
    return grads, metrics


def make_sharded_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh,
                            state_template: TrainState, rules=None):
    """→ ``(step, state_specs, batch_spec)``, as the reference returns.

    ``state_template``'s leaves give the global shapes (a
    :func:`meta_state` will do); ``step(state, batch) → (state,
    metrics)`` takes this rank's blocks (:func:`init_sharded_state`,
    :func:`shard_state`) and its rows (:func:`local_batch`).  Metrics are
    the global batch's, the same on every rank.  ``micro_batches`` m > 1
    sums the m micro-steps' float32 gradients in order and divides by m,
    as the one-card step does."""
    specs = partition.param_specs(state_template.params, cfg, mesh, rules)
    bspec = partition.batch_spec(mesh, rules)
    opt_specs = OptState(mu=specs, nu=specs, count=())
    split = {k: partition.sharded_axes(v) for k, v in specs.items()}
    model = sharded_model(cfg, specs, rules)

    def step(state: TrainState, batch):
        with shard_axes.logical_binding(mesh, rules):
            grads, metrics = compute_sharded_grads(
                model, cfg, tcfg, batch, state.params, mesh, specs)
            params, opt, opt_metrics = adamw_update(
                tcfg.optimizer, state.params, grads, state.opt, split, mesh)
        metrics.update(opt_metrics)
        return TrainState(params, opt), metrics

    return step, TrainState(specs, opt_specs), bspec
