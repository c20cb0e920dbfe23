"""AdamW with float32 master weights, global-norm clipping, LR schedules.

Ports ``src/repro/train/optimizer.py``.  Parameters, gradients and the
moments are dicts of tensors keyed by the model's parameter names; the
moments are float32.  A step is an explicit function, not
``torch.optim``: it updates the masters and the moments in place under
``torch.no_grad()`` (the reference donates its state to the jitted
step), and returns them with the new step count.

Weight decay follows the reference's rank test (``p.ndim >= 2``) on the
reference's leaf, whose decoder and encoder leaves carry a leading
``n_groups`` axis: a per-layer norm scale, ``conv_b``, ``d_skip`` or
``dt_bias`` decays there and so decays here; ``final_norm.scale`` and
``enc_norm.scale`` do not (``models.params.reference_ndim``).

On a mesh of ranks (the sharded train step) the leaves are this rank's
blocks: the update is elementwise, and the clipping norm sums each
leaf's *global* elements once — the blocks' sums of squares folded in
rank order over the axes the leaf is split over, a leaf replicated over
an axis counted once.  ``decays`` reads the reference's rank, which a
block shares.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, NamedTuple, Tuple

import torch

from ..core import array_ops
from ..models.params import reference_ndim

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    mu: Tree
    nu: Tree
    count: torch.Tensor          # int32 scalar: steps taken


def init_opt_state(params: Mapping[str, torch.Tensor]) -> OptState:
    zeros = {k: torch.zeros_like(p, dtype=torch.float32)
             for k, p in params.items()}
    dev = next(iter(params.values())).device
    return OptState(mu=zeros, nu={k: torch.zeros_like(v)
                                  for k, v in zeros.items()},
                    count=torch.zeros((), dtype=torch.int32, device=dev))


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to ``min_lr_ratio``, in float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.learning_rate * step / max(cfg.warmup_steps, 1)
    progress = torch.clamp(
        (step - cfg.warmup_steps)
        / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * progress))
    return torch.where(step < cfg.warmup_steps, warm,
                       cfg.learning_rate * cos)


def global_norm(leaves, split=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares.

    On a mesh, ``leaves`` are blocks and ``split[i]`` the axes leaf ``i``
    is split over: its block sums are folded over those axes, in rank
    order (every rank ends with the same bits)."""
    sums = torch.stack([torch.sum(torch.square(x.to(torch.float32)))
                        for x in leaves])
    if mesh is not None:
        for axis in mesh:
            on = torch.tensor([axis in sp for sp in split],
                              device=sums.device)
            if mesh[axis] > 1 and bool(on.any()):
                every = array_ops.axis_all_gather(sums[None], mesh, axis)
                total = every[0]
                for row in every[1:]:
                    total = total + row
                sums = torch.where(on, total, sums)
    return torch.sqrt(torch.sum(sums))


def decays(name: str, p: torch.Tensor) -> bool:
    """Weight decay for leaves whose reference counterpart is a matrix or
    a stack (the reference's ``_is_matrix``)."""
    return reference_ndim(name, p.ndim) >= 2


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: OptState,
                 split=None, mesh=None,
                 ) -> Tuple[Mapping[str, torch.Tensor], OptState,
                            Dict[str, torch.Tensor]]:
    """One AdamW step → (params, new state, ``{grad_norm, lr}``); the
    masters and the moments are updated in place.  On a mesh, ``split``
    maps each leaf to the axes its block splits over (:func:`global_norm`)."""
    gnorm = global_norm([grads[k] for k in params],
                        None if split is None else [split[k] for k in params],
                        mesh)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    count = state.count + 1
    lr = lr_schedule(cfg, count)
    countf = count.to(torch.float32)
    b1c = 1 - torch.pow(cfg.b1, countf)
    b2c = 1 - torch.pow(cfg.b2, countf)
    for name, p in params.items():
        g = grads[name].to(torch.float32) * scale
        m, v = state.mu[name], state.nu[name]
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if decays(name, p):
            step = step + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * step).to(p.dtype))
    return params, OptState(state.mu, state.nu, count), {"grad_norm": gnorm,
                                                         "lr": lr}
