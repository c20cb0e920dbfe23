"""Int8 error-feedback gradient compression for the pure data-parallel
axis.

Ports ``src/repro/train/grad_compress.py`` in two forms.  On the port's
virtual shards every argument carries a leading ``n_shards`` axis (shard
``s``'s full gradient leaf and its error state).  Over a real mesh axis
(``axis=`` and a ``sharding.axes.GroupMesh``) the arguments are this
rank's leaf and error state, as inside the reference's ``shard_map``.
Either way the collectives are the port's group transport
(``core/array_ops.py``)::

    q  = quantize(g + e)          # int8, per-leaf max-abs scale
    ĝ  = allreduce_int8(q)        # reduce-scatter + all-gather in int8
    e' = (g + e) - dequant(q)     # residual carried to the next step

The int8 reduce-scatter is one :func:`array_ops.all_to_all` (counted in
``EXCHANGES``); the scales and the reduced chunks go through
:func:`array_ops.spmd_allgather`.  Each member sums its chunk in rank
order, so every rank ends with the same bits.  Exact when every shard
sees identical data (q identical); otherwise standard EF convergence
applies.  As in the reference, ``TrainConfig`` does not call it.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core import array_ops


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.amax(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _ef_allreduce(xs, errs, group) -> Tuple[list, list]:
    """The algorithm over the leaves of the shards this process holds
    (every shard's on virtual shards, its one on a rank of ``group``)."""
    n = array_ops.axis_size(xs, group)
    xes = [x.to(torch.float32) + e for x, e in zip(xs, errs)]
    length = xes[0].numel()
    qs, scales = zip(*(_quantize(F.pad(xe.reshape(-1), (0, (-length) % n)))
                       for xe in xes))
    # stage 1: reduce-scatter in int8 — each shard sums one chunk
    mine = array_ops.all_to_all([q.reshape(n, -1) for q in qs], group)
    gather = array_ops.spmd_allgather
    scale_all = gather(scales, tiled=False, group=group)[0]     # (n,)
    parts = []
    for chunks in mine:
        deq = chunks.to(torch.float32) * scale_all[:, None]    # (n, chunk)
        total = deq[0]
        for d in range(1, n):
            total = total + deq[d]
        parts.append(total / n)

    # stage 2: all-gather the reduced chunks in int8
    q2s, scale2s = zip(*(_quantize(part) for part in parts))
    full_q = gather(q2s, tiled=False, group=group)[0]           # (n, chunk)
    scale2_all = gather(scale2s, tiled=False, group=group)[0]   # (n,)
    per_chunk = full_q.to(torch.float32) * scale2_all[:, None]
    result = per_chunk.reshape(-1)[:length].reshape(xs[0].shape)

    # error feedback on each shard's own quantization
    new_errs = [xe - (q.to(torch.float32) * sc)[:length].reshape(xe.shape)
                for xe, q, sc in zip(xes, qs, scales)]
    return [result.to(x.dtype) for x in xs], new_errs


def ef_allreduce_mean(x: torch.Tensor, err: torch.Tensor,
                      axis: Optional[str] = None, mesh=None,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 mean-allreduce of ``x`` with error feedback.

    Virtual (``axis=None``): x, err (n_shards, ...) each shard's gradient
    leaf and error state → (the averaged leaf, the same on every shard,
    (n_shards, ...) in ``x``'s dtype; the new error state, float32).
    Over ``axis`` of ``mesh`` (default: the bound one): x, err this
    rank's leaf and error state → (the average over the axis's ranks,
    the same on each, in ``x``'s dtype; this rank's new error state)."""
    if axis is None:
        res, errs = _ef_allreduce(list(x.unbind(0)), list(err.unbind(0)),
                                  None)
        return torch.stack(res), torch.stack(errs)
    from ..sharding import axes as shard_axes

    mesh = mesh if mesh is not None else shard_axes.group_mesh()
    res, errs = _ef_allreduce([x], [err], mesh.groups[axis])
    return res[0], errs[0]


def init_error_state(grads: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Zero float32 error state shaped like ``grads`` (shard axis
    included)."""
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads.items()}


def tree_ef_allreduce(grads: Mapping[str, torch.Tensor],
                      err_state: Mapping[str, torch.Tensor],
                      axis: Optional[str] = None, mesh=None):
    """:func:`ef_allreduce_mean` leaf by leaf → (grads, error state)."""
    out = {k: ef_allreduce_mean(g, err_state[k], axis, mesh)
           for k, g in grads.items()}
    return ({k: v[0] for k, v in out.items()},
            {k: v[1] for k, v in out.items()})
