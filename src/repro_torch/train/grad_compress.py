"""Int8 error-feedback gradient compression for the pure data-parallel
axis.

Ports ``src/repro/train/grad_compress.py`` onto the port's virtual
shards: every argument carries a leading ``n_shards`` axis (shard ``s``'s
full gradient leaf and its error state), and the collectives are the
port's shard-axis ones (``core/array_ops.py``)::

    q  = quantize(g + e)          # int8, per-leaf max-abs scale
    ĝ  = allreduce_int8(q)        # reduce-scatter + all-gather in int8
    e' = (g + e) - dequant(q)     # residual carried to the next step

The int8 reduce-scatter is one :func:`array_ops.all_to_all` (counted in
``EXCHANGES``); the scales and the reduced chunks go through
:func:`array_ops.spmd_allgather`.  Exact when every shard sees identical
data (q identical); otherwise standard EF convergence applies.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from ..core import array_ops


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.amax(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def ef_allreduce_mean(x: torch.Tensor, err: torch.Tensor,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 mean-allreduce of ``x`` with error feedback.

    x, err (n_shards, ...): each shard's gradient leaf and error state →
    (the averaged leaf, the same on every shard, (n_shards, ...) in
    ``x``'s dtype; the new error state, float32)."""
    n = x.shape[0]
    shape = x.shape[1:]
    xe = x.to(torch.float32) + err
    flat = xe.reshape(n, -1)
    length = flat.shape[1]
    flat_p = F.pad(flat, (0, (-length) % n))

    qs, scales = zip(*(_quantize(flat_p[s]) for s in range(n)))
    # stage 1: reduce-scatter in int8 — each shard sums one chunk
    mine = array_ops.all_to_all([q.reshape(n, -1) for q in qs])
    gather = array_ops.spmd_allgather
    scale_all = gather(scales, tiled=False)[0]                 # (n,)
    parts = []
    for s in range(n):
        deq = mine[s].to(torch.float32) * scale_all[:, None]   # (n, chunk)
        total = deq[0]
        for d in range(1, n):
            total = total + deq[d]
        parts.append(total / n)

    # stage 2: all-gather the reduced chunks in int8
    q2s, scale2s = zip(*(_quantize(part) for part in parts))
    full_q = gather(q2s, tiled=False)[0]                       # (n, chunk)
    scale2_all = gather(scale2s, tiled=False)[0]               # (n,)
    per_chunk = full_q.to(torch.float32) * scale2_all[:, None]
    result = per_chunk.reshape(-1)[:length].reshape(shape)

    # error feedback on each shard's own quantization
    dq = torch.stack([(q.to(torch.float32) * sc)[:length]
                      for q, sc in zip(qs, scales)]).reshape(xe.shape)
    return (result.to(x.dtype).expand(x.shape).clone(), xe - dq)


def init_error_state(grads: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Zero float32 error state shaped like ``grads`` (shard axis
    included)."""
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads.items()}


def tree_ef_allreduce(grads: Mapping[str, torch.Tensor],
                      err_state: Mapping[str, torch.Tensor]):
    """:func:`ef_allreduce_mean` leaf by leaf → (grads, error state)."""
    out = {k: ef_allreduce_mean(g, err_state[k]) for k, g in grads.items()}
    return ({k: v[0] for k, v in out.items()},
            {k: v[1] for k, v in out.items()})
