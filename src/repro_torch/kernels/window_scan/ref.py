"""Plain PyTorch version of the blocked segmented windowed scan.

For every row ``i`` of a table sorted by ``(partition, order)`` keys,
reduce the rows of the same partition inside a trailing row-count window,

    out[i] = op( values[a .. i] ),   a = max(i - window + 1, seg_start[i]),

for ``op`` in sum/min/max; all sum lanes ride one ``(n, L)`` call.
``seg_start[i]`` is the row where ``i``'s segment (partition) begins.

The algorithm is the reference's (``src/repro/kernels/window_scan/ref.py``)
step for step, so its float sums are bit-identical to the JAX package's
on the CPU:

  1. rows are split into chunks of exactly ``window`` rows;
  2. a segmented inclusive prefix scan runs forward within each chunk and a
     segmented suffix scan backward (both reset at segment starts), each a
     Hillis–Steele ladder of ``log2(window)`` shift-combine steps whose
     combine order is fixed (:func:`_chunk_scan`);
  3. a window ending at ``i`` either lies inside ``i``'s chunk (the prefix
     at ``i`` is the answer) or straddles one chunk boundary (a suffix in
     the previous chunk combined with the prefix at ``i``).

min and max propagate NaN and order ``-0.0`` below ``+0.0``, as
``jnp.minimum``/``jnp.maximum`` do (:func:`_combine`).
:func:`segmented_cumulative` reuses the ladder at chunk size ``n`` for
expanding aggregates; it is plain PyTorch on every device, as it is a jnp
function in the reference.
"""
from __future__ import annotations

import torch

_IDENTITY = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}


def _combine(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a ⊕ b``; for min/max a NaN operand wins and ``-0.0 < +0.0``."""
    if op == "sum":
        return a + b
    if op == "min":
        take_a = (a < b) | ((a == b) & torch.signbit(a))
    else:
        take_a = (a > b) | ((a == b) & ~torch.signbit(a))
    return torch.where(take_a | torch.isnan(a), a, b)


def _chunk_scan(v: torch.Tensor, f: torch.Tensor, op: str) -> torch.Tensor:
    """Segmented inclusive scan along dim 1 of ``v (m, c, L)``.

    ``f (m, c)`` flags rows that START a segment; the value at a row covers
    back to the nearest flagged row (or the chunk start).  At offset ``d``
    a row whose span is still open combines with the row ``d`` to its left
    (left operand = the earlier span) and inherits its flag.
    """
    c = v.shape[1]
    d = 1
    while d < c:
        sv = torch.cat([torch.full_like(v[:, :d], _IDENTITY[op]), v[:, :-d]],
                       dim=1)
        sf = torch.cat([torch.ones_like(f[:, :d]), f[:, :-d]], dim=1)
        v = torch.where(f[..., None], v, _combine(op, sv, v))
        f = f | sf
        d *= 2
    return v


def _chunk_suffix(v: torch.Tensor, new_seg: torch.Tensor,
                  op: str) -> torch.Tensor:
    """Segmented suffix scan along dim 1: ``out[j] = op(v[j .. e])``, ``e``
    the last row of ``j``'s segment within the chunk — :func:`_chunk_scan`
    on the reversed chunk, whose segment starts are the segment ENDS."""
    rf = torch.cat([new_seg[:, 1:], torch.zeros_like(new_seg[:, :1])], dim=1)
    return _chunk_scan(v.flip(1), rf.flip(1), op).flip(1)


def windowed_scan(values: torch.Tensor, seg_start: torch.Tensor, window: int,
                  op: str = "sum") -> torch.Tensor:
    """values ``(n, L)`` f32, seg_start ``(n,)`` → ``(n, L)`` rolling
    reductions, ``out[i] = op(values[max(i - window + 1, seg_start[i]) ..
    i])``.  ``seg_start[i] <= i`` and constant within each segment."""
    n, lanes = values.shape
    w = int(window)
    n_pad = -(-n // w) * w
    dev = values.device
    vals = torch.cat([values, torch.full((n_pad - n, lanes), _IDENTITY[op],
                                         dtype=values.dtype, device=dev)])
    idx = torch.arange(n_pad, device=dev)
    # padding rows are their own segments: they never join a window
    segs = torch.cat([seg_start.to(torch.int64), idx[n:]])
    new_seg = segs == idx

    m = n_pad // w
    v3 = vals.reshape(m, w, lanes)
    f3 = new_seg.reshape(m, w)
    prefix = _chunk_scan(v3, f3, op).reshape(n_pad, lanes)
    suffix = _chunk_suffix(v3, f3, op).reshape(n_pad, lanes)

    a = torch.maximum(idx - (w - 1), segs)
    chunk_start = (idx // w) * w
    use_prev = a < chunk_start  # the window straddles one chunk boundary
    sval = suffix[torch.clamp(a, 0, n_pad - 1)]
    out = torch.where(use_prev[:, None], _combine(op, sval, prefix), prefix)
    return out[:n]


def segmented_cumulative(values: torch.Tensor, seg_start: torch.Tensor,
                         op: str = "sum") -> torch.Tensor:
    """values ``(n, L)``, seg_start ``(n,)`` → expanding reductions
    ``out[i] = op(values[seg_start[i] .. i])``: one segmented scan at chunk
    size ``n``."""
    n = values.shape[0]
    f = seg_start.to(torch.int64) == torch.arange(n, device=values.device)
    return _chunk_scan(values[None], f[None], op)[0]
