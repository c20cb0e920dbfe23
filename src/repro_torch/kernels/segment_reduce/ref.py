"""Plain PyTorch version of the segment reductions (GroupBy hot loop).

Semantics of ``jax.ops.segment_sum/min/max``: ids outside
``[0, num_segments)`` are dropped, empty segments hold the identity
(0 / +inf / -inf), and a segment holding a NaN reduces to NaN under
min and max.

The plain version sorts rows by segment id (stable) and reads each
segment as a contiguous run:

  * sums add each run's finite values on their own, in float64 (runs of
    one length class gathered into one padded block and summed along it),
    with NaN and ±inf entries counted separately so they poison only their
    own segment.  A run's sum depends on its own rows alone: a difference
    of two prefix sums over the whole sorted table would carry that
    prefix's float64 rounding (eps * |prefix|) into every segment, which
    exceeds float32 rounding for a small segment after a long prefix of
    same-signed values;
  * min/max sort by value within the segment (NaN last, ``-0.0`` before
    ``+0.0``, by :func:`order_key`): the run's first element is the min and
    its last the max, and a NaN last element means the segment holds a
    NaN.  So ``-0.0`` is the min of ``{-0.0, +0.0}`` and ``+0.0`` its max,
    as ``jax.ops.segment_min/max`` give.

It deliberately uses no scatter-reduction (``index_add_``,
``scatter_reduce``): those are the library yardstick the kernels are timed
against, not part of the port.
"""
from __future__ import annotations

from typing import Tuple

import torch

_INITS = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}


def order_key(values: torch.Tensor) -> torch.Tensor:
    """int32 keys whose order is the float32 order of ``values``, with
    ``-0.0`` below ``+0.0`` and every NaN above ``+inf``."""
    bits = values.to(torch.float32).view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return torch.where(torch.isnan(values), torch.iinfo(torch.int32).max, key)


def _runs(seg: torch.Tensor, num_segments: int, values: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """In-range rows ordered by segment (stably, after any prior order of
    ``values``'s rows), and each segment's ``[start, end)`` in that order.

    Returns ``(values_sorted, seg_sorted, start, end)``.
    """
    keep = (seg >= 0) & (seg < num_segments)
    v, s = values[keep], seg[keep].to(torch.int64)
    order = torch.argsort(s, stable=True)
    v, s = v[order], s[order]
    ids = torch.arange(num_segments, device=seg.device)
    return (v, s, torch.searchsorted(s, ids),
            torch.searchsorted(s, ids, right=True))


def _run_sums(x: torch.Tensor, start: torch.Tensor,
              end: torch.Tensor) -> torch.Tensor:
    """``x[start[i]:end[i]].sum(0)`` for every run ``i`` of ``(n, L)``
    rows, each run summed on its own: runs whose lengths share a power of
    two are gathered into one zero-padded ``(runs, width, L)`` block (at
    most twice their rows) and summed along the width."""
    length = end - start
    out = x.new_zeros((start.shape[0], x.shape[1]))
    live = length > 0
    if not bool(live.any()):
        return out
    cls = torch.where(live, torch.floor(torch.log2(
        length.clamp(min=1).to(torch.float64))).to(torch.int64), -1)
    for c in torch.unique(cls[live]).tolist():
        sel = torch.nonzero(cls == c).flatten()
        width = int(length[sel].max())
        offs = torch.arange(width, device=x.device)
        idx = (start[sel, None] + offs).clamp(max=x.shape[0] - 1)
        block = x[idx]
        block = torch.where((offs < length[sel, None])[..., None], block, 0.0)
        out[sel] = block.sum(dim=1)
    return out


def segment_reduce_fused(values: torch.Tensor, segment_ids: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """Sum-reduce ``(N, L)`` float32 values by segment → ``(S, L)``."""
    v, _, start, end = _runs(segment_ids, num_segments,
                             values.to(torch.float64))

    def run_sums(x):
        return _run_sums(x, start, end)

    finite = torch.isfinite(v)
    total = run_sums(torch.where(finite, v, 0.0))
    nan = run_sums(torch.isnan(v).to(torch.float64)) > 0
    pinf = run_sums((v == float("inf")).to(torch.float64)) > 0
    ninf = run_sums((v == float("-inf")).to(torch.float64)) > 0
    total = torch.where(pinf, float("inf"), total)
    total = torch.where(ninf, float("-inf"), total)
    total = torch.where(nan | (pinf & ninf), float("nan"), total)
    return total.to(torch.float32)


def segment_reduce(values: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int, op: str = "sum") -> torch.Tensor:
    """One-lane segment ``sum``/``min``/``max`` → ``(num_segments,)``."""
    if op == "sum":
        return segment_reduce_fused(values[:, None], segment_ids,
                                    num_segments)[:, 0]
    if op not in ("min", "max"):
        raise ValueError(f"unknown op {op!r}")
    values = values.to(torch.float32)
    # sort by value first (NaN last, -0.0 before +0.0); the stable sort by
    # segment in _runs keeps that order inside each run
    by_value = torch.argsort(order_key(values), stable=True)
    v, _, start, end = _runs(segment_ids[by_value], num_segments,
                             values[by_value])
    out = torch.full((num_segments,), _INITS[op], dtype=torch.float32,
                     device=values.device)
    if v.numel() == 0:
        return out
    nonempty = end > start
    first = v[torch.clamp(start, max=v.numel() - 1)]
    last = v[torch.clamp(end - 1, min=0)]
    got = torch.where(torch.isnan(last), last, first) if op == "min" else last
    return torch.where(nonempty, got, out)
