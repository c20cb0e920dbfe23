"""Segment machinery for ordered analytics (reference DESIGN.md §9).

A table sorted by ``(partition, order)`` keys turns window PARTITIONs into
contiguous SEGMENTS — runs of rows whose partition-key lanes are equal.
Boundaries are one adjacent-row lane compare, and every windowed operator
consumes the same two tensors:

  * ``new_seg (n,) bool`` — the row starts a new segment;
  * ``seg_start (n,) int64`` — index of the row's segment start (a running
    max over flagged indices).

Partition identity is the ordering identity (``exchange.sort_key_lanes``):
all NaNs are one partition, ``-0.0`` and ``+0.0`` two.

Cross-shard state, for a partition a range layout splits across a shard
boundary (equal full keys never straddle one, equal partition keys can):

  * :func:`tail_halo` / :func:`head_halo` — the last (first) rows of the
    neighbouring shard, moved with one ``array_ops.spmd_ppermute``, so
    bounded lookback (rolling windows, lag) and lookahead (lead) read
    across;
  * :func:`chain_carries` — per-shard boundary summaries pooled with
    ``array_ops.spmd_allgather`` and chained, so unbounded lookback
    (cumulatives, row_number, rank) adds the contribution of every
    preceding shard of the same partition.

Neither goes through ``array_ops.all_to_all``: a window on a range layout
adds no exchange.  The halo and carry functions take one entry per shard
this process holds — every shard when they are virtual, the rank's own
with ``group=`` (``core/context.py``); halo pairs are global shard ids.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from ..core.array_ops import shard_span, spmd_ppermute
# one op table for the whole ordered stack: the carry chain combines
# exactly like the scans it extends
from ..kernels.window_scan.ref import _IDENTITY, _combine

Cols = Dict[str, torch.Tensor]


def boundary_flags(lanes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``new_seg`` flags from ``(n, L)`` key lanes (L may be 0: one global
    partition).  Invalid rows are each their own segment, so padding can
    never join — or bridge — a real partition."""
    n = valid.shape[0]
    first = torch.zeros(n, dtype=torch.bool, device=valid.device)
    first[:1] = True
    if lanes.shape[1]:
        diff = torch.cat([first[:1], (lanes[1:] != lanes[:-1]).any(dim=1)])
    else:
        diff = first
    prev_invalid = torch.cat([first[:1], ~valid[:-1]])
    return first | diff | prev_invalid | ~valid


def flag_starts(flags: torch.Tensor) -> torch.Tensor:
    """``seg_start[i]`` = index of the nearest flagged row at or before i
    (0 before the first flag).

    The reference's running max (``lax.cummax``) becomes a gather of the
    flagged indices by running flag count: ``torch.cummax`` on a 1-D CUDA
    tensor scans one row with one block and took half a second at 2^25
    rows, where ``cumsum`` and ``nonzero`` are device-wide scans.
    """
    starts = flags.nonzero().squeeze(1)
    if starts.numel() == 0:
        return torch.zeros(flags.shape, dtype=torch.int64,
                           device=flags.device)
    nth = torch.cumsum(flags, 0) - 1  # flags at or before i, minus one
    return torch.where(nth >= 0, starts[torch.clamp(nth, min=0)], 0)


def _take(arrays: Cols, src: torch.Tensor, ok: torch.Tensor) -> Cols:
    """``arrays[src]`` with ``src`` clamped (the reference relies on JAX
    clamping) and rows where ``ok`` is false zeroed."""
    out = {}
    for name, v in arrays.items():
        g = v[torch.clamp(src, 0, v.shape[0] - 1)]
        out[name] = torch.where(ok.reshape((-1,) + (1,) * (g.dim() - 1)), g,
                                torch.zeros_like(g))
    return out


def _send(taken: List[Cols], ok: List[torch.Tensor], perm, group
          ) -> Tuple[List[Cols], List[torch.Tensor]]:
    """ppermute every array and the valid flags; a shard no pair sends to
    (shard 0 of a backward halo, every shard of a single-shard table)
    receives zeros, i.e. no valid row."""
    recv = [dict() for _ in taken]
    for name in taken[0]:
        sent = spmd_ppermute([t[name] for t in taken], perm, group=group)
        for s, v in enumerate(sent):
            recv[s][name] = v
    return recv, spmd_ppermute(ok, perm, group=group)


def tail_halo(arrays: Sequence[Cols], counts: Sequence[torch.Tensor], h: int,
              group=None) -> Tuple[List[Cols], List[torch.Tensor]]:
    """Last ``h`` valid rows of each shard, delivered to the NEXT shard.

    Returns, per shard, ``(received arrays (h, ...), received valid
    (h,))`` — the rows globally right before the shard's row 0, oldest
    first; missing positions (a short predecessor, or shard 0's absent
    one) are invalid.
    """
    taken, oks = [], []
    for a, count in zip(arrays, counts):
        src = count - h + torch.arange(h, device=count.device)
        ok = src >= 0
        taken.append(_take(a, src, ok))
        oks.append(ok)
    n = shard_span(taken, group)[0]
    return _send(taken, oks, [(s, s + 1) for s in range(n - 1)], group)


def head_halo(arrays: Sequence[Cols], counts: Sequence[torch.Tensor], k: int,
              group=None) -> Tuple[List[Cols], List[torch.Tensor]]:
    """First ``k`` valid rows of each shard, delivered to the PREVIOUS
    shard — the forward (lead) counterpart of :func:`tail_halo`."""
    taken, oks = [], []
    for a, count in zip(arrays, counts):
        j = torch.arange(k, device=count.device)
        ok = j < count
        taken.append(_take(a, j, ok))
        oks.append(ok)
    n = shard_span(taken, group)[0]
    return _send(taken, oks, [(s + 1, s) for s in range(n - 1)], group)


def chain_carries(head_keys: torch.Tensor, tail_keys: torch.Tensor,
                  tail_vals: torch.Tensor, whole: torch.Tensor,
                  nonempty: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Cross-shard prefix carry for each shard's HEAD segment.

    Inputs are all-gathered per-shard summaries, leading dim
    ``n_shards``: first/last valid row's partition-key lanes, the
    reduction of each shard's TAIL segment, whether the whole shard is one
    segment, and whether it holds any row.  ``carry[s]`` reduces every row
    of ``s``'s head partition on shards ``< s`` (the identity when the
    partition starts at ``s``).  The chain walks shards right to left and
    passes through empty shards, which splitter duplication can park in
    the middle of a partition.
    """
    p = head_keys.shape[0]
    ident = torch.full(tuple(tail_vals.shape[1:]), _IDENTITY[op],
                       dtype=tail_vals.dtype, device=tail_vals.device)
    true = torch.ones((), dtype=torch.bool, device=tail_vals.device)
    outs = []
    for s in range(p):
        carry, alive = ident, true
        for r in range(s - 1, -1, -1):
            keymatch = (tail_keys[r] == head_keys[s]).all() \
                if head_keys.shape[1] else true
            link = alive & nonempty[r] & keymatch
            carry = torch.where(link, _combine(op, tail_vals[r], carry),
                                carry)
            alive = alive & (~nonempty[r] | (link & whole[r]))
        outs.append(carry)
    return torch.stack(outs)
