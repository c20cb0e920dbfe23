"""Distributed table operators — paper Tables II/III and the shuffle (Fig 2).

The hash half of the reference's operators, on PyTorch tensors.  Every
distributed operator is local columnar work plus the bucket-exchange
**shuffle** built on the array all-to-all.  Shards are virtual
(``core/context.py``): each operator runs its per-shard phases in a loop
over the shards, and the phases meet at the exchange choke point
(``core/exchange.py:hash_shuffle`` → ``core/array_ops.py:all_to_all``).
The reference's per-shard functions (``_join_impl``, ``_groupby_impl``,
``_setop_impl``) are split at their ``hash_shuffle`` call.

Static-shape contract (reference DESIGN.md §2): shuffles move
fixed-capacity buckets; overflow (rows beyond a bucket or an output
capacity) is *counted and returned*, never silently corrupted.

Operators implemented here (→ paper table):
  select, project                          — Table II (local)
  union, difference                        — Table II (distributed)
  intersect, join, orderby, aggregate,
  groupby(+aggregate)                      — Table III (distributed)
  window_aggregate, rank, topk, quantile   — ordered analytics (§9)
  shuffle                                  — Fig 2 primitive

``join(method="sort")`` and ``cartesian`` belong to a later slice of the
port and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .array_ops import allgather, allreduce, ppermute
from .context import HPTMTContext
from .exchange import (_scatter_rows, check_no_reserved, compact_rows,
                       hash_shuffle, key_compare_u32, lex_order, order_lanes,
                       range_shuffle, take_hashes)
from .operator import Abstraction, operator
from .table import (DistTable, _pad_axis0, hash_columns,
                    partitioning_ascending, partitioning_keys,
                    partitioning_kind, range_partitioning)

Cols = Dict[str, torch.Tensor]

_LATER = "is not ported yet: it arrives with a later slice of the PyTorch port"


def _zero(dev) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=dev)


def _mask_for(count: torch.Tensor, capacity: int) -> torch.Tensor:
    return torch.arange(capacity, device=count.device) < count


def _cap(cols: Cols) -> int:
    return next(iter(cols.values())).shape[0]


def _bcast(mask: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Broadcast a row mask over ``v``'s trailing dims; zero masked rows."""
    return torch.where(mask.reshape((-1,) + (1,) * (v.dim() - 1)), v,
                       torch.zeros_like(v))


# ===========================================================================
# the shuffle primitive (Fig 2)
# ===========================================================================
def _bucket_capacity(capacity: int, n_shards: int, factor: float) -> int:
    if n_shards == 1:
        return capacity
    return max(1, min(capacity, math.ceil(capacity * factor / n_shards)))


def _partitioned_on(dt: DistTable, keys: Sequence[str],
                    ctx: HPTMTContext) -> bool:
    """True when ``dt``'s rows are already hash-co-located on ``keys``.

    Metadata is trusted only on an exact ``(ordered keys, n_shards)`` match —
    the murmur chain is order-sensitive (reference DESIGN.md §4).
    """
    return (ctx.n_shards > 1
            and dt.partitioning == (tuple(keys), ctx.n_shards))


@operator("table.shuffle", Abstraction.TABLE)
def shuffle(dt: DistTable, keys: Sequence[str], *, ctx: HPTMTContext,
            out_capacity: Optional[int] = None, bucket_factor: float = 2.0,
            ) -> Tuple[DistTable, torch.Tensor]:
    """Re-distribute rows so equal keys land on the same shard (Fig 2).

    A no-op when ``dt.partitioning`` already records a hash exchange on
    exactly these keys — unless the call also asks for a resize.  The
    output carries ``(keys, n_shards)`` partitioning metadata so downstream
    join/groupby/set ops on the same keys skip their own shuffle.
    """
    n = ctx.n_shards
    if _partitioned_on(dt, keys, ctx) and (out_capacity is None
                                           or out_capacity == dt.capacity):
        return dt, _zero(dt.device)
    cols, counts = dt.shards()
    out, new_counts, overflow = hash_shuffle(
        cols, counts, tuple(keys), n,
        _bucket_capacity(dt.capacity, n, bucket_factor),
        out_capacity or dt.capacity)
    return (DistTable.from_shards(out, new_counts, (tuple(keys), n)),
            allreduce(overflow))


# ===========================================================================
# local operators (Table II: Select / Project)
# ===========================================================================
@operator("table.select", Abstraction.TABLE, distributed=False)
def select(dt: DistTable, predicate: Callable[[Cols], torch.Tensor], *,
           ctx: HPTMTContext) -> DistTable:
    """Filter rows by a per-row predicate over the columns (Table II)."""
    outs, counts = [], []
    for cols, count in zip(*dt.shards()):
        cap = _cap(cols)
        keep = predicate(cols) & _mask_for(count, cap)
        out, n, _ = compact_rows(cols, keep, cap)
        outs.append(out)
        counts.append(n)
    # rows never change shards: the partitioning layout survives filtering
    return DistTable.from_shards(outs, counts, dt.partitioning)


@operator("table.project", Abstraction.TABLE, distributed=False)
def project(dt: DistTable, columns: Sequence[str], *,
            ctx: HPTMTContext) -> DistTable:
    """Keep only the named columns (Table II). Purely local.

    Partitioning metadata survives only while every key column is still
    present.
    """
    part = dt.partitioning
    if part is not None and not set(partitioning_keys(part)) <= set(columns):
        part = None
    return DistTable({k: dt.columns[k] for k in columns}, dt.counts, part)


# ===========================================================================
# OrderBy (Table III) — multi-key distributed sample sort (DESIGN.md §9)
# ===========================================================================
def _normalize_order(by, ascending, column_names, kwarg: str):
    """Validate sort keys/directions eagerly; returns ``(keys, ascending)``.

    ``by`` is a column name or a sequence of them; ``ascending`` a bool or
    a per-key sequence.  Errors name the offending kwarg and value.
    """
    keys = (by,) if isinstance(by, str) else tuple(by)
    if not keys:
        raise ValueError(f"{kwarg}= needs at least one key column")
    missing = [k for k in keys if k not in column_names]
    if missing:
        raise ValueError(f"{kwarg}= names unknown column(s) {missing}; "
                         f"table has {sorted(column_names)}")
    if isinstance(ascending, bool):
        asc = (ascending,) * len(keys)
    else:
        asc = tuple(bool(a) for a in ascending)
        if len(asc) != len(keys):
            raise ValueError(
                f"ascending= has {len(asc)} entries for {len(keys)} "
                f"{kwarg}= keys — provide one bool, or one per key")
    return keys, asc


@operator("table.orderby", Abstraction.TABLE)
def orderby(dt: DistTable, by, *, ctx: HPTMTContext,
            ascending=True, out_capacity: Optional[int] = None,
            bucket_factor: float = 2.0, n_samples: int = 64,
            ) -> Tuple[DistTable, torch.Tensor]:
    """Globally sort rows via multi-key sample sort (Table III OrderBy).

    ``by`` is one column name or a sequence; ``ascending`` one bool or one
    per key.  NaN keys sort LAST in both directions.  Destination shards
    come from sampled splitters and the rows ride the same single packed
    all-to-all as a hash shuffle; rows with equal full keys never straddle
    a shard boundary.

    The output records ``("range", keys, ascending, n_shards)``
    partitioning: ``window`` / ``rank`` / ``quantile`` / another
    ``orderby`` on the same keys then add no exchange and no sort.  A call
    on an input already carrying exactly this layout is a no-op (unless it
    also resizes).
    """
    keys, asc = _normalize_order(by, ascending, dt.column_names, "by")
    n = ctx.n_shards
    part = range_partitioning(keys, asc, n)
    if dt.partitioning == part and (out_capacity is None
                                    or out_capacity == dt.capacity):
        return dt, _zero(dt.device)
    cols, counts = dt.shards()
    out, new_counts, overflow = range_shuffle(
        cols, counts, keys, asc, n,
        _bucket_capacity(dt.capacity, n, bucket_factor),
        out_capacity or dt.capacity, n_samples=min(n_samples, dt.capacity))
    return DistTable.from_shards(out, new_counts, part), allreduce(overflow)


@operator("table.local_sort", Abstraction.TABLE)
def local_sort(dt: DistTable, by, *, ctx: HPTMTContext, ascending=True,
               partitioning: object = "auto"
               ) -> Tuple[DistTable, torch.Tensor]:
    """Sort rows *within each shard* — no exchange.

    Rows never cross shards, so this is not a global sort on its own.
    ``partitioning`` stamps the output metadata: ``"auto"`` keeps a hash
    layout (rows did not move) and drops anything else — a range layout
    on other keys no longer describes the order; an explicit value is
    trusted verbatim.  Same NaN-last key semantics as ``orderby``.
    """
    keys, asc = _normalize_order(by, ascending, dt.column_names, "by")
    if partitioning == "auto":
        part = dt.partitioning if partitioning_kind(dt.partitioning) \
            == "hash" else None
    else:
        part = partitioning
    outs = []
    for cols, count in zip(*dt.shards()):
        order = lex_order(order_lanes(cols, keys, asc),
                          _mask_for(count, _cap(cols)))
        outs.append({k: v[order] for k, v in cols.items()})
    return DistTable.from_shards(outs, dt.counts.unbind(0), part), \
        _zero(dt.device)


# ===========================================================================
# Windowed aggregation / rank / top-k / quantile (DESIGN.md §9)
# ===========================================================================
@operator("table.window", Abstraction.TABLE)
def window_aggregate(dt: DistTable, partition_by, order_by, aggs, *,
                     ctx: HPTMTContext, rows: Optional[int] = None,
                     ascending=True, bucket_factor: float = 2.0,
                     n_samples: int = 64) -> Tuple[DistTable, torch.Tensor]:
    """SQL-style window functions over ``(PARTITION BY, ORDER BY)`` groups.

    ``aggs`` entries are ``(column, op)`` or ``(column, op, offset)`` with
    op in sum/mean/count/min/max (over a trailing window of ``rows`` rows;
    ``None`` = cumulative), lag/lead (offset gathers, zero outside the
    partition), and ``(None, "row_number")`` / ``(None, "rank")``.  Output
    = input columns plus one labeled column per agg; rows never move or
    drop.  A window wider than its partition clips to it (SQL ROWS
    BETWEEN); partition identity is the ordering identity.

    The input must be ordered by ``partition_by + order_by``: when its
    metadata already records that range layout the sort is elided and the
    operator adds no exchange and no sort (halo and carry state move by
    ppermute and all-gather); otherwise one sample-sort exchange runs
    first.  Overflow counts *truncated windows*; zero certifies the
    result.
    """
    from ..window import eval_window, normalize_aggs  # window imports core

    pkeys = tuple(partition_by) if not isinstance(partition_by, str) \
        else (partition_by,)
    missing = [k for k in pkeys if k not in dt.column_names]
    if missing:
        raise ValueError(f"partition_by= names unknown column(s) "
                         f"{missing}; table has {sorted(dt.column_names)}")
    okeys, asc_o = _normalize_order(order_by, ascending, dt.column_names,
                                    "order_by")
    norm = normalize_aggs(aggs, dt.column_names, rows)
    n = ctx.n_shards
    max_off = max((p for _, _, op, p in norm if op in ("lag", "lead")),
                  default=0)
    lookback = max(rows - 1 if rows is not None else 0, max_off)
    if n > 1 and lookback > dt.capacity:
        raise ValueError(
            f"window lookback {lookback} (rows=/lag/lead offsets) exceeds "
            f"the per-shard capacity {dt.capacity}; raise the capacity or "
            f"repartition over fewer shards")
    keys = pkeys + okeys
    asc = (True,) * len(pkeys) + asc_o
    part = range_partitioning(keys, asc, n)
    cols, counts = dt.shards()
    ov = [_zero(dt.device) for _ in cols]
    if dt.partitioning != part:
        cols, counts, ov = range_shuffle(
            cols, counts, keys, asc, n,
            _bucket_capacity(dt.capacity, n, bucket_factor), dt.capacity,
            n_samples=min(n_samples, dt.capacity))
    new_cols, o = eval_window(cols, counts, pkeys=pkeys, okeys=okeys,
                              ascending=asc, aggs=norm, rows=rows,
                              n_shards=n)
    outs = [dict(c, **nc) for c, nc in zip(cols, new_cols)]
    return (DistTable.from_shards(outs, counts, part),
            allreduce([a + b for a, b in zip(ov, o)]))


def rank(dt: DistTable, partition_by, order_by, *, ctx: HPTMTContext,
         ascending=True, **kw) -> Tuple[DistTable, torch.Tensor]:
    """Convenience: add SQL ``rank`` (+``row_number``) window columns."""
    return window_aggregate(
        dt, partition_by, order_by,
        [(None, "rank"), (None, "row_number")], ctx=ctx,
        ascending=ascending, **kw)


def _topk_candidates(cols: Cols, valid: torch.Tensor, keys, asc, k: int):
    """The first ``k`` rows of ``cols`` in ``(keys, asc)`` order."""
    take = lex_order(order_lanes(cols, keys, asc), valid)[:k]
    return {name: v[take] for name, v in cols.items()}


@operator("table.topk", Abstraction.TABLE)
def topk(dt: DistTable, by, k: int, *, ctx: HPTMTContext,
         largest: bool = True, ascending=None) -> DistTable:
    """The first ``k`` rows of the global sort order, without a global
    sort: per-shard top-k candidates tree-reduce over ``log2(p)`` ppermute
    rounds of 2k-row merges (pairs ``s + 2^t → s``, own candidates first)
    — no exchange.

    ``largest=True`` (default) means descending by ``by``; ``ascending=``
    per-key directions override.  The result lands on shard 0, globally
    sorted, with the matching range metadata.
    """
    if not isinstance(k, int) or k < 1:
        raise ValueError(f"k={k!r} must be a positive int")
    if ctx.n_shards > 1 and k > dt.capacity:
        # a shard can only surface `capacity` candidates, so a bigger k
        # would silently return fewer rows than asked — reject eagerly
        raise ValueError(
            f"k={k} exceeds the per-shard capacity {dt.capacity}; raise "
            f"the capacity or use orderby for a full sort")
    if ascending is None:
        ascending = not largest
    keys, asc = _normalize_order(by, ascending, dt.column_names, "by")
    n = ctx.n_shards
    k = min(k, dt.capacity)
    cand, ccnt = [], []
    for cols, count in zip(*dt.shards()):
        cand.append(_topk_candidates(cols, _mask_for(count, _cap(cols)),
                                     keys, asc, k))
        ccnt.append(torch.clamp(count, max=k))
    for t in range(max(n - 1, 0).bit_length()):
        step = 1 << t
        perm = [(s + step, s) for s in range(0, n - step, 2 * step)]
        recv = {name: ppermute([c[name] for c in cand], perm)
                for name in cand[0]}
        rcnt = ppermute(ccnt, perm)
        # only receivers merge: a shard that receives nothing would merge
        # with zero valid rows and keep its candidates
        for _, s in perm:
            merged = {name: torch.cat([v, recv[name][s]])
                      for name, v in cand[s].items()}
            j = torch.arange(k, device=dt.device)
            cand[s] = _topk_candidates(
                merged, torch.cat([j < ccnt[s], j < rcnt[s]]), keys, asc, k)
            ccnt[s] = torch.clamp(ccnt[s] + rcnt[s], max=k)
    if n > 1:
        keep = torch.arange(k, device=dt.device) < ccnt[0]
        cand = [{name: _bcast(keep, v) for name, v in cand[0].items()}] + [
            {name: torch.zeros_like(v) for name, v in cand[0].items()}
            for _ in range(n - 1)]
        ccnt = [ccnt[0]] + [torch.zeros_like(ccnt[0])] * (n - 1)
    return DistTable.from_shards(cand, ccnt, range_partitioning(keys, asc, n))


def _quantile_approx(cols, counts, column, qarr, n_samples):
    """Splitter-style sketch: quantiles of a pooled per-shard regular
    sample of the non-NaN values; no exchange."""
    samples, nvals = [], []
    for c, count in zip(cols, counts):
        col = c[column].to(torch.float32)
        cap = col.shape[0]
        mask = _mask_for(count, cap) & ~torch.isnan(col)
        svals, scnt, _ = compact_rows({"v": col}, mask, cap)
        stride = torch.clamp(scnt // n_samples, min=1)
        sidx = torch.minimum(
            torch.arange(n_samples, device=col.device) * stride,
            torch.clamp(scnt - 1, min=0))
        ok = sidx < scnt
        samples.append(torch.where(ok, svals["v"][sidx], float("inf")))
        nvals.append(ok.sum(dtype=torch.int32))
    sample = allgather(samples).reshape(-1)
    nval = allreduce(nvals)
    ones = torch.ones(sample.shape[0], dtype=torch.bool, device=sample.device)
    sample = sample[lex_order([sample], ones)]  # invalid (+inf) sort last
    t = qarr * torch.clamp(nval - 1, min=0).to(torch.float32)
    lo, hi = torch.floor(t).to(torch.int64), torch.ceil(t).to(torch.int64)
    last = sample.shape[0] - 1
    vlo = sample[torch.clamp(lo, 0, last)]
    vhi = sample[torch.clamp(hi, 0, last)]
    out = vlo + (t - lo.to(torch.float32)) * (vhi - vlo)
    return torch.where(nval > 0, out, float("nan"))


def _quantile_exact(cols, counts, column, qarr, sort_ov):
    """Order statistics off a range layout sorted ascending on ``column``:
    rank → shard arithmetic and one masked all-reduce per boundary."""
    vals, nns = [], []
    for c, count in zip(cols, counts):
        col = c[column].to(torch.float32)
        vals.append(col)
        nns.append((_mask_for(count, col.shape[0])
                    & ~torch.isnan(col)).sum(dtype=torch.int32))
    nn_all = allgather(nns)
    offsets = torch.cumsum(nn_all, 0) - nn_all
    total = nn_all.sum()
    t = qarr * torch.clamp(total - 1, min=0).to(torch.float32)
    lo, hi = torch.floor(t).to(torch.int64), torch.ceil(t).to(torch.int64)

    def fetch(g):  # global rank → value, via one masked all-reduce
        parts = []
        for s, col in enumerate(vals):
            local = g - offsets[s]
            have = (local >= 0) & (local < nns[s])
            parts.append(torch.where(
                have, col[torch.clamp(local, 0, col.shape[0] - 1)], 0.0))
        return allreduce(parts)

    vlo, vhi = fetch(lo), fetch(hi)
    out = vlo + (t - lo.to(torch.float32)) * (vhi - vlo)
    # a skew-overflowed internal sort dropped rows: poison, never mislead
    return torch.where((total > 0) & (allreduce(sort_ov) == 0), out,
                       float("nan"))


@operator("table.quantile", Abstraction.TABLE)
def quantile(dt: DistTable, column: str, qs, *, ctx: HPTMTContext,
             method: str = "auto", bucket_factor: float = 2.0,
             n_samples: int = 64) -> torch.Tensor:
    """Quantiles of one column, numpy ``nanquantile`` semantics (linear
    interpolation, NaNs excluded): a ``(len(qs),)`` float32 tensor.

    ``method="exact"`` reads the true order statistics off the range
    layout: an input already sorted ascending on ``column`` costs no
    exchange and no sort; otherwise one sample-sort exchange runs first.
    ``method="approx"`` is the quantile of a pooled per-shard regular
    sample, never an exchange.  ``"auto"`` picks exact when the layout is
    already there (or on one shard), else approx.
    """
    if column not in dt.column_names:
        raise ValueError(f"column= names unknown column {column!r}; "
                         f"table has {sorted(dt.column_names)}")
    if method not in ("auto", "exact", "approx"):
        raise ValueError(f"unknown quantile method={method!r}; expected "
                         f"'auto', 'exact' or 'approx'")
    if np.isscalar(qs) and not isinstance(qs, (str, bytes)):
        qs = (float(qs),)
    else:
        try:
            qs = tuple(float(q) for q in qs)
        except TypeError:
            raise ValueError(f"qs={qs!r} must be a probability or a "
                             f"sequence of probabilities") from None
    bad = [q for q in qs if not 0.0 <= q <= 1.0]
    if bad:
        raise ValueError(f"qs= values {bad} outside [0, 1]")
    n = ctx.n_shards
    # a range layout whose FIRST key is this column ascending proves the
    # global order the exact path reads ranks from
    asc = partitioning_ascending(dt.partitioning)
    sorted_on_col = (partitioning_kind(dt.partitioning) == "range"
                     and partitioning_keys(dt.partitioning)[:1] == (column,)
                     and bool(asc and asc[0]))
    if method == "auto":
        method = "exact" if (sorted_on_col or n == 1) else "approx"
    if dt.capacity == 0:  # gathers on size-0 columns are ill-formed
        return torch.full((len(qs),), float("nan"), device=dt.device)
    qarr = torch.tensor(qs, dtype=torch.float32, device=dt.device)
    cols, counts = dt.shards()
    n_samples = min(n_samples, dt.capacity)
    if method == "approx":
        return _quantile_approx(cols, counts, column, qarr, n_samples)
    sort_ov = [_zero(dt.device) for _ in cols]
    if not sorted_on_col:
        cols, counts, sort_ov = range_shuffle(
            cols, counts, (column,), (True,), n,
            _bucket_capacity(dt.capacity, n, bucket_factor), dt.capacity,
            n_samples=n_samples)
    return _quantile_exact(cols, counts, column, qarr, sort_ov)


# ===========================================================================
# Join (Table III) — shuffle + local hash build/probe
# ===========================================================================
_JOIN_HOWS = ("inner", "left", "right", "outer")


def _hash_slots(n_rows: int) -> int:
    """Power-of-two slot count with 4x head-room — the one sizing rule for
    every build table (join, set ops, groupby hash)."""
    return 1 << max(int(4 * n_rows - 1).bit_length(), 6)


def _emit_join_columns(lcols: Cols, rcols: Cols, keys, li, ri) -> Cols:
    """Late-materialized join output from ``(left_row, right_row)`` pairs.

    Key columns come from whichever side the pair has (left wins when
    both); absent sides zero-fill, so pure-padding pairs are zero rows.
    """
    has_l, has_r = li >= 0, ri >= 0
    li_s = torch.where(has_l, li, 0).to(torch.int64)
    ri_s = torch.where(has_r, ri, 0).to(torch.int64)
    out: Cols = {}
    for k in keys:
        lv = lcols[k][li_s]
        out[k] = torch.where(has_l.reshape((-1,) + (1,) * (lv.dim() - 1)),
                             lv, _bcast(has_r, rcols[k][ri_s]))
    for k, v in lcols.items():
        if k in keys:
            continue
        out[k] = _bcast(has_l, v[li_s])
    for k, v in rcols.items():
        if k in keys:
            continue
        name = k if k not in lcols else f"{k}_r"
        out[name] = _bcast(has_r, v[ri_s])
    out["_matched"] = has_l & has_r
    return out


def _local_hash_join(lcols: Cols, ln, rcols: Cols, rn, *, keys, how,
                     max_matches, max_probes, out_capacity):
    """Sort-free local join: hash build over the right side, counted
    two-pass probe by the left, late-materialized payload gather.

    Overflow counts verified matches dropped by ``max_matches``,
    probe/build rows that exhausted ``max_probes``, and rows past
    ``out_capacity``.
    """
    from ..kernels.hash_join import ops as hjops

    lcols, lh1, lh2 = take_hashes(lcols, keys)
    rcols, rh1, rh2 = take_hashes(rcols, keys)
    lcap, rcap = _cap(lcols), _cap(rcols)
    lmask, rmask = _mask_for(ln, lcap), _mask_for(rn, rcap)
    lkeys = key_compare_u32(lcols, keys)
    rkeys = key_compare_u32(rcols, keys)

    slots = _hash_slots(rcap)
    table, n_unplaced = hjops.build_table(rh1, rh2, rmask, slots, max_probes)
    records, side = hjops.slot_records(table, rh2, rkeys)
    cnt, rimat, exhausted = hjops.probe(records, side, lh1, lh2, lkeys,
                                        lmask, max_matches, max_probes)

    emit_n = torch.clamp(cnt, max=max_matches)
    if how in ("left", "outer"):
        emit_n = torch.clamp(emit_n, min=1)
    emit_n = torch.where(lmask, emit_n, 0)
    base = torch.cumsum(emit_n, dim=0, dtype=torch.int32) - emit_n
    total = emit_n.sum(dtype=torch.int32)
    li, ri = hjops.emit_lookup(rimat, base, emit_n, total, out_capacity)
    overflow = (torch.where(lmask, torch.clamp(cnt - max_matches, min=0), 0)
                .sum(dtype=torch.int32)
                + exhausted.sum(dtype=torch.int32) + n_unplaced)
    if how in ("right", "outer"):
        # tail: right rows no left row's key matches, found by the reverse
        # membership probe (a unique-key table over the LEFT side) — a
        # right row whose pairs were all dropped by the fan-out cap stays
        # matched, so capped pairs never resurface as unmatched rows
        lowner, _, l_unres = hjops.build_table_unique(
            lh1, lh2, lkeys, lmask, _hash_slots(lcap), max_probes)
        lrec, lside = hjops.slot_records(lowner, lh2, lkeys)
        rcnt, _, rexh = hjops.probe(lrec, lside, rh1, rh2, rkeys, rmask, 1,
                                    max_probes)
        tail = rmask & (rcnt == 0) & ~rexh
        tpos = torch.where(tail, total + torch.cumsum(tail, 0) - 1,
                           out_capacity)
        fill = tpos < out_capacity
        ri = ri.clone()
        ri[tpos[fill]] = torch.arange(rcap, dtype=torch.int32,
                                      device=ri.device)[fill]
        total = total + tail.sum(dtype=torch.int32)
        overflow = (overflow + l_unres.sum(dtype=torch.int32)
                    + rexh.sum(dtype=torch.int32))

    out = _emit_join_columns(lcols, rcols, keys, li, ri)
    overflow = overflow + torch.clamp(total - out_capacity, min=0)
    return out, torch.clamp(total, max=out_capacity), overflow


def _shuffle_side(cols, counts, ov, keys, n_shards, bucket, mid_cap):
    """Hash-shuffle one input of a binary operator, carrying ``(h1, h2)``
    so its local phase never rehashes; adds the overflow to ``ov``."""
    cols, counts, o = hash_shuffle(cols, counts, keys, n_shards, bucket,
                                   mid_cap, carry_hashes=True)
    return cols, counts, [a + b for a, b in zip(ov, o)]


def _join_impl(lc: List[Cols], lcnt, rc: List[Cols], rcnt, *, keys, how,
               max_matches, max_probes, n_shards, lbucket, rbucket,
               mid_cap_l, mid_cap_r, out_capacity, shuffle_left,
               shuffle_right):
    ov = [_zero(c.device) for c in lcnt]
    if n_shards > 1:
        # co-locate equal keys.  A side whose partitioning metadata already
        # proves co-location skips its exchange; its hashes are recomputed
        # locally by take_hashes.
        if shuffle_left:
            lc, lcnt, ov = _shuffle_side(lc, lcnt, ov, keys, n_shards,
                                         lbucket, mid_cap_l)
        if shuffle_right:
            rc, rcnt, ov = _shuffle_side(rc, rcnt, ov, keys, n_shards,
                                         rbucket, mid_cap_r)
    outs, counts = [], []
    for s in range(len(lc)):
        out, cnt, o = _local_hash_join(
            lc[s], lcnt[s], rc[s], rcnt[s], keys=keys, how=how,
            max_matches=max_matches, max_probes=max_probes,
            out_capacity=out_capacity)
        outs.append(out)
        counts.append(cnt)
        ov[s] = ov[s] + o
    return outs, counts, allreduce(ov)


@operator("table.join", Abstraction.TABLE)
def join(left: DistTable, right: DistTable, keys: Sequence[str], *,
         ctx: HPTMTContext, how: str = "inner", max_matches: int = 1,
         out_capacity: Optional[int] = None,
         bucket_factor: float = 2.0, method: str = "auto",
         max_probes: Optional[int] = None
         ) -> Tuple[DistTable, torch.Tensor]:
    """Distributed equi-join: shuffle-by-key + local hash build/probe
    (Table III); ``how`` is inner/left/right/outer.

    ``method="hash"`` (the ``"auto"`` choice) is a sort-free
    open-addressing build over the right side plus a counted two-pass
    probe with late-materialized payload gathers.  ``method="sort"`` (the
    reference's sort-merge oracle) is not ported yet.  Put the smaller
    table on the right — it is the build side.

    ``max_matches`` bounds the join fan-out per left row; matches beyond
    it — and rows whose probe chain exceeds ``max_probes`` — are counted
    in the returned overflow.  A side already hash-partitioned on exactly
    ``keys`` skips its shuffle; the output is itself partitioned on
    ``keys``.
    """
    if how not in _JOIN_HOWS:
        raise ValueError(f"unknown join type how={how!r}; "
                         f"expected one of {_JOIN_HOWS}")
    if method not in ("auto", "hash", "sort"):
        raise ValueError(f"unknown join method={method!r}; "
                         f"expected 'auto', 'hash' or 'sort'")
    if max_matches < 1:
        raise ValueError(f"max_matches={max_matches} must be >= 1")
    if method == "sort":
        raise NotImplementedError(f"join(method='sort') {_LATER}")
    check_no_reserved(left.column_names)
    check_no_reserved(right.column_names)
    n = ctx.n_shards
    mid_l = max(left.capacity, 1)
    mid_r = max(right.capacity, 1)
    default_out = mid_l * max_matches + (
        mid_r if how in ("right", "outer") else 0)
    lc, lcnt = left.shards()
    rc, rcnt = right.shards()
    outs, counts, overflow = _join_impl(
        lc, lcnt, rc, rcnt, keys=tuple(keys), how=how,
        max_matches=max_matches,
        max_probes=max_probes or max(64, 2 * max_matches), n_shards=n,
        lbucket=_bucket_capacity(left.capacity, n, bucket_factor),
        rbucket=_bucket_capacity(right.capacity, n, bucket_factor),
        mid_cap_l=mid_l, mid_cap_r=mid_r,
        out_capacity=out_capacity or default_out,
        shuffle_left=not _partitioned_on(left, keys, ctx),
        shuffle_right=not _partitioned_on(right, keys, ctx))
    return DistTable.from_shards(outs, counts, (tuple(keys), n)), overflow


# ===========================================================================
# GroupBy + Aggregate (Table III)
# ===========================================================================
_SEGMENT_OPS = ("sum", "mean", "min", "max", "count")


def split_aggs(aggs):
    """Decompose aggregates into (map-side partial, merge) aggregates.

    sum/count/min/max combine associatively; mean decomposes into a sum and
    a count that are summed at the merge and divided at finalize.
    """
    partial, merge = [], []
    for col, op in aggs:
        if op in ("sum", "count"):
            partial.append((col, op))
            merge.append((f"{col}_{op}", "sum"))
        elif op in ("min", "max"):
            partial.append((col, op))
            merge.append((f"{col}_{op}", op))
        elif op == "mean":
            partial.append((col, "sum"))
            partial.append((col, "count"))
            merge.append((f"{col}_sum", "sum"))
            merge.append((f"{col}_count", "sum"))
        else:
            raise ValueError(op)
    return tuple(dict.fromkeys(partial)), tuple(dict.fromkeys(merge))


def finalize_agg_cols(cols: Cols, aggs, merge_aggs) -> Cols:
    """Rename merged partial-aggregate columns to the user's labels; means
    are finalized as sum/count here (and only here)."""
    merge_labels = {f"{c}_{o}" for c, o in merge_aggs}
    out = {k: v for k, v in cols.items() if k not in merge_labels}
    for col, op in aggs:
        if op == "mean":
            s, c = cols[f"{col}_sum_sum"], cols[f"{col}_count_sum"]
            out[f"{col}_mean"] = s / torch.clamp(c, min=1.0)
        elif op in ("sum", "count"):
            out[f"{col}_{op}"] = cols[f"{col}_{op}_sum"]
        else:
            out[f"{col}_{op}"] = cols[f"{col}_{op}_{op}"]
    return out


def _agg_outputs(aggs, seg_count, sums, minmax, out_capacity):
    """Assemble labeled aggregate columns from the shared reductions."""
    out: Cols = {}
    for col, agg in aggs:
        label = f"{col}_{agg}"
        if agg == "count":
            out[label] = seg_count[:out_capacity]
        elif agg == "sum":
            out[label] = sums[col][:out_capacity]
        elif agg == "mean":
            s = sums[col]
            cnt = seg_count.reshape((-1,) + (1,) * (s.dim() - 1))
            out[label] = (s / torch.clamp(cnt, min=1.0))[:out_capacity]
        else:
            out[label] = minmax[(col, agg)][:out_capacity]
    return out


def _segment_aggregates(cols: Cols, aggs, seg_id, n_segments: int):
    """All reductions for ``aggs`` over ``seg_id`` with minimal passes.

    Every sum-combining lane (counts + sums, incl. both halves of mean)
    rides ONE fused segment reduction — trailing dims flatten to extra
    lanes and are reshaped back after; min/max reduce per column lane.
    Repeated (column, op) pairs are computed once.
    """
    from ..kernels.segment_reduce import ops as segops

    cap = seg_id.shape[0]
    seg_id = seg_id.to(torch.int32)
    need_count = any(a in ("count", "mean") for _, a in aggs)
    sum_cols = list(dict.fromkeys(
        c for c, a in aggs if a in ("sum", "mean")))
    parts, spans = [], []  # spans: (col name | None=count, trailing, lanes)
    if need_count:
        parts.append(torch.ones((cap, 1), dtype=torch.float32,
                                device=seg_id.device))
        spans.append((None, (), 1))
    for c in sum_cols:
        v = cols[c].to(torch.float32).reshape(cap, -1)
        parts.append(v)
        spans.append((c, tuple(cols[c].shape[1:]), v.shape[1]))
    seg_count, sums = None, {}
    if parts:
        fused = segops.segment_reduce_fused(torch.cat(parts, dim=1), seg_id,
                                            n_segments)
        off = 0
        for name, trailing, lanes in spans:
            block = fused[:, off:off + lanes]
            off += lanes
            if name is None:
                seg_count = block[:, 0]
            else:
                sums[name] = block.reshape((n_segments,) + trailing)
    minmax = {}
    for col, agg in aggs:
        if agg in ("min", "max") and (col, agg) not in minmax:
            v = cols[col].to(torch.float32)
            lanes = [segops.segment_reduce(lane, seg_id, n_segments, op=agg)
                     for lane in v.reshape(cap, -1).unbind(1)]
            minmax[(col, agg)] = torch.stack(lanes, dim=1).reshape(
                (n_segments,) + tuple(v.shape[1:]))
    return seg_count, sums, minmax


def _local_groupby_sort(cols: Cols, count, *, keys, aggs, out_capacity):
    """Sort-based grouping: lexsort keys, segment-reduce runs."""
    cap = _cap(cols)
    dev = count.device
    mask = _mask_for(count, cap)
    order = lex_order([cols[k] for k in keys], mask)
    sorted_cols = {k: v[order] for k, v in cols.items()}
    smask = mask[order]

    # a row opens a new segment when ANY key differs from its predecessor
    # (row 0 always does)
    new_seg = torch.zeros(cap, dtype=torch.bool, device=dev)
    new_seg[0] = True
    for k in keys:
        col = sorted_cols[k]
        new_seg[1:] |= col[1:] != col[:-1]
    new_seg &= smask
    seg_id = torch.cumsum(new_seg, dim=0, dtype=torch.int32) - 1
    n_seg = torch.clamp(torch.where(smask, seg_id, -1).max() + 1, min=0)
    seg_id = torch.where(smask, seg_id, cap)  # sentinel bucket for invalid

    out: Cols = {}
    # first row of each segment via counting scatter (segment ids of the
    # boundary rows are unique), no argsort
    first_idx = _scatter_rows(
        torch.arange(cap, dtype=torch.int32, device=dev),
        torch.where(new_seg, seg_id, cap), cap).to(torch.int64)
    for k in keys:
        out[k] = sorted_cols[k][first_idx][:out_capacity]
    # invalid rows carry the sentinel id ``cap``; reducing ``cap`` segments
    # drops them in the kernel instead of piling them into one contended
    # bucket (the reference reduces ``cap + 1`` and never reads the last)
    seg_count, sums, minmax = _segment_aggregates(
        sorted_cols, aggs, seg_id, cap)
    out.update(_agg_outputs(aggs, seg_count, sums, minmax, out_capacity))
    # zero-fill rows beyond n_seg; pad when out_capacity exceeds the input
    # capacity (there can be at most ``cap`` groups, the rest is padding)
    m = _mask_for(torch.clamp(n_seg, max=out_capacity), out_capacity)
    out = {k: _bcast(m, _pad_axis0(v, out_capacity)) for k, v in out.items()}
    overflow = torch.clamp(n_seg - out_capacity, min=0)
    return out, torch.clamp(n_seg, max=out_capacity), overflow


def _local_groupby_hash(cols: Cols, count, *, keys, aggs, out_capacity,
                        max_probes: int = 64):
    """Sort-free grouping: claim hash-table slots, segment-reduce by slot.

    Each valid row double-hash-probes a power-of-two slot table via
    ``build_table_unique``: the lowest row index probing a free slot claims
    it for its key, and rows match a slot only after comparing their
    ACTUAL bitwise key lanes against the claimant.  Rows unresolved after
    ``max_probes`` are counted as overflow.  O(n) per round, zero sorts.
    """
    from ..kernels.hash_join import ops as hjops

    cap = _cap(cols)
    mask = _mask_for(count, cap)
    slots = _hash_slots(out_capacity)
    h1, h2 = hash_columns([cols[k] for k in keys])
    owner, seg, unresolved = hjops.build_table_unique(
        h1, h2, key_compare_u32(cols, keys), mask, slots, max_probes)

    occupied = owner >= 0
    claimant = torch.where(occupied, owner, 0).to(torch.int64)
    slot_cols: Cols = {k: _bcast(occupied, cols[k][claimant]) for k in keys}
    # unresolved and invalid rows carry the sentinel slot ``slots``, which
    # the reduction over ``slots`` segments drops (see the sort path)
    seg_count, sums, minmax = _segment_aggregates(cols, aggs, seg, slots)
    slot_cols.update(_agg_outputs(aggs, seg_count, sums, minmax, slots))
    out, n_seg, trunc = compact_rows(slot_cols, occupied, out_capacity)
    overflow = unresolved.sum(dtype=torch.int32) + trunc
    return out, n_seg, overflow


def _local_groupby(cols: Cols, count, *, keys, aggs, out_capacity,
                   method: str = "auto"):
    """Local grouping, dispatching sort vs hash.

    ``auto`` picks the sort-free hash table when the caller declared low
    cardinality (``out_capacity`` at most a quarter of the row capacity),
    else the sort path.  Returns ``(columns, n_groups, overflow)``.
    """
    if method == "auto":
        method = "hash" if out_capacity * 4 <= _cap(cols) else "sort"
    if method == "hash":
        return _local_groupby_hash(cols, count, keys=keys, aggs=aggs,
                                   out_capacity=out_capacity)
    return _local_groupby_sort(cols, count, keys=keys, aggs=aggs,
                               out_capacity=out_capacity)


def _local_groupby_all(cols, counts, **kw):
    """:func:`_local_groupby` on every shard → three per-shard lists."""
    res = [_local_groupby(c, n, **kw) for c, n in zip(cols, counts)]
    return tuple(list(x) for x in zip(*res))


def _groupby_impl(cols, counts, *, keys, aggs, n_shards, bucket,
                  mid_capacity, out_capacity, elide, combine, partial_cap,
                  combine_bucket, method):
    if n_shards > 1 and not elide:
        if combine:
            # map-side combine: pre-aggregate locally so only distinct
            # (key, partial) rows enter the packed exchange
            partial_aggs, merge_aggs = split_aggs(aggs)
            pcols, pcount, ov = _local_groupby_all(
                cols, counts, keys=keys, aggs=partial_aggs,
                out_capacity=partial_cap, method=method)
            pcols, pcount, o = hash_shuffle(
                pcols, pcount, keys, n_shards, combine_bucket,
                n_shards * combine_bucket)
            out, n_seg, o2 = _local_groupby_all(
                pcols, pcount, keys=keys, aggs=merge_aggs,
                out_capacity=out_capacity, method=method)
            out = [finalize_agg_cols(c, aggs, merge_aggs) for c in out]
            ov = ov + o + o2
        else:
            cols, counts, o = hash_shuffle(cols, counts, keys, n_shards,
                                           bucket, mid_capacity)
            out, n_seg, o2 = _local_groupby_all(
                cols, counts, keys=keys, aggs=aggs,
                out_capacity=out_capacity, method=method)
            ov = o + o2
    else:
        # single shard, or rows already co-located on the keys: no exchange
        out, n_seg, ov = _local_groupby_all(
            cols, counts, keys=keys, aggs=aggs, out_capacity=out_capacity,
            method=method)
    return out, n_seg, allreduce(ov)


@operator("table.groupby", Abstraction.TABLE)
def groupby_aggregate(dt: DistTable, keys: Sequence[str],
                      aggs: Sequence[Tuple[str, str]], *, ctx: HPTMTContext,
                      out_capacity: Optional[int] = None,
                      bucket_factor: float = 2.0,
                      combine: "bool | str" = "auto",
                      method: str = "auto",
                      ) -> Tuple[DistTable, torch.Tensor]:
    """GroupBy + aggregate (Table III): shuffle-by-key + segment reduce.

    ``aggs`` is a list of ``(column, op)`` with op in sum/mean/min/max/count.

    * **Shuffle elision** — when ``dt.partitioning`` records that rows are
      already hash-co-located on exactly these ``keys``, the exchange is
      skipped and grouping is purely local.
    * **Map-side combine** (``combine``) — pre-aggregate locally before the
      exchange so only distinct ``(key, partial)`` rows cross shards;
      ``"auto"`` enables it when ``out_capacity`` declares cardinality below
      the row capacity.

    ``method`` selects the local grouping kernel: ``"sort"``, ``"hash"``
    (sort-free slot table), or ``"auto"``.
    """
    for _, a in aggs:
        if a not in _SEGMENT_OPS:
            raise ValueError(f"unknown aggregate {a!r}")
    if method not in ("auto", "sort", "hash"):
        raise ValueError(f"unknown groupby method {method!r}")
    if not isinstance(combine, bool) and combine != "auto":
        raise ValueError(f"combine must be a bool or 'auto', got {combine!r}")
    check_no_reserved(dt.column_names)
    n = ctx.n_shards
    out_cap = out_capacity or dt.capacity
    do_combine = combine if isinstance(combine, bool) else (
        out_cap < dt.capacity)
    partial_cap = (dt.capacity if out_cap >= dt.capacity
                   else min(dt.capacity, out_cap * n))
    cols, counts = dt.shards()
    outs, n_seg, overflow = _groupby_impl(
        cols, counts, keys=tuple(keys), aggs=tuple(aggs), n_shards=n,
        bucket=_bucket_capacity(dt.capacity, n, bucket_factor),
        mid_capacity=dt.capacity, out_capacity=out_cap,
        elide=_partitioned_on(dt, keys, ctx), combine=do_combine,
        partial_cap=partial_cap,
        combine_bucket=_bucket_capacity(partial_cap, n, bucket_factor),
        method=method)
    return DistTable.from_shards(outs, n_seg, (tuple(keys), n)), overflow


@operator("table.aggregate", Abstraction.TABLE)
def aggregate(dt: DistTable, column: str, op: str, *, ctx: HPTMTContext):
    """Global scalar aggregate of one column (Table III Aggregate)."""
    if op not in _SEGMENT_OPS:
        raise ValueError(f"unknown aggregate {op!r}")
    vals, rows = [], []
    for cols, count in zip(*dt.shards()):
        mask = _mask_for(count, _cap(cols))
        col = cols[column].to(torch.float32)
        rows.append(mask.to(torch.float32).sum())
        if op in ("sum", "mean"):
            vals.append(torch.where(mask, col, 0.0).sum())
        elif op == "count":
            vals.append(rows[-1])
        elif op == "min":
            vals.append(torch.where(mask, col, float("inf")).min())
        else:
            vals.append(torch.where(mask, col, float("-inf")).max())
    if op == "min":
        return torch.stack(vals).min()
    if op == "max":
        return torch.stack(vals).max()
    v = allreduce(vals)
    if op == "mean":
        v = v / torch.clamp(allreduce(rows), min=1.0)
    return v


# ===========================================================================
# set operators: Union / Difference / Intersect (Table II/III)
# ===========================================================================
def _dedup_hash(cols: Cols, h1, h2, mask, max_probes: int = 64):
    """Keep the lowest-index row of every bitwise-equal duplicate group.

    Rows claim unique-key slots (``build_table_unique`` over the carried
    full-row hashes) and only slot claimants survive.  Rows whose probe
    chain exhausts are *kept* and counted.  Returns ``(keep,
    n_unresolved)``.
    """
    from ..kernels.hash_join import ops as hjops

    cap = h1.shape[0]
    slots = _hash_slots(cap)
    keys_u32 = key_compare_u32(cols, tuple(sorted(cols)))
    owner, seg, unresolved = hjops.build_table_unique(
        h1, h2, keys_u32, mask, slots, max_probes)
    rows = torch.arange(cap, dtype=torch.int32, device=h1.device)
    # invalid rows carry the sentinel slot; clamp it like the reference's
    # gather does (their verdict is masked out below)
    at = torch.clamp(torch.where(unresolved, 0, seg), max=slots - 1)
    claimant = owner[at.to(torch.int64)] == rows
    keep = mask & (unresolved | claimant)
    return keep, unresolved.sum(dtype=torch.int32)


def _membership_hash(a_cols: Cols, amask, ah1, ah2, b_cols: Cols, bmask,
                     bh1, bh2, names, max_probes: int = 64):
    """For each row of A: does a bitwise-equal row exist in B?

    Hash + verify over a unique-key slot table of B.  Returns ``(found,
    n_overflow)`` where the count covers B rows missing from the table and
    A probes that exhausted.
    """
    from ..kernels.hash_join import ops as hjops

    bkeys = key_compare_u32(b_cols, names)
    akeys = key_compare_u32(a_cols, names)
    owner, _, b_unres = hjops.build_table_unique(
        bh1, bh2, bkeys, bmask, _hash_slots(bh1.shape[0]), max_probes)
    records, side = hjops.slot_records(owner, bh2, bkeys)
    cnt, _, exhausted = hjops.probe(records, side, ah1, ah2, akeys, amask, 1,
                                    max_probes)
    found = amask & (cnt > 0)
    overflow = (b_unres.sum(dtype=torch.int32)
                + exhausted.sum(dtype=torch.int32))
    return found, overflow


def _local_setop(acols: Cols, an, bcols: Cols, bn, *, kind, names,
                 out_capacity):
    # hashes: popped from the shuffle carry, or computed once here
    acols, ah1, ah2 = take_hashes(acols, names)
    bcols, bh1, bh2 = take_hashes(bcols, names)
    amask, bmask = _mask_for(an, _cap(acols)), _mask_for(bn, _cap(bcols))

    if kind == "union":
        # concat then hash-dedup (hashes concatenate alongside the rows)
        cat = {k: torch.cat([acols[k], bcols[k]]) for k in acols}
        keep, o_dedup = _dedup_hash(cat, torch.cat([ah1, bh1]),
                                    torch.cat([ah2, bh2]),
                                    torch.cat([amask, bmask]))
        out, cnt, o = compact_rows(cat, keep, out_capacity)
    elif kind == "difference":
        found, o_dedup = _membership_hash(acols, amask, ah1, ah2, bcols,
                                          bmask, bh1, bh2, names)
        out, cnt, o = compact_rows(acols, amask & ~found, out_capacity)
    else:  # intersect
        found, o_mem = _membership_hash(acols, amask, ah1, ah2, bcols,
                                        bmask, bh1, bh2, names)
        keep, o_d = _dedup_hash(acols, ah1, ah2, found)
        o_dedup = o_mem + o_d
        out, cnt, o = compact_rows(acols, keep, out_capacity)
    return out, cnt, o + o_dedup


def _setop_impl(ac, acnt, bc, bcnt, *, kind, names, n_shards, abucket,
                bbucket, mid_a, mid_b, out_capacity, shuffle_a, shuffle_b):
    ov = [_zero(c.device) for c in acnt]
    if n_shards > 1:
        # sides whose metadata proves co-location on the full schema skip
        # their exchange
        if shuffle_a:
            ac, acnt, ov = _shuffle_side(ac, acnt, ov, names, n_shards,
                                         abucket, mid_a)
        if shuffle_b:
            bc, bcnt, ov = _shuffle_side(bc, bcnt, ov, names, n_shards,
                                         bbucket, mid_b)
    outs, counts = [], []
    for s in range(len(ac)):
        out, cnt, o = _local_setop(ac[s], acnt[s], bc[s], bcnt[s], kind=kind,
                                   names=names, out_capacity=out_capacity)
        outs.append(out)
        counts.append(cnt)
        ov[s] = ov[s] + o
    return outs, counts, allreduce(ov)


def _make_setop(kind: str, opname: str, doc: str):
    @operator(opname, Abstraction.TABLE)
    def op(a: DistTable, b: DistTable, *, ctx: HPTMTContext,
           out_capacity: Optional[int] = None, bucket_factor: float = 2.0,
           ) -> Tuple[DistTable, torch.Tensor]:
        names = tuple(sorted(set(a.column_names) & set(b.column_names)))
        if names != a.column_names or names != b.column_names:
            raise ValueError("set operators require identical schemas")
        check_no_reserved(names)
        n = ctx.n_shards
        default_out = (a.capacity + b.capacity if kind == "union"
                       else a.capacity)
        ac, acnt = a.shards()
        bc, bcnt = b.shards()
        outs, counts, overflow = _setop_impl(
            ac, acnt, bc, bcnt, kind=kind, names=names, n_shards=n,
            abucket=_bucket_capacity(a.capacity, n, bucket_factor),
            bbucket=_bucket_capacity(b.capacity, n, bucket_factor),
            mid_a=a.capacity, mid_b=b.capacity,
            out_capacity=out_capacity or default_out,
            shuffle_a=not _partitioned_on(a, names, ctx),
            shuffle_b=not _partitioned_on(b, names, ctx))
        # output rows keep the shard their full-row hash assigned
        return DistTable.from_shards(outs, counts, (names, n)), overflow

    op.__doc__ = doc
    op.__name__ = kind
    return op


union = _make_setop("union", "table.union",
                    "Distributed Union with duplicate removal (Table II).")
difference = _make_setop(
    "difference", "table.difference",
    "Rows of A with no equal row in B (Table II Difference).")
intersect = _make_setop(
    "intersect", "table.intersect",
    "Deduplicated rows of A that also appear in B (Table III Intersect).")


@operator("table.cartesian", Abstraction.TABLE)
def cartesian(a: DistTable, b: DistTable, *, ctx: HPTMTContext,
              out_capacity: Optional[int] = None) -> DistTable:
    """Cartesian product (Table II) — not ported yet."""
    raise NotImplementedError(f"cartesian {_LATER}")
