"""Cylon-style eager DataFrame API over the HPTMT table operators (PyTorch).

Global-view programming (paper §V-B): the user manipulates one logical
DataFrame; operators run over the context's shards on its device (the
card, unless the context says ``device="cpu"``).  ``to_numpy()`` /
``to_torch()`` are the bridges to array code (paper Figs 13/17 interop).

The port carries the hash surface (construction, select, project, join
by hash or sort-merge, groupby, hash repartition, the set operators,
scalar aggregates), the ordered surface (``sort_values``, range
repartition, ``window(...).agg``, ``rank``, ``topk``, ``quantile``) and
storage and Arrow interop (``read_parquet``/``read_dataset``,
``to_parquet``, ``to_hpt``, ``from_arrow``, ``to_arrow``; ``repro_torch.io``),
the out-of-core path (``spill=`` on ``join``, ``groupby`` and
``Window.agg``; ``repro_torch.spill``) and the lazy planner
(``lazy()``; ``repro_torch.plan``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import table_ops
from ..core.context import HPTMTContext
from ..core.report import OverflowError, OverflowReport
from ..core.table import DistTable, Table, as_tensor, partitioning_kind


def _publish_report(report: OverflowReport) -> OverflowReport:
    """Mirror a lineage report into the active telemetry collector (a
    no-op when telemetry is off).  Gauge semantics make re-publishing a
    cumulative lineage idempotent — overflow shows up in the metrics
    dump under the same dotted labels the report itself uses."""
    from .. import telemetry

    rec = telemetry.current()
    if rec is not None:
        rec.record_overflow(report)
    return report


def _spill_mode(spill: object) -> object:
    """Validate the ``spill=`` tri-state eagerly, naming the bad value."""
    if spill not in (False, True, "auto"):
        raise ValueError(
            f"spill={spill!r}: expected False (in-memory, overflow "
            f"raises), 'auto' (spill when the budget or an overflow "
            f"demands it), or True (force the out-of-core path)")
    return spill


class DataFrame:
    """``spill=`` on join/groupby/window selects the out-of-core path
    (reference DESIGN.md §10): ``False`` keeps the all-in-memory behavior
    (overflow raises), ``"auto"`` pre-checks the input against
    ``budget_rows`` and — when the in-memory attempt still overflows —
    retries once through the spill engine, and ``True`` forces spill.
    Every operator's overflow lands in :attr:`overflow_report`, the one
    exactness certificate for the whole lineage.
    """

    def __init__(self, table: DistTable, ctx: HPTMTContext,
                 report: Optional[OverflowReport] = None):
        self._t = table
        self._ctx = ctx
        self._report = report if report is not None else OverflowReport()

    @property
    def overflow_report(self) -> OverflowReport:
        """Unified overflow accounting across this frame's lineage."""
        return self._report

    # -- construction ----------------------------------------------------
    @classmethod
    def from_dict(cls, data: Dict[str, np.ndarray], ctx: HPTMTContext,
                  capacity: Optional[int] = None,
                  bucket_factor: float = 1.0) -> "DataFrame":
        """Build a DataFrame, block-partitioned over the context's shards.

        Columns narrow as the JAX package's do (int64 → int32, float64 →
        float32) and land on the context's device.  ``bucket_factor``
        over-allocates each shard's capacity beyond ``capacity`` (or the
        exact ``ceil(rows / n_shards)`` default) so that a *later* shuffle
        has head-room for hash skew.  A ``capacity``/``bucket_factor`` too
        small to hold the input rows is rejected here.

        On a process group every rank passes the same global ``data`` (the
        reference's global view); each slices the rows of its own shards
        on the host and copies only those to its device.
        """
        lengths = {k: np.shape(v)[0] if np.ndim(v) else 0
                   for k, v in data.items()}
        if len(set(lengths.values())) > 1:
            common = max(set(lengths.values()),
                         key=lambda n: sum(v == n for v in lengths.values()))
            ragged = sorted(f"{k} has {n} rows" for k, n in lengths.items()
                            if n != common)
            raise ValueError(
                f"ragged column lengths: {ragged} vs {common} rows in the "
                f"other column(s) — every column must have the same length")
        n = next(iter(lengths.values()), 0)
        per = math.ceil((capacity or -(-n // ctx.n_shards)) * bucket_factor)
        if per * ctx.n_shards < n:
            raise ValueError(
                f"per-shard capacity {per} x {ctx.n_shards} shards cannot "
                f"hold {n} rows — raise capacity or bucket_factor")
        if ctx.group is None:
            t = Table.from_arrays({k: as_tensor(v, ctx.device)
                                   for k, v in data.items()})
            return cls(DistTable.from_local(t, ctx, capacity=per), ctx)
        rows = -(-n // ctx.n_shards)  # rows a shard (the last may be short)
        lo = min(ctx.local_shards.start * rows, n)
        hi = min(ctx.local_shards.stop * rows, n)
        t = Table.from_arrays({k: as_tensor(v[lo:hi], ctx.device)
                               for k, v in data.items()})
        return cls(DistTable.from_local(t, ctx, capacity=per, total_rows=n,
                                        first_row=lo), ctx)

    # -- storage & Arrow interop (repro_torch.io) -------------------------
    @classmethod
    def read_parquet(cls, path: str, ctx: HPTMTContext, *,
                     columns: Optional[Sequence[str]] = None,
                     predicate=None, capacity: Optional[int] = None,
                     bucket_factor: float = 1.0,
                     allow_narrowing: bool = False,
                     strict: bool = True) -> "DataFrame":
        """Scan an on-disk dataset (Parquet or native ``.hpt`` — format
        auto-detected) with projection + predicate pushdown, onto the
        context's device.

        A dataset written with ``partition_by`` re-enters with its
        ``partitioning`` metadata attached when the context's shard count
        matches, so a following ``join``/``groupby`` on the partition keys
        moves no data.

        ``strict=False`` records a capacity overflow under
        ``"scan.capacity"`` in the frame's :attr:`overflow_report`
        instead of raising — the caller owns the exactness decision.
        """
        from ..io import read_dataset

        dt, overflow, _ = read_dataset(
            path, ctx=ctx, columns=columns, predicate=predicate,
            capacity=capacity, bucket_factor=bucket_factor,
            allow_narrowing=allow_narrowing)
        if strict:
            cls._check(overflow, "scan")
        return cls(dt, ctx, _publish_report(
            OverflowReport().add("scan.capacity", overflow)))

    read_dataset = read_parquet  # format-neutral alias

    def to_parquet(self, path: str, *,
                   partition_by: Optional[Sequence[str]] = None,
                   rows_per_group: Optional[int] = None,
                   format: Optional[str] = "parquet") -> "DataFrame":
        """Write as a sharded Parquet dataset (``format="hpt"`` for the
        dependency-free native container; ``None``/"auto" picks parquet
        when pyarrow is available).

        ``partition_by`` hash-shuffles rows first (elided when already
        partitioned) and records the layout in the dataset manifest, so a
        later :meth:`read_parquet` on a matching context restores the
        shuffle-elision evidence.
        """
        from ..io import write_dist_table

        overflow = write_dist_table(self._t, path, ctx=self._ctx,
                                    format=format, partition_by=partition_by,
                                    rows_per_group=rows_per_group)
        self._check(overflow, "to_parquet")
        return self

    def to_hpt(self, path: str, *,
               partition_by: Optional[Sequence[str]] = None,
               rows_per_group: Optional[int] = None) -> "DataFrame":
        return self.to_parquet(path, partition_by=partition_by,
                               rows_per_group=rows_per_group, format="hpt")

    @classmethod
    def from_arrow(cls, arrow_table, ctx: HPTMTContext,
                   capacity: Optional[int] = None,
                   bucket_factor: float = 1.0) -> "DataFrame":
        """Ingest a pyarrow Table (nulls rejected eagerly — the columns
        then narrow and move as in :meth:`from_dict`)."""
        from ..io import from_arrow as _from_arrow

        cols, _ = _from_arrow(arrow_table)
        return cls.from_dict(cols, ctx, capacity=capacity,
                             bucket_factor=bucket_factor)

    def to_arrow(self):
        """Materialize valid rows as a pyarrow Table (paper §VI interop)."""
        from ..io import to_arrow as _to_arrow

        return _to_arrow(self.to_numpy())

    # -- metadata ------------------------------------------------------------
    @property
    def columns(self) -> Tuple[str, ...]:
        return self._t.column_names

    def __len__(self) -> int:
        return int(self._t.num_rows())

    @property
    def table(self) -> DistTable:
        return self._t

    @property
    def partitioning(self):
        """The layout evidence tuple: ``(hash_keys, n_shards)`` after a
        hash exchange, ``("range", keys, ascending, n_shards)`` after an
        orderby/range repartition, else None.  Hash layouts let
        join/groupby/set ops on matching keys skip their shuffle; range
        layouts let window/rank/quantile/orderby skip their sort."""
        return self._t.partitioning

    @property
    def partitioning_kind(self):
        """``"hash"``, ``"range"`` or ``None`` — the layout kind."""
        return partitioning_kind(self._t.partitioning)

    # -- relational operators (eager) ------------------------------------------
    def select(self, predicate: Callable) -> "DataFrame":
        return self._child(table_ops.select(self._t, predicate,
                                            ctx=self._ctx))

    def project(self, cols: Sequence[str]) -> "DataFrame":
        return self._child(table_ops.project(self._t, cols, ctx=self._ctx))

    def join(self, other: "DataFrame", on: Sequence[str], how: str = "inner",
             *, method: str = "auto", max_matches: int = 1,
             spill: object = False, budget_rows: Optional[int] = None,
             spill_workdir: Optional[str] = None, **kw) -> "DataFrame":
        """Equi-join on ``on``; ``how`` is inner/left/right/outer;
        ``method`` is ``"hash"`` (the ``"auto"`` choice) or ``"sort"``
        (sort-merge, with a probe ``window=`` of equal-hash candidates).

        ``max_matches`` bounds the fan-out per left row; matches beyond it
        count as overflow and raise here.

        ``spill="auto"`` spills to disk when either input exceeds
        ``n_shards * budget_rows`` rows (or, lacking a budget, when the
        in-memory attempt overflows); ``spill=True`` forces the
        out-of-core path.  The runs go to a fresh ``tempfile`` directory,
        made under ``spill_workdir`` when one is given (else ``TMPDIR``)
        and removed afterwards; nothing else in ``spill_workdir`` is
        touched.  Extra keyword arguments apply to the in-memory path
        only.  On a process group both triggers are the group's — the
        row count and the overflow are every rank's — so every rank
        spills or none does, into one directory rank 0 makes (under a
        ``spill_workdir`` every rank sees).
        """
        from ..spill import should_spill, spill_join

        _spill_mode(spill)
        budget = budget_rows or max(self._t.capacity, other._t.capacity)
        ns = self._ctx.n_shards

        def _spilled() -> "DataFrame":
            return self._from_spill(
                spill_join(self._t, other._t, on, ctx=self._ctx,
                           budget_rows=budget, how=how, method=method,
                           max_matches=max_matches,
                           max_probes=kw.get("max_probes"),
                           workdir=spill_workdir), other)

        if spill is True or (spill == "auto" and budget_rows is not None and
                             (should_spill(len(self), ns, budget_rows) or
                              should_spill(len(other), ns, budget_rows))):
            return _spilled()
        out, ov = table_ops.join(self._t, other._t, on, ctx=self._ctx,
                                 how=how, method=method,
                                 max_matches=max_matches, **kw)
        if int(ov) != 0 and spill == "auto":
            return _spilled()
        self._check(ov, "join")
        return self._child(out, other)

    def groupby(self, keys: Sequence[str],
                aggs: Sequence[Tuple[str, str]], *,
                spill: object = False, budget_rows: Optional[int] = None,
                spill_workdir: Optional[str] = None, **kw) -> "DataFrame":
        """Hash-aggregate ``aggs`` per distinct ``keys`` combination.

        ``spill="auto"``/``spill=True``/``budget_rows`` select the
        out-of-core path exactly as in :meth:`join`.
        """
        from ..spill import should_spill, spill_groupby

        _spill_mode(spill)
        budget = budget_rows or self._t.capacity

        def _spilled() -> "DataFrame":
            return self._from_spill(
                spill_groupby(self._t, keys, aggs, ctx=self._ctx,
                              budget_rows=budget, workdir=spill_workdir))

        if spill is True or (spill == "auto" and budget_rows is not None and
                             should_spill(len(self), self._ctx.n_shards,
                                          budget_rows)):
            return _spilled()
        out, ov = table_ops.groupby_aggregate(self._t, keys, aggs,
                                              ctx=self._ctx, **kw)
        if int(ov) != 0 and spill == "auto":
            return _spilled()
        self._check(ov, "groupby")
        return self._child(out)

    def repartition(self, keys: Sequence[str], mode: str = "hash",
                    ascending=True, **kw) -> "DataFrame":
        """Re-distribute rows: ``mode="hash"`` co-locates equal ``keys`` on
        a shard (Fig 2); ``mode="range"`` globally sorts by ``keys`` via
        the sample-sort exchange — contiguous key ranges per shard,
        locally sorted.

        Either way the result records its layout (see
        :attr:`partitioning`), so chained operators on the same keys elide
        their shuffles.  A no-op when the layout already holds.
        """
        if mode not in ("hash", "range"):
            raise ValueError(f"unknown repartition mode={mode!r}; "
                             f"expected 'hash' or 'range'")
        keys = (keys,) if isinstance(keys, str) else tuple(keys)
        missing = [k for k in keys if k not in self.columns]
        if missing:
            raise ValueError(f"keys= names unknown column(s) {missing}; "
                             f"table has {sorted(self.columns)}")
        if mode == "range":
            return self.sort_values(list(keys), ascending=ascending, **kw)
        out, ov = table_ops.shuffle(self._t, keys, ctx=self._ctx, **kw)
        self._check(ov, "shuffle")
        return self._child(out)

    def sort_values(self, by, ascending=True, **kw) -> "DataFrame":
        """Globally sort by one or more columns (multi-key sample sort;
        per-key ``ascending``, NaNs always last)."""
        out, ov = table_ops.orderby(self._t, by, ctx=self._ctx,
                                    ascending=ascending, **kw)
        self._check(ov, "orderby")
        return self._child(out)

    def window(self, partition_by, order_by, ascending=True) -> "Window":
        """SQL-style window builder: ``df.window(["g"], ["t"]).agg([...],
        rows=32)`` — see :meth:`Window.agg`."""
        return Window(self, partition_by, order_by, ascending)

    def rank(self, partition_by, order_by, ascending=True,
             **kw) -> "DataFrame":
        """Add ``rank`` and ``row_number`` columns per partition/order."""
        out, ov = table_ops.rank(self._t, partition_by, order_by,
                                 ctx=self._ctx, ascending=ascending, **kw)
        self._check(ov, "rank")
        return self._child(out)

    def topk(self, by, k: int, largest: bool = True, **kw) -> "DataFrame":
        """The global top-``k`` rows by ``by`` — per-shard candidates
        tree-reduced over ppermute rounds, no global sort."""
        return self._child(table_ops.topk(self._t, by, k, ctx=self._ctx,
                                          largest=largest, **kw))

    def quantile(self, column: str, qs, method: str = "auto", **kw):
        """Quantiles of ``column`` (numpy ``nanquantile`` semantics).

        Scalar ``qs`` returns a float; a sequence returns a numpy array.
        ``method="exact"`` adds no exchange on a range-sorted input;
        ``"approx"`` is the splitter-sample sketch.
        """
        out = table_ops.quantile(self._t, column, qs, ctx=self._ctx,
                                 method=method, **kw)
        arr = out.cpu().numpy()
        scalar = np.isscalar(qs) and not isinstance(qs, (str, bytes))
        return float(arr[0]) if scalar else arr

    def union(self, other: "DataFrame", **kw) -> "DataFrame":
        out, ov = table_ops.union(self._t, other._t, ctx=self._ctx, **kw)
        self._check(ov, "union")
        return self._child(out, other)

    def difference(self, other: "DataFrame", **kw) -> "DataFrame":
        out, ov = table_ops.difference(self._t, other._t, ctx=self._ctx, **kw)
        self._check(ov, "difference")
        return self._child(out, other)

    def intersect(self, other: "DataFrame", **kw) -> "DataFrame":
        out, ov = table_ops.intersect(self._t, other._t, ctx=self._ctx, **kw)
        self._check(ov, "intersect")
        return self._child(out, other)

    def agg(self, column: str, op: str):
        return float(table_ops.aggregate(self._t, column, op, ctx=self._ctx))

    # -- lazy planning (repro_torch.plan) ----------------------------------
    def lazy(self, name: str = "table"):
        """Start a lazy expression graph rooted at this frame's table.

        Chained operators on the returned :class:`~repro_torch.plan.
        LazyFrame` only build a logical plan; ``.collect()`` optimizes it
        (predicate/projection pushdown, chained exchange elision, join
        reordering, global layout choice) and runs the whole pipeline as
        one program — the eager chain's rows, never more exchanges.
        ``.explain()`` shows the plan without running it.
        """
        from ..plan import LazyFrame
        from ..plan.logical import source

        return LazyFrame(source(self._t, name), self._ctx, self._report)

    # -- interop bridges ----------------------------------------------------
    def to_numpy(self) -> Dict[str, np.ndarray]:
        return self._t.to_numpy()

    def to_torch(self, columns: Optional[Sequence[str]] = None
                 ) -> torch.Tensor:
        """Stack numeric columns into a dense ``(rows, cols)`` float32
        matrix on the frame's device."""
        rows = self._t.valid_rows()
        names = columns or self._t.column_names
        return torch.stack([rows[c].to(torch.float32) for c in names], dim=1)

    # -- spill / overflow plumbing ------------------------------------------
    def _child(self, out: DistTable, *others: "DataFrame") -> "DataFrame":
        """Wrap an operator result, carrying the lineage's overflow report."""
        rep = OverflowReport().merge(self._report)
        for o in others:
            rep.merge(o._report)
        return DataFrame(out, self._ctx, _publish_report(rep))

    def _from_spill(self, res, *others: "DataFrame") -> "DataFrame":
        """Materialize a spilled operator's chunk stream into a DataFrame.

        The spill store is closed (scratch dir removed) before returning;
        any residual loss in the spill report — e.g. join fan-out beyond
        ``max_matches``, which is a semantic cap, not a memory one —
        still raises, exactly as the in-memory path would.
        """
        from ..core.dataflow import _concat_chunks

        with res:
            chunks = list(res.chunks()) or [res.empty_chunk()]
            res.report.assert_exact()
            rep = OverflowReport().merge(self._report)
            for o in others:
                rep.merge(o._report)
            rep.merge(res.report)
            out = _concat_chunks(chunks, self._ctx)
        return DataFrame(out, self._ctx, _publish_report(rep))

    @staticmethod
    def _check(overflow, op: str) -> None:
        if int(overflow) != 0:
            raise OverflowError(
                f"{op}: {int(overflow)} rows overflowed static capacity — "
                "re-run with a larger out_capacity/bucket_factor, or pass "
                "spill='auto' to recover out-of-core")


class Window:
    """Bound ``(partition_by, order_by)`` spec, built by
    :meth:`DataFrame.window`; ``.agg(...)`` evaluates window functions."""

    def __init__(self, df: DataFrame, partition_by, order_by, ascending):
        self._df = df
        self._partition_by = partition_by
        self._order_by = order_by
        self._ascending = ascending

    def agg(self, aggs, rows: Optional[int] = None, *,
            spill: object = False, budget_rows: Optional[int] = None,
            spill_workdir: Optional[str] = None, **kw) -> DataFrame:
        """Evaluate window aggregates; returns the DataFrame plus one
        column per agg (rows never move or drop).

        ``aggs`` entries: ``(col, op)`` with op in sum/mean/count/min/max
        (over a trailing window of ``rows`` rows, or cumulative when
        ``rows=None``), ``(col, "lag"/"lead", offset)``, and
        ``(None, "row_number"/"rank")``.  Already-sorted inputs
        (``sort_values`` on ``partition_by + order_by``) evaluate with no
        data movement; a truncated window raises :class:`OverflowError`.

        ``spill="auto"``/``spill=True``/``budget_rows`` select the
        out-of-core path: window partitions spill whole to disk and
        re-enter pre-sorted, so no window is ever truncated by the
        cross-shard halo.
        """
        from ..spill import should_spill, spill_window

        df = self._df
        _spill_mode(spill)
        budget = budget_rows or df._t.capacity

        def _spilled() -> DataFrame:
            return df._from_spill(spill_window(
                df._t, self._partition_by, self._order_by, aggs,
                ctx=df._ctx, budget_rows=budget, rows=rows,
                ascending=self._ascending, workdir=spill_workdir))

        if spill is True or (spill == "auto" and budget_rows is not None and
                             should_spill(len(df), df._ctx.n_shards,
                                          budget_rows)):
            return _spilled()
        out, ov = table_ops.window_aggregate(
            df._t, self._partition_by, self._order_by, aggs,
            ctx=df._ctx, rows=rows, ascending=self._ascending, **kw)
        if int(ov) != 0 and spill == "auto":
            return _spilled()
        DataFrame._check(ov, "window")
        return df._child(out)
