"""LazyFrame: the deferred twin of :class:`repro_torch.dataframe.DataFrame`.

``DataFrame.lazy()`` (or :meth:`LazyFrame.read_parquet`) starts an
expression graph; chained operators only build :mod:`plan.logical`
nodes.  ``.collect()`` optimizes the graph (``plan.rules``), lowers it
to one program (``plan.physical``) and runs it; ``.explain()`` renders
logical → optimized → physical without reading any data.  The eager
DataFrame stays the parity oracle: ``lazy().collect()`` gives the same
rows as the same eager chain, it just moves less data (reference
DESIGN.md §11).

The reference's runtime services — ``collect(telemetry=..., policy=...,
ledger=..., qerror_threshold=...)``, ``refine()`` and
``explain(analyze=True)`` — wait for the port's telemetry, stages and
ledger (ROADMAP Queue 1 item 9) and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from ..core.report import OverflowError, OverflowReport

from . import logical as L
from .explain import render_explain
from .physical import PhysicalPlan
from .rules import optimize

_ITEM9 = "is not ported yet (ROADMAP Queue 1 item 9)"


class LazyFrame:
    """A logical plan + context; every operator returns a new LazyFrame."""

    def __init__(self, node: L.LogicalNode, ctx,
                 report: Optional[OverflowReport] = None):
        self._node = node
        self._ctx = ctx
        self._report = report if report is not None else OverflowReport()

    # -- construction ------------------------------------------------------
    @classmethod
    def read_parquet(cls, path: str, ctx, *,
                     columns: Optional[Sequence[str]] = None,
                     predicate=None, capacity: Optional[int] = None,
                     bucket_factor: float = 1.0,
                     allow_narrowing: bool = False,
                     on_error: str = "raise") -> "LazyFrame":
        """Lazy dataset scan (Parquet or ``.hpt``): only metadata is read
        here; pushed-down predicates/projections land in the physical
        scan at ``collect()`` time.  ``on_error="quarantine"`` skips
        corrupt fragments at scan time instead of raising (recorded in
        scan stats + the dataset's quarantine sidecar)."""
        return cls(L.scan(path, columns=columns, predicate=predicate,
                          capacity=capacity, bucket_factor=bucket_factor,
                          allow_narrowing=allow_narrowing,
                          on_error=on_error), ctx)

    read_dataset = read_parquet  # format-neutral alias

    # -- metadata ----------------------------------------------------------
    @property
    def columns(self) -> Tuple[str, ...]:
        return self._node.schema

    @property
    def logical_plan(self) -> L.LogicalNode:
        return self._node

    def _chain(self, node: L.LogicalNode, *others: "LazyFrame"
               ) -> "LazyFrame":
        rep = OverflowReport().merge(self._report)
        for o in others:
            rep.merge(o._report)
        return LazyFrame(node, self._ctx, rep)

    # -- operators (all deferred) ------------------------------------------
    def filter(self, predicate) -> "LazyFrame":
        """Row filter: ``pred()`` tuples / ``(col, op, value)`` triples
        (visible to the rewriter: pushed through joins and into scans) or
        a callable ``cols -> mask`` (opaque, never pushed)."""
        return self._chain(L.filter_(self._node, predicate))

    select = filter  # eager-API name (callable predicate form)

    def project(self, columns) -> "LazyFrame":
        return self._chain(L.project(self._node, columns))

    def join(self, other: "LazyFrame", on, how: str = "inner", *,
             method: str = "auto", max_matches: int = 1,
             reorder: bool = False, **kw) -> "LazyFrame":
        """Deferred equi-join (same semantics as the eager ``join``).

        ``reorder=True`` lets the optimizer swap the inputs so the
        smaller estimated side becomes the hash build side (rule
        ``reorder-join-inputs``).  Off by default: ``table_ops.join``
        caps fan-out per LEFT row, so swapping changes which side
        ``max_matches`` caps and overflow accounting could diverge from
        the eager oracle — opt in only when the cap cannot bind.
        """
        if not isinstance(other, LazyFrame):
            raise TypeError(f"join expects a LazyFrame (got "
                            f"{type(other).__name__}); call .lazy() first")
        return self._chain(
            L.join(self._node, other._node, on, how=how,
                   max_matches=max_matches, method=method,
                   reorder=reorder, **kw), other)

    def groupby(self, keys, aggs, **kw) -> "LazyFrame":
        return self._chain(L.groupby(self._node, keys, aggs, **kw))

    def repartition(self, keys, mode: str = "hash",
                    ascending=True) -> "LazyFrame":
        return self._chain(L.repartition(self._node, keys, mode=mode,
                                         ascending=ascending))

    def sort_values(self, by, ascending=True) -> "LazyFrame":
        return self._chain(L.orderby(self._node, by, ascending=ascending))

    def window(self, partition_by, order_by, ascending=True) -> "LazyWindow":
        return LazyWindow(self, partition_by, order_by, ascending)

    def rank(self, partition_by, order_by, ascending=True) -> "LazyFrame":
        return self._chain(L.window(
            self._node, partition_by, order_by,
            [(None, "rank"), (None, "row_number")], ascending=ascending))

    def topk(self, by, k: int, largest: bool = True,
             ascending=None) -> "LazyFrame":
        if ascending is None:
            ascending = not largest
        return self._chain(L.topk(self._node, by, k, ascending=ascending))

    # -- execution ---------------------------------------------------------
    def physical_plan(self) -> PhysicalPlan:
        """Optimize + lower without running (no data I/O): the
        ``plan.fn`` / ``plan.inputs()`` pair the contract tests run under
        the exchange counter."""
        root, _ = optimize(self._node)
        return PhysicalPlan(root, self._ctx)

    def collect(self, *, strict: bool = True, jit: bool = True,
                telemetry=None, policy=None, qerror_threshold=None,
                ledger=None):
        """Optimize, lower, run; returns an eager :class:`DataFrame`.

        One program executes the whole pipeline.  ``jit`` keeps the
        reference's keyword, which compiles the program there; the port
        runs the same eager program either way (no ``torch.compile``:
        the kernels are the hand-written ones the operators launch).
        Overflow from any step lands in the result's ``overflow_report``
        under ``plan.<step>`` labels and raises unless ``strict=False`` —
        the same contract as the eager operators.

        ``telemetry``, ``policy``, ``qerror_threshold`` and ``ledger``
        wait for the port's runtime services and raise
        ``NotImplementedError``.
        """
        from ..dataframe.frame import DataFrame

        for name, value in (("telemetry", telemetry), ("policy", policy),
                            ("qerror_threshold", qerror_threshold),
                            ("ledger", ledger)):
            if value is not None:
                raise NotImplementedError(f"collect({name}=...) {_ITEM9}")
        root, _ = optimize(self._node)
        plan = PhysicalPlan(root, self._ctx)
        out, ovs = plan.fn(*plan.inputs())
        report = OverflowReport().merge(self._report)
        report.add("plan.scan.capacity", plan.scan_overflow)
        for label, v in sorted(ovs.items()):
            report.add(f"plan.{label}", int(v))
        if strict and not report.is_exact():
            detail = ", ".join(f"{k}={v}" for k, v in report)
            raise OverflowError(
                f"planned pipeline overflowed static capacity ({detail}) "
                f"— re-run with larger capacities, or collect(strict=False)")
        return DataFrame(out, self._ctx, report)

    def refine(self, rec) -> "LazyFrame":
        """Re-optimizing join order from observed cardinalities needs a
        telemetry collector's observations."""
        raise NotImplementedError(f"LazyFrame.refine {_ITEM9}")

    def explain(self, *, optimized: bool = True,
                analyze: bool = False) -> str:
        """Stable text rendering: logical plan → fired rewrite rules →
        optimized plan → physical steps with predicted collective counts.
        Builds the physical plan but reads no data.  ``analyze=True``
        (EXPLAIN ANALYZE: run under a collector and annotate every step)
        waits for the port's telemetry.
        """
        if analyze:
            raise NotImplementedError(f"explain(analyze=True) {_ITEM9}")
        root, fired = optimize(self._node)
        plan = PhysicalPlan(root if optimized else self._node, self._ctx)
        return render_explain(self._node, root, fired, plan)


class LazyWindow:
    """Deferred ``(partition_by, order_by)`` spec; ``.agg()`` defers too."""

    def __init__(self, lf: LazyFrame, partition_by, order_by, ascending):
        self._lf = lf
        self._partition_by = partition_by
        self._order_by = order_by
        self._ascending = ascending

    def agg(self, aggs, rows: Optional[int] = None) -> LazyFrame:
        return self._lf._chain(L.window(
            self._lf._node, self._partition_by, self._order_by, aggs,
            rows=rows, ascending=self._ascending))
