"""Dataflow operators — the Twister2/TSet side of HPTMT (paper §V-B-2, §VII-A).

Eager operators (``table_ops``) take whole tables in memory.  Dataflow
operators process data **piece by piece**: the dataset is a stream of
bounded-size chunks (the external-memory model — "datasets that do not fit
into the available random access memory", Fig 5), and each operator consumes
and produces chunks.  Distributed barriers (GroupBy/Join/OrderBy/Union) use
the *combiner* pattern: per-chunk shuffle + partial result, merged at the
barrier — so peak memory stays bounded by the chunk size, not the dataset.

The same kernels power both styles; only the driver differs.  That is the
paper's Fig 9: dataflow operators and eager operators working together in
a single parallel program.

On a process group (``ctx.group``) a TSet runs over the table operators
on the group: each rank chunks, transforms and concatenates its own
shards, every barrier's exchange is the group's, and the sinks return
what the virtual run returns (``collect`` this rank's blocks of it;
``reduce``, ``quantile`` and ``to_numpy`` the same value on every rank).
:meth:`TSet.from_spill` streams this rank's blocks of a group's spill
output, and :meth:`TSet.lazy` roots the lazy planner, which runs on the
group too.

One result differs from the reference on purpose: ``reduce(col, "mean")``
returns the true mean (the summed per-chunk sums over the summed counts,
as reference DESIGN.md §4.2 decomposes a mean and the eager ``aggregate``
computes it); the reference averages the per-chunk means, which differs
whenever the chunks hold different row counts.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import table_ops
from .context import HPTMTContext
from .exchange import compact_rows
from .report import OverflowReport
from .table import DistTable, partitioning_keys, partitioning_kind


# ---------------------------------------------------------------------------
# plan nodes
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Node:
    kind: str
    inputs: Tuple["_Node", ...] = ()
    payload: dict = dataclasses.field(default_factory=dict)


class TSet:
    """A lazy, chunked, distributed dataset (Twister2 TSet analogue)."""

    def __init__(self, node: _Node, ctx: HPTMTContext):
        self._node = node
        self._ctx = ctx
        self._last_report: Optional[OverflowReport] = None

    @property
    def overflow_report(self) -> Optional[OverflowReport]:
        """Overflow accounting from the most recent materialization
        (``collect``/``reduce``/``quantile``/``to_numpy``), or ``None``
        before the first one: join fan-out, orderby/union capacity,
        per-chunk groupby partials, plus any spill-recovery evidence a
        :meth:`from_spill` source carries (reference DESIGN.md §10)."""
        return self._last_report

    # -- sources -----------------------------------------------------------
    @classmethod
    def _source(cls, chunks: Sequence[DistTable], ctx: HPTMTContext,
                report=None) -> "TSet":
        payload = {"chunks": list(chunks)}
        if report is not None:
            payload["report"] = report
        return cls(_Node("source", payload=payload), ctx)

    @classmethod
    def from_chunks(cls, chunks: Sequence[DistTable],
                    ctx: HPTMTContext) -> "TSet":
        return cls._source(chunks, ctx)

    @classmethod
    def from_spill(cls, result, ctx: Optional[HPTMTContext] = None) -> "TSet":
        """Source a TSet from a completed spill result.

        The spilled chunk stream becomes the source chunks — partitioning
        metadata intact, so downstream barriers keep eliding — and the
        spill report (recovered rows, residual losses) is folded into
        every materialization's :attr:`overflow_report`.  Duck-typed on
        ``.chunks()`` / ``.report`` so core never imports the spill
        layer.  On a group each rank takes its blocks of every chunk."""
        ctx = ctx or result._ctx
        return cls._source(result.chunks(), ctx, result.report)

    @classmethod
    def from_table(cls, dt: DistTable, ctx: HPTMTContext,
                   chunk_rows: Optional[int] = None) -> "TSet":
        """Split a table into row-chunks of at most ``chunk_rows`` rows a
        shard each (views of the table's blocks, no copy; on a group, of
        this rank's blocks)."""
        if chunk_rows is None or chunk_rows >= dt.capacity:
            return cls._source([dt], ctx)
        chunks = []
        cap = dt.capacity
        for start in range(0, cap, chunk_rows):
            stop = min(start + chunk_rows, cap)
            cols = {k: v[:, start:stop] for k, v in dt.columns.items()}
            counts = torch.clamp(dt.counts - start, 0, stop - start)
            # row-slicing never moves rows across shards: layout survives
            chunks.append(DistTable(cols, counts, dt.partitioning, dt.group))
        return cls._source(chunks, ctx)

    @classmethod
    def from_scan(cls, scan, ctx: Optional[HPTMTContext] = None) -> "TSet":
        """Source a TSet from a storage ``ScanSource`` (``repro_torch.io``).

        The scan's fragment rounds become the chunk stream — the chunked
        ingest path (paper Fig 5).  Chunks inherit the scan's
        partitioned-re-entry metadata, so a groupby/join on the partition
        keys elides its merge shuffle.  Duck-typed (anything with
        ``.chunks()`` and ``.ctx``) so core never imports the io layer.
        """
        return cls.from_chunks(list(scan.chunks()), ctx or scan.ctx)

    # -- piecewise (streaming) operators ------------------------------------
    def select(self, predicate: Callable) -> "TSet":
        return TSet(_Node("select", (self._node,), {"pred": predicate}),
                    self._ctx)

    def project(self, columns: Sequence[str]) -> "TSet":
        return TSet(_Node("project", (self._node,),
                          {"cols": tuple(columns)}), self._ctx)

    def map_columns(self, fn: Callable[[Dict[str, torch.Tensor]], Dict]
                    ) -> "TSet":
        """Apply a per-chunk columnar transform (adds/replaces columns).
        ``fn`` sees ``(n_shards, capacity, ...)`` column blocks."""
        return TSet(_Node("map", (self._node,), {"fn": fn}), self._ctx)

    # -- barrier (shuffling) operators ---------------------------------------
    def join(self, other: "TSet", keys: Sequence[str], **kw) -> "TSet":
        return TSet(_Node("join", (self._node, other._node),
                          {"keys": tuple(keys), "kw": kw}), self._ctx)

    def groupby(self, keys: Sequence[str], aggs: Sequence[Tuple[str, str]],
                **kw) -> "TSet":
        return TSet(_Node("groupby", (self._node,),
                          {"keys": tuple(keys), "aggs": tuple(aggs),
                           "kw": kw}), self._ctx)

    def orderby(self, by, **kw) -> "TSet":
        """Global multi-key sort at the barrier (materializing)."""
        return TSet(_Node("orderby", (self._node,), {"by": by, "kw": kw}),
                    self._ctx)

    def union(self, other: "TSet", **kw) -> "TSet":
        return TSet(_Node("union", (self._node, other._node), {"kw": kw}),
                    self._ctx)

    def window(self, partition_by, order_by, aggs, rows=None,
               **kw) -> "TSet":
        """Windowed aggregation barrier: chunks merge, one sample-sort
        exchange orders them (elided if the layout holds), the window
        lanes evaluate in place.  Truncated windows raise."""
        return TSet(_Node("window", (self._node,),
                          {"partition_by": partition_by,
                           "order_by": order_by, "aggs": tuple(aggs),
                           "rows": rows, "kw": kw}), self._ctx)

    def topk(self, by, k: int, **kw) -> "TSet":
        """Streaming top-k via the combiner pattern: each chunk reduces to
        its own k candidates (bounded memory), and the barrier merges the
        per-chunk winners — no chunk ever rematerializes."""
        return TSet(_Node("topk", (self._node,),
                          {"by": by, "k": k, "kw": kw}), self._ctx)

    # -- sinks ----------------------------------------------------------------
    def _run(self) -> List[DistTable]:
        """Execute the graph with a fresh report, then publish it."""
        self._last_report = report = OverflowReport()
        chunks = _execute(self._node, self._ctx, report)
        self._publish_report()
        return chunks

    def collect(self) -> DistTable:
        """Execute the dataflow graph and materialize the result."""
        return _concat_chunks(self._run(), self._ctx)

    def _publish_report(self) -> None:
        """Mirror the materialization's overflow into the active telemetry
        collector under the same dotted labels (no-op when off)."""
        from .. import telemetry

        rec = telemetry.current()
        if rec is not None and self._last_report is not None:
            rec.record_overflow(self._last_report)

    def lazy(self, name: str = "tset"):
        """Bridge into the query planner (``repro_torch.plan``).

        Materializes this TSet's streaming graph (a barrier, exactly like
        :meth:`collect` — chunk layouts survive concatenation) and roots
        a :class:`~repro_torch.plan.LazyFrame` at the result, so
        downstream relational chains get whole-pipeline exchange
        optimization the chunk-wise executor cannot see.  The
        materialization's overflow report is carried into the lazy
        lineage.
        """
        from ..plan import LazyFrame
        from ..plan.logical import source

        dt = self.collect()
        return LazyFrame(source(dt, name), self._ctx,
                         OverflowReport().merge(self._last_report))

    def reduce(self, column: str, op: str) -> torch.Tensor:
        """Streaming scalar aggregate (per-chunk partials, merged).

        A mean merges as the sum of the chunks' sums over the sum of
        their counts, never as a mean of means."""
        from ..kernels.segment_reduce import ops as segops

        chunks = self._run()
        agg = table_ops.aggregate
        if op == "mean":
            s = torch.stack([agg(c, column, "sum", ctx=self._ctx)
                             for c in chunks]).sum()
            n = torch.stack([agg(c, column, "count", ctx=self._ctx)
                             for c in chunks]).sum()
            return s / torch.clamp(n, min=1.0)
        parts = torch.stack([agg(c, column, op, ctx=self._ctx)
                             for c in chunks])
        if op in ("min", "max"):
            # one segment of the segment reduction: -0.0 below +0.0 and
            # a NaN wins, as aggregate merges its shards
            return segops.segment_reduce(
                parts, torch.zeros(parts.shape, dtype=torch.int32,
                                   device=parts.device), 1, op)[0]
        if op in ("sum", "count"):
            return parts.sum()
        raise ValueError(f"unknown aggregate {op!r}")

    def quantile(self, column: str, qs, **kw):
        """Column quantiles at the barrier (materializing; exact by
        default via the range layout — ``table_ops.quantile``)."""
        dt = _concat_chunks(self._run(), self._ctx)
        return table_ops.quantile(dt, column, qs, ctx=self._ctx, **kw)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Bridge to NumPy (paper Fig 13 line 28 / Fig 17 line 18)."""
        return self.collect().to_numpy()


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------
def _concat_chunks(chunks: List[DistTable], ctx: HPTMTContext) -> DistTable:
    """Concatenate chunks shard-wise and re-compact each shard.

    Shard ``s`` of the result holds every chunk's shard-``s`` rows, in
    chunk order, at capacity ``sum(chunk capacities)`` (on a group, for
    each shard this rank holds).
    """
    if len(chunks) == 1:
        return chunks[0]
    names = chunks[0].column_names
    cap = sum(c.capacity for c in chunks)
    outs, counts = [], []
    for shard in range(ctx.n_local):
        cols = {name: torch.cat([c.columns[name][shard] for c in chunks])
                for name in names}
        # rows are valid-prefix within each chunk block, not globally
        valid = torch.cat([torch.arange(c.capacity, device=c.device)
                           < c.counts[shard] for c in chunks])
        out, n, _ = compact_rows(cols, valid, cap)
        outs.append(out)
        counts.append(n)
    # shard-wise concatenation keeps every row on its shard: when all
    # chunks agree on a hash layout, the merged table still has it — this
    # is what lets the combiner barrier's merge groupby elide its shuffle.
    # A RANGE layout does NOT survive: concatenating two sorted chunks
    # interleaves their orders, so only the single-chunk early return
    # above can keep it (reference DESIGN.md §4, §9).
    parts = {c.partitioning for c in chunks}
    part = parts.pop() if len(parts) == 1 else None
    if partitioning_kind(part) == "range":
        part = None
    return DistTable.from_shards(outs, counts, part, ctx.group)


def _execute(node: _Node, ctx: HPTMTContext,
             report: Optional[OverflowReport] = None) -> List[DistTable]:
    if report is None:
        report = OverflowReport()
    if node.kind == "source":
        src_report = node.payload.get("report")
        if src_report is not None:
            report.merge(src_report)
        return list(node.payload["chunks"])

    if node.kind in ("select", "project", "map"):
        chunks = _execute(node.inputs[0], ctx, report)
        out = []
        for c in chunks:
            if node.kind == "select":
                out.append(table_ops.select(c, node.payload["pred"],
                                            ctx=ctx))
            elif node.kind == "project":
                out.append(table_ops.project(c, node.payload["cols"],
                                             ctx=ctx))
            else:
                updates = node.payload["fn"](c.columns)
                new_cols = dict(c.columns)
                new_cols.update(updates)
                # a transform that rewrites a key column — hash or range —
                # invalidates the layout evidence; untouched keys keep it
                part = c.partitioning
                if part is not None and \
                        set(partitioning_keys(part)) & set(updates):
                    part = None
                out.append(DistTable(new_cols, c.counts, part, c.group))
        return out

    if node.kind == "groupby":
        # combiner pattern: partial aggregate per chunk, then merge the
        # partials.  Each per-chunk groupby leaves its output partitioned
        # on the keys; _concat_chunks preserves the common layout, so the
        # merge groupby below elides its shuffle — one exchange per chunk,
        # zero at the barrier (reference DESIGN.md §4).
        chunks = _execute(node.inputs[0], ctx, report)
        keys, aggs = node.payload["keys"], node.payload["aggs"]
        partial_aggs, merge_aggs = table_ops.split_aggs(aggs)
        # map-side combine is essential here, not just an optimisation: a
        # chunk's per-shard capacity is small by design, so shuffling raw
        # rows of a low-cardinality key would overflow it — pre-aggregated
        # partials always fit
        kw = dict(node.payload["kw"])
        kw.setdefault("combine", True)
        partials = []
        for c in chunks:
            part, ov = table_ops.groupby_aggregate(
                c, keys, partial_aggs, ctx=ctx, **kw)
            report.add("groupby.slots", ov)
            partials.append(part)
        merged = _concat_chunks(partials, ctx)
        final, ov = table_ops.groupby_aggregate(
            merged, keys, merge_aggs, ctx=ctx, **kw)
        report.add("groupby.slots", ov)
        final = DistTable(
            table_ops.finalize_agg_cols(final.columns, aggs, merge_aggs),
            final.counts, final.partitioning, final.group)
        return [final]

    # materializing barriers
    if node.kind == "join":
        left = _concat_chunks(_execute(node.inputs[0], ctx, report), ctx)
        right = _concat_chunks(_execute(node.inputs[1], ctx, report), ctx)
        out, ov = table_ops.join(left, right, node.payload["keys"], ctx=ctx,
                                 **node.payload["kw"])
        report.add("join.fanout", ov)
        return [out]
    if node.kind == "orderby":
        t = _concat_chunks(_execute(node.inputs[0], ctx, report), ctx)
        out, ov = table_ops.orderby(t, node.payload["by"], ctx=ctx,
                                    **node.payload["kw"])
        report.add("orderby.capacity", ov)
        return [out]
    if node.kind == "window":
        t = _concat_chunks(_execute(node.inputs[0], ctx, report), ctx)
        out, ov = table_ops.window_aggregate(
            t, node.payload["partition_by"], node.payload["order_by"],
            node.payload["aggs"], rows=node.payload["rows"], ctx=ctx,
            **node.payload["kw"])
        # window overflow means truncated (wrong-VALUED) windows, not
        # dropped rows — unlike the other barriers it must never pass
        # silently (zero overflow is the exactness certificate)
        report.add("window.truncated", ov)
        if int(ov) != 0:
            raise RuntimeError(
                f"window: {int(ov)} windows were truncated by the "
                f"cross-shard halo — raise the capacity or repartition")
        return [out]
    if node.kind == "topk":
        # combiner pattern: per-chunk top-k candidates (bounded memory),
        # merged by one final top-k over the k-per-chunk survivors
        chunks = _execute(node.inputs[0], ctx, report)
        by, k, kw = (node.payload[f] for f in ("by", "k", "kw"))
        cands = [table_ops.topk(c, by, k, ctx=ctx, **kw) for c in chunks]
        merged = _concat_chunks(cands, ctx)
        return [table_ops.topk(merged, by, k, ctx=ctx, **kw)]
    if node.kind == "union":
        a = _concat_chunks(_execute(node.inputs[0], ctx, report), ctx)
        b = _concat_chunks(_execute(node.inputs[1], ctx, report), ctx)
        out, ov = table_ops.union(a, b, ctx=ctx, **node.payload["kw"])
        report.add("union.capacity", ov)
        return [out]
    raise ValueError(f"unknown node {node.kind}")
