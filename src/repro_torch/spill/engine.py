"""Out-of-core spillable operators: bounded-memory join / groupby / window.

This is the recovery path the overflow contract points at (reference
DESIGN.md §2, §10): when an operator's planned static capacity cannot
hold its input, the engine hash-partitions the rows into on-disk ``.hpt``
runs (``store.py``), then streams **partition-pairs** through the exact
same in-memory operators — each pair sized to a caller-committed
``budget_rows`` per shard — and leaves the outputs on disk as a chunk
stream.  Nothing is approximated: every partition is processed by the
identical ``table_ops`` code the all-in-memory path runs (on the card,
through its kernels), so spilled results equal the in-memory answer
(held to the JAX package's spill in ``tests/test_torch_spill.py``).

Host and card: the partition pass works on host numpy (each input shard
is copied device-to-host once); a partition re-enters the card when it
is loaded (host-to-device from the run files' numpy buffers); each
pair's output shards come back to the host and are written as runs.

Partition truthfulness is the load-bearing invariant.  The host-side
partitioner (``hashing.py``) computes bit-identical hashes to the device
``hash_columns``, assigns ``shard = h1 % n_shards`` (exactly the shuffle
destination rule) and ``partition = (h1 // n_shards) % n_parts``, and the
run files carry ``(_h1, _h2)`` across the disk boundary.  A re-ingested
partition therefore re-enters with ``(keys, n_shards)`` hash metadata —
or, for windows, a host-sorted block layout with range metadata — that is
*true*, so the elision paths fire and the per-pair operator adds **zero**
exchanges (and zero sorts, for windows), counted at
``core.array_ops.EXCHANGES`` / ``SORTS`` in the tests.

Skew handling: a partition whose per-shard row count exceeds the budget
is refined once by re-splitting on the independent ``h2`` (no rehash —
the runs carry it).  A partition that still exceeds the budget after
refinement is dominated by duplicates of a single key, which no
partitioner can split; it is processed in one piece at an enlarged
capacity (still exact) and counted in ``SpillStats.oversized``.

On a process group (``ctx.group``) each rank partitions only its own
shards' rows and writes runs for every destination shard into the ONE
store directory the group shares (``store.py``), so the shared disk is
the exchange: a spilled pair still makes no exchange.  Every decision —
the partition count, skips, capacities, refinement — is taken from the
group's index of runs, the same on every rank, and each rank then loads
the runs of its own shards (a window partition: every rank reads and
sorts the whole partition and keeps its own blocks), writes its shards'
output runs under their global shard ids, and rows, ``SpillStats`` and
the report are the virtual run's.  Each round of file I/O ends in
``SpillStore.sync``, so a failure on any rank raises on every rank.

Each pair runs as a plain call of the operator (the reference compiles
it with ``jax.jit``).  Under an active telemetry collector the engine
opens the reference's ``spill.write`` / ``spill.read`` /
``spill.reentry`` spans and publishes the ``spill.*`` gauges, the host's
memory pressure and the report when it finishes.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import telemetry
from ..core import table_ops
from ..core.array_ops import gather_objects
from ..core.context import HPTMTContext
from ..core.exchange import H1_NAME, H2_NAME, LANES_NAME
from ..core.report import OverflowReport
from ..core.table import DistTable, Table, range_partitioning

from .hashing import np_hash_columns, np_lex_order, np_order_lanes
from .store import SpillStore

HostChunk = Tuple[Dict[str, np.ndarray], int]

#: head-room multiplier on the minimum partition count, absorbing hash skew
_PART_HEADROOM = 2
#: partition count when the source size is unknown (generator sources);
#: the h2 refinement pass repairs any underestimate, so this is only a
#: granularity default, never a correctness knob
_DEFAULT_PARTS = 32


def plan_partitions(total_rows: Optional[int], n_shards: int,
                    budget_rows: int) -> int:
    """Number of spill partitions so a partition-pair fits the budget."""
    if budget_rows < 1:
        raise ValueError(f"budget_rows={budget_rows} must be >= 1")
    if total_rows is None:
        return _DEFAULT_PARTS
    return max(1, math.ceil(total_rows / (n_shards * budget_rows))
               * _PART_HEADROOM)


def should_spill(total_rows: int, n_shards: int,
                 budget_rows: Optional[int]) -> bool:
    """The trigger decision: does the input exceed the planned capacity?"""
    return budget_rows is not None and total_rows > n_shards * budget_rows


# ===========================================================================
# host-side chunk ingestion
# ===========================================================================
def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def iter_host_chunks(src) -> Iterator[HostChunk]:
    """Normalize a spill source into host ``(columns, num_rows)`` chunks.

    Accepts a :class:`DistTable` (one chunk per shard, copied to the
    host), an iterable of DistTables (e.g. ``ScanSource.chunks()``), or an
    iterable of already-host ``(dict, n)`` tuples.  Only valid rows are
    yielded; padding never touches disk.  On a group a DistTable yields
    this rank's shards, and host tuples are taken as this rank's rows.
    """
    if isinstance(src, DistTable):
        src = [src]
    for item in src:
        if isinstance(item, DistTable):
            for i, n in enumerate(item.counts.tolist()):
                yield ({k: _host(v[i, :n]) for k, v in item.columns.items()},
                       n)
        else:
            cols, n = item
            yield ({k: np.asarray(v)[:n] for k, v in cols.items()}, int(n))


def _local_rows_or_none(srcs) -> Optional[int]:
    total = 0
    for s in srcs:
        items = [s] if isinstance(s, DistTable) else s
        if not isinstance(items, (list, tuple)):
            return None
        for item in items:
            total += (int(item.counts.sum()) if isinstance(item, DistTable)
                      else int(item[1]))
    return total


def _total_rows_or_none(*srcs, group=None) -> Optional[int]:
    """Source size without consuming it (summed over the group's ranks),
    or None for generator sources (on any rank)."""
    local = _local_rows_or_none(srcs)
    if group is None:
        return local
    every = gather_objects(local, group)
    return None if any(n is None for n in every) else sum(every)


def _tag_rows(store: SpillStore, tag: str) -> int:
    """Rows the group wrote under ``tag`` (every valid row once)."""
    return sum(store.rows(tag, q) for q in store.partitions(tag))


def _round(store: SpillStore, fn):
    """``fn()`` as one round of this rank's file I/O; a failure on any
    rank raises on every rank (``SpillStore.sync``)."""
    out, err = None, None
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 — every rank raises
        err = e
    store.sync(err)
    return out


def _schema_of(cols: Dict[str, np.ndarray]) -> Dict[str, Tuple]:
    return {k: (np.dtype(v.dtype), tuple(v.shape[1:]))
            for k, v in cols.items()}


def _bucket_order(bucket: np.ndarray, n_buckets: int) -> np.ndarray:
    """Stable permutation that groups rows by a small bucket id: the
    permutation of a stable ``argsort`` (and of the reference's
    ``lexsort`` over the id's parts), taken by numpy's radix sort when
    the ids fit in 16 bits."""
    dtype = np.uint16 if n_buckets <= 1 << 16 else np.int64
    return np.argsort(bucket.astype(dtype), kind="stable")


# ===========================================================================
# partition pass
# ===========================================================================
def _write_buckets(store: SpillStore, tag: str, cols: Dict[str, np.ndarray],
                   q: np.ndarray, s: np.ndarray, order: np.ndarray) -> None:
    """Write contiguous ``(q, s)`` groups of the permuted chunk as runs."""
    if len(order) == 0:
        return
    with telemetry.span("spill.write", tag=tag, rows=len(order),
                        bytes=sum(int(v.nbytes) for v in cols.values())):
        qs = q[order]
        ss = s[order]
        boundary = np.nonzero((qs[1:] != qs[:-1])
                              | (ss[1:] != ss[:-1]))[0] + 1
        starts = np.concatenate([[0], boundary])
        stops = np.concatenate([boundary, [len(order)]])
        for a, b in zip(starts, stops):
            rows = order[a:b]
            store.write_run(tag, int(qs[a]), int(ss[a]),
                            {k: v[rows] for k, v in cols.items()},
                            int(b - a))


def _partition_hash(store: SpillStore, tag: str, src, keys: Sequence[str],
                    n_shards: int, n_parts: int
                    ) -> Tuple[int, Dict[str, Tuple]]:
    """Hash-partition a source into ``(q, s)`` runs carrying ``(h1, h2)``.

    ``s = h1 % n_shards`` is the shuffle destination rule; ``q`` consumes
    the next hash bits, so re-ingesting partition ``q`` shard-by-shard
    reproduces exactly the layout a real shuffle would have produced.
    """
    total, schema = 0, None
    for cols, n in iter_host_chunks(src):
        if schema is None:
            schema = _schema_of(cols)
        if n == 0:
            continue
        h1, h2 = np_hash_columns([cols[k] for k in keys])
        s = (h1 % np.uint32(n_shards)).astype(np.int64)
        q = ((h1 // np.uint32(n_shards)) % np.uint32(n_parts)).astype(np.int64)
        cols = dict(cols)
        cols[H1_NAME], cols[H2_NAME] = h1, h2
        _write_buckets(store, tag, cols, q, s,
                       _bucket_order(q * n_shards + s, n_parts * n_shards))
        total += n
    if schema is None:
        raise ValueError(f"spill source {tag!r} yielded no chunks")
    return total, schema


def _canonical_nan(col: np.ndarray) -> np.ndarray:
    """Collapse every NaN payload to one bit pattern before hashing.

    Window partition identity is the *ordering* identity (all NaNs form
    one partition, DESIGN.md §9); the hash is bitwise, so differing NaN
    payloads must not scatter one window partition across spill
    partitions.
    """
    if np.issubdtype(col.dtype, np.floating):
        nan = np.isnan(col)
        if nan.any():
            col = np.where(nan, np.asarray(np.nan, col.dtype), col)
    return col


def _partition_window(store: SpillStore, tag: str, src,
                      pkeys: Sequence[str], keys: Sequence[str],
                      ascending: Sequence[bool], n_parts: int
                      ) -> Tuple[int, Dict[str, Tuple]]:
    """Partition by window-partition keys, carrying the order lanes.

    Rows of one window partition must never straddle spill partitions, so
    ``q`` hashes the PARTITION BY keys only; the full directional lanes
    (``pkeys + okeys``) ride along in the run files so re-ingestion sorts
    on the host with one ``lexsort`` and no recomputation.
    """
    total, schema = 0, None
    for cols, n in iter_host_chunks(src):
        if schema is None:
            schema = _schema_of(cols)
        if n == 0:
            continue
        h1, h2 = np_hash_columns([_canonical_nan(cols[k]) for k in pkeys])
        q = (h1 % np.uint32(n_parts)).astype(np.int64)
        cols = dict(cols)
        cols[H1_NAME], cols[H2_NAME] = h1, h2
        cols[LANES_NAME] = np_order_lanes(cols, keys, ascending)
        s = np.zeros(n, np.int64)
        _write_buckets(store, tag, cols, q, s, _bucket_order(q, n_parts))
        total += n
    if schema is None:
        raise ValueError(f"spill source {tag!r} yielded no chunks")
    return total, schema


# ===========================================================================
# skew refinement
# ===========================================================================
def _refine_oversized(store: SpillStore, tags: Sequence[str],
                      n_shards: int, budget_rows: int, n_parts: int,
                      per_shard: bool) -> Tuple[List[int], int, int]:
    """Split partitions whose load exceeds the budget.

    One refinement level re-buckets on the carried ``h2`` (independent of
    the ``h1`` bits already consumed) — the same child mapping on every
    operand, so join pairs stay aligned.  Returns the final partition
    ids, the count refined, and the count left oversized (single-key
    skew: unsplittable, processed whole at an enlarged capacity).  On a
    group the loads come from the group's index, and each rank re-buckets
    the runs it wrote (``h2 % fanout`` maps alike everywhere).
    """
    def load(q: int) -> int:
        if per_shard:
            return max((store.rows(t, q, s)
                        for t in tags for s in range(n_shards)), default=0)
        return max((store.rows(t, q) for t in tags), default=0)

    pending = sorted({q for t in tags for q in store.partitions(t)})
    pending = [(q, 0) for q in pending]
    final: List[int] = []
    next_q = n_parts
    refined = oversized = 0
    while pending:
        q, level = pending.pop()
        size = load(q)
        if size <= budget_rows:
            final.append(q)
            continue
        if level >= 1:
            final.append(q)
            oversized += 1
            continue
        fanout = max(2, math.ceil(size / budget_rows) * _PART_HEADROOM)
        base = next_q
        next_q += fanout
        refined += 1

        def rewrite(q=q, fanout=fanout, base=base):
            for t in tags:
                for s in store.shards(t, q):
                    for cols, n in store.iter_runs(t, q, s, own=True):
                        sub = (cols[H2_NAME]
                               % np.uint32(fanout)).astype(np.int64)
                        sq = np.full(n, s, np.int64)
                        _write_buckets(store, t, cols, base + sub, sq,
                                       _bucket_order(sub, fanout))
                store.drop_partition(t, q)

        _round(store, rewrite)
        pending.extend((base + j, 1) for j in range(fanout))
    return sorted(set(final)), refined, oversized


# ===========================================================================
# partition loading / output writing
# ===========================================================================
def _empty_cols(schema: Dict[str, Tuple]) -> Dict[str, np.ndarray]:
    return {k: np.zeros((0,) + tuple(tr), dt)
            for k, (dt, tr) in schema.items()}


def _round_capacity(rows: int, budget_rows: int) -> int:
    """Pad capacities to budget multiples.  The reference does it so jit
    traces are reused; the port keeps it because the capacity also sizes
    the build table (``table_ops._hash_slots``), and with it the probe
    chains' order and the overflow — the pair's answer must be the
    reference's bit for bit."""
    return budget_rows * max(1, math.ceil(rows / budget_rows))


def _load_hash_partition(store: SpillStore, tag: str, q: int,
                         schema: Dict[str, Tuple], keys: Sequence[str],
                         ctx: HPTMTContext, capacity: int) -> DistTable:
    """Re-ingest one partition with TRUE hash-partitioning metadata (on a
    group, this rank's shards of it)."""
    with telemetry.span("spill.read", tag=tag, partition=q) as sp:
        tables = []
        total = 0
        for s in ctx.local_shards:
            cols, n = store.read_partition(tag, q, s)
            total += n
            if n == 0:
                cols = _empty_cols(schema)
            cols.pop(H1_NAME, None)
            cols.pop(H2_NAME, None)
            tables.append(Table.from_arrays(cols, num_rows=n,
                                            capacity=capacity,
                                            device=ctx.device))
        sp.attrs["rows"] = total
        return DistTable.from_local_tables(
            tables, ctx, capacity, partitioning=(tuple(keys), ctx.n_shards))


def _load_range_partition(store: SpillStore, tag: str, q: int,
                          schema: Dict[str, Tuple], keys: Sequence[str],
                          ascending: Sequence[bool], ctx: HPTMTContext,
                          capacity: int) -> DistTable:
    """Re-ingest one window partition with TRUE range metadata.

    The whole partition is lex-sorted by its carried lanes on the host
    and block-sliced into contiguous per-shard chunks — exactly the
    layout the sample-sort exchange would have produced, so the per-pair
    window runs its zero-exchange / zero-sort elided path.  On a group
    every rank reads and sorts the whole partition and keeps the blocks
    of its own shards.
    """
    with telemetry.span("spill.read", tag=tag, partition=q) as sp:
        cols, n = store.read_partition(tag, q)
        sp.attrs["rows"] = n
        if n == 0:
            cols = dict(_empty_cols(schema))
            cols[LANES_NAME] = np.zeros((0, len(keys)), np.uint32)
        order = np_lex_order(cols[LANES_NAME])
        cols = {k: v for k, v in cols.items()
                if k not in (H1_NAME, H2_NAME, LANES_NAME)}
        per = max(1, math.ceil(n / ctx.n_shards))
        tables = []
        for s in ctx.local_shards:
            rows = order[min(s * per, n):min((s + 1) * per, n)]
            tables.append(Table.from_arrays(
                {k: v[rows] for k, v in cols.items()}, num_rows=len(rows),
                capacity=capacity, device=ctx.device))
        return DistTable.from_local_tables(
            tables, ctx, capacity,
            partitioning=range_partitioning(keys, ascending, ctx.n_shards))


def _write_output(store: SpillStore, q: int, dt: DistTable,
                  ctx: HPTMTContext) -> int:
    """Persist a pair result shard-by-shard under global shard ids and
    enter it in the group's index; returns the group's rows written."""
    def write():
        for i, n in enumerate(dt.counts.tolist()):
            if n:
                store.write_run("out", q, ctx.local_shards[i],
                                {k: _host(v[i, :n])
                                 for k, v in dt.columns.items()}, n)

    _round(store, write)
    return store.rows("out", q)


def _out_schema_of(dt: DistTable) -> Dict[str, Tuple]:
    return {k: (np.dtype(_host(v[0, :0]).dtype), tuple(v.shape[2:]))
            for k, v in dt.columns.items()}


# ===========================================================================
# results
# ===========================================================================
@dataclasses.dataclass
class SpillStats:
    """What the engine did — partitions, refinement, disk traffic."""
    n_parts: int = 0
    pairs: int = 0
    refined: int = 0
    oversized: int = 0
    rows_in: int = 0
    rows_out: int = 0
    bytes_spilled: int = 0


class SpillResult:
    """A completed spilled operator: an on-disk chunk stream + report.

    The output lives in the spill store until consumed; :meth:`chunks`
    streams it partition-by-partition as DistTables on the context's
    device with partitioning metadata attached (so downstream operators
    keep eliding), deleting each partition's runs after they are yielded.
    :meth:`collect` materializes everything on the host (tests / small
    outputs).
    """

    def __init__(self, store: SpillStore, ctx: HPTMTContext,
                 partitioning, report: OverflowReport, stats: SpillStats,
                 out_schema: Dict[str, Tuple]):
        self._store = store
        self._ctx = ctx
        self._partitioning = partitioning
        self.report = report
        self.stats = stats
        self._out_schema = out_schema

    @property
    def store(self) -> SpillStore:
        return self._store

    @property
    def partitioning(self):
        return self._partitioning

    def chunks(self, *, drop: bool = True) -> Iterator[DistTable]:
        """Stream output partitions as metadata-carrying DistTables (on a
        group, this rank's blocks of each)."""
        ctx = self._ctx
        for q in self._store.partitions("out"):
            cap = max(max((self._store.rows("out", q, s)
                           for s in range(ctx.n_shards)), default=0), 1)

            def load(q=q, cap=cap):
                tables = []
                for s in ctx.local_shards:
                    cols, n = self._store.read_partition("out", q, s)
                    if n == 0:
                        cols = _empty_cols(self._out_schema)
                    tables.append(Table.from_arrays(
                        cols, num_rows=n, capacity=cap, device=ctx.device))
                return tables

            yield DistTable.from_local_tables(
                _round(self._store, load), ctx, cap,
                partitioning=self._partitioning)
            if drop:
                self._store.drop_partition("out", q)

    def empty_chunk(self) -> DistTable:
        """A zero-row DistTable with the output schema and partitioning —
        the stand-in result when no partition produced rows (e.g. an
        inner join with no matches)."""
        cols = _empty_cols(self._out_schema)
        tables = [Table.from_arrays(cols, num_rows=0, capacity=1,
                                    device=self._ctx.device)
                  for _ in range(self._ctx.n_shards)]
        return DistTable.from_shard_tables(
            tables, self._ctx, partitioning=self._partitioning)

    def collect(self) -> Dict[str, np.ndarray]:
        """Materialize the whole output on the host (closes the store)."""
        pieces = [c.to_numpy() for c in self.chunks()]
        self.close()
        if not pieces:
            return _empty_cols(self._out_schema)
        return {k: np.concatenate([p[k] for p in pieces], axis=0)
                for k in pieces[0]}

    def to_tset(self):
        """Materialize the chunk stream into a TSet source whose
        materializations carry this spill's report (closes the store)."""
        from ..core.dataflow import TSet

        ts = TSet.from_spill(self)
        self.close()
        return ts

    def close(self) -> None:
        self._store.close()

    def __enter__(self) -> "SpillResult":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ===========================================================================
# spilled operators
# ===========================================================================
def spill_join(left, right, keys: Sequence[str], *, ctx: HPTMTContext,
               budget_rows: int, how: str = "inner", method: str = "auto",
               max_matches: int = 1, max_probes: Optional[int] = None,
               workdir: Optional[str] = None,
               report: Optional[OverflowReport] = None,
               policy=None) -> SpillResult:
    """Out-of-core equi-join under a per-shard ``budget_rows`` memory cap.

    Both operands are hash-partitioned to disk on ``keys``; each
    partition-pair re-enters with true ``(keys, n_shards)`` metadata and
    joins with BOTH shuffles elided.  Fan-out beyond ``max_matches`` is
    still counted (it is a semantic cap, not a memory one) under
    ``"join.fanout"`` in the report.
    """
    report = report if report is not None else OverflowReport()
    keys = tuple(keys)
    store = SpillStore(workdir, policy=policy, group=ctx.group)
    try:
        n_parts = plan_partitions(
            _total_rows_or_none(left, right, group=ctx.group), ctx.n_shards,
            budget_rows)
        (_, lschema), (_, rschema) = _round(store, lambda: (
            _partition_hash(store, "left", left, keys, ctx.n_shards,
                            n_parts),
            _partition_hash(store, "right", right, keys, ctx.n_shards,
                            n_parts)))
        ln, rn = _tag_rows(store, "left"), _tag_rows(store, "right")
        parts, refined, oversized = _refine_oversized(
            store, ("left", "right"), ctx.n_shards, budget_rows, n_parts,
            per_shard=True)
        stats = SpillStats(n_parts=n_parts, refined=refined,
                           oversized=oversized, rows_in=ln + rn)
        out_schema = None
        for q in parts:
            lrows = max((store.rows("left", q, s)
                         for s in range(ctx.n_shards)), default=0)
            rrows = max((store.rows("right", q, s)
                         for s in range(ctx.n_shards)), default=0)
            skip = ((lrows == 0 and how not in ("right", "outer"))
                    or (rrows == 0 and how == "inner")
                    or (rrows == 0 and lrows == 0))
            if skip:
                store.drop_partition("left", q)
                store.drop_partition("right", q)
                continue
            lcap = _round_capacity(max(lrows, 1), budget_rows)
            rcap = _round_capacity(max(rrows, 1), budget_rows)
            ldt, rdt = _round(store, lambda: (
                _load_hash_partition(store, "left", q, lschema, keys, ctx,
                                     lcap),
                _load_hash_partition(store, "right", q, rschema, keys, ctx,
                                     rcap)))
            with telemetry.span("spill.reentry", op="table.join",
                                partition=q) as sp:
                out, ov = table_ops.join(ldt, rdt, keys, ctx=ctx, how=how,
                                         method=method,
                                         max_matches=max_matches,
                                         max_probes=max_probes)
                sp.block(out)
            report.add("join.fanout", ov)
            if out_schema is None:
                out_schema = _out_schema_of(out)
            stats.rows_out += _write_output(store, q, out, ctx)
            stats.pairs += 1
            store.drop_partition("left", q)
            store.drop_partition("right", q)
        report.add_recovered("spill.join", ln + rn)
        if out_schema is None:
            out_schema = _join_schema(lschema, rschema, keys)
        return _finish(store, ctx, (keys, ctx.n_shards), report, stats,
                       out_schema)
    except BaseException:
        store.close()
        raise


def spill_groupby(src, keys: Sequence[str],
                  aggs: Sequence[Tuple[str, str]], *, ctx: HPTMTContext,
                  budget_rows: int, workdir: Optional[str] = None,
                  report: Optional[OverflowReport] = None,
                  policy=None) -> SpillResult:
    """Out-of-core groupby-aggregate under a per-shard memory budget.

    Each key lives in exactly one spill partition, so per-partition
    grouping is exact with no cross-partition merge step.
    """
    report = report if report is not None else OverflowReport()
    keys = tuple(keys)
    store = SpillStore(workdir, policy=policy, group=ctx.group)
    try:
        n_parts = plan_partitions(_total_rows_or_none(src, group=ctx.group),
                                  ctx.n_shards, budget_rows)
        _, schema = _round(store, lambda: _partition_hash(
            store, "in", src, keys, ctx.n_shards, n_parts))
        n = _tag_rows(store, "in")
        parts, refined, oversized = _refine_oversized(
            store, ("in",), ctx.n_shards, budget_rows, n_parts,
            per_shard=True)
        stats = SpillStats(n_parts=n_parts, refined=refined,
                           oversized=oversized, rows_in=n)
        out_schema = None
        for q in parts:
            rows = max((store.rows("in", q, s)
                        for s in range(ctx.n_shards)), default=0)
            if rows == 0:
                store.drop_partition("in", q)
                continue
            cap = _round_capacity(rows, budget_rows)
            dt = _round(store, lambda: _load_hash_partition(
                store, "in", q, schema, keys, ctx, cap))
            with telemetry.span("spill.reentry", op="table.groupby",
                                partition=q) as sp:
                out, ov = table_ops.groupby_aggregate(dt, keys, tuple(aggs),
                                                      ctx=ctx)
                sp.block(out)
            report.add("groupby.slots", ov)
            if out_schema is None:
                out_schema = _out_schema_of(out)
            stats.rows_out += _write_output(store, q, out, ctx)
            stats.pairs += 1
            store.drop_partition("in", q)
        report.add_recovered("spill.groupby", n)
        if out_schema is None:
            out_schema = _groupby_schema(schema, keys, aggs)
        return _finish(store, ctx, (keys, ctx.n_shards), report, stats,
                       out_schema)
    except BaseException:
        store.close()
        raise


def spill_window(src, partition_by, order_by, aggs, *, ctx: HPTMTContext,
                 budget_rows: int, rows: Optional[int] = None,
                 ascending=True, workdir: Optional[str] = None,
                 report: Optional[OverflowReport] = None,
                 policy=None) -> SpillResult:
    """Out-of-core windowed aggregation under a per-shard memory budget.

    Partitions hash the PARTITION BY keys only (one window partition
    never straddles spill partitions); each re-ingested partition is
    host-sorted by its carried lanes, block-sliced, and evaluated on the
    range-elided window path — zero exchanges, zero sorts.
    """
    report = report if report is not None else OverflowReport()
    pkeys = (partition_by,) if isinstance(partition_by, str) \
        else tuple(partition_by)
    store = SpillStore(workdir, policy=policy, group=ctx.group)
    try:
        it = iter_host_chunks(src)

        def peek():  # one round: an empty source on any rank fails all
            try:
                first = next(it)
            except StopIteration:
                raise ValueError("spill source yielded no chunks") from None
            return first, table_ops._normalize_order(
                order_by, ascending, tuple(sorted(first[0])), "order_by")

        first, (okeys, asc_o) = _round(store, peek)
        keys = pkeys + okeys
        asc = (True,) * len(pkeys) + asc_o
        n_parts = plan_partitions(_total_rows_or_none(src, group=ctx.group),
                                  ctx.n_shards, budget_rows)
        _, schema = _round(store, lambda: _partition_window(
            store, "in", itertools.chain([first], it), pkeys, keys, asc,
            n_parts))
        n = _tag_rows(store, "in")
        parts, refined, oversized = _refine_oversized(
            store, ("in",), ctx.n_shards, budget_rows * ctx.n_shards,
            n_parts, per_shard=False)
        stats = SpillStats(n_parts=n_parts, refined=refined,
                           oversized=oversized, rows_in=n)
        out_schema = None
        for q in parts:
            qrows = store.rows("in", q)
            if qrows == 0:
                store.drop_partition("in", q)
                continue
            per = max(1, math.ceil(qrows / ctx.n_shards))
            cap = _round_capacity(per, budget_rows)
            dt = _round(store, lambda: _load_range_partition(
                store, "in", q, schema, keys, asc, ctx, cap))
            with telemetry.span("spill.reentry", op="table.window",
                                partition=q) as sp:
                out, ov = table_ops.window_aggregate(dt, pkeys, okeys, aggs,
                                                     ctx=ctx, rows=rows,
                                                     ascending=asc_o)
                sp.block(out)
            report.add("window.truncated", ov)
            if out_schema is None:
                out_schema = _out_schema_of(out)
            stats.rows_out += _write_output(store, q, out, ctx)
            stats.pairs += 1
            store.drop_partition("in", q)
        report.add_recovered("spill.window", n)
        part = range_partitioning(keys, asc, ctx.n_shards)
        if out_schema is None:
            out_schema = dict(schema)
        return _finish(store, ctx, part, report, stats, out_schema)
    except BaseException:
        store.close()
        raise


def _finish(store: SpillStore, ctx, partitioning, report, stats,
            out_schema) -> SpillResult:
    stats.bytes_spilled = store.bytes_written
    rec = telemetry.current()
    if rec is not None:
        rec.metrics.gauge("spill.bytes_spilled", stats.bytes_spilled)
        rec.metrics.gauge("spill.pairs", stats.pairs)
        rec.metrics.gauge("spill.rows_in", stats.rows_in)
        rec.metrics.gauge("spill.rows_out", stats.rows_out)
        telemetry.publish_pressure(rec, "spill")
        rec.record_overflow(report)
    return SpillResult(store, ctx, partitioning, report, stats, out_schema)


# ===========================================================================
# predicted output schemas (fallback when no partition produced rows)
# ===========================================================================
def _join_schema(lschema, rschema, keys) -> Dict[str, Tuple]:
    out = dict(lschema)
    for k, v in rschema.items():
        if k not in keys:
            out[k] = v
    return out


def _groupby_schema(schema, keys, aggs) -> Dict[str, Tuple]:
    out = {k: schema[k] for k in keys}
    for col, op in aggs:
        if op == "count":
            out[f"{col}_count"] = (np.dtype(np.int32), ())
        elif op == "mean":
            out[f"{col}_mean"] = (np.dtype(np.float32), ())
        else:
            out[f"{col}_{op}"] = schema[col]
    return out
