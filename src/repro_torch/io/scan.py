"""Pushdown-aware sharded scan operator (DESIGN.md §5.4).

``ScanSource`` turns an on-disk :class:`~repro_torch.io.dataset.Dataset`
into a :class:`DistTable` (eager) or a stream of chunk tables
(``chunks()``; the reference's ``TSet`` bridge waits for the port's
dataflow), planning everything from metadata before touching a data
page:

  * **Projection pushdown** — only projected columns (plus columns the
    predicate needs) are read; unprojected columns are never materialized
    (Parquet skips their column chunks, ``.hpt`` seeks past their
    buffers).
  * **Predicate pushdown** — fragments (Parquet row groups / ``.hpt``
    files) whose min/max stats prove no row can match are skipped whole;
    surviving fragments get an exact residual row filter after load.
    Stats-based pruning is conservative: missing stats never prune.
  * **Capacity planning** — per-shard static capacity is computed from
    the row counts of the fragments assigned to each shard; an explicit
    smaller ``capacity`` engages the §2 overflow contract (excess rows
    are counted and dropped in original row order, never corrupted).
  * **Partitioned re-entry** — when the manifest's hash-partitioning
    evidence matches the context (same ordered keys, same shard count,
    every key column projected), fragments are placed back on the shard
    that wrote them and the result carries ``DistTable.partitioning``:
    a following join/groupby on those keys elides its shuffle
    (DESIGN.md §4).

On a process group (``ctx.group``) every rank plans the same
``_by_shard`` from the metadata and reads only the fragments of its own
shards; capacities, overflow and :class:`ScanStats` are the global plan's
and the group's sums, bit for bit the virtual run's on as many shards.

Hardened reads (DESIGN.md §13.5): every fragment run passes through the
``scan.read`` chaos-injection site and, with a
:class:`~repro_torch.resilience.FaultPolicy`, transient ``OSError``-family
failures are retried with backoff.  Corruption — truncation, CRC or
byte-count mismatch, schema drift, undecodable Parquet pages — is
*never* retried: it surfaces as a typed
:class:`~repro_torch.io.native.CorruptFragmentError` naming the file and
fragment, or, under ``on_error="quarantine"``, the bad fragment is
skipped whole, counted in :class:`ScanStats`, and recorded in a
``_hptmt_quarantine.json`` sidecar next to the dataset.

Planning and I/O run on the host in numpy; rows enter torch (on the
context's device) and the fixed-capacity static-shape world only at table
assembly, narrowed as ``core/table.py:as_tensor`` narrows (int64 → int32,
uint64 → uint32, float64 → float32) and refused, unless
``allow_narrowing``, when the narrowing would lose a value.

Under an active telemetry collector the scan opens the reference's
``io.scan.prune`` / ``io.scan.read`` / ``io.scan.materialize`` spans,
records its :class:`ScanStats` under ``scan.*`` and publishes the host's
memory pressure (``scan.pressure.*``).
"""
from __future__ import annotations

import dataclasses
import json
import math
import operator as _op
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import telemetry
from ..core.table import DistTable, Partitioning, Table, as_tensor
from ..resilience import faults
from .dataset import Dataset, Fragment, open_dataset
from .native import CorruptFragmentError

_OPS = {"<": _op.lt, "<=": _op.le, ">": _op.gt, ">=": _op.ge,
        "==": _op.eq, "!=": _op.ne}


@dataclasses.dataclass(frozen=True)
class ColumnPredicate:
    """One comparison ``column <op> value``; a list of these is an AND."""
    column: str
    op: str
    value: Union[int, float, bool]

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"unknown predicate op {self.op!r}; "
                             f"expected one of {sorted(_OPS)}")

    def maybe_satisfied(self, stats: Optional[Tuple]) -> bool:
        """Can ANY row of a fragment with these min/max stats match?

        ``None`` stats (absent, NaN-poisoned, or non-scalar column) never
        prune — conservative.
        """
        if stats is None:
            return True
        mn, mx = stats
        v = self.value
        if self.op == "<":
            return mn < v
        if self.op == "<=":
            return mn <= v
        if self.op == ">":
            return mx > v
        if self.op == ">=":
            return mx >= v
        if self.op == "==":
            return mn <= v <= mx
        return not (mn == v == mx)  # "!="

    def mask(self, cols: Dict[str, np.ndarray]) -> np.ndarray:
        """Exact residual row filter on loaded host columns."""
        return _OPS[self.op](cols[self.column], self.value)


def pred(column: str, op: str, value) -> ColumnPredicate:
    """Shorthand: ``pred("day", "<", 7)``."""
    return ColumnPredicate(column, op, value)


def _normalize_predicate(predicate) -> Tuple[ColumnPredicate, ...]:
    if predicate is None:
        return ()
    if isinstance(predicate, ColumnPredicate):
        return (predicate,)
    if isinstance(predicate, tuple) and len(predicate) == 3 \
            and isinstance(predicate[0], str):
        return (ColumnPredicate(*predicate),)
    return tuple(p if isinstance(p, ColumnPredicate)
                 else ColumnPredicate(*p) for p in predicate)


@dataclasses.dataclass
class ScanStats:
    """Observable pushdown accounting (asserted by tests/benchmarks)."""
    files_total: int = 0
    row_groups_total: int = 0
    row_groups_skipped: int = 0
    columns_total: int = 0
    columns_read: int = 0
    rows_on_disk: int = 0      # dataset total per metadata
    rows_scanned: int = 0      # materialized from surviving fragments
    rows_selected: int = 0     # after the residual predicate
    rows_overflowed: int = 0   # dropped by the §2 capacity contract
    fragments_quarantined: int = 0  # corrupt fragments skipped (opt-in)
    rows_quarantined: int = 0       # metadata rows of those fragments

    def as_report(self):
        """This scan's overflow as an :class:`~repro_torch.core.report.OverflowReport`
        under the ``"scan.capacity"`` label — mergeable into a
        DataFrame/TSet lineage report (DESIGN.md §10)."""
        from ..core.report import OverflowReport

        return OverflowReport().add("scan.capacity", self.rows_overflowed)


class ScanSource:
    """Plan + execute a sharded, pushdown-aware scan of a dataset."""

    def __init__(self, dataset: Union[Dataset, str], *, ctx,
                 columns: Optional[Sequence[str]] = None,
                 predicate=None, capacity: Optional[int] = None,
                 bucket_factor: float = 1.0,
                 allow_narrowing: bool = False,
                 on_error: str = "raise", policy=None):
        if on_error not in ("raise", "quarantine"):
            raise ValueError(f"on_error={on_error!r}; expected 'raise' "
                             f"or 'quarantine'")
        if isinstance(dataset, str):
            dataset = open_dataset(dataset)
        self.dataset = dataset
        self.ctx = ctx
        self.predicate = _normalize_predicate(predicate)
        self.allow_narrowing = allow_narrowing
        self.on_error = on_error
        self.policy = policy  # optional FaultPolicy: retry transient reads
        self.quarantined: List[Dict] = []
        schema = dataset.schema
        self.out_columns: Tuple[str, ...] = (
            tuple(columns) if columns is not None else schema.names)
        missing = [c for c in self.out_columns if c not in schema]
        if missing:
            raise KeyError(f"projected columns {missing} not in dataset "
                           f"schema {list(schema.names)}")
        for p in self.predicate:
            if p.column not in schema:
                raise KeyError(f"predicate column {p.column!r} not in "
                               f"dataset schema {list(schema.names)}")
            if schema[p.column].trailing:
                raise ValueError(f"predicate column {p.column!r} has "
                                 f"trailing dims {schema[p.column].trailing}"
                                 f" — predicates apply to scalar columns")
        # read set = projection ∪ predicate columns (pred-only columns are
        # dropped after filtering, never returned)
        self.read_columns: Tuple[str, ...] = tuple(dict.fromkeys(
            list(self.out_columns) + [p.column for p in self.predicate]))
        self.stats = ScanStats(
            files_total=dataset.n_files,
            row_groups_total=len(dataset.fragments),
            columns_total=len(schema.names),
            rows_on_disk=dataset.num_rows)
        self._plan(capacity, bucket_factor)

    # -- planning (metadata only) ------------------------------------------
    def _plan(self, capacity: Optional[int], bucket_factor: float) -> None:
        p = self.ctx.n_shards
        # "!=" on a float column must never prune: NaN rows satisfy it,
        # but writers may compute min/max ignoring NaNs (Parquet does), so
        # min == max == v does NOT prove every row equals v.  All other
        # ops are NaN-safe (a NaN row can never satisfy them).  The
        # residual filter still applies "!=" exactly.
        prunable = [pr for pr in self.predicate
                    if not (pr.op == "!="
                            and self.dataset.schema[pr.column].np_dtype.kind
                            == "f")]
        with telemetry.span("io.scan.prune",
                            fragments=len(self.dataset.fragments)) as sp:
            kept: List[Fragment] = [
                frag for frag in self.dataset.fragments
                if all(pr.maybe_satisfied(frag.stats.get(pr.column))
                       for pr in prunable)]
            self.stats.row_groups_skipped = (
                len(self.dataset.fragments) - len(kept))
            sp.attrs["pruned"] = self.stats.row_groups_skipped
        self.stats.columns_read = len(self.read_columns) if kept else 0

        # partitioned re-entry: manifest evidence + matching context +
        # every hash-key column surviving the projection (same rule as
        # table_ops.project, DESIGN.md §4)
        dpart = self.dataset.partitioning
        self._partitioning: Partitioning = None
        use_manifest_placement = (
            dpart is not None and dpart[1] == p
            and all(f.shard is not None and 0 <= f.shard < p
                    for f in self.dataset.fragments))
        if use_manifest_placement and set(dpart[0]) <= set(self.out_columns):
            self._partitioning = dpart

        self._by_shard: List[List[Fragment]] = [[] for _ in range(p)]
        for i, frag in enumerate(kept):
            shard = frag.shard if use_manifest_placement else i % p
            self._by_shard[shard].append(frag)

        # bucket_factor over-allocates like DataFrame.from_dict: head-room
        # for a *later* shuffle's hash skew (a 100%-occupancy table gives
        # downstream exchanges zero slack and overflows on skewed keys)
        planned = max([sum(f.rows for f in fr) for fr in self._by_shard]
                      + [1])
        self.shard_capacity = int(capacity) if capacity is not None \
            else math.ceil(planned * bucket_factor)

    @property
    def partitioning(self) -> Partitioning:
        return self._partitioning

    @property
    def planned_rows(self) -> int:
        """Rows in fragments that survived pruning (metadata only; an
        upper bound on materialized rows — the residual filter can only
        shrink it).  Feeds the query planner's cardinality estimates."""
        return sum(f.rows for fr in self._by_shard for f in fr)

    # -- materialization ----------------------------------------------------
    def _reset_io_stats(self) -> None:
        """I/O counters are per-materialization, not cumulative — calling
        ``to_dist_table`` and then ``chunks`` must not double-count."""
        self.stats.rows_scanned = 0
        self.stats.rows_selected = 0
        self.stats.rows_overflowed = 0
        self.stats.fragments_quarantined = 0
        self.stats.rows_quarantined = 0
        self.quarantined = []

    def _validate_run(self, frags: Sequence[Fragment],
                      cols: Dict[str, np.ndarray]) -> None:
        """Schema-drift check: a fragment whose on-disk dtypes disagree
        with the dataset schema corrupts downstream identity contracts
        (hash layouts, bit-exact parity) — typed error, never a silent
        cast."""
        schema = self.dataset.schema
        for name in self.read_columns:
            want = schema[name].np_dtype
            if cols[name].dtype != want:
                raise CorruptFragmentError(
                    f"{frags[0].path}: column {name!r} drifted to dtype "
                    f"{cols[name].dtype} (dataset schema says {want}) — "
                    f"the fragment was rewritten with a different schema")

    def _read_fragments(self, frags: Sequence[Fragment]
                        ) -> Tuple[Dict[str, np.ndarray], int]:
        """One physical read (+ validation), retried under the policy
        for transient failures; the ``scan.read`` injection site fires
        inside the retry loop so injected one-shot faults recover."""
        def read():
            faults.fire("scan.read", path=frags[0].path)
            if frags[0].format == "hpt":
                from .native import read_hpt

                cols, n = read_hpt(frags[0].path, self.read_columns)
            else:
                from .parquet import read_row_groups

                cols, n = read_row_groups(frags[0].path,
                                          [f.row_group for f in frags],
                                          self.read_columns)
            self._validate_run(frags, cols)
            return cols, n

        if self.policy is not None:
            return self.policy.run(read, site="scan.read")
        return read()

    def _quarantine(self, frags: Sequence[Fragment],
                    err: Exception) -> None:
        """Record a corrupt run and skip it whole (opt-in data loss with
        a full audit trail: stats counters and the sidecar)."""
        rows = sum(f.rows for f in frags)
        self.stats.fragments_quarantined += len(frags)
        self.stats.rows_quarantined += rows
        self.quarantined.append({
            "path": frags[0].path,
            "fragments": [f.file_index if f.row_group is None
                          else f.row_group for f in frags],
            "rows": int(rows), "error": str(err)})

    def _write_quarantine_manifest(self) -> None:
        """Sidecar audit record next to the dataset (atomic, best-effort:
        an unwritable dataset dir must not fail the scan itself)."""
        path = os.path.join(self.dataset.root, "_hptmt_quarantine.json")
        try:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"quarantined": self.quarantined}, f, indent=1)
            os.replace(tmp, path)
        except OSError:
            pass

    def _load_run(self, frags: Sequence[Fragment]
                  ) -> Tuple[Dict[str, np.ndarray], int]:
        """Load consecutive fragments of ONE file in a single read.

        Parquet row groups of the same shard file batch into one
        ``read_row_groups`` call — one file open / footer parse per run,
        not per fragment.  Corruption surfaces as a typed
        :class:`CorruptFragmentError` naming file + fragments, or the
        run is quarantined when the scan opted in.
        """
        with telemetry.span("io.scan.read", path=frags[0].path,
                            fragments=len(frags)) as sp:
            try:
                cols, n = self._read_fragments(frags)
            except (ValueError, KeyError) as e:
                # the corruption family: CorruptFragmentError subclasses
                # (hpt integrity / byte counts / schema drift), pyarrow's
                # ArrowInvalid (a ValueError), missing-column KeyErrors
                err = e if isinstance(e, CorruptFragmentError) else \
                    CorruptFragmentError(
                        f"{frags[0].path}: fragment(s) "
                        f"{[f.row_group for f in frags]} failed to decode "
                        f"({type(e).__name__}: {e})")
                if self.on_error != "quarantine":
                    raise err from e
                self._quarantine(frags, err)
                sp.attrs["quarantined"] = len(frags)
                schema = self.dataset.schema
                cols = {c: np.zeros((0,) + schema[c].trailing,
                                    schema[c].np_dtype)
                        for c in self.read_columns}
                n = 0
            self.stats.rows_scanned += n
            sp.attrs["rows_scanned"] = n
            if self.predicate:
                keep = np.ones(n, bool)
                for pr in self.predicate:
                    keep &= pr.mask(cols)
                cols = {k: v[keep] for k, v in cols.items()}
                n = int(keep.sum())
            self.stats.rows_selected += n
            sp.attrs["rows_selected"] = n
        return {k: cols[k] for k in self.out_columns}, n

    def _load_fragments(self, frags: Sequence[Fragment]
                        ) -> List[Tuple[Dict[str, np.ndarray], int]]:
        runs: List[List[Fragment]] = []
        for f in frags:
            if (runs and f.format == "parquet"
                    and runs[-1][-1].path == f.path):
                runs[-1].append(f)
            else:
                runs.append([f])
        return [self._load_run(r) for r in runs]

    def _empty_shard(self) -> Tuple[Dict[str, np.ndarray], int]:
        schema = self.dataset.schema
        return {c: np.zeros((0,) + schema[c].trailing, schema[c].np_dtype)
                for c in self.out_columns}, 0

    def _shard_table(self, frags: Sequence[Fragment],
                     capacity: int) -> Table:
        """Concatenate a shard's fragments (original row order), truncate
        at ``capacity`` per the §2 count-and-drop contract."""
        parts = self._load_fragments(frags) if frags else []
        if not parts:
            cols, n = self._empty_shard()
        else:
            n = sum(pn for _, pn in parts)
            cols = {c: np.concatenate([pc[c] for pc, _ in parts], axis=0)
                    for c in self.out_columns}
        overflow = max(0, n - capacity)
        if overflow:
            cols = {k: v[:capacity] for k, v in cols.items()}
            n = capacity
            self.stats.rows_overflowed += overflow
        return self._table(cols, n, capacity)

    def _table(self, cols: Dict[str, np.ndarray], n: int,
               capacity: int) -> Table:
        tcols = {k: _to_torch_column(k, v, self.allow_narrowing,
                                     self.ctx.device)
                 for k, v in cols.items()}
        return Table.from_arrays(tcols, num_rows=n, capacity=capacity)

    _IO_COUNTERS = ("rows_scanned", "rows_selected", "rows_overflowed",
                    "fragments_quarantined", "rows_quarantined")

    def _sync_stats(self) -> None:
        """Every rank's I/O counters summed and quarantine records joined
        in rank (so shard) order: on a group every rank then reads the
        virtual run's stats."""
        from ..core.array_ops import gather_objects

        mine = ([getattr(self.stats, k) for k in self._IO_COUNTERS],
                self.quarantined)
        every = gather_objects(mine, self.ctx.group)
        for i, k in enumerate(self._IO_COUNTERS):
            setattr(self.stats, k, sum(c[i] for c, _ in every))
        self.quarantined = [q for _, qs in every for q in qs]

    def _local_round(self, load):
        """Run ``load()`` over this rank's shards; a failure on any rank
        raises on every rank."""
        from ..core.array_ops import raise_together

        out, err = None, None
        try:
            out = load()
        except Exception as e:  # noqa: BLE001 — every rank raises
            err = e
        raise_together(err, self.ctx.group)
        return out

    def to_dist_table(self) -> Tuple[DistTable, int]:
        """Materialize the whole scan → ``(DistTable, overflow)``.

        On the context's group each rank reads only the fragments of its
        own shards (:attr:`ctx.local_shards`) at the global plan's
        capacity; the overflow and :attr:`stats` are the group's, the
        same on every rank, and rank 0 writes the quarantine sidecar."""
        self._reset_io_stats()
        with telemetry.span("io.scan.materialize",
                            shards=self.ctx.n_shards) as sp:
            def load():
                return [self._shard_table(self._by_shard[s],
                                          self.shard_capacity)
                        for s in self.ctx.local_shards]
            parts = self._local_round(load)
            self._sync_stats()
            overflow = self.stats.rows_overflowed
            dt = DistTable.from_local_tables(
                parts, self.ctx, self.shard_capacity,
                partitioning=self._partitioning)
            sp.block(dt)
            sp.attrs["rows"] = self.stats.rows_selected
            sp.attrs["overflow"] = overflow
        if self.quarantined and self.ctx.rank == 0:
            self._write_quarantine_manifest()
        rec = telemetry.current()
        if rec is not None:
            rec.record_scan(self.stats)
            telemetry.publish_pressure(rec, "scan")
        return dt, overflow

    def chunks(self):
        """Chunked form: lazily yield one DistTable per fragment *round*.

        Round ``r`` holds every shard's ``r``-th surviving fragment (or an
        empty block), sized to that round's largest fragment.  The
        generator loads one round at a time, so iterating and processing
        chunk-by-chunk keeps the I/O working set at one fragment round
        (paper Fig 5); a consumer that collects all chunks (``TSet``
        sources, barrier operators) bounds per-*operator* state by the
        chunk size but holds the chunk list itself.  Chunks inherit the
        partitioned-re-entry metadata, so a downstream combiner barrier
        can elide its merge shuffle.  On the context's group each rank
        loads its own shards' fragments of a round, and :attr:`stats`
        become the group's once the generator is exhausted.
        """
        self._reset_io_stats()
        rounds = max((len(fr) for fr in self._by_shard), default=0)
        for r in range(rounds):
            frags = [fr[r] if r < len(fr) else None
                     for fr in self._by_shard]
            cap = max((f.rows for f in frags if f is not None), default=1)
            cap = max(cap, 1)

            def load():
                tables = []
                for s in self.ctx.local_shards:
                    if frags[s] is None:
                        tables.append(self._table(self._empty_shard()[0], 0,
                                                  cap))
                    else:
                        tables.append(self._shard_table([frags[s]], cap))
                return tables
            yield DistTable.from_local_tables(
                self._local_round(load), self.ctx, cap,
                partitioning=self._partitioning)
        self._sync_stats()

    def to_tset(self):
        """The TSet bridge for out-of-core dataflow pipelines."""
        from ..core.dataflow import TSet

        return TSet.from_scan(self)


def read_dataset(path: str, *, ctx, columns: Optional[Sequence[str]] = None,
                 predicate=None, capacity: Optional[int] = None,
                 bucket_factor: float = 1.0, allow_narrowing: bool = False,
                 on_error: str = "raise", policy=None,
                 ) -> Tuple[DistTable, int, ScanStats]:
    """One-call scan: ``(DistTable, overflow, stats)``."""
    src = ScanSource(path, ctx=ctx, columns=columns, predicate=predicate,
                     capacity=capacity, bucket_factor=bucket_factor,
                     allow_narrowing=allow_narrowing, on_error=on_error,
                     policy=policy)
    dt, overflow = src.to_dist_table()
    return dt, overflow, src.stats


# ---------------------------------------------------------------------------
# host → torch dtype boundary
# ---------------------------------------------------------------------------
_NARROW = {"int64": np.int32, "uint64": np.uint32, "float64": np.float32}


def _to_torch_column(name: str, arr: np.ndarray, allow_narrowing: bool,
                     device) -> torch.Tensor:
    """Move a host column onto ``device``, refusing silent 64→32-bit loss.

    The port narrows 64-bit columns as the JAX package does with x64 off
    (``core/table.py:as_tensor``, which narrows silently).  So the narrowing
    happens here first and — unless ``allow_narrowing`` — the round trip is
    checked, raising an eager, named error when a value does not fit (the
    storage layer never corrupts silently).
    """
    if arr.dtype.name in _NARROW:
        cast = arr.astype(_NARROW[arr.dtype.name])
        if not allow_narrowing:
            back = cast.astype(arr.dtype)
            lossless = (np.array_equal(back, arr, equal_nan=True)
                        if arr.dtype.kind == "f"
                        else np.array_equal(back, arr))
            if not lossless:
                raise ValueError(
                    f"column {name!r} ({arr.dtype}) does not fit "
                    f"{np.dtype(_NARROW[arr.dtype.name]).name}, and the "
                    f"port holds 64-bit columns as 32-bit ones — cast the "
                    f"data, or pass allow_narrowing=True to accept the loss")
        arr = cast
    return as_tensor(arr, device)
