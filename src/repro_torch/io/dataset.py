"""Sharded on-disk datasets and the partitioning manifest (DESIGN.md §5.3).

A dataset is a directory of shard files plus ``_hptmt_manifest.json``::

    root/
      _hptmt_manifest.json
      part-00000-000.hpt        (or .parquet)
      part-00001-000.hpt
      ...

The manifest records the schema, every file's row count and **which shard
wrote it**, and — when the dataset was written with ``partition_by=keys``
— the hash-partitioning evidence ``{"keys": [...], "n_shards": p}``.  That
is exactly the ``DistTable.partitioning`` contract of DESIGN.md §4: a scan
that places file ``i``'s rows back on shard ``i`` of a ``p``-shard context
may re-attach the metadata, and a following ``join``/``groupby`` on the
partition keys elides its shuffle (zero left-side exchanges, counted by
``array_ops.EXCHANGES`` in ``tests/test_torch_io.py``).  The manifest and
the files are the JAX package's, so either package reads what the other
wrote.

Fragments are the pushdown granularity: one per Parquet row group, one
per native ``.hpt`` file.  Both carry per-column min/max stats.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.table import DistTable, Partitioning, partitioning_kind
from .compat import has_pyarrow, require_pyarrow
from .native import read_hpt_header, write_hpt
from .schema import Schema

MANIFEST_NAME = "_hptmt_manifest.json"
FORMATS = ("hpt", "parquet")


@dataclasses.dataclass(frozen=True)
class Fragment:
    """One prunable unit: an ``.hpt`` file or one Parquet row group."""
    path: str
    format: str
    row_group: Optional[int]  # None for hpt (file == fragment)
    rows: int
    stats: Dict[str, Optional[Tuple]]
    file_index: int
    shard: Optional[int]  # writer shard recorded in the manifest


@dataclasses.dataclass(frozen=True)
class Dataset:
    """Planned view of an on-disk dataset: metadata only, no data read."""
    root: str
    format: str
    schema: Schema
    fragments: Tuple[Fragment, ...]
    partitioning: Partitioning
    n_files: int

    @property
    def num_rows(self) -> int:
        return sum(f.rows for f in self.fragments)

    def stat_bounds(self, column: str) -> Optional[Tuple]:
        """Global ``(min, max)`` for ``column`` across all fragments.

        ``None`` when any fragment lacks stats for the column — callers
        (the query planner's cardinality estimator) must treat that as
        "unknown", the same conservatism as fragment pruning.
        """
        lo = hi = None
        for f in self.fragments:
            s = f.stats.get(column)
            if s is None:
                return None
            lo = s[0] if lo is None else min(lo, s[0])
            hi = s[1] if hi is None else max(hi, s[1])
        return None if lo is None else (lo, hi)


def _default_format(fmt: Optional[str]) -> str:
    if fmt in FORMATS:
        return fmt
    if fmt in (None, "auto"):
        return "parquet" if has_pyarrow() else "hpt"
    raise ValueError(f"unknown dataset format {fmt!r}; expected {FORMATS}")


# ===========================================================================
# writing
# ===========================================================================
def write_dataset(root: str,
                  shards: Sequence[Tuple[Dict[str, np.ndarray], int]],
                  *, format: Optional[str] = None,
                  partitioning: Partitioning = None,
                  rows_per_group: Optional[int] = None) -> str:
    """Write per-shard ``(columns, num_rows)`` arrays as a dataset.

    ``rows_per_group`` bounds the pushdown granularity: Parquet splits each
    shard file into row groups of that size; the native format writes one
    ``.hpt`` file per group (a fragment is a whole file there).
    ``partitioning`` is recorded verbatim in the manifest — callers assert
    it truthfully (see :func:`write_dist_table`).
    """
    fmt = _default_format(format)
    os.makedirs(root, exist_ok=True)
    written = [_write_shard(root, i, cols, n, fmt, rows_per_group)
               for i, (cols, n) in enumerate(shards)]
    _write_manifest(root, fmt, written, partitioning)
    return root


def _write_shard(root: str, shard_id: int, cols: Dict[str, np.ndarray],
                 n: int, fmt: str, rows_per_group: Optional[int]
                 ) -> Tuple[Schema, List[dict]]:
    """Write one shard's files → its schema and manifest file entries."""
    cols = {k: np.asarray(v)[:n] for k, v in cols.items()}
    files: List[dict] = []
    if fmt == "parquet":
        from .parquet import write_parquet

        name = f"part-{shard_id:05d}-000.parquet"
        write_parquet(os.path.join(root, name), cols, n,
                      rows_per_group=rows_per_group)
        files.append({"path": name, "rows": int(n), "shard": shard_id})
    else:
        per = int(rows_per_group) if rows_per_group else max(int(n), 1)
        starts = range(0, max(int(n), 1), per) if n else [0]
        for g, start in enumerate(starts):
            stop = min(start + per, int(n))
            name = f"part-{shard_id:05d}-{g:03d}.hpt"
            write_hpt(os.path.join(root, name),
                      {k: v[start:stop] for k, v in cols.items()},
                      stop - start)
            files.append({"path": name, "rows": int(stop - start),
                          "shard": shard_id})
    return Schema.from_columns(cols), files


def _write_manifest(root: str, fmt: str,
                    written: Sequence[Tuple[Schema, List[dict]]],
                    partitioning: Partitioning) -> None:
    """The manifest of every shard's ``(schema, files)``, in shard order,
    written last (atomic rename)."""
    if not written:
        raise ValueError("write_dataset needs at least one shard")
    schema = written[0][0]
    for shard_id, (s, _) in enumerate(written):
        if s != schema:
            raise ValueError(f"shard {shard_id} schema {s} != shard 0 "
                             f"schema {schema}")
    # the manifest's {"keys", "n_shards"} schema records HASH evidence
    # only (scan re-entry feeds the §4 elision sites); a range layout
    # (orderby output) is not representable on disk yet — normalize it to
    # None here so EVERY caller is covered (dropping is always safe, §4)
    if partitioning is not None and partitioning_kind(partitioning) != "hash":
        partitioning = None
    manifest = {
        "version": 1,
        "format": fmt,
        "schema": schema.to_json(),
        "partitioning": (None if partitioning is None else
                         {"keys": list(partitioning[0]),
                          "n_shards": int(partitioning[1])}),
        "files": [f for _, files in written for f in files],
    }
    tmp = os.path.join(root, MANIFEST_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, os.path.join(root, MANIFEST_NAME))


def write_dist_table(dt: DistTable, root: str, *, ctx,
                     format: Optional[str] = None,
                     partition_by: Optional[Sequence[str]] = None,
                     rows_per_group: Optional[int] = None):
    """Write a :class:`DistTable` as a dataset; returns the overflow count.

    With ``partition_by`` the rows are hash-shuffled first (a no-op when
    ``dt.partitioning`` already proves the layout, DESIGN.md §4) and the
    manifest records the ``(keys, n_shards)`` evidence, so a later scan on
    a matching context re-enters the partitioned world without moving a
    row.

    On the context's process group every rank calls this (``root`` one
    directory every rank sees): each writes the files of its own shards,
    then the ranks gather every shard's schema and file entries, and rank
    0 writes the manifest — only after every shard file exists, and
    before any rank returns.  The files and the manifest are the virtual
    run's, byte for byte; a failure on any rank raises on every rank.
    """
    from ..core import table_ops
    from ..core.array_ops import gather_objects, raise_together

    fmt = _default_format(format)
    overflow = 0
    if partition_by is not None:
        dt, ov = table_ops.shuffle(dt, list(partition_by), ctx=ctx)
        overflow = int(ov)
    err, mine = None, []
    try:
        os.makedirs(root, exist_ok=True)
        for i, shard in enumerate(ctx.local_shards):
            t = dt.shard_table(i)
            mine.append(_write_shard(root, shard, t.to_numpy(),
                                     int(t.num_rows), fmt, rows_per_group))
    except Exception as e:  # noqa: BLE001 — every rank raises
        err = e
    raise_together(err, ctx.group)
    written = [w for rank in gather_objects(mine, ctx.group) for w in rank]
    err = None
    if ctx.rank == 0:
        try:
            _write_manifest(root, fmt, written, dt.partitioning)
        except Exception as e:  # noqa: BLE001 — every rank raises
            err = e
    raise_together(err, ctx.group)
    return overflow


# ===========================================================================
# opening
# ===========================================================================
def open_dataset(path: str) -> Dataset:
    """Open a dataset directory (manifest) or a single shard file.

    Metadata-only: reads the manifest plus per-file headers / Parquet
    footers; no data pages are touched until a scan materializes.
    """
    if os.path.isdir(path):
        return _open_dir(path)
    if path.endswith(".hpt"):
        return _from_files(os.path.dirname(path) or ".", "hpt",
                           [{"path": os.path.basename(path), "shard": None}],
                           partitioning=None)
    if path.endswith(".parquet"):
        return _from_files(os.path.dirname(path) or ".", "parquet",
                          [{"path": os.path.basename(path), "shard": None}],
                          partitioning=None)
    raise ValueError(f"{path}: not a dataset directory, .hpt, or .parquet")


def _open_dir(root: str) -> Dataset:
    mpath = os.path.join(root, MANIFEST_NAME)
    if os.path.exists(mpath):
        with open(mpath) as f:
            m = json.load(f)
        part = m.get("partitioning")
        partitioning = (tuple(part["keys"]), int(part["n_shards"])) \
            if part else None
        return _from_files(root, m["format"], m["files"], partitioning,
                           schema=Schema.from_json(m["schema"]))
    # manifest-less directory: glob shard files, no partitioning evidence
    for fmt, pattern in (("parquet", "*.parquet"), ("hpt", "*.hpt")):
        found = sorted(glob.glob(os.path.join(root, pattern)))
        if found:
            return _from_files(
                root, fmt,
                [{"path": os.path.basename(p), "shard": None} for p in found],
                partitioning=None)
    raise FileNotFoundError(f"{root}: no {MANIFEST_NAME}, *.parquet or "
                            f"*.hpt files")


def _from_files(root: str, fmt: str, files: Sequence[dict],
                partitioning: Partitioning,
                schema: Optional[Schema] = None) -> Dataset:
    if fmt == "parquet":
        require_pyarrow(f"opening parquet dataset {root}")
    fragments: List[Fragment] = []
    for idx, entry in enumerate(files):
        fpath = os.path.join(root, entry["path"])
        shard = entry.get("shard")
        if fmt == "hpt":
            header = read_hpt_header(fpath)
            fschema = Schema.from_json(header["schema"])
            stats = {k: (None if v is None else (v["min"], v["max"]))
                     for k, v in header.get("stats", {}).items()}
            fragments.append(Fragment(fpath, fmt, None, header["num_rows"],
                                      stats, idx, shard))
        else:
            from .parquet import parquet_fragments, parquet_schema

            fschema = parquet_schema(fpath)
            for g, rows, stats in parquet_fragments(fpath):
                fragments.append(Fragment(fpath, fmt, g, rows, stats, idx,
                                          shard))
        if schema is None:
            schema = fschema
        elif fschema != schema:
            raise ValueError(f"{fpath}: schema {fschema} != dataset "
                             f"schema {schema}")
    if schema is None:
        raise FileNotFoundError(f"{root}: dataset has no files")
    return Dataset(root=root, format=fmt, schema=schema,
                   fragments=tuple(fragments), partitioning=partitioning,
                   n_files=len(files))
