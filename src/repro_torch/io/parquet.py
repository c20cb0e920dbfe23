"""Parquet shard files: write with row groups, read with pushdown.

One Parquet file holds one shard's valid rows, split into row groups of
``rows_per_group`` (the pushdown granularity).  The reader works from
file *metadata only* until actual row groups are selected:

  * :func:`parquet_fragments` lists per-row-group ``(rows, min/max stats)``
    without touching data pages — what the scan planner prunes against;
  * :func:`read_row_groups` materializes only the selected row groups and
    only the projected columns (projection pushdown is Parquet-native:
    unprojected column chunks are never decoded or read).

All functions require pyarrow (`pip install .[io]`); the native ``.hpt``
path (``native.py``) is the dependency-free equivalent.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .arrow import from_arrow, to_arrow
from .compat import require_pyarrow
from .schema import Schema


def write_parquet(path: str, cols: Dict[str, np.ndarray],
                  num_rows: Optional[int] = None,
                  rows_per_group: Optional[int] = None) -> None:
    """Write valid rows as one Parquet file with min/max statistics."""
    require_pyarrow("write_parquet")
    import pyarrow.parquet as pq

    table = to_arrow(cols, num_rows)
    kw = {}
    if rows_per_group is not None:
        kw["row_group_size"] = int(rows_per_group)
    pq.write_table(table, path, write_statistics=True, **kw)


def parquet_schema(path: str) -> Schema:
    require_pyarrow("parquet_schema")
    import pyarrow.parquet as pq

    return Schema.from_arrow(pq.ParquetFile(path).schema_arrow)


def parquet_fragments(path: str) -> List[Tuple[int, int, Dict[str, Optional[Tuple]]]]:
    """Per-row-group metadata: ``(row_group_index, rows, {col: (min,max)})``.

    Stats cover only top-level primitive columns (nested fixed_size_list
    leaves are skipped); a column without usable min/max maps to ``None``
    so the planner cannot prune on it — conservative, never wrong.
    """
    require_pyarrow("parquet_fragments")
    import pyarrow.parquet as pq

    md = pq.ParquetFile(path).metadata
    out = []
    for g in range(md.num_row_groups):
        rg = md.row_group(g)
        stats: Dict[str, Optional[Tuple]] = {}
        for c in range(rg.num_columns):
            col = rg.column(c)
            name = col.path_in_schema
            if "." in name:  # nested leaf — not a scannable scalar column
                continue
            s = col.statistics
            if s is not None and s.has_min_max:
                stats[name] = (s.min, s.max)
            else:
                stats[name] = None
        out.append((g, rg.num_rows, stats))
    return out


def read_row_groups(path: str, row_groups: Sequence[int],
                    columns: Optional[Sequence[str]] = None,
                    ) -> Tuple[Dict[str, np.ndarray], int]:
    """Materialize selected row groups / projected columns → numpy."""
    require_pyarrow("read_row_groups")
    import pyarrow.parquet as pq

    pf = pq.ParquetFile(path)
    table = pf.read_row_groups(list(row_groups),
                               columns=list(columns) if columns else None)
    return from_arrow(table)
