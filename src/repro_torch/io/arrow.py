"""Zero-copy Arrow interop (optional pyarrow; HPTMT §VI).

``from_arrow`` / ``to_arrow`` convert between a pyarrow Table and the
column-dict + ``num_rows`` representation the rest of the stack uses.
Fixed-width numeric columns cross the boundary without copying the data
buffers (Arrow and numpy agree on the raw layout); bool (bit-packed in
Arrow, byte-per-value in numpy) is the one materializing conversion.

Validity contract (DESIGN.md §5.1): the in-memory format is fixed
capacity + ``num_rows`` with **no null bitmap** — Arrow inputs containing
nulls are rejected eagerly with the offending column names, never
silently zero-filled.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .compat import require_pyarrow
from .schema import Schema


def check_no_nulls(arrow_table) -> None:
    """Reject nulls eagerly — the fixed-capacity + num_rows contract has
    no per-value validity bitmap to carry them."""
    bad = [(f.name, arrow_table.column(f.name).null_count)
           for f in arrow_table.schema
           if arrow_table.column(f.name).null_count]
    if bad:
        raise ValueError(
            f"columns with nulls cannot be ingested: "
            f"{[f'{n} ({c} nulls)' for n, c in bad]} — the storage "
            f"contract is fixed capacity + num_rows with no validity "
            f"bitmap (DESIGN.md §5); drop or fill the nulls first")


def from_arrow(arrow_table, columns: Optional[Sequence[str]] = None,
               ) -> Tuple[Dict[str, np.ndarray], int]:
    """pyarrow Table → (column dict, num_rows); zero-copy where possible."""
    pa = require_pyarrow("from_arrow")
    if columns is not None:
        arrow_table = arrow_table.select(list(columns))
    schema = Schema.from_arrow(arrow_table.schema)  # validates dtypes
    check_no_nulls(arrow_table)
    n = arrow_table.num_rows
    out: Dict[str, np.ndarray] = {}
    for field in schema:
        col = arrow_table.column(field.name)
        chunked = col.combine_chunks() if col.num_chunks != 1 else col.chunk(0)
        arr = chunked
        for _ in field.trailing:  # unwrap nested fixed_size_list levels
            arr = arr.flatten()
        if pa.types.is_boolean(arr.type):
            flat = arr.to_numpy(zero_copy_only=False)
        else:
            flat = arr.to_numpy(zero_copy_only=True)
        out[field.name] = flat.reshape((n,) + field.trailing)
    return out, n


def to_arrow(cols: Dict[str, np.ndarray], num_rows: Optional[int] = None):
    """(column dict, num_rows) → pyarrow Table over the valid rows.

    Numeric buffers are wrapped, not copied; only the valid-row prefix is
    exposed so padding never leaks into Arrow land.
    """
    pa = require_pyarrow("to_arrow")
    cols = {k: np.asarray(v) for k, v in cols.items()}
    schema = Schema.from_columns(cols)
    n = num_rows if num_rows is not None else \
        next(iter(cols.values())).shape[0]
    arrays = []
    for field in schema:
        valid = np.ascontiguousarray(cols[field.name][:n])
        arr = pa.array(valid.reshape(-1))
        for dim in reversed(field.trailing):
            arr = pa.FixedSizeListArray.from_arrays(arr, dim)
        arrays.append(arr)
    return pa.Table.from_arrays(arrays, names=list(schema.names))
