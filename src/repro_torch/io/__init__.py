"""Columnar storage & ingest subsystem (HPTMT §VI interoperability).

The paper names Apache Arrow and Parquet as the keystone of
language-agnostic, high-performance interop; this package maps them onto
the port's static-shape Table/DistTable world (reference DESIGN.md §5).
It is the JAX package's ``repro.io`` on torch: the same names, the same
files on disk (either package reads what the other wrote, bit for bit),
and rows that land on the context's device at table assembly.

  schema.py    Arrow-compatible schema model ↔ the packed ``ColSpec``
               uint32-lane format of ``core/exchange.py``
  native.py    pure-numpy ``.hpt`` container (header + raw column
               buffers) — works and is CI-tested with pyarrow absent
  arrow.py     zero-copy ``from_arrow``/``to_arrow`` (optional pyarrow)
  parquet.py   per-shard Parquet files with row-group min/max stats
  dataset.py   sharded on-disk datasets + the partitioning manifest
  scan.py      pushdown-aware ``ScanSource`` (projection + predicate,
               row-group skipping, per-shard capacity planning)
"""
from .compat import has_pyarrow, require_pyarrow
from .schema import Field, Schema
from .native import (CorruptFragmentError, HptIntegrityError, read_hpt,
                     read_hpt_header, write_hpt)
from .arrow import from_arrow, to_arrow
from .dataset import Dataset, Fragment, open_dataset, write_dataset, write_dist_table
from .scan import ColumnPredicate, ScanSource, ScanStats, pred, read_dataset

__all__ = [
    "has_pyarrow", "require_pyarrow", "Field", "Schema",
    "CorruptFragmentError", "HptIntegrityError", "read_hpt",
    "read_hpt_header", "write_hpt",
    "from_arrow", "to_arrow",
    "Dataset", "Fragment", "open_dataset", "write_dataset",
    "write_dist_table",
    "ColumnPredicate", "ScanSource", "ScanStats", "pred", "read_dataset",
]
