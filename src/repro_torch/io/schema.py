"""Arrow-compatible schema model ↔ the packed ``ColSpec`` lane format.

A :class:`Schema` is the static type of a table: an ordered set of
:class:`Field`\\ s (name, numpy dtype, trailing dims).  It maps
*bidirectionally* onto the ``ColSpec`` uint32-lane layout that the port's
packed exchange uses (``core/exchange.py``): fields are laid out in
sorted-name order and each field occupies ``lanes`` uint32 lanes per row —
1 lane per element for ≤4-byte types (sub-4-byte types widen), 2 lanes per
element for 8-byte types, trailing dims flatten to extra lanes.  The same
schema also maps onto an Arrow schema (``pyarrow`` optional): trailing
dims become nested ``fixed_size_list`` types.

Validity contract (DESIGN.md §2/§5): a stored table is *fixed capacity +
``num_rows``* — every row in ``[0, num_rows)`` is valid and there is no
per-value null bitmap.  Arrow inputs containing nulls are rejected eagerly
with the offending column names (never silently zero-filled).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core.exchange import ColSpec
from .compat import require_pyarrow

#: numpy dtypes representable in the packed uint32-lane format.
SUPPORTED_DTYPES: Tuple[str, ...] = (
    "bool", "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64",
    "float16", "float32", "float64",
)


#: the torch dtype of each storable numpy dtype: the port's ``ColSpec``
#: holds a ``torch.dtype`` where the reference's holds a numpy one
TORCH_DTYPES = {name: getattr(torch, name) for name in SUPPORTED_DTYPES}
_NUMPY_NAMES = {t: name for name, t in TORCH_DTYPES.items()}


def _canon_dtype(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        if dtype not in _NUMPY_NAMES:
            raise TypeError(f"dtype {dtype} is not storable: the packed "
                            f"lane format supports {SUPPORTED_DTYPES}")
        return _NUMPY_NAMES[dtype]
    try:
        name = np.dtype(dtype).name
    except TypeError:
        name = str(dtype)  # e.g. the unparseable 'str32' of a '<U' dtype
    if name not in SUPPORTED_DTYPES:
        raise TypeError(
            f"dtype {name!r} is not storable: the packed lane format "
            f"supports {SUPPORTED_DTYPES} (dictionary-encode strings into "
            f"fixed-width integer ids first, per core/table.py)")
    return name


@dataclasses.dataclass(frozen=True)
class Field:
    """One column: name, canonical numpy dtype name, trailing dims."""
    name: str
    dtype: str
    trailing: Tuple[int, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "dtype", _canon_dtype(self.dtype))
        object.__setattr__(self, "trailing", tuple(int(t) for t in self.trailing))

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(self.dtype)

    @property
    def torch_dtype(self) -> torch.dtype:
        return TORCH_DTYPES[self.dtype]

    @property
    def elements(self) -> int:
        """Flattened trailing elements per row."""
        return math.prod(self.trailing) if self.trailing else 1

    @property
    def lanes(self) -> int:
        """uint32 lanes per row in the packed format (§3.1)."""
        per = 2 if self.np_dtype.itemsize == 8 else 1
        return per * self.elements


class Schema:
    """Ordered field set; order is the packed layout's sorted-name order."""

    def __init__(self, fields: Sequence[Field]):
        fields = sorted(fields, key=lambda f: f.name)
        names = [f.name for f in fields]
        if len(set(names)) != len(names):
            dup = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"duplicate field names: {dup}")
        if not fields:
            raise ValueError("Schema needs at least one field")
        self.fields: Tuple[Field, ...] = tuple(fields)
        self._by_name: Dict[str, Field] = {f.name: f for f in fields}

    # -- basics ----------------------------------------------------------
    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(f.name for f in self.fields)

    @property
    def row_width(self) -> int:
        """Total uint32 lanes per packed row."""
        return sum(f.lanes for f in self.fields)

    def __getitem__(self, name: str) -> Field:
        return self._by_name[name]

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def __iter__(self):
        return iter(self.fields)

    def __eq__(self, other) -> bool:
        return isinstance(other, Schema) and self.fields == other.fields

    def __repr__(self) -> str:
        inner = ", ".join(
            f"{f.name}:{f.dtype}{list(f.trailing) if f.trailing else ''}"
            for f in self.fields)
        return f"Schema({inner})"

    def subset(self, names: Sequence[str]) -> "Schema":
        missing = [n for n in names if n not in self._by_name]
        if missing:
            raise KeyError(
                f"columns {missing} not in schema {list(self.names)}")
        return Schema([self._by_name[n] for n in names])

    # -- columns ↔ schema -------------------------------------------------
    @classmethod
    def from_columns(cls, cols: Dict[str, "np.ndarray"]) -> "Schema":
        """Infer the schema of a column dict (numpy arrays or torch
        tensors)."""
        return cls([Field(k, v.dtype, tuple(v.shape[1:]))
                    for k, v in cols.items()])

    def validate_columns(self, cols: Dict[str, np.ndarray]) -> None:
        got = Schema.from_columns(cols)
        if got != self:
            raise ValueError(f"columns {got} do not match schema {self}")

    # -- ColSpec mapping (core/exchange.py) --------------------------------
    def to_colspecs(self) -> Tuple[ColSpec, ...]:
        """The exact packed layout ``pack_columns`` produces for this schema."""
        specs: List[ColSpec] = []
        start = 0
        for f in self.fields:  # already sorted by name == pack order
            specs.append(ColSpec(f.name, f.torch_dtype, f.trailing, start,
                                 f.lanes))
            start += f.lanes
        return tuple(specs)

    @classmethod
    def from_colspecs(cls, specs: Sequence[ColSpec]) -> "Schema":
        sc = cls([Field(s.name, s.dtype, tuple(s.trailing)) for s in specs])
        # round-trip integrity: the lane math here must agree with the
        # packer that produced the specs
        for ours, theirs in zip(sc.to_colspecs(), sorted(specs,
                                                         key=lambda s: s.start)):
            if (ours.start, ours.lanes) != (theirs.start, theirs.lanes):
                raise ValueError(
                    f"ColSpec layout mismatch for {ours.name!r}: schema "
                    f"computes (start={ours.start}, lanes={ours.lanes}), "
                    f"packer recorded (start={theirs.start}, "
                    f"lanes={theirs.lanes})")
        return sc

    # -- JSON (manifest / .hpt header) -------------------------------------
    def to_json(self) -> List[dict]:
        return [{"name": f.name, "dtype": f.dtype,
                 "trailing": list(f.trailing)} for f in self.fields]

    @classmethod
    def from_json(cls, data: Sequence[dict]) -> "Schema":
        return cls([Field(d["name"], d["dtype"], tuple(d.get("trailing", ())))
                    for d in data])

    # -- Arrow mapping ------------------------------------------------------
    def to_arrow(self):
        pa = require_pyarrow("Schema.to_arrow")
        return pa.schema([(f.name, _arrow_type(pa, f)) for f in self.fields])

    @classmethod
    def from_arrow(cls, arrow_schema) -> "Schema":
        require_pyarrow("Schema.from_arrow")
        return cls([_field_from_arrow(f) for f in arrow_schema])


def _arrow_type(pa, field: Field):
    t = pa.from_numpy_dtype(field.np_dtype)
    for dim in reversed(field.trailing):
        t = pa.list_(t, dim)
    return t


def _field_from_arrow(af) -> Field:
    import pyarrow as pa

    t, trailing = af.type, []
    while pa.types.is_fixed_size_list(t):
        trailing.append(t.list_size)
        t = t.value_type
    try:
        dtype = t.to_pandas_dtype()
    except NotImplementedError as e:
        raise TypeError(
            f"arrow column {af.name!r} has unsupported type {af.type} "
            f"(dictionary-encode strings into integer ids first)") from e
    return Field(af.name, np.dtype(dtype).name, tuple(trailing))
