"""Columnar Table abstraction (paper §IV), on PyTorch tensors.

An Arrow-style struct-of-arrays table with a static shape:

  * every column is a fixed-dtype tensor of length ``capacity``;
  * rows ``[0, num_rows)`` are valid and compacted to the front; rows beyond
    are padding (their contents are ignored by all operators);
  * heterogeneous dtypes across columns, homogeneous within a column.

``Table`` is a single-shard (local) table; :class:`DistTable` is the
row-partitioned form.  Its columns are ``(n_shards, capacity, ...)``
blocks on one device — virtual shards as a leading dimension — or, on a
process group (``core/context.py``), the ``(n_local, capacity, ...)``
blocks of the shards this rank holds.

Numeric inputs narrow the way the JAX package narrows them with 64-bit
mode off (:func:`as_tensor`): int64 → int32, uint64 → uint32, float64 →
float32.  Hashes, packing and output dtypes then agree with the reference.

uint32 values (hash lanes, packed rows) are stored as ``int32`` tensors
holding the same bits: PyTorch has few ``uint32`` kernels, and equality,
``&``, ``|`` and ``^`` do not care about the sign.  Arithmetic on them
widens to int64 first (:func:`u32`).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .array_ops import spmd_allgather
from .context import DeviceLike, HPTMTContext, group_size, resolve_device

Columns = Dict[str, torch.Tensor]

# ---------------------------------------------------------------------------
# hashing (order must match kernels/hash_partition and csrc/hash_partition.cu)
# ---------------------------------------------------------------------------
M32 = 0xFFFFFFFF
_H1_INIT = 0x9E3779B9
_H2_INIT = 0x85EBCA6B
_MUL1 = 0xCC9E2D51
_MUL2 = 0x1B873593
_K2_XOR = 0xDEADBEEF

#: numpy dtypes the JAX package narrows when 64-bit mode is off
_NARROW = {np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32,
           np.dtype(np.float64): np.float32,
           np.dtype(np.complex128): np.complex64}
_TORCH_NARROW = {torch.int64: torch.int32, torch.float64: torch.float32,
                 torch.complex128: torch.complex64}


def as_tensor(x, device: DeviceLike = None) -> torch.Tensor:
    """Column → tensor on ``device``, narrowed like ``jnp.asarray``.

    A tensor keeps its device when ``device`` is None; anything else goes
    to :func:`resolve_device` (the card unless the caller says otherwise).
    """
    if isinstance(x, torch.Tensor):
        t = x if device is None else x.to(resolve_device(device))
        return t.to(_TORCH_NARROW.get(t.dtype, t.dtype))
    a = np.asarray(x)
    # copies only to narrow, to make contiguous, or to own read-only data
    a = np.ascontiguousarray(a, dtype=_NARROW.get(a.dtype, a.dtype))
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(resolve_device(device))


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern → its uint32 value as int64."""
    return x.to(torch.int64) & M32


def i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 value held in int64 → the int32 tensor with the same bits."""
    return torch.where(x > 0x7FFFFFFF, x - (1 << 32), x).to(torch.int32)


def _as_u32(col: torch.Tensor) -> torch.Tensor:
    """Bit-stable 32-bit view of a column for hashing (int32 bits)."""
    if col.dtype == torch.bool:
        return col.to(torch.int32)
    if col.is_floating_point():
        return col.to(torch.float32).contiguous().view(torch.int32)
    if col.dtype == torch.uint32:
        return col.view(torch.int32)
    # sign-extends signed types and zero-extends unsigned ones: the bits
    # of ``astype(uint32)``
    return col.to(torch.int32)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2^32`` for uint32 values in int64, never overflowing:
    the constant is split into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & M32


def _mix(h: torch.Tensor, k: torch.Tensor, mul: int) -> torch.Tensor:
    k = _mul32(k, mul)
    k = ((k << 15) | (k >> 17)) & M32
    h = h ^ k
    h = ((h << 13) | (h >> 19)) & M32
    return (_mul32(h, 5) + 0xE6546B64) & M32


def hash_lanes(keys: Sequence[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The murmur chain over int32-bit key lanes; ``(h1, h2)`` as uint32
    values in int64."""
    n = keys[0].shape[0]
    dev = keys[0].device
    h1 = torch.full((n,), _H1_INIT, dtype=torch.int64, device=dev)
    h2 = torch.full((n,), _H2_INIT, dtype=torch.int64, device=dev)
    for lane in keys:
        k = u32(lane)
        h1 = _mix(h1, k, _MUL1)
        h2 = _mix(h2, k ^ _K2_XOR, _MUL2)
    return h1 ^ (h1 >> 16), h2 ^ (h2 >> 16)


def hash_columns(cols: Sequence[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two independent 32-bit hashes per row (≈64-bit identity), returned
    as int32 tensors holding the uint32 bits."""
    h1, h2 = hash_lanes([_as_u32(c) for c in cols])
    return i32(h1), i32(h2)


# ---------------------------------------------------------------------------
# local Table
# ---------------------------------------------------------------------------
class Table:
    """A local columnar table with static capacity and dynamic row count."""

    def __init__(self, columns: Columns, num_rows):
        if not columns:
            raise ValueError("Table needs at least one column")
        caps = {v.shape[0] for v in columns.values()}
        if len(caps) != 1:
            raise ValueError(f"column capacities differ: {caps}")
        self.columns = dict(columns)
        dev = next(iter(columns.values())).device
        self.num_rows = torch.as_tensor(num_rows, dtype=torch.int32,
                                        device=dev)

    @classmethod
    def from_arrays(cls, columns, num_rows=None,
                    capacity: Optional[int] = None,
                    device: DeviceLike = None) -> "Table":
        cols = {k: as_tensor(v, device) for k, v in columns.items()}
        n = next(iter(cols.values())).shape[0]
        if num_rows is None:
            num_rows = n
        if capacity is not None and capacity != n:
            if capacity < n:
                raise ValueError("capacity smaller than provided rows")
            cols = {k: _pad_axis0(v, capacity) for k, v in cols.items()}
        return cls(cols, num_rows)

    @property
    def capacity(self) -> int:
        return next(iter(self.columns.values())).shape[0]

    @property
    def column_names(self) -> Tuple[str, ...]:
        return tuple(sorted(self.columns))

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Materialize valid rows on host."""
        k = int(self.num_rows)
        return {name: col[:k].cpu().numpy()
                for name, col in self.columns.items()}


def _pad_axis0(x: torch.Tensor, capacity: int) -> torch.Tensor:
    if x.shape[0] == capacity:
        return x
    out = torch.zeros((capacity,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    out[:x.shape[0]] = x
    return out


# ---------------------------------------------------------------------------
# distributed Table
# ---------------------------------------------------------------------------
#: Partitioning metadata (reference DESIGN.md §4/§9): ``(hash_keys,
#: n_shards)`` after a hash exchange on ``hash_keys``,
#: ``("range", keys, ascending, n_shards)`` after a range exchange (an
#: orderby), or ``None`` when the layout is unknown.  The range form is
#: told apart by its leading :data:`RANGE_MARKER`; use the helpers below
#: instead of destructuring.
Partitioning = Optional[tuple]

RANGE_MARKER = "range"


def range_partitioning(keys: Sequence[str], ascending: Sequence[bool],
                       n_shards: int) -> tuple:
    """Ordered-layout metadata produced by orderby / range repartition."""
    return (RANGE_MARKER, tuple(keys), tuple(bool(a) for a in ascending),
            int(n_shards))


def partitioning_kind(part: Partitioning) -> Optional[str]:
    """``"hash"`` / ``"range"`` / ``None`` for a metadata tuple."""
    if part is None:
        return None
    return RANGE_MARKER if part[0] == RANGE_MARKER else "hash"


def partitioning_keys(part: Partitioning) -> Tuple[str, ...]:
    """The ordered key columns the layout evidence depends on (() if None)."""
    if part is None:
        return ()
    return part[1] if part[0] == RANGE_MARKER else part[0]


def partitioning_ascending(part: Partitioning) -> Tuple[bool, ...]:
    """Per-key sort directions of a range layout (() for hash/None)."""
    if part is None or part[0] != RANGE_MARKER:
        return ()
    return part[2]


class DistTable:
    """Row-partitioned table: ``n_shards`` blocks of ``capacity`` rows each.

    ``columns[k]`` has shape ``(n_local, capacity, ...)`` and ``counts``
    shape ``(n_local,)``, each shard's valid-row count.  Without a
    ``group`` every shard is here (``n_local == n_shards``, one device);
    on a process group of ``world`` ranks these are the blocks of the
    ``n_local = n_shards // world`` shards this rank holds, and the
    methods that return the whole table (:meth:`valid_rows`,
    :meth:`to_numpy`, :meth:`to_numpy_blocks`, :meth:`to_local`) are
    collectives every rank must call.  Local shard ``i``'s block is a
    plain :class:`Table` (:meth:`shard_table`).

    ``partitioning`` records how rows were assigned to shards:
    ``(hash_keys, n_shards)`` after a hash exchange on ``hash_keys``,
    ``("range", keys, ascending, n_shards)`` after a range exchange (rows
    globally sorted, contiguous key ranges per shard), else ``None``.
    Operators skip a shuffle (hash) or a sort (range) when the layout
    already holds.  Constructors that cannot prove a layout
    (``from_local``) leave it ``None``.
    """

    def __init__(self, columns: Columns, counts,
                 partitioning: Partitioning = None, group=None):
        self.columns = dict(columns)
        dev = next(iter(self.columns.values())).device
        self.counts = torch.as_tensor(counts, dtype=torch.int32, device=dev)
        self.partitioning = partitioning
        self.group = group

    # -- properties ----------------------------------------------------------
    @property
    def n_local(self) -> int:
        """Shards whose blocks this table holds."""
        return self.counts.shape[0]

    @property
    def n_shards(self) -> int:
        """The global shard count."""
        return self.n_local * group_size(self.group)

    @property
    def capacity(self) -> int:
        return next(iter(self.columns.values())).shape[1]

    @property
    def column_names(self) -> Tuple[str, ...]:
        return tuple(sorted(self.columns))

    @property
    def device(self) -> torch.device:
        return self.counts.device

    def num_rows(self) -> torch.Tensor:
        """Valid rows of the whole table (a collective on a group)."""
        return self._every_count().sum()

    def _every_count(self) -> torch.Tensor:
        """Every shard's row count, in global shard order."""
        if self.group is None:
            return self.counts
        return spmd_allgather(list(self.counts.unbind(0)), tiled=False,
                              group=self.group)[0]

    def _every_block(self) -> Columns:
        """Every shard's column blocks, ``(n_shards, capacity, ...)``."""
        if self.group is None:
            return self.columns
        return {k: spmd_allgather(list(v.unbind(0)), tiled=False,
                                  group=self.group)[0]
                for k, v in self.columns.items()}

    # -- construction ----------------------------------------------------------
    @classmethod
    def from_local(cls, table: Table, ctx: HPTMTContext,
                   capacity: Optional[int] = None, *,
                   total_rows: Optional[int] = None,
                   first_row: int = 0) -> "DistTable":
        """Block-partition a local table's valid rows across shards.

        On a group each rank keeps the blocks of its own shards: it passes
        the whole table, or — with ``total_rows``, the whole table's row
        count — only rows ``first_row ..`` of it, which must cover the
        rows its shards hold."""
        p, nl, first = ctx.n_shards, ctx.n_local, ctx.local_shards.start
        dev = ctx.device
        if total_rows is None:
            n, whole = table.num_rows.to(dev, torch.int64), table.capacity
        else:
            n = torch.tensor(total_rows, dtype=torch.int64, device=dev)
            whole = total_rows
        per = (n + p - 1) // p  # rows per shard (last may be short)
        cap = capacity or -(-whole // p)
        # row r goes to shard r // per at slot r % per
        idx = torch.arange(nl * cap, dtype=torch.int64, device=dev)
        shard, slot = first + idx // cap, idx % cap
        src = shard * per + slot
        valid = (slot < per) & (src < n)
        src = torch.where(valid, src - first_row, 0)
        counts = n - torch.arange(first, first + nl, dtype=torch.int64,
                                  device=dev) * per
        cols = {}
        for k, v in table.columns.items():
            g = _pad_axis0(v.to(dev), max(v.shape[0], 1))[src]
            m = valid.reshape((-1,) + (1,) * (g.dim() - 1))
            cols[k] = torch.where(m, g, torch.zeros_like(g)).reshape(
                (nl, cap) + tuple(v.shape[1:]))
        counts = torch.minimum(torch.clamp(counts, min=0), per)
        counts = torch.clamp(counts, max=cap).to(torch.int32)
        return cls(cols, counts, group=ctx.group)

    @classmethod
    def from_shard_tables(cls, tables: Sequence[Table], ctx: HPTMTContext,
                          partitioning: Partitioning = None) -> "DistTable":
        """Assemble per-shard local tables into a DistTable.

        The inverse of :meth:`shard_table`: ``tables[i]`` becomes shard
        ``i``'s block (padded to the common capacity, the largest of all
        ``n_shards`` tables).  On the context's group ``tables`` still
        lists every shard, as :meth:`from_numpy_blocks` takes every
        shard's blocks, and each rank copies only its own shards' blocks.
        ``partitioning`` is attached verbatim, so callers assert the
        layout evidence truthfully.
        """
        if len(tables) != ctx.n_shards:
            raise ValueError(f"{len(tables)} shard tables for a "
                             f"{ctx.n_shards}-shard context")
        names = tables[0].column_names
        for i, t in enumerate(tables[1:], 1):
            if t.column_names != names:
                raise ValueError(f"shard {i} columns {t.column_names} != "
                                 f"shard 0 columns {names}")
        cap = max(t.capacity for t in tables)
        return cls.from_local_tables(
            [tables[s] for s in ctx.local_shards], ctx, cap, partitioning)

    @classmethod
    def from_local_tables(cls, tables: Sequence[Table], ctx: HPTMTContext,
                          capacity: int,
                          partitioning: Partitioning = None) -> "DistTable":
        """Stack the tables of the shards this process holds
        (``ctx.local_shards``, in order), each padded to ``capacity`` —
        which must be the same on every rank."""
        if len(tables) != ctx.n_local:
            raise ValueError(f"{len(tables)} tables for the {ctx.n_local} "
                             f"shards this process holds")
        cols = {k: torch.stack([_pad_axis0(t.columns[k].to(ctx.device),
                                           capacity) for t in tables])
                for k in tables[0].column_names}
        counts = torch.stack([torch.clamp(t.num_rows.to(ctx.device),
                                          max=capacity) for t in tables])
        return cls(cols, counts, partitioning, ctx.group)

    @classmethod
    def from_numpy_blocks(cls, columns: Dict[str, np.ndarray], counts,
                          partitioning: Partitioning = None,
                          device: DeviceLike = None,
                          ctx: Optional[HPTMTContext] = None) -> "DistTable":
        """Adopt a reference ``DistTable``'s arrays, given as numpy.

        ``columns[k]`` is the global ``(n_shards * capacity, ...)`` array;
        ``counts`` the per-shard row counts.  The partitioning metadata is
        taken verbatim, so a state that already proves co-location carries
        over.  With ``ctx`` the blocks go to its device, and on its group
        each rank copies only the blocks of its own shards.
        """
        counts = np.asarray(counts, np.int32)
        p = counts.shape[0]
        group, mine = None, slice(None)
        if ctx is not None:
            device, group = ctx.device, ctx.group
            mine = slice(ctx.local_shards.start, ctx.local_shards.stop)
        dev = resolve_device(device)
        cols = {}
        for k, v in columns.items():
            a = np.asarray(v)
            cols[k] = as_tensor(
                a.reshape((p, a.shape[0] // p) + a.shape[1:])[mine], dev)
        return cls(cols, torch.tensor(counts[mine], device=dev),
                   partitioning, group)

    def to_numpy_blocks(self) -> Tuple[Dict[str, np.ndarray], np.ndarray,
                                       Partitioning]:
        """Inverse of :meth:`from_numpy_blocks`: global column arrays,
        counts and partitioning (a collective on a group: every rank
        gets the whole table)."""
        p, c = self.n_shards, self.capacity
        cols = {k: v.reshape((p * c,) + tuple(v.shape[2:])).cpu().numpy()
                for k, v in self._every_block().items()}
        return cols, self._every_count().cpu().numpy(), self.partitioning

    # -- conversion ----------------------------------------------------------
    def shard_table(self, i: int) -> Table:
        return Table({k: v[i] for k, v in self.columns.items()},
                     self.counts[i])

    def shards(self) -> Tuple[list, list]:
        """Per-local-shard ``(columns, count)`` lists — the operators' loop
        form."""
        cols = [{k: v[i] for k, v in self.columns.items()}
                for i in range(self.n_local)]
        return cols, list(self.counts.unbind(0))

    @classmethod
    def from_shards(cls, cols: Sequence[Columns], counts: Sequence,
                    partitioning: Partitioning = None,
                    group=None) -> "DistTable":
        """Stack per-shard outputs of equal capacity (see :meth:`shards`)."""
        stacked = {k: torch.stack([c[k] for c in cols]) for k in cols[0]}
        return cls(stacked, torch.stack([torch.as_tensor(n).reshape(())
                                         for n in counts]), partitioning,
                   group)

    def valid_rows(self) -> Columns:
        """Every shard's valid rows, concatenated in shard order, on the
        table's device (a collective on a group: every rank gets them
        all)."""
        counts = self._every_count().tolist()
        return {name: torch.cat([v[i, :counts[i]]
                                 for i in range(self.n_shards)])
                for name, v in self._every_block().items()}

    def to_local(self) -> Table:
        """Gather all shards into one compacted local table."""
        cols = self.valid_rows()
        return Table.from_arrays(cols,
                                 num_rows=next(iter(cols.values())).shape[0],
                                 capacity=self.capacity * self.n_shards)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return {k: v.cpu().numpy() for k, v in self.valid_rows().items()}
