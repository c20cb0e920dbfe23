"""Fused single-collective row exchange (shuffle hot path, Fig 2).

Every distributed table operator (join, groupby, set ops, orderby)
reduces to the shuffle primitive: re-distributing rows so related keys
land on the same shard (paper §IV-B-1).  The port keeps the reference's three
optimisations (reference DESIGN.md §3):

  1. **Packed exchange** — every column is bit-cast to uint32 lanes and
     packed into one ``(n_shards * bucket, row_width)`` buffer per sender,
     with the per-destination send counts in a fused metadata row, so each
     shuffle is exactly ONE call of the exchange choke point
     (``array_ops.all_to_all``).
  2. **Sort-free bucketing** — destination slots come from a counting-sort
     scatter (per-destination prefix ranks plus the histogram the
     ``hash_partition`` kernel produces); compaction is a cumsum scatter.
  3. **Hash carrying** — the row hashes ``(h1, h2)`` computed for the
     destinations travel as hidden columns (:data:`H1_NAME` /
     :data:`H2_NAME`), so join and set-op kernels never rehash.

The range half (reference DESIGN.md §9) is the ordered twin: monotone
uint32 sort lanes (:func:`sort_key_lanes`), the one stable lexicographic
sort of the port (:func:`lex_order`, counted by ``array_ops.SORTS``), and
the sample-sort exchange :func:`range_shuffle`, which rides the same
single packed all-to-all.

A function that moves rows between shards takes one entry per shard —
per virtual shard, or per shard this rank holds when ``group=`` names a
process group (``core/context.py``) — and runs each shard's local phase
in a loop around the one collective.  Whether rows move is decided on
the GLOBAL shard count: a single-entry call without a group is the
reference's ``axis=None`` case — no exchange, the local buckets are the
result — while a rank of a group that holds one shard still exchanges.

uint32 lanes are held as int32 tensors with the same bits (``core/table.py``).
Overflow is counted and the excess rows dropped, never corrupted.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from .array_ops import SORTS, all_to_all, shard_span, spmd_allgather

Cols = Dict[str, torch.Tensor]

#: Reserved hidden-column names for carried row hashes.
H1_NAME = "_h1"
H2_NAME = "_h2"
#: Reserved for carried order lanes (used by the reference's spill engine).
LANES_NAME = "_lanes"


# ===========================================================================
# bit-exact uint32 packing
# ===========================================================================
@dataclasses.dataclass(frozen=True)
class ColSpec:
    """Static layout of one column inside the packed row."""
    name: str
    dtype: torch.dtype
    trailing: Tuple[int, ...]
    start: int
    lanes: int


def _col_to_u32(col: torch.Tensor) -> torch.Tensor:
    """Bit-exact reversible view of a column as ``(cap, lanes)`` uint32
    lanes (int32 bits)."""
    cap = col.shape[0]
    x = col.reshape(cap, -1).contiguous()
    size = x.dtype.itemsize
    if x.dtype == torch.bool:
        u = x.to(torch.int32)
    elif size == 4:
        u = x.view(torch.int32)
    elif size == 8:
        u = x.view(torch.int32)  # (cap, 2L), low word first
    elif size == 2:
        u = x.view(torch.int16).to(torch.int32) & 0xFFFF
    elif size == 1:
        u = x.view(torch.uint8).to(torch.int32)
    else:
        raise TypeError(f"unsupported column dtype {col.dtype}")
    return u.reshape(cap, -1)


def _u32_to_col(u: torch.Tensor, dtype: torch.dtype,
                trailing: Tuple[int, ...]) -> torch.Tensor:
    """Inverse of :func:`_col_to_u32`."""
    cap = u.shape[0]
    u = u.contiguous()
    if dtype == torch.bool:
        x = u != 0
    elif dtype.itemsize == 4:
        x = u.view(dtype)
    elif dtype.itemsize == 8:
        x = u.reshape(cap, -1, 2).contiguous().view(dtype)
    elif dtype.itemsize == 2:
        x = u.to(torch.int16).view(dtype)
    else:
        x = u.to(torch.uint8).view(dtype)
    return x.reshape((cap,) + tuple(trailing))


def pack_columns(cols: Cols) -> Tuple[torch.Tensor, Tuple[ColSpec, ...]]:
    """Pack all columns into one ``(cap, row_width)`` lane buffer."""
    parts, specs, start = [], [], 0
    for name in sorted(cols):
        u = _col_to_u32(cols[name])
        specs.append(ColSpec(name, cols[name].dtype,
                             tuple(cols[name].shape[1:]), start, u.shape[1]))
        start += u.shape[1]
        parts.append(u)
    return torch.cat(parts, dim=1), tuple(specs)


def unpack_columns(buf: torch.Tensor, specs: Sequence[ColSpec]) -> Cols:
    """Recover original dtypes/shapes from a packed lane buffer."""
    return {s.name: _u32_to_col(buf[:, s.start:s.start + s.lanes],
                                s.dtype, s.trailing) for s in specs}


# ===========================================================================
# sort-free primitives
# ===========================================================================
def dest_ranks(dest: torch.Tensor, n_parts: int) -> torch.Tensor:
    """Stable within-destination rank of each row (counting sort, no sort).

    ``rank[i]`` = number of earlier rows with the same destination.  Rows
    with ``dest >= n_parts`` (invalid) get rank 0 — callers mask them.
    One flat prefix sum per destination: O(n) memory, and each scan is a
    single device-wide scan (a prefix sum over a ``(parts, n)`` one-hot
    gives only ``parts`` rows of parallelism on CUDA).
    """
    rank = torch.zeros(dest.shape, dtype=torch.int32, device=dest.device)
    for p in range(n_parts):
        hit = dest == p
        rank = torch.where(hit, torch.cumsum(hit, 0, dtype=torch.int32) - 1,
                           rank)
    return rank


def _scatter_rows(src: torch.Tensor, slot: torch.Tensor,
                  size: int) -> torch.Tensor:
    """``zeros(size, ...)`` with ``out[slot[i]] = src[i]``; slots outside
    ``[0, size)`` are dropped (the reference's ``mode="drop"``).  Dropped
    rows are filtered out first rather than written to a spare row: on the
    card, millions of padding rows storing to one row contend."""
    out = torch.zeros((size,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    ok = (slot >= 0) & (slot < size)
    out[slot[ok].to(torch.int64)] = src[ok]
    return out


def compact_rows(cols: Cols, keep: torch.Tensor, out_capacity: int
                 ) -> Tuple[Cols, torch.Tensor, torch.Tensor]:
    """Move kept rows to the front (stable) via cumsum scatter; no sort.

    Returns ``(columns, new_count, n_truncated)`` — rows past
    ``out_capacity`` are dropped and counted.  Padding rows are zero-filled.
    """
    total = keep.sum(dtype=torch.int32)
    pos = torch.cumsum(keep, dim=0, dtype=torch.int32) - 1
    slot = torch.where(keep, pos, out_capacity)
    out = {k: _scatter_rows(v, slot, out_capacity) for k, v in cols.items()}
    new_count = torch.clamp(total, max=out_capacity)
    return out, new_count, total - new_count


def _histogram(dest: torch.Tensor, n_parts: int) -> torch.Tensor:
    """Per-destination count of valid rows (``dest < n_parts``): one
    reduction per destination (a scatter-add of every row into ``n_parts``
    counters contends on the card)."""
    return torch.stack([(dest == p).sum(dtype=torch.int32)
                        for p in range(n_parts)])


# ===========================================================================
# the packed single-collective exchange
# ===========================================================================
def exchange_rows(cols: Sequence[Cols], dest: Sequence[torch.Tensor],
                  n_shards: int, bucket: int,
                  hist: Optional[Sequence[torch.Tensor]] = None, *,
                  group=None):
    """Bucket each shard's rows by destination and exchange them in ONE
    all-to-all.

    ``cols[s]``/``dest[s]``/``hist[s]`` are shard ``s``'s columns, row
    destinations (``>= n_shards`` for invalid rows) and per-destination
    valid-row histogram (recomputed when not supplied).  With a single
    entry and no group nothing is exchanged: the local buckets come back.

    Frame layout: per destination, ``bucket`` packed data rows followed by
    one metadata row whose lane 0 holds the send count — so counts ride the
    same collective as the data.

    Returns ``(received_cols, received_valid_mask, n_overflowed_send)``,
    one entry per shard.
    """
    n_local = len(cols)
    n_global = shard_span(cols, group)[0]
    if n_global not in (1, n_shards):
        raise ValueError(f"{n_global} shard inputs for {n_shards} shards")
    frames, sent_all, overflow, specs = [], [], [], None
    for s in range(n_local):
        d = dest[s]
        h = hist[s] if hist is not None else _histogram(d, n_shards)
        packed, specs = pack_columns(cols[s])
        width = packed.shape[1]
        rank = dest_ranks(d, n_shards)
        ok = (d < n_shards) & (rank < bucket)
        slot = torch.where(ok, d.to(torch.int64) * bucket + rank,
                           n_shards * bucket)
        buf = _scatter_rows(packed, slot, n_shards * bucket)
        sent = torch.clamp(h, max=bucket)
        overflow.append((h - sent).sum(dtype=torch.int32))
        sent_all.append(sent)
        meta = torch.zeros((n_shards, 1, width), dtype=torch.int32,
                           device=buf.device)
        meta[:, 0, 0] = sent
        frames.append(torch.cat([buf.reshape(n_shards, bucket, width), meta],
                                dim=1))

    if n_global > 1:
        received = all_to_all(frames, group)
        recv_cnt = [r[:, bucket, 0] for r in received]
    else:
        received, recv_cnt = frames, sent_all

    out_cols, valid = [], []
    for r, cnt in zip(received, recv_cnt):
        buf = r[:, :bucket].reshape(n_shards * bucket, -1)
        pos = torch.arange(n_shards * bucket, device=buf.device)
        valid.append((pos % bucket) < cnt[pos // bucket])
        out_cols.append(unpack_columns(buf, specs))
    return out_cols, valid, overflow


def hash_shuffle(cols: Sequence[Cols], counts: Sequence[torch.Tensor],
                 key_names: Sequence[str], n_shards: int, bucket: int,
                 out_capacity: int, *, carry_hashes: bool = False,
                 group=None):
    """Hash-partition + packed exchange + compaction, over all shards.

    Destinations and the send histograms come from the ``hash_partition``
    kernel (plain version on the CPU).  With ``carry_hashes`` the row
    hashes travel as hidden :data:`H1_NAME` / :data:`H2_NAME` columns;
    pop them with :func:`take_hashes`.

    A completed call establishes the ``(key_names, n_shards)`` hash layout
    operators record as ``DistTable.partitioning``.

    Returns ``(columns, new_count, overflow)``, one entry per shard.
    """
    from ..kernels.hash_partition import ops as hpops  # lazy: no cycle

    sends, dests, hists = [], [], []
    for c, count in zip(cols, counts):
        capacity = next(iter(c.values())).shape[0]
        mask = torch.arange(capacity, device=count.device) < count
        key_cols = [c[k] for k in key_names]
        if carry_hashes:
            check_no_reserved(c)
            dest, hist, h1, h2 = hpops.hash_partition(
                key_cols, n_shards, mask, return_hashes=True)
            c = dict(c)
            c[H1_NAME], c[H2_NAME] = h1, h2
        else:
            dest, hist = hpops.hash_partition(key_cols, n_shards, mask)
        sends.append(c)
        dests.append(dest)
        hists.append(hist)
    bufs, valid, ov_send = exchange_rows(sends, dests, n_shards, bucket,
                                         hist=hists, group=group)
    out, new_counts, overflow = [], [], []
    for b, v, o in zip(bufs, valid, ov_send):
        cols_s, n, ov_recv = compact_rows(b, v, out_capacity)
        out.append(cols_s)
        new_counts.append(n)
        overflow.append(o + ov_recv)
    return out, new_counts, overflow


# ===========================================================================
# sample-sort range partitioning (reference DESIGN.md §9)
# ===========================================================================
_M32 = 0xFFFFFFFF
_SIGN = 0x80000000


def sort_key_lanes(col: torch.Tensor, ascending: bool = True) -> torch.Tensor:
    """Monotone ``(n, 1)`` view of a key column for ordering: uint32
    values held in int64 (torch on the CPU has no uint32 compare or sort).

    Unsigned comparison of the lanes reproduces the column's value order:

      * floats narrow to f32 and map through the total-order transform
        (sign bit set for non-negatives, full complement for negatives),
        so ``-inf < -0.0 < +0.0 < +inf`` — ±0.0 are two lane values;
      * signed integers flip their sign bit; unsigned/bool widen as-is;
      * ``ascending=False`` complements the lane, reversing the order.

    NaN-last contract: every NaN is forced to ``0xFFFFFFFF`` AFTER the
    direction flip, so NaNs form one block at the END of the order in
    both directions.  64-bit key dtypes are rejected, as in the reference.
    """
    if col.dtype.itemsize == 8:
        raise TypeError(
            f"orderby/range-partition key dtype {col.dtype} is 64-bit; "
            f"narrow the column to a 32-bit type first")
    if col.dim() > 1:
        raise TypeError("orderby/range-partition keys must be 1-D columns")
    nan = None
    if col.is_floating_point():
        f = col.to(torch.float32)
        b = f.contiguous().view(torch.int32).to(torch.int64) & _M32
        m = torch.where(b >= _SIGN, b ^ _M32, b | _SIGN)
        nan = torch.isnan(f)
    elif col.dtype == torch.bool or not col.is_signed():
        m = col.to(torch.int64)
    else:
        m = (col.to(torch.int32).to(torch.int64) & _M32) ^ _SIGN
    if not ascending:
        m = m ^ _M32
    if nan is not None:
        m = torch.where(nan, _M32, m)
    return m[:, None]


def order_lanes(cols: Cols, key_names: Sequence[str],
                ascending: Sequence[bool]) -> torch.Tensor:
    """Concatenated directional lanes for multi-key ordering: row ``i``
    sorts before row ``j`` iff ``lanes[i]`` is lexicographically below
    ``lanes[j]`` (lane 0 most significant)."""
    return torch.cat([sort_key_lanes(cols[k], asc)
                      for k, asc in zip(key_names, ascending)], dim=1)


def lex_order(keys, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic sort permutation; invalid rows last.

    ``keys`` is an ``(n, L)`` lane matrix (:func:`order_lanes`) or a
    sequence of 1-D key tensors, most significant first.  Equal keys keep
    their row order, so the permutation is ``jnp.lexsort``'s — stable
    sorts from the least significant key up.  ``mask=None`` sorts by the
    keys alone, for a caller whose keys already place invalid rows last.
    The port's one sort choke point: every call adds one to
    ``array_ops.SORTS``.
    """
    SORTS.add()
    keys = list(keys.unbind(1)) if isinstance(keys, torch.Tensor) \
        else list(keys)
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    steps = keys[::-1] + ([] if mask is None else [(~mask).to(torch.int8)])
    for key in steps:
        order = order[torch.argsort(key[order], stable=True)]
    return order


def _lex_leq(splitters: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """``(S, n)`` bool: splitter ``s`` <= row lexicographically."""
    res = torch.ones((splitters.shape[0], lanes.shape[0]), dtype=torch.bool,
                     device=lanes.device)
    for lane in range(lanes.shape[1] - 1, -1, -1):
        sp = splitters[:, lane][:, None]
        rw = lanes[:, lane][None, :]
        res = (sp < rw) | ((sp == rw) & res)
    return res


def range_splitters(lanes: Sequence[torch.Tensor],
                    masks: Sequence[torch.Tensor], n_shards: int,
                    n_samples: int, *, group=None) -> torch.Tensor:
    """Per-shard regular sampling + all-gather → ``n_shards - 1``
    splitters (``(n_shards - 1, L)`` lanes).

    Each shard samples ``n_samples`` valid rows at a regular stride
    (invalid samples pad with ``0xFFFFFFFF``), the shards pool their
    samples with one all-gather, sort them, and read the splitters at
    ``(arange(1, P) * total) // P`` — the reference's placement exactly.
    """
    samples = []
    for ln, mask in zip(lanes, masks):
        count = mask.sum(dtype=torch.int64)
        stride = torch.clamp(count // n_samples, min=1)
        sidx = torch.minimum(
            torch.arange(n_samples, device=ln.device) * stride,
            torch.clamp(count - 1, min=0))
        samples.append(torch.where((sidx < count)[:, None], ln[sidx], _M32))
    sample = spmd_allgather(samples, group=group)[0]
    sample = sample[lex_order(sample, None)]
    total = sample.shape[0]
    spos = (torch.arange(1, n_shards, device=sample.device) * total) \
        // n_shards
    return sample[spos]


def range_shuffle(cols: Sequence[Cols], counts: Sequence[torch.Tensor],
                  key_names: Sequence[str], ascending: Sequence[bool],
                  n_shards: int, bucket: int, out_capacity: int, *,
                  n_samples: int = 64, sort_local: bool = True,
                  group=None):
    """Sample-sort range partitioning + packed exchange (+ local sort).

    Destinations come from a lexicographic compare against sampled
    splitters instead of a hash, and the rows ride the same single packed
    all-to-all as :func:`hash_shuffle`.  A row goes to
    ``#{splitters <= row}`` (side "right"), so rows with equal full keys
    share a shard.  With ``sort_local`` the received rows are lexsorted:
    the result is globally ordered by ``(key_names, ascending)``, NaNs
    last — the layout operators record as
    ``("range", keys, ascending, n_shards)``.

    Returns ``(columns, new_count, overflow)``, one entry per shard.
    """
    masks = [torch.arange(next(iter(c.values())).shape[0],
                          device=n.device) < n for c, n in zip(cols, counts)]
    lanes = [order_lanes(c, key_names, ascending) for c in cols]
    if n_shards > 1:
        splitters = range_splitters(lanes, masks, n_shards, n_samples,
                                    group=group)
        dests = [torch.where(m, _lex_leq(splitters, ln).sum(0), n_shards)
                 for ln, m in zip(lanes, masks)]
        bufs, valid, ov_send = exchange_rows(cols, dests, n_shards, bucket,
                                             group=group)
        out, new_counts, overflow = [], [], []
        for b, v, o in zip(bufs, valid, ov_send):
            c, n, o2 = compact_rows(b, v, out_capacity)
            out.append(c)
            new_counts.append(n)
            overflow.append(o + o2)
    else:
        c, n, o = compact_rows(cols[0], masks[0], out_capacity)
        out, new_counts, overflow = [c], [n], [o]
    if sort_local:
        for i, (c, n) in enumerate(zip(out, new_counts)):
            m = torch.arange(out_capacity, device=n.device) < n
            order = lex_order(order_lanes(c, key_names, ascending), m)
            out[i] = {k: v[order] for k, v in c.items()}
    return out, new_counts, overflow


def key_compare_u32(cols: Cols, key_names: Sequence[str]) -> torch.Tensor:
    """Bitwise key-comparison lanes, consistent with the hash identity.

    The ``(N, L)`` lane matrix the hash-join / set-op kernels verify
    candidates against: float keys narrow to float32 and compare by bit
    pattern — the identity ``hash_columns`` uses, so NaN keys with equal
    bits are equal and ``-0.0 != +0.0`` — while integer/bool keys compare
    by their packed two's-complement lanes.
    """
    parts = []
    for name in key_names:
        col = cols[name]
        if col.is_floating_point():
            col = col.to(torch.float32).contiguous().view(torch.int32)
        parts.append(_col_to_u32(col))
    return torch.cat(parts, dim=1)


def check_no_reserved(names: Sequence[str]) -> None:
    """Reject user tables that use the reserved hidden-column names."""
    clash = {H1_NAME, H2_NAME, LANES_NAME} & set(names)
    if clash:
        raise ValueError(
            f"column names {sorted(clash)} are reserved for carried row "
            f"hashes / order lanes (core/exchange.py); rename the column(s)")


def take_hashes(cols: Cols, key_names: Sequence[str]
                ) -> Tuple[Cols, torch.Tensor, torch.Tensor]:
    """Pop carried ``(h1, h2)`` from a shuffled table, or compute them."""
    from .table import hash_columns  # lazy: table does not import exchange

    cols = dict(cols)
    if H1_NAME in cols:
        return cols, cols.pop(H1_NAME), cols.pop(H2_NAME)
    h1, h2 = hash_columns([cols[k] for k in key_names])
    return cols, h1, h2


def strip_hidden(cols: Cols) -> Cols:
    """Drop carried-hash columns before handing a table back to the user."""
    return {k: v for k, v in cols.items()
            if k not in (H1_NAME, H2_NAME, LANES_NAME)}


# ===========================================================================
# seed reference implementation (oracle for parity tests)
# ===========================================================================
def exchange_rows_reference(cols: Sequence[Cols],
                            dest: Sequence[torch.Tensor], n_shards: int,
                            bucket: int, *, group=None):
    """The per-column argsort exchange, kept as a test oracle.

    One all-to-all per column plus a count side-channel; bucketing via
    stable ``argsort``.  Bit-for-bit equal *valid rows* to
    :func:`exchange_rows` (padding differs).  Returns
    ``(bufs, valid, overflow)``, one entry per shard.
    """
    n_local = len(cols)
    n_global = shard_span(cols, group)[0]
    sends, sent_all, overflow = [], [], []
    for c, d in zip(cols, dest):
        capacity = d.shape[0]
        d = d.to(torch.int64)
        order = torch.argsort(d, stable=True)
        sdest = d[order]
        first = torch.searchsorted(sdest, sdest, side="left")
        rank = torch.arange(capacity, device=d.device) - first
        ok = (sdest < n_shards) & (rank < bucket)
        slot = torch.where(ok, sdest * bucket + rank, n_shards * bucket)
        send_cnt = _histogram(d, n_shards)
        sent = torch.clamp(send_cnt, max=bucket)
        overflow.append((send_cnt - sent).sum(dtype=torch.int32))
        sent_all.append(sent)
        sends.append({k: _scatter_rows(v[order], slot, n_shards * bucket)
                      for k, v in c.items()})

    if n_global > 1:
        recv_cnt = all_to_all(sent_all, group)
        per_col = {k: all_to_all([s[k].reshape((n_shards, bucket)
                                               + tuple(s[k].shape[1:]))
                                  for s in sends], group)
                   for k in sends[0]}
        bufs = [{k: per_col[k][r].reshape((n_shards * bucket,)
                                          + tuple(per_col[k][r].shape[2:]))
                 for k in per_col} for r in range(n_local)]
    else:
        recv_cnt, bufs = sent_all, sends

    valid = []
    for cnt in recv_cnt:
        pos = torch.arange(n_shards * bucket, device=cnt.device)
        valid.append((pos % bucket) < cnt[pos // bucket])
    return bufs, valid, overflow
