"""Native ``.hpt`` columnar container — pure numpy, zero dependencies.

Layout (DESIGN.md §5.2)::

    bytes [0, 4)     magic  b"HPT1"
    bytes [4, 8)     uint32 little-endian header length H
    bytes [8, 8+H)   JSON header:
        {"num_rows": int,
         "schema":  [{"name", "dtype", "trailing"}, ...],
         "stats":   {col: {"min": x, "max": x} | null, ...},
         "offsets": {col: [start, nbytes], ...}}
    bytes [8+H, …)   data region: per-column raw little-endian C-order
                     buffers of exactly ``num_rows`` valid rows

Only valid rows are written — the fixed-capacity padding of the in-memory
representation never touches disk; capacity is re-planned at scan time
from the recorded row counts.  ``stats`` holds per-column min/max over the
valid rows of 1-D numeric/bool columns (``null`` when the column has NaNs
or trailing dims), feeding predicate pushdown: a reader may skip the whole
file when the stats prove no row can satisfy the predicate.

Round trips are bit-exact for every supported dtype — including ``-0.0``,
``inf`` and ``nan`` payloads — because buffers are raw ``tobytes()`` dumps.
The container is the JAX package's byte for byte: a file either package
writes, the other reads back bit-exact.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .schema import Schema

MAGIC = b"HPT1"

Stats = Optional[Tuple[float, float]]


class CorruptFragmentError(ValueError):
    """A data fragment failed structural validation (truncation, CRC or
    byte-count mismatch, schema drift, undecodable pages).

    The base of the storage layer's corruption family — a ``ValueError``
    subclass, so the shared :class:`~repro_torch.resilience.FaultPolicy`
    classifies it FATAL: corruption is deterministic, a retry re-reads
    the same bad bytes.  The scan layer either surfaces it naming file +
    fragment (``on_error="raise"``) or skips and records the fragment
    (``on_error="quarantine"``).
    """


class HptIntegrityError(CorruptFragmentError):
    """A ``.hpt`` file is truncated or corrupted.

    Raised instead of decoding garbage when the container fails its
    structural checks (magic, header length, buffer extents) or a column
    buffer's recorded CRC32 does not match the bytes on disk.  The message
    names the file and the failing check; the usual causes are an
    interrupted copy or a torn spill run — delete the file and regenerate
    it (spill runs are recomputed from their source on retry).
    """


def column_stats(arr: np.ndarray) -> Stats:
    """Min/max of a 1-D numeric/bool column, or None when unusable.

    NaNs poison ordering comparisons, so any NaN disables the stats for
    the column (pushdown then cannot prune on it — conservative, never
    wrong).
    """
    if arr.ndim != 1 or arr.size == 0:
        return None
    if arr.dtype.kind == "f" and bool(np.isnan(arr).any()):
        return None
    if arr.dtype.kind == "b":
        return bool(arr.min()), bool(arr.max())
    if arr.dtype.kind == "f":
        return float(arr.min()), float(arr.max())
    return int(arr.min()), int(arr.max())


def write_hpt(path: str, cols: Dict[str, np.ndarray],
              num_rows: Optional[int] = None) -> dict:
    """Write valid rows of a column dict; returns the header written."""
    cols = {k: np.asarray(v) for k, v in cols.items()}
    schema = Schema.from_columns(cols)
    lengths = {k: v.shape[0] for k, v in cols.items()}
    if len(set(lengths.values())) > 1:
        raise ValueError(f"ragged column lengths: {sorted(lengths.items())}")
    n = next(iter(lengths.values()))
    if num_rows is None:
        num_rows = n
    if num_rows > n:
        raise ValueError(f"num_rows {num_rows} exceeds column length {n}")

    offsets, stats, crcs, bufs, pos = {}, {}, {}, [], 0
    for name in schema.names:
        valid = np.ascontiguousarray(cols[name][:num_rows])
        buf = valid.tobytes()
        offsets[name] = [pos, len(buf)]
        crcs[name] = zlib.crc32(buf) & 0xFFFFFFFF
        stats[name] = None
        s = column_stats(valid)
        if s is not None:
            stats[name] = {"min": s[0], "max": s[1]}
        bufs.append(buf)
        pos += len(buf)

    header = {"num_rows": int(num_rows), "schema": schema.to_json(),
              "stats": stats, "offsets": offsets, "crc32": crcs}
    hjson = json.dumps(header).encode()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(hjson)))
        f.write(hjson)
        for buf in bufs:
            f.write(buf)
    os.replace(tmp, path)  # readers never observe a half-written file
    return header


def read_hpt_header(path: str) -> dict:
    """Header only — the metadata a scan plans from, no data bytes read."""
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != MAGIC:
            raise HptIntegrityError(
                f"{path}: not an .hpt file or truncated before the magic "
                f"(read {magic!r}, want {MAGIC!r})")
        raw_len = f.read(4)
        if len(raw_len) < 4:
            raise HptIntegrityError(
                f"{path}: truncated inside the header-length field")
        (hlen,) = struct.unpack("<I", raw_len)
        hjson = f.read(hlen)
        if len(hjson) < hlen:
            raise HptIntegrityError(
                f"{path}: truncated inside the JSON header (have "
                f"{len(hjson)} of {hlen} bytes)")
        try:
            return json.loads(hjson.decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise HptIntegrityError(
                f"{path}: corrupted JSON header ({e})") from e


def read_hpt(path: str, columns: Optional[Sequence[str]] = None,
             ) -> Tuple[Dict[str, np.ndarray], int]:
    """Read (a projection of) an ``.hpt`` file → (columns, num_rows).

    Projection pushdown is physical: unprojected columns are never read
    from disk — the reader seeks straight to each requested buffer.
    """
    header = read_hpt_header(path)
    schema = Schema.from_json(header["schema"])
    n = header["num_rows"]
    names = list(columns) if columns is not None else list(schema.names)
    missing = [c for c in names if c not in schema]
    if missing:
        raise KeyError(f"{path}: columns {missing} not in schema "
                       f"{list(schema.names)}")
    crcs = header.get("crc32", {})  # absent in pre-checksum files
    with open(path, "rb") as f:
        f.seek(4)
        (hlen,) = struct.unpack("<I", f.read(4))
        data_start = 8 + hlen
        out: Dict[str, np.ndarray] = {}
        for name in names:
            field = schema[name]
            start, nbytes = header["offsets"][name]
            # eager consistency check BEFORE any byte is read: the header
            # row count must agree with the recorded buffer extent, else
            # the reshape below would surface a raw numpy error
            trail = 1
            for d in field.trailing:
                trail *= int(d)
            expected = int(n) * trail * field.np_dtype.itemsize
            if nbytes != expected:
                raise CorruptFragmentError(
                    f"{path}: column {name!r} is inconsistent — the "
                    f"header claims {n} rows ({expected} bytes of "
                    f"{field.np_dtype}{field.trailing or ''}) but records "
                    f"a {nbytes}-byte buffer; the header or data region "
                    f"was corrupted — regenerate the file")
            f.seek(data_start + start)
            raw = f.read(nbytes)
            if len(raw) < nbytes:
                raise HptIntegrityError(
                    f"{path}: column {name!r} truncated (have {len(raw)} "
                    f"of {nbytes} bytes) — the file was cut short while "
                    f"being written or copied")
            if name in crcs and (zlib.crc32(raw) & 0xFFFFFFFF) != crcs[name]:
                raise HptIntegrityError(
                    f"{path}: column {name!r} failed its CRC32 check — "
                    f"the data bytes do not match what the writer "
                    f"recorded; regenerate the file")
            arr = np.frombuffer(raw, dtype=field.np_dtype)
            out[name] = arr.reshape((n,) + field.trailing).copy()
    return out, n
