"""Host-side (numpy) mirrors of the port's hash and order-lane transforms.

The spill engine partitions rows **on the host**: run files are cut from
numpy buffers without a round trip through the card.  For the
re-ingested partitions to re-enter the partitioned world truthfully —
``shard = h1 % n_shards`` must hold for every row the engine places on
shard ``s`` — the host partitioner has to compute *bit-identical* hashes
to ``core.table.hash_columns`` and *bit-identical* directional lanes to
``core.exchange.sort_key_lanes``.  The port's device hash holds uint32
values in int64 (``core/table.py``); these twins work in ``uint32``.
Both are held to each other and to the JAX package's hash in
``tests/test_torch_spill.py``; any drift there silently breaks the
shuffle-elision contract, so the constants are imported from the port's
``core.table`` rather than re-declared.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core.table import _H1_INIT, _H2_INIT, _K2_XOR, _MUL1, _MUL2


def np_as_u32(col: np.ndarray) -> np.ndarray:
    """Numpy twin of ``core.table._as_u32`` (bit-stable 32-bit view)."""
    col = np.asarray(col)
    if col.dtype == np.bool_:
        return col.astype(np.uint32)
    if np.issubdtype(col.dtype, np.floating):
        return col.astype(np.float32).view(np.uint32)
    return col.astype(np.uint32)


def _np_mix(h: np.ndarray, k: np.ndarray, mul: int) -> np.ndarray:
    k = k * np.uint32(mul)
    k = (k << np.uint32(15)) | (k >> np.uint32(17))
    h = h ^ k
    h = (h << np.uint32(13)) | (h >> np.uint32(19))
    return h * np.uint32(5) + np.uint32(0xE6546B64)


def np_hash_columns(cols: Sequence[np.ndarray]
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy twin of ``core.table.hash_columns``: ``(h1, h2)`` as uint32,
    the same bits as the device hash's int32 tensors."""
    n = np.asarray(cols[0]).shape[0]
    h1 = np.full((n,), _H1_INIT, dtype=np.uint32)
    h2 = np.full((n,), _H2_INIT, dtype=np.uint32)
    with np.errstate(over="ignore"):
        for c in cols:
            k = np_as_u32(c)
            h1 = _np_mix(h1, k, _MUL1)
            h2 = _np_mix(h2, k ^ np.uint32(_K2_XOR), _MUL2)
    h1 = h1 ^ (h1 >> np.uint32(16))
    h2 = h2 ^ (h2 >> np.uint32(16))
    return h1, h2


def np_sort_key_lanes(col: np.ndarray, ascending: bool = True) -> np.ndarray:
    """Numpy twin of ``core.exchange.sort_key_lanes`` (NaN-last contract),
    as ``(n, 1)`` uint32."""
    col = np.asarray(col)
    if col.dtype.itemsize == 8:
        raise TypeError(
            f"orderby/range-partition key dtype {col.dtype} is 64-bit; "
            f"narrow the column to a 32-bit type first")
    if col.ndim > 1:
        raise TypeError("orderby/range-partition keys must be 1-D columns")
    if np.issubdtype(col.dtype, np.floating):
        f = col.astype(np.float32)
        b = f.view(np.uint32)
        m = np.where(b >> np.uint32(31) != 0, ~b, b | np.uint32(0x80000000))
        nan = np.isnan(f)
    elif col.dtype == np.bool_:
        m = col.astype(np.uint32)
        nan = None
    elif np.issubdtype(col.dtype, np.unsignedinteger):
        m = col.astype(np.uint32)
        nan = None
    else:  # signed integers
        m = col.astype(np.int32).view(np.uint32) ^ np.uint32(0x80000000)
        nan = None
    if not ascending:
        m = ~m
    if nan is not None:
        m = np.where(nan, np.uint32(0xFFFFFFFF), m)
    return m[:, None]


def np_order_lanes(cols: Dict[str, np.ndarray], key_names: Sequence[str],
                   ascending: Sequence[bool]) -> np.ndarray:
    """Numpy twin of ``core.exchange.order_lanes`` (lane 0 most significant)."""
    return np.concatenate(
        [np_sort_key_lanes(cols[k], asc)
         for k, asc in zip(key_names, ascending)], axis=1)


def np_lex_order(lanes: np.ndarray) -> np.ndarray:
    """Stable sort permutation for directional lanes (all rows valid)."""
    keys: List[np.ndarray] = [lanes[:, lane]
                              for lane in range(lanes.shape[1] - 1, -1, -1)]
    return np.lexsort(tuple(keys))
