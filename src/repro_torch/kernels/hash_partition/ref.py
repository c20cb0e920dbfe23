"""Plain PyTorch version of the shuffle hash-partition (paper Fig 2 hot loop).

The murmur chain runs in int64 with a ``& 0xFFFFFFFF`` after every
multiply, add and shift (``core/table.py``), since PyTorch on the CPU has
no uint32 arithmetic.
"""
from __future__ import annotations

import torch

from ...core.exchange import _histogram
from ...core.table import hash_lanes, i32


def hash_partition_lanes(keys_u32: torch.Tensor, valid: torch.Tensor,
                         n_parts: int, return_hashes: bool = False):
    """keys_u32 ``(N, K)`` int32 lanes, valid ``(N,)`` bool →
    ``(dest (N,) int32 with invalid rows = n_parts, hist (n_parts,) int32)``
    plus ``(h1, h2)`` (int32 bits) when ``return_hashes``."""
    h1, h2 = hash_lanes(list(keys_u32.unbind(1)))
    dest = torch.where(valid, h1 % n_parts, n_parts).to(torch.int32)
    hist = _histogram(dest, n_parts)
    if return_hashes:
        return dest, hist, i32(h1), i32(h2)
    return dest, hist
