"""Wrapper of the CUDA hash-partition kernel (``csrc/hash_partition.cu``).

Replaces the TPU kernel ``hash_partition_pallas``
(``src/repro/kernels/hash_partition/kernel.py``).  The kernel is
memory-bound — K key lanes and a valid byte in, a destination and
optionally two hashes out per row — and counts the histogram per block
in shared memory before one flush of integer atomics (see the source).
"""
from __future__ import annotations

import torch

from ...core.array_ops import Counter
from .. import native

#: launches of the kernel
LAUNCHES = Counter()

#: the per-block shared-memory histogram holds at most this many counters
MAX_PARTS = 12 * 1024


def hash_partition_cuda(keys_u32: torch.Tensor, valid: torch.Tensor,
                        n_parts: int, return_hashes: bool = False):
    """keys_u32 ``(N, K)`` int32 lanes, valid ``(N,)`` bool on the card →
    ``(dest, hist)`` or ``(dest, hist, h1, h2)`` as in ``ref.py``."""
    dev = keys_u32.device
    if dev.type != "cuda":
        raise ValueError(f"hash_partition_cuda needs CUDA tensors, got {dev}")
    if keys_u32.dim() != 2:
        raise ValueError(f"keys_u32 must be (N, K), got {tuple(keys_u32.shape)}")
    if not 1 <= n_parts <= MAX_PARTS:
        raise ValueError(f"n_parts={n_parts} outside [1, {MAX_PARTS}]")
    keys = native.require(keys_u32, "keys_u32", torch.int32, dev)
    valid = native.require(valid, "valid", torch.bool, dev)
    n, k = keys.shape
    if valid.shape != (n,):
        raise ValueError(f"valid shape {tuple(valid.shape)} != ({n},)")
    dest = torch.empty(n, dtype=torch.int32, device=dev)
    hist = torch.zeros(n_parts, dtype=torch.int32, device=dev)
    h1 = torch.empty(n, dtype=torch.int32, device=dev) if return_hashes else None
    h2 = torch.empty(n, dtype=torch.int32, device=dev) if return_hashes else None
    if n > 0:
        err = native.library().hptmt_hash_partition(
            keys.data_ptr(), n, k, valid.data_ptr(), n_parts,
            dest.data_ptr(), hist.data_ptr(), native.ptr(h1),
            native.ptr(h2), native.stream(dev))
        native.check("hptmt_hash_partition", err)
        LAUNCHES.add()
    if return_hashes:
        return dest, hist, h1, h2
    return dest, hist
