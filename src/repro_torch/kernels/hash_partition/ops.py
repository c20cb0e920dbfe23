"""Public entry point for hash-partitioning (shuffle destination compute).

The single hash site of the shuffle engine (``core/exchange.py``): a CUDA
tensor runs the hand-written kernel, a CPU tensor the plain version.  With
``return_hashes`` it also hands back ``(h1, h2)`` so the exchange can
carry them and downstream operators never rehash.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ...core.table import _as_u32
from .. import native
from . import kernel as _kernel
from . import ref as _ref


def hash_partition(key_cols: Sequence[torch.Tensor], n_parts: int,
                   valid: torch.Tensor, return_hashes: bool = False):
    """Row destinations + histogram (+ row hashes when ``return_hashes``).

    Returns ``(dest, hist)`` or ``(dest, hist, h1, h2)``; hashes are int32
    tensors holding the uint32 bits.
    """
    keys = torch.stack([_as_u32(c) for c in key_cols], dim=1)
    if native.on_cuda(keys):
        return _kernel.hash_partition_cuda(keys, valid, n_parts,
                                           return_hashes=return_hashes)
    return _ref.hash_partition_lanes(keys, valid, n_parts,
                                     return_hashes=return_hashes)
