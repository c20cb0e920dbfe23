"""Wrapper of the CUDA windowed-scan kernel (``csrc/window_scan.cu``).

Replaces the TPU kernel ``windowed_scan_pallas``
(``src/repro/kernels/window_scan/kernel.py``).  The TPU kernel loads each
block and its predecessor into VMEM and caps the window at a VMEM budget
(``_PALLAS_MAX_WINDOW``); here one CTA scans a 4096-row tile in shared
memory, windows wider than a tile carry between tiles, and every window
size is accepted.  For windows up to the tile the sums are bit-identical
to the plain version (the same ladder); wider windows add in another
order and agree to a tolerance.  min and max are exact and propagate NaN.
"""
from __future__ import annotations

import torch

from ...core.array_ops import Counter
from .. import native

#: launches of the windowed-scan kernel
LAUNCHES = Counter()

#: rows of one CTA's tile; must equal ``kTile`` in ``csrc/window_scan.cu``
TILE = 4096

_OPS = {"sum": 0, "min": 1, "max": 2}


def windowed_scan_cuda(values: torch.Tensor, seg_start: torch.Tensor,
                       window: int, op: str = "sum") -> torch.Tensor:
    """values ``(n, L)`` float32, seg_start ``(n,)`` int32 → ``(n, L)``;
    see ``ref.windowed_scan``."""
    if op not in _OPS:
        raise ValueError(f"unknown windowed_scan op {op!r}")
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"windowed_scan_cuda needs CUDA tensors, got {dev}")
    values = native.require(values, "values", torch.float32, dev)
    seg = native.require(seg_start, "seg_start", torch.int32, dev)
    if values.dim() != 2 or seg.shape != values.shape[:1]:
        raise ValueError(f"values {tuple(values.shape)} must be (n, L) and "
                         f"seg_start {tuple(seg.shape)} (n,)")
    w = int(window)
    if w < 1:
        raise ValueError(f"window={w} must be >= 1")
    n, lanes = values.shape
    out = torch.empty_like(values)
    if n == 0 or lanes == 0:
        return out
    pre, suf = torch.empty_like(values), torch.empty_like(values)
    k_tiles = -(-w // TILE) if w > TILE else 0
    carry = torch.empty((2, -(-n // w) * k_tiles, lanes), dtype=torch.float32,
                        device=dev)
    err = native.library().hptmt_windowed_scan(
        values.data_ptr(), seg.data_ptr(), n, lanes, w, _OPS[op], TILE,
        pre.data_ptr(), suf.data_ptr(), carry[0].data_ptr(),
        carry[1].data_ptr(), out.data_ptr(), native.stream(dev))
    native.check("hptmt_windowed_scan", err)
    LAUNCHES.add()
    return out
