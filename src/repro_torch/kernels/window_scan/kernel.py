"""Wrapper of the CUDA windowed-scan kernel (``csrc/window_scan.cu``).

Replaces the TPU kernel ``windowed_scan_pallas``
(``src/repro/kernels/window_scan/kernel.py``).  The TPU kernel loads each
block and its predecessor into VMEM and caps the window at a VMEM budget
(``_PALLAS_MAX_WINDOW``); here every window size is accepted.  Windows up
to the 4096-row tile run one fused pass that reads values and segment
starts once and writes the output once (a warp's shuffles for w <= 32, a
CTA's shared memory above), recomputing the previous chunk's suffixes
instead of storing them; their sums are bit-identical to the plain
version (the same ladder).  Wider windows carry between tiles through
scratch and add in another order, agreeing to a tolerance.  min and max
are exact and propagate NaN.  Values are read through their row stride,
so a column slice of a wider table (the window engine's views) goes in
without a copy.
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


def _rows(values: torch.Tensor):
    """``(tensor, row stride)`` the kernel reads: lanes adjacent, rows any
    non-negative stride apart; another layout is copied."""
    n, lanes = values.shape
    if lanes == 1 or values.stride(1) == 1:
        return values, values.stride(0)
    return values.contiguous(), lanes


def windowed_scan_cuda(values: torch.Tensor, seg_start: torch.Tensor,
                       window: int, op: str = "sum") -> torch.Tensor:
    """values ``(n, L)`` float32, seg_start ``(n,)`` int32 → ``(n, L)``;
    see ``ref.windowed_scan``."""
    if op not in _OPS:
        raise ValueError(f"unknown windowed_scan op {op!r}")
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"windowed_scan_cuda needs CUDA tensors, got {dev}")
    if values.dtype != torch.float32:
        raise TypeError(f"values has dtype {values.dtype}, expected "
                        "torch.float32")
    seg = native.require(seg_start, "seg_start", torch.int32, dev)
    if values.dim() != 2 or seg.shape != values.shape[:1]:
        raise ValueError(f"values {tuple(values.shape)} must be (n, L) and "
                         f"seg_start {tuple(seg.shape)} (n,)")
    w = int(window)
    if w < 1:
        raise ValueError(f"window={w} must be >= 1")
    n, lanes = values.shape
    out = torch.empty((n, lanes), dtype=torch.float32, device=dev)
    if n == 0 or lanes == 0:
        return out
    values, ld = _rows(values)
    scratch = [None] * 4
    if w > TILE:  # pre, suf and the two carries of the three-pass path
        carries = -(-n // w) * -(-w // TILE)
        buf = torch.empty(2 * n * lanes + 2 * carries * lanes,
                          dtype=torch.float32, device=dev)
        scratch = buf.split([n * lanes, n * lanes, carries * lanes,
                             carries * lanes])
    err = native.library().hptmt_windowed_scan(
        values.data_ptr(), ld, seg.data_ptr(), n, lanes, w, _OPS[op], TILE,
        *(native.ptr(t) for t in scratch), out.data_ptr(),
        native.stream(dev))
    native.check("hptmt_windowed_scan", err)
    LAUNCHES.add()
    return out
