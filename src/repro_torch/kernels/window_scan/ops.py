"""Public entry points of the windowed-scan engine.

A CUDA tensor runs the hand-written kernel, a CPU tensor the plain
version (``ref.py``); nothing falls back from one to the other, and every
window size takes the same route.  The expanding (cumulative) scan
:func:`segmented_cumulative` is plain PyTorch on every device, as it is a
jnp function in the reference.

``windowed_scan`` accepts ``(n,)`` or ``(n, L)`` values; all sum lanes of
one window call ride a single ``(n, L)`` call, min/max one lane each.
"""
from __future__ import annotations

import torch

from .. import native
from . import kernel as _kernel
from . import ref as _ref

segmented_cumulative = _ref.segmented_cumulative

_OPS = ("sum", "min", "max")


def windowed_scan(values: torch.Tensor, seg_start: torch.Tensor, window: int,
                  op: str = "sum") -> torch.Tensor:
    """Rolling segment-clipped reduction, ``out[i] = op(values[max(i -
    window + 1, seg_start[i]) .. i])``; see ``ref.windowed_scan``."""
    if op not in _OPS:
        raise ValueError(f"unknown windowed_scan op {op!r}; expected "
                         f"one of {_OPS}")
    squeeze = values.dim() == 1
    v = (values[:, None] if squeeze else values).to(torch.float32)
    if native.on_cuda(v):
        out = _kernel.windowed_scan_cuda(v, seg_start.to(torch.int32),
                                         window, op)
    else:
        out = _ref.windowed_scan(v, seg_start, window, op)
    return out[:, 0] if squeeze else out
