"""Public entry points for segment reduction.

A CUDA tensor runs the hand-written kernel, a CPU tensor the plain
version (``ref.py``); nothing falls back from one to the other.
"""
from __future__ import annotations

import torch

from .. import native
from . import kernel as _kernel
from . import ref as _ref


def segment_reduce(values: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int, op: str = "sum") -> torch.Tensor:
    """One-lane segment ``sum``/``min``/``max``; ids outside
    ``[0, num_segments)`` are dropped."""
    if native.on_cuda(values):
        return _kernel.segment_reduce_cuda(values, segment_ids, num_segments,
                                           op)
    return _ref.segment_reduce(values, segment_ids, num_segments, op)


def segment_reduce_fused(values: torch.Tensor, segment_ids: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """Sum-reduce ``(N, L)`` value lanes by segment in one pass.

    The GroupBy fast path: every sum-combining aggregate (sum, count, the
    sum/count halves of mean) rides one reduction instead of one per
    column.
    """
    if native.on_cuda(values):
        return _kernel.segment_reduce_fused_cuda(values, segment_ids,
                                                 num_segments)
    return _ref.segment_reduce_fused(values, segment_ids, num_segments)
