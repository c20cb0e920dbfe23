"""Wrappers of the CUDA segment-reduction kernels (``csrc/segment_reduce.cu``).

Replace the TPU kernels ``segment_reduce_fused_pallas`` and
``segment_reduce_pallas`` (``src/repro/kernels/segment_reduce/kernel.py``).
The TPU kernels reduce one-hot tiles on the MXU (O(N * S) work); here the
work is O(N), by one of two paths that the C entry points choose by byte
count: ``"smem"`` when one output lane of ``S`` float32 fits in a block's
shared memory (per-CTA partials with shared-memory atomics, one global
atomic an occupied entry at the end), else ``"direct"`` (one global atomic
per run of equal ids in a warp).  Both are memory-bound: values and ids
are read once, the output written once.  Float sums come out in another
order than the plain version's and agree to a tolerance; min/max are exact
— integer atomics on an order-preserving key, ``-0.0`` below ``+0.0``,
NaN winning (as the canonical quiet NaN).
"""
from __future__ import annotations

import torch

from ...core.array_ops import Counter
from .. import native

#: launches of the fused multi-lane sum kernel
FUSED_LAUNCHES = Counter()
#: launches of the one-lane sum/min/max kernel
LAUNCHES = Counter()
#: launches of each by the path the kernel took (``hptmt_segment_privatized``)
FUSED_PATH_LAUNCHES = {"smem": Counter(), "direct": Counter()}
PATH_LAUNCHES = {"smem": Counter(), "direct": Counter()}

_OPS = {"sum": (0, 0.0), "min": (1, float("inf")), "max": (2, float("-inf"))}


def _inputs(values: torch.Tensor, segment_ids: torch.Tensor, name: str):
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    values = native.require(values, "values", torch.float32, dev)
    seg = native.require(segment_ids, "segment_ids", torch.int32, dev)
    if seg.shape != values.shape[:1]:
        raise ValueError(f"segment_ids shape {tuple(seg.shape)} does not "
                         f"match values {tuple(values.shape)}")
    return dev, values, seg


def path(num_segments: int, lanes: int) -> str:
    """The path an ``(num_segments, lanes)`` reduction takes on the current
    device, as the C entry points choose it."""
    return ("smem" if native.library().hptmt_segment_privatized(
        num_segments, lanes) else "direct")


def segment_reduce_fused_cuda(values: torch.Tensor, segment_ids: torch.Tensor,
                              num_segments: int) -> torch.Tensor:
    """values ``(N, L)`` float32, ids ``(N,)`` int32 → ``(S, L)`` sums."""
    dev, values, seg = _inputs(values, segment_ids,
                               "segment_reduce_fused_cuda")
    n, lanes = values.shape
    out = torch.zeros((num_segments, lanes), dtype=torch.float32, device=dev)
    if n * lanes > 0 and num_segments > 0:
        err = native.library().hptmt_segment_sum_fused(
            values.data_ptr(), seg.data_ptr(), n, lanes, num_segments,
            out.data_ptr(), native.stream(dev))
        native.check("hptmt_segment_sum_fused", err)
        FUSED_LAUNCHES.add()
        FUSED_PATH_LAUNCHES[path(num_segments, lanes)].add()
    return out


def segment_reduce_cuda(values: torch.Tensor, segment_ids: torch.Tensor,
                        num_segments: int, op: str = "sum") -> torch.Tensor:
    """values ``(N,)`` float32, ids ``(N,)`` int32 → ``(S,)``."""
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}")
    dev, values, seg = _inputs(values, segment_ids, "segment_reduce_cuda")
    if values.dim() != 1:
        raise ValueError(f"values must be (N,), got {tuple(values.shape)}")
    code, init = _OPS[op]
    out = torch.full((num_segments,), init, dtype=torch.float32, device=dev)
    n = values.shape[0]
    if n > 0 and num_segments > 0:
        err = native.library().hptmt_segment_reduce(
            values.data_ptr(), seg.data_ptr(), n, num_segments, code,
            out.data_ptr(), native.stream(dev))
        native.check("hptmt_segment_reduce", err)
        LAUNCHES.add()
        PATH_LAUNCHES[path(num_segments, 1)].add()
    return out
