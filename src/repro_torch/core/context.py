"""HPTMT execution context for the PyTorch port.

The paper's principle (c) — *independence of the parallel execution
environment* — requires operators that never reach for global runtime
state.  Every operator takes an :class:`HPTMTContext` naming the shard
count and the device the shards live on.

In this port ``n_shards`` virtual shards are a leading dimension of every
column block on ONE device: a table is ``(n_shards, capacity)`` per
column, operators run their per-shard phases in a loop, and the exchanges
between phases go through one choke point (``core/array_ops.py``).  A
``torch.distributed`` group spanning several cards is a later step; the
``group`` field is reserved for it and must stay ``None``.

Entry points run on the card: ``device=None`` resolves to ``"cuda"`` and
raises when no CUDA device exists.  The CPU runs only when the caller
asks for it with ``device="cpu"`` — no code path drops to the CPU on its
own.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → the CUDA card; a CUDA request without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "operators on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class HPTMTContext:
    """Shard count, device, and (reserved) process group.

    Attributes:
      n_shards: number of row partitions (virtual shards on one device).
      device: where every column block lives; ``None`` means the card.
      group: a ``torch.distributed`` group across cards — not supported
        yet, must be ``None``.
    """

    n_shards: int = 1
    device: DeviceLike = None
    group: Optional[object] = None

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"n_shards={self.n_shards} must be >= 1")
        if self.group is not None:
            raise NotImplementedError(
                "process groups across cards are not ported yet; shards are "
                "virtual on one device")
        object.__setattr__(self, "device", resolve_device(self.device))


def local_context(device: DeviceLike = None) -> HPTMTContext:
    """Single-shard context: operators degrade to local execution."""
    return HPTMTContext(n_shards=1, device=device)
