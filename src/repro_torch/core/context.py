"""HPTMT execution context for the PyTorch port.

The paper's principle (c) — *independence of the parallel execution
environment* — requires operators that never reach for global runtime
state.  Every operator takes an :class:`HPTMTContext` naming the shard
count, the device the shards live on and, optionally, the process group
they span.

``n_shards`` is always the GLOBAL shard count.  Without a group every
shard is virtual: a column block is ``(n_shards, capacity)`` on ONE
device, operators run their per-shard phases in a loop, and the
exchanges between phases go through one choke point
(``core/array_ops.py``).  With a ``torch.distributed`` group of ``world``
ranks, rank ``r`` holds the ``n_local = n_shards // world`` consecutive
shards ``r * n_local .. r * n_local + n_local - 1`` (:attr:`local_shards`)
as ``(n_local, capacity)`` blocks on its own device, and the same choke
point turns into collectives over the group.  The group travels as an
explicit argument from the context down to every collective; nothing
binds it at module level.

Entry points run on the card: ``device=None`` resolves to ``"cuda"`` (on
a group, the rank's current CUDA device, which its launcher set) and
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


def group_size(group) -> int:
    """Ranks in ``group`` (1 for ``None``: virtual shards)."""
    if group is None:
        return 1
    import torch.distributed as dist
    if not isinstance(group, dist.ProcessGroup):
        raise TypeError(f"group={group!r} is not a torch.distributed "
                        f"process group")
    return dist.get_world_size(group)


def group_rank(group) -> int:
    """This process's rank in ``group`` (0 for ``None``)."""
    if group is None:
        return 0
    import torch.distributed as dist
    return dist.get_rank(group)


@dataclasses.dataclass(frozen=True)
class HPTMTContext:
    """Shard count, device, and the process group the shards span.

    Attributes:
      n_shards: the global number of row partitions.
      device: where this process's column blocks live; ``None`` means the
        card (``cuda:<current device>`` on a group).
      group: a ``torch.distributed`` process group, or ``None`` for
        virtual shards on one device.
    """

    n_shards: int = 1
    device: DeviceLike = None
    group: Optional[object] = None

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"n_shards={self.n_shards} must be >= 1")
        if self.n_shards % self.world:
            raise ValueError(
                f"n_shards={self.n_shards} does not split over a group of "
                f"{self.world} ranks")
        dev = self.device
        if dev is None and self.group is not None:
            dev = "cuda"
            if torch.cuda.is_available():
                dev = f"cuda:{torch.cuda.current_device()}"
        object.__setattr__(self, "device", resolve_device(dev))

    @property
    def world(self) -> int:
        """Ranks the shards span (1 without a group)."""
        return group_size(self.group)

    @property
    def rank(self) -> int:
        """This process's rank (0 without a group)."""
        return group_rank(self.group)

    @property
    def n_local(self) -> int:
        """Shards this process holds."""
        return self.n_shards // self.world

    @property
    def local_shards(self) -> range:
        """Global ids of the shards this process holds."""
        return range(self.rank * self.n_local,
                     (self.rank + 1) * self.n_local)


def refuse_in_group(what: str, item: str) -> None:
    """For a service that takes no context: refuse to run inside a process
    group (one formed in this process, or one ``torchrun`` launched it
    into) until it runs across ranks."""
    import os

    import torch.distributed as dist
    if (dist.is_available() and dist.is_initialized()) or \
            int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(
            f"{what} does not run on a process group yet (ROADMAP Queue 1 "
            f"item {item}); run it in a single process")


def local_context(device: DeviceLike = None) -> HPTMTContext:
    """Single-shard context: operators degrade to local execution."""
    return HPTMTContext(n_shards=1, device=device)
