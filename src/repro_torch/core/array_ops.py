"""Shard-axis collectives — the subset of paper Table I the table path needs.

Shards are virtual: ``n_shards`` blocks on one device, stacked along a
leading shard axis.  A collective is therefore a tensor reshuffle along
that axis:

  * :func:`all_to_all` — shard ``s`` sends ``frames[s, d]`` to shard ``d``:
    the transpose of the ``(P, P, ...)`` send frames;
  * :func:`allreduce` — a sum over the shard axis.

:func:`all_to_all` is the ONE exchange choke point of the port: every row
exchange goes through it, and :data:`EXCHANGES` counts its calls.  The
count stands in for the reference tests' jaxpr ``all_to_all`` count, so
the shuffle-elision contracts (DESIGN.md §4) are asserted on it.
"""
from __future__ import annotations

from typing import Sequence

import torch


class Counter:
    """A plain call counter (reset to 0 before a run, read after)."""

    def __init__(self):
        self.n = 0

    def add(self) -> None:
        self.n += 1

    def reset(self) -> None:
        self.n = 0


#: calls of :func:`all_to_all` — one per shuffle
EXCHANGES = Counter()


def all_to_all(frames: Sequence[torch.Tensor]) -> list:
    """``frames[s]`` is shard ``s``'s ``(P, ...)`` send frame, block ``d``
    bound for shard ``d``; returns the ``(P, ...)`` frame each shard
    receives, block ``s`` from sender ``s``."""
    EXCHANGES.add()
    return list(torch.stack(list(frames)).transpose(0, 1).unbind(0))


def allreduce(values: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of one scalar per shard (the overflow counts' allreduce)."""
    return sum(values[1:], values[0])
