"""Shard-axis collectives — the subset of paper Table I the table path needs.

Shards are virtual: ``n_shards`` blocks on one device, stacked along a
leading shard axis.  A collective is therefore a tensor reshuffle along
that axis:

  * :func:`all_to_all` — shard ``s`` sends ``frames[s, d]`` to shard ``d``:
    the transpose of the ``(P, P, ...)`` send frames;
  * :func:`allreduce` — a sum over the shard axis;
  * :func:`allgather` — every shard's value, stacked along a new leading
    shard axis (the window engine's per-shard summaries, the range
    exchange's splitter samples);
  * :func:`ppermute` — shard blocks shifted along a permutation (the
    window halo, the top-k tree reduce).

:func:`all_to_all` is the ONE exchange choke point of the port: every row
exchange goes through it, and :data:`EXCHANGES` counts its calls.  The
count stands in for the reference tests' jaxpr ``all_to_all`` count, so
the shuffle-elision contracts (DESIGN.md §4) are asserted on it.
:func:`allgather` and :func:`ppermute` move small per-shard state, not
rows of a table, and do not count as exchanges.

:data:`SORTS` counts the port's stable lexicographic sorts
(``core/exchange.py:lex_order``, the one sort choke point); it stands in
for the reference tests' jaxpr ``"sort["`` check of the ordered
operators (DESIGN.md §9: a window on a range layout sorts nothing).
"""
from __future__ import annotations

from typing import Sequence

import torch


class Counter:
    """A plain call counter (reset to 0 before a run, read after).

    ``log``, when a list, also receives each counted exchange's payload
    bytes (``telemetry.audit.exchange_log`` sets it; ``None`` — the
    default — keeps the count the only cost)."""

    def __init__(self):
        self.n = 0
        self.log = None

    def add(self) -> None:
        self.n += 1

    def reset(self) -> None:
        self.n = 0


#: calls of :func:`all_to_all` — one per shuffle
EXCHANGES = Counter()
#: calls of ``exchange.lex_order`` — one per stable lexicographic sort
SORTS = Counter()


def all_to_all(frames: Sequence[torch.Tensor]) -> list:
    """``frames[s]`` is shard ``s``'s ``(P, ...)`` send frame, block ``d``
    bound for shard ``d``; returns the ``(P, ...)`` frame each shard
    receives, block ``s`` from sender ``s``."""
    EXCHANGES.add()
    if EXCHANGES.log is not None:
        EXCHANGES.log.append(sum(f.numel() * f.element_size()
                                 for f in frames))
    return list(torch.stack(list(frames)).transpose(0, 1).unbind(0))


def allreduce(values: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of one scalar per shard (the overflow counts' allreduce)."""
    return sum(values[1:], values[0])


def allgather(values: Sequence[torch.Tensor]) -> torch.Tensor:
    """One value per shard → the ``(P, ...)`` stack every shard sees."""
    return torch.stack(list(values))


def ppermute(frames: Sequence[torch.Tensor], perm) -> list:
    """Shift shard blocks along ``perm``, a sequence of ``(src, dst)``
    pairs: shard ``dst`` receives ``frames[src]``.  A shard no pair sends
    to receives zeros, as JAX's ``ppermute`` delivers."""
    out = [torch.zeros_like(f) for f in frames]
    for src, dst in perm:
        out[dst] = frames[src]
    return out
