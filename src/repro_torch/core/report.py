"""Unified overflow accounting — one exactness certificate per result.

Every operator in this repo runs at a static capacity and *counts* rows it
cannot hold instead of corrupting state (DESIGN.md §2).  Before this
module the counts were scattered per-operator conventions: ``join``
returned a traced scalar, the ``TSet`` barriers discarded theirs, the
scan kept ``rows_overflowed`` on :class:`ScanStats`.  An
:class:`OverflowReport` folds them all into one host-side structure that
rides along with ``DataFrame``/``TSet``/spill results, so a caller has a
single place to ask "is this result exact?" — and the spill engine has a
single place to record that an overflow was *recovered* (re-run
out-of-core) rather than lost.

Counts live under dotted source labels, e.g. ``"join.fanout"``,
``"groupby.slots"``, ``"scan.capacity"``, ``"window.truncated"``.
Recovered counts are kept separately: they describe work the spill path
re-did exactly, so they do not affect :meth:`is_exact`.
"""
from __future__ import annotations

import builtins
import dataclasses
from typing import Dict, Iterator, Tuple


class OverflowError(RuntimeError, builtins.OverflowError):
    """Raised when a result with a nonzero residual overflow is asserted
    exact (:meth:`OverflowReport.assert_exact`) or when an operator is
    configured to fail rather than drop (``DataFrame`` default).

    Subclasses BOTH ``RuntimeError`` (the repo's operator-failure family)
    and the builtin ``OverflowError``, so callers who never import this
    module still catch it with a plain ``except OverflowError:``."""


@dataclasses.dataclass
class OverflowReport:
    """Mutable accumulator of per-source overflow counts.

    ``entries`` maps a dotted source label to the number of rows that
    overflowed and were dropped there.  ``recovered`` maps labels to rows
    that *would* have overflowed in-memory but were recomputed exactly by
    the spill engine — evidence of recovery, not of loss.
    """

    entries: Dict[str, int] = dataclasses.field(default_factory=dict)
    recovered: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add(self, source: str, count) -> "OverflowReport":
        """Record ``count`` dropped rows under ``source`` (0 is a no-op)."""
        n = int(count)
        if n:
            self.entries[source] = self.entries.get(source, 0) + n
        return self

    def add_recovered(self, source: str, count) -> "OverflowReport":
        """Record ``count`` rows recovered via spill under ``source``."""
        n = int(count)
        if n:
            self.recovered[source] = self.recovered.get(source, 0) + n
        return self

    def merge(self, other: "OverflowReport") -> "OverflowReport":
        for k, v in other.entries.items():
            self.add(k, v)
        for k, v in other.recovered.items():
            self.add_recovered(k, v)
        return self

    @property
    def total(self) -> int:
        """Residual (lost) rows across all sources."""
        return sum(self.entries.values())

    @property
    def total_recovered(self) -> int:
        return sum(self.recovered.values())

    def is_exact(self) -> bool:
        """True iff no row was lost anywhere in the lineage."""
        return self.total == 0

    def assert_exact(self) -> "OverflowReport":
        if not self.is_exact():
            detail = ", ".join(f"{k}={v}" for k, v in sorted(
                self.entries.items()))
            raise OverflowError(
                f"result is inexact: {self.total} rows overflowed static "
                f"capacity ({detail}) — raise the capacity/bucket_factor "
                f"or enable spill (spill='auto')")
        return self

    def to_metrics(self, prefix: str = "overflow") -> Dict[str, int]:
        """This report as flat dotted metrics for the telemetry layer.

        Lost rows keep their source labels under ``<prefix>.``
        (``overflow.join.fanout``); spill-recovered rows land under
        ``<prefix>.recovered.``, so one metrics dump carries the same
        exactness story the report itself tells (DESIGN.md §12).
        """
        out = {f"{prefix}.{k}": v for k, v in sorted(self.entries.items())}
        out.update({f"{prefix}.recovered.{k}": v
                    for k, v in sorted(self.recovered.items())})
        return out

    def __iter__(self) -> Iterator[Tuple[str, int]]:
        return iter(sorted(self.entries.items()))

    def __bool__(self) -> bool:  # truthy iff something was lost
        return self.total > 0

    def __repr__(self) -> str:
        lost = ", ".join(f"{k}={v}" for k, v in sorted(self.entries.items()))
        rec = ", ".join(f"{k}={v}" for k, v in sorted(self.recovered.items()))
        return (f"OverflowReport(lost={{{lost}}}, recovered={{{rec}}})")
