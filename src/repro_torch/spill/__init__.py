"""Out-of-core spill subsystem (reference DESIGN.md §10).

Turns the overflow contract's *counted loss* into *recovery*: inputs
bigger than the planned capacity are hash-partitioned into on-disk
``.hpt`` runs and streamed partition-by-partition through the unchanged
in-memory operators (on the card, through their kernels) under a bounded
per-step memory budget — exact against the all-in-memory path, with the
run format carrying the row hashes and order lanes so re-ingested
partitions take the shuffle- and sort-elision paths (zero exchanges on
re-entry).

  hashing.py   bit-identical numpy twins of the device hash / lanes
  store.py     run-file store, atomic writes, fault injection
  engine.py    spill_join / spill_groupby / spill_window + SpillResult
"""
from .engine import (SpillResult, SpillStats, iter_host_chunks,
                     plan_partitions, should_spill, spill_groupby,
                     spill_join, spill_window)
from .store import (FAULT_ENV, SpillError, SpillStore, SpillWriteError,
                    reset_fault_injection)

__all__ = [
    "SpillResult", "SpillStats", "iter_host_chunks", "plan_partitions",
    "should_spill", "spill_groupby", "spill_join", "spill_window",
    "FAULT_ENV", "SpillError", "SpillStore", "SpillWriteError",
    "reset_fault_injection",
]
