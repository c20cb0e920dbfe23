"""On-disk run store for the spill engine (reference DESIGN.md §10).

A :class:`SpillStore` owns one scratch directory of ``.hpt`` run files.
Runs are keyed by ``(tag, partition, shard)`` — ``tag`` names the operand
("left", "right", "in", "out"), ``partition`` is the spill partition a
row's key hashed to, ``shard`` the shard it will re-enter on — and a key
may accumulate several sequence-numbered files (one per ingested chunk),
since the ``.hpt`` container is write-once.  Runs are host numpy; the
engine moves them to the card when a partition re-enters.

Durability contract: every run goes through ``io.native.write_hpt``'s
atomic tmp-write + rename, and carries the container's per-column CRC32,
so a reader can never decode a torn run — interrupted writes either leave
a ``*.tmp`` that :meth:`SpillStore.close` / the engine's error path
removes, or raise :class:`~repro_torch.io.native.HptIntegrityError` at
read.  The store makes its own directory with ``tempfile.mkdtemp``: under
``TMPDIR`` with no ``workdir``, else as a fresh subdirectory of
``workdir``, so closing it deletes only what it wrote and never a file
that was in ``workdir`` before.

On a process group (``group=``) the store is ONE directory for the whole
group: rank 0 makes it (``array_ops.shared_tempdir``) and every rank
writes its runs there, so the shared disk is the spill's exchange — the
ranks must see one file system (one host, or a shared ``workdir``).  A
run's name carries its writer's rank and that rank's sequence number,
so ranks never collide.  A rank's new runs enter the index at
:meth:`SpillStore.sync`, which gathers every rank's new runs (and any
failure: one rank's failed write raises on every rank), so ``rows``,
``partitions`` and ``shards`` read the same on every rank.  A key's runs
are read in (writer rank, sequence) order — rank ``r`` writes the runs
of shards ``r * n_local ..`` in shard order, so that is the virtual
run's order, where the chunks of shards 0, 1, ... are written in turn.
A rank deletes only the runs it wrote, and :meth:`SpillStore.close`
removes the directory on rank 0 once every rank is done with it.

Fault injection: every run write passes through the unified chaos
registry (:mod:`repro_torch.resilience.faults`) at site ``"spill.write"``.
The legacy ``HPTMT_SPILL_FAULT`` env knob (``"<point>:<n>"``) keeps its
semantics as a back-compat alias: the ``n``-th run write fails —
``disk_full`` raises ``ENOSPC`` before any byte lands; ``partial_write``
tears the tmp file mid-write and then fails, simulating a crash.  Both
surface as the named :class:`SpillWriteError` with the tmp file cleaned
up, and the injector disarms after firing so a retry under the same
environment succeeds.  A :class:`~repro_torch.resilience.FaultPolicy`
passed to the store retries the write in place (the run's columns are
still in memory) with backoff.
"""
from __future__ import annotations

import os
import shutil
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..core.array_ops import barrier, gather_objects, on_rank0, \
    picklable, raise_first, shared_tempdir
from ..core.context import group_rank
from ..io.native import read_hpt, write_hpt
from ..resilience import faults as _faults
from ..resilience.policy import RetryBudgetExceeded

FAULT_ENV = _faults.SPILL_FAULT_ENV
FAULT_POINTS = _faults.SPILL_FAULT_POINTS


class SpillError(RuntimeError):
    """Base class for spill-engine failures."""


class SpillWriteError(SpillError):
    """A spill run could not be written (disk full / interrupted write).

    The failed run's temp file has already been cleaned up; retrying the
    operation recomputes the run from its in-memory source.
    """


def reset_fault_injection() -> None:
    """Re-arm the fault injector from the current environment (tests).

    Delegates to the registry's :func:`repro_torch.resilience.faults.reset`
    — one-shot "fired" memory is per armed spec there, so a retry under
    an unchanged environment succeeds.
    """
    _faults.reset()


def _check_fault(path: str) -> None:
    """Fire any armed ``spill.write`` fault (once) at this write site."""
    _faults.fire("spill.write", path=path)


class SpillStore:
    """A directory of spill runs with an in-memory index.

    Usable as a context manager; ``close()`` removes the store's own
    directory (runs, temp files and all), so no spill artifact outlives
    the operation that created it, and a ``workdir`` the store had to
    create once it is empty again.  ``group`` is the process group the
    store serves (``None``: one process).
    """

    def __init__(self, workdir: Optional[str] = None, *, policy=None,
                 group=None):
        self.group = group
        self.rank = group_rank(group)
        self._made_workdir = None
        if self.rank == 0 and workdir is not None \
                and not os.path.isdir(workdir):
            self._made_workdir = workdir
        self.root = shared_tempdir("hptmt-spill-", workdir, group)
        self.policy = policy  # optional FaultPolicy: retry run writes
        # (tag, q, s) -> [(writer rank, seq, path, rows)], in read order
        self._runs: Dict[Tuple[str, int, int],
                         List[Tuple[int, int, str, int]]] = {}
        # this rank's runs not yet in the group's index (see sync)
        self._new: List[Tuple[Tuple[str, int, int], int, int, str, int,
                              int]] = []
        self._seq = 0
        self.bytes_written = 0
        self.closed = False

    # -- writing -----------------------------------------------------------
    def write_run(self, tag: str, q: int, s: int,
                  cols: Dict[str, np.ndarray], num_rows: int) -> str:
        """Write one run file atomically; returns its path.

        Injected or real OS-level write failures are converted to the
        named :class:`SpillWriteError` after removing the temp file, so a
        failed spill never leaves a half-written run behind.  On a group
        the run enters the index at the next :meth:`sync`.
        """
        seq = self._seq
        path = os.path.join(
            self.root,
            f"{tag}-q{q:05d}-s{s:03d}-r{self.rank:03d}-{seq:05d}.hpt")
        self._seq += 1

        def attempt():
            _check_fault(path)
            return write_hpt(path, cols, num_rows)

        try:
            if self.policy is not None:
                # local I/O, no collective: each rank retries on its own
                header = self.policy.run(attempt, site="spill.write")
            else:
                header = attempt()
        except (OSError, RetryBudgetExceeded) as e:
            for leftover in (path + ".tmp", path):
                try:
                    os.remove(leftover)
                except OSError:
                    pass
            raise SpillWriteError(
                f"spill run {os.path.basename(path)} failed to write "
                f"({getattr(e, 'strerror', None) or e}); "
                f"scratch dir {self.root} — free disk "
                f"space or point the spill workdir elsewhere and retry"
            ) from e
        nbytes = sum(n for _, n in header["offsets"].values())
        entry = ((tag, int(q), int(s)), self.rank, seq, path, int(num_rows),
                 nbytes)
        if self.group is None:
            self._index([entry])
        else:
            self._new.append(entry)
        return path

    def _index(self, entries) -> None:
        touched = set()
        for key, rank, seq, path, rows, nbytes in entries:
            self._runs.setdefault(key, []).append((rank, seq, path, rows))
            self.bytes_written += nbytes
            touched.add(key)
        for key in touched:
            self._runs[key].sort()

    def sync(self, error: Optional[BaseException] = None) -> None:
        """End a round of writes (or reads) on every rank: each rank passes
        the exception its round raised (or ``None``); every rank's new
        runs enter the index, and if any rank failed every rank raises —
        its own exception, or else the lowest failing rank's.  Without a
        group only ``error`` is raised."""
        if self.group is None:
            if error is not None:
                raise error
            return
        every = gather_objects((picklable(error), self._new), self.group)
        self._new = []
        self._index([e for _, new in every for e in new])
        raise_first(error, [e for e, _ in every])

    # -- reading -----------------------------------------------------------
    def partitions(self, tag: str) -> List[int]:
        return sorted({q for (t, q, _s) in self._runs if t == tag})

    def shards(self, tag: str, q: int) -> List[int]:
        return sorted({s for (t, qq, s) in self._runs if t == tag and qq == q})

    def rows(self, tag: str, q: int, s: Optional[int] = None) -> int:
        return sum(run[3] for (t, qq, ss), runs in self._runs.items()
                   if t == tag and qq == q and (s is None or ss == s)
                   for run in runs)

    def _keys(self, tag: str, q: int, s: Optional[int]):
        return sorted(k for k in self._runs
                      if k[0] == tag and k[1] == q and (s is None or k[2] == s))

    def _paths(self, tag: str, q: int, s: Optional[int], own: bool):
        for key in self._keys(tag, q, s):
            for rank, _, path, _ in self._runs[key]:
                if not own or rank == self.rank:
                    yield path

    def read_partition(self, tag: str, q: int, s: Optional[int] = None
                       ) -> Tuple[Dict[str, np.ndarray], int]:
        """Concatenate the runs of one partition (optionally one shard),
        every writer's."""
        pieces: List[Dict[str, np.ndarray]] = []
        total = 0
        for path in self._paths(tag, q, s, own=False):
            cols, nn = read_hpt(path)
            pieces.append(cols)
            total += nn
        if not pieces:
            return {}, 0
        if len(pieces) == 1:
            return pieces[0], total
        return {k: np.concatenate([p[k] for p in pieces], axis=0)
                for k in pieces[0]}, total

    def iter_runs(self, tag: str, q: int, s: Optional[int] = None, *,
                  own: bool = False
                  ) -> Iterator[Tuple[Dict[str, np.ndarray], int]]:
        """Stream one partition's runs file-by-file (bounded memory);
        ``own`` keeps to the runs this rank wrote."""
        for path in self._paths(tag, q, s, own):
            yield read_hpt(path)

    def drop_partition(self, tag: str, q: int) -> None:
        """Forget a partition's runs once consumed and delete the files
        this rank wrote (keeps disk bounded).  On a group the caller
        drops only once no rank reads the partition any more."""
        for key in [k for k in self._runs if k[0] == tag and k[1] == q]:
            for rank, _, path, _ in self._runs.pop(key):
                if rank != self.rank:
                    continue
                try:
                    os.remove(path)
                except OSError:
                    pass

    # -- lifecycle ---------------------------------------------------------
    def leftover_temp_files(self) -> List[str]:
        """Any ``*.tmp`` files in the scratch tree (should always be [])."""
        if not os.path.isdir(self.root):
            return []
        return sorted(p for p in os.listdir(self.root) if p.endswith(".tmp"))

    def close(self) -> None:
        """Remove the store's directory (on a group: every rank calls it,
        and rank 0 removes the directory once every rank is here)."""
        if self.closed:
            return
        self.closed = True
        self._runs.clear()
        self._new = []
        def remove():
            shutil.rmtree(self.root, ignore_errors=True)
            if self._made_workdir is not None:
                try:
                    os.rmdir(self._made_workdir)  # only if nothing else is there
                except OSError:
                    pass

        barrier(self.group)
        on_rank0(remove, self.group)

    def __enter__(self) -> "SpillStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
