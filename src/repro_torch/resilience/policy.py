"""Shared retry/backoff policy — the one retry loop every layer uses.

:class:`FaultPolicy` carries the whole fault-handling contract of a run
(reference DESIGN.md §13.4): how many times to retry, how long to back off
(exponential with *deterministic* jitter — reproducible schedules, no
wall-clock randomness), which exception types are retryable vs fatal,
and where stage checkpoints go.  It is consumed by

  * ``LazyFrame.collect(policy=...)`` — stage checkpoints + whole-plan
    retry (``plan.collect`` site),
  * ``io.scan.ScanSource`` — per-fragment-run read retries,
  * ``spill.store.SpillStore`` — run-write retries,
  * stage-checkpoint commits (``checkpoint.commit`` site),
  * ``workflow.WorkflowEngine`` — task retries with backoff.

On a process group a retry loop is local or agreed.  A site whose work
is this process's own I/O — a scan's fragment reads (``scan.read``), a
spill run's write (``spill.write``) — retries on its own rank: its
peers never wait on it inside the attempt.  A site whose attempt holds
collectives — the whole-plan run (``plan.collect``), a stage commit
(``checkpoint.commit``), a workflow task — passes ``group=``: every
rank learns every rank's outcome of each attempt, so every rank
retries, or raises, together, and no rank waits in a collective its
peers left.  Faults inside such an attempt must reach every rank first
(the plan's ``plan.step.<i>`` sites and the commit raise together).

Retry taxonomy: the **fatal** tuple (``ValueError``/``TypeError``/...)
fails fast — those are programming or corruption errors where a retry
re-runs the same deterministic failure (``HptIntegrityError`` and
``CorruptFragmentError`` are ``ValueError`` subclasses precisely so
corruption is never retried).  Everything else is presumed transient
(``OSError``, ``RuntimeError``) unless an explicit ``retryable`` tuple
narrows it.  Exhausted budgets raise :class:`RetryBudgetExceeded`,
itself classified fatal so nested policies never multiply retries.
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Callable, Optional, Tuple


class RetryBudgetExceeded(RuntimeError):
    """A site failed on every attempt the policy allowed.  ``__cause__``
    carries the last underlying error.  Classified fatal by every
    :class:`FaultPolicy`, so an outer retry loop fails fast instead of
    multiplying the inner budget."""


_DEFAULT_FATAL = (ValueError, TypeError, KeyError, AttributeError,
                  NotImplementedError, AssertionError, RetryBudgetExceeded)


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """Immutable fault-handling contract; share one per run.

    ``max_retries`` bounds RETRIES — a site gets ``max_retries + 1``
    attempts.  Backoff before retry ``k`` (0-based) is
    ``min(backoff_base * backoff_factor**k, backoff_max)`` scaled by a
    deterministic per-``(site, attempt)`` jitter in ``[1, 1+jitter]``.

    ``checkpoint_dir`` enables lineage stage checkpoints under
    ``collect(policy=...)``; ``keep_checkpoints=False`` removes them
    after a successful collect (a crash leaves them for resume).
    """
    max_retries: int = 3
    backoff_base: float = 0.01
    backoff_factor: float = 2.0
    backoff_max: float = 1.0
    jitter: float = 0.1
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: bool = False
    retryable: Optional[Tuple[type, ...]] = None
    fatal: Tuple[type, ...] = _DEFAULT_FATAL

    def is_retryable(self, exc: BaseException) -> bool:
        """Fatal types fail fast; otherwise retryable (or only the
        explicit ``retryable`` tuple when one is given)."""
        if isinstance(exc, self.fatal):
            return False
        if self.retryable is not None:
            return isinstance(exc, self.retryable)
        return True

    def delay(self, attempt: int, site: str = "") -> float:
        """Backoff before retry ``attempt`` (deterministic: same site +
        attempt → same delay, across processes and reruns)."""
        d = min(self.backoff_base * self.backoff_factor ** attempt,
                self.backoff_max)
        frac = (zlib.crc32(f"{site}:{attempt}".encode()) % 1000) / 999.0
        return d * (1.0 + self.jitter * frac)

    def run(self, fn: Callable, *, site: str,
            sleep: Callable[[float], None] = time.sleep, group=None):
        """Invoke ``fn()`` under this policy's retry loop.

        Publishes a ``retry.<site>`` counter per retry on the active
        telemetry collector; raises the original exception for fatal
        failures and :class:`RetryBudgetExceeded` on exhaustion.  With a
        process ``group`` each attempt's outcome is the group's: every
        rank's exception, each classified on the rank that raised it,
        reaches every rank.  If any of them is fatal every rank raises
        (its own exception, or else the first fatal one); if every
        failure is retryable every rank retries.
        """
        from .. import telemetry
        from ..core.array_ops import gather_objects, picklable

        last: Optional[BaseException] = None
        for attempt in range(self.max_retries + 1):
            mine, out = None, None
            try:
                out = fn()
            except Exception as e:  # noqa: BLE001 — classified below
                mine = e
            retryable = mine is not None and self.is_retryable(mine)
            every = [(mine, retryable)] if group is None else \
                gather_objects((picklable(mine), retryable), group)
            failed = [(e, ok) for e, ok in every if e is not None]
            if not failed:
                return out
            fatal = [e for e, ok in failed if not ok]
            if fatal:
                raise mine if mine is not None else fatal[0]
            last = mine if mine is not None else failed[0][0]
            if attempt < self.max_retries:
                rec = telemetry.current()
                if rec is not None:
                    rec.metrics.count(f"retry.{site}")
                sleep(self.delay(attempt, site))
        raise RetryBudgetExceeded(
            f"site {site!r}: all {self.max_retries + 1} attempts failed; "
            f"last error: {type(last).__name__}: {last}") from last
