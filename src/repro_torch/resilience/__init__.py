"""Pipeline fault tolerance (paper §VII-F, reference DESIGN.md §13).

The paper's prescription — "we can always handle the faults outside of
the operator code" — in the two pieces the storage slice needs:

  faults.py    unified chaos-injection registry: site-addressable,
               seeded deterministic schedules, env-drivable
               (``HPTMT_FAULTS``, ``HPTMT_SPILL_FAULT``)
  policy.py    :class:`FaultPolicy` — the shared retry/backoff contract
               (typed retryable-vs-fatal split, deterministic jitter)

The reference's third piece, lineage stage checkpoints (``stages.py``),
arrives with the runtime services (ROADMAP Queue 1 item 9).
"""
from .faults import (FAULTS_ENV, KINDS, SPILL_FAULT_ENV, SPILL_FAULT_POINTS,
                     FatalInjectedFault, InjectedFault, arm, arm_schedule,
                     clear, fire, fires, reset)
from .policy import FaultPolicy, RetryBudgetExceeded

__all__ = [
    "FAULTS_ENV", "KINDS", "SPILL_FAULT_ENV", "SPILL_FAULT_POINTS",
    "FatalInjectedFault", "InjectedFault",
    "arm", "arm_schedule", "clear", "fire", "fires", "reset",
    "FaultPolicy", "RetryBudgetExceeded",
]
