"""Pipeline fault tolerance (paper §VII-F, reference DESIGN.md §13).

The paper's prescription — "we can always handle the faults outside of
the operator code" — as a subsystem with three coupled pieces:

  faults.py    unified chaos-injection registry: site-addressable,
               seeded deterministic schedules, env-drivable
               (``HPTMT_FAULTS``, ``HPTMT_SPILL_FAULT``)
  policy.py    :class:`FaultPolicy` — the shared retry/backoff contract
               (typed retryable-vs-fatal split, deterministic jitter)
               consumed by scan, spill, stage commits and the workflow
               engine
  stages.py    lineage stage checkpoints: CRC-checked ``.hpt`` stage
               snapshots at exchange boundaries, keyed by a plan
               fingerprint; ``collect(policy=...)`` resumes from the
               last committed stage and re-runs only the suffix

Recovery events publish through :mod:`repro_torch.telemetry` as
``fault.injected.*`` / ``retry.<site>`` counters, the
``recovery.resumed_from_stage`` gauge, and ``recovery.*`` spans.
"""
from .faults import (FAULTS_ENV, KINDS, SPILL_FAULT_ENV, SPILL_FAULT_POINTS,
                     FatalInjectedFault, InjectedFault, arm, arm_schedule,
                     clear, fire, fires, reset)
from .policy import FaultPolicy, RetryBudgetExceeded
from .stages import StageCheckpointer, plan_fingerprint, stage_hook

__all__ = [
    "FAULTS_ENV", "KINDS", "SPILL_FAULT_ENV", "SPILL_FAULT_POINTS",
    "FatalInjectedFault", "InjectedFault",
    "arm", "arm_schedule", "clear", "fire", "fires", "reset",
    "FaultPolicy", "RetryBudgetExceeded",
    "StageCheckpointer", "plan_fingerprint", "stage_hook",
]
