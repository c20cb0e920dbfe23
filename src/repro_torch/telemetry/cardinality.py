"""Cardinality audit: planner estimates vs observed rows (reference
DESIGN.md §14.1).

The physical planner stamps every
:class:`~repro_torch.plan.physical.PlanStep` with its ``estimated_rows``
prediction; the op-by-op instrumentation (``collect(telemetry=rec)``)
records each step's observed ``rows_out``.  This module closes the loop with the standard **q-error**

    q(est, obs) = max(est / obs, obs / est)        (both floored at 1 row)

— 1.0 is a perfect estimate, and the metric is symmetric: a 10x over-
and a 10x under-estimate are equally wrong, which is what makes it the
right gate for join-order decisions (they only need the *ratio* right).

``record_qerrors`` files a ``qerr`` fact per audited step plus the
``cardinality.max_qerror`` gauge; ``audit_cardinality`` raises
:class:`CardinalityAuditError` when any step's q-error exceeds the
caller's threshold (``collect(..., strict=True, qerror_threshold=...)``)
so a planner whose estimates drift out of contract fails loudly instead
of silently reordering joins from fiction.
"""
from __future__ import annotations

from typing import Dict, Optional

#: the contract threshold CI asserts on the representative chain — a
#: generous bound (estimates guide ORDER, not admission), but one real
#: estimator regressions blow straight past
DEFAULT_QERROR_THRESHOLD = 4.0


class CardinalityAuditError(RuntimeError):
    """A plan step's cardinality estimate missed the observed row count
    by more than the configured q-error threshold."""


def q_error(est: float, obs: float) -> float:
    """Symmetric multiplicative estimation error, both sides ≥ 1 row
    (an empty-vs-empty prediction is exact, not a 0/0)."""
    e = max(float(est), 1.0)
    o = max(float(obs), 1.0)
    return max(e / o, o / e)


def step_qerrors(rec) -> Dict[int, float]:
    """Per-step q-errors for every plan step carrying BOTH an estimate
    and an observation (a step that did not run — a stage restored from
    a checkpoint skips its subtree — has none)."""
    out: Dict[int, float] = {}
    for idx, facts in rec.plan_steps.items():
        est, obs = facts.get("est_rows"), facts.get("rows_out")
        if est is None or obs is None:
            continue
        out[idx] = q_error(est, obs)
    return out


def record_qerrors(rec) -> Dict[int, float]:
    """Compute q-errors, file each as a ``qerr`` step fact, and publish
    the ``cardinality.max_qerror`` / ``cardinality.steps_audited``
    gauges; returns the per-step map."""
    qs = step_qerrors(rec)
    for idx, q in qs.items():
        rec.observe_step(idx, qerr=round(q, 3))
    rec.metrics.gauge("cardinality.steps_audited", len(qs))
    if qs:
        rec.metrics.gauge("cardinality.max_qerror",
                          round(max(qs.values()), 3))
    return qs


def audit_cardinality(rec, threshold: Optional[float] = None) -> Dict[int, float]:
    """Enforce the q-error contract: raise :class:`CardinalityAuditError`
    when any audited step exceeds ``threshold`` (default
    :data:`DEFAULT_QERROR_THRESHOLD`)."""
    limit = DEFAULT_QERROR_THRESHOLD if threshold is None else float(threshold)
    qs = step_qerrors(rec)
    bad = {i: q for i, q in qs.items() if q > limit}
    if bad:
        detail = ", ".join(
            f"step {i} ({rec.plan_steps[i].get('op', '?')}): "
            f"est={rec.plan_steps[i].get('est_rows'):.0f} "
            f"obs={rec.plan_steps[i].get('rows_out')} q={q:.2f}"
            for i, q in sorted(bad.items()))
        raise CardinalityAuditError(
            f"cardinality audit failed (q-error threshold {limit:g}): "
            f"{detail} — the planner's estimates are out of contract; "
            f"refine() with the observed rows or fix the estimator")
    return qs
