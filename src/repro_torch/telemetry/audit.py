"""Exchange audits: what a planned program predicted against what it did.

The reference reads collectives out of program artifacts at two levels —
the traced jaxpr and the compiled HLO — and its planner's audit holds
its own prediction against both (reference DESIGN.md §12).  A PyTorch
program has neither artifact: the port runs its operators eagerly and
every row exchange passes through ONE choke point,
``core.array_ops.all_to_all``, which counts its calls
(``array_ops.EXCHANGES``).  So the port's audit has one observed layer:

    planner predicted all_to_all == exchanges counted at the choke point

:func:`exchange_log` records each exchange's payload bytes while a
program runs, and :func:`plan_audit` builds the audit record
(``predicted_a2a``, ``observed_a2a``, ``exchanges``, ``consistent``) that
``LazyFrame.collect(telemetry=...)`` files and ``PlanAuditError``
enforces under ``strict``.

Not carried from the reference, for want of a torch analogue:
``jaxpr_collectives``, ``jaxpr_exchanges``, ``trace_collectives``,
``hlo_collectives``, ``compiled_collectives``, ``top_collectives``,
``program_audit`` and ``JAXPR_PRIMITIVES``.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional


@contextlib.contextmanager
def exchange_log():
    """Record the payload bytes of every exchange made in the ``with``
    body, in program order (the list it yields fills as the body runs).

    Bytes are GLOBAL: the sum over every shard's send frame, the volume
    the exchange moves across all shards (the reference's convention).
    """
    from ..core import array_ops

    prev = array_ops.EXCHANGES.log
    log: List[int] = []
    array_ops.EXCHANGES.log = log
    try:
        yield log
    finally:
        array_ops.EXCHANGES.log = prev


def plan_audit(log: List[int], *, n_shards: int,
               predicted_a2a: Optional[int] = None) -> Dict[str, Any]:
    """Audit record of one run whose exchanges ``log`` recorded.

    ``observed_a2a`` counts the exchanges the run made; when the caller
    supplies its planner prediction, ``consistent`` states whether the
    two agree — the runtime form of the plan-contract assertion.
    """
    audit: Dict[str, Any] = {
        "n_shards": n_shards,
        "observed_a2a": len(log),
        "exchanges": [{"primitive": "all_to_all", "bytes": b} for b in log],
        "observed_bytes": sum(log),
    }
    if predicted_a2a is not None:
        audit["predicted_a2a"] = predicted_a2a
        audit["consistent"] = predicted_a2a == audit["observed_a2a"]
    return audit
