"""Run-history ledger: one JSONL record per collect/bench run
(reference DESIGN.md §14.3).

Every record is keyed by the run's **plan fingerprint** — the same
deterministic identity stage checkpoints use (``resilience.stages.
plan_fingerprint``: canonical logical tree + shard count) — so runs of
the same pipeline over the same data land under one key across
processes, machines and days, and ``scripts/perf_report.py`` can chart
per-fingerprint deltas and flag regressions (>30% wall time, >2x
q-error drift) instead of comparing apples to oranges.  Bench cases use
the synthetic key ``bench:<case>`` (their identity is the case name).

Record schema (one JSON object per line, append-only)::

    {"fingerprint": "...", "kind": "collect" | "bench",
     "ts": <unix seconds>, "wall_s": <float>,
     "max_qerror": <float | null>, "qerrors": {"<step>": q, ...},
     "peak_rss_mb": <float | null>, "steps": <n | null>,
     "predicted_a2a": <n | null>, "observed_a2a": <n | null>,
     "audit_consistent": <bool | null>,
     "counters": {...}, "gauges": {...},       # metrics snapshot
     "derived": "..."}                          # bench flavor text

Appends are line-atomic (single ``write`` of one line, O_APPEND), so
concurrent benchers interleave whole records, never tear one.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional


def append(path: str, record: Dict[str, Any]) -> None:
    """Append one record as a single JSONL line (parent dirs created)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    line = json.dumps(record, sort_keys=True, default=repr)
    with open(path, "a") as f:
        f.write(line + "\n")


def read(path: str) -> List[Dict[str, Any]]:
    """All records in file order; a torn/garbage trailing line (crash
    mid-append on a non-atomic filesystem) is skipped, not fatal."""
    out: List[Dict[str, Any]] = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


def collect_record(rec, *, fingerprint: str, wall_s: float,
                   kind: str = "collect",
                   extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Build the ledger record for one ``collect()`` run.

    ``rec`` is the run's :class:`~repro_torch.telemetry.record.Collector`, or
    ``None`` for an un-instrumented collect (then only identity + wall
    time are recorded — still enough for the time-regression screen).
    """
    from .memory import peak_rss_kb

    out: Dict[str, Any] = {
        "fingerprint": fingerprint, "kind": kind,
        "ts": round(time.time(), 3), "wall_s": round(float(wall_s), 6),
        "max_qerror": None, "qerrors": {}, "peak_rss_mb": None,
        "steps": None, "predicted_a2a": None, "observed_a2a": None,
        "audit_consistent": None, "counters": {}, "gauges": {},
    }
    peak = peak_rss_kb()
    if peak is not None:
        out["peak_rss_mb"] = round(peak / 1024.0, 1)
    if rec is not None:
        out["counters"] = dict(sorted(rec.metrics.counters.items()))
        out["gauges"] = dict(sorted(rec.metrics.gauges.items()))
        out["steps"] = len(rec.plan_steps) or None
        qs = {str(i): round(f["qerr"], 3)
              for i, f in rec.plan_steps.items() if "qerr" in f}
        out["qerrors"] = qs
        if qs:
            out["max_qerror"] = max(qs.values())
        if rec.audits:
            a = rec.audits[-1]
            out["predicted_a2a"] = a.get("predicted_a2a")
            out["observed_a2a"] = a.get("observed_a2a")
            out["audit_consistent"] = a.get("consistent")
    if extra:
        out.update(extra)
    return out


def bench_record(name: str, us_per_call: float, derived: str = "",
                 peak_rss_mb: Optional[float] = None,
                 telemetry: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
    """Ledger record for one benchmark case (key ``bench:<name>``)."""
    out: Dict[str, Any] = {
        "fingerprint": f"bench:{name}", "kind": "bench",
        "ts": round(time.time(), 3),
        "wall_s": round(us_per_call * 1e-6, 6),
        "max_qerror": None, "qerrors": {}, "derived": derived,
        "peak_rss_mb": peak_rss_mb,
    }
    if telemetry:
        out["observed_a2a"] = sum(
            telemetry.get("collectives", {}).values()) or None
    return out
