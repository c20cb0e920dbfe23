"""Exporters: Chrome ``trace_event`` JSON and a flat metrics dump.

``export_chrome_trace`` writes the span tree in the Trace Event Format,
loadable by Perfetto / ``chrome://tracing``: complete ``"ph": "X"``
events for spans, ``"ph": "C"`` counter tracks for every gauge, and
``"ph": "M"`` process/thread-name metadata so spans group into one lane
per subsystem phase (``plan.*``, ``spill.*``, ``recovery.*``, ...)
instead of a single flat track.  ``metrics_snapshot`` flattens a
collector — metrics, plan audits, per-step observations — into one
JSON-serializable dict, so a perf number ships with the exchange counts
and bytes that explain it.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List

#: span-name prefixes → one Perfetto lane each (tid 1..n; unknown
#: prefixes share tid 0, the "main" lane)
PHASE_LANES = ("plan", "io", "scan", "spill", "recovery", "workflow",
               "table", "exchange", "bench")


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return repr(v)


def _lane(name: str) -> int:
    prefix = name.split(".", 1)[0]
    try:
        return PHASE_LANES.index(prefix) + 1
    except ValueError:
        return 0


def chrome_trace_events(collector) -> List[Dict[str, Any]]:
    """Span tree + gauges as Trace Event Format events.

    Spans are complete ``X`` events placed on a per-phase lane (tid);
    ``M`` metadata events name the process (the collector) and each used
    lane; every gauge becomes one ``C`` counter sample stamped at the
    trace end so Perfetto renders it as a counter track.
    """
    events: List[Dict[str, Any]] = []
    used_lanes = {0}
    end_ts = 0.0

    def emit(span):
        nonlocal end_ts
        tid = _lane(span.name)
        used_lanes.add(tid)
        ts, dur = round(span.t0_us, 3), round(span.dur_us, 3)
        # the end of the event as written (a sum of the rounded times can
        # exceed the rounded sum by an ulp)
        end_ts = max(end_ts, ts + dur)
        events.append({
            "name": span.name, "ph": "X", "cat": "repro",
            "ts": ts, "dur": dur, "pid": 0, "tid": tid,
            "args": {k: _jsonable(v) for k, v in span.attrs.items()},
        })
        for c in span.children:
            emit(c)

    for root in collector.spans:
        emit(root)

    meta: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
        "args": {"name": collector.name}}]
    for tid in sorted(used_lanes):
        lane = "main" if tid == 0 else PHASE_LANES[tid - 1]
        meta.append({"name": "thread_name", "ph": "M", "pid": 0,
                     "tid": tid, "args": {"name": lane}})
        meta.append({"name": "thread_sort_index", "ph": "M", "pid": 0,
                     "tid": tid, "args": {"sort_index": tid}})

    counters = [{
        "name": gname, "ph": "C", "cat": "repro", "pid": 0, "tid": 0,
        "ts": end_ts, "args": {"value": _jsonable(v)}}
        for gname, v in sorted(collector.metrics.gauges.items())]
    return meta + events + counters


def export_chrome_trace(collector, path: str) -> str:
    """Write the trace to ``path`` (Perfetto-loadable); returns ``path``."""
    doc = {"traceEvents": chrome_trace_events(collector),
           "displayTimeUnit": "ms",
           "otherData": {"collector": collector.name}}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return path


def metrics_snapshot(collector) -> Dict[str, Any]:
    """Flat JSON-ready view: metrics + audits + per-plan-step facts."""
    return {
        "collector": collector.name,
        "metrics": collector.metrics.as_dict(),
        "audits": [dict(a) for a in collector.audits],
        "plan_steps": {str(i): dict(v)
                       for i, v in sorted(collector.plan_steps.items())},
        "n_spans": sum(1 for _ in collector.all_spans()),
    }


def export_metrics(collector, path: str) -> str:
    with open(path, "w") as f:
        json.dump(metrics_snapshot(collector), f, indent=1, sort_keys=True)
        f.write("\n")
    return path
