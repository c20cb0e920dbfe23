"""Unified runtime telemetry: spans, metrics, and exchange audits.

The observability layer for the port's operator stack (reference
DESIGN.md §12):

  * :func:`trace` / :func:`span` / :func:`traced` — a hierarchical span
    recorder with host-clock honesty (a span synchronizes the card's
    devices behind its outputs before it closes).  Off by default; when
    no collector is active every instrumentation site is a single
    ``None`` check.
  * :class:`Collector` ``.metrics`` — counters/gauges fed by runtime
    facts (rows in/out, overflow labels, spill bytes, scan pruning) and
    by the exchange audit (:mod:`.audit`: the planner's predicted
    exchanges against those counted at the choke point).
  * :func:`export_chrome_trace` / :func:`metrics_snapshot` — Perfetto
    trace JSON and the flat metrics dump.
  * The query observatory (reference DESIGN.md §14): q-errors
    (:mod:`.cardinality`), the live-bytes model and RSS watermarks
    (:mod:`.memory`) and the run-history ledger (:mod:`.ledger`).

Typical session::

    from repro_torch import telemetry

    with telemetry.trace() as rec:
        df = lazy_pipeline.collect(telemetry=rec)
    telemetry.export_chrome_trace(rec, "pipeline_trace.json")
"""
from .audit import exchange_log, plan_audit
from .cardinality import (DEFAULT_QERROR_THRESHOLD, CardinalityAuditError,
                          audit_cardinality, q_error, record_qerrors,
                          step_qerrors)
from .export import (chrome_trace_events, export_chrome_trace,
                     export_metrics, metrics_snapshot)
from .ledger import (append as ledger_append, bench_record, collect_record,
                     read as ledger_read)
from .memory import (RssWatermark, peak_rss_kb, publish_pressure,
                     reset_peak_rss, rss_kb, step_live_bytes)
from .record import (Collector, Metrics, Span, current, operator_call, span,
                     trace, traced, tracing, using)

__all__ = [
    "Collector", "Metrics", "Span", "current", "operator_call", "span",
    "trace", "traced", "tracing", "using",
    "exchange_log", "plan_audit",
    "chrome_trace_events", "export_chrome_trace", "export_metrics",
    "metrics_snapshot",
    "DEFAULT_QERROR_THRESHOLD", "CardinalityAuditError", "audit_cardinality",
    "q_error", "record_qerrors", "step_qerrors",
    "RssWatermark", "peak_rss_kb", "publish_pressure", "reset_peak_rss",
    "rss_kb", "step_live_bytes",
    "ledger_append", "ledger_read", "bench_record", "collect_record",
]
