"""Span/metrics recorder — the runtime half of the telemetry layer.

One module-level active :class:`Collector` (or ``None``, the default).
Every instrumentation site in the port follows the same two-gate rule
(reference DESIGN.md §12):

  * **off-by-default** — when no collector is active, the site is one
    global ``None`` check (:func:`span` returns the shared no-op span);
    nothing allocates, nothing times, nothing synchronizes the card.
  * **host-clock honesty** — spans never materialize while
    ``torch.compile`` traces (:func:`tracing` gates every open).  A span
    that wraps device work synchronizes the device of every CUDA tensor
    in its outputs (:meth:`Span.block`) before stamping its duration, so
    the card's asynchronous launches cannot make an operator look free.

Spans form a tree (``Collector._stack``); metrics are flat counters and
gauges under dotted names, matching the
:class:`~repro_torch.core.report.OverflowReport` label convention.
"""
from __future__ import annotations

import contextlib
import functools
import time
from typing import Any, Dict, List, Optional

import torch


def tracing() -> bool:
    """True while ``torch.compile`` traces — spans must not materialize
    then (host clocks do not run with the traced program)."""
    return torch.compiler.is_compiling()


def _cuda_devices(value, out: set) -> None:
    """Collect the devices of every CUDA tensor in ``value``: tensors,
    tuples, lists, dicts, tables (``.columns``/``.counts``) and frames
    (``.table``)."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    elif isinstance(getattr(value, "columns", None), dict):
        _cuda_devices(value.columns, out)
    elif hasattr(value, "table"):
        _cuda_devices(value.table, out)


class Span:
    """One timed region: name + attrs + children, µs since trace start."""

    __slots__ = ("name", "attrs", "t0_us", "dur_us", "children")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.t0_us = 0.0
        self.dur_us = 0.0
        self.children: List["Span"] = []

    def block(self, value) -> None:
        """Wait for the device work behind ``value`` before the span
        closes — the asynchronous-launch honesty rule."""
        devices: set = set()
        _cuda_devices(value, devices)
        for dev in devices:
            torch.cuda.synchronize(dev)

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.dur_us:.0f}us, "
                f"{len(self.children)} children)")


class _NullSpan:
    """Shared no-op span: every method is free, attrs go nowhere."""

    __slots__ = ("attrs",)
    name = "null"
    t0_us = dur_us = 0.0
    children: List[Span] = []

    def __init__(self):
        self.attrs: Dict[str, Any] = {}

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        self.attrs = {}

    def block(self, value) -> None:
        pass


_NULL = _NullSpan()


class Metrics:
    """Flat dotted-name registry: counters accumulate, gauges overwrite."""

    def __init__(self):
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}

    def count(self, name: str, value: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + value

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def merge(self, other: "Metrics") -> "Metrics":
        for k, v in other.counters.items():
            self.count(k, v)
        self.gauges.update(other.gauges)
        return self

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {"counters": dict(sorted(self.counters.items())),
                "gauges": dict(sorted(self.gauges.items()))}


class _SpanCtx:
    """Context manager that opens/closes one span on a collector."""

    __slots__ = ("_rec", "_span")

    def __init__(self, rec: "Collector", sp: Span):
        self._rec = rec
        self._span = sp

    def __enter__(self) -> Span:
        sp = self._span
        sp.t0_us = (time.perf_counter() - self._rec.epoch) * 1e6
        self._rec._stack.append(sp)
        return sp

    def __exit__(self, *exc) -> None:
        sp = self._rec._stack.pop()
        sp.dur_us = (time.perf_counter() - self._rec.epoch) * 1e6 - sp.t0_us


class Collector:
    """One trace session: a span tree + metrics + plan/exchange audits."""

    def __init__(self, name: str = "trace"):
        self.name = name
        self.epoch = time.perf_counter()
        self.spans: List[Span] = []
        self.metrics = Metrics()
        self.audits: List[Dict[str, Any]] = []
        self.plan_steps: Dict[int, Dict[str, Any]] = {}
        self._stack: List[Span] = []

    def span(self, name: str, **attrs):
        """Open a child span of the innermost open span (no-op while
        ``torch.compile`` traces: host clocks lie there)."""
        if tracing():
            return _NULL
        sp = Span(name, attrs)
        parent = self._stack[-1] if self._stack else None
        (parent.children if parent is not None else self.spans).append(sp)
        return _SpanCtx(self, sp)

    def all_spans(self):
        for root in self.spans:
            yield from root.walk()

    # -- runtime-fact bridges (dynamic metrics source) ---------------------
    def record_overflow(self, report) -> None:
        """Expose an :class:`OverflowReport` lineage under its own dotted
        labels.  Gauges, not counters: lineage reports are cumulative, so
        the latest value IS the lineage total (re-recording a child's
        report never double-counts)."""
        for k, v in report.to_metrics().items():
            self.metrics.gauge(k, v)

    def record_scan(self, stats) -> None:
        """Absorb a :class:`~repro_torch.io.scan.ScanStats` into
        ``scan.*``."""
        for k, v in vars(stats).items():
            self.metrics.count(f"scan.{k}", v)

    def record_audit(self, audit: Dict[str, Any]) -> None:
        self.audits.append(audit)

    def observe_step(self, index: int, **facts) -> None:
        """Per-physical-node runtime facts (plan.physical instrumentation);
        keyed by step index so ``explain(analyze=True)`` can join them."""
        self.plan_steps.setdefault(index, {}).update(facts)


# ---------------------------------------------------------------------------
# module-level state: the off-by-default switch
# ---------------------------------------------------------------------------
_ACTIVE: Optional[Collector] = None


def current() -> Optional[Collector]:
    """The active collector, or ``None`` (telemetry off — the default)."""
    return _ACTIVE


@contextlib.contextmanager
def trace(name: str = "trace"):
    """Activate a fresh :class:`Collector` for the ``with`` body.

    Nested traces stack: the innermost collector receives the spans; the
    outer one resumes when the inner block exits.
    """
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, Collector(name)
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev


@contextlib.contextmanager
def using(rec: Collector):
    """Activate an EXISTING collector for the ``with`` body (the
    ``collect(telemetry=rec)`` path: the caller owns the collector and
    may activate it across several pipelines)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, rec
    try:
        yield rec
    finally:
        _ACTIVE = prev


def span(name: str, **attrs):
    """Open a span on the active collector — the shared no-op when
    telemetry is off or ``torch.compile`` is tracing."""
    rec = _ACTIVE
    if rec is None:
        return _NULL
    return rec.span(name, **attrs)


def traced(name: Optional[str] = None, **attrs):
    """Decorator form: run the function under a span, waiting for its
    result's device work so it is charged to the span that launched it."""

    def wrap(fn):
        label = name if name is not None else fn.__qualname__

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            rec = _ACTIVE
            if rec is None:
                return fn(*args, **kwargs)
            with rec.span(label, **attrs) as sp:
                out = fn(*args, **kwargs)
                sp.block(out)
            return out

        return inner

    return wrap


def _rows_of(value) -> Optional[int]:
    """Row count of the first table-like element of a value, if any.

    ``DistTable.num_rows()`` is a tensor on the table's device, so this
    reads it back (a synchronization) — callers run it only while a
    collector is active."""
    items = value if isinstance(value, (tuple, list)) else (value,)
    for v in items:
        if hasattr(v, "num_rows"):
            n = v.num_rows
            return int(n() if callable(n) else n)
    return None


def operator_call(name: str, fn, args, kwargs):
    """Span-wrapped operator invocation (the ``@operator`` hook).

    Only runs when a collector is active; skips entirely while
    ``torch.compile`` traces, so operators called inside a compiled
    region stay unperturbed.  Closes after synchronizing the outputs'
    devices and records rows in/out both as span attrs and as
    ``<name>.rows_*`` counters.
    """
    rec = _ACTIVE
    if rec is None or tracing():
        return fn(*args, **kwargs)
    with rec.span(name) as sp:
        out = fn(*args, **kwargs)
        sp.block(out)
        rows_in = _rows_of(args)
        rows_out = _rows_of(out)
        if rows_in is not None:
            sp.attrs["rows_in"] = rows_in
            rec.metrics.count(f"{name}.rows_in", rows_in)
        if rows_out is not None:
            sp.attrs["rows_out"] = rows_out
            rec.metrics.count(f"{name}.rows_out", rows_out)
        rec.metrics.count(f"{name}.calls", 1)
    return out
