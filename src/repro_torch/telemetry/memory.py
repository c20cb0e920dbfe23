"""Per-step memory accounting: RSS watermarks + an analytic live-bytes
model (reference DESIGN.md §14.2).

Two complementary views of a plan step's memory, both off-by-default:

  * **Observed** — the kernel's peak-RSS watermark (``VmHWM``) sampled
    before/after a step.  It is host memory only: the card's allocations
    do not show in it.  The watermark is monotone, so the delta is
    "how much this step pushed the process peak up": zero for a step
    that ran inside already-allocated headroom, positive exactly when
    the step set a new high-water mark.  Attribution, not accounting —
    deltas over a run sum to the run's total peak growth.
  * **Predicted** — :func:`step_live_bytes`, a deterministic analytic
    model over the packed-lane layout: every table row costs
    ``LANE_BYTES`` per column plus ``HASH_LANES`` carried hash lanes;
    an exchange stages a packed send + recv copy of its input; ordered
    operators add per-shard halo/carry buffers; spilled runs add their
    on-disk bytes (they transit host memory).  The model reads only
    static plan facts (estimated rows, schema widths), so ``explain()``
    can print it without running anything.

Both land on the same ``plan.<idx>.<op>`` spans / ``Collector.
plan_steps`` facts the cardinality audit uses, so ``explain
(analyze=True)`` joins predicted ``est_bytes`` against observed
``peak_rss_delta_kb`` per node.
"""
from __future__ import annotations

from typing import Optional

#: bytes per packed lane (everything tables move is 32-bit lanes)
LANE_BYTES = 4
#: (h1, h2) hash lanes carried alongside every row through exchanges
HASH_LANES = 2


# ---------------------------------------------------------------------------
# observed: /proc watermark sampling (host memory only)
# ---------------------------------------------------------------------------
def _status_kb(field: str) -> Optional[float]:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(field + ":"):
                    return float(line.split()[1])
    except OSError:
        pass
    return None


def rss_kb() -> Optional[float]:
    """Current resident set size in KB (``None`` off-Linux)."""
    return _status_kb("VmRSS")


def peak_rss_kb() -> Optional[float]:
    """Process peak RSS in KB — ``VmHWM`` with a rusage fallback."""
    kb = _status_kb("VmHWM")
    if kb is not None:
        return kb
    try:
        import resource

        return float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
    except Exception:
        return None


def reset_peak_rss() -> None:
    """Reset the kernel watermark (Linux ``clear_refs``; no-op elsewhere,
    where VmHWM stays a lifetime high-water mark and deltas only ever
    under-report — never over-report — per-region growth)."""
    try:
        with open("/proc/self/clear_refs", "w") as f:
            f.write("5")
    except OSError:
        pass


class RssWatermark:
    """Sample the peak-RSS watermark around a region.

    ``delta_kb`` after exit is the region's contribution to the process
    peak (0.0 when the region fit in existing headroom, or when the
    platform has no watermark to read).
    """

    __slots__ = ("before_kb", "delta_kb")

    def __enter__(self) -> "RssWatermark":
        self.before_kb = peak_rss_kb()
        self.delta_kb = 0.0
        return self

    def __exit__(self, *exc) -> None:
        after = peak_rss_kb()
        if self.before_kb is not None and after is not None:
            self.delta_kb = max(0.0, after - self.before_kb)


def publish_pressure(rec, prefix: str) -> None:
    """Publish current/peak RSS gauges under ``<prefix>.pressure.*`` —
    the memory-pressure evidence spill decisions and scans leave behind
    (a no-op for unreadable platforms)."""
    cur, peak = rss_kb(), peak_rss_kb()
    if cur is not None:
        rec.metrics.gauge(f"{prefix}.pressure.rss_mb",
                          round(cur / 1024.0, 1))
    if peak is not None:
        rec.metrics.gauge(f"{prefix}.pressure.peak_rss_mb",
                          round(peak / 1024.0, 1))


# ---------------------------------------------------------------------------
# predicted: the analytic live-bytes model
# ---------------------------------------------------------------------------
def row_bytes(n_cols: int) -> int:
    """Bytes one resident row costs in the packed-lane layout."""
    return LANE_BYTES * (int(n_cols) + HASH_LANES)


def step_live_bytes(op: str, *, rows_in: float = 0.0, rows_out: float = 0.0,
                    cols_in: int = 0, cols_out: int = 0, exchanges: int = 0,
                    n_shards: int = 1, spill_bytes: float = 0.0) -> int:
    """Deterministic live-bytes estimate for one physical plan step.

    input + output residency, plus per-exchange packed send/recv staging
    (each AllToAll materializes one packed copy of its input on each
    side), plus per-shard halo + carry rows for the ordered operators,
    plus any spill run bytes (on-disk runs transit host buffers).
    """
    base = rows_in * row_bytes(cols_in) + rows_out * row_bytes(cols_out)
    staged = 2.0 * exchanges * rows_in * row_bytes(cols_in)
    halo = 0.0
    if op in ("window", "orderby", "topk"):
        halo = 2.0 * max(1, n_shards) * row_bytes(cols_in)
    return int(base + staged + halo + spill_bytes)
