"""Stable text rendering of logical / optimized / physical plans.

The output is deterministic for a given (plan, context): node payloads
render through explicit per-kind formatters (never ``repr`` of objects
with memory addresses — callables render as ``<fn>``, datasets by their
fragment/column counts), so tests can assert exact substrings and two
renders of the same plan compare equal (reference DESIGN.md §11).  The
text is the JAX package's line for line.

One line differs: the reference's ``audit:`` footer closes with the
all-to-all bytes "in compiled HLO", and the port compiles no HLO.  What
the port can know is the count of calls of its exchange choke point
(``core.array_ops.EXCHANGES``), so the port's footer reads
``audit: predicted=<n> counted=<n> all_to_all at the exchange choke
point``; each exchanging step's line carries its payload bytes.  Only
``explain(analyze=True)`` renders the footer.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .logical import LogicalNode


def _fmt_preds(preds) -> str:
    if callable(preds):
        return "<fn>"
    return " AND ".join(f"{p.column}{p.op}{p.value!r}" for p in preds)


def _fmt_asc(keys, asc) -> str:
    return ",".join(k if a else f"{k}:desc" for k, a in zip(keys, asc))


def _describe(node: LogicalNode) -> str:
    p = node.payload
    k = node.kind
    if k == "source":
        return f"source[{p['name']}: {','.join(node.schema)}]"
    if k == "scan":
        ds = p["dataset"]
        s = f"scan[{len(ds.fragments)} fragments, cols={','.join(p['columns'])}"
        if p["predicate"]:
            s += f", predicate={_fmt_preds(p['predicate'])}"
        return s + "]"
    if k == "filter":
        return f"filter[{_fmt_preds(p['predicate'])}]"
    if k == "project":
        return f"project[{','.join(p['columns'])}]"
    if k == "join":
        s = f"join[{p['how']} on={','.join(p['keys'])}"
        if p["swap"]:
            s += ", swapped"
        return s + "]"
    if k == "groupby":
        aggs = ",".join(f"{c}_{op}" for c, op in p["aggs"])
        s = f"groupby[keys={','.join(p['keys'])} aggs={aggs}"
        if p["layout"] != "hash":
            s += f", layout={p['layout']}"
        return s + "]"
    if k == "orderby":
        return f"orderby[{_fmt_asc(p['by'], p['ascending'])}]"
    if k == "window":
        aggs = ",".join(f"{c}:{op}" if c else op
                        for c, op, *_ in p["aggs"])
        rows = p["rows"] if p["rows"] is not None else "cumulative"
        return (f"window[partition={','.join(p['partition_by'])} "
                f"order={_fmt_asc(p['order_by'], p['ascending'])} "
                f"aggs={aggs} rows={rows}]")
    if k == "topk":
        return f"topk[{_fmt_asc(p['by'], p['ascending'])} k={p['k']}]"
    if k == "repartition":
        return f"repartition[{p['mode']} keys={','.join(p['keys'])}]"
    return k  # pragma: no cover — exhaustive over node kinds


def render_tree(root: LogicalNode) -> str:
    lines: List[str] = []

    def walk(node: LogicalNode, depth: int) -> None:
        lines.append("  " * depth + _describe(node))
        for inp in node.inputs:
            walk(inp, depth + 1)

    walk(root, 0)
    return "\n".join(lines)


def plan_annotations(rec) -> Dict[int, Dict]:
    """Join a collector's measured facts back onto physical step indices.

    ``Collector.plan_steps`` carries what the instrumented plan observed
    (inclusive ``time_us``, ``rows_out``, ``a2a_bytes``); the span tree
    additionally yields each node's SELF time — its inclusive duration
    minus its direct ``plan.*`` children, so a parent is not charged for
    work its inputs did.
    """
    ann: Dict[int, Dict] = {i: dict(f) for i, f in rec.plan_steps.items()}
    for sp in rec.all_spans():
        parts = sp.name.split(".")
        if len(parts) < 3 or parts[0] != "plan":
            continue
        try:
            idx = int(parts[1])
        except ValueError:
            continue
        child_us = sum(c.dur_us for c in sp.children
                       if c.name.startswith("plan.")
                       and c.name != "plan.collect")
        ann.setdefault(idx, {})["self_us"] = sp.dur_us - child_us
        # SELF peak-rss growth: a monotone watermark charges a child's
        # rise to every enclosing step, so subtract direct plan children
        own = sp.attrs.get("peak_rss_delta_kb")
        if own is not None:
            child_kb = sum(c.attrs.get("peak_rss_delta_kb", 0.0)
                           for c in sp.children
                           if c.name.startswith("plan.")
                           and c.name != "plan.collect")
            ann[idx]["self_rss_kb"] = max(0.0, own - child_kb)
    return ann


def _fmt_est(v) -> str:
    """Deterministic short form of a row estimate (manifests only)."""
    if v is None:
        return "?"
    return f"{round(float(v), 1):g}"


def _fmt_annotation(a: Dict) -> str:
    bits = []
    if "self_us" in a:
        bits.append(f"time={a['self_us'] / 1e3:.3f}ms")
    if a.get("rows_out") is not None:
        bits.append(f"rows={a['rows_out']}")
    if "qerr" in a:
        bits.append(f"qerr={a['qerr']:.2f}")
    if "a2a_bytes" in a:
        bits.append(f"bytes={a['a2a_bytes']}")
    if a.get("self_rss_kb"):
        bits.append(f"rss=+{a['self_rss_kb']:.0f}KB")
    return "  [" + " ".join(bits) + "]" if bits else ""


def _memory_footer(plan, annotations: Dict[int, Dict]) -> Optional[str]:
    """Peak-memory attribution: predicted live bytes vs the observed
    watermark growth, naming the step that grew the peak most."""
    est_total = sum(s.est_bytes or 0 for s in plan.steps)
    deltas = {i: a.get("self_rss_kb", 0.0)
              for i, a in annotations.items()
              if a.get("self_rss_kb") is not None}
    if not deltas and not est_total:
        return None
    total_kb = sum(deltas.values())
    line = (f"  memory: est_live={est_total / 1024:.0f}KB "
            f"peak_rss_delta={total_kb:.0f}KB")
    if deltas and max(deltas.values()) > 0:
        top = max(deltas, key=deltas.get)
        op = next((s.op for s in plan.steps if s.index == top), "?")
        line += f" (top: {top}.{op} +{deltas[top]:.0f}KB)"
    return line


def render_physical(plan, annotations: Optional[Dict[int, Dict]] = None,
                    audit: Optional[Dict] = None) -> str:
    lines = []
    for s in plan.steps:
        det = f"  -- {s.detail}" if s.detail else ""
        line = (f"  {s.index:2d}. {s.op:<12} {s.strategy:<24} "
                f"all_to_all={s.a2a} est_rows={_fmt_est(s.est_rows)}{det}")
        if annotations is not None and s.index in annotations:
            line += _fmt_annotation(annotations[s.index])
        lines.append(line)
    lines.append(f"  predicted collectives: {plan.predicted_collectives} "
                 f"all_to_all on {plan.ctx.n_shards} shards "
                 f"(output layout: {plan.out_layout.describe()})")
    if annotations is not None:
        footer = _memory_footer(plan, annotations)
        if footer is not None:
            lines.append(footer)
    if audit is not None:
        lines.append(
            f"  audit: predicted={audit.get('predicted_a2a', '?')} "
            f"counted={audit['observed_a2a']} all_to_all at the exchange "
            f"choke point")
    return "\n".join(lines)


def render_explain(logical_root: LogicalNode, optimized_root: LogicalNode,
                   fired, plan,
                   annotations: Optional[Dict[int, Dict]] = None,
                   audit: Optional[Dict] = None) -> str:
    parts = ["== logical plan ==", render_tree(logical_root),
             "== rewrites =="]
    parts.append("  " + (", ".join(fired) if fired else "(none fired)"))
    parts += ["== optimized plan ==", render_tree(optimized_root),
              "== physical plan ==",
              render_physical(plan, annotations, audit)]
    return "\n".join(parts)
