"""Physical planner: lower an optimized logical plan to ONE program.

``PhysicalPlan`` walks the logical tree bottom-up and builds a single
closure over the eager ``table_ops`` engines — the whole pipeline then
runs as one call (the reference traces and jits it; the port calls it
eagerly, operator after operator, on the context's device), which is
what makes cross-operator layout reasoning sound: the planner tracks the
TRUE layout of every intermediate in a :class:`Layout` value and *sets
the partitioning stamp explicitly before each operator call*, so per-op
elision decisions are taken here, with whole-pipeline knowledge, not by
the operators' local metadata checks (reference DESIGN.md §11).  The
exchanges a run makes are counted at the choke point
(``core.array_ops.EXCHANGES``) and equal :attr:`PhysicalPlan.
predicted_collectives` — the reference's jaxpr ``all_to_all`` count.

Layout-driven strategies (the elision-proof catalog):

  join      a side whose TRUE layout is hash on exactly the join keys
            skips its shuffle (the eager §4 rule, applied transitively)
  groupby   ANY layout (hash or range) whose key SET equals the group
            keys proves equal key-combos co-located → grouping is purely
            local.  Placement survives: the output keeps the input's
            layout, which the per-call metadata stamp cannot express.
  orderby   input range-placed on the same keys/directions but locally
            unordered (e.g. a groupby ran on it) needs only a per-shard
            ``local_sort`` — zero AllToAll; an exact ordered match is a
            no-op
  window    input co-located on the partition keys (hash or range, any
            key order) ⇒ no partition straddles a shard ⇒ a local sort
            by ``partition_by + order_by`` replaces the range exchange.
            ``lead`` aggs are excluded: their truncation accounting
            reads downstream shards and can over-report on co-located
            layouts; they take the full exchange.
  groupby→orderby (rule "choose-range-layout"): the groupby exchanges by
            RANGE instead of hash; grouping elides by co-location and
            the orderby finishes with a local sort — one AllToAll where
            the eager chain pays two.

Identity contract: hash placement co-locates by the 32-bit *bit-pattern*
identity of ``hash_columns`` (``-0.0 != +0.0``; NaNs equal iff their
bits are), which is exactly the grouping/join identity — and the window
partition identity except for heterogeneous NaN bit patterns, which are
out of contract for hash layouts exactly as they are for the eager
hash join (reference DESIGN.md §8).

``inputs()`` (scan I/O) is lazy — ``explain()`` builds a full physical
plan, with per-scan pushdown detail, without reading a single data page.

On a process group every rank lowers the same plan (the estimates read
source tables' global row counts) and runs it on its own shards.  A run
starts with one small all-gather that tells every rank whether any rank
has a ``plan.step.<i>`` fault armed; only then does each step agree on
its fault site, so a fault raises on every rank and never leaves a rank
waiting in the step's exchange.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .. import telemetry
from ..core import table_ops
from ..core.table import (DistTable, partitioning_ascending,
                          partitioning_keys, partitioning_kind,
                          range_partitioning)

from .logical import LogicalNode

_FLIP = {"inner": "inner", "left": "right", "right": "left",
         "outer": "outer"}


@dataclasses.dataclass(frozen=True)
class Layout:
    """TRUE physical layout of an intermediate (vs. the metadata stamp).

    ``kind="hash"``: rows placed by ``hash(keys) % n`` (genuine, ordered
    tuple).  ``kind="range"``: shards hold disjoint contiguous key
    ranges; ``ordered=True`` adds that rows are ALSO locally sorted, so
    the table is globally sorted (the full ``("range", ...)`` stamp).
    ``ordered=False`` keeps only the placement half — co-location
    evidence no metadata stamp can carry.
    """
    kind: str = "none"  # none | hash | range
    keys: Tuple[str, ...] = ()
    ascending: Tuple[bool, ...] = ()
    ordered: bool = False

    def describe(self) -> str:
        if self.kind == "none":
            return "none"
        d = f"{self.kind}({','.join(self.keys)})"
        if self.kind == "range":
            d += "+sorted" if self.ordered else "+placed"
        return d


def _from_stamp(part) -> Layout:
    kind = partitioning_kind(part)
    if kind == "hash":
        return Layout("hash", tuple(partitioning_keys(part)))
    if kind == "range":
        return Layout("range", tuple(partitioning_keys(part)),
                      tuple(partitioning_ascending(part)), True)
    return Layout()


def _to_stamp(layout: Layout, n: int):
    """The honest metadata stamp for a layout (coloc-only → None)."""
    if layout.kind == "hash":
        return (layout.keys, n)
    if layout.kind == "range" and layout.ordered:
        return range_partitioning(layout.keys, layout.ascending, n)
    return None


def _coloc(layout: Layout, keys) -> bool:
    """Equal key-combos provably on one shard (any key order)."""
    return (layout.kind in ("hash", "range") and len(keys) > 0
            and set(layout.keys) == set(keys))


def _hash_exact(layout: Layout, keys) -> bool:
    return layout.kind == "hash" and layout.keys == tuple(keys)


def _restamp(dt: DistTable, part) -> DistTable:
    return DistTable(dt.columns, dt.counts, part, dt.group)


@dataclasses.dataclass(frozen=True)
class PlanStep:
    """One physical operator: strategy + predicted AllToAll count.

    ``stage`` marks an exchange boundary — a step whose strategy moves
    rows between shards (pre-clamp, so single-shard runs keep the same
    stage structure).  Stage steps are where ``collect(policy=...)``
    commits lineage checkpoints (reference DESIGN.md §13.2).

    ``est_rows`` / ``est_bytes`` are the planner's deterministic
    predictions (manifest cardinality estimate + the packed-lane
    live-bytes model, reference DESIGN.md §14) that the op-by-op
    instrumentation audits against observed ``rows_out`` /
    ``peak_rss_delta_kb``.
    """
    index: int
    op: str
    strategy: str
    a2a: int
    detail: str = ""
    stage: bool = False
    est_rows: Optional[float] = None
    est_bytes: Optional[int] = None


class PhysicalPlan:
    """Lowered pipeline: ``fn(*inputs)`` runs everything in one call.

    ``fn`` returns ``(DistTable, {step_label: overflow_scalar})``;
    ``inputs()`` materializes leaf tables (scan I/O happens here, and only
    here).  ``steps`` carries the per-operator strategy and predicted
    collective count that ``explain()`` renders and the plan-contract
    tests assert against the exchange counter.
    """

    def __init__(self, root: LogicalNode, ctx):
        self.ctx = ctx
        self.root = root
        self.steps: List[PlanStep] = []
        self._input_specs: List[Tuple[str, object]] = []
        self._materialized: Optional[Tuple[DistTable, ...]] = None
        self.scan_overflow = 0
        # resilience hook: when set (collect(policy=...)), stage-boundary
        # steps route through it — restore a committed snapshot (skipping
        # the whole subtree) or run + commit.  None (the default) keeps
        # the executed program the hookless one.
        self.stage_hook = None
        self._chaos = False  # a plan.step fault armed on some rank (fn)
        self._est_cache: Dict[int, float] = {}
        run, layout = self._lower(root)
        self.out_layout = layout
        self._run = run

    # -- public surface ----------------------------------------------------
    @property
    def predicted_collectives(self) -> int:
        return sum(s.a2a for s in self.steps)

    def inputs(self) -> Tuple[DistTable, ...]:
        if self._materialized is None:
            tables, overflow = [], 0
            for kind, obj in self._input_specs:
                if kind == "table":
                    tables.append(obj)
                else:  # scan
                    dt, ov = obj.to_dist_table()
                    overflow += int(ov)
                    tables.append(dt)
            self.scan_overflow = overflow
            self._materialized = tuple(tables)
        return self._materialized

    def fn(self, *tables) -> Tuple[DistTable, Dict[str, torch.Tensor]]:
        from ..core.array_ops import gather_objects
        from ..resilience import faults

        group = self.ctx.group
        self._chaos = group is not None and any(
            gather_objects(faults.armed("plan.step."), group))
        out, ovs = self._run(tables)
        out = _restamp(out, _to_stamp(self.out_layout, self.ctx.n_shards))
        return out, dict(ovs)

    # -- lowering ----------------------------------------------------------
    def _step(self, op: str, strategy: str, a2a: int,
              detail: str = "") -> PlanStep:
        stage = a2a > 0  # exchange boundary — judged before the clamp so
        # a 1-shard run checkpoints at the same stages as a 4-shard one
        if self.ctx.n_shards == 1:
            a2a = 0  # single shard: every exchange is local
        s = PlanStep(len(self.steps), op, strategy, a2a, detail, stage)
        self.steps.append(s)
        return s

    def _lower(self, node: LogicalNode) -> Tuple[Callable, Layout]:
        run, layout = getattr(self, f"_lower_{node.kind}")(node)
        # every _lower_* appends its own step LAST, so steps[-1] here is
        # the node just lowered (children were appended before it)
        step = self._annotate(self.steps[-1], node)
        run = self._instrument(run, step, layout)
        return self._resilient(run, step, layout), layout

    def _annotate(self, step: PlanStep, node: LogicalNode) -> PlanStep:
        """Stamp the step with its predicted cardinality and live bytes
        (manifests + schema widths only — deterministic, no data read).
        Safe to replace in-place: run closures capture only the index."""
        from ..telemetry import memory as M

        from .rules import estimated_rows

        est = estimated_rows(node, self._est_cache)
        rows_in = sum(estimated_rows(i, self._est_cache)
                      for i in node.inputs)
        cols_in = max((len(i.schema) for i in node.inputs), default=0)
        est_bytes = M.step_live_bytes(
            step.op, rows_in=rows_in, rows_out=est, cols_in=cols_in,
            cols_out=len(node.schema), exchanges=step.a2a,
            n_shards=self.ctx.n_shards)
        step = dataclasses.replace(step, est_rows=est, est_bytes=est_bytes)
        self.steps[step.index] = step
        return step

    def _resilient(self, run: Callable, step: PlanStep,
                   layout: Layout) -> Callable:
        """Per-node fault-injection + stage-checkpoint wrapper.

        Always fires the ``plan.step.<idx>`` chaos site (a cheap no-op
        unless a fault is armed; on a group where ``fn`` found one armed
        on some rank, one small all-gather a step, so it raises on every
        rank).  With a ``stage_hook`` installed and the step at an
        exchange boundary, the hook decides: restore a committed snapshot
        — the child closures never run, so a resumed run executes only
        the suffix — or run and commit.
        """
        from ..core.array_ops import raise_together
        from ..resilience import faults

        def wrapped(tables):
            if not self._chaos:
                faults.fire(f"plan.step.{step.index}")
            else:
                err = None
                try:
                    faults.fire(f"plan.step.{step.index}")
                except Exception as e:  # noqa: BLE001 — every rank raises
                    err = e
                raise_together(err, self.ctx.group)
            hook = self.stage_hook
            if hook is None or not step.stage:
                return run(tables)
            return hook(step, layout, lambda: run(tables))

        return wrapped

    def _instrument(self, run: Callable, step: PlanStep,
                    layout: Layout) -> Callable:
        """Per-node telemetry wrapper.

        Inert unless a collector is active (and never while
        ``torch.compile`` traces).  When live, each node becomes a
        ``plan.<index>.<op>`` span (children nested inside), closed after
        the card finished its outputs, and its measured time, rows and
        host-RSS growth land in ``Collector.plan_steps`` for
        ``explain(analyze=True)`` to join against the predicted steps.
        """
        label = f"plan.{step.index}.{step.op}"

        def wrapped(tables):
            from ..telemetry import memory as M

            rec = telemetry.current()
            if rec is None or telemetry.tracing():
                return run(tables)
            with M.RssWatermark() as wm:
                with rec.span(label, op=step.op, strategy=step.strategy,
                              a2a=step.a2a, layout=layout.describe(),
                              est_rows=step.est_rows,
                              est_bytes=step.est_bytes) as sp:
                    out, ovs = run(tables)
                    sp.block(out)
                    rows = telemetry.record._rows_of(out)
                    if rows is not None:
                        sp.attrs["rows_out"] = rows
            sp.attrs["peak_rss_delta_kb"] = wm.delta_kb
            rec.observe_step(step.index, time_us=sp.dur_us, rows_out=rows,
                             peak_rss_delta_kb=wm.delta_kb)
            return out, ovs

        return wrapped

    def _lower_source(self, node: LogicalNode):
        dt: DistTable = node.payload["table"]
        idx = len(self._input_specs)
        self._input_specs.append(("table", dt))
        layout = _from_stamp(dt.partitioning)
        self._step("source", node.payload["name"], 0,
                   f"layout={layout.describe()}")
        return (lambda tables: (tables[idx], [])), layout

    def _lower_scan(self, node: LogicalNode):
        from ..io.scan import ScanSource

        p = node.payload
        src = ScanSource(p["dataset"], ctx=self.ctx, columns=p["columns"],
                         predicate=p["predicate"], capacity=p["capacity"],
                         bucket_factor=p["bucket_factor"],
                         allow_narrowing=p["allow_narrowing"],
                         on_error=p.get("on_error", "raise"))
        idx = len(self._input_specs)
        self._input_specs.append(("scan", src))
        layout = _from_stamp(src.partitioning)
        st = src.stats
        kept = st.row_groups_total - st.row_groups_skipped
        self._step(
            "scan", "pushdown", 0,
            f"cols {len(src.read_columns)}/{st.columns_total}, "
            f"fragments {kept}/{st.row_groups_total}, "
            f"rows<={src.planned_rows}, layout={layout.describe()}")
        return (lambda tables: (tables[idx], [])), layout

    def _lower_filter(self, node: LogicalNode):
        crun, clay = self._lower(node.inputs[0])
        pred = node.payload["predicate"]
        if callable(pred):
            mask_fn, desc = pred, "callable"
        else:
            def mask_fn(cols, _ps=pred):
                m = _ps[0].mask(cols)
                for q in _ps[1:]:
                    m = m & q.mask(cols)
                return m
            desc = " AND ".join(f"{q.column}{q.op}{q.value!r}"
                                for q in pred)
        step = self._step("filter", "local", 0, desc)
        n = self.ctx.n_shards

        def run(tables, _step=step):
            t, ovs = crun(tables)
            out = table_ops.select(_restamp(t, _to_stamp(clay, n)),
                                   mask_fn, ctx=self.ctx)
            return out, ovs

        # filtering keeps placement AND local order (stable compaction)
        return run, clay

    def _lower_project(self, node: LogicalNode):
        crun, clay = self._lower(node.inputs[0])
        cols = node.payload["columns"]
        keeps = clay.kind != "none" and set(clay.keys) <= set(cols)
        out_layout = clay if keeps else Layout()
        self._step("project", "local", 0, ",".join(cols))
        n = self.ctx.n_shards

        def run(tables):
            t, ovs = crun(tables)
            out = table_ops.project(_restamp(t, _to_stamp(clay, n)),
                                    cols, ctx=self.ctx)
            return out, ovs

        return run, out_layout

    def _lower_join(self, node: LogicalNode):
        lrun, llay = self._lower(node.inputs[0])
        rrun, rlay = self._lower(node.inputs[1])
        p = node.payload
        keys, how, swap = p["keys"], p["how"], p["swap"]
        mm, method, kw = p["max_matches"], p["method"], dict(p["kw"])
        out_capacity = kw.pop("out_capacity", None)
        elide_l = _hash_exact(llay, keys)
        elide_r = _hash_exact(rlay, keys)
        a2a = int(not elide_l) + int(not elide_r)
        n = self.ctx.n_shards
        lsch, rsch = node.inputs[0].schema, node.inputs[1].schema
        dups = [c for c in lsch if c in rsch and c not in keys]
        rename = {}
        if swap:
            rename = {c: f"{c}_r" for c in dups}
            rename.update({f"{c}_r": c for c in dups})
        parts = [w for w, e in (("left", elide_l), ("right", elide_r))
                 if e]
        strategy = ("elide-" + "+".join(parts)) if parts else "shuffle"
        if swap:
            strategy += ",swap"
        step = self._step("join", strategy, a2a,
                          f"keys={','.join(keys)} how={how}")

        def run(tables, _label=f"{step.index}.join"):
            lt, lov = lrun(tables)
            rt, rov = rrun(tables)
            lt = _restamp(lt, (keys, n) if elide_l else _to_stamp(llay, n))
            rt = _restamp(rt, (keys, n) if elide_r else _to_stamp(rlay, n))
            # keep the output capacity of the ORIGINAL orientation so a
            # swapped join is shape-identical to the eager call
            cap = out_capacity if out_capacity is not None else \
                max(lt.capacity, 1) * mm + (
                    max(rt.capacity, 1) if how in ("right", "outer")
                    else 0)
            if swap:
                out, ov = table_ops.join(
                    rt, lt, keys, ctx=self.ctx, how=_FLIP[how],
                    max_matches=mm, method=method, out_capacity=cap, **kw)
                out = DistTable(
                    {rename.get(c, c): v for c, v in out.columns.items()},
                    out.counts, out.partitioning, out.group)
            else:
                out, ov = table_ops.join(
                    lt, rt, keys, ctx=self.ctx, how=how, max_matches=mm,
                    method=method, out_capacity=cap, **kw)
            return out, lov + rov + [(_label, ov)]

        return run, Layout("hash", tuple(keys))

    def _lower_groupby(self, node: LogicalNode):
        crun, clay = self._lower(node.inputs[0])
        p = node.payload
        keys, aggs, kw = p["keys"], p["aggs"], dict(p["kw"])
        n = self.ctx.n_shards
        if _coloc(clay, keys):
            strategy, a2a = "elide(co-located)", 0
            # grouping keeps rows on their shard: placement survives,
            # local order does not
            out_layout = dataclasses.replace(clay, ordered=False) \
                if clay.kind == "range" else clay
            pre, stamp_in = None, (tuple(keys), n)
        elif p["layout"] == "range":
            strategy, a2a = "range-exchange", 1
            asc = tuple(p["layout_ascending"])
            out_layout = Layout("range", tuple(keys), asc, False)

            def pre(t, _asc=asc):
                return table_ops.orderby(t, keys, ctx=self.ctx,
                                         ascending=_asc)
            stamp_in = (tuple(keys), n)  # range-placed ⇒ co-located
        else:
            strategy, a2a = "hash-exchange", 1
            out_layout = Layout("hash", tuple(keys))
            pre, stamp_in = None, None
        step = self._step("groupby", strategy, a2a,
                          f"keys={','.join(keys)}")

        def run(tables, _label=f"{step.index}.groupby"):
            t, ovs = crun(tables)
            t = _restamp(t, _to_stamp(clay, n))
            if pre is not None:
                t, ov0 = pre(t)
                ovs = ovs + [(f"{step.index}.groupby.exchange", ov0)]
            if stamp_in is not None:
                t = _restamp(t, stamp_in)
            out, ov = table_ops.groupby_aggregate(t, keys, aggs,
                                                  ctx=self.ctx, **kw)
            return out, ovs + [(_label, ov)]

        return run, out_layout

    def _lower_orderby(self, node: LogicalNode):
        crun, clay = self._lower(node.inputs[0])
        keys = tuple(node.payload["by"])
        asc = tuple(node.payload["ascending"])
        n = self.ctx.n_shards
        target = Layout("range", keys, asc, True)
        part = range_partitioning(keys, asc, n)
        if clay == target:
            strategy, a2a = "elide(sorted)", 0
        elif clay.kind == "range" and clay.keys == keys \
                and clay.ascending == asc:
            strategy, a2a = "local-sort", 0
        else:
            strategy, a2a = "range-exchange", 1
        step = self._step("orderby", strategy, a2a,
                          f"by={','.join(keys)}")

        def run(tables, _label=f"{step.index}.orderby"):
            t, ovs = crun(tables)
            if strategy == "elide(sorted)":
                return _restamp(t, part), ovs
            if strategy == "local-sort":
                out, ov = table_ops.local_sort(
                    _restamp(t, None), keys, ctx=self.ctx, ascending=asc,
                    partitioning=part)
            else:
                out, ov = table_ops.orderby(
                    _restamp(t, _to_stamp(clay, n)), keys, ctx=self.ctx,
                    ascending=asc)
            return out, ovs + [(_label, ov)]

        return run, target

    def _lower_window(self, node: LogicalNode):
        from ..window import normalize_aggs

        crun, clay = self._lower(node.inputs[0])
        p = node.payload
        pkeys = tuple(p["partition_by"])
        okeys, asc_o = tuple(p["order_by"]), tuple(p["ascending"])
        aggs, rows = p["aggs"], p["rows"]
        keys = pkeys + okeys
        asc = (True,) * len(pkeys) + asc_o
        n = self.ctx.n_shards
        part = range_partitioning(keys, asc, n)
        norm = normalize_aggs(aggs, node.inputs[0].schema, rows)
        has_lead = any(op == "lead" for _, _, op, _ in norm)
        target = Layout("range", keys, asc, True)
        if clay == target:
            strategy, a2a = "elide(sorted)", 0
            out_layout = target
        elif _coloc(clay, pkeys) and not has_lead:
            strategy, a2a = "local-sort(co-located)", 0
            if clay.kind == "range" and clay.keys == pkeys \
                    and clay.ascending == (True,) * len(pkeys):
                # shards hold ascending contiguous pkey ranges AND rows
                # are now locally (pkeys, okeys)-sorted → globally sorted
                out_layout = target
            elif clay.kind == "range":
                out_layout = dataclasses.replace(clay, ordered=False)
            else:
                out_layout = clay
        else:
            strategy, a2a = "range-exchange", 1
            out_layout = target
        step = self._step(
            "window", strategy, a2a,
            f"partition={','.join(pkeys)} order={','.join(okeys)}")

        def run(tables, _label=f"{step.index}.window"):
            t, ovs = crun(tables)
            if strategy == "elide(sorted)":
                t = _restamp(t, part)
            elif strategy == "local-sort(co-located)":
                # no partition straddles a shard, so a per-shard sort
                # establishes the full (pkeys, okeys) order; the range
                # stamp below is a RELABEL consumed only by the window's
                # need_sort check (halo/carry chains never link: equal
                # partition keys cannot sit on two shards)
                t, _ = table_ops.local_sort(_restamp(t, None), keys,
                                            ctx=self.ctx, ascending=asc,
                                            partitioning=part)
            else:
                t = _restamp(t, _to_stamp(clay, n))
            out, ov = table_ops.window_aggregate(
                t, pkeys, okeys, aggs, ctx=self.ctx, rows=rows,
                ascending=asc_o)
            return out, ovs + [(_label, ov)]

        return run, out_layout

    def _lower_topk(self, node: LogicalNode):
        crun, clay = self._lower(node.inputs[0])
        p = node.payload
        keys, asc, k = tuple(p["by"]), tuple(p["ascending"]), p["k"]
        n = self.ctx.n_shards
        self._step("topk", "tree-reduce", 0, f"by={','.join(keys)} k={k}")

        def run(tables):
            t, ovs = crun(tables)
            out = table_ops.topk(_restamp(t, _to_stamp(clay, n)), keys, k,
                                 ctx=self.ctx, ascending=asc)
            return out, ovs

        return run, Layout("range", keys, asc, True)

    def _lower_repartition(self, node: LogicalNode):
        p = node.payload
        if p["mode"] == "range":
            # identical semantics to orderby (DataFrame.repartition
            # delegates to sort_values)
            return self._lower_orderby(LogicalNode(
                "orderby", node.inputs,
                {"by": p["keys"], "ascending": p["ascending"]},
                node.schema))
        crun, clay = self._lower(node.inputs[0])
        keys = tuple(p["keys"])
        n = self.ctx.n_shards
        if _hash_exact(clay, keys):
            strategy, a2a = "elide(placed)", 0
        else:
            strategy, a2a = "hash-exchange", 1
        step = self._step("repartition", strategy, a2a,
                          f"keys={','.join(keys)}")

        def run(tables, _label=f"{step.index}.repartition"):
            t, ovs = crun(tables)
            if strategy == "elide(placed)":
                return _restamp(t, (keys, n)), ovs
            out, ov = table_ops.shuffle(_restamp(t, _to_stamp(clay, n)),
                                        keys, ctx=self.ctx)
            return out, ovs + [(_label, ov)]

        return run, Layout("hash", keys)
