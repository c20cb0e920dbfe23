"""LazyFrame: the deferred twin of :class:`repro_torch.dataframe.DataFrame`.

``DataFrame.lazy()`` (or :meth:`LazyFrame.read_parquet`) starts an
expression graph; chained operators only build :mod:`plan.logical`
nodes.  ``.collect()`` optimizes the graph (``plan.rules``), lowers it
to one program (``plan.physical``) and runs it; ``.explain()`` renders
logical → optimized → physical without reading any data.  The eager
DataFrame stays the parity oracle: ``lazy().collect()`` gives the same
rows as the same eager chain, it just moves less data (reference
DESIGN.md §11).

The runtime services ride on ``collect``: ``telemetry=`` (spans, the
planner-vs-choke-point exchange audit, q-errors), ``ledger=`` (one JSONL
run record), ``qerror_threshold=`` (the enforced cardinality contract)
and ``policy=`` (stage checkpoints and resume); ``refine()`` re-takes
join-order decisions from observed rows and ``explain(analyze=True)``
annotates every step with what a run measured.

On a context with a process group every rank builds and collects the
same plan over its own shards.  Every decision is taken from values the
same on every rank — the estimates and observed rows are the group's
(``DistTable.num_rows`` is a collective), so the rules, the audit, the
q-error threshold and ``refine()`` fire alike everywhere, and
``explain()`` renders the virtual run's text; the whole-plan retry and
stage commits are agreed across the ranks, the stage directory is one
the group shares, and rank 0 alone appends to the ``ledger``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from ..core.report import OverflowError, OverflowReport

from . import logical as L
from .explain import plan_annotations, render_explain
from .physical import PhysicalPlan
from .rules import optimize


class PlanAuditError(RuntimeError):
    """The planner's predicted all-to-all count and the exchanges counted
    at the choke point (``core.array_ops.EXCHANGES``) disagree — the plan
    contract (reference DESIGN.md §11/§12) is broken.  Raised by
    ``collect(telemetry=..., strict=True)``."""


class LazyFrame:
    """A logical plan + context; every operator returns a new LazyFrame."""

    def __init__(self, node: L.LogicalNode, ctx,
                 report: Optional[OverflowReport] = None):
        self._node = node
        self._ctx = ctx
        self._report = report if report is not None else OverflowReport()

    # -- construction ------------------------------------------------------
    @classmethod
    def read_parquet(cls, path: str, ctx, *,
                     columns: Optional[Sequence[str]] = None,
                     predicate=None, capacity: Optional[int] = None,
                     bucket_factor: float = 1.0,
                     allow_narrowing: bool = False,
                     on_error: str = "raise") -> "LazyFrame":
        """Lazy dataset scan (Parquet or ``.hpt``): only metadata is read
        here; pushed-down predicates/projections land in the physical
        scan at ``collect()`` time.  ``on_error="quarantine"`` skips
        corrupt fragments at scan time instead of raising (recorded in
        scan stats + the dataset's quarantine sidecar)."""
        return cls(L.scan(path, columns=columns, predicate=predicate,
                          capacity=capacity, bucket_factor=bucket_factor,
                          allow_narrowing=allow_narrowing,
                          on_error=on_error), ctx)

    read_dataset = read_parquet  # format-neutral alias

    # -- metadata ----------------------------------------------------------
    @property
    def columns(self) -> Tuple[str, ...]:
        return self._node.schema

    @property
    def logical_plan(self) -> L.LogicalNode:
        return self._node

    def _chain(self, node: L.LogicalNode, *others: "LazyFrame"
               ) -> "LazyFrame":
        rep = OverflowReport().merge(self._report)
        for o in others:
            rep.merge(o._report)
        return LazyFrame(node, self._ctx, rep)

    # -- operators (all deferred) ------------------------------------------
    def filter(self, predicate) -> "LazyFrame":
        """Row filter: ``pred()`` tuples / ``(col, op, value)`` triples
        (visible to the rewriter: pushed through joins and into scans) or
        a callable ``cols -> mask`` (opaque, never pushed)."""
        return self._chain(L.filter_(self._node, predicate))

    select = filter  # eager-API name (callable predicate form)

    def project(self, columns) -> "LazyFrame":
        return self._chain(L.project(self._node, columns))

    def join(self, other: "LazyFrame", on, how: str = "inner", *,
             method: str = "auto", max_matches: int = 1,
             reorder: bool = False, **kw) -> "LazyFrame":
        """Deferred equi-join (same semantics as the eager ``join``).

        ``reorder=True`` lets the optimizer swap the inputs so the
        smaller estimated side becomes the hash build side (rule
        ``reorder-join-inputs``).  Off by default: ``table_ops.join``
        caps fan-out per LEFT row, so swapping changes which side
        ``max_matches`` caps and overflow accounting could diverge from
        the eager oracle — opt in only when the cap cannot bind.
        """
        if not isinstance(other, LazyFrame):
            raise TypeError(f"join expects a LazyFrame (got "
                            f"{type(other).__name__}); call .lazy() first")
        return self._chain(
            L.join(self._node, other._node, on, how=how,
                   max_matches=max_matches, method=method,
                   reorder=reorder, **kw), other)

    def groupby(self, keys, aggs, **kw) -> "LazyFrame":
        return self._chain(L.groupby(self._node, keys, aggs, **kw))

    def repartition(self, keys, mode: str = "hash",
                    ascending=True) -> "LazyFrame":
        return self._chain(L.repartition(self._node, keys, mode=mode,
                                         ascending=ascending))

    def sort_values(self, by, ascending=True) -> "LazyFrame":
        return self._chain(L.orderby(self._node, by, ascending=ascending))

    def window(self, partition_by, order_by, ascending=True) -> "LazyWindow":
        return LazyWindow(self, partition_by, order_by, ascending)

    def rank(self, partition_by, order_by, ascending=True) -> "LazyFrame":
        return self._chain(L.window(
            self._node, partition_by, order_by,
            [(None, "rank"), (None, "row_number")], ascending=ascending))

    def topk(self, by, k: int, largest: bool = True,
             ascending=None) -> "LazyFrame":
        if ascending is None:
            ascending = not largest
        return self._chain(L.topk(self._node, by, k, ascending=ascending))

    # -- execution ---------------------------------------------------------
    def physical_plan(self) -> PhysicalPlan:
        """Optimize + lower without running (no data I/O): the
        ``plan.fn`` / ``plan.inputs()`` pair the contract tests run under
        the exchange counter."""
        root, _ = optimize(self._node)
        return PhysicalPlan(root, self._ctx)

    def collect(self, *, strict: bool = True, jit: bool = True,
                telemetry=None, policy=None, qerror_threshold=None,
                ledger=None):
        """Optimize, lower, run; returns an eager :class:`DataFrame`.

        One program executes the whole pipeline.  ``jit`` keeps the
        reference's keyword, which compiles the program there; the port
        runs the same eager program either way (no ``torch.compile``:
        the kernels are the hand-written ones the operators launch).
        Overflow from any step lands in the result's ``overflow_report``
        under ``plan.<step>`` labels and raises unless ``strict=False`` —
        the same contract as the eager operators.

        ``telemetry`` accepts a :class:`repro_torch.telemetry.Collector`:
        the run then records a ``plan.<index>.<op>`` span per physical
        node (the port always runs op by op), publishes the
        plan-vs-observed exchange audit (predicted == counted at the
        choke point; a mismatch raises :class:`PlanAuditError` under
        ``strict=True``), and files the predicted facts of every step
        (strategy, ``est_rows``, ``est_bytes``) next to its measured
        ones.  Per-step q-errors are always recorded when observations
        exist; ``qerror_threshold`` (a float) additionally ENFORCES them
        under ``strict=True``: any step whose estimate misses observed
        rows by more than the threshold raises
        :class:`~repro_torch.telemetry.cardinality.CardinalityAuditError`.

        ``ledger`` names a JSONL file: the run appends one record keyed
        by its plan fingerprint (wall time, metrics, q-errors, memory
        watermark — reference DESIGN.md §14.3).

        ``policy`` accepts a :class:`repro_torch.resilience.FaultPolicy`
        and switches on fault-tolerant execution (reference DESIGN.md
        §13): scan reads and the whole-plan run retry with backoff, and —
        when the policy carries a ``checkpoint_dir`` — every
        exchange-boundary stage commits a CRC-checked snapshot keyed by
        the plan's fingerprint, so a crashed/killed collect resumes from
        the last committed stage and re-runs only the suffix, bit-exact.
        Without a policy this path adds nothing — no stage I/O.
        """
        import time

        from ..dataframe.frame import DataFrame

        root, _ = optimize(self._node)
        plan = PhysicalPlan(root, self._ctx)
        fingerprint = None
        if policy is not None or ledger is not None:
            from ..resilience import stages as S

            fingerprint = S.plan_fingerprint(root, self._ctx)
        t0 = time.perf_counter()
        if policy is not None:
            out, ovs = self._collect_resilient(plan, policy, telemetry,
                                               fingerprint)
        elif telemetry is not None:
            out, ovs = self._collect_audited(plan, telemetry,
                                             strict=strict)
        else:
            out, ovs = plan.fn(*plan.inputs())
        wall_s = time.perf_counter() - t0
        report = OverflowReport().merge(self._report)
        report.add("plan.scan.capacity", plan.scan_overflow)
        for label, v in sorted(ovs.items()):
            report.add(f"plan.{label}", int(v))
        if telemetry is not None:
            from ..telemetry import cardinality as C

            telemetry.record_overflow(report)
            C.record_qerrors(telemetry)
        if ledger is not None and self._ctx.rank == 0:
            from ..telemetry import ledger as Led

            Led.append(ledger, Led.collect_record(
                telemetry, fingerprint=fingerprint, wall_s=wall_s))
        if strict and not report.is_exact():
            detail = ", ".join(f"{k}={v}" for k, v in report)
            raise OverflowError(
                f"planned pipeline overflowed static capacity ({detail}) "
                f"— re-run with larger capacities, or collect(strict=False)")
        if telemetry is not None and strict and qerror_threshold is not None:
            C.audit_cardinality(telemetry, qerror_threshold)
        return DataFrame(out, self._ctx, report)

    def refine(self, rec) -> "LazyFrame":
        """Re-optimize join order from OBSERVED cardinalities (opt-in).

        ``rec`` is the collector of a prior ``collect(telemetry=rec)`` of
        THIS pipeline: physical steps are appended in the same post-order
        the optimized logical tree walks, so step ``i``'s observed
        ``rows_out`` belongs to post-order node ``i``.  Every inner join
        that opted into reordering (``reorder=True``) has its swap
        decision re-taken from the observed input rows — under the same
        rename-safety guard as the estimate-based rule — and PINNED
        (``reorder=False``), so the estimate rule cannot undo the
        observed decision on the next ``collect()``.  Joins without
        observations (a different pipeline) are left untouched.  Parity
        holds by the same argument as the rewrite rule: a swap only
        changes which side hashes first.
        """
        root, _ = optimize(self._node)
        obs = {}
        for i, node in enumerate(L.walk(root)):
            rows = rec.plan_steps.get(i, {}).get("rows_out")
            if rows is not None:
                obs[id(node)] = int(rows)

        def rebuild(node):
            kids = tuple(rebuild(i) for i in node.inputs)
            out = node if kids == node.inputs else node.with_inputs(*kids)
            if node.kind != "join" or node.payload["how"] != "inner" \
                    or not node.payload["reorder"]:
                return out
            lo = obs.get(id(node.inputs[0]))
            ro = obs.get(id(node.inputs[1]))
            if lo is None or ro is None:
                return out
            swap = lo < ro
            if swap:
                keys = node.payload["keys"]
                left, right = node.inputs
                dups = [c for c in left.schema
                        if c in right.schema and c not in keys]
                names = set(left.schema) | set(right.schema)
                if any(f"{c}_r" in names for c in dups):
                    return out  # rename would collide: keep as-is
            return out.with_payload(swap=swap, reorder=False)

        return LazyFrame(rebuild(root), self._ctx,
                         OverflowReport().merge(self._report))

    def _collect_resilient(self, plan: PhysicalPlan, policy, rec,
                           fingerprint: str):
        """Run ``plan`` under ``policy``: scan retries, stage
        checkpoints at exchange boundaries, whole-plan retry, and
        resume-from-last-committed-stage on restart (reference DESIGN.md
        §13.2).  A restored stage replaces its whole subtree — the
        re-executed program is exactly the plan suffix after the last
        commit.
        """
        import contextlib
        import shutil

        from .. import telemetry as T
        from ..core.array_ops import barrier, on_rank0, shared_tempdir
        from ..resilience import stages as S

        for kind, obj in plan._input_specs:
            if kind == "scan":  # route transient-read retries to scans
                obj.policy = policy

        group = self._ctx.group
        tmp_root = None
        ckpt_root = policy.checkpoint_dir
        if ckpt_root is None:
            # stages still give in-process retry memoization; without a
            # durable dir they simply cannot survive a process death
            tmp_root = shared_tempdir("hptmt-stages-", group=group)
            ckpt_root = tmp_root
        ckpt = S.StageCheckpointer(ckpt_root, fingerprint, group)
        committed = set(ckpt.committed_stages())
        resumed_from = max(committed) if committed else None
        plan.stage_hook = S.stage_hook(ckpt, policy=policy, ctx=self._ctx,
                                       committed=committed, record=rec)
        active = T.using(rec) if rec is not None else \
            contextlib.nullcontext()
        try:
            with active:
                if rec is not None:
                    for s in plan.steps:
                        rec.observe_step(s.index, op=s.op,
                                         strategy=s.strategy,
                                         predicted_a2a=s.a2a,
                                         est_rows=s.est_rows,
                                         est_bytes=s.est_bytes)
                    if resumed_from is not None:
                        rec.metrics.gauge("recovery.resumed_from_stage",
                                          resumed_from)
                with T.span("recovery.collect", fingerprint=fingerprint,
                            resumed_from=(-1 if resumed_from is None
                                          else resumed_from),
                            stages=sum(s.stage for s in plan.steps)) as sp:
                    out, ovs = policy.run(
                        lambda: plan.fn(*plan.inputs()),
                        site="plan.collect", group=group)
                    sp.block(out)
        finally:
            plan.stage_hook = None
        if not policy.keep_checkpoints:
            ckpt.remove()
        if tmp_root is not None:
            barrier(group)
            on_rank0(lambda: shutil.rmtree(tmp_root, ignore_errors=True),
                     group)
        return out, ovs

    def _collect_audited(self, plan: PhysicalPlan, rec, *, strict: bool):
        """Run ``plan`` under collector ``rec``: root span + per-step
        predicted facts + the planner-vs-choke-point exchange audit."""
        from .. import telemetry as T

        for s in plan.steps:
            rec.observe_step(s.index, op=s.op, strategy=s.strategy,
                             predicted_a2a=s.a2a, est_rows=s.est_rows,
                             est_bytes=s.est_bytes)
        with T.using(rec):
            with rec.span("plan.collect", steps=len(plan.steps),
                          predicted_a2a=plan.predicted_collectives) as sp:
                inputs = plan.inputs()
                with T.exchange_log() as log:
                    out, ovs = plan.fn(*inputs)
                sp.block(out)
        audit = T.plan_audit(log, n_shards=self._ctx.n_shards,
                             predicted_a2a=plan.predicted_collectives)
        rec.record_audit(audit)
        rec.metrics.gauge("plan.predicted_a2a", audit["predicted_a2a"])
        rec.metrics.gauge("plan.observed_a2a", audit["observed_a2a"])
        rec.metrics.gauge("plan.observed_bytes", audit["observed_bytes"])
        # map the k-th counted exchange to the k-th exchanging step (steps
        # are appended children-first, i.e. in execution order) — skipped
        # if the counts disagree, never guessed
        if len(log) == sum(s.a2a for s in plan.steps):
            it = iter(log)
            for s in plan.steps:
                if s.a2a:
                    rec.observe_step(s.index, a2a_bytes=sum(
                        next(it) for _ in range(s.a2a)))
        if strict and not audit["consistent"]:
            raise PlanAuditError(
                f"exchange audit mismatch: planner predicted "
                f"{audit['predicted_a2a']} all_to_all, the choke point "
                f"counted {audit['observed_a2a']} — the plan contract is "
                f"broken")
        return out, ovs

    def explain(self, *, optimized: bool = True,
                analyze: bool = False) -> str:
        """Stable text rendering: logical plan → fired rewrite rules →
        optimized plan → physical steps with predicted collective counts.
        Builds the physical plan but reads no data.

        ``analyze=True`` EXECUTES the pipeline under a private collector
        and annotates every physical step with its measured self-time,
        output rows, q-error and exchange payload bytes, plus the
        predicted/counted audit line (the runtime form of EXPLAIN
        ANALYZE).
        """
        if analyze and not optimized:
            raise ValueError("explain(analyze=True) runs the optimized "
                             "plan; optimized=False is not analyzable")
        root, fired = optimize(self._node)
        plan = PhysicalPlan(root if optimized else self._node, self._ctx)
        if not analyze:
            return render_explain(self._node, root, fired, plan)
        from .. import telemetry as T

        rec = T.Collector("explain-analyze")
        self.collect(telemetry=rec, strict=False)
        audit = rec.audits[-1] if rec.audits else None
        return render_explain(self._node, root, fired, plan,
                              annotations=plan_annotations(rec),
                              audit=audit)


class LazyWindow:
    """Deferred ``(partition_by, order_by)`` spec; ``.agg()`` defers too."""

    def __init__(self, lf: LazyFrame, partition_by, order_by, ascending):
        self._lf = lf
        self._partition_by = partition_by
        self._order_by = order_by
        self._ascending = ascending

    def agg(self, aggs, rows: Optional[int] = None) -> LazyFrame:
        return self._lf._chain(L.window(
            self._lf._node, self._partition_by, self._order_by, aggs,
            rows=rows, ascending=self._ascending))
