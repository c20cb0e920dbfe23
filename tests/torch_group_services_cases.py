"""What each rank runs for ``tests/test_torch_group_services.py``.

The runtime services on a process group: the spill engine (join, groupby,
window, refinement, the ``spill="auto"`` triggers, a run-write fault on
one rank, the workdir contract, ``TSet.from_spill``), the lazy planner
(``TSet.lazy``, the three contract chains of ``tests/test_torch_plan.py``
with their audit, q-errors, ledger, ``explain()`` and ``refine()``),
stage checkpoints (commit, an agreed retry, kill-and-resume on another
number of ranks), the workflow engine (a one-rank fault retried
together, the journal, resume and the stale-journal refusal), and the
outcomes every rank shares (an agreed retry stopped by a fatal error on
one rank, an empty spill source on one rank).

:func:`services_cases` runs on one context — the port's virtual 4-shard
context in the test process, or one rank of a ``gloo`` group that
``run_ranks`` spawned (it imports this module by name, so it imports no
JAX) — under a root directory every rank sees, and returns each result
whole (gathered blocks, counts, partitioning, overflow), the stats, the
files' digests and each case's exchange and sort counts.  Inputs are
drawn once from a seed at import, so every process holds the same
arrays.
"""
from __future__ import annotations

import dataclasses
import errno
import json
import os
import shutil

import numpy as np

import torch_parity  # noqa: F401  (one intra-op thread a process)
from torch_group_cases import frame_result, table_result
from torch_group_storage_cases import barrier, file_digests
from repro_torch import telemetry
from repro_torch.core import array_ops, table_ops
from repro_torch.core.dataflow import TSet
from repro_torch.dataframe import DataFrame
from repro_torch.io import pred
from repro_torch.plan import LazyFrame, optimize
from repro_torch.resilience import FaultPolicy, arm, fires, reset
from repro_torch.resilience.faults import FatalInjectedFault, InjectedFault
from repro_torch.spill import spill_groupby, spill_join, spill_window
from repro_torch.spill.store import SpillWriteError
from repro_torch.workflow import Task, WorkflowEngine, WorkflowError

R = np.random.default_rng(27)
#: the spill inputs: several partitions on 4 shards under BUDGET rows a
#: shard; right keys overlap the left's only in part (left/outer rows)
NL, NR = 2048, 400
LEFT = {"k": R.integers(0, 300, NL).astype(np.int32),
        "g": R.integers(0, 16, NL).astype(np.int32),
        "v": R.standard_normal(NL).astype(np.float32)}
RIGHT = {"k": np.arange(NR, dtype=np.int32) - 50,
         "w": R.standard_normal(NR).astype(np.float32)}
BUDGET = 128
G_AGGS = (("v", "sum"), ("v", "min"), ("v", "count"), ("v", "max"))
#: integer-valued floats: rolling sums are exact in any order
EVENTS = {"g": R.integers(0, 60, 2000).astype(np.int32),
          "t": R.permutation(2000).astype(np.int32),
          "x": R.integers(-100, 100, 2000).astype(np.float32)}
W_AGGS = [("x", "sum"), ("x", "min"), (None, "row_number"), ("x", "lag", 1)]
W_BUDGET = 100
#: one key holds 70% of the rows: refined once, then left oversized
SKEW = {"k": np.where(R.random(2000) < 0.7, 7,
                      R.integers(0, 50, 2000)).astype(np.int32),
        "v": R.standard_normal(2000).astype(np.float32)}
SKEW_BUDGET = 100
#: the three planner chains of ``tests/test_torch_plan.py`` (same seed,
#: same draws)
_C = np.random.default_rng(0)
BIG4 = {"k1": _C.integers(0, 10, 320).astype(np.float32),
        "k2": _C.integers(0, 4, 320).astype(np.float32),
        "v": _C.integers(-50, 50, 320).astype(np.float32)}
SMALL4 = {"k1": np.repeat(np.arange(10), 4).astype(np.float32),
          "k2": np.tile(np.arange(4), 10).astype(np.float32),
          "w": _C.integers(-50, 50, 40).astype(np.float32)}
KEYS, GKEYS = ["k1", "k2"], ["k2", "k1"]
AGGS = [("v", "sum"), ("w", "max")]
WAGGS = [("v_sum", "sum")]
SCAN_L = {"k": _C.integers(0, 64, 512).astype(np.int32),
          "g": _C.integers(0, 8, 512).astype(np.int32),
          "v": _C.integers(-20, 20, 512).astype(np.float32)}
SCAN_R = {"k": _C.permutation(64).astype(np.int32),
          "w": _C.integers(-20, 20, 64).astype(np.float32)}
SCAN_GAGGS = [("v", "sum"), ("v", "count"), ("v", "min"), ("w", "max")]
SCAN_WAGGS = [("v_sum", "sum"), ("v_count", "sum"), ("v_min", "min")]
#: the spill workdir's own file, which every spilled case must leave
KEEP = "kept.txt"
#: kill-and-resume: every rank dies by SIGKILL at the second stage commit
CRASH = ("checkpoint.commit", "crash", 2)
#: ledger fields that hold times or this host's memory
LEDGER_TIMES = ("ts", "wall_s", "peak_rss_mb", "counters", "gauges")


def write_scan_dataset(path: str) -> None:
    """The scan chain's dataset (one process writes it, every rank reads
    it): 8 fragments of 64 rows."""
    from repro_torch.core import HPTMTContext

    DataFrame.from_dict(SCAN_L, HPTMTContext(n_shards=1, device="cpu")
                        ).to_hpt(path, rows_per_group=64)


def _frame(d, ctx, capacity=None):
    rows = len(next(iter(d.values())))
    return DataFrame.from_dict(d, ctx, capacity=capacity
                               or 2 * -(-rows // ctx.n_shards))


class Counts:
    """Each case's ``(exchanges, sorts)`` in this process."""

    def __init__(self):
        self.n = {}

    def __call__(self, tag, fn):
        array_ops.EXCHANGES.reset()
        array_ops.SORTS.reset()
        out = fn()
        self.n[tag] = (array_ops.EXCHANGES.n, array_ops.SORTS.n)
        return out


def _stats(res) -> dict:
    return dataclasses.asdict(res.stats)


def _workdir(ctx, root: str, tag: str) -> str:
    """A spill workdir under ``root`` holding one file of the caller's."""
    wd = os.path.join(root, tag)
    if ctx.rank == 0:
        os.makedirs(wd)
        with open(os.path.join(wd, KEEP), "w") as f:
            f.write(tag)
    barrier(ctx)
    return wd


def _kept(wd: str) -> bool:
    """The workdir holds its file alone, unchanged."""
    with open(os.path.join(wd, KEEP)) as f:
        return os.listdir(wd) == [KEEP] and f.read() == os.path.basename(wd)


# ---------------------------------------------------------------------------
# the spill engine
# ---------------------------------------------------------------------------
def spill_cases(ctx, root: str, counts: Counts) -> tuple:
    """``(results, every)``: the spilled results whole, and the stats,
    store and workdir facts every rank must report alike."""
    left, right = _frame(LEFT, ctx), _frame(RIGHT, ctx)
    res, every = {}, {}
    for how in ("inner", "left", "outer"):
        wd = _workdir(ctx, root, f"join_{how}")
        res[f"join_{how}"] = frame_result(counts(f"join_{how}", lambda: (
            left.join(right, ["k"], how=how, spill=True, budget_rows=BUDGET,
                      spill_workdir=wd))))
        every[f"kept_join_{how}"] = _kept(wd)
    wd = _workdir(ctx, root, "groupby")
    res["groupby"] = frame_result(counts("groupby", lambda: left.groupby(
        ["k"], list(G_AGGS), spill=True, budget_rows=BUDGET,
        spill_workdir=wd)))
    every["kept_groupby"] = _kept(wd)
    ev = _frame(EVENTS, ctx)
    wd = _workdir(ctx, root, "window")
    res["window"] = frame_result(counts("window", lambda: ev.window(
        ["g"], ["t"]).agg(W_AGGS, rows=8, spill=True, budget_rows=W_BUDGET,
                          spill_workdir=wd)))
    every["kept_window"] = _kept(wd)

    # the engine's own API: stats, the store, and a TSet over the output
    for name, run in (
            ("stats_join", lambda: spill_join(
                left.table, right.table, ("k",), ctx=ctx, budget_rows=BUDGET,
                how="outer")),
            ("stats_groupby", lambda: spill_groupby(
                left.table, ("k",), G_AGGS, ctx=ctx, budget_rows=BUDGET)),
            ("stats_window", lambda: spill_window(
                ev.table, ("g",), ("t",), W_AGGS, ctx=ctx,
                budget_rows=W_BUDGET, rows=8)),
            ("skew", lambda: spill_groupby(
                _frame(SKEW, ctx).table, ("k",), (("v", "sum"),
                                                  ("v", "count")),
                ctx=ctx, budget_rows=SKEW_BUDGET))):
        with counts(name, run) as out:
            every[name] = _stats(out)
            every[f"{name}_tmp"] = out.store.leftover_temp_files()
            root_dir = out.store.root
            res[name] = {k: v for k, v in out.collect().items()}
        every[f"{name}_removed"] = not os.path.exists(root_dir)
    with spill_groupby(left.table, ("g",), G_AGGS, ctx=ctx,
                       budget_rows=BUDGET) as out:
        ts = out.to_tset()
    ts = ts.groupby(["g"], [("v_sum", "sum"), ("v_count", "sum")])
    res["from_spill"] = table_result(counts("from_spill", ts.collect))
    every["from_spill_report"] = sorted(ts.overflow_report.recovered.items())

    # spill="auto": by the budget, and on an in-memory overflow
    auto = {"auto_budget": counts("auto_budget", lambda: left.groupby(
        ["k"], list(G_AGGS), spill="auto", budget_rows=BUDGET)),
        "auto_overflow": counts("auto_overflow", lambda: left.join(
            right, ["k"], spill="auto", out_capacity=64))}
    for name, df in auto.items():
        res[name] = frame_result(df)
        every[f"{name}_recovered"] = sorted(
            df.overflow_report.recovered.items())

    # a run write that fails on the last rank only raises on every rank
    wd = _workdir(ctx, root, "fault")
    reset()
    if ctx.rank == ctx.world - 1:
        arm("spill.write", "disk_full", nth=3)
    try:
        left.join(right, ["k"], spill=True, budget_rows=BUDGET,
                  spill_workdir=wd)
        every["fault"] = ("returned", False)
    except SpillWriteError as e:
        every["fault"] = (type(e).__name__, "failed to write" in str(e))
    fault_fires = fires("spill.write")
    reset()
    every["kept_fault"] = _kept(wd)
    return res, every, fault_fires


# ---------------------------------------------------------------------------
# the lazy planner
# ---------------------------------------------------------------------------
def chains(ctx, path: str) -> dict:
    """The three contract chains of ``tests/test_torch_plan.py``:
    ``(eager_fn, eager inputs, lazy frame)``."""
    bf = DataFrame.from_dict(BIG4, ctx, bucket_factor=4.0)
    sf = DataFrame.from_dict(SMALL4, ctx, bucket_factor=4.0)

    def chain(lt, rt):
        j, _ = table_ops.join(lt, rt, KEYS, ctx=ctx, how="inner",
                              max_matches=64)
        g, _ = table_ops.groupby_aggregate(j, GKEYS, AGGS, ctx=ctx)
        w, _ = table_ops.window_aggregate(g, GKEYS, ["v_sum"], WAGGS, ctx=ctx)
        return w

    def gbob(dt):
        g, _ = table_ops.groupby_aggregate(dt, ["k1"], [("v", "sum")],
                                           ctx=ctx)
        s, _ = table_ops.orderby(g, ["k1"], ctx=ctx)
        return s

    sl = DataFrame.read_parquet(path, ctx, bucket_factor=2.0)
    sr = DataFrame.from_dict(SCAN_R, ctx, bucket_factor=2.0)
    mask = pred("v", ">", 0.0).mask

    def scan_chain(lt, rt):
        f = table_ops.select(lt, mask, ctx=ctx)
        j, _ = table_ops.join(f, rt, ["k"], ctx=ctx)
        g, _ = table_ops.groupby_aggregate(j, ["k"], SCAN_GAGGS, ctx=ctx)
        w, _ = table_ops.window_aggregate(g, ["k"], ["v_sum"], SCAN_WAGGS,
                                          ctx=ctx, rows=32)
        return w

    return {
        "chain": (chain, (bf.table, sf.table),
                  bf.lazy().join(sf.lazy(), KEYS, max_matches=64)
                  .groupby(GKEYS, AGGS).window(GKEYS, ["v_sum"]).agg(WAGGS)),
        "gbob": (gbob, (bf.table,),
                 bf.lazy().groupby(["k1"], [("v", "sum")]).sort_values("k1")),
        "scan": (scan_chain, (sl.table, sr.table), scan_lazy(ctx, path)),
    }


def scan_lazy(ctx, path: str) -> LazyFrame:
    """The scan chain: scan → filter → join → groupby → window."""
    sr = DataFrame.from_dict(SCAN_R, ctx, bucket_factor=2.0)
    return (LazyFrame.read_parquet(path, ctx, bucket_factor=2.0)
            .filter([pred("v", ">", 0.0)]).join(sr.lazy(), ["k"])
            .groupby(["k"], SCAN_GAGGS)
            .window(["k"], ["v_sum"]).agg(SCAN_WAGGS, rows=32))


def resume_lazy(ctx, path: str) -> LazyFrame:
    """The scan chain, then a sort by ``v_sum``: two exchange stages, so a
    kill at the second commit leaves one committed (as phase 17's)."""
    return scan_lazy(ctx, path).sort_values("v_sum")


def _ledger_fields(path: str) -> list:
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k not in LEDGER_TIMES}
            for r in recs]


def planner_cases(ctx, root: str, path: str, counts: Counts) -> tuple:
    """``(results, every)``: each chain's rows and counts, its explain
    text, fired rules, audit, q-errors and ledger record."""
    res, every = {}, {}
    ledger = os.path.join(root, "ledger.jsonl")
    for name, (fn, tables, lf) in chains(ctx, path).items():
        counts(f"{name}_eager", lambda: fn(*tables))
        plan = lf.physical_plan()
        every[f"{name}_predicted"] = plan.predicted_collectives
        res[name] = frame_result(counts(f"{name}_planned", lf.collect))
        every[f"{name}_explain"] = lf.explain()
        every[f"{name}_rules"] = list(optimize(lf.logical_plan)[1])
        rec = telemetry.Collector(name)
        counts(f"{name}_audited", lambda: lf.collect(
            telemetry=rec, ledger=ledger, qerror_threshold=1e6))
        audit = dict(rec.audits[-1])
        every[f"{name}_audit"] = {k: audit[k] for k in (
            "predicted_a2a", "observed_a2a", "observed_bytes", "consistent")}
        every[f"{name}_qerr"] = {i: f.get("qerr") for i, f in
                                 sorted(rec.plan_steps.items())}
        every[f"{name}_refined"] = lf.refine(rec).explain()
    barrier(ctx)
    every["ledger"] = _ledger_fields(ledger)
    # the lazy planner rooted at a TSet
    left = _frame(LEFT, ctx)
    ts = TSet.from_table(left.table, ctx, chunk_rows=left.table.capacity // 4)
    res["tset_lazy"] = frame_result(counts("tset_lazy", lambda: (
        ts.project(["k", "g", "v"]).lazy().groupby(["g"], [("v", "sum")])
        .collect())))
    return res, every


# ---------------------------------------------------------------------------
# stage checkpoints
# ---------------------------------------------------------------------------
def stage_files(ckdir: str) -> dict:
    """``fingerprint/stage → {file: digest}`` of every committed stage."""
    out = {}
    for fp in sorted(os.listdir(ckdir)):
        for st in sorted(os.listdir(os.path.join(ckdir, fp))):
            out[f"{fp}/{st}"] = file_digests(os.path.join(ckdir, fp, st))
    return out


def stage_cases(ctx, root: str, path: str, counts: Counts) -> tuple:
    """Commit every stage of the resume chain; the same chain under an
    agreed retry of a ``plan.step`` fault armed on the last rank only."""
    res, every = {}, {}
    ck = os.path.join(root, "stages")
    lf = resume_lazy(ctx, path)
    pol = FaultPolicy(checkpoint_dir=ck, keep_checkpoints=True,
                      backoff_base=0.001)
    res["committed"] = frame_result(counts("committed", lambda: lf.collect(
        policy=pol)))
    every["stages"] = [s.index for s in lf.physical_plan().steps if s.stage]
    barrier(ctx)
    every["stage_files"] = stage_files(ck)
    rerun = counts("rerun", lambda: lf.collect(policy=pol))
    res["rerun"] = frame_result(rerun)
    # a fault at the join's step on the last rank: every rank retries the
    # plan once (no checkpoint dir: stages live in a shared temp dir)
    step = next(s.index for s in lf.physical_plan().steps
                if s.op == "join")
    reset()
    if ctx.rank == ctx.world - 1:
        arm(f"plan.step.{step}", "io_error")
    rec = telemetry.Collector("retry")
    res["retried"] = frame_result(counts("retried", lambda: lf.collect(
        policy=FaultPolicy(backoff_base=0.001), telemetry=rec)))
    every["retries"] = rec.metrics.counters.get("retry.plan.collect", 0)
    step_fires = fires(f"plan.step.{step}")
    reset()
    return res, every, step_fires


def crash_rank(ctx, path: str, ckdir: str) -> None:
    """The resume chain under stage checkpoints, every rank armed to die
    by SIGKILL at the second commit; returning at all is a failure."""
    arm(*CRASH[:2], nth=CRASH[2])
    resume_lazy(ctx, path).collect(
        policy=FaultPolicy(checkpoint_dir=ckdir, keep_checkpoints=True))
    raise AssertionError("the rank was not killed")


def resume_rank(ctx, path: str, ckdir: str) -> dict:
    """Resume the crashed chain from ``ckdir``: the rows, the exchanges
    (the suffix's), the stages restored and the files after."""
    counts = Counts()
    rec = telemetry.Collector("resume")
    lf = resume_lazy(ctx, path)
    out = counts("resume", lambda: lf.collect(
        policy=FaultPolicy(checkpoint_dir=ckdir, keep_checkpoints=True),
        telemetry=rec))
    res = frame_result(out)
    barrier(ctx)
    return {"rank": ctx.rank, "result": res, "counts": counts.n["resume"],
            "restored": rec.metrics.counters.get(
                "recovery.stages_restored", 0),
            "resumed_from": rec.metrics.gauges.get(
                "recovery.resumed_from_stage"),
            "files": stage_files(ckdir)}


# ---------------------------------------------------------------------------
# the workflow engine
# ---------------------------------------------------------------------------
def workflow_cases(ctx, root: str, path: str) -> dict:
    """A 3-task DAG on the group with a transient scan fault on the last
    rank; its resume; a changed DAG against the same journal."""
    calls = {"scan": 0, "join_groupby": 0, "check": 0}
    sr = DataFrame.from_dict(SCAN_R, ctx, bucket_factor=2.0)

    def scan():
        calls["scan"] += 1
        return DataFrame.read_dataset(path, ctx, bucket_factor=2.0)

    def join_groupby(scan):
        calls["join_groupby"] += 1
        return scan.join(sr, ["k"]).groupby(["g"], [("v", "sum"),
                                                    ("w", "max")])

    def check(join_groupby):
        calls["check"] += 1
        return frame_result(join_groupby)

    def engine(journal, deps=("scan",)):
        pol = FaultPolicy(max_retries=2, backoff_base=0.001)
        return (WorkflowEngine(journal, policy=pol)
                .add(Task("scan", scan))
                .add(Task("join_groupby", join_groupby, deps=deps))
                .add(Task("check", check, deps=("join_groupby",))))

    journal = os.path.join(root, "journal.json")
    reset()
    if ctx.rank == ctx.world - 1:
        arm("scan.read", "io_error")
    with telemetry.trace("workflow") as rec:
        results = engine(journal).run()
    out = {"result": results["check"], "calls": dict(calls),
           "retries": rec.metrics.counters.get("retry.workflow.scan", 0)}
    reset()
    with open(journal) as f:
        out["journal"] = f.read()
    with telemetry.trace("resume") as rec:
        engine(journal).run()
    out["resumed_calls"] = dict(calls)
    out["replayed"] = rec.metrics.counters.get("workflow.replayed", 0)
    try:
        engine(journal, deps=()).run()
        out["stale"] = "ran"
    except WorkflowError as e:
        out["stale"] = "stale journal" in str(e)
    return out


# ---------------------------------------------------------------------------
# outcomes every rank shares
# ---------------------------------------------------------------------------
def agreement_cases(ctx, root: str) -> tuple:
    """``(every, mine)``: an agreed retry's ``(attempts, outcome)`` when a
    fatal error on the last rank meets a transient one on rank 0, when
    two ranks fail transiently at once, and when rank 0's fatal error
    does not pickle; and a window spill whose source is empty on the last
    rank.  ``every`` holds what every rank reports alike, ``mine`` what
    each rank raises itself."""
    last = ctx.rank == ctx.world - 1
    pol = FaultPolicy(max_retries=2, backoff_base=0.001)

    def attempts(name, fail):
        n = [0]

        def fn():
            n[0] += 1
            e = fail(n[0])
            if e is not None:
                raise e
            return "done"

        try:
            out = pol.run(fn, site=f"agree.{name}", group=ctx.group)
        except Exception as e:  # noqa: BLE001 — the outcome is the fact
            out = type(e).__name__
        return n[0], out

    def transient():
        return InjectedFault(errno.EIO, "injected io error", "agree")

    mine = {
        "fatal_beside_transient": attempts("fatal", lambda a: (
            FatalInjectedFault("corrupt") if last
            else transient() if ctx.rank == 0 else None)),
        "unpicklable_fatal": attempts("unpicklable", lambda a: (
            ValueError("unpicklable", lambda: None) if ctx.rank == 0
            else None))}
    every = {"transient_together": attempts("transient", lambda a: (
        transient() if a == 1 and (ctx.rank == 0 or last) else None))}
    wd = _workdir(ctx, root, "empty_window")
    chunk = ({k: v[:100] for k, v in EVENTS.items()}, 100)
    try:
        spill_window([] if last else [chunk], ("g",), ("t",), W_AGGS,
                     ctx=ctx, budget_rows=W_BUDGET, rows=8, workdir=wd)
        every["empty_window"] = ("returned", False)
    except ValueError as e:
        every["empty_window"] = (type(e).__name__, "no chunks" in str(e))
    every["kept_empty_window"] = _kept(wd)
    return every, mine


# ---------------------------------------------------------------------------
# one run of every case
# ---------------------------------------------------------------------------
def services_cases(ctx, root: str, path: str) -> dict:
    """One process's run of every case under ``root`` (one directory every
    rank sees; ``path`` the scan chain's dataset)."""
    counts = Counts()
    spill, spill_every, fault_fires = spill_cases(
        ctx, os.path.join(root, "spill"), counts)
    plan, plan_every = planner_cases(ctx, root, path, counts)
    stages, stage_every, step_fires = stage_cases(ctx, root, path, counts)
    flow = workflow_cases(ctx, root, path)
    agree, mine = agreement_cases(ctx, os.path.join(root, "agree"))
    return {"rank": ctx.rank, "world": ctx.world, "counts": counts.n,
            "agree": mine,
            "results": {"spill": spill, "plan": plan, "stages": stages,
                        "workflow": flow.pop("result")},
            "every": {"spill": spill_every, "plan": plan_every,
                      "stages": stage_every, "workflow": flow,
                      "agree": agree},
            "fires": {"spill.write": fault_fires, "plan.step": step_fires}}


def copy_tree(src: str, dst: str) -> str:
    shutil.copytree(src, dst)
    return dst
