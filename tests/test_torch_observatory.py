"""The port's query observatory (``repro_torch.telemetry`` cardinality,
memory and ledger) against the JAX package (reference DESIGN.md §14).

  * **cardinality** — ``q_error`` and every plan step's ``est_rows`` /
    ``est_bytes`` equal JAX's; a collect records per-step q-errors from
    the rows it observed, and ``qerror_threshold`` raises on a 10x miss;
    ``refine`` gives JAX's re-pinned plan when both collectors hold the
    same ``plan_steps`` (JAX's ``_instrument`` records nothing on jax
    0.9.0, so the port's observations feed both);
  * **memory** — ``step_live_bytes`` equals JAX's on a grid, the RSS
    probes and watermark, pressure gauges, the ``memory:`` footer;
  * **ledger** — either package reads what the other writes, a torn line
    is skipped, collect records share a fingerprint, and the reference's
    ``scripts/perf_report.py`` gates a ledger the port wrote.
"""
import importlib.util
import itertools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.plan as jplan  # noqa: E402
from repro import telemetry as jtelemetry  # noqa: E402
from repro.core import local_context  # noqa: E402
from repro.dataframe.frame import DataFrame as JDataFrame  # noqa: E402
from repro.io.scan import pred as jpred  # noqa: E402
from repro.plan.explain import render_tree as j_render_tree  # noqa: E402
from repro.telemetry import ledger as jledger  # noqa: E402
from repro.telemetry import memory as JM  # noqa: E402
from repro_torch import telemetry  # noqa: E402
from repro_torch.core import HPTMTContext  # noqa: E402
from repro_torch.dataframe import DataFrame  # noqa: E402
from repro_torch.io import pred  # noqa: E402
from repro_torch.plan import logical as L, optimize  # noqa: E402
from repro_torch.plan.explain import render_tree  # noqa: E402
from repro_torch.resilience import FaultPolicy, arm, reset  # noqa: E402
from repro_torch.telemetry import (CardinalityAuditError, ledger,  # noqa: E402
                                   q_error, step_qerrors)
from repro_torch.telemetry import memory as M  # noqa: E402

CPU1 = HPTMTContext(n_shards=1, device="cpu")
CPU4 = HPTMTContext(n_shards=4, device="cpu")
JCTX = local_context()
SCRIPTS = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "scripts"))


@pytest.fixture(autouse=True)
def _clean_faults():
    reset()
    yield
    reset()


def _data(n=64, seed=0, n_keys=8):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, n_keys, n).astype(np.float32),
            "v": rng.normal(size=n).astype(np.float32)}


SMALL = {"k": np.arange(8, dtype=np.float32),
         "w": np.arange(8, dtype=np.float32)}


def _chain(D, ctx):
    big = D.from_dict(_data(n=96), ctx, bucket_factor=4.0)
    small = D.from_dict(SMALL, ctx, bucket_factor=4.0)
    return (big.lazy().join(small.lazy(), ["k"], max_matches=4)
            .groupby(["k"], [("v", "sum")]).sort_values("k"))


# ---------------------------------------------------------------------------
# pillar 1: cardinality audit
# ---------------------------------------------------------------------------
def test_q_error_equals_jax():
    vals = [0, 0.5, 1, 3, 10, 64.0, 1e6]
    for e, o in itertools.product(vals, vals):
        assert q_error(e, o) == jtelemetry.q_error(e, o), (e, o)
    assert q_error(0, 0) == 1.0 and q_error(10, 100) == 10.0


@pytest.mark.parametrize("ctx", [CPU1, CPU4], ids=["1shard", "4shards"])
def test_plan_step_estimates_equal_jax(ctx):
    """Row estimates read manifests only, so they equal the JAX plan's on
    any shard count; the live-bytes model then equals JAX's model over
    them (on 1 shard: the JAX plan's ``est_bytes`` step for step)."""
    lf = _chain(DataFrame, ctx)
    plan = lf.physical_plan()
    jsteps = _chain(JDataFrame, JCTX).physical_plan().steps
    assert [(s.op, s.est_rows) for s in plan.steps] == \
        [(s.op, s.est_rows) for s in jsteps]
    root, _ = optimize(lf.logical_plan)
    est = {id(nd): s.est_rows for s, nd in zip(plan.steps, L.walk(root))}
    for s, node in zip(plan.steps, L.walk(root)):
        assert s.est_bytes == JM.step_live_bytes(
            s.op, rows_in=sum(est[id(i)] for i in node.inputs),
            rows_out=s.est_rows,
            cols_in=max((len(i.schema) for i in node.inputs), default=0),
            cols_out=len(node.schema), exchanges=s.a2a,
            n_shards=ctx.n_shards) > 0, s
    if ctx.n_shards == 1:
        assert [s.est_bytes for s in plan.steps] == \
            [s.est_bytes for s in jsteps]
    again = lf.physical_plan()
    assert [(s.est_rows, s.est_bytes) for s in plan.steps] == \
        [(s.est_rows, s.est_bytes) for s in again.steps]


def test_collect_records_qerrors_and_threshold_enforces():
    n = 64
    # every row matches the == predicate, but the prior says 10% — a
    # deliberate 10x miss the audit must both RECORD and ENFORCE
    data = {"k": np.full(n, 5.0, np.float32),
            "v": np.arange(n, dtype=np.float32)}
    lf = DataFrame.from_dict(data, CPU1, bucket_factor=4.0).lazy() \
        .filter([pred("k", "==", 5.0)])
    jlf = JDataFrame.from_dict(data, JCTX, bucket_factor=4.0).lazy() \
        .filter([jpred("k", "==", 5.0)])
    with telemetry.trace("qerr") as rec:
        out = lf.collect(telemetry=rec)
    assert len(out.to_numpy()["k"]) == len(jlf.collect().to_numpy()["k"])
    qs = step_qerrors(rec)
    jsteps = jlf.physical_plan().steps
    for s in jsteps:  # JAX's estimate against the rows both observe
        assert qs[s.index] == jtelemetry.q_error(
            s.est_rows, rec.plan_steps[s.index]["rows_out"])
    assert abs(max(qs.values()) - 10.0) < 0.01, qs
    assert rec.metrics.gauges["cardinality.max_qerror"] == 10.0
    assert rec.metrics.gauges["cardinality.steps_audited"] == len(qs)
    with telemetry.trace("qerr-strict") as rec2:
        with pytest.raises(CardinalityAuditError, match="filter"):
            lf.collect(telemetry=rec2, qerror_threshold=4.0)
    with telemetry.trace("qerr-lax") as rec3:  # strict-mode contract only
        lf.collect(telemetry=rec3, strict=False, qerror_threshold=4.0)


def test_refine_repins_join_order_like_jax():
    n = 64
    rng = np.random.default_rng(1)
    big = {"k": (np.arange(n) % 8).astype(np.float32),
           "c": np.full(n, 5.0, np.float32),
           "v": rng.normal(size=n).astype(np.float32)}
    small = {"k": (np.arange(32) % 8).astype(np.float32),
             "w": np.arange(32, dtype=np.float32)}

    def build(D, P, ctx):
        b = D.from_dict(big, ctx, bucket_factor=4.0)
        s = D.from_dict(small, ctx, bucket_factor=4.0)
        return (b.lazy().filter([P("c", "==", 5.0)])
                .join(s.lazy(), ["k"], max_matches=64, reorder=True)
                .groupby(["k"], [("v", "sum"), ("w", "sum")])
                .sort_values("k"))

    lf = build(DataFrame, pred, CPU1)
    jlf = build(JDataFrame, jpred, JCTX)
    root, _ = optimize(lf.logical_plan)
    assert next(nd for nd in L.walk(root)
                if nd.kind == "join").payload["swap"] is True
    with telemetry.trace("refine") as rec:
        oracle = lf.collect(telemetry=rec).to_numpy()
    jrec = jtelemetry.Collector("refine")
    jrec.plan_steps = {i: dict(f) for i, f in rec.plan_steps.items()}
    refined, jrefined = lf.refine(rec), jlf.refine(jrec)
    assert render_tree(refined.logical_plan) == \
        j_render_tree(jrefined.logical_plan)
    rjoin = next(nd for nd in L.walk(refined.logical_plan)
                 if nd.kind == "join")
    jjoin = next(nd for nd in jplan.logical.walk(jrefined.logical_plan)
                 if nd.kind == "join")
    assert (rjoin.payload["swap"], rjoin.payload["reorder"]) == \
        (jjoin.payload["swap"], jjoin.payload["reorder"]) == (False, False)
    reroot, _ = optimize(refined.logical_plan)
    assert next(nd for nd in L.walk(reroot)
                if nd.kind == "join").payload["swap"] is False
    got = refined.collect().to_numpy()
    for col in oracle:
        np.testing.assert_allclose(got[col], oracle[col], rtol=1e-5,
                                   err_msg=col)


# ---------------------------------------------------------------------------
# pillar 2: memory accounting
# ---------------------------------------------------------------------------
def test_rss_probes_and_watermark():
    kb, peak = M.rss_kb(), M.peak_rss_kb()
    assert kb is not None and kb > 0
    assert peak is not None and peak >= kb * 0.5
    with M.RssWatermark() as wm:
        ballast = np.ones(1 << 20, dtype=np.float64)
        ballast[0] = 2.0
    assert wm.delta_kb >= 0.0
    rec = telemetry.Collector("mem")
    M.publish_pressure(rec, "x")
    assert rec.metrics.gauges["x.pressure.rss_mb"] > 0
    assert rec.metrics.gauges["x.pressure.peak_rss_mb"] > 0


def test_step_live_bytes_equals_jax():
    for op, rows, cols, ex, n, spill in itertools.product(
            ("filter", "groupby", "join", "window", "orderby", "topk"),
            (0, 1, 100, 12345.5), (0, 3, 7), (0, 1, 2), (1, 4),
            (0.0, 4096.0)):
        kw = dict(rows_in=rows, rows_out=rows / 2, cols_in=cols,
                  cols_out=cols + 1, exchanges=ex, n_shards=n,
                  spill_bytes=spill)
        assert M.step_live_bytes(op, **kw) == JM.step_live_bytes(op, **kw)
    assert M.row_bytes(5) == JM.row_bytes(5)


def test_collect_observes_memory_and_analyze_footer():
    lf = (DataFrame.from_dict(_data(n=96), CPU1, bucket_factor=4.0).lazy()
          .groupby(["k"], [("v", "sum")]).sort_values("k"))
    with telemetry.trace("mem") as rec:
        lf.collect(telemetry=rec)
    for idx, facts in rec.plan_steps.items():
        assert facts["est_bytes"] > 0, (idx, facts)
        assert facts["peak_rss_delta_kb"] >= 0, (idx, facts)
    sp = next(s for s in rec.all_spans() if s.name.startswith("plan.")
              and "peak_rss_delta_kb" in s.attrs)
    assert sp.attrs["est_bytes"] > 0
    txt = lf.explain(analyze=True)
    assert "memory: est_live=" in txt and "peak_rss_delta=" in txt, txt


# ---------------------------------------------------------------------------
# pillar 3: run-history ledger
# ---------------------------------------------------------------------------
def test_ledger_cross_reads_and_skips_torn_line(tmp_path):
    path = str(tmp_path / "led" / "runs.jsonl")
    ledger.append(path, {"fingerprint": "fp0", "wall_s": 1.0})
    jledger.append(path, {"fingerprint": "fp0", "wall_s": 2.0})
    with open(path, "a") as f:
        f.write('{"fingerprint": "fp0", "wall')   # crash mid-append
    assert [r["wall_s"] for r in ledger.read(path)] == [1.0, 2.0]
    assert ledger.read(path) == jledger.read(path)
    assert ledger.read(str(tmp_path / "missing.jsonl")) == []
    r = ledger.bench_record("shuffle", 1234.5, derived="p50",
                            peak_rss_mb=99.5,
                            telemetry={"collectives": {"all-to-all": 3}})
    jr = jledger.bench_record("shuffle", 1234.5, derived="p50",
                              peak_rss_mb=99.5,
                              telemetry={"collectives": {"all-to-all": 3}})
    assert {k: v for k, v in r.items() if k != "ts"} == \
        {k: v for k, v in jr.items() if k != "ts"}


def test_collect_appends_fingerprinted_ledger_records(tmp_path):
    path = str(tmp_path / "runs.jsonl")
    lf = DataFrame.from_dict(_data(), CPU1, bucket_factor=4.0).lazy() \
        .groupby(["k"], [("v", "sum")])
    lf.collect(ledger=path)                        # un-instrumented run
    with telemetry.trace("led") as rec:
        lf.collect(telemetry=rec, ledger=path)
    jlf = JDataFrame.from_dict(_data(), JCTX, bucket_factor=4.0).lazy() \
        .groupby(["k"], [("v", "sum")])
    jlf.collect(ledger=path)                       # the reference appends
    recs = jledger.read(path)                      # ... and reads them all
    assert len(recs) == 3
    assert recs[0]["fingerprint"] == recs[1]["fingerprint"]
    assert recs[0]["kind"] == "collect" and recs[0]["wall_s"] > 0
    assert recs[0]["max_qerror"] is None, "no collector: identity only"
    assert recs[1]["max_qerror"] >= 1.0
    assert recs[1]["steps"] == len(rec.plan_steps)
    assert recs[1]["qerrors"]
    assert recs[1]["audit_consistent"] is True
    assert recs[1]["peak_rss_mb"] > 0
    assert sorted(recs[2]) == sorted(recs[0])      # one record schema


def test_perf_report_gates_a_ledger_the_port_wrote(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "perf_report", os.path.join(SCRIPTS, "perf_report.py"))
    pr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pr)
    path = str(tmp_path / "runs.jsonl")
    lf = DataFrame.from_dict(_data(), CPU1, bucket_factor=4.0).lazy() \
        .groupby(["k"], [("v", "sum")])
    lf.collect()
    lf.collect(ledger=path)
    # a chaos-armed retry backs off ~0.8 s before the disarmed rerun: a
    # deterministic >30% slowdown of the same fingerprint
    arm("plan.step.0", "io_error")
    lf.collect(ledger=path, policy=FaultPolicy(
        max_retries=2, backoff_base=0.8, backoff_factor=1.0,
        backoff_max=0.8, jitter=0.0))
    [fp] = {r["fingerprint"] for r in ledger.read(path)}
    rows = pr.fingerprint_deltas(jledger.read(path))
    assert {r["fingerprint"]: r["flags"] for r in rows if r["flags"]} == \
        {fp: ["TIME"]}
    assert pr.main([path, "--out", str(tmp_path / "r.md"), "--gate"]) == 1


def test_crash_leaves_no_record_and_resume_shares_fingerprint(tmp_path):
    from repro_torch.resilience import FatalInjectedFault

    path = str(tmp_path / "runs.jsonl")
    pol = FaultPolicy(max_retries=1, backoff_base=0.001, backoff_max=0.01,
                      checkpoint_dir=str(tmp_path / "stages"),
                      keep_checkpoints=True)
    plan = _chain(DataFrame, CPU1).physical_plan()
    last = plan.steps[-1].index
    assert sum(1 for s in plan.steps if s.stage) >= 2
    rec1 = telemetry.Collector("run1")
    oracle = _chain(DataFrame, CPU1).collect(
        telemetry=rec1, policy=pol, ledger=path).to_numpy()
    assert rec1.metrics.counters["recovery.stages_committed"] >= 2
    arm(f"plan.step.{last}", "fatal")
    with pytest.raises(FatalInjectedFault):
        _chain(DataFrame, CPU1).collect(telemetry=telemetry.Collector(),
                                        policy=pol, ledger=path)
    assert len(ledger.read(path)) == 1, "crashed run must leave no record"
    rec3 = telemetry.Collector("run3")
    got = _chain(DataFrame, CPU1).collect(telemetry=rec3, policy=pol,
                                          ledger=path).to_numpy()
    for k, v in oracle.items():
        np.testing.assert_array_equal(v, got[k], err_msg=k)
    assert rec3.metrics.counters["recovery.stages_restored"] >= 1
    recs = ledger.read(path)
    assert len(recs) == 2 and recs[0]["fingerprint"] == recs[1]["fingerprint"]
    assert recs[1]["counters"]["recovery.stages_restored"] >= 1
