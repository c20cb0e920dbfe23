"""The port's telemetry layer (``repro_torch.telemetry``) against the JAX
package and against the contract of the reference's
``tests/test_telemetry.py`` (DESIGN.md §12).

The reference's spans cannot be compared with: on jax 0.9.0 its
``tracing()`` is always True, so it emits none (ROADMAP Queue 3).  So the
port's spans are held to what that test file asserts, and to JAX wherever
JAX computes a value without a span: result rows, ``OverflowReport.
to_metrics``, ``ScanStats``, ``SpillStats``, the rendered plans.

  * **off by default** — one shared no-op span, nothing recorded and no
    ``torch.cuda.synchronize`` call;
  * **honest spans** — a span synchronizes the device of every CUDA
    tensor in its outputs, once a device; eager operator calls become
    ``table.<op>`` spans with the rows the JAX results have; nothing
    materializes under ``torch.compile``;
  * **one metrics story** — overflow gauges, ``scan.*`` counters and
    ``spill.*`` gauges equal the JAX package's reports;
  * **exporters**, ``explain`` determinism and ``explain(analyze=True)``;
  * **the audit** — on the 4-shard contract chain the planner's
    prediction equals the exchanges counted at the choke point (2, the
    JAX jaxpr's count, ``tests/test_torch_plan.py``).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import local_context  # noqa: E402
from repro.core.report import OverflowReport as JReport  # noqa: E402
from repro.dataframe.frame import DataFrame as JDataFrame  # noqa: E402
from repro.telemetry import Collector as JCollector  # noqa: E402
from repro_torch import telemetry  # noqa: E402
from repro_torch.core import HPTMTContext, table_ops  # noqa: E402
from repro_torch.core.dataflow import TSet  # noqa: E402
from repro_torch.core.report import OverflowReport  # noqa: E402
from repro_torch.dataframe import DataFrame  # noqa: E402
from repro_torch.io import pred  # noqa: E402
from repro_torch.plan import LazyFrame  # noqa: E402
from repro_torch.telemetry import record  # noqa: E402

CPU1 = HPTMTContext(n_shards=1, device="cpu")
CPU4 = HPTMTContext(n_shards=4, device="cpu")
JCTX = local_context()


def _data(n=64, seed=0, n_keys=8):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, n_keys, n).astype(np.float32),
            "v": rng.normal(size=n).astype(np.float32)}


def _df(ctx, **kw):
    return DataFrame.from_dict(_data(**kw), ctx, bucket_factor=4.0)


def _jdf(**kw):
    return JDataFrame.from_dict(_data(**kw), JCTX, bucket_factor=4.0)


@pytest.fixture
def syncs(monkeypatch):
    """Count ``torch.cuda.synchronize`` calls (a no-op on the CPU)."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    return calls


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports itself as living on a CUDA device, so
    ``Span.block`` (which reads only these two) is tested without a card."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", int(self.dev_index))


def _fake_cuda(index: int) -> torch.Tensor:
    t = torch.Tensor._make_subclass(_FakeCuda, torch.zeros(2))
    t.dev_index = index
    return t


# ---------------------------------------------------------------------------
# off by default
# ---------------------------------------------------------------------------
def test_off_by_default_is_one_shared_noop(syncs):
    assert telemetry.current() is None
    sp = telemetry.span("anything", tagged=1)
    assert telemetry.span("else") is sp, "off path must reuse ONE object"
    with sp as s:
        s.attrs["x"] = 1
        s.block(_fake_cuda(0))
    out = _df(CPU1).select(lambda c: c["v"] > 0)
    assert len(out.to_numpy()["k"]) >= 0
    assert telemetry.current() is None
    assert syncs == [], "telemetry off must never synchronize the card"


def test_span_block_synchronizes_each_cuda_device_once(syncs):
    a, b, c = _fake_cuda(0), _fake_cuda(1), _fake_cuda(0)
    value = ({"x": a, "y": [b, torch.ones(3)]}, (c,))
    with telemetry.trace("block") as rec:
        with telemetry.span("s") as sp:
            sp.block(value)
    assert sorted(d.index for d in syncs) == [0, 1]
    assert rec.spans[0].dur_us >= 0
    # tables and frames are walked through their columns
    syncs.clear()
    df = _df(CPU1)
    record.Span("t", {}).block((df, df.table))
    assert syncs == [], "CPU tensors need no synchronization"


# ---------------------------------------------------------------------------
# honest spans
# ---------------------------------------------------------------------------
def test_eager_operator_calls_become_spans_with_rows():
    df = _df(CPU1)
    with telemetry.trace("t") as rec:
        df.groupby(["k"], [("v", "sum")])
    jrows = len(_jdf().groupby(["k"], [("v", "sum")]).to_numpy()["k"])
    names = [s.name for s in rec.all_spans()]
    assert "table.groupby" in names
    g = next(s for s in rec.all_spans() if s.name == "table.groupby")
    assert g.attrs["rows_in"] == 64
    assert g.attrs["rows_out"] == jrows == 8
    assert rec.metrics.counters["table.groupby.calls"] == 1
    assert rec.metrics.counters["table.groupby.rows_in"] == 64
    assert telemetry.current() is None, "trace() must deactivate on exit"


@pytest.mark.parametrize("ctx", [CPU1, CPU4], ids=["1shard", "4shards"])
def test_operator_span_rows_equal_jax_rows(ctx):
    """Every operator of a join → groupby → sort chain reports the rows
    the JAX package's results hold."""
    left = _data(n=96, seed=1)
    right = {"k": np.arange(8, dtype=np.float32),
             "w": np.arange(8, dtype=np.float32)}

    def chain(D, c):
        a = D.from_dict(left, c, bucket_factor=4.0)
        b = D.from_dict(right, c, bucket_factor=4.0)
        j = a.join(b, ["k"], max_matches=4)
        g = j.groupby(["k"], [("v", "sum"), ("w", "max")])
        return j, g, g.sort_values("k")

    with telemetry.trace("rows") as rec:
        chain(DataFrame, ctx)
    jj, jg, js = chain(JDataFrame, JCTX)
    # an operator's rows_in are its first table argument's (the join's
    # left side)
    want = {"table.join": (96, len(jj.to_numpy()["k"])),
            "table.groupby": (len(jj.to_numpy()["k"]),
                              len(jg.to_numpy()["k"])),
            "table.orderby": (len(jg.to_numpy()["k"]),
                              len(js.to_numpy()["k"]))}
    for name, (rin, rout) in want.items():
        sp = next(s for s in rec.all_spans() if s.name == name)
        assert (sp.attrs["rows_in"], sp.attrs["rows_out"]) == (rin, rout), \
            name
        assert rec.metrics.counters[f"{name}.rows_out"] == rout


def test_compiled_region_emits_nothing():
    calls = []

    def op(x):
        calls.append(1)
        return x * 2

    def f(x):
        with telemetry.span("inside", a=1):
            y = record.operator_call("table.fake", op, (x,), {})
        return y + 1

    cf = torch.compile(f, backend="eager")
    with telemetry.trace("compiled") as rec:
        got = cf(torch.ones(4))
        cf(torch.ones(4))
    torch.testing.assert_close(got, torch.full((4,), 3.0))
    assert list(rec.all_spans()) == [], \
        "spans must not materialize while torch.compile traces"
    assert "table.fake.calls" not in rec.metrics.counters
    # the same function run eagerly does record
    with telemetry.trace("eager") as rec2:
        f(torch.ones(4))
    assert [s.name for s in rec2.all_spans()] == ["inside", "table.fake"]


def test_nested_traces_stack():
    with telemetry.trace("outer") as outer:
        with outer.span("a"):
            with telemetry.trace("inner") as inner:
                with telemetry.span("b"):
                    pass
        with telemetry.span("c"):
            pass
    assert [s.name for s in outer.all_spans()] == ["a", "c"]
    assert [s.name for s in inner.all_spans()] == ["b"]
    assert telemetry.current() is None


# ---------------------------------------------------------------------------
# the one metrics story: OverflowReport / scan / spill / TSet
# ---------------------------------------------------------------------------
def test_overflow_report_to_metrics_and_gauges_equal_jax():
    rep = (OverflowReport().add("join.fanout", 3)
           .add_recovered("spill.join", 7).add("scan.capacity", 2))
    jrep = (JReport().add("join.fanout", 3)
            .add_recovered("spill.join", 7).add("scan.capacity", 2))
    assert rep.to_metrics() == jrep.to_metrics()
    rec, jrec = telemetry.Collector(), JCollector()
    for r, report in ((rec, rep), (jrec, jrep)):
        r.record_overflow(report)
        r.record_overflow(report)  # lineage reports are cumulative: gauges
    assert rec.metrics.gauges == jrec.metrics.gauges
    assert rec.metrics.gauges["overflow.join.fanout"] == 3


def test_scan_overflow_and_stats_reach_collector(tmp_path):
    from repro.io.scan import ScanSource as JScan

    data = {"a": np.arange(32, dtype=np.float32),
            "b": np.arange(32, dtype=np.float32)}
    path = str(tmp_path / "tele_ds")
    DataFrame.from_dict(data, CPU1).to_hpt(path, rows_per_group=8)
    with telemetry.trace("scan") as rec:
        df = DataFrame.read_parquet(path, CPU1, capacity=8, strict=False)
    lost = df.overflow_report.entries["scan.capacity"]
    assert lost > 0
    assert rec.metrics.gauges["overflow.scan.capacity"] == lost
    jsrc = JScan(path, ctx=JCTX, capacity=8)
    jsrc.to_dist_table()
    for k, v in vars(jsrc.stats).items():
        assert rec.metrics.counters[f"scan.{k}"] == v, k
    names = [s.name for s in rec.all_spans()]
    assert {"io.scan.prune", "io.scan.read", "io.scan.materialize"} \
        <= set(names)
    read = next(s for s in rec.all_spans() if s.name == "io.scan.read")
    assert read.attrs["rows_scanned"] > 0
    assert rec.metrics.gauges["scan.pressure.rss_mb"] > 0


def test_tset_publishes_reports_through_collector():
    ts = TSet.from_table(_df(CPU1).table, CPU1).select(lambda c: c["v"] > 0)
    with telemetry.trace("tset") as rec:
        ts.collect()
        assert any(s.name == "table.select" for s in rec.all_spans())
        ts._last_report = OverflowReport().add("window.truncated", 5)
        ts._publish_report()
    assert rec.metrics.gauges["overflow.window.truncated"] == 5


def test_spill_spans_and_gauges_equal_jax_stats():
    from repro.spill import spill_join as jspill_join
    from repro_torch.spill import spill_join

    rng = np.random.default_rng(2)
    n = 4096
    lk = rng.integers(0, n // 4, n).astype(np.int32)
    rk = np.arange(n // 4, dtype=np.int32)
    ldata = {"k": lk, "v": lk.astype(np.float32)}
    rdata = {"k": rk, "w": rk.astype(np.float32)}
    left = DataFrame.from_dict(ldata, CPU1).table
    right = DataFrame.from_dict(rdata, CPU1).table
    with telemetry.trace("spill") as rec:
        res = spill_join(left, right, ("k",), ctx=CPU1, budget_rows=512)
        rows = sum(int(c.num_rows()) for c in res.chunks())
        res.close()
    assert rows == n
    names = [s.name for s in rec.all_spans()]
    assert {"spill.write", "spill.read", "spill.reentry"} <= set(names)
    re_sp = next(s for s in rec.all_spans() if s.name == "spill.reentry")
    assert re_sp.attrs["op"] == "table.join"
    jres = jspill_join(JDataFrame.from_dict(ldata, JCTX).table,
                       JDataFrame.from_dict(rdata, JCTX).table, ("k",),
                       ctx=JCTX, budget_rows=512)
    js = jres.stats
    jres.close()
    g = rec.metrics.gauges
    assert (g["spill.rows_in"], g["spill.rows_out"], g["spill.pairs"]) == \
        (js.rows_in, js.rows_out, js.pairs) == (n + n // 4, n, js.pairs)
    assert g["spill.bytes_spilled"] > 0
    assert g["overflow.recovered.spill.join"] == \
        jres.report.recovered["spill.join"]
    assert g["spill.pressure.rss_mb"] > 0


def test_fault_and_retry_counters(tmp_path):
    from repro_torch.resilience import FaultPolicy, arm, fire, reset

    reset()
    try:
        arm("scan.read", "io_error")
        pol = FaultPolicy(max_retries=2, backoff_base=0.0, backoff_max=0.0)
        with telemetry.trace("faults") as rec:
            pol.run(lambda: fire("scan.read"), site="scan.read")
        assert rec.metrics.counters["fault.injected.scan.read"] == 1
        assert rec.metrics.counters["retry.scan.read"] == 1
    finally:
        reset()


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------
def test_chrome_trace_and_metrics_export(tmp_path):
    with telemetry.trace("export") as rec:
        with rec.span("parent", kind="demo"):
            with rec.span("child"):
                pass
        _df(CPU1).groupby(["k"], [("v", "sum")])
        rec.metrics.count("demo.calls", 2)
        rec.metrics.gauge("demo.level", 7)
    tpath = str(tmp_path / "trace.json")
    telemetry.export_chrome_trace(rec, tpath)
    with open(tpath) as f:
        data = json.load(f)
    evs = data["traceEvents"]
    spans = [e for e in evs if e["ph"] == "X"]
    assert {e["name"] for e in spans} == {"parent", "child",
                                          "table.groupby"}
    parent = next(e for e in spans if e["name"] == "parent")
    child = next(e for e in spans if e["name"] == "child")
    assert parent["ts"] <= child["ts"], "child opens inside parent"
    assert parent["args"]["kind"] == "demo"
    meta = [e for e in evs if e["ph"] == "M"]
    assert any(e["name"] == "process_name"
               and e["args"]["name"] == "export" for e in meta)
    tids = {e["tid"] for e in spans}
    named = {e["tid"] for e in meta if e["name"] == "thread_name"}
    assert tids <= named, "every span lane must carry a thread_name"
    counters = [e for e in evs if e["ph"] == "C"]
    level = next(e for e in counters if e["name"] == "demo.level")
    assert level["args"]["value"] == 7
    assert level["ts"] >= max(e["ts"] + e["dur"] for e in spans)

    snap = telemetry.metrics_snapshot(rec)
    assert snap["metrics"]["counters"]["demo.calls"] == 2
    assert snap["n_spans"] == 3
    mpath = str(tmp_path / "metrics.json")
    telemetry.export_metrics(rec, mpath)
    with open(mpath) as f:
        assert json.load(f)["metrics"]["counters"]["demo.calls"] == 2


# ---------------------------------------------------------------------------
# explain: determinism + analyze annotations + the audit
# ---------------------------------------------------------------------------
def _chain(D, ctx):
    big = D.from_dict(_data(n=96), ctx, bucket_factor=4.0)
    small = D.from_dict({"k": np.arange(8, dtype=np.float32),
                         "w": 10.0 + np.arange(8, dtype=np.float32)}, ctx,
                        bucket_factor=4.0)
    return (big.lazy().join(small.lazy(), ["k"], max_matches=4)
            .groupby(["k"], [("v", "sum"), ("w", "max")])
            .sort_values("k"))


def test_explain_is_byte_identical_across_runs():
    first = _chain(DataFrame, CPU1).explain()
    assert _chain(DataFrame, CPU1).explain() == first
    lf = _chain(DataFrame, CPU1)
    lf.explain(analyze=True)  # a measured run leaves the render unchanged
    assert lf.explain() == first
    assert first == _chain(JDataFrame, JCTX).explain()


@pytest.mark.parametrize("ctx", [CPU1, CPU4], ids=["1shard", "4shards"])
def test_explain_analyze_annotates_every_node(ctx):
    lf = _chain(DataFrame, ctx)
    plan = lf.physical_plan()
    txt = lf.explain(analyze=True)
    phys = txt.split("== physical plan ==")[1].splitlines()
    for s in plan.steps:
        line = next(ln for ln in phys
                    if ln.strip().startswith(f"{s.index}. "))
        assert "time=" in line, f"step {s.index} missing measured time"
        assert "rows=" in line, f"step {s.index} missing rows"
        if s.a2a:
            assert "bytes=" in line, f"step {s.index} missing bytes"
    n = plan.predicted_collectives
    assert f"audit: predicted={n} counted={n} all_to_all" in txt


def test_collect_with_telemetry_records_consistent_audit():
    lf = _chain(DataFrame, CPU4)
    with telemetry.trace("audit") as rec:
        out = lf.collect(telemetry=rec)
    assert out.overflow_report.is_exact()
    audit = rec.audits[-1]
    assert audit["consistent"] is True
    assert audit["predicted_a2a"] == audit["observed_a2a"] > 0
    assert rec.metrics.gauges["plan.predicted_a2a"] == audit["predicted_a2a"]
    plan = lf.physical_plan()
    for s in plan.steps:
        assert rec.plan_steps[s.index]["strategy"] == s.strategy
        assert rec.plan_steps[s.index]["time_us"] > 0
    # a plan whose exchanges disagree with the prediction fails strictly
    from repro_torch.plan import PlanAuditError
    from repro_torch.plan import physical

    real = physical.PhysicalPlan.predicted_collectives
    try:
        physical.PhysicalPlan.predicted_collectives = property(
            lambda self: 99)
        with pytest.raises(PlanAuditError, match="predicted 99"):
            lf.collect(telemetry=telemetry.Collector())
    finally:
        physical.PhysicalPlan.predicted_collectives = real


def test_telemetry_contract_4shards(tmp_path):
    """The representative scan → filter → join → groupby → window chain
    on 4 shards: planner 2 == counted 2 (the JAX jaxpr's count), bytes on
    the exchanging step, every step's facts, q-errors within 2.0."""
    rng = np.random.default_rng(0)
    nb = 320
    big = {"k1": rng.integers(0, 10, nb).astype(np.float32),
           "k2": rng.integers(0, 4, nb).astype(np.float32),
           "v": rng.normal(size=nb).astype(np.float32)}
    small = {"k1": np.repeat(np.arange(10), 4).astype(np.float32),
             "k2": np.tile(np.arange(4), 10).astype(np.float32),
             "w": rng.normal(size=40).astype(np.float32)}
    path = str(tmp_path / "tele4_ds")
    DataFrame.from_dict(big, CPU4, bucket_factor=4.0).to_hpt(
        path, rows_per_group=40)
    sf = DataFrame.from_dict(small, CPU4, bucket_factor=4.0)
    lf = (LazyFrame.read_parquet(path, CPU4, bucket_factor=4.0)
          .filter([pred("k1", "<", 8.0)])
          .join(sf.lazy(), ["k1", "k2"], max_matches=64)
          .groupby(["k2", "k1"], [("v", "sum"), ("w", "max")])
          .window(["k2", "k1"], ["v_sum"]).agg([("v_sum", "sum")]))
    plan = lf.physical_plan()
    with telemetry.trace("contract") as rec:
        lf.collect(telemetry=rec, qerror_threshold=2.0)
    audit = rec.audits[-1]
    assert audit["consistent"] is True, audit
    assert audit["predicted_a2a"] == audit["observed_a2a"] == 2
    assert all(e["bytes"] > 0 for e in audit["exchanges"])
    for s in plan.steps:
        facts = rec.plan_steps[s.index]
        assert facts["time_us"] > 0, (s.index, facts)
        assert facts["rows_out"] is not None
        assert facts["est_bytes"] > 0, (s.index, facts)
        assert 1.0 <= facts["qerr"] <= 2.0, (s.index, facts)
        assert facts["peak_rss_delta_kb"] >= 0, (s.index, facts)
        if s.a2a:
            assert facts["a2a_bytes"] > 0, (s.index, facts)
    assert rec.metrics.gauges["cardinality.steps_audited"] == len(
        plan.steps)
    txt = lf.explain(analyze=True)
    assert "audit: predicted=2 counted=2 all_to_all" in txt, txt
    assert txt.count("time=") >= len(plan.steps)
    # the exchanges' bytes: each one moves every shard's send frame
    assert rec.metrics.gauges["plan.observed_bytes"] == sum(
        e["bytes"] for e in audit["exchanges"])


def test_instrumentation_changes_no_result():
    lf = _chain(DataFrame, CPU4)
    plain = lf.collect().to_numpy()
    with telemetry.trace("on") as rec:
        traced = lf.collect(telemetry=rec).to_numpy()
    for k in plain:
        np.testing.assert_array_equal(plain[k], traced[k], err_msg=k)
    assert table_ops.join.op_info.name == "table.join"
    assert os.path.basename(table_ops.__file__) == "table_ops.py"
