"""Parity of the port's lazy planner (``repro_torch.plan``) with the JAX
package's (``repro.plan``), case for case with ``tests/test_plan.py``.

  * rules — the registry, each rewrite and its guard, and
    ``estimated_rows``: the same pipeline built in both packages fires the
    same rules and optimizes to the same logical plan (rendered trees
    equal), and ``explain()`` gives the JAX package's text line for line
    (no backend line is rendered without ``analyze=True``); explain reads
    no data;
  * parity — ``lazy().collect()`` gives the port's eager chain's rows, bit
    for bit (a hypothesis property over random pipelines with NaN keys,
    ±0.0 and float32-saturating values included);
  * the contract — on 4 virtual shards the planned pipeline's exchanges,
    counted at the port's choke point (``array_ops.EXCHANGES``), equal
    ``predicted_collectives`` and the JAX package's jaxpr ``all_to_all``
    count on 4 devices (one subprocess), never exceed the eager chain's,
    and are strictly fewer on the representative chains.
"""
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # tier-1 env may lack hypothesis: skip only @given tests
    from conftest import given, settings, st

import repro.plan as jplan  # noqa: E402
from repro.core import local_context  # noqa: E402
from repro.dataframe.frame import DataFrame as JDataFrame  # noqa: E402
from repro.io.scan import pred as jpred  # noqa: E402
from repro.plan.explain import render_tree as j_render_tree  # noqa: E402
from repro_torch.core import HPTMTContext, array_ops, table_ops  # noqa: E402
from repro_torch.core.report import OverflowError  # noqa: E402
from repro_torch.dataframe import DataFrame  # noqa: E402
from repro_torch.io import pred  # noqa: E402
from repro_torch.plan import LazyFrame, RULES, estimated_rows, logical, optimize  # noqa: E402
from repro_torch.plan.explain import render_physical, render_tree  # noqa: E402
from repro_torch.resilience import InjectedFault, arm, reset  # noqa: E402
from torch_parity import assert_rows_equal, bits, run_jax_4way  # noqa: E402

CPU1 = HPTMTContext(n_shards=1, device="cpu")
CPU4 = HPTMTContext(n_shards=4, device="cpu")

PORT = types.SimpleNamespace(DataFrame=DataFrame, LazyFrame=LazyFrame,
                             pred=pred, ctx=CPU1)
JAXP = types.SimpleNamespace(DataFrame=JDataFrame,
                             LazyFrame=jplan.LazyFrame, pred=jpred,
                             ctx=local_context())


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _frames(pkg, seed=0, n=48):
    rng = np.random.default_rng(seed)
    big = {"k1": rng.integers(0, 6, n).astype(np.float32),
           "k2": rng.integers(0, 3, n).astype(np.float32),
           "v": rng.normal(size=n).astype(np.float32)}
    small = {"k1": np.repeat(np.arange(6), 3).astype(np.float32),
             "k2": np.tile(np.arange(3), 6).astype(np.float32),
             "w": rng.normal(size=18).astype(np.float32)}
    return (pkg.DataFrame.from_dict(big, pkg.ctx, bucket_factor=4.0),
            pkg.DataFrame.from_dict(small, pkg.ctx, bucket_factor=4.0))


def _hpt_dataset(tmp_path):
    """8-fragment native dataset; column `a` is globally increasing, so
    range predicates on it prune fragments via manifest min/max.  The
    port writes it; both packages read the same files."""
    n = 64
    rng = np.random.default_rng(1)
    data = {"a": np.arange(n, dtype=np.float32),
            "b": (np.arange(n) % 8).astype(np.float32),
            "c": rng.normal(size=n).astype(np.float32),
            "d": rng.normal(size=n).astype(np.float32)}
    path = str(tmp_path / "plan_ds")
    DataFrame.from_dict(data, CPU1).to_hpt(path, rows_per_group=8)
    return path


def _both(build):
    """``build(pkg)`` in each package → ``(port_lf, jax_lf)``, with the
    same fired rules, the same optimized plan and the same explain()."""
    lp, lj = build(PORT), build(JAXP)
    rp, fp = optimize(lp.logical_plan)
    rj, fj = jplan.optimize(lj.logical_plan)
    assert fp == fj, (fp, fj)
    assert render_tree(rp) == j_render_tree(rj)
    assert lp.explain() == lj.explain()
    return lp, lj


# ---------------------------------------------------------------------------
# rewrite-rule units
# ---------------------------------------------------------------------------
def test_rules_registry_matches_docs():
    assert RULES == jplan.RULES == (
        "push-filter-through-project", "push-filter-through-join",
        "push-filter-into-scan", "push-projection-into-scan",
        "drop-redundant-exchange", "reorder-join-inputs",
        "choose-range-layout")


def test_push_filter_and_projection_into_scan(tmp_path):
    path = _hpt_dataset(tmp_path)
    lf, _ = _both(lambda p: p.LazyFrame.read_parquet(path, p.ctx)
                  .filter([p.pred("a", "<", 16.0)]).project(["a", "c"]))
    root, fired = optimize(lf.logical_plan)
    assert "push-filter-into-scan" in fired
    assert "push-projection-into-scan" in fired
    assert root.kind == "project" and root.inputs[0].kind == "scan"
    scan = root.inputs[0]
    assert scan.payload["predicate"], "predicate did not reach the scan"
    assert set(scan.payload["columns"]) == {"a", "c"}
    txt = lf.explain()
    assert "fragments 2/8" in txt and "push-filter-into-scan" in txt


def test_push_filter_through_project_and_fuse():
    def build(p):
        bf, _ = _frames(p)
        return (bf.lazy().project(["k1", "v"])
                .filter([p.pred("v", ">", 0.0)])
                .filter([p.pred("k1", "<", 4.0)]))
    lf, _ = _both(build)
    root, fired = optimize(lf.logical_plan)
    assert "push-filter-through-project" in fired
    assert root.kind == "project"
    assert root.inputs[0].kind == "filter"
    assert len(root.inputs[0].payload["predicate"]) == 2


def test_push_filter_through_join_inner_only():
    def inner(p):
        bf, sf = _frames(p)
        return (bf.lazy().join(sf.lazy(), ["k1", "k2"], max_matches=4)
                .filter([p.pred("v", ">", 0.0), p.pred("w", "<", 1.0)]))

    def left(p):
        bf, sf = _frames(p)
        return (bf.lazy().join(sf.lazy(), ["k1", "k2"], how="left",
                               max_matches=4)
                .filter([p.pred("v", ">", 0.0)]))
    lf, _ = _both(inner)
    root, fired = optimize(lf.logical_plan)
    assert "push-filter-through-join" in fired
    assert root.kind == "join"
    lf_l, _ = _both(left)
    assert "push-filter-through-join" not in optimize(lf_l.logical_plan)[1]


def test_generated_join_columns_never_pushed():
    def build(p):
        bf, sf = _frames(p)
        return (bf.lazy().join(sf.lazy(), ["k1", "k2"], max_matches=4)
                .filter([p.pred("_matched", "==", 1.0)]))
    lf, _ = _both(build)
    root, fired = optimize(lf.logical_plan)
    assert "push-filter-through-join" not in fired
    assert root.kind == "filter"


def test_drop_redundant_exchange():
    def dead(p):
        bf, _ = _frames(p)
        return bf.lazy().repartition(["v"]).groupby(["k1"], [("v", "sum")])

    def keep(p):
        bf, _ = _frames(p)
        return bf.lazy().repartition(["k1"]).groupby(["k1"], [("v", "sum")])

    def topk(p):
        bf, _ = _frames(p)
        return bf.lazy().repartition(["k1"]).topk(["v"], 7)
    lf, _ = _both(dead)
    root, fired = optimize(lf.logical_plan)
    assert "drop-redundant-exchange" in fired
    assert all(n.kind != "repartition" for n in logical.walk(root))
    for build in (keep, topk):
        lf, _ = _both(build)
        root, fired = optimize(lf.logical_plan)
        assert "drop-redundant-exchange" not in fired
        assert any(n.kind == "repartition" for n in logical.walk(root))


def _tiny_wide(p, literal_r=False):
    tiny = {"k": np.arange(4, dtype=np.float32),
            "x": 100.0 + np.arange(4, dtype=np.float32)}
    if literal_r:
        tiny["x_r"] = np.arange(4, dtype=np.float32)
    wide = {"k": (np.arange(40) % 4).astype(np.float32),
            "x": np.arange(40, dtype=np.float32)}
    return (p.DataFrame.from_dict(tiny, p.ctx, bucket_factor=4.0),
            p.DataFrame.from_dict(wide, p.ctx, bucket_factor=4.0))


def test_reorder_join_inputs_and_collision_guard():
    def opted(p, literal_r=False, reorder=True):
        tiny, wide = _tiny_wide(p, literal_r)
        return tiny.lazy().join(wide.lazy(), ["k"], max_matches=16,
                                reorder=reorder)
    lf, _ = _both(opted)
    root, fired = optimize(lf.logical_plan)
    assert "reorder-join-inputs" in fired and root.payload["swap"]
    assert "swapped" in lf.explain()
    for kw in ({"reorder": False}, {"literal_r": True}):
        lf, _ = _both(lambda p: opted(p, **kw))
        root, fired = optimize(lf.logical_plan)
        assert "reorder-join-inputs" not in fired and not root.payload["swap"]


def test_reorder_opt_in_guards_max_matches_cap():
    """table_ops.join caps fan-out per LEFT row, so a swap caps the OTHER
    side: the rule stays off by default, and opting in surfaces the
    overflow instead of silently dropping matches."""
    left = DataFrame.from_dict(
        {"k": np.zeros(8, np.float32),
         "v": np.arange(8, dtype=np.float32)}, CPU1, bucket_factor=4.0)
    right = DataFrame.from_dict(
        {"k": np.arange(20, dtype=np.float32),
         "w": 50.0 + np.arange(20, dtype=np.float32)}, CPU1,
        bucket_factor=4.0)
    lf = left.lazy().join(right.lazy(), ["k"], max_matches=1)
    root, fired = optimize(lf.logical_plan)
    assert "reorder-join-inputs" not in fired and not root.payload["swap"]
    assert_rows_equal(lf.collect().to_numpy(),
                      left.join(right, ["k"], max_matches=1).to_numpy())
    opt = left.lazy().join(right.lazy(), ["k"], max_matches=1,
                           reorder=True)
    assert "reorder-join-inputs" in optimize(opt.logical_plan)[1]
    with pytest.raises(OverflowError):
        opt.collect()


def test_choose_range_layout():
    def build(p):
        bf, _ = _frames(p)
        return bf.lazy().groupby(["k1"], [("v", "sum")]).sort_values("k1")
    lf, lj = _both(build)
    root, fired = optimize(lf.logical_plan)
    assert "choose-range-layout" in fired
    assert root.inputs[0].payload["layout"] == "range"
    plan = lf.physical_plan()
    assert [s.strategy for s in plan.steps if s.op == "groupby"] \
        == ["range-exchange"]
    assert [s.strategy for s in plan.steps if s.op == "orderby"] \
        == ["local-sort"]
    jsteps = lj.physical_plan().steps
    assert [(s.op, s.strategy, s.a2a, s.stage, s.est_rows, s.est_bytes)
            for s in plan.steps] == [
        (s.op, s.strategy, s.a2a, s.stage, s.est_rows, s.est_bytes)
        for s in jsteps]

    def other(p):
        bf, _ = _frames(p)
        return bf.lazy().groupby(["k1"], [("v", "sum")]).sort_values("v_sum")
    lf, _ = _both(other)
    assert "choose-range-layout" not in optimize(lf.logical_plan)[1]


def test_estimated_rows(tmp_path):
    path = _hpt_dataset(tmp_path)
    for kw in ({}, {"predicate": [("a", "<", 16.0)]}):
        lf, lj = _both(lambda p: p.LazyFrame.read_parquet(path, p.ctx, **kw))
        assert estimated_rows(lf.logical_plan) == \
            jplan.estimated_rows(lj.logical_plan)
    full = LazyFrame.read_parquet(path, CPU1).logical_plan
    assert estimated_rows(full) == 64.0
    pruned = LazyFrame.read_parquet(
        path, CPU1, predicate=[pred("a", "<", 16.0)]).logical_plan
    assert 0.0 < estimated_rows(pruned) <= 16.0
    bf, _ = _frames(PORT)
    assert estimated_rows(bf.lazy().topk(["v"], 5).logical_plan) == 5.0


# ---------------------------------------------------------------------------
# physical strategies (layout tracking across operator chains)
# ---------------------------------------------------------------------------
def test_join_groupby_elision_strategies():
    def build(p):
        bf, sf = _frames(p)
        return (bf.lazy().repartition(["k1", "k2"])
                .join(sf.lazy().repartition(["k1", "k2"]), ["k1", "k2"],
                      max_matches=4)
                .groupby(["k2", "k1"], [("v", "sum")]))
    lf, _ = _both(build)
    by_op = {s.op: s.strategy for s in lf.physical_plan().steps}
    assert by_op["join"] == "elide-left+right"
    assert by_op["groupby"] == "elide(co-located)"


def test_window_coloc_and_lead_guard():
    def build(p, agg):
        bf, _ = _frames(p)
        return bf.lazy().repartition(["k1"]).window(["k1"], ["v"]).agg([agg])
    ok, _ = _both(lambda p: build(p, ("v", "sum")))
    assert [s.strategy for s in ok.physical_plan().steps
            if s.op == "window"] == ["local-sort(co-located)"]
    lead, _ = _both(lambda p: build(p, ("v", "lead")))
    assert [s.strategy for s in lead.physical_plan().steps
            if s.op == "window"] == ["range-exchange"]


def test_orderby_elision_after_sort():
    def build(p):
        bf, _ = _frames(p)
        return bf.lazy().sort_values(["k1", "v"]).sort_values(["k1", "v"])
    lf, _ = _both(build)
    assert [s.strategy for s in lf.physical_plan().steps
            if s.op == "orderby"] == ["range-exchange", "elide(sorted)"]


# ---------------------------------------------------------------------------
# explain stability
# ---------------------------------------------------------------------------
def test_explain_is_stable_and_golden(tmp_path):
    path = _hpt_dataset(tmp_path)
    lf, _ = _both(lambda p: p.LazyFrame.read_parquet(path, p.ctx)
                  .filter([p.pred("a", "<", 32.0)]).project(["a", "c"])
                  .sort_values("a"))
    first, second = lf.explain(), lf.explain()
    assert first == second, "explain() must be deterministic"
    for needle in ("== logical plan ==", "== rewrites ==",
                   "== optimized plan ==", "== physical plan ==",
                   "push-filter-into-scan", "push-projection-into-scan",
                   "predicted collectives:", "scan[8 fragments",
                   "orderby[a]"):
        assert needle in first, f"missing {needle!r} in:\n{first}"
    # callable predicates render opaquely (no memory addresses)
    cf, cj = _both(lambda p: _frames(p)[0].lazy()
                   .filter(lambda cols: cols["v"] > 0))
    assert "filter[<fn>]" in cf.explain()
    assert cf.explain() == cf.explain()


def test_explain_backend_line_names_the_choke_point():
    bf, _ = _frames(PORT)
    plan = bf.lazy().repartition(["k1"]).physical_plan()
    txt = render_physical(plan, audit={"predicted_a2a": 1,
                                       "observed_a2a": 1})
    last = txt.splitlines()[-1]
    assert last == ("  audit: predicted=1 counted=1 all_to_all at the "
                    "exchange choke point")
    assert "HLO" not in txt


def test_explain_reads_no_data(tmp_path, monkeypatch):
    path = _hpt_dataset(tmp_path)
    lf = LazyFrame.read_parquet(path, CPU1).filter([pred("a", "<", 8.0)])
    from repro_torch.io import scan as scan_mod

    def boom(self):
        raise AssertionError("explain() must not materialize the scan")
    monkeypatch.setattr(scan_mod.ScanSource, "to_dist_table", boom)
    assert "predicted collectives" in lf.explain()


# ---------------------------------------------------------------------------
# parity vs the eager oracle (one shard; every strategy still runs)
# ---------------------------------------------------------------------------
def test_parity_join_groupby_orderby():
    bf, sf = _frames(PORT)
    exp = (bf.join(sf, ["k1", "k2"], max_matches=4)
           .groupby(["k2", "k1"], [("v", "sum"), ("w", "max")])
           .sort_values(["k2", "k1"]))
    got = (bf.lazy().join(sf.lazy(), ["k1", "k2"], max_matches=4)
           .groupby(["k2", "k1"], [("v", "sum"), ("w", "max")])
           .sort_values(["k2", "k1"]).collect())
    ge, gg = exp.to_numpy(), got.to_numpy()
    assert sorted(ge) == sorted(gg)
    for c in ge:  # unique sorted keys ⇒ full order is deterministic
        np.testing.assert_array_equal(bits(gg[c]), bits(ge[c]), err_msg=c)


def test_parity_window_chain():
    bf, sf = _frames(PORT)

    def chain(a, b):
        return (a.join(b, ["k1", "k2"], max_matches=4)
                .groupby(["k2", "k1"], [("v", "sum"), ("w", "max")])
                .window(["k2", "k1"], ["v_sum"]).agg([("v_sum", "sum")]))

    assert_rows_equal(chain(bf.lazy(), sf.lazy()).collect().to_numpy(),
                      chain(bf, sf).to_numpy())


def test_parity_scan_pushdown(tmp_path):
    path = _hpt_dataset(tmp_path)
    exp = DataFrame.read_parquet(path, CPU1, columns=["a", "c"],
                                 predicate=[pred("a", "<", 16.0)])
    got = (LazyFrame.read_parquet(path, CPU1)
           .filter([pred("a", "<", 16.0)]).project(["a", "c"]).collect())
    ge, gg = exp.to_numpy(), got.to_numpy()
    assert sorted(ge) == sorted(gg) == ["a", "c"]
    for c in ge:
        np.testing.assert_array_equal(gg[c], ge[c], err_msg=c)


def test_parity_swapped_join_with_duplicate_columns():
    tiny, wide = _tiny_wide(PORT)
    lf = tiny.lazy().join(wide.lazy(), ["k"], max_matches=16,
                          reorder=True)
    assert "reorder-join-inputs" in optimize(lf.logical_plan)[1]
    assert_rows_equal(lf.collect().to_numpy(),
                      tiny.join(wide, ["k"], max_matches=16).to_numpy())


def test_literal_key_suffix_column_survives_projection(tmp_path):
    """A dataset column literally named `k_r` where `k` is a join key is
    NOT a join-generated duplicate: required-column analysis keeps it on
    the right-side scan."""
    n = 8
    data = {"k": np.arange(n, dtype=np.float32),
            "k_r": 10.0 + np.arange(n, dtype=np.float32),
            "w": np.ones(n, np.float32)}
    path = str(tmp_path / "kr_ds")
    DataFrame.from_dict(data, CPU1).to_hpt(path, rows_per_group=4)

    def build(p):
        left = p.DataFrame.from_dict(
            {"k": np.arange(n, dtype=np.float32),
             "v": np.arange(n, dtype=np.float32)}, p.ctx, bucket_factor=4.0)
        return (left.lazy()
                .join(p.LazyFrame.read_parquet(path, p.ctx), ["k"],
                      max_matches=1).project(["k", "k_r"]))
    lf, _ = _both(build)
    root, fired = optimize(lf.logical_plan)
    scans = [nd for nd in logical.walk(root) if nd.kind == "scan"]
    assert len(scans) == 1
    assert "k_r" in scans[0].payload["columns"]
    assert "w" not in scans[0].payload["columns"]
    assert "push-projection-into-scan" in fired
    assert_rows_equal(lf.collect().to_numpy(),
                      {"k": data["k"], "k_r": data["k_r"]})


def test_parity_topk_and_repartition():
    bf, _ = _frames(PORT)
    exp = bf.repartition(["k1"]).topk(["v"], 7, largest=True)
    got = bf.lazy().repartition(["k1"]).topk(["v"], 7, largest=True)
    assert_rows_equal(got.collect().to_numpy(), exp.to_numpy())


def test_overflow_parity_and_strict_escape():
    dup = {"k": np.zeros(8, np.float32),
           "v": np.arange(8, dtype=np.float32)}
    a = DataFrame.from_dict(dup, CPU1, bucket_factor=4.0)
    b = DataFrame.from_dict(dup, CPU1, bucket_factor=4.0)
    with pytest.raises(OverflowError):
        a.join(b, ["k"], max_matches=1)  # 8 matches per row
    lazy = a.lazy().join(b.lazy(), ["k"], max_matches=1)
    with pytest.raises(OverflowError):
        lazy.collect()
    out = lazy.collect(strict=False)  # caller owns the exactness decision
    assert not out.overflow_report.is_exact()
    assert any(k.startswith("plan.") and v > 0
               for k, v in out.overflow_report)


def test_build_time_validation():
    bf, sf = _frames(PORT)
    with pytest.raises(ValueError, match="unknown column"):
        bf.lazy().filter([pred("nope", "<", 1.0)])
    with pytest.raises(ValueError, match="unknown aggregate"):
        bf.lazy().groupby(["k1"], [("v", "median")])
    with pytest.raises(TypeError, match="call .lazy"):
        bf.lazy().join(sf, ["k1"])
    with pytest.raises(ValueError, match="positive int"):
        bf.lazy().topk(["v"], 0)


def test_runtime_services_wait_for_item_9(tmp_path):
    # item 9 is ported: every runtime service of collect() gives the
    # plain collect's rows
    from repro_torch import telemetry
    from repro_torch.resilience import FaultPolicy

    bf, _ = _frames(PORT)
    lf = bf.lazy().groupby(["k1"], [("v", "sum")])
    want = lf.collect().to_numpy()
    rec = telemetry.Collector()
    for kw in ({"telemetry": rec},
               {"policy": FaultPolicy(checkpoint_dir=str(tmp_path / "s"))},
               {"ledger": str(tmp_path / "l.jsonl")},
               {"telemetry": telemetry.Collector(), "qerror_threshold": 100.0}):
        assert_rows_equal(lf.collect(**kw).to_numpy(), want)
    assert len(telemetry.ledger_read(str(tmp_path / "l.jsonl"))) == 1
    assert_rows_equal(lf.refine(rec).collect().to_numpy(), want)
    assert "audit: predicted=0 counted=0" in lf.explain(analyze=True)
    # jit= keeps its keyword and runs the same eager program
    assert_rows_equal(lf.collect(jit=True).to_numpy(),
                      lf.collect(jit=False).to_numpy())


def test_plan_step_fault_site_fires_then_disarms():
    bf, _ = _frames(PORT)
    lf = bf.lazy().groupby(["k1"], [("v", "sum")])
    reset()
    try:
        arm("plan.step.1", "io_error")
        with pytest.raises(InjectedFault):
            lf.collect()
        assert_rows_equal(lf.collect().to_numpy(),
                          bf.groupby(["k1"], [("v", "sum")]).to_numpy())
    finally:
        reset()


# ---------------------------------------------------------------------------
# property suite: random pipelines, NaN keys, ±0.0, saturating values
# ---------------------------------------------------------------------------
_KEY_POOL = (0.0, -0.0, 1.0, 2.5, float("nan"))
_VAL_POOL = (0.0, -0.0, 1.5, -3.25, 6.5e7, float(2 ** 31), 3.4e38)


@settings(max_examples=12, deadline=None)
@given(data=st.data())
def test_property_random_pipeline_matches_eager(data):
    n = data.draw(st.integers(min_value=6, max_value=28), label="rows")
    k = np.asarray(data.draw(st.lists(st.sampled_from(_KEY_POOL),
                                      min_size=n, max_size=n)), np.float32)
    v = np.asarray(data.draw(st.lists(st.sampled_from(_VAL_POOL),
                                      min_size=n, max_size=n)), np.float32)
    base = {"k": k, "v": v, "u": np.arange(n, dtype=np.float32)}
    df = DataFrame.from_dict(base, CPU1, bucket_factor=4.0)
    lf = df.lazy()
    for op in data.draw(st.lists(
            st.sampled_from(["filter", "sort", "repart"]), max_size=2),
            label="mid"):
        if op == "filter":
            t = data.draw(st.sampled_from([0.0, 1.5, -3.25]))
            df = df.select(lambda cols, _t=t: cols["v"] >= _t)
            lf = lf.filter([pred("v", ">=", t)])
        elif op == "sort":
            df, lf = df.sort_values(["k", "u"]), lf.sort_values(["k", "u"])
        else:
            df, lf = df.repartition(["k"]), lf.repartition(["k"])
    tail = data.draw(st.sampled_from(["groupby", "window", "topk", "none"]),
                     label="tail")
    if tail == "groupby":
        aggs = [("v", "sum"), ("v", "count"), ("v", "min")]
        df, lf = df.groupby(["k"], aggs), lf.groupby(["k"], aggs)
    elif tail == "window":
        # order key `u` is unique ⇒ in-partition order (and thus every
        # running aggregate) is deterministic under any row placement
        df = df.window(["k"], ["u"]).agg([("v", "sum")])
        lf = lf.window(["k"], ["u"]).agg([("v", "sum")])
    elif tail == "topk":
        df, lf = df.topk(["v", "u"], 5), lf.topk(["v", "u"], 5)
    out = lf.collect(strict=False, jit=False)
    assert out.overflow_report.is_exact()
    assert_rows_equal(out.to_numpy(), df.to_numpy())


# ---------------------------------------------------------------------------
# the 4-shard contract: counter == predicted == JAX's jaxpr, planned < eager
# ---------------------------------------------------------------------------
# integer-valued floats: sums are exact in any order, so the port's rows
# (float64 plain segment sums) compare to JAX's bit for bit
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
#: chip_smoke.py phase 14's chain, at a small size: scan -> filter ->
#: join -> groupby -> window
SCAN_L = {"k": _C.integers(0, 64, 512).astype(np.int32),
          "g": _C.integers(0, 8, 512).astype(np.int32),
          "v": _C.integers(-20, 20, 512).astype(np.float32)}
SCAN_R = {"k": _C.permutation(64).astype(np.int32),
          "w": _C.integers(-20, 20, 64).astype(np.float32)}
SCAN_GAGGS = [("v", "sum"), ("v", "count"), ("v", "min"), ("w", "max")]
SCAN_WAGGS = [("v_sum", "sum"), ("v_count", "sum"), ("v_min", "min")]


def _chains(p, ctx, path):
    """The three chains as ``(eager_fn, eager inputs, lazy frame)`` in
    package ``p`` — the same code builds them in both packages."""
    tops = p.table_ops
    bf = p.DataFrame.from_dict(BIG4, ctx, bucket_factor=4.0)
    sf = p.DataFrame.from_dict(SMALL4, ctx, bucket_factor=4.0)

    def chain(lt, rt):
        j, _ = tops.join(lt, rt, KEYS, ctx=ctx, how="inner", max_matches=64)
        g, _ = tops.groupby_aggregate(j, GKEYS, AGGS, ctx=ctx)
        w, _ = tops.window_aggregate(g, GKEYS, ["v_sum"], WAGGS, ctx=ctx)
        return w.columns

    def gbob(dt):
        g, _ = tops.groupby_aggregate(dt, ["k1"], [("v", "sum")], ctx=ctx)
        s, _ = tops.orderby(g, ["k1"], ctx=ctx)
        return s.columns

    sl = p.DataFrame.read_parquet(path, ctx, bucket_factor=2.0)
    sr = p.DataFrame.from_dict(SCAN_R, ctx, bucket_factor=2.0)
    mask = p.pred("v", ">", 0.0).mask

    def scan_chain(lt, rt):
        f = tops.select(lt, mask, ctx=ctx)
        j, _ = tops.join(f, rt, ["k"], ctx=ctx)
        g, _ = tops.groupby_aggregate(j, ["k"], SCAN_GAGGS, ctx=ctx)
        w, _ = tops.window_aggregate(g, ["k"], ["v_sum"], SCAN_WAGGS,
                                     ctx=ctx, rows=32)
        return w.columns

    return {
        "chain": (chain, (bf.table, sf.table),
                  bf.lazy().join(sf.lazy(), KEYS, max_matches=64)
                  .groupby(GKEYS, AGGS).window(GKEYS, ["v_sum"]).agg(WAGGS)),
        "gbob": (gbob, (bf.table,),
                 bf.lazy().groupby(["k1"], [("v", "sum")]).sort_values("k1")),
        "scan": (scan_chain, (sl.table, sr.table),
                 p.LazyFrame.read_parquet(path, ctx, bucket_factor=2.0)
                 .filter([p.pred("v", ">", 0.0)]).join(sr.lazy(), ["k"])
                 .groupby(["k"], SCAN_GAGGS)
                 .window(["k"], ["v_sum"]).agg(SCAN_WAGGS, rows=32)),
    }


@pytest.fixture(scope="module")
def scan_ds(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("plan4") / "left")
    DataFrame.from_dict(SCAN_L, CPU1).to_hpt(path, rows_per_group=64)
    return path


@pytest.fixture(scope="module")
def jax4(scan_ds):
    return run_jax_4way(f"""
        import types
        from repro.dataframe.frame import DataFrame
        from repro.io.scan import pred
        from repro.plan import LazyFrame
        sys.path.insert(0, {os.path.dirname(__file__)!r})
        from test_torch_plan import _chains

        p = types.SimpleNamespace(DataFrame=DataFrame, LazyFrame=LazyFrame,
                                  pred=pred, table_ops=table_ops)
        for name, (fn, tables, lf) in _chains(p, ctx, {scan_ds!r}).items():
            plan = lf.physical_plan()
            out[name + "/counts"] = np.array(
                [a2a_count(fn, *tables), a2a_count(plan.fn, *plan.inputs()),
                 plan.predicted_collectives])
            for k, v in lf.collect().to_numpy().items():
                out[name + "/rows/" + k] = v
    """, {})


@pytest.mark.parametrize("name,want", [("chain", (4, 2, 2)),
                                       ("gbob", (2, 1, 1)),
                                       ("scan", (3, 2, 2))])
def test_plan_contract_4way(jax4, scan_ds, name, want):
    p = types.SimpleNamespace(DataFrame=DataFrame, LazyFrame=LazyFrame,
                              pred=pred, table_ops=table_ops)
    fn, tables, lf = _chains(p, CPU4, scan_ds)[name]
    array_ops.EXCHANGES.reset()
    fn(*tables)
    eager = array_ops.EXCHANGES.n
    plan = lf.physical_plan()
    inputs = plan.inputs()
    array_ops.EXCHANGES.reset()
    plan.fn(*inputs)
    planned = array_ops.EXCHANGES.n
    got = (eager, planned, plan.predicted_collectives)
    print(f"{name.upper()} eager=%d planned=%d predicted=%d" % got)
    assert got == tuple(jax4[name + "/counts"]) == want
    assert planned < eager, "the planned chain must be strictly cheaper"
    out = lf.collect()
    assert out.overflow_report.is_exact()
    pre = name + "/rows/"
    want_rows = {k[len(pre):]: v for k, v in jax4.items()
                 if k.startswith(pre)}
    assert_rows_equal(out.to_numpy(), want_rows, msg=name)


def test_plan_contract_1shard_makes_no_exchange(scan_ds):
    p = types.SimpleNamespace(DataFrame=DataFrame, LazyFrame=LazyFrame,
                              pred=pred, table_ops=table_ops)
    for name, (fn, tables, lf) in _chains(p, CPU1, scan_ds).items():
        plan = lf.physical_plan()
        assert plan.predicted_collectives == 0
        assert any(s.stage for s in plan.steps), name
        array_ops.EXCHANGES.reset()
        plan.fn(*plan.inputs())
        fn(*tables)
        assert array_ops.EXCHANGES.n == 0, name
