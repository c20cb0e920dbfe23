"""Parity of the port's TSet dataflow (``repro_torch.core.dataflow``) with
the JAX package's (``repro.core.dataflow``).

  * every operator and sink — select, project, map_columns, the combiner
    groupby, join, orderby, union, window, topk; collect, reduce,
    quantile, to_numpy, lazy — on 1 shard and on 4: the same valid rows
    in the same places (bitwise; sums and means to ``1e-5 * sum|v|``),
    the same per-shard counts and partitioning, the same
    ``overflow_report`` labels, and exchanges counted at the port's choke
    point (``array_ops.EXCHANGES``) equal to the JAX package's jaxpr
    ``all_to_all`` count (all 4-shard JAX cases in one subprocess);
  * the combiner barrier — one exchange a chunk, none at the merge;
  * the bridges — ``TSet.from_spill`` / ``SpillResult.to_tset``,
    ``ScanSource.to_tset`` and ``TSet.lazy``;
  * ``reduce("mean")`` — the port returns the true mean where the
    reference averages per-chunk means (ROADMAP Queue 3);
  * the training data pipeline's ``preprocess`` (a TSet select, project,
    join and collect, then an orderby) on 4 shards, its JAX side in the
    same subprocess.
"""
import json
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core.dataflow as jflow  # noqa: E402
from repro.core import local_context  # noqa: E402
from repro.core import table_ops as jops  # noqa: E402
from repro.dataframe.frame import DataFrame as JDataFrame  # noqa: E402
from repro_torch.core import HPTMTContext, array_ops, table_ops  # noqa: E402
from repro_torch.core.dataflow import TSet  # noqa: E402
from repro_torch.dataframe import DataFrame  # noqa: E402
from torch_parity import assert_sums_close, bits, run_jax_4way  # noqa: E402

CPU1 = HPTMTContext(n_shards=1, device="cpu")
CPU4 = HPTMTContext(n_shards=4, device="cpu")
JCTX = local_context()

N, KEYS, GROUPS = 192, 24, 6
AGGS = (("v", "sum"), ("v", "mean"), ("v", "min"), ("v", "max"),
        ("v", "count"))


def _data(seed=0):
    rng = np.random.default_rng(seed)
    left = {"k": rng.integers(0, KEYS, N).astype(np.int32),
            "g": rng.integers(0, GROUPS, N).astype(np.int32),
            "v": rng.standard_normal(N).astype(np.float32)}
    right = {"k": rng.permutation(KEYS).astype(np.int32),
             "w": rng.standard_normal(KEYS).astype(np.float32)}
    events = {"g": rng.integers(0, GROUPS, N).astype(np.int32),
              "t": rng.integers(0, 32, N).astype(np.int32),
              "v": rng.standard_normal(N).astype(np.float32)}
    return left, right, events


LEFT, RIGHT, EVENTS = _data()
#: the tolerance scale of every float sum: sum|v| over the whole input
SCALE = float(np.abs(LEFT["v"]).astype(np.float64).sum()
              + np.abs(EVENTS["v"]).astype(np.float64).sum()
              + KEYS * np.abs(RIGHT["w"]).astype(np.float64).max())


def _pipelines(p, ctx):
    """``name -> thunk`` building each TSet pipeline in package ``p`` —
    the same code runs in both packages (the JAX subprocess imports it).
    A thunk returns ``(tset, sink)``: ``sink`` is ``"collect"`` or a
    ``(method, args)`` call on the TSet."""
    bf = 2.0
    lt = p.DataFrame.from_dict(LEFT, ctx, bucket_factor=bf).table
    rt = p.DataFrame.from_dict(RIGHT, ctx, bucket_factor=bf).table
    et = p.DataFrame.from_dict(EVENTS, ctx, bucket_factor=bf).table
    ch = lt.capacity // 4  # four chunks a table

    def left():
        return p.TSet.from_table(lt, ctx, chunk_rows=ch)

    def right():
        return p.TSet.from_table(rt, ctx,
                                 chunk_rows=max(1, rt.capacity // 2))

    def events():
        return p.TSet.from_table(et, ctx, chunk_rows=et.capacity // 4)

    return {
        "select_groupby_k": lambda: (
            left().select(lambda c: c["v"] > 0).groupby(["k"], AGGS),
            "collect"),
        "groupby_g": lambda: (left().groupby(["g"], AGGS), "collect"),
        "project_map": lambda: (
            left().project(["k", "v"])
            .map_columns(lambda c: {"v2": c["v"] * 2.0}), "collect"),
        "join_groupby": lambda: (
            left().join(right(), ["k"])
            .groupby(["g"], (("v", "sum"), ("w", "max"))), "collect"),
        "orderby": lambda: (left().orderby(["k", "v"]), "collect"),
        "union": lambda: (left().project(["k"])
                          .union(right().project(["k"])), "collect"),
        "window": lambda: (
            events().window(["g"], ["t"], [("v", "sum")], rows=4),
            "collect"),
        "topk": lambda: (left().topk("v", 10), "collect"),
        "reduce_sum": lambda: (left(), ("reduce", ("v", "sum"))),
        "reduce_count": lambda: (left(), ("reduce", ("v", "count"))),
        "reduce_min": lambda: (left(), ("reduce", ("v", "min"))),
        "reduce_max": lambda: (left(), ("reduce", ("v", "max"))),
        "quantile": lambda: (left().select(lambda c: c["v"] > -1.0),
                             ("quantile", ("v", [0.1, 0.5, 0.9]))),
    }


#: exchanges each pipeline makes on 4 shards (the JAX jaxpr agrees):
#: the combiner groupby one a chunk and none at the merge
WANT_A2A = {"select_groupby_k": 4, "groupby_g": 4, "project_map": 0,
            "join_groupby": 3, "orderby": 1, "union": 2, "window": 1,
            "topk": 0, "reduce_sum": 0, "reduce_count": 0, "reduce_min": 0,
            "reduce_max": 0, "quantile": 0}


def _port():
    return types.SimpleNamespace(DataFrame=DataFrame, TSet=TSet)


def _jax():
    return types.SimpleNamespace(DataFrame=JDataFrame, TSet=jflow.TSet)


def _sink(ts, sink):
    if sink == "collect":
        return ts.collect()
    name, args = sink
    return getattr(ts, name)(*args)


def _rows_of(out):
    """Valid rows (shard order), per-shard counts and partitioning of a
    collected table."""
    counts = np.asarray(out.counts)
    return out.to_numpy(), counts, repr(out.partitioning)


def _is_sum(col):
    return col.endswith(("_sum", "_mean"))


def assert_same_rows(got, want, msg=""):
    """Same columns row for row: bitwise, sums and means to tolerance."""
    assert sorted(got) == sorted(want), (msg, sorted(got), sorted(want))
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (msg, k, g.dtype,
                                                           w.dtype)
        if _is_sum(k):
            assert_sums_close(g, w, SCALE, msg=f"{msg}:{k}")
        else:
            np.testing.assert_array_equal(bits(g), bits(w),
                                          err_msg=f"{msg}:{k}")


def _port_case(name, ctx):
    build = _pipelines(_port(), ctx)[name]
    ts, sink = build()
    array_ops.EXCHANGES.reset()
    out = _sink(ts, sink)
    return out, array_ops.EXCHANGES.n, ts.overflow_report


def _assert_case(name, out, report, jout, jreport_entries):
    assert sorted(report.entries) == sorted(jreport_entries), name
    if isinstance(out, torch.Tensor):
        np.testing.assert_allclose(out.numpy().astype(np.float64),
                                   np.asarray(jout, np.float64),
                                   rtol=0, atol=1e-5 * SCALE, err_msg=name)
        if name in ("reduce_count", "reduce_min", "reduce_max"):
            np.testing.assert_array_equal(bits(out.numpy()),
                                          bits(np.asarray(jout)))
        return
    rows, counts, part = _rows_of(out)
    jrows, jcounts, jpart = jout
    np.testing.assert_array_equal(counts, jcounts, err_msg=name)
    assert part == jpart, (name, part, jpart)
    assert_same_rows(rows, jrows, msg=name)


# ---------------------------------------------------------------------------
# 1 shard: JAX in process
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(WANT_A2A))
def test_tset_1shard_matches_jax(name):
    out, ex, report = _port_case(name, CPU1)
    assert ex == 0, (name, ex)
    jts, jsink = _pipelines(_jax(), JCTX)[name]()
    jout = _sink(jts, jsink)
    if not isinstance(jout, jax.Array):
        jout = _rows_of(jout)
    _assert_case(name, out, report, jout, jts.overflow_report.entries)
    assert report.is_exact()


# ---------------------------------------------------------------------------
# 4 shards: all JAX cases in one subprocess
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax4():
    return run_jax_4way(f"""
        import json, types
        import repro.core.dataflow as jflow
        from repro.core.report import OverflowReport
        from repro.dataframe.frame import DataFrame
        sys.path.insert(0, {os.path.dirname(__file__)!r})
        from test_torch_dataflow import _pipelines, _sink

        # each pipeline runs as ONE jitted program (eager shard_map is
        # ~10x slower).  Overflow counts are traced values there, so the
        # report's adds and the window's truncation count are returned
        # as outputs and summed into labels after the call.
        real_add = OverflowReport.add
        real_window = jflow.table_ops.window_aggregate

        def program(build):
            ts, sink = build()
            seen = []

            def prog():
                def add(self, source, count):
                    seen.append((source, count))
                    return self

                def window(*a, **k):
                    res, ov = real_window(*a, **k)
                    seen.append(("window.truncated", ov))
                    return res, 0

                OverflowReport.add = add
                jflow.table_ops.window_aggregate = window
                try:
                    res = _sink(ts, sink)
                finally:
                    OverflowReport.add = real_add
                    jflow.table_ops.window_aggregate = real_window
                return res, [c for _, c in seen]
            return prog, seen

        p = types.SimpleNamespace(DataFrame=DataFrame, TSet=jflow.TSet)
        for name, build in _pipelines(p, ctx).items():
            prog, seen = program(build)
            out[name + "/a2a"] = np.asarray(
                str(jax.make_jaxpr(prog)()).count("all_to_all"))
            prog, seen = program(build)
            res, counts = jax.jit(prog)()
            labels = sorted({{src for (src, _), c in zip(seen, counts)
                              if int(c) != 0}})
            out[name + "/report"] = np.asarray(json.dumps(labels))
            if isinstance(res, jax.Array):
                out[name + "/scalar"] = np.asarray(res)
            else:
                for k, v in res.to_numpy().items():
                    out[name + "/rows/" + k] = v
                out[name + "/counts"] = np.asarray(res.counts)
                out[name + "/part"] = np.asarray(repr(res.partitioning))

        # the training data pipeline's curated stream on 4 shards
        from repro.data.pipeline import CorpusConfig
        from test_torch_pipeline import CORPORA, jax_preprocess
        for cname, kw in CORPORA.items():
            stream, counts = jax_preprocess(CorpusConfig(**kw), ctx)
            out["preprocess/" + cname] = stream
            out["preprocess/" + cname + "/overflow"] = np.asarray(
                sum(counts))
    """, {})


@pytest.mark.parametrize("name", sorted(WANT_A2A))
def test_tset_4shards_matches_jax(jax4, name):
    out, ex, report = _port_case(name, CPU4)
    assert ex == int(jax4[name + "/a2a"]) == WANT_A2A[name], (
        name, ex, int(jax4[name + "/a2a"]))
    if name + "/scalar" in jax4:
        jout = jax4[name + "/scalar"]
    else:
        pre = name + "/rows/"
        jout = ({k[len(pre):]: v for k, v in jax4.items()
                 if k.startswith(pre)},
                jax4[name + "/counts"], str(jax4[name + "/part"]))
    _assert_case(name, out, report, jout,
                 json.loads(str(jax4[name + "/report"])))
    assert report.is_exact()


@pytest.mark.parametrize("corpus", ["seed3", "wide"])
def test_preprocess_4shards_matches_jax(jax4, corpus):
    """The curated stream bit for bit.  On the 32-document corpus the
    join overflows on 4 shards (its output capacity is the tokens'
    capacity a shard, and 32 documents hash unevenly): of 1024 good
    token rows 881 come out, in both packages — the reference's
    ``preprocess`` does not read the report (ROADMAP Queue 3)."""
    from repro_torch.data import pipeline as TP
    from test_torch_pipeline import CORPORA

    ccfg = TP.CorpusConfig(**CORPORA[corpus])
    array_ops.EXCHANGES.reset()
    got = TP.preprocess(TP.synthetic_corpus(ccfg, CPU4), ccfg, CPU4)
    assert array_ops.EXCHANGES.n == 3       # the join's two, the orderby's
    want = jax4["preprocess/" + corpus]
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if corpus == "seed3":
        assert got.shape[0] == 881
        assert int(jax4["preprocess/seed3/overflow"]) > 0


def test_combiner_groupby_one_exchange_a_chunk_none_at_merge():
    ts, _ = _pipelines(_port(), CPU4)["groupby_g"]()
    chunks = ts._node.inputs[0].payload["chunks"]
    assert len(chunks) == 4
    array_ops.EXCHANGES.reset()
    ts.collect()
    assert array_ops.EXCHANGES.n == len(chunks)
    # the merge alone: partials already placed on the keys elide it
    from repro_torch.core.dataflow import _concat_chunks

    parts = [table_ops.groupby_aggregate(c, ["g"], [("v", "sum")],
                                         ctx=CPU4, combine=True)[0]
             for c in chunks]
    merged = _concat_chunks(parts, CPU4)
    assert merged.partitioning == (("g",), 4)
    array_ops.EXCHANGES.reset()
    table_ops.groupby_aggregate(merged, ["g"], [("v_sum", "sum")], ctx=CPU4)
    assert array_ops.EXCHANGES.n == 0


def test_window_truncation_raises_and_map_drops_rewritten_layout():
    # one partition over 4 shards (~16 rows each) and windows of 30
    # rows, deeper than one predecessor shard: the reference raises on
    # truncated windows; so does the port
    n = 64
    ev = {"g": np.zeros(n, np.int32), "t": np.arange(n, dtype=np.int32),
          "v": np.ones(n, np.float32)}
    dt = DataFrame.from_dict(ev, CPU4, capacity=32).table
    ts = TSet.from_table(dt, CPU4).window(["g"], ["t"], [("v", "sum")],
                                          rows=30)
    with pytest.raises(RuntimeError, match="truncated"):
        ts.collect()
    assert ts.overflow_report.entries["window.truncated"] > 0
    jdt = JDataFrame.from_dict(ev, JCTX).table
    # a map that rewrites a partition key forgets the layout (both)
    g = TSet.from_table(DataFrame.from_dict(LEFT, CPU1).table, CPU1) \
        .groupby(["k"], [("v", "sum")])
    kept = g.map_columns(lambda c: {"v2": c["v_sum"]}).collect()
    lost = g.map_columns(lambda c: {"k": c["k"] + 1}).collect()
    assert kept.partitioning == (("k",), 1) and lost.partitioning is None
    jg = jflow.TSet.from_table(jdt, JCTX).groupby(["g"], [("v", "sum")])
    assert jg.map_columns(lambda c: {"g": c["g"]}).collect() \
        .partitioning is None


# ---------------------------------------------------------------------------
# bridges: spill, scan, lazy
# ---------------------------------------------------------------------------
def test_from_spill_and_to_tset_match_jax():
    from repro.spill import spill_groupby as jspill_groupby
    from repro_torch.spill import spill_groupby

    aggs = (("v", "sum"), ("v", "count"))
    res = spill_groupby(DataFrame.from_dict(LEFT, CPU1).table, ("k",), aggs,
                        ctx=CPU1, budget_rows=32)
    ts = TSet.from_spill(res).groupby(["k"], [("v_sum", "sum")])
    out = ts.collect()
    res.close()
    jres = jspill_groupby(JDataFrame.from_dict(LEFT, JCTX).table, ("k",),
                          aggs, ctx=JCTX, budget_rows=32)
    jts = jflow.TSet.from_spill(jres).groupby(["k"], [("v_sum", "sum")])
    jout = jts.collect()
    jres.close()
    _assert_case("from_spill", out, ts.overflow_report, _rows_of(jout),
                 jts.overflow_report.entries)
    assert ts.overflow_report.recovered == jts.overflow_report.recovered
    # to_tset closes the store and carries the report the same way
    res2 = spill_groupby(DataFrame.from_dict(LEFT, CPU1).table, ("k",), aggs,
                         ctx=CPU1, budget_rows=32)
    ts2 = res2.to_tset()
    rows2 = ts2.to_numpy()
    assert ts2.overflow_report.recovered == {"spill.groupby": N}
    assert sorted(rows2["k"].tolist()) == sorted(set(LEFT["k"].tolist()))


def test_scan_to_tset_groupby_matches_jax(tmp_path):
    from repro.io.scan import ScanSource as JScan
    from repro_torch.io import ScanSource, write_dataset

    root = str(tmp_path / "ds")
    write_dataset(root, [(LEFT, N)], format="hpt", rows_per_group=48)
    ts = ScanSource(root, ctx=CPU1).to_tset().groupby(["g"], AGGS)
    out = ts.collect()
    jts = JScan(root, ctx=JCTX).to_tset().groupby(["g"], AGGS)
    _assert_case("scan", out, ts.overflow_report, _rows_of(jts.collect()),
                 jts.overflow_report.entries)


def test_lazy_bridge_matches_jax():
    def chain(p, ctx):
        ts = p.TSet.from_table(
            p.DataFrame.from_dict(LEFT, ctx, bucket_factor=2.0).table, ctx,
            chunk_rows=96).select(lambda c: c["v"] > 0)
        return ts.lazy("left").groupby(["g"], [("v", "sum")]).collect()

    out = chain(_port(), CPU1)
    jout = chain(_jax(), JCTX)
    assert out.overflow_report.is_exact()
    assert_same_rows(out.to_numpy(), jout.to_numpy(), msg="lazy")


# ---------------------------------------------------------------------------
# reduce("mean"): the true mean, not the reference's mean of means
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,chunk,equal", [(10, 7, False), (12, 6, True)])
def test_reduce_mean_is_the_true_mean(n, chunk, equal):
    v = np.arange(n, dtype=np.float32)
    dt = DataFrame.from_dict({"v": v}, CPU1).table
    port = float(TSet.from_table(dt, CPU1, chunk_rows=chunk)
                 .reduce("v", "mean"))
    jdt = JDataFrame.from_dict({"v": v}, JCTX).table
    jts = float(jflow.TSet.from_table(jdt, JCTX, chunk_rows=chunk)
                .reduce("v", "mean"))
    jeager = float(jops.aggregate(jdt, "v", "mean", ctx=JCTX))
    print(f"mean of arange({n}) in chunks of {chunk}: JAX TSet {jts}, "
          f"port TSet {port}, JAX aggregate {jeager}")
    assert port == jeager == float(v.mean())
    if equal:
        assert jts == port  # full, equal-sized chunks: both agree
    else:
        assert (n, chunk, jts, port) == (10, 7, 5.5, 4.5)
