"""Parity of the port's ordered analytics with the JAX package: the sort
lanes, the range exchange (orderby), window aggregation, rank, top-k and
quantile, on 1 shard in process and on 4 shards against one JAX
subprocess on 4 host devices.

Placement, counts, overflow and partitioning metadata must match bit for
bit, and so must every window lane: the port's plain windowed scan runs
the reference's ladder step for step, so even the float sums agree
exactly on the CPU (the tolerance ``1e-5 * sum|v|`` of the kernel on the
card is not needed here).  The exchange and sort choke points
(``array_ops.EXCHANGES``/``SORTS``) stand in for the reference's jaxpr
``all_to_all`` / ``sort[`` counts.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import DistTable as JDistTable  # noqa: E402
from repro.core import Table as JTable  # noqa: E402
from repro.core import exchange as jexchange  # noqa: E402
from repro.core import local_context  # noqa: E402
from repro.core import table_ops as jops  # noqa: E402
from repro.dataframe.frame import DataFrame as JDataFrame  # noqa: E402
from repro_torch.core import (DistTable, HPTMTContext, Table,  # noqa: E402
                              array_ops, range_partitioning, table_ops)
from repro_torch.core import exchange as texchange  # noqa: E402
from repro_torch.core.report import OverflowError as TOverflowError  # noqa: E402
from repro_torch.dataframe import DataFrame  # noqa: E402
from torch_parity import (assert_blocks_equal, bits, jax_blocks,  # noqa: E402
                          jax_result, run_jax_4way)

RNG = np.random.default_rng(41)
CPU1 = HPTMTContext(n_shards=1, device="cpu")
CPU4 = HPTMTContext(n_shards=4, device="cpu")
N = 512
DATA = {"g": RNG.integers(0, 11, N).astype(np.int32),
        "t": RNG.integers(0, 60, N).astype(np.int32),
        "v": RNG.normal(size=N).astype(np.float32),
        "q": RNG.uniform(0, 100, N).astype(np.float32)}
KEYS = {"k": RNG.integers(-4, 4, N).astype(np.int32),
        "x": RNG.normal(size=N).astype(np.float32)}
KEYS["x"][RNG.integers(0, N, 12)] = np.nan
KEYS["x"][:4] = [0.0, -0.0, np.inf, -np.inf]
AGGS = [("v", "sum"), ("v", "mean"), ("q", "sum"), ("v", "min"),
        ("q", "max"), (None, "count"), ("v", "lag"), ("v", "lag", 2),
        ("v", "lead"), ("q", "lead", 3), (None, "rank"),
        (None, "row_number")]
#: one partition spanning every shard, ~16 rows a shard (truncation)
TRUNC = {"g": np.zeros(64, np.int32), "t": np.arange(64, dtype=np.int32),
         "v": np.ones(64, np.float32)}
TRUNC_CASES = [("roll28", [("v", "sum")], 28), ("roll8", [("v", "sum")], 8),
               ("lead20", [("v", "lead", 20)], 8)]
ORDER_CASES = [("mixed", ["k", "x"], [True, False], 2.0),
               ("desc", ["x"], False, 2.0),
               ("starved", ["k", "x"], True, 0.2)]
QS = (0.0, 0.1, 0.5, 0.9, 1.0)


def port_dt(data, ctx, capacity=None):
    return DistTable.from_local(Table.from_arrays(data, device="cpu"), ctx,
                                capacity=capacity)


def jax_dt(data):
    return JDistTable.from_local(JTable.from_arrays(
        {k: jnp.asarray(v) for k, v in data.items()}), local_context())


@pytest.fixture(scope="module")
def jax4():
    """Every 4-shard case, by the JAX package on 4 host devices under jit,
    plus the traced all-to-all count of the orderby → window chain."""
    inputs = {f"d/{k}": v for k, v in DATA.items()}
    inputs.update({f"k/{k}": v for k, v in KEYS.items()})
    inputs.update({f"t/{k}": v for k, v in TRUNC.items()})
    return run_jax_4way(f"""
        d, kt, tr = table("d", 256), table("k", 256), table("t", 32)
        for name, by, asc, bf in {ORDER_CASES!r}:
            save("order_" + name, *run(lambda x: table_ops.orderby(
                x, by, ascending=asc, bucket_factor=bf, ctx=ctx), kt))
        srt, _ = run(lambda x: table_ops.orderby(x, ["g", "t"], ctx=ctx), d)
        save("sorted", srt)
        for rows in (8, None):
            save(f"win_{{rows}}", *run(lambda x: table_ops.window_aggregate(
                x, ["g"], ["t"], {AGGS!r}, rows=rows, ctx=ctx), srt))
        tsrt, _ = run(lambda x: table_ops.orderby(x, ["g", "t"], ctx=ctx), tr)
        for name, aggs, rows in {TRUNC_CASES!r}:
            save("trunc_" + name, *run(
                lambda x: table_ops.window_aggregate(
                    x, ["g"], ["t"], aggs, rows=rows, ctx=ctx), tsrt))
        save("topk", run(lambda x: table_ops.topk(x, "t", 16, ctx=ctx), d))
        sv, _ = run(lambda x: table_ops.orderby(x, "v", ctx=ctx), d)
        out["q_exact"] = np.asarray(run(lambda x: table_ops.quantile(
            x, "v", {QS!r}, ctx=ctx), sv))
        out["q_approx"] = np.asarray(run(lambda x: table_ops.quantile(
            x, "v", {QS!r}, method="approx", ctx=ctx), d))
        def chain(x):
            s, o1 = table_ops.orderby(x, ["g", "t"], ctx=ctx)
            w, o2 = table_ops.window_aggregate(
                s, ["g"], ["t"], {AGGS!r}, rows=8, ctx=ctx)
            return w, o1 + o2
        out["a2a_chain"] = np.asarray(a2a_count(chain, d))
        out["a2a_window"] = np.asarray(a2a_count(
            lambda x: table_ops.window_aggregate(
                x, ["g"], ["t"], {AGGS!r}, rows=8, ctx=ctx), srt))
    """, inputs)


# ---------------------------------------------------------------------------
# sort lanes
# ---------------------------------------------------------------------------
LANE_COLS = {
    "float32": KEYS["x"],
    "float16": KEYS["x"].astype(np.float16),
    "int32": np.array([-2**31, -1, 0, 1, 2**31 - 1, 7], np.int32),
    "int8": np.array([-128, -1, 0, 1, 127], np.int8),
    "uint32": np.array([0, 1, 2**31, 2**32 - 1], np.uint32),
    "uint8": np.array([0, 1, 200, 255], np.uint8),
    "bool": np.array([True, False, True]),
}


@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("dtype", sorted(LANE_COLS))
def test_sort_key_lanes_bit_exact(dtype, ascending):
    """NaN forced last after the direction flip, ±0.0 two lanes, signed
    and unsigned integers, bool — the reference's lanes bit for bit."""
    col = LANE_COLS[dtype]
    got = texchange.sort_key_lanes(torch.from_numpy(col), ascending).numpy()
    ref = np.asarray(jexchange.sort_key_lanes(jnp.asarray(col), ascending))
    assert got.shape == ref.shape
    assert got.min() >= 0 and got.max() <= 0xFFFFFFFF
    np.testing.assert_array_equal(got.astype(np.uint32), ref)


def test_sort_key_lanes_reject_64bit_and_nd():
    with pytest.raises(TypeError, match="64-bit"):
        texchange.sort_key_lanes(torch.zeros(3, dtype=torch.int64))
    with pytest.raises(TypeError, match="1-D"):
        texchange.sort_key_lanes(torch.zeros((3, 2)))


# ---------------------------------------------------------------------------
# orderby
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("asc", [(True, True), (False, True), (True, False),
                                 (False, False)])
def test_orderby_single_shard_vs_jax(asc):
    array_ops.EXCHANGES.reset()
    out, ov = table_ops.orderby(port_dt(KEYS, CPU1), ["k", "x"],
                                ascending=list(asc), ctx=CPU1)
    ref, rov = jops.orderby(jax_dt(KEYS), ["k", "x"], ascending=list(asc),
                            ctx=local_context())
    assert array_ops.EXCHANGES.n == 0
    assert int(ov) == int(rov) == 0
    assert_blocks_equal(out, *jax_blocks(ref))
    assert out.partitioning == range_partitioning(("k", "x"), asc, 1)


@pytest.mark.parametrize("name,by,asc,bf", ORDER_CASES)
def test_orderby_4_shards_vs_jax(jax4, name, by, asc, bf):
    """Splitters, placement, per-shard counts and overflow equal the
    reference's (the starved case drops and counts rows)."""
    array_ops.EXCHANGES.reset()
    out, ov = table_ops.orderby(port_dt(KEYS, CPU4, 256), by, ascending=asc,
                                bucket_factor=bf, ctx=CPU4)
    assert array_ops.EXCHANGES.n == 1
    cols, counts, part, rov = jax_result(jax4, "order_" + name)
    assert int(ov) == rov
    assert (rov > 0) == (name == "starved")
    assert_blocks_equal(out, cols, counts, part, msg=name)


# ---------------------------------------------------------------------------
# window aggregation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rows", [1, 8, 200, None])
def test_window_single_shard_vs_jax(rows):
    """Rolling (1, 8, wider than any partition) and cumulative lanes, lag
    and lead offsets, rank and row_number over tied order keys."""
    out, ov = table_ops.window_aggregate(port_dt(DATA, CPU1), ["g"], ["t"],
                                         AGGS, rows=rows, ctx=CPU1)
    ref, rov = jops.window_aggregate(jax_dt(DATA), ["g"], ["t"], AGGS,
                                     rows=rows, ctx=local_context())
    assert int(ov) == int(rov) == 0
    assert_blocks_equal(out, *jax_blocks(ref), msg=f"rows={rows}")


@pytest.mark.parametrize("rows", [8, None])
def test_window_4_shards_vs_jax(jax4, rows):
    """The halo (rolling, lag, lead) and the carry chain (cumulative,
    rank, row_number) across shard boundaries: every lane bit for bit."""
    srt, _ = table_ops.orderby(port_dt(DATA, CPU4, 256), ["g", "t"],
                               ctx=CPU4)
    assert_blocks_equal(srt, *jax_result(jax4, "sorted")[:3], msg="sorted")
    out, ov = table_ops.window_aggregate(srt, ["g"], ["t"], AGGS, rows=rows,
                                         ctx=CPU4)
    cols, counts, part, rov = jax_result(jax4, f"win_{rows}")
    assert int(ov) == rov == 0
    assert_blocks_equal(out, cols, counts, part, msg=f"rows={rows}")


@pytest.mark.parametrize("name,aggs,rows", TRUNC_CASES)
def test_window_truncation_counted_4_shards(jax4, name, aggs, rows):
    """A window deeper than a mid-partition shard's rows cannot be proven
    from the one-shard halo: truncations are counted as the reference
    counts them, and a window inside the halo is exact."""
    srt, _ = table_ops.orderby(port_dt(TRUNC, CPU4, 32), ["g", "t"],
                               ctx=CPU4)
    out, ov = table_ops.window_aggregate(srt, ["g"], ["t"], aggs, rows=rows,
                                         ctx=CPU4)
    cols, counts, part, rov = jax_result(jax4, "trunc_" + name)
    assert int(ov) == rov
    assert (rov > 0) == (name != "roll8")
    assert_blocks_equal(out, cols, counts, part, msg=name)
    if name == "roll8":
        np.testing.assert_array_equal(
            out.to_numpy()["v_sum"], np.minimum(np.arange(64) + 1, 8))


def test_ordered_chain_exchange_and_sort_counts(jax4):
    """orderby = exactly one exchange; a window on its range layout adds
    none and sorts nothing, like the reference's traced chain."""
    dt = port_dt(DATA, CPU4, 256)
    array_ops.EXCHANGES.reset()
    array_ops.SORTS.reset()
    srt, _ = table_ops.orderby(dt, ["g", "t"], ctx=CPU4)
    assert array_ops.EXCHANGES.n == 1
    sorts = array_ops.SORTS.n
    assert sorts > 0
    again, _ = table_ops.orderby(srt, ["g", "t"], ctx=CPU4)
    assert again is srt
    for rows in (8, None):
        table_ops.window_aggregate(srt, ["g"], ["t"], AGGS, rows=rows,
                                   ctx=CPU4)
        table_ops.rank(srt, ["g"], ["t"], ctx=CPU4)
    assert array_ops.EXCHANGES.n == int(jax4["a2a_chain"]) == 1
    assert int(jax4["a2a_window"]) == 0
    assert array_ops.SORTS.n == sorts
    # without the layout, the window sorts first: one exchange
    table_ops.window_aggregate(dt, ["g"], ["t"], AGGS, rows=8, ctx=CPU4)
    assert array_ops.EXCHANGES.n == 2


# ---------------------------------------------------------------------------
# top-k and quantile
# ---------------------------------------------------------------------------
def test_topk_vs_jax(jax4):
    """The ppermute tree keeps the reference's rows among tied keys."""
    out = table_ops.topk(port_dt(DATA, CPU1), "t", 16, ctx=CPU1)
    ref = jops.topk(jax_dt(DATA), "t", 16, ctx=local_context())
    assert_blocks_equal(out, *jax_blocks(ref), msg="1 shard")
    array_ops.EXCHANGES.reset()
    out4 = table_ops.topk(port_dt(DATA, CPU4, 256), "t", 16, ctx=CPU4)
    assert array_ops.EXCHANGES.n == 0
    assert_blocks_equal(out4, *jax_result(jax4, "topk")[:3], msg="4 shards")


def test_quantile_vs_jax(jax4):
    one = port_dt(DATA, CPU1)
    for method in ("auto", "exact", "approx"):
        got = table_ops.quantile(one, "v", QS, method=method, ctx=CPU1)
        ref = jops.quantile(jax_dt(DATA), "v", QS, method=method,
                            ctx=local_context())
        np.testing.assert_array_equal(bits(got.numpy()),
                                      bits(np.asarray(ref)), err_msg=method)
    np.testing.assert_allclose(
        table_ops.quantile(one, "v", QS, ctx=CPU1).numpy(),
        np.quantile(DATA["v"], QS), rtol=1e-5, atol=1e-6)
    srt, _ = table_ops.orderby(port_dt(DATA, CPU4, 256), "v", ctx=CPU4)
    array_ops.EXCHANGES.reset()
    array_ops.SORTS.reset()
    exact = table_ops.quantile(srt, "v", QS, ctx=CPU4)
    assert array_ops.EXCHANGES.n == array_ops.SORTS.n == 0
    np.testing.assert_array_equal(bits(exact.numpy()),
                                  bits(jax4["q_exact"]))
    approx = table_ops.quantile(port_dt(DATA, CPU4, 256), "v", QS,
                                method="approx", ctx=CPU4)
    assert array_ops.EXCHANGES.n == 0
    np.testing.assert_array_equal(bits(approx.numpy()),
                                  bits(jax4["q_approx"]))


# ---------------------------------------------------------------------------
# layouts and the DataFrame surface
# ---------------------------------------------------------------------------
def test_sorted_output_is_not_taken_as_hash_partitioned():
    """A range layout on ``k`` is no hash layout on ``k``: a following
    join or groupby on 4 shards still shuffles."""
    keys = np.random.default_rng(5).integers(0, 200, N).astype(np.int32)
    left = DataFrame.from_dict({"k": keys, "x": KEYS["x"]}, CPU4,
                               bucket_factor=2.0)
    right = DataFrame.from_dict({"k": np.arange(200, dtype=np.int32),
                                 "w": np.ones(200, np.float32)}, CPU4,
                                bucket_factor=2.0)
    srt = left.sort_values("k")
    assert srt.partitioning_kind == "range"
    array_ops.EXCHANGES.reset()
    j = srt.join(right, ["k"])
    assert array_ops.EXCHANGES.n == 2
    assert j.partitioning_kind == "hash"
    array_ops.EXCHANGES.reset()
    srt.groupby(["k"], [("x", "max")], combine=False)
    assert array_ops.EXCHANGES.n == 1
    # local_sort keeps a hash layout (rows did not move), drops a range one
    hashed = table_ops.shuffle(left.table, ["k"], ctx=CPU4)[0]
    assert table_ops.local_sort(hashed, "x", ctx=CPU4)[0].partitioning == \
        hashed.partitioning
    assert table_ops.local_sort(srt.table, "x",
                                ctx=CPU4)[0].partitioning is None


def test_frame_ordered_surface_vs_jax():
    jdf = JDataFrame.from_dict(DATA, local_context())
    tdf = DataFrame.from_dict(DATA, CPU1)
    for got, ref in (
            (tdf.sort_values(["g", "t"], ascending=[True, False]),
             jdf.sort_values(["g", "t"], ascending=[True, False])),
            (tdf.repartition(["t"], mode="range"),
             jdf.repartition(["t"], mode="range")),
            (tdf.window(["g"], ["t"]).agg(AGGS, rows=5),
             jdf.window(["g"], ["t"]).agg(AGGS, rows=5)),
            (tdf.rank(["g"], ["v"], ascending=False),
             jdf.rank(["g"], ["v"], ascending=False)),
            (tdf.topk("q", 7, largest=False), jdf.topk("q", 7,
                                                       largest=False))):
        assert_blocks_equal(got.table, *jax_blocks(ref.table))
        assert got.partitioning_kind == ref.partitioning_kind == "range"
    assert tdf.quantile("v", 0.5) == jdf.quantile("v", 0.5)
    q = tdf.quantile("v", [0.25, 0.75])
    assert isinstance(q, np.ndarray) and q.shape == (2,)
    # the spill path (ported since): "auto" without a budget stays in
    # memory; True gives the JAX spill's rows in the same places
    auto = tdf.window(["g"], ["t"]).agg(AGGS, rows=5, spill="auto")
    assert_blocks_equal(auto.table, *jax_blocks(
        jdf.window(["g"], ["t"]).agg(AGGS, rows=5).table))
    spilled = tdf.window(["g"], ["t"]).agg(AGGS, rows=5, spill=True,
                                           budget_rows=64)
    jspilled = jdf.window(["g"], ["t"]).agg(AGGS, rows=5, spill=True,
                                            budget_rows=64)
    assert spilled.overflow_report.total_recovered == len(tdf)
    got, want = spilled.to_numpy(), jspilled.to_numpy()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(bits(got[k]), bits(want[k]), err_msg=k)


def test_window_truncation_raises_in_the_frame():
    df = DataFrame.from_dict(TRUNC, CPU4, capacity=32)
    with pytest.raises(TOverflowError, match="window"):
        df.sort_values(["g", "t"]).window(["g"], ["t"]).agg(
            [("v", "sum")], rows=28)


ERRORS = [
    ("by= names unknown column", lambda d, c: table_ops.orderby(
        d, ["nope"], ctx=c)),
    ("ascending= has 1 entries", lambda d, c: table_ops.orderby(
        d, ["g", "t"], ascending=[True], ctx=c)),
    ("by= needs at least one", lambda d, c: table_ops.orderby(d, [], ctx=c)),
    ("partition_by= names unknown", lambda d, c: table_ops.window_aggregate(
        d, ["nope"], ["t"], [("v", "sum")], ctx=c)),
    ("order_by= names unknown", lambda d, c: table_ops.window_aggregate(
        d, ["g"], ["nope"], [("v", "sum")], ctx=c)),
    ("names unknown column 'nope'", lambda d, c: table_ops.window_aggregate(
        d, ["g"], ["t"], [("nope", "sum")], ctx=c)),
    ("unknown window op", lambda d, c: table_ops.window_aggregate(
        d, ["g"], ["t"], [("v", "median")], ctx=c)),
    ("offset must be a positive", lambda d, c: table_ops.window_aggregate(
        d, ["g"], ["t"], [("v", "lag", 0)], ctx=c)),
    ("collides", lambda d, c: table_ops.window_aggregate(
        d, ["g"], ["t"], [("v", "sum"), ("v", "sum")], ctx=c)),
    ("rows=0 must be", lambda d, c: table_ops.window_aggregate(
        d, ["g"], ["t"], [("v", "sum")], rows=0, ctx=c)),
    ("lookback 300", lambda d, c: table_ops.window_aggregate(
        d, ["g"], ["t"], [("v", "sum")], rows=301, ctx=c)),
    ("k=300 exceeds the per-shard capacity", lambda d, c: table_ops.topk(
        d, "v", 300, ctx=c)),
    ("k=0 must be", lambda d, c: table_ops.topk(d, "v", 0, ctx=c)),
    (r"qs= values \[1.5\] outside", lambda d, c: table_ops.quantile(
        d, "v", (0.5, 1.5), ctx=c)),
    ("unknown quantile method", lambda d, c: table_ops.quantile(
        d, "v", 0.5, method="median", ctx=c)),
    ("column= names unknown", lambda d, c: table_ops.quantile(
        d, "nope", 0.5, ctx=c)),
]


@pytest.mark.parametrize("match,call", ERRORS, ids=[e[0] for e in ERRORS])
def test_eager_value_errors_as_reference(match, call):
    """Each eager ValueError of the reference, with its message."""
    with pytest.raises(ValueError, match=match):
        call(port_dt(DATA, CPU4, 256), CPU4)
    jctx_err = None
    try:
        from repro.core import HPTMTContext as JContext
        from repro.core import make_mesh
        import jax
        if jax.device_count() >= 4:
            jctx_err = JContext(mesh=make_mesh((4,), ("data",)))
    except ImportError:
        pass
    if jctx_err is None:
        # one host device here: the checks that need no mesh run on 1 shard
        if "per-shard capacity" in match or "lookback" in match:
            return
        with pytest.raises(ValueError, match=match):
            call(jax_dt(DATA), local_context())
