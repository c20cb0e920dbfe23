"""Parity of the port's out-of-core spill (``repro_torch.spill``) with the
JAX package's (``repro.spill``), case for case with ``tests/test_spill.py``.

  * host/device hash parity — the port's numpy partitioner is
    bit-identical to the port's device hash (uint32 held in int64) and to
    the JAX package's, on mixed dtypes, negative ints, ``-0.0`` and NaN
    payloads; the order lanes likewise;
  * engine exactness — spilled join/groupby/window give the JAX spill's
    rows in the same places (sums to ``1e-5 * sum|v|``: the port's plain
    segment sum adds in float64) and the port's in-memory rows, on 1
    shard and on 4 (the 4-shard JAX spill runs in one subprocess);
  * trigger semantics — ``spill="auto"`` stays in memory when the input
    fits the budget and spills when it does not, and retries an
    in-memory overflow out of core;
  * durability — CRC-checked runs, ``disk_full`` / ``partial_write``
    faults surfacing as ``SpillWriteError`` with no ``.tmp`` left, and a
    clean retry;
  * re-entry — a re-ingested pair makes 0 exchanges and a re-ingested
    window 0 sorts, on the port's counters (``array_ops.EXCHANGES`` /
    ``SORTS``), where the unpartitioned input makes them.
"""
import errno
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from conftest import given, settings, st

import jax.numpy as jnp  # noqa: E402

import repro.spill as jspill  # noqa: E402
from repro.core import local_context  # noqa: E402
from repro.core.exchange import order_lanes as j_order_lanes  # noqa: E402
from repro.core.table import hash_columns as j_hash_columns  # noqa: E402
from repro.dataframe.frame import DataFrame as JDataFrame  # noqa: E402
from repro_torch.core import HPTMTContext, array_ops, table_ops  # noqa: E402
from repro_torch.core.exchange import order_lanes  # noqa: E402
from repro_torch.core.report import OverflowError, OverflowReport  # noqa: E402
from repro_torch.core.table import hash_columns  # noqa: E402
from repro_torch.dataframe import DataFrame  # noqa: E402
from repro_torch.io.native import HptIntegrityError, read_hpt, write_hpt  # noqa: E402
from repro_torch.kernels.segment_reduce import ref as seg_ref  # noqa: E402
from repro_torch.spill import (FAULT_ENV, SpillStore, SpillWriteError,  # noqa: E402
                               reset_fault_injection, should_spill,
                               spill_groupby, spill_join, spill_window)
from repro_torch.spill.engine import (_canonical_nan,  # noqa: E402
                                      _load_hash_partition,
                                      _load_range_partition,
                                      _partition_hash, _partition_window)
from repro_torch.spill.hashing import (np_hash_columns, np_lex_order,  # noqa: E402
                                       np_order_lanes)
from torch_parity import (assert_rows_equal, assert_sums_close,  # noqa: E402
                          bits, run_jax_4way)

CPU1 = HPTMTContext(n_shards=1, device="cpu")
CPU4 = HPTMTContext(n_shards=4, device="cpu")
JCTX = local_context()


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _frame(data, ctx, headroom=1):
    """DataFrame whose in-memory path has capacity head-room: the oracle
    must never itself overflow under shuffle skew."""
    n = len(next(iter(data.values())))
    cap = max(1, -(-n // ctx.n_shards)) * max(1, headroom)
    return DataFrame.from_dict(data, ctx, capacity=cap)


def _jframe(data, headroom=1):
    n = len(next(iter(data.values())))
    return JDataFrame.from_dict(data, JCTX, capacity=n * max(1, headroom))


def assert_same_places(got, want, sums=(), abs_sums=None, msg=""):
    """The same columns, row for row: bitwise, except the ``sums``
    columns, which hold to ``1e-5 * sum|v|`` (``abs_sums[col]``)."""
    assert sorted(got) == sorted(want), (msg, sorted(got), sorted(want))
    for k in want:
        assert got[k].dtype == want[k].dtype, (msg, k, got[k].dtype)
        assert got[k].shape == want[k].shape, (msg, k, got[k].shape)
        if k in sums:
            assert_sums_close(got[k], want[k], abs_sums[k], msg=f"{msg}:{k}")
        else:
            np.testing.assert_array_equal(bits(got[k]), bits(want[k]),
                                          err_msg=f"{msg}:{k}")


def _by_key(d, key):
    order = np.argsort(d[key], kind="stable")
    return {k: np.asarray(v)[order] for k, v in d.items()}


def _abs_sums(data, key, keys_out, col="v"):
    """Per-group ``sum|v|`` aligned with the sorted group keys."""
    mag = {}
    for k, v in zip(data[key], np.abs(data[col]).astype(np.float64)):
        mag[k] = mag.get(k, 0.0) + v
    return np.array([mag[k] for k in keys_out])


# ---------------------------------------------------------------------------
# host/device hash + lane parity
# ---------------------------------------------------------------------------
NAN_PAYLOADS = np.array([0x7FC00000, 0x7FC00001, 0xFFC00000, 0x7F800001,
                         0xFFFFFFFF], np.uint32).view(np.float32)


def _assert_hash_parity(cols):
    h1h, h2h = np_hash_columns(cols)
    h1t, h2t = hash_columns([torch.from_numpy(np.ascontiguousarray(c))
                             for c in cols])
    np.testing.assert_array_equal(h1t.numpy().view(np.uint32), h1h)
    np.testing.assert_array_equal(h2t.numpy().view(np.uint32), h2h)
    h1j, h2j = j_hash_columns([jnp.asarray(c) for c in cols])
    np.testing.assert_array_equal(np.asarray(h1j), h1h)
    np.testing.assert_array_equal(np.asarray(h2j), h2h)


def test_np_hash_matches_device_mixed_dtypes():
    rng = np.random.default_rng(0)
    n = 512
    f = rng.standard_normal(n).astype(np.float32)
    f[::17] = np.nan
    f[::29] = -0.0
    f[::31] = 0.0
    f[3:3 + len(NAN_PAYLOADS)] = NAN_PAYLOADS
    cols = [rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
            f, rng.integers(0, 2, n).astype(bool),
            rng.integers(0, 2**32, n).astype(np.uint32),
            rng.integers(-300, 300, n).astype(np.int16)]
    _assert_hash_parity(cols)
    for c in cols:
        _assert_hash_parity([c])


def test_nan_payloads_hash_apart_until_canonical():
    """Bitwise identity keeps NaN payloads apart; the window partitioner
    collapses them first, so one window partition stays in one spill
    partition."""
    h1, _ = np_hash_columns([NAN_PAYLOADS])
    assert len(set(h1.tolist())) == len(NAN_PAYLOADS)
    canon = _canonical_nan(NAN_PAYLOADS)
    assert np.isnan(canon).all()
    h1c, _ = np_hash_columns([canon])
    assert len(set(h1c.tolist())) == 1
    ints = np.arange(4, dtype=np.int32)
    assert _canonical_nan(ints) is ints


def test_np_lanes_match_device_directions():
    rng = np.random.default_rng(1)
    n = 256
    f = rng.standard_normal(n).astype(np.float32)
    f[::11] = np.nan
    f[::13] = -0.0
    cols = {"i": rng.integers(-1000, 1000, n).astype(np.int32), "f": f,
            "b": rng.integers(0, 2, n).astype(bool),
            "u": rng.integers(0, 2**32, n).astype(np.uint32)}
    names = ("i", "f", "b", "u")
    for asc in ((True, True, True, True), (False, True, False, False)):
        host = np_order_lanes(cols, names, asc)
        dev = order_lanes({k: torch.from_numpy(v) for k, v in cols.items()},
                          names, asc)
        np.testing.assert_array_equal(dev.numpy().astype(np.uint32), host)
        jdev = j_order_lanes({k: jnp.asarray(v) for k, v in cols.items()},
                             names, asc)
        np.testing.assert_array_equal(np.asarray(jdev), host)
    # host lexsort over lanes == numpy argsort semantics (NaN last)
    lanes = np_order_lanes(cols, ("f",), (True,))
    sorted_f = cols["f"][np_lex_order(lanes)]
    valid = sorted_f[~np.isnan(sorted_f)]
    assert (np.diff(valid) >= 0).all()
    assert np.isnan(sorted_f[-np.isnan(cols["f"]).sum():]).all()


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(-2**31, 2**31 - 1), min_size=1, max_size=64),
       st.lists(st.floats(width=32, allow_nan=True, allow_infinity=True),
                min_size=1, max_size=64))
def test_np_hash_matches_device_property(ints, floats):
    m = min(len(ints), len(floats))
    _assert_hash_parity([np.asarray(ints[:m], np.int32),
                         np.asarray(floats[:m], np.float32)])


# ---------------------------------------------------------------------------
# .hpt integrity: CRC + truncation + magic
# ---------------------------------------------------------------------------
def test_hpt_crc_roundtrip_and_corruption(tmp_path):
    path = str(tmp_path / "run.hpt")
    cols = {"a": np.arange(100, dtype=np.int32),
            "b": np.linspace(0, 1, 100, dtype=np.float32)}
    header = write_hpt(path, cols, 100)
    assert set(header["crc32"]) == {"a", "b"}
    back, n = read_hpt(path)
    assert n == 100
    np.testing.assert_array_equal(back["a"], cols["a"])
    raw = bytearray(open(path, "rb").read())
    raw[-3] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(HptIntegrityError, match="run.hpt"):
        read_hpt(path)
    write_hpt(path, cols, 100)
    whole = open(path, "rb").read()
    open(path, "wb").write(whole[:-10])
    with pytest.raises(HptIntegrityError):
        read_hpt(path)
    open(path, "wb").write(b"HPT1\x00")
    with pytest.raises(HptIntegrityError):
        read_hpt(path)
    open(path, "wb").write(b"JUNKJUNKJUNK")
    with pytest.raises(HptIntegrityError):
        read_hpt(path)


# ---------------------------------------------------------------------------
# engine exactness: the JAX spill and the port's in-memory path, 1 shard
# ---------------------------------------------------------------------------
RNG = np.random.default_rng(2)
JOIN_L = {"k": RNG.integers(0, 200, 1500).astype(np.int32),
          "v": RNG.standard_normal(1500).astype(np.float32)}
# right keys only partially overlap so left/outer rows matter
JOIN_R = {"k": (np.arange(300, dtype=np.int32) - 50),
          "w": RNG.standard_normal(300).astype(np.float32)}
GB = {"k": RNG.integers(0, 300, 4000).astype(np.int32),
      "v": RNG.standard_normal(4000).astype(np.float32)}
GB_AGGS = (("v", "sum"), ("v", "min"), ("v", "count"), ("v", "max"))
# rolling float sums are bit-exact only when addition is associative on
# the data; integer-valued float32 makes it so (reference DESIGN.md §10)
WIN = {"g": RNG.integers(0, 60, 2500).astype(np.int32),
       "t": RNG.permutation(2500).astype(np.int32),
       "x": RNG.integers(-100, 100, 2500).astype(np.float32)}
WIN_AGGS = [("x", "sum"), ("x", "min"), (None, "row_number"),
            ("x", "lag", 1)]


@pytest.mark.parametrize("how", ["inner", "left", "outer"])
def test_spill_join_bit_exact_all_hows(how):
    dl, dr = _frame(JOIN_L, CPU1), _frame(JOIN_R, CPU1)
    want = dl.join(dr, ["k"], how=how, max_matches=16).to_numpy()
    with spill_join(dl.table, dr.table, ("k",), ctx=CPU1, budget_rows=128,
                    how=how, max_matches=16) as res:
        got = res.collect()
        assert res.stats.pairs > 1 and res.store.leftover_temp_files() == []
    assert_rows_equal(got, want, msg=how)
    with jspill.spill_join(_jframe(JOIN_L).table, _jframe(JOIN_R).table,
                           ("k",), ctx=JCTX, budget_rows=128, how=how,
                           max_matches=16) as jres:
        jgot = jres.collect()
    assert_same_places(got, jgot, msg=f"{how} vs JAX spill")


def test_spill_groupby_bit_exact():
    df = _frame(GB, CPU1)
    want = _by_key(df.groupby(["k"], list(GB_AGGS)).to_numpy(), "k")
    with spill_groupby(df.table, ("k",), GB_AGGS, ctx=CPU1,
                       budget_rows=256) as res:
        got = res.collect()
        assert res.stats.rows_in == len(GB["k"])
    assert_rows_equal(got, want, msg="vs in-memory")
    with jspill.spill_groupby(_jframe(GB).table, ("k",), GB_AGGS, ctx=JCTX,
                              budget_rows=256) as jres:
        jgot = jres.collect()
    mag = _abs_sums(GB, "k", np.sort(want["k"]))
    assert_same_places(_by_key(got, "k"), _by_key(jgot, "k"),
                       sums=("v_sum",), abs_sums={"v_sum": mag},
                       msg="vs JAX spill")


def test_spill_window_bit_exact_integer_valued():
    df = _frame(WIN, CPU1)
    want = df.window(["g"], ["t"]).agg(WIN_AGGS, rows=8).to_numpy()
    array_ops.SORTS.reset()
    with spill_window(df.table, ("g",), ("t",), WIN_AGGS, ctx=CPU1,
                      budget_rows=300, rows=8) as res:
        got = res.collect()
    assert array_ops.SORTS.n == 0, "a re-entered window sorted"
    assert_rows_equal(got, want)
    with jspill.spill_window(_jframe(WIN).table, ("g",), ("t",), WIN_AGGS,
                             ctx=JCTX, budget_rows=300, rows=8) as jres:
        assert_same_places(got, jres.collect(), msg="vs JAX spill")


def test_spill_join_empty_result_keeps_schema():
    dl = _frame({"k": np.arange(100, dtype=np.int32),
                 "v": np.ones(100, np.float32)}, CPU1)
    dr = _frame({"k": np.arange(1000, 1010, dtype=np.int32),
                 "w": np.ones(10, np.float32)}, CPU1)
    out = dl.join(dr, ["k"], spill=True, budget_rows=32)
    assert len(out) == 0
    assert {"k", "v", "w"} <= set(out.columns)


def test_skew_refinement_and_oversized_counted():
    # one dominant key cannot be split by any partitioner: the engine
    # must refine once, give up, count it oversized — and stay exact
    rng = np.random.default_rng(5)
    n = 2000
    k = np.where(rng.random(n) < 0.7, 7, rng.integers(0, 50, n)) \
        .astype(np.int32)
    data = {"k": k, "v": rng.standard_normal(n).astype(np.float32)}
    df = _frame(data, CPU1)
    aggs = (("v", "sum"), ("v", "count"))
    want = df.groupby(["k"], list(aggs)).to_numpy()
    with spill_groupby(df.table, ("k",), aggs, ctx=CPU1,
                       budget_rows=100) as res:
        got = res.collect()
        stats = res.stats
    with jspill.spill_groupby(_jframe(data).table, ("k",), aggs, ctx=JCTX,
                              budget_rows=100) as jres:
        jgot = jres.collect()
        jstats = jres.stats
    assert stats.oversized >= 1 and stats.refined >= 1
    assert (stats.n_parts, stats.pairs, stats.refined, stats.oversized) == (
        jstats.n_parts, jstats.pairs, jstats.refined, jstats.oversized)
    assert_rows_equal(got, want)
    mag = _abs_sums(data, "k", np.sort(want["k"]))
    assert_same_places(_by_key(got, "k"), _by_key(jgot, "k"),
                       sums=("v_sum",), abs_sums={"v_sum": mag})


def test_plain_segment_sum_on_a_shard_with_no_rows():
    """A spilled pair's shard can hold no row: the plain segment sum must
    return zeros, not fail on its empty prefix sum."""
    vals = torch.zeros((8, 2), dtype=torch.float32)
    seg = torch.full((8,), 8, dtype=torch.int32)  # every row invalid
    out = seg_ref.segment_reduce_fused(vals, seg, 8)
    assert out.shape == (8, 2) and not out.any()
    df = DataFrame.from_dict({"k": np.zeros(2, np.int32),
                              "v": np.ones(2, np.float32)}, CPU4,
                             capacity=4)
    got = df.groupby(["k"], [("v", "sum"), ("v", "count")]).to_numpy()
    assert got["v_sum"].tolist() == [2.0] and got["v_count"].tolist() == [2]


# ---------------------------------------------------------------------------
# trigger semantics: the overflow -> spill boundary
# ---------------------------------------------------------------------------
N_TRIG = 1000


@pytest.mark.parametrize("budget,expect_spill", [
    (N_TRIG, False),        # fits exactly: stay in memory
    (N_TRIG - 1, True),     # one row over the committed budget: spill
    (N_TRIG // 4, True),    # far over: spill
    (None, False),          # no budget committed: stay in memory
])
def test_auto_trigger_straddles_capacity_boundary(budget, expect_spill):
    rng = np.random.default_rng(6)
    data = {"k": rng.integers(0, 100, N_TRIG).astype(np.int32),
            "v": rng.standard_normal(N_TRIG).astype(np.float32)}
    df = _frame(data, CPU1)
    assert should_spill(N_TRIG, CPU1.n_shards, budget) == expect_spill
    assert jspill.should_spill(N_TRIG, 1, budget) == expect_spill
    aggs = [("v", "sum"), ("v", "count")]
    want = df.groupby(["k"], aggs).to_numpy()
    out = df.groupby(["k"], aggs, spill="auto", budget_rows=budget)
    assert_rows_equal(out.to_numpy(), want)
    # the report tells which path ran, and certifies zero residual loss
    assert bool(out.overflow_report.recovered) == expect_spill
    assert out.overflow_report.is_exact()


def test_auto_retries_in_memory_overflow_via_spill():
    # an undersized out_capacity makes the in-memory groupby drop groups;
    # spill="auto" must catch the counted overflow and recover exactly
    rng = np.random.default_rng(7)
    n = 1200
    data = {"k": rng.integers(0, 400, n).astype(np.int32),
            "v": rng.standard_normal(n).astype(np.float32)}
    df = _frame(data, CPU1)
    aggs = [("v", "sum")]
    want = df.groupby(["k"], aggs).to_numpy()
    with pytest.raises(OverflowError, match="spill='auto'"):
        df.groupby(["k"], aggs, out_capacity=64)
    out = df.groupby(["k"], aggs, out_capacity=64, spill="auto")
    assert_rows_equal(out.to_numpy(), want)
    assert out.overflow_report.total_recovered >= n
    assert out.overflow_report.is_exact()


def test_join_auto_retry_and_forced_spill_agree():
    rng = np.random.default_rng(8)
    n = 900
    dl = _frame({"k": rng.integers(0, 80, n).astype(np.int32),
                 "v": rng.standard_normal(n).astype(np.float32)}, CPU1)
    dr = _frame({"k": np.arange(80, dtype=np.int32),
                 "w": rng.standard_normal(80).astype(np.float32)}, CPU1)
    want = dl.join(dr, ["k"], max_matches=16).to_numpy()
    with pytest.raises(OverflowError):
        dl.join(dr, ["k"], max_matches=16, out_capacity=64)
    auto = dl.join(dr, ["k"], max_matches=16, out_capacity=64, spill="auto")
    forced = dl.join(dr, ["k"], max_matches=16, spill=True, budget_rows=128)
    assert_rows_equal(auto.to_numpy(), want)
    assert_rows_equal(forced.to_numpy(), want)
    assert auto.overflow_report.is_exact()


def test_window_spill_and_residual_semantics():
    rng = np.random.default_rng(9)
    n = 800
    data = {"g": rng.integers(0, 20, n).astype(np.int32),
            "t": rng.permutation(n).astype(np.int32),
            "x": rng.integers(0, 50, n).astype(np.float32)}
    df = _frame(data, CPU1)
    want = df.window(["g"], ["t"]).agg([("x", "sum")], rows=4).to_numpy()
    out = df.window(["g"], ["t"]).agg([("x", "sum")], rows=4,
                                      spill="auto", budget_rows=100)
    assert_rows_equal(out.to_numpy(), want)
    assert out.overflow_report.is_exact()
    assert out.overflow_report.total_recovered == n
    # residual semantic overflow (join fan-out cap) still raises via spill
    dl = _frame({"k": np.zeros(64, np.int32),
                 "v": np.arange(64, dtype=np.float32)}, CPU1)
    dr = _frame({"k": np.zeros(8, np.int32),
                 "w": np.arange(8, dtype=np.float32)}, CPU1)
    with pytest.raises(OverflowError, match="join.fanout"):
        dl.join(dr, ["k"], max_matches=1, spill=True, budget_rows=16)


def test_spill_mode_validated_eagerly():
    df = _frame({"k": np.arange(8, dtype=np.int32),
                 "v": np.ones(8, np.float32)}, CPU1)
    with pytest.raises(ValueError, match="spill="):
        df.groupby(["k"], [("v", "sum")], spill="yes")
    with pytest.raises(ValueError, match="spill="):
        df.join(df, ["k"], spill=1.5)
    with pytest.raises(ValueError, match="spill="):
        df.window(["k"], ["v"]).agg([("v", "sum")], spill="always")


# ---------------------------------------------------------------------------
# the unified report
# ---------------------------------------------------------------------------
def test_overflow_report_api():
    r = OverflowReport()
    assert r.is_exact() and not r
    r.add("join.fanout", 0)
    assert r.entries == {}
    r.add("join.fanout", 3).add("scan.capacity", 2).add("join.fanout", 1)
    assert r.total == 6 and bool(r)
    r.merge(OverflowReport().add_recovered("spill.join", 100))
    assert r.total_recovered == 100
    assert dict(r) == {"join.fanout": 4, "scan.capacity": 2}
    with pytest.raises(OverflowError, match="join.fanout=4"):
        r.assert_exact()
    OverflowReport().add_recovered("x", 5).assert_exact()


def test_report_threads_through_lineage():
    rng = np.random.default_rng(10)
    n = 600
    df = _frame({"k": rng.integers(0, 50, n).astype(np.int32),
                 "v": rng.standard_normal(n).astype(np.float32)}, CPU1)
    g = df.groupby(["k"], [("v", "sum")], spill=True, budget_rows=64)
    assert g.overflow_report.total_recovered == n
    assert g.overflow_report.recovered == {"spill.groupby": n}
    # derived frames inherit the lineage report
    assert g.select(lambda c: c["k"] >= 0).overflow_report.total_recovered \
        == n
    with spill_groupby(df.table, ("k",), (("v", "sum"),), ctx=CPU1,
                       budget_rows=64) as res:
        chunks = list(res.chunks())
    assert sum(len(c.to_numpy()["k"]) for c in chunks) == 50
    assert all(c.partitioning == (("k",), 1) for c in chunks)
    # the TSet bridge carries the spill's report into every
    # materialization, and the chunks' layout into its barriers
    with spill_groupby(df.table, ("k",), (("v", "sum"),), ctx=CPU1,
                       budget_rows=64) as res:
        ts = res.to_tset()
    out = ts.collect()
    assert out.to_numpy()["k"].shape == (50,)
    assert out.partitioning == (("k",), 1)
    assert ts.overflow_report.recovered == {"spill.groupby": n}


def test_scan_stats_as_report():
    from repro_torch.io.scan import ScanStats

    rep = ScanStats(rows_overflowed=7).as_report()
    assert dict(rep) == {"scan.capacity": 7}
    assert ScanStats().as_report().is_exact()


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------
def _spill_inputs(ctx):
    rng = np.random.default_rng(11)
    n = 400
    return _frame({"k": rng.integers(0, 40, n).astype(np.int32),
                   "v": rng.standard_normal(n).astype(np.float32)}, ctx), n


@pytest.mark.parametrize("point", ["disk_full", "partial_write"])
def test_fault_injection_named_error_no_leaks_then_retry(
        point, tmp_path, monkeypatch):
    df, n = _spill_inputs(CPU1)
    workdir = str(tmp_path / "scratch")
    monkeypatch.setenv(FAULT_ENV, f"{point}:3")
    reset_fault_injection()
    try:
        with pytest.raises(SpillWriteError, match="free disk space") as e:
            spill_groupby(df.table, ("k",), (("v", "sum"),), ctx=CPU1,
                          budget_rows=64, workdir=workdir)
        want_errno = errno.ENOSPC if point == "disk_full" else errno.EIO
        assert e.value.__cause__.errno == want_errno
        # error path closed the store: no runs, no half-written temp files
        assert not os.path.isdir(workdir) or not os.listdir(workdir)
        # the injector disarmed after firing: the retry succeeds
        want = df.groupby(["k"], [("v", "sum")]).to_numpy()
        with spill_groupby(df.table, ("k",), (("v", "sum"),), ctx=CPU1,
                           budget_rows=64, workdir=workdir) as res:
            assert res.store.leftover_temp_files() == []
            got = res.collect()
        assert_rows_equal(got, want)
    finally:
        reset_fault_injection()


def test_fault_injection_rejects_unknown_point(monkeypatch, tmp_path):
    df, _ = _spill_inputs(CPU1)
    monkeypatch.setenv(FAULT_ENV, "meteor_strike:1")
    reset_fault_injection()
    try:
        with pytest.raises(ValueError, match="meteor_strike"):
            spill_groupby(df.table, ("k",), (("v", "sum"),), ctx=CPU1,
                          budget_rows=64, workdir=str(tmp_path / "s"))
    finally:
        reset_fault_injection()


def test_store_write_failure_cleans_tmp(monkeypatch, tmp_path):
    monkeypatch.setenv(FAULT_ENV, "partial_write:1")
    reset_fault_injection()
    try:
        store = SpillStore(str(tmp_path / "s"))
        with pytest.raises(SpillWriteError):
            store.write_run("in", 0, 0, {"a": np.arange(4)}, 4)
        assert store.leftover_temp_files() == []
        # next write (same env, already fired) succeeds atomically
        store.write_run("in", 0, 0, {"a": np.arange(4)}, 4)
        cols, nn = store.read_partition("in", 0, 0)
        assert nn == 4
        store.close()
        assert not os.path.isdir(store.root)
    finally:
        reset_fault_injection()


def test_store_policy_retries_the_write(tmp_path):
    from repro_torch.resilience import FaultPolicy, arm, fires

    reset_fault_injection()
    try:
        arm("spill.write", "disk_full")
        store = SpillStore(str(tmp_path / "s"),
                           policy=FaultPolicy(max_retries=2,
                                              backoff_base=0.0))
        store.write_run("in", 0, 0, {"a": np.arange(4)}, 4)
        assert fires("spill.write") == 1 and store.rows("in", 0) == 4
        assert store.leftover_temp_files() == []
        store.close()
    finally:
        reset_fault_injection()


def test_default_store_lives_in_tmpdir():
    store = SpillStore()
    try:
        import tempfile

        assert os.path.dirname(store.root) == tempfile.gettempdir()
    finally:
        store.close()
    assert not os.path.isdir(store.root)


@pytest.mark.parametrize("op", ["join", "groupby", "window"])
def test_spill_workdir_keeps_what_was_there(op, tmp_path):
    """A supplied ``spill_workdir`` gets a fresh run directory that is
    removed afterwards; files already in it survive."""
    df, _ = _spill_inputs(CPU1)
    workdir = tmp_path / "data"
    (workdir / "sub").mkdir(parents=True)
    (workdir / "mine.txt").write_text("user data")
    (workdir / "sub" / "more.bin").write_bytes(b"\x00\x01")
    kw = dict(spill=True, budget_rows=64, spill_workdir=str(workdir))
    if op == "join":
        right = _frame({"k": np.arange(40, dtype=np.int32),
                        "w": np.ones(40, np.float32)}, CPU1)
        df.join(right, ["k"], **kw)
    elif op == "groupby":
        df.groupby(["k"], [("v", "sum")], **kw)
    else:
        df.window(["k"], ["v"]).agg([("v", "sum")], rows=4, **kw)
    assert sorted(os.listdir(workdir)) == ["mine.txt", "sub"]
    assert (workdir / "mine.txt").read_text() == "user data"
    assert (workdir / "sub" / "more.bin").read_bytes() == b"\x00\x01"


def test_store_removes_only_the_workdir_it_made(tmp_path):
    made = tmp_path / "new" / "runs"
    store = SpillStore(str(made))
    store.write_run("in", 0, 0, {"a": np.arange(4)}, 4)
    assert os.path.dirname(store.root) == str(made)
    store.close()
    assert not made.exists() and (tmp_path / "new").is_dir()
    kept = tmp_path / "kept"
    kept.mkdir()
    with SpillStore(str(kept)) as store:
        store.write_run("in", 0, 0, {"a": np.arange(4)}, 4)
    assert kept.is_dir() and os.listdir(kept) == []


# ---------------------------------------------------------------------------
# 4 shards: re-entry on the elided paths, and parity with JAX's spill
# ---------------------------------------------------------------------------
R4 = np.random.default_rng(12)
L4 = {"k": R4.integers(0, 700, 6000).astype(np.int32),
      "v": R4.standard_normal(6000).astype(np.float32)}
RR4 = {"k": np.arange(700, dtype=np.int32),
       "w": R4.standard_normal(700).astype(np.float32)}
W4 = {"g": R4.integers(0, 50, 4000).astype(np.int32),
      "t": R4.permutation(4000).astype(np.int32),
      "x": R4.integers(0, 9, 4000).astype(np.float32)}
W4_AGGS = [("x", "sum"), (None, "row_number")]
G4_AGGS = (("v", "sum"), ("v", "count"), ("v", "min"))


def _frame4(d):
    rows = len(next(iter(d.values())))
    return DataFrame.from_dict(d, CPU4, capacity=2 * -(-rows // 4))


@pytest.fixture(scope="module")
def jax4():
    inputs = {f"l/{k}": v for k, v in L4.items()}
    inputs.update({f"r/{k}": v for k, v in RR4.items()})
    inputs.update({f"w/{k}": v for k, v in W4.items()})
    return run_jax_4way(f"""
        from repro.dataframe.frame import DataFrame
        from repro.spill import spill_groupby, spill_join, spill_window

        def frame(prefix):
            d = {{k.split("/", 1)[1]: v for k, v in inp.items()
                  if k.startswith(prefix + "/")}}
            rows = len(next(iter(d.values())))
            return DataFrame.from_dict(d, ctx,
                                       capacity=2 * -(-rows // ctx.n_shards))

        def keep(name, res):
            # the output runs in collect()'s order (partition, then
            # shard), read from the store: eager chunk assembly on 4
            # devices would recompile for every chunk capacity
            st = res.store
            pieces = [st.read_partition("out", q, s)[0]
                      for q in st.partitions("out") for s in range(4)
                      if st.rows("out", q, s)]
            for k in pieces[0]:
                out[name + "/" + k] = np.concatenate([p[k] for p in pieces])

        dl, dr, dw = frame("l"), frame("r"), frame("w")
        with spill_join(dl.table, dr.table, ("k",), ctx=ctx,
                        budget_rows=400, max_matches=4) as res:
            keep("join", res)
        with spill_groupby(dl.table, ("k",), {G4_AGGS!r}, ctx=ctx,
                           budget_rows=400) as res:
            keep("gb", res)
        with spill_window(dw.table, ("g",), ("t",), {W4_AGGS!r}, ctx=ctx,
                          budget_rows=300, rows=8) as res:
            keep("win", res)
    """, inputs)


def _jax4_result(jax4, name):
    pre = name + "/"
    return {k[len(pre):]: v for k, v in jax4.items() if k.startswith(pre)}


def test_spill_join_4_shards_vs_jax(jax4):
    dl, dr = _frame4(L4), _frame4(RR4)
    want = dl.join(dr, ["k"], max_matches=4).to_numpy()
    array_ops.EXCHANGES.reset()
    with spill_join(dl.table, dr.table, ("k",), ctx=CPU4, budget_rows=400,
                    max_matches=4) as res:
        got = res.collect()
        assert res.stats.pairs > 1
    assert array_ops.EXCHANGES.n == 0, "a spilled pair shuffled"
    assert_rows_equal(got, want)
    assert_same_places(got, _jax4_result(jax4, "join"), msg="vs JAX spill")
    # the DataFrame trigger takes the same path
    array_ops.EXCHANGES.reset()
    out = dl.join(dr, ["k"], max_matches=4, spill=True, budget_rows=400)
    assert array_ops.EXCHANGES.n == 0
    assert out.partitioning == (("k",), 4)
    assert_rows_equal(out.to_numpy(), want)


def test_spill_groupby_4_shards_vs_jax(jax4):
    dl = _frame4(L4)
    want = dl.groupby(["k"], list(G4_AGGS)).to_numpy()
    array_ops.EXCHANGES.reset()
    with spill_groupby(dl.table, ("k",), G4_AGGS, ctx=CPU4,
                       budget_rows=400) as res:
        got = res.collect()
    assert array_ops.EXCHANGES.n == 0
    assert_rows_equal(got, want)
    mag = _abs_sums(L4, "k", np.sort(want["k"]))
    assert_same_places(_by_key(got, "k"),
                       _by_key(_jax4_result(jax4, "gb"), "k"),
                       sums=("v_sum",), abs_sums={"v_sum": mag})


def test_spill_window_4_shards_vs_jax(jax4):
    dw = _frame4(W4)
    want = dw.window(["g"], ["t"]).agg(W4_AGGS, rows=8).to_numpy()
    array_ops.EXCHANGES.reset()
    array_ops.SORTS.reset()
    out = dw.window(["g"], ["t"]).agg(W4_AGGS, rows=8, spill=True,
                                      budget_rows=300)
    assert (array_ops.EXCHANGES.n, array_ops.SORTS.n) == (0, 0)
    assert out.overflow_report.is_exact()
    assert_rows_equal(out.to_numpy(), want)
    with spill_window(dw.table, ("g",), ("t",), W4_AGGS, ctx=CPU4,
                      budget_rows=300, rows=8) as res:
        assert_same_places(res.collect(), _jax4_result(jax4, "win"),
                           msg="vs JAX spill")


def test_reentered_pairs_make_no_exchange_and_no_sort():
    dl, dr = _frame4(L4), _frame4(RR4)
    with SpillStore() as store:
        _, ls = _partition_hash(store, "left", dl.table, ("k",), 4, 8)
        _, rs = _partition_hash(store, "right", dr.table, ("k",), 4, 8)
        q = store.partitions("left")[0]
        ldt = _load_hash_partition(store, "left", q, ls, ("k",), CPU4, 512)
        rdt = _load_hash_partition(store, "right", q, rs, ("k",), CPU4, 512)
        assert ldt.partitioning == (("k",), 4)
        # every row sits on the shard the shuffle would send it to
        for dt in (ldt, rdt):
            for s, n in enumerate(dt.counts.tolist()):
                h1, _ = hash_columns([dt.columns["k"][s, :n]])
                assert ((h1.to(torch.int64) & 0xFFFFFFFF) % 4 == s).all()
        array_ops.EXCHANGES.reset()
        _, ov = table_ops.join(ldt, rdt, ("k",), ctx=CPU4, max_matches=4)
        assert array_ops.EXCHANGES.n == 0 and int(ov) == 0
        # the same rows without the layout evidence shuffle both sides
        array_ops.EXCHANGES.reset()
        table_ops.join(ldt.__class__(ldt.columns, ldt.counts), rdt, ("k",),
                       ctx=CPU4, max_matches=4)
        assert array_ops.EXCHANGES.n == 1

    dw = _frame4(W4)
    with SpillStore() as store:
        _, ws = _partition_window(store, "in", dw.table, ("g",), ("g", "t"),
                                  (True, True), 8)
        q = store.partitions("in")[0]
        wdt = _load_range_partition(store, "in", q, ws, ("g", "t"),
                                    (True, True), CPU4, 512)
        array_ops.EXCHANGES.reset()
        array_ops.SORTS.reset()
        table_ops.window_aggregate(wdt, ("g",), ("t",), W4_AGGS, ctx=CPU4,
                                   rows=8)
        assert (array_ops.EXCHANGES.n, array_ops.SORTS.n) == (0, 0)
        # the unsorted input does sort (the assertion has teeth)
        table_ops.window_aggregate(dw.table, ("g",), ("t",), W4_AGGS,
                                   ctx=CPU4, rows=8)
        assert array_ops.EXCHANGES.n == 1 and array_ops.SORTS.n >= 1
