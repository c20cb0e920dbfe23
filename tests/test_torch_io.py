"""Parity of the port's storage layer (``repro_torch.io``) and fault
registry (``repro_torch.resilience``) with the JAX package's.

The cases of ``tests/test_io.py`` and the storage cases of
``tests/test_resilience.py`` in parity form: the schema's lane math
against the port's ``pack_columns``; ``.hpt`` files written by either
package read back bit-exact by the other (and written byte for byte
alike); Arrow and Parquet round trips across the packages; pushdown scans
whose rows and ``ScanStats`` equal the reference's, with NaN-safe pruning,
count-and-drop overflow and the narrowing guard; quarantine and
``scan.read`` retries under ``FaultPolicy``; the pyarrow-disabled leg; and
partitioned re-entry on 4 virtual shards, where a join on the partition
keys makes 1 exchange with an unpartitioned right side and 0 when both
sides re-enter, with the rows of the JAX package's 4-device run.
"""
import dataclasses
import errno
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")


import repro.io as jio  # noqa: E402
import repro.resilience as jres  # noqa: E402
from repro.core import local_context  # noqa: E402
from repro.dataframe.frame import DataFrame as JDataFrame  # noqa: E402
from repro_torch import io as tio  # noqa: E402
from repro_torch import resilience as tres  # noqa: E402
from repro_torch.core import DistTable, HPTMTContext, array_ops  # noqa: E402
from repro_torch.core.exchange import pack_columns, unpack_columns  # noqa: E402
from repro_torch.dataframe import DataFrame  # noqa: E402
from torch_parity import (SRC, assert_blocks_equal, jax_blocks,  # noqa: E402
                          jax_result, run_jax_4way)

CPU1 = HPTMTContext(n_shards=1, device="cpu")
CPU4 = HPTMTContext(n_shards=4, device="cpu")
JCTX = local_context()
FORMATS = ("hpt", "parquet")

WEIRD_F32 = np.array([-0.0, 0.0, np.inf, -np.inf, np.nan, -np.nan,
                      np.float32(1e-40), 3.5], np.float32)

#: one column per storable dtype, with adversarial payloads
ALL_DTYPE_COLS = {
    "f16": WEIRD_F32.astype(np.float16),
    "f32": WEIRD_F32,
    "f64": WEIRD_F32.astype(np.float64),
    "i8": np.array([-128, 127, 0, -1, 5, 6, 7, 8], np.int8),
    "i16": np.array([-32768, 32767, 0, -1, 5, 6, 7, 8], np.int16),
    "i32": np.array([-2**31, 2**31 - 1, 0, -1, 5, 6, 7, 8], np.int32),
    "i64": np.array([-2**63, 2**63 - 1, 0, -1, 5, 6, 7, 8], np.int64),
    "u8": np.array([0, 255, 1, 2, 3, 4, 5, 6], np.uint8),
    "u16": np.array([0, 65535, 1, 2, 3, 4, 5, 6], np.uint16),
    "u32": np.array([0, 2**32 - 1, 1, 2, 3, 4, 5, 6], np.uint32),
    "u64": np.array([0, 2**64 - 1, 1, 2, 3, 4, 5, 6], np.uint64),
    "b": np.array([1, 0, 1, 1, 0, 0, 1, 0], bool),
    "emb": np.arange(24, dtype=np.float32).reshape(8, 3) * -0.5,
}


@pytest.fixture(autouse=True)
def _clean_faults():
    tres.reset()
    yield
    tres.reset()


def _need(fmt):
    """Skip a Parquet case where pyarrow is absent or disabled."""
    if fmt == "parquet":
        pytest.importorskip("pyarrow")
        if not tio.has_pyarrow():
            pytest.skip("pyarrow disabled via HPTMT_DISABLE_PYARROW")


def bit_equal(a, b, msg=""):
    """Bitwise equality — distinguishes -0.0 from 0.0 and NaN payloads."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, \
        f"{msg}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}"
    assert np.ascontiguousarray(a).tobytes() == \
        np.ascontiguousarray(b).tobytes(), msg


def rows_equal(port_dt, jax_dt, msg=""):
    """Equal valid rows, positionally, column for column."""
    got, ref = port_dt.to_numpy(), jax_dt.to_numpy()
    assert sorted(got) == sorted(ref), msg
    for k in ref:
        bit_equal(got[k], np.asarray(ref[k]), f"{msg}:{k}")


def make_events(n=1200, n_days=30, seed=3):
    rng = np.random.default_rng(seed)
    return {
        "user_id": rng.integers(0, 40, n).astype(np.int32),
        "day": np.sort(rng.integers(0, n_days, n)).astype(np.int32),
        "value": rng.normal(size=n).astype(np.float32),
        "score": rng.uniform(0, 1, n).astype(np.float32),
        "clicks": rng.integers(0, 9, n).astype(np.int32),
        "flag": rng.uniform(size=n) < 0.5,
    }


def scan_both(root, **kw):
    """The same scan through both packages → (port, jax) results."""
    jkw = dict(kw)
    pr = kw.get("predicate")
    if pr is not None:  # the port's predicates, as the reference's
        pr = [pr] if isinstance(pr, tio.ColumnPredicate) else pr
        jkw["predicate"] = [jio.pred(p.column, p.op, p.value) for p in pr]
    return (tio.read_dataset(root, ctx=CPU1, **kw),
            jio.read_dataset(root, ctx=JCTX, **jkw))


def assert_scans_equal(root, msg="", **kw):
    (tdt, tov, tst), (jdt, jov, jst) = scan_both(root, **kw)
    assert tov == jov, msg
    assert dataclasses.asdict(tst) == dataclasses.asdict(jst), msg
    assert tdt.partitioning == jdt.partitioning, msg
    assert tdt.capacity == jdt.capacity, msg
    rows_equal(tdt, jdt, msg)
    return tdt, tst


# ===========================================================================
# schema ↔ ColSpec
# ===========================================================================
def test_schema_matches_packer_layout():
    cols = {"v": torch.from_numpy(WEIRD_F32),
            "k": torch.arange(8, dtype=torch.int32),
            "b": torch.from_numpy(ALL_DTYPE_COLS["b"]),
            "h": torch.from_numpy(ALL_DTYPE_COLS["f16"]),
            "e": torch.from_numpy(ALL_DTYPE_COLS["emb"]),
            "d": torch.from_numpy(ALL_DTYPE_COLS["f64"]),
            "u": torch.from_numpy(ALL_DTYPE_COLS["u8"])}
    buf, specs = pack_columns(cols)
    schema = tio.Schema.from_columns(cols)
    assert schema.to_colspecs() == specs
    assert schema.row_width == buf.shape[1]
    assert tio.Schema.from_colspecs(specs).to_colspecs() == specs
    back = unpack_columns(buf, schema.to_colspecs())
    for k in cols:
        bit_equal(back[k].numpy(), cols[k].numpy(), k)
    # tensors and numpy arrays infer the same schema, the reference's
    npcols = {k: v.numpy() for k, v in cols.items()}
    assert tio.Schema.from_columns(npcols) == schema
    assert schema.to_json() == jio.Schema.from_columns(npcols).to_json()


def test_schema_lane_math_64bit_and_trailing():
    fields = [("a", "int64", ()), ("b", "float64", (3,)),
              ("c", "uint8", (2, 2)), ("d", "bool", ())]
    schema = tio.Schema([tio.Field(*f) for f in fields])
    ref = jio.Schema([jio.Field(*f) for f in fields])
    assert [f.lanes for f in schema] == [2, 6, 4, 1]
    assert schema.row_width == ref.row_width == 13
    specs = schema.to_colspecs()
    assert [(s.name, s.start, s.lanes) for s in specs] == \
        [(s.name, s.start, s.lanes) for s in ref.to_colspecs()]
    assert [s.dtype for s in specs] == [torch.int64, torch.float64,
                                        torch.uint8, torch.bool]
    assert tio.Schema.from_colspecs(specs) == schema


def test_schema_rejects_unsupported_dtype_and_round_trips_json():
    with pytest.raises(TypeError, match="dictionary-encode"):
        tio.Schema.from_columns({"s": np.array(["a", "b"])})
    with pytest.raises(TypeError, match="not storable"):
        tio.Schema.from_columns({"c": torch.zeros(2, dtype=torch.complex64)})
    schema = tio.Schema.from_columns(ALL_DTYPE_COLS)
    assert tio.Schema.from_json(schema.to_json()) == schema
    assert schema.to_json() == \
        jio.Schema.from_columns(ALL_DTYPE_COLS).to_json()


# ===========================================================================
# .hpt across the two packages
# ===========================================================================
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_hpt_cross_package_bit_exact(tmp_path, writer):
    """A file either package writes reads back bit-exact in the other,
    and both writers produce the same bytes."""
    ours, theirs = str(tmp_path / "port.hpt"), str(tmp_path / "jax.hpt")
    tio.write_hpt(ours, ALL_DTYPE_COLS)
    jio.write_hpt(theirs, ALL_DTYPE_COLS)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    path, read = ((theirs, tio.read_hpt) if writer == "jax"
                  else (ours, jio.read_hpt))
    back, n = read(path)
    assert n == 8 and set(back) == set(ALL_DTYPE_COLS)
    for k, v in ALL_DTYPE_COLS.items():
        bit_equal(back[k], v, k)
    assert tio.read_hpt_header(path) == jio.read_hpt_header(path)


def test_hpt_projection_reads_requested_only(tmp_path):
    path = str(tmp_path / "t.hpt")
    jio.write_hpt(path, ALL_DTYPE_COLS)
    back, _ = tio.read_hpt(path, columns=["f32", "emb"])
    assert set(back) == {"f32", "emb"}
    bit_equal(back["f32"], ALL_DTYPE_COLS["f32"])
    bit_equal(back["emb"], ALL_DTYPE_COLS["emb"])
    with pytest.raises(KeyError, match="nope"):
        tio.read_hpt(path, columns=["nope"])
    with pytest.raises(ValueError, match="ragged"):
        tio.write_hpt(str(tmp_path / "r.hpt"),
                      {"a": np.arange(3), "b": np.arange(4)})


def test_hpt_corruption_raises_the_reference_errors(tmp_path):
    p = str(tmp_path / "bad.hpt")
    tio.write_hpt(p, {"x": np.arange(100, dtype=np.int32)}, 100)
    raw = open(p, "rb").read()
    open(p, "wb").write(raw.replace(b'"num_rows": 100', b'"num_rows": 150',
                                    1))
    with pytest.raises(tio.CorruptFragmentError) as e:
        tio.read_hpt(p)
    with pytest.raises(jio.CorruptFragmentError) as je:
        jio.read_hpt(p)
    assert str(e.value) == str(je.value)
    assert isinstance(e.value, ValueError)  # fatal family: never retried
    open(p, "wb").write(raw[:-12])
    with pytest.raises(tio.HptIntegrityError, match="truncated"):
        tio.read_hpt(p)
    open(p, "wb").write(raw[:6])
    with pytest.raises(tio.HptIntegrityError, match="header-length"):
        tio.read_hpt_header(p)


# ===========================================================================
# Arrow and Parquet
# ===========================================================================
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_arrow_and_parquet_round_trip_across_packages(tmp_path, writer):
    _need("parquet")
    from repro.io import parquet as jpq
    from repro_torch.io import parquet as tpq

    to_arrow, from_arrow = ((jio.to_arrow, tio.from_arrow) if writer == "jax"
                            else (tio.to_arrow, jio.from_arrow))
    back, n = from_arrow(to_arrow(ALL_DTYPE_COLS))
    assert n == 8
    for k, v in ALL_DTYPE_COLS.items():
        bit_equal(back[k], v, k)
    path = str(tmp_path / "all.parquet")
    write, read = ((jpq.write_parquet, tpq.read_row_groups) if writer == "jax"
                   else (tpq.write_parquet, jpq.read_row_groups))
    write(path, ALL_DTYPE_COLS, rows_per_group=3)
    assert tpq.parquet_fragments(path) == jpq.parquet_fragments(path)
    back, n = read(path, [0, 1, 2])
    assert n == 8
    for k, v in ALL_DTYPE_COLS.items():
        bit_equal(back[k], v, k)
    assert tpq.parquet_schema(path) == tio.Schema.from_columns(ALL_DTYPE_COLS)


def test_arrow_schema_and_nulls():
    _need("parquet")
    import pyarrow as pa

    schema = tio.Schema.from_columns(ALL_DTYPE_COLS)
    assert tio.Schema.from_arrow(schema.to_arrow()) == schema
    assert schema.to_arrow() == \
        jio.Schema.from_columns(ALL_DTYPE_COLS).to_arrow()
    at = pa.table({"ok": pa.array([1, 2, 3], pa.int32()),
                   "holes": pa.array([1.0, None, 3.0], pa.float32())})
    with pytest.raises(ValueError, match="holes") as e:
        tio.from_arrow(at)
    with pytest.raises(ValueError) as je:
        jio.from_arrow(at)
    assert str(e.value) == str(je.value)


def test_dataframe_arrow_bridge_vs_jax():
    _need("parquet")
    import pyarrow as pa

    cols = {"k": np.arange(6, dtype=np.int32), "v": WEIRD_F32[:6],
            "w": np.arange(6, dtype=np.float64) / 3}
    df = DataFrame.from_dict(cols, CPU1)
    at = df.to_arrow()
    jat = JDataFrame.from_dict(cols, JCTX).to_arrow()
    assert isinstance(at, pa.Table) and at.schema == jat.schema
    for k in cols:  # Table.equals would call NaN unequal to itself
        bit_equal(at.column(k).to_numpy(), jat.column(k).to_numpy(), k)
    back = DataFrame.from_arrow(at, CPU1)
    jback = JDataFrame.from_arrow(at, JCTX)
    for k, v in jback.to_numpy().items():
        bit_equal(back.to_numpy()[k], np.asarray(v), k)


# ===========================================================================
# pushdown scans (the reference writes, both packages read)
# ===========================================================================
@pytest.mark.parametrize("fmt", FORMATS)
def test_pushdown_parity_and_stats(tmp_path, fmt):
    """Two of six columns under a selective predicate: the rows and every
    ``ScanStats`` counter equal the reference's, and equal a full scan +
    numpy post-filter."""
    _need(fmt)
    cols = make_events()
    root = str(tmp_path / f"events_{fmt}")
    jio.write_dataset(root, [(cols, 1200)], format=fmt, rows_per_group=150)
    dt, st = assert_scans_equal(
        root, columns=["user_id", "value"],
        predicate=[tio.pred("day", ">=", 5), tio.pred("day", "<", 9)])
    assert st.columns_total == 6 and st.columns_read == 3
    assert st.row_groups_total == 8 and st.row_groups_skipped >= 1
    assert st.rows_scanned < st.rows_on_disk
    got = dt.to_numpy()
    mask = (cols["day"] >= 5) & (cols["day"] < 9)
    bit_equal(got["user_id"], cols["user_id"][mask])
    bit_equal(got["value"], cols["value"][mask])
    assert st.rows_selected == int(mask.sum())


@pytest.mark.parametrize("op", ["<", "<=", ">", ">=", "==", "!="])
@pytest.mark.parametrize("fmt", FORMATS)
def test_pushdown_operator_coverage(tmp_path, fmt, op):
    _need(fmt)
    cols = make_events(n=600)
    root = str(tmp_path / f"ev_{fmt}")
    jio.write_dataset(root, [(cols, 600)], format=fmt, rows_per_group=100)
    npop = {"<": np.less, "<=": np.less_equal, ">": np.greater,
            ">=": np.greater_equal, "==": np.equal, "!=": np.not_equal}[op]
    dt, _ = assert_scans_equal(root, op, predicate=tio.pred("day", op, 7))
    bit_equal(dt.to_numpy()["value"], cols["value"][npop(cols["day"], 7)])


def test_predicate_validation(tmp_path):
    root = str(tmp_path / "v")
    jio.write_dataset(root, [(ALL_DTYPE_COLS, 8)], format="hpt")
    with pytest.raises(KeyError, match="missing"):
        tio.ScanSource(root, ctx=CPU1, predicate=tio.pred("missing", "<", 1))
    with pytest.raises(ValueError, match="trailing"):
        tio.ScanSource(root, ctx=CPU1, predicate=tio.pred("emb", "<", 1))
    with pytest.raises(ValueError, match="unknown predicate op"):
        tio.ColumnPredicate("f32", "~", 1)
    with pytest.raises(ValueError, match="on_error"):
        tio.ScanSource(root, ctx=CPU1, on_error="explode")
    assert tio.pred("k", "<", 3) == tio.ColumnPredicate("k", "<", 3)


def test_nan_stats_never_prune(tmp_path):
    root = str(tmp_path / "nan")
    tio.write_dataset(root, [({"x": WEIRD_F32,
                               "i": np.arange(8, dtype=np.int32)}, 8)],
                      format="hpt")
    ds = tio.open_dataset(root)
    assert ds.fragments[0].stats["x"] is None
    assert ds.fragments[0].stats["i"] == (0, 7)
    dt, st = assert_scans_equal(root, predicate=tio.pred("x", ">", 0))
    assert st.row_groups_skipped == 0
    assert dt.to_numpy()["i"].tolist() == [2, 6, 7]  # inf, 1e-40 and 3.5


@pytest.mark.parametrize("fmt", FORMATS)
def test_float_ne_predicate_never_prunes(tmp_path, fmt):
    """``!=`` on a float column never prunes (NaN rows satisfy it and
    Parquet's min/max ignore NaN); on an int column it still does."""
    _need(fmt)
    root = str(tmp_path / f"ne_{fmt}")
    x = np.array([1.0, 1.0, np.nan, 1.0], np.float32)
    tio.write_dataset(root, [({"x": x, "i": np.arange(4, dtype=np.int32)},
                              4)], format=fmt)
    dt, st = assert_scans_equal(root, predicate=tio.pred("x", "!=", 1.0))
    assert st.row_groups_skipped == 0
    assert dt.to_numpy()["i"].tolist() == [2]
    root2 = str(tmp_path / f"ne_int_{fmt}")
    tio.write_dataset(root2, [({"k": np.full(4, 7, np.int32),
                                "i": np.arange(4, dtype=np.int32)}, 4)],
                      format=fmt)
    _, st2 = assert_scans_equal(root2, predicate=tio.pred("k", "!=", 7))
    assert st2.row_groups_skipped == 1


def test_scan_stats_reset_and_chunks_vs_jax(tmp_path):
    cols = make_events(n=300)
    root = str(tmp_path / "stats")
    jio.write_dataset(root, [(cols, 300)], format="hpt", rows_per_group=60)
    src = tio.ScanSource(root, ctx=CPU1, columns=["user_id", "value"])
    src.to_dist_table()
    first = src.stats.rows_scanned
    src.to_dist_table()  # a second run must not double-count
    assert src.stats.rows_scanned == first == 300
    chunks = list(src.chunks())
    assert src.stats.rows_scanned == 300
    jchunks = list(jio.ScanSource(root, ctx=JCTX,
                                  columns=["user_id", "value"]).chunks())
    assert len(chunks) == len(jchunks) == 5
    for c, jc in zip(chunks, jchunks):
        assert_blocks_equal(c, *jax_blocks(jc))
    # the TSet bridge sources the same chunk stream
    ts = src.to_tset()
    got = ts.to_numpy()
    want = {k: np.concatenate([c.to_numpy()[k] for c in chunks])
            for k in ("user_id", "value")}
    for k, v in want.items():
        np.testing.assert_array_equal(np.sort(got[k]), np.sort(v))


@pytest.mark.parametrize("fmt", FORMATS)
def test_scan_overflow_count_and_drop(tmp_path, fmt):
    """Rows beyond an explicit capacity are counted and dropped in
    original row order, as in the reference."""
    _need(fmt)
    cols = make_events(n=500)
    root = str(tmp_path / f"ovf_{fmt}")
    jio.write_dataset(root, [(cols, 500)], format=fmt, rows_per_group=100)
    dt, st = assert_scans_equal(root, capacity=120)
    assert st.rows_overflowed == 380 and int(dt.num_rows()) == 120
    bit_equal(dt.to_numpy()["value"], cols["value"][:120])
    with pytest.raises(OverflowError, match="scan"):
        DataFrame.read_parquet(root, CPU1, capacity=120)
    df = DataFrame.read_parquet(root, CPU1, capacity=120, strict=False)
    assert df.overflow_report.entries == {"scan.capacity": 380}
    assert st.as_report().entries == {"scan.capacity": 380}


def test_scan_plans_capacity_from_metadata(tmp_path):
    cols = make_events(n=321)
    root = str(tmp_path / "cap")
    jio.write_dataset(root, [(cols, 321)], format="hpt", rows_per_group=64)
    assert tio.ScanSource(root, ctx=CPU1).shard_capacity == 321
    assert tio.ScanSource(root, ctx=CPU1,
                          bucket_factor=1.5).shard_capacity == 482
    dt, _ = assert_scans_equal(root, bucket_factor=1.5)
    assert dt.capacity == 482 and int(dt.num_rows()) == 321
    dt4, ov, _ = tio.read_dataset(root, ctx=CPU4)
    jdt4 = jio.read_dataset(root, ctx=JCTX)[0]
    assert ov == 0 and int(dt4.num_rows()) == 321
    # fragments (files of 64 rows, the last of 1) go round-robin
    assert dt4.counts.tolist() == [128, 65, 64, 64] and dt4.capacity == 128
    np.testing.assert_array_equal(np.sort(dt4.to_numpy()["value"]),
                                  np.sort(np.asarray(
                                      jdt4.to_numpy()["value"])))


def test_scan_64bit_narrowing_guard(tmp_path):
    root = str(tmp_path / "wide")
    jio.write_dataset(root, [({"big": np.array([1, 2**40], np.int64),
                               "ok64": np.array([1, 2], np.int64),
                               "f64": np.array([0.5, 1e300])}, 2)],
                      format="hpt")
    for cols in (["big"], ["f64"]):
        with pytest.raises(ValueError, match=cols[0]):
            tio.read_dataset(root, ctx=CPU1, columns=cols)
        with pytest.raises(ValueError, match=cols[0]):
            jio.read_dataset(root, ctx=JCTX, columns=cols)
    dt, _ = assert_scans_equal(root, columns=["ok64"])
    assert dt.columns["ok64"].dtype == torch.int32
    assert dt.to_numpy()["ok64"].tolist() == [1, 2]
    assert_scans_equal(root, allow_narrowing=True)


# ===========================================================================
# partitioning manifest & re-entry (1 shard)
# ===========================================================================
@pytest.mark.parametrize("fmt", FORMATS)
def test_partitioned_write_read_reattaches_metadata(tmp_path, fmt):
    """The port writes the reference's dataset: the same manifest and
    (``.hpt``) the same bytes; both packages read it back alike."""
    _need(fmt)
    cols = make_events(n=400)
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    DataFrame.from_dict(cols, CPU1).to_parquet(ours, partition_by=["user_id"],
                                               format=fmt)
    JDataFrame.from_dict(cols, JCTX).to_parquet(
        theirs, partition_by=["user_id"], format=fmt)
    manifest = [json.load(open(os.path.join(r, "_hptmt_manifest.json")))
                for r in (ours, theirs)]
    assert manifest[0] == manifest[1]
    if fmt == "hpt":
        for f in manifest[0]["files"]:
            assert open(os.path.join(ours, f["path"]), "rb").read() == \
                open(os.path.join(theirs, f["path"]), "rb").read()
    assert tio.open_dataset(ours).partitioning == (("user_id",), 1)
    back = DataFrame.read_parquet(ours, CPU1)
    assert back.partitioning == (("user_id",), 1)
    rows_equal(back.table, JDataFrame.read_parquet(ours, JCTX).table)
    assert DataFrame.read_parquet(
        ours, CPU1, columns=["day", "value"]).partitioning is None
    assert DataFrame.read_parquet(
        ours, CPU1, predicate=tio.pred("day", "<", 9)).partitioning == \
        (("user_id",), 1)
    # one shard: the shuffle permutes rows within the shard
    got = back.to_numpy()
    order = np.lexsort((cols["value"].view(np.uint32), cols["user_id"]))
    border = np.lexsort((got["value"].view(np.uint32), got["user_id"]))
    for k in cols:
        bit_equal(got[k][border], cols[k][order], k)


def test_unpartitioned_dataset_has_no_evidence(tmp_path):
    root = str(tmp_path / "plain")
    DataFrame.from_dict(make_events(n=100), CPU1).to_hpt(root)
    assert tio.open_dataset(root).partitioning is None
    assert DataFrame.read_parquet(root, CPU1).partitioning is None
    assert jio.open_dataset(root).partitioning is None
    # a single file opens as a dataset of its own
    one = tio.open_dataset(os.path.join(root, "part-00000-000.hpt"))
    assert one.num_rows == 100 and one.partitioning is None


# ===========================================================================
# resilience: the fault registry, the retry policy, hardened scans
# ===========================================================================
def test_arm_counts_down_fires_once_then_disarms():
    tres.arm("scan.read", "io_error", nth=2)
    tres.fire("scan.read")
    with pytest.raises(tres.InjectedFault):
        tres.fire("scan.read")
    tres.fire("scan.read")
    assert tres.fires("scan.read") == 1 and tres.fires() == 1


def test_fault_kinds_map_to_exception_families(tmp_path):
    tres.arm("x", "fatal")
    with pytest.raises(tres.FatalInjectedFault):
        tres.fire("x")
    p = str(tmp_path / "run0.hpt")
    tres.arm("x", "io_error")
    with pytest.raises(tres.InjectedFault) as e:
        tres.fire("x", path=p)
    assert e.value.errno == errno.EIO and e.value.filename == p
    tres.arm("x", "disk_full")
    with pytest.raises(tres.InjectedFault) as e:
        tres.fire("x")
    assert e.value.errno == errno.ENOSPC
    tres.arm("x", "partial_write")
    with pytest.raises(tres.InjectedFault) as e:
        tres.fire("x", path=p)
    assert e.value.errno == errno.EIO
    assert os.path.exists(p + ".tmp")  # torn half-write left behind
    with pytest.raises(ValueError, match="unknown fault kind"):
        tres.arm("x", "meteor_strike")
    with pytest.raises(ValueError, match="nth"):
        tres.arm("x", "io_error", nth=0)


def test_env_arming(monkeypatch):
    monkeypatch.setenv(tres.FAULTS_ENV, "scan.read:io_error:1")
    tres.reset()
    with pytest.raises(tres.InjectedFault):
        tres.fire("scan.read")
    tres.fire("scan.read")
    monkeypatch.setenv(tres.FAULTS_ENV, "scan.read:fatal:2")
    tres.reset()
    tres.fire("scan.read")
    with pytest.raises(tres.FatalInjectedFault):
        tres.fire("scan.read")
    monkeypatch.setenv(tres.FAULTS_ENV, "scan.read:meteor")
    tres.reset()
    with pytest.raises(ValueError, match="unknown fault kind"):
        tres.fire("scan.read")
    monkeypatch.setenv(tres.FAULTS_ENV, "")
    monkeypatch.setenv(tres.SPILL_FAULT_ENV, "disk_full:1")
    tres.reset()
    with pytest.raises(tres.InjectedFault):  # legacy knob → spill.write
        tres.fire("spill.write")
    tres.fire("spill.write")


def test_arm_schedule_matches_the_reference():
    sites = ["scan.read", "spill.write"]
    sched = tres.arm_schedule(11, sites, n_faults=3)
    try:
        assert sched == jres.arm_schedule(11, sites, n_faults=3)
    finally:
        jres.reset()
    tres.reset()
    assert tres.arm_schedule(12, sites, n_faults=3) != sched


def test_policy_retry_taxonomy():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    assert tres.FaultPolicy(max_retries=3).run(
        flaky, site="t", sleep=lambda s: None) == "ok"
    assert calls["n"] == 3

    def bad():
        calls["n"] += 1
        raise ValueError("deterministic bug")

    calls["n"] = 0
    with pytest.raises(ValueError, match="deterministic bug"):
        tres.FaultPolicy(max_retries=5).run(bad, site="t",
                                            sleep=lambda s: None)
    assert calls["n"] == 1

    pol = tres.FaultPolicy(max_retries=2)

    def always():
        raise OSError("down")

    with pytest.raises(tres.RetryBudgetExceeded, match="all 3 attempts"):
        pol.run(always, site="t", sleep=lambda s: None)
    calls["n"] = 0

    def inner():
        calls["n"] += 1
        return pol.run(always, site="t", sleep=lambda s: None)

    with pytest.raises(tres.RetryBudgetExceeded):
        tres.FaultPolicy(max_retries=9).run(inner, site="outer",
                                            sleep=lambda s: None)
    assert calls["n"] == 1
    narrow = tres.FaultPolicy(max_retries=4, retryable=(KeyError,),
                              fatal=())
    assert narrow.is_retryable(KeyError()) and not narrow.is_retryable(
        OSError())


def test_policy_backoff_equals_the_reference():
    kw = dict(backoff_base=0.01, backoff_factor=2.0, backoff_max=0.05,
              jitter=0.1)
    d = [tres.FaultPolicy(**kw).delay(k, site="s") for k in range(8)]
    assert d == [jres.FaultPolicy(**kw).delay(k, site="s")
                 for k in range(8)]
    assert all(x <= 0.05 * 1.1 + 1e-12 for x in d) and d[1] > d[0]


def _fragmented(tmp_path, n=64):
    rng = np.random.default_rng(3)
    cols = {"a": np.arange(n, dtype=np.float32),
            "b": (np.arange(n) % 8).astype(np.float32),
            "c": rng.normal(size=n).astype(np.float32)}
    root = str(tmp_path / "ds")
    jio.write_dataset(root, [(cols, n)], format="hpt", rows_per_group=8)
    return root


def test_scan_quarantine_skips_corrupt_run_with_sidecar(tmp_path):
    root = _fragmented(tmp_path)
    frag = sorted(f for f in os.listdir(root) if f.endswith(".hpt"))[2]
    raw = open(os.path.join(root, frag), "rb").read()
    open(os.path.join(root, frag), "wb").write(raw[:-8])
    with pytest.raises(tio.CorruptFragmentError, match=frag.replace(".",
                                                                    r"\.")):
        tio.read_dataset(root, ctx=CPU1)
    sidecar = os.path.join(root, "_hptmt_quarantine.json")
    jdt, _, jst = jio.read_dataset(root, ctx=JCTX, on_error="quarantine")
    jside = json.load(open(sidecar))
    os.remove(sidecar)
    dt, ov, st = tio.read_dataset(root, ctx=CPU1, on_error="quarantine")
    assert dataclasses.asdict(st) == dataclasses.asdict(jst)
    assert st.fragments_quarantined == 1 and st.rows_quarantined == 8
    rows_equal(dt, jdt)
    assert not np.isin(np.arange(16, 24), dt.to_numpy()["a"]).any()
    assert json.load(open(sidecar)) == jside
    assert frag in jside["quarantined"][0]["path"]


def test_scan_transient_fault_retried_by_policy(tmp_path):
    root = _fragmented(tmp_path)
    clean = tio.read_dataset(root, ctx=CPU1, predicate=tio.pred("a", "<",
                                                                48.0))
    tres.arm("scan.read", "io_error", nth=3)
    pol = tres.FaultPolicy(max_retries=2, backoff_base=0.0)
    dt, ov, st = tio.read_dataset(root, ctx=CPU1, policy=pol,
                                  predicate=tio.pred("a", "<", 48.0))
    assert tres.fires("scan.read") == 1
    assert dataclasses.asdict(st) == dataclasses.asdict(clean[2])
    rows_equal(dt, clean[0])
    tres.arm("scan.read", "io_error", nth=1)
    with pytest.raises(tres.InjectedFault):  # no policy: no retry
        tio.read_dataset(root, ctx=CPU1)
    tres.arm("scan.read", "fatal", nth=1)
    with pytest.raises(tio.CorruptFragmentError, match="injected fatal"):
        tio.read_dataset(root, ctx=CPU1, policy=pol)  # fatal: never retried


# ===========================================================================
# the pyarrow-disabled leg
# ===========================================================================
def test_pyarrow_absent_leg_native_works(tmp_path):
    """With pyarrow disabled the format falls back to ``.hpt``, scans
    work, and Parquet requests raise an error naming pyarrow."""
    script = textwrap.dedent(f"""
        import os
        os.environ["HPTMT_DISABLE_PYARROW"] = "1"
        import numpy as np
        from repro_torch.core import HPTMTContext
        from repro_torch.dataframe import DataFrame
        from repro_torch.io import has_pyarrow, pred, require_pyarrow
        assert not has_pyarrow()
        ctx = HPTMTContext(device="cpu")
        df = DataFrame.from_dict(
            {{"k": np.arange(50, dtype=np.int32),
              "v": np.arange(50, dtype=np.float32)}}, ctx)
        root = os.path.join({str(tmp_path)!r}, "ds")
        df.to_parquet(root, format=None, rows_per_group=10,
                      partition_by=["k"])
        assert all(f.endswith((".hpt", ".json")) for f in os.listdir(root))
        back = DataFrame.read_parquet(root, ctx, predicate=pred("k", "<", 20))
        assert len(back) == 20
        assert back.partitioning == (("k",), 1)
        for fn in (lambda: df.to_parquet(os.path.join({str(tmp_path)!r},
                                                      "pq")),
                   lambda: df.to_arrow(),
                   lambda: require_pyarrow("x")):
            try:
                fn()
            except RuntimeError as e:
                assert "pyarrow" in str(e) and "HPTMT_DISABLE_PYARROW" in str(e)
            else:
                raise AssertionError("a parquet request should have raised")
        print("ABSENT-LEG-OK")
        """)
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, f"stderr:\n{r.stderr[-3000:]}"
    assert "ABSENT-LEG-OK" in r.stdout


# ===========================================================================
# partitioned re-entry on 4 shards, against the JAX package's 4 devices
# ===========================================================================
N4, R4 = 96, 64


def _reentry_inputs():
    rng = np.random.default_rng(9)
    lk = rng.permutation(N4).astype(np.int32)
    rk = rng.permutation(N4).astype(np.int32)[:R4]
    return ({"k": lk, "a": lk.astype(np.float32)},
            {"k": rk, "b": rk.astype(np.float32)})


@pytest.fixture(scope="module")
def reentry(tmp_path_factory):
    """The port writes each side partitioned on ``k`` in both formats; the
    JAX package writes its own copies and, on 4 devices, reads the port's
    datasets and joins them."""
    root = str(tmp_path_factory.mktemp("reentry"))
    left, right = _reentry_inputs()
    fmts = ["hpt"] + (["parquet"] if tio.has_pyarrow() else [])
    for fmt in fmts:
        for name, cols in (("left", left), ("right", right)):
            DataFrame.from_dict(cols, CPU4, bucket_factor=2.0).to_parquet(
                os.path.join(root, f"{name}_{fmt}"), partition_by=["k"],
                format=fmt)
    inputs = {f"l/{k}": v for k, v in left.items()}
    inputs.update({f"r/{k}": v for k, v in right.items()})
    out = run_jax_4way(f"""
        import os
        from repro.dataframe.frame import DataFrame
        root = {root!r}
        left = DataFrame.from_dict({{k.split("/")[1]: v for k, v in
                                     inp.items() if k.startswith("l/")}},
                                    ctx, bucket_factor=2.0)
        right = DataFrame.from_dict({{k.split("/")[1]: v for k, v in
                                      inp.items() if k.startswith("r/")}},
                                     ctx, bucket_factor=2.0)
        save("right", right.table)
        left.to_parquet(os.path.join(root, "jax_left"), partition_by=["k"],
                        format="hpt")
        for fmt in {fmts!r}:
            lp = DataFrame.read_parquet(os.path.join(root, "left_" + fmt), ctx)
            rp = DataFrame.read_parquet(os.path.join(root, "right_" + fmt),
                                        ctx)
            save("lp_" + fmt, lp.table)
            join = lambda l, r: table_ops.join(l, r, ["k"], out_capacity=48,
                                               ctx=ctx)
            out[f"a2a1_{{fmt}}"] = np.asarray(a2a_count(join, lp.table,
                                                        right.table))
            out[f"a2a0_{{fmt}}"] = np.asarray(a2a_count(join, lp.table,
                                                        rp.table))
            save("join1_" + fmt, *run(join, lp.table, right.table))
            save("join0_" + fmt, *run(join, lp.table, rp.table))
    """, inputs)
    return root, fmts, out


def test_partitioned_reentry_4_shards_vs_jax(reentry):
    root, fmts, jax4 = reentry
    # the port wrote the JAX package's partitioned files, byte for byte
    mine, theirs = os.path.join(root, "left_hpt"), os.path.join(root,
                                                                "jax_left")
    files = sorted(f for f in os.listdir(theirs) if f.endswith(".hpt"))
    assert len(files) == 4
    for f in files + ["_hptmt_manifest.json"]:
        assert open(os.path.join(mine, f), "rb").read() == \
            open(os.path.join(theirs, f), "rb").read(), f
    right = DataFrame(DistTable.from_numpy_blocks(
        *jax_result(jax4, "right")[:2], device="cpu"), CPU4)
    for fmt in fmts:
        lp = DataFrame.read_parquet(os.path.join(root, f"left_{fmt}"), CPU4)
        rp = DataFrame.read_parquet(os.path.join(root, f"right_{fmt}"), CPU4)
        assert lp.partitioning == rp.partitioning == (("k",), 4)
        assert_blocks_equal(lp.table, *jax_result(jax4, f"lp_{fmt}")[:3])
        for name, r, a2a in (("join1", right, 1), ("join0", rp, 0)):
            array_ops.EXCHANGES.reset()
            out = lp.join(r, on=["k"], out_capacity=48)
            assert array_ops.EXCHANGES.n == a2a == int(
                jax4[f"a2a{a2a}_{fmt}"]), (fmt, name)
            cols, counts, part, ov = jax_result(jax4, f"{name}_{fmt}")
            assert ov == 0
            assert_blocks_equal(out.table, cols, counts, part, f"{name} {fmt}")
        # another shard count: the evidence does not attach
        lp2 = DataFrame.read_parquet(os.path.join(root, f"left_{fmt}"),
                                     HPTMTContext(n_shards=2, device="cpu"))
        assert lp2.partitioning is None and len(lp2) == N4

