"""Parity of the port's groupby, scalar aggregates and set operators with
the JAX package.

The plain versions of the segment-reduction kernels are held against the
JAX references and the Pallas kernels in interpret mode: counts and
min/max exactly (NaN groups included), float sums to
``|got - ref| <= 1e-5 * sum|v|`` per group — the port's plain version
sums in float64 after a sort, the reference scatters (or reduces one-hot
tiles) in float32, so the order and the rounding differ.  Then the
operators on 1 shard and on 4: hash and sort local kernels, with and
without map-side combine.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import DistTable as JDistTable  # noqa: E402
from repro.core import Table as JTable  # noqa: E402
from repro.core import local_context  # noqa: E402
from repro.core import table_ops as jops  # noqa: E402
from repro.kernels.segment_reduce import kernel as jsk  # noqa: E402
from repro.kernels.segment_reduce import ref as jsr  # noqa: E402
from repro_torch.core import DistTable, HPTMTContext, table_ops  # noqa: E402
from repro_torch.kernels.segment_reduce import ops as tsops  # noqa: E402
from torch_parity import (assert_blocks_equal, assert_sums_close,  # noqa: E402
                          bits, jax_blocks, jax_result, run_jax_4way,
                          valid_rows)

RNG = np.random.default_rng(17)
CPU1 = HPTMTContext(n_shards=1, device="cpu")
CPU4 = HPTMTContext(n_shards=4, device="cpu")

N, S = 700, 50
SEG = RNG.integers(-3, S + 5, N).astype(np.int32)  # some ids out of range
SEG[SEG == 7] = 8  # an empty segment
VALS = RNG.normal(size=(N, 3)).astype(np.float32)
VALS[:, 0] = 1.0  # a count lane
NAN_VALS = VALS.copy()
NAN_VALS[RNG.integers(0, N, 6), 1] = np.nan

DATA = {"g": RNG.integers(0, 40, 480).astype(np.int32),
        "h": RNG.integers(0, 3, 480).astype(np.int32),
        "v": RNG.normal(size=480).astype(np.float32),
        "w": RNG.normal(size=480).astype(np.float32)}
DATA["v"][RNG.integers(0, 480, 4)] = np.nan
AGGS = [("v", "sum"), ("v", "mean"), ("v", "min"), ("v", "max"),
        ("w", "sum"), ("v", "count"), ("w", "max")]
#: (name, keys, kwargs)
GROUPBY_CASES = [
    ("hash", ["g"], {"method": "hash", "out_capacity": 64}),
    ("hash_nocombine", ["g"], {"method": "hash", "out_capacity": 64,
                               "combine": False}),
    ("sort", ["g", "h"], {"method": "sort"}),
    ("auto", ["g"], {}),
]
SET_A = {"x": RNG.integers(0, 30, 300).astype(np.int32),
         "y": RNG.integers(0, 2, 300).astype(np.int32)}
SET_B = {"x": RNG.integers(10, 40, 200).astype(np.int32),
         "y": RNG.integers(0, 2, 200).astype(np.int32)}


def _abs_sums(seg, vals, num_segments):
    """Per-segment sum of |v| (the tolerance scale), NaN-free."""
    out = np.zeros((num_segments,) + vals.shape[1:])
    ok = (seg >= 0) & (seg < num_segments)
    np.add.at(out, seg[ok], np.nan_to_num(np.abs(vals[ok].astype(np.float64))))
    return out


# ---------------------------------------------------------------------------
# segment reductions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("op", ["min", "max"])
def test_segment_minmax_exact_with_nan(op):
    v = NAN_VALS[:, 1]
    got = tsops.segment_reduce(torch.from_numpy(v), torch.from_numpy(SEG), S,
                               op).numpy()
    ref = np.asarray(jsr.segment_reduce(jnp.asarray(v), jnp.asarray(SEG), S,
                                        op))
    pallas = np.asarray(jsk.segment_reduce_pallas(
        jnp.asarray(v), jnp.asarray(SEG), S, op, interpret=True))
    assert np.isnan(ref).any() and np.isinf(ref).any()  # NaN + empty groups
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pallas)


def test_segment_minmax_nan_propagation_small():
    v = torch.tensor([1.0, float("nan"), 3.0, 2.0])
    s = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    np.testing.assert_array_equal(tsops.segment_reduce(v, s, 3, "min").numpy(),
                                  [np.nan, 2.0, np.inf])
    np.testing.assert_array_equal(tsops.segment_reduce(v, s, 3, "max").numpy(),
                                  [np.nan, 3.0, -np.inf])


@pytest.mark.parametrize("data", ["finite", "nan"])
def test_segment_sum_vs_jax_ref_and_pallas(data):
    v = (VALS if data == "finite" else NAN_VALS)[:, 1]
    got = tsops.segment_reduce(torch.from_numpy(v), torch.from_numpy(SEG), S,
                               "sum").numpy()
    scale = _abs_sums(SEG, v, S)
    ref = jsr.segment_reduce(jnp.asarray(v), jnp.asarray(SEG), S, "sum")
    assert_sums_close(got, ref, scale, "ref")
    if data == "finite":  # the one-hot matmul spreads a NaN over its block
        pallas = jsk.segment_reduce_pallas(jnp.asarray(v), jnp.asarray(SEG),
                                           S, "sum", interpret=True)
        assert_sums_close(got, pallas, scale, "pallas")


@pytest.mark.parametrize("data", ["finite", "nan"])
def test_segment_sum_fused_vs_jax_ref_and_pallas(data):
    vals = VALS if data == "finite" else NAN_VALS
    got = tsops.segment_reduce_fused(torch.from_numpy(vals),
                                     torch.from_numpy(SEG), S).numpy()
    ref = np.asarray(jsr.segment_reduce_fused(jnp.asarray(vals),
                                              jnp.asarray(SEG), S))
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])  # counts: exact
    assert_sums_close(got, ref, _abs_sums(SEG, vals, S), "ref")
    if data == "finite":
        pallas = jsk.segment_reduce_fused_pallas(
            jnp.asarray(vals), jnp.asarray(SEG), S, interpret=True)
        assert_sums_close(got, pallas, _abs_sums(SEG, vals, S), "pallas")


# ---------------------------------------------------------------------------
# groupby operator
# ---------------------------------------------------------------------------
def _group_scale(keys, out_rows):
    """Per output group, sum|v| and sum|w| over its input rows."""
    idx = {}
    for i, key in enumerate(zip(*(DATA[k] for k in keys))):
        idx.setdefault(tuple(int(x) for x in key), []).append(i)
    okeys = zip(*(out_rows[k] for k in keys))
    rows = [idx[tuple(int(x) for x in key)] for key in okeys]
    return {c: np.array([np.nansum(np.abs(DATA[c][r].astype(np.float64)))
                         for r in rows]) for c in ("v", "w")}, \
        np.array([len(r) for r in rows])


def assert_groupby_close(port_dt, cols, counts, part, keys, msg=""):
    """Keys, counts, min/max and the layout exactly; sums and means to the
    per-group tolerance."""
    pcols, pcounts, ppart = port_dt.to_numpy_blocks()
    np.testing.assert_array_equal(pcounts, counts, err_msg=msg)
    assert repr(ppart) == part
    assert sorted(pcols) == sorted(cols)
    got, ref = valid_rows(pcols, pcounts), valid_rows(cols, counts)
    scale, n = _group_scale(keys, ref)
    for k in cols:
        if k.endswith(("_sum", "_mean")):
            s = scale[k.split("_")[0]]
            assert_sums_close(got[k], ref[k],
                              s / n if k.endswith("_mean") else s,
                              f"{msg}:{k}")
        else:
            np.testing.assert_array_equal(bits(got[k]), bits(ref[k]),
                                          err_msg=f"{msg}:{k}")


@pytest.fixture(scope="module")
def jax4():
    inputs = {f"t/{k}": v for k, v in DATA.items()}
    inputs.update({f"a/{k}": v for k, v in SET_A.items()})
    inputs.update({f"b/{k}": v for k, v in SET_B.items()})
    return run_jax_4way(f"""
        t = table("t", capacity=200)
        save("t", t)
        for name, keys, kw in {GROUPBY_CASES!r}:
            res, ov = run(lambda d: table_ops.groupby_aggregate(
                d, keys, {AGGS!r}, ctx=ctx, **kw), t)
            save(name, res, ov)
        for op in ("sum", "mean", "count", "min", "max"):
            out["agg_" + op] = np.asarray(run(
                lambda d: table_ops.aggregate(d, "w", op, ctx=ctx), t))
        a, b = table("a", capacity=100), table("b", capacity=80)
        save("a", a)
        save("b", b)
        for kind in ("union", "intersect", "difference"):
            fn = getattr(table_ops, kind)
            res, ov = run(lambda x, y: fn(x, y, ctx=ctx), a, b)
            save(kind, res, ov)
    """, inputs)


def _jax_table(data):
    return JDistTable.from_local(JTable.from_arrays(
        {k: jnp.asarray(v) for k, v in data.items()}), local_context())


def _port(jdt):
    return DistTable.from_numpy_blocks(*jax_blocks(jdt)[:2], device="cpu")


@pytest.mark.parametrize("name,keys,kw", GROUPBY_CASES,
                         ids=[c[0] for c in GROUPBY_CASES])
def test_groupby_single_shard_vs_jax(name, keys, kw):
    jt = _jax_table(DATA)
    jout, jov = jax.jit(lambda d: jops.groupby_aggregate(
        d, keys, AGGS, ctx=local_context(), **kw))(jt)
    tout, tov = table_ops.groupby_aggregate(_port(jt), keys, AGGS, ctx=CPU1,
                                            **kw)
    assert int(tov) == int(jov)
    assert_groupby_close(tout, *jax_blocks(jout), keys, name)


@pytest.mark.parametrize("name,keys,kw", GROUPBY_CASES,
                         ids=[c[0] for c in GROUPBY_CASES])
def test_groupby_4_shards_vs_jax(jax4, name, keys, kw):
    t = DistTable.from_numpy_blocks(*jax_result(jax4, "t")[:2], device="cpu")
    tout, tov = table_ops.groupby_aggregate(t, keys, AGGS, ctx=CPU4, **kw)
    cols, counts, part, jov = jax_result(jax4, name)
    assert int(tov) == jov
    assert_groupby_close(tout, cols, counts, part, keys, name)


def test_groupby_overflow_counted_vs_jax():
    jt = _jax_table(DATA)
    jout, jov = jax.jit(lambda d: jops.groupby_aggregate(
        d, ["g"], [("w", "sum")], ctx=local_context(), method="hash",
        out_capacity=16))(jt)
    tout, tov = table_ops.groupby_aggregate(
        _port(jt), ["g"], [("w", "sum")], ctx=CPU1, method="hash",
        out_capacity=16)
    assert int(tov) == int(jov) > 0
    np.testing.assert_array_equal(tout.to_numpy()["g"],
                                  np.asarray(jout.columns["g"])[:16])


@pytest.mark.parametrize("op", ["sum", "mean", "count", "min", "max"])
def test_aggregate_vs_jax_1_and_4_shards(jax4, op):
    jt = _jax_table(DATA)
    ref1 = float(jops.aggregate(jt, "w", op, ctx=local_context()))
    got1 = float(table_ops.aggregate(_port(jt), "w", op, ctx=CPU1))
    t4 = DistTable.from_numpy_blocks(*jax_result(jax4, "t")[:2],
                                     device="cpu")
    got4 = float(table_ops.aggregate(t4, "w", op, ctx=CPU4))
    ref4 = float(jax4["agg_" + op])
    scale = np.abs(DATA["w"]).sum() / (len(DATA["w"]) if op == "mean" else 1)
    for got, ref in ((got1, ref1), (got4, ref4)):
        if op in ("sum", "mean"):
            assert abs(got - ref) <= 1e-5 * scale
        else:
            assert got == ref


@pytest.mark.parametrize("kind", ["union", "intersect", "difference"])
def test_set_ops_vs_jax_1_and_4_shards(jax4, kind):
    ja, jb = _jax_table(SET_A), _jax_table(SET_B)
    jout, jov = jax.jit(lambda x, y: getattr(jops, kind)(
        x, y, ctx=local_context()))(ja, jb)
    tout, tov = getattr(table_ops, kind)(_port(ja), _port(jb), ctx=CPU1)
    assert_blocks_equal(tout, *jax_blocks(jout), msg=kind)
    assert int(tov) == int(jov)

    a = DistTable.from_numpy_blocks(*jax_result(jax4, "a")[:2], device="cpu")
    b = DistTable.from_numpy_blocks(*jax_result(jax4, "b")[:2], device="cpu")
    tout, tov = getattr(table_ops, kind)(a, b, ctx=CPU4)
    cols, counts, part, jov = jax_result(jax4, kind)
    assert_blocks_equal(tout, cols, counts, part, msg=kind)
    assert int(tov) == jov
