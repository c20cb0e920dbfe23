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

min and max are also held bit for bit on mixed ``-0.0``/``+0.0`` data
(``-0.0`` is the min of the two, ``+0.0`` the max, as
``jax.ops.segment_min/max`` and ``jnp.min/max`` give), and
:func:`emulate_privatized_segment` rehearses the CUDA kernels' schedule
(``csrc/segment_reduce.cu``) on the CPU against the plain version.
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


def _signed_zeros(n, seg):
    """float32 values that are mostly +-0.0: groups with id % 7 == 0 hold
    only +0.0, == 3 only -0.0, and groups with id % 3 == 1 (2) also hold
    positive (negative) numbers."""
    v = np.where(RNG.random(n) < 0.5, np.float32(-0.0), np.float32(0.0))
    some = RNG.random(n) < 0.15
    v = np.where(some & (seg % 3 == 1), RNG.uniform(0.5, 2, n), v)
    v = np.where(some & (seg % 3 == 2), -RNG.uniform(0.5, 2, n), v)
    v = np.where(seg % 7 == 0, 0.0, v)
    v = np.where(seg % 7 == 3, -0.0, v)
    return v.astype(np.float32)


#: mixed-zero segment data: ids out of range, an empty segment, NaN
ZSEG = RNG.integers(-2, S + 3, N).astype(np.int32)
ZSEG[ZSEG == 11] = 12
ZVALS = _signed_zeros(N, ZSEG)
ZVALS[RNG.integers(0, N, 3)] = np.nan
#: a mixed-zero table for the groupby (no NaN: DATA carries those)
ZDATA = {"g": RNG.integers(0, 40, 480).astype(np.int32),
         "h": RNG.integers(0, 3, 480).astype(np.int32)}
ZDATA["v"] = _signed_zeros(480, ZDATA["g"])
ZAGGS = [("v", "min"), ("v", "max"), ("v", "count")]
#: 201 rows: one odd-signed zero among 200 of the other sign, at a row of
#: the first shard (7) or of the third (137) of a 4-shard table
ZPOS = (7, 137)
AGG_ZEROS = {}
for _pos in ZPOS:
    _lo = np.zeros(201, np.float32)  # +0.0, one -0.0: min is -0.0
    _lo[_pos] = -0.0
    AGG_ZEROS[f"lo{_pos}"] = _lo
    AGG_ZEROS[f"hi{_pos}"] = -_lo  # -0.0, one +0.0: max is +0.0
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


def assert_minmax_bits(got, ref, msg=""):
    """min/max exactly: NaN at the same places, every other entry with the
    same bits (so ``-0.0`` differs from ``+0.0``)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=msg)
    np.testing.assert_array_equal(bits(got[~nan]), bits(ref[~nan]),
                                  err_msg=msg)


@pytest.mark.parametrize("op", ["min", "max"])
def test_segment_minmax_signed_zeros_bitwise(op):
    """The plain min/max against jax.ops' ref and Pallas interpret mode on
    mixed +-0.0, with NaN, empty segments and ids out of range."""
    got = tsops.segment_reduce(torch.from_numpy(ZVALS),
                               torch.from_numpy(ZSEG), S, op).numpy()
    ref = np.asarray(jsr.segment_reduce(jnp.asarray(ZVALS),
                                        jnp.asarray(ZSEG), S, op))
    pallas = np.asarray(jsk.segment_reduce_pallas(
        jnp.asarray(ZVALS), jnp.asarray(ZSEG), S, op, interpret=True))
    zero = ref == 0
    # both signs of zero come out, so the check can tell them apart
    assert np.signbit(ref[zero]).any() and not np.signbit(ref[zero]).all()
    assert np.isnan(ref).any() and np.isinf(ref).any()
    assert_minmax_bits(got, ref, "ref")
    assert_minmax_bits(got, pallas, "pallas")


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
# the CUDA kernels' schedule, rehearsed on the CPU
# ---------------------------------------------------------------------------
#: dynamic shared memory an H100 block may opt in to (the kernels' limit)
SMEM_BYTES = 232448
I32 = np.iinfo(np.int32)


def _key(v, op):
    """The kernels' int32 order key: ``-0.0`` below ``+0.0``, NaN the
    extreme that wins (INT_MIN for min, INT_MAX for max)."""
    b = np.asarray(v, np.float32).view(np.int32)
    key = b ^ ((b >> 31) & 0x7FFFFFFF)
    return np.where(np.isnan(v), I32.min if op == "min" else I32.max,
                    key).astype(np.int32)


def _unkey(k, op):
    nan = I32.min if op == "min" else I32.max
    b = np.where(k == nan, 0x7FC00000, k ^ ((k >> 31) & 0x7FFFFFFF))
    return b.astype(np.int32).view(np.float32)


def emulate_privatized_segment(values, seg, num_segments, op, *, ctas=3,
                               threads=8, smem=SMEM_BYTES, seed=0):
    """The schedule of ``csrc/segment_reduce.cu``, in numpy.

    ``values (N, L)`` float32, ``seg (N,)`` int32 → ``((S, L), path)``.
    The path is chosen as the C entry points choose it: ``"smem"`` when
    ``S * 4`` bytes fit in ``smem`` (lanes split into chunks of equal width
    when ``S * L * 4`` do not), else ``"direct"``.

    * smem: row ``r`` belongs to CTA ``(r % (ctas * threads)) // threads``
      of each lane chunk; each CTA folds its rows, in a shuffled order,
      into a tile that starts at the identity (0.0, or the INT_MAX/INT_MIN
      key), then publishes every entry that is not still the identity;
    * direct: warps of 32 consecutive rows; each run of equal ids is
      reduced by the shuffle ladder (lane ``i`` takes lane ``i - d`` while
      ``i - d`` is in its run, ``d = 1, 2, ..., 16``) and its last lane
      publishes.

    The published partials land on the output in a shuffled order, by
    float32 adds or integer min/max on the keys (the global atomics), and
    min/max keys turn back into floats (NaN as the canonical quiet NaN).
    """
    rng = np.random.default_rng(seed)
    n, lanes = values.shape
    s_ = num_segments
    valid = (seg >= 0) & (seg < s_)
    if op == "sum":
        combine, x, ident = np.add, values.astype(np.float32), np.float32(0)
        out = np.zeros((s_, lanes), np.float32)
    else:
        combine = np.minimum if op == "min" else np.maximum
        x, ident = _key(values, op), (I32.max if op == "min" else I32.min)
        init = np.float32(np.inf if op == "min" else -np.inf)
        out = np.full((s_, lanes), _key(init, op), np.int32)
    partials = []  # (segment ids, lane, partials) of the global atomics
    per_tile = min(smem // (s_ * 4), lanes)
    if per_tile > 0:
        path = "smem"
        chunks = -(-lanes // per_tile)
        width = -(-lanes // chunks)
        cta = (np.arange(n) % (ctas * threads)) // threads
        for lane0 in range(0, lanes, width):
            for b in range(ctas):
                rows = rng.permutation(np.flatnonzero((cta == b) & valid))
                for c in range(lane0, min(lane0 + width, lanes)):
                    tile = np.full(s_, ident, x.dtype)
                    combine.at(tile, seg[rows], x[rows, c])
                    keep = np.flatnonzero(tile != ident)  # 0.0 == -0.0
                    partials.append((keep, c, tile[keep]))
    else:
        path = "direct"
        for w0 in range(0, n, 32):
            rows = np.arange(w0, min(w0 + 32, n))
            s, lane = seg[rows], np.arange(rows.shape[0])
            head = np.r_[True, s[1:] != s[:-1]]
            start = np.maximum.accumulate(np.where(head, lane, 0))
            pub = np.r_[head[1:], True] & valid[rows]
            for c in range(lanes):
                v = np.where(valid[rows], x[rows, c], ident).astype(x.dtype)
                for d in (1, 2, 4, 8, 16):
                    y = np.concatenate([v[:d], v[:-d]])[:v.shape[0]]
                    v = np.where(lane - d >= start, combine(y, v), v)
                partials.append((s[pub], c, v[pub]))
    for i in rng.permutation(len(partials)):
        idx, c, part = partials[i]
        combine.at(out[:, c], idx, part)
    return (out if op == "sum" else _unkey(out, op)), path


def _sorted_by_segment(seg, values):
    order = np.argsort(seg, kind="stable")
    return seg[order], values[order]


#: (name, shared-memory bytes, sort the ids): one tile, lane chunks, and
#: the direct path on shuffled and on sorted ids
SCHEDULES = [("smem", SMEM_BYTES, False), ("direct", 4 * S - 4, False),
             ("direct_sorted", 4 * S - 4, True)]


@pytest.mark.parametrize("name,smem,sort", SCHEDULES,
                         ids=[c[0] for c in SCHEDULES])
@pytest.mark.parametrize("op", ["min", "max"])
def test_emulated_schedule_minmax_bitwise(op, name, smem, sort):
    """The kernels' schedule gives the plain min/max bit for bit on mixed
    +-0.0 with NaN, empty segments and ids out of range."""
    seg, v = (_sorted_by_segment(ZSEG, ZVALS) if sort else (ZSEG, ZVALS))
    got, path = emulate_privatized_segment(v[:, None], seg, S, op, smem=smem)
    assert path == name.split("_")[0]
    exp = tsops.segment_reduce(torch.from_numpy(v), torch.from_numpy(seg), S,
                               op).numpy()
    assert_minmax_bits(got[:, 0], exp, f"{op} {name}")


#: (name, shared-memory bytes, sort the ids) for three lanes: exactly at
#: the limit (one tile), one byte-word short of it (two lane chunks), and
#: one lane that does not fit (direct)
FUSED_SCHEDULES = [("smem", 3 * 4 * S, False),
                   ("smem_chunks", 3 * 4 * S - 4, False),
                   ("direct", 4 * S - 4, False),
                   ("direct_sorted", 4 * S - 4, True)]


@pytest.mark.parametrize("name,smem,sort", FUSED_SCHEDULES,
                         ids=[c[0] for c in FUSED_SCHEDULES])
@pytest.mark.parametrize("data", ["finite", "nan"])
def test_emulated_schedule_fused_sums(data, name, smem, sort):
    """Counts exact, sums within ``1e-5 * sum|v|`` of the plain version
    (NaN where it has NaN), ids out of range dropped."""
    vals = VALS if data == "finite" else NAN_VALS
    seg, vals = _sorted_by_segment(SEG, vals) if sort else (SEG, vals)
    got, path = emulate_privatized_segment(vals, seg, S, "sum", smem=smem)
    assert path == name.split("_")[0]
    exp = tsops.segment_reduce_fused(torch.from_numpy(vals),
                                     torch.from_numpy(seg), S).numpy()
    np.testing.assert_array_equal(got[:, 0], exp[:, 0])
    assert_sums_close(got, exp, _abs_sums(seg, vals, S), name)


@pytest.mark.parametrize("name,smem,sort", FUSED_SCHEDULES,
                         ids=[c[0] for c in FUSED_SCHEDULES])
def test_emulated_schedule_drops_ids_out_of_range(name, smem, sort):
    """Rows whose id lies outside ``[0, S)`` (NaN here) reach no output."""
    out_of_range = (SEG < 0) | (SEG >= S)
    assert out_of_range.any()
    vals = np.where(out_of_range[:, None], np.float32(np.nan), VALS)
    seg, vals = _sorted_by_segment(SEG, vals) if sort else (SEG, vals)
    got, _ = emulate_privatized_segment(vals, seg, S, "sum", smem=smem)
    exp = tsops.segment_reduce_fused(torch.from_numpy(VALS[~out_of_range]),
                                     torch.from_numpy(SEG[~out_of_range]),
                                     S).numpy()
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(got[:, 0], exp[:, 0])
    assert_sums_close(got, exp, _abs_sums(SEG, VALS, S), name)


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
    inputs.update({f"z/{k}": v for k, v in ZDATA.items()})
    inputs.update({f"zagg/{k}": v for k, v in AGG_ZEROS.items()})
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
        z = table("z", capacity=200)
        save("z", z)
        for name, keys, kw in {GROUPBY_CASES!r}:
            res, ov = run(lambda d: table_ops.groupby_aggregate(
                d, keys, {ZAGGS!r}, ctx=ctx, **kw), z)
            save("z_" + name, res, ov)
        zagg = table("zagg", capacity=64)
        save("zagg", zagg)
        for col in {sorted(AGG_ZEROS)!r}:
            for op in ("min", "max"):
                out[f"zagg_{{col}}_{{op}}"] = np.asarray(run(
                    lambda d: table_ops.aggregate(d, col, op, ctx=ctx), zagg))
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


@pytest.mark.parametrize("name,keys,kw", GROUPBY_CASES,
                         ids=[c[0] for c in GROUPBY_CASES])
def test_groupby_signed_zeros_bitwise_vs_jax(jax4, name, keys, kw):
    """min/max on mixed +-0.0, hash and sort, on 1 shard and on 4: every
    output bit equal to JAX's (``-0.0`` the min, ``+0.0`` the max)."""
    jt = _jax_table(ZDATA)
    jout, jov = jax.jit(lambda d: jops.groupby_aggregate(
        d, keys, ZAGGS, ctx=local_context(), **kw))(jt)
    tout, tov = table_ops.groupby_aggregate(_port(jt), keys, ZAGGS, ctx=CPU1,
                                            **kw)
    assert int(tov) == int(jov)
    cols, counts, part = jax_blocks(jout)
    v_min = valid_rows(cols, counts)["v_min"]
    assert np.signbit(v_min[v_min == 0]).any()  # the check sees the signs
    assert_blocks_equal(tout, cols, counts, part, msg=f"{name} 1 shard")

    t4 = DistTable.from_numpy_blocks(*jax_result(jax4, "z")[:2], device="cpu")
    tout, tov = table_ops.groupby_aggregate(t4, keys, ZAGGS, ctx=CPU4, **kw)
    cols, counts, part, jov = jax_result(jax4, "z_" + name)
    assert int(tov) == jov
    assert_blocks_equal(tout, cols, counts, part, msg=f"{name} 4 shards")


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


@pytest.mark.parametrize("pos", ZPOS)
@pytest.mark.parametrize("col", ["lo", "hi"])
@pytest.mark.parametrize("op", ["min", "max"])
def test_aggregate_signed_zeros_bitwise(jax4, op, col, pos):
    """min/max of 200 zeros of one sign and one of the other, bit for bit.

    On 1 shard against JAX's aggregate.  On 4 shards against JAX's
    aggregate of the same rows on one device (``jnp.min``/``jnp.max`` over
    every row): JAX's 4-shard aggregate combines shards with
    ``lax.pmin``/``pmax``, whose all-reduce on the CPU keeps the lowest
    shard's zero and drops NaN, so it is held to the port only where the
    odd zero lies in the first shard.
    """
    name = f"{col}{pos}"
    jt = _jax_table({"x": AGG_ZEROS[name]})
    ref = np.asarray(jops.aggregate(jt, "x", op, ctx=local_context()))
    assert ref == 0
    got1 = table_ops.aggregate(_port(jt), "x", op, ctx=CPU1).numpy()
    cols, counts = jax_result(jax4, "zagg")[:2]
    t4 = DistTable.from_numpy_blocks({"x": cols[name]}, counts, device="cpu")
    got4 = table_ops.aggregate(t4, "x", op, ctx=CPU4).numpy()
    np.testing.assert_array_equal(bits(got1), bits(ref))
    np.testing.assert_array_equal(bits(got4), bits(ref))
    first = cols[name][:counts[0]]
    if np.signbit(first).any() != np.signbit(first).all():  # odd one there
        np.testing.assert_array_equal(
            bits(got4), bits(jax4[f"zagg_{name}_{op}"].astype(np.float32)))


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


def test_plain_segment_sum_of_small_runs_after_a_long_prefix():
    """Each segment's sum is its own rows' sum: one-row segments of tiny
    values after 2^18 rows of positive values come back exactly (a float64
    prefix sum over the whole table carried its rounding, ~1e-11 here,
    into every later segment), against the JAX reference too."""
    rng = np.random.default_rng(41)
    n = 1 << 18
    v = np.abs(rng.standard_normal(n)).astype(np.float32)
    v[-100:] = rng.uniform(1e-7, 1e-5, 100).astype(np.float32)
    seg = np.arange(n, dtype=np.int32)
    got = tsops.segment_reduce_fused(torch.from_numpy(v)[:, None],
                                     torch.from_numpy(seg), n)[:, 0].numpy()
    np.testing.assert_array_equal(got, v)
    ref = np.asarray(jsr.segment_reduce(jnp.asarray(v), jnp.asarray(seg), n,
                                        "sum"))
    np.testing.assert_array_equal(got, ref)
