"""Parity of the port's hash-join engine with the JAX package.

The build/probe/emit primitives bit for bit against the JAX references
(the probe also against the Pallas kernel in interpret mode), then the
join operator for all four ``how`` modes, fan-out beyond ``max_matches``
and a starved ``max_probes``, on 1 shard and on 4: the same rows in the
same places, and the same overflow.
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
from repro.core.exchange import key_compare_u32 as jkey_lanes  # noqa: E402
from repro.core.table import hash_columns as jhash  # noqa: E402
from repro.kernels.hash_join import kernel as jhk  # noqa: E402
from repro.kernels.hash_join import ref as jhr  # noqa: E402
from repro_torch.core import DistTable, HPTMTContext, table_ops  # noqa: E402
from repro_torch.core.exchange import key_compare_u32  # noqa: E402
from repro_torch.core.table import as_tensor, hash_columns  # noqa: E402
from repro_torch.kernels.hash_join import ops as thops  # noqa: E402
from repro_torch.kernels.hash_join import ref as thr  # noqa: E402
from torch_parity import (assert_blocks_equal, jax_blocks,  # noqa: E402
                          jax_result, run_jax_4way)

RNG = np.random.default_rng(3)
CPU1 = HPTMTContext(n_shards=1, device="cpu")
CPU4 = HPTMTContext(n_shards=4, device="cpu")

#: float key pool exercising the bitwise identity: NaN (equal bits match),
#: -0.0 vs +0.0 (distinct), and plain values
KEY_POOL = np.array([0.0, -0.0, 1.0, 2.0, 3.5, np.nan, np.nan, 7.25],
                    np.float32)

LEFT = {"k": RNG.integers(0, 90, 400).astype(np.int32),
        "a": RNG.normal(size=400).astype(np.float32)}
RIGHT = {"k": RNG.integers(0, 60, 160).astype(np.int32),
         "b": RNG.integers(-9, 9, 160).astype(np.int32)}
#: (how, max_matches, max_probes)
JOIN_CASES = [("inner", 8, None), ("left", 8, None), ("right", 8, None),
              ("outer", 8, None), ("inner", 1, None), ("outer", 1, 2)]


def _case_id(case):
    return "-".join(str(c) for c in case)


def _i32(a):
    return np.asarray(a).view(np.int32)


def _keys(kind, n):
    if kind == "float":
        return KEY_POOL[RNG.integers(0, len(KEY_POOL), n)]
    return RNG.integers(0, max(2, n // 10), n).astype(np.int32)


def _hashed(kind, n, valid_p=0.9):
    k = _keys(kind, n)
    jh1, jh2 = jhash([jnp.asarray(k)])
    lanes = jkey_lanes({"k": jnp.asarray(k)}, ["k"])
    th1, th2 = hash_columns([as_tensor(k, "cpu")])
    tl = key_compare_u32({"k": as_tensor(k, "cpu")}, ["k"])
    np.testing.assert_array_equal(th1.numpy(), _i32(jh1))
    np.testing.assert_array_equal(tl.numpy(), _i32(lanes))
    valid = RNG.random(n) < valid_p
    return (jh1, jh2, lanes, jnp.asarray(valid)), (th1, th2, tl,
                                                   torch.from_numpy(valid))


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("slots,max_probes", [(4096, 64), (512, 4)])
def test_build_tables_bit_exact(kind, slots, max_probes):
    (jh1, jh2, jl, jv), (th1, th2, tl, tv) = _hashed(kind, 600)
    jt, jfail = jhr.build_table(jh1, jh2, jv, slots, max_probes)
    tt, tfail = thr.build_table(th1, th2, tv, slots, max_probes)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert int(tfail) == int(jfail)

    jo, jseg, junres = jhr.build_table_unique(jh1, jh2, jl, jv, slots,
                                              max_probes)
    to, tseg, tunres = thr.build_table_unique(th1, th2, tl, tv, slots,
                                              max_probes)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tseg.numpy(), np.asarray(jseg))
    np.testing.assert_array_equal(tunres.numpy(), np.asarray(junres))


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("max_matches,max_probes", [(1, 64), (4, 64),
                                                    (4, 3)])
def test_probe_and_emit_bit_exact(kind, max_matches, max_probes):
    (jh1, jh2, jl, jv), (th1, th2, tl, tv) = _hashed(kind, 300)
    slots = 2048
    jt, _ = jhr.build_table(jh1, jh2, jv, slots, max_probes)
    tt, _ = thr.build_table(th1, th2, tv, slots, max_probes)
    jsh2, jskeys = jhr.slot_payload(jt, jh2, jl)
    tsh2, tskeys = thr.slot_payload(tt, th2, tl)
    np.testing.assert_array_equal(tsh2.numpy(), _i32(jsh2))
    np.testing.assert_array_equal(tskeys.numpy(), _i32(jskeys))

    (ph1, ph2, pl, pv), (qh1, qh2, ql, qv) = _hashed(kind, 500)
    ref = jhr.probe(jt, jsh2, jskeys, ph1, ph2, pl, pv, max_matches,
                    max_probes)
    pallas = jhk.probe_pallas(jt, jsh2, jskeys, ph1, ph2, pl, pv,
                              max_matches, max_probes, interpret=True)
    yardstick = thr.probe(tt, tsh2, tskeys, qh1, qh2, ql, qv, max_matches,
                          max_probes)
    records, side = thops.slot_records(tt, th2, tl)
    got = thops.probe(records, side, qh1, qh2, ql, qv, max_matches,
                      max_probes)
    for exp in (ref, pallas):
        for port in (yardstick, got):
            for g, e in zip(port, exp):
                np.testing.assert_array_equal(g.numpy(), np.asarray(e))

    cnt, rimat = got[0], got[1]
    emit_n = torch.where(qv, torch.clamp(cnt, 1, max_matches), 0)
    base = torch.cumsum(emit_n, 0, dtype=torch.int32) - emit_n
    total = emit_n.sum(dtype=torch.int32)
    jemit = jnp.asarray(emit_n.numpy())
    jli, jri = jhr.emit_lookup(jnp.asarray(rimat.numpy()),
                               jnp.asarray(base.numpy()), jemit,
                               jnp.sum(jemit), 700)
    tli, tri = thr.emit_lookup(rimat, base, emit_n, total, 700)
    np.testing.assert_array_equal(tli.numpy(), np.asarray(jli))
    np.testing.assert_array_equal(tri.numpy(), np.asarray(jri))


def _hashed_lanes(lanes, n, kind, valid_p=0.9):
    """Keys of ``lanes`` 32-bit lanes, one column a lane: int32 from a
    small pool (duplicates), or float32 from KEY_POOL (±0.0, NaN)."""
    if kind == "int":
        cols = {f"c{i}": RNG.integers(0, 5, n).astype(np.int32)
                for i in range(lanes)}
    else:
        cols = {f"f{i}": KEY_POOL[RNG.integers(0, 4 if i else 8, n)]
                for i in range(lanes)}
    names = sorted(cols)
    jh1, jh2 = jhash([jnp.asarray(cols[k]) for k in names])
    jl = jkey_lanes({k: jnp.asarray(v) for k, v in cols.items()}, names)
    tcols = {k: as_tensor(v, "cpu") for k, v in cols.items()}
    th1, th2 = hash_columns([tcols[k] for k in names])
    tl = key_compare_u32(tcols, names)
    assert tl.shape == (n, lanes)
    np.testing.assert_array_equal(tl.numpy(), _i32(jl))
    valid = RNG.random(n) < valid_p
    return (jh1, jh2, jl, jnp.asarray(valid)), (th1, th2, tl,
                                                torch.from_numpy(valid))


@pytest.mark.parametrize("lanes", [1, 2, 3])
@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("unique", [False, True])
@pytest.mark.parametrize("max_matches,max_probes", [(1, 64), (8, 64),
                                                    (8, 2)])
def test_slot_records_and_packed_walk_bit_exact(lanes, kind, unique,
                                                max_matches, max_probes):
    """The packed slot records hold the reference's three slot arrays,
    and the walk over them gives the JAX probe's outputs bit for bit —
    join tables (duplicate keys, chain order) and unique-key tables (set-op
    membership) at 1, 2 and 3 lanes, a starved ``max_probes`` included."""
    (jh1, jh2, jl, jv), (th1, th2, tl, tv) = _hashed_lanes(lanes, 400, kind)
    slots = 1024
    if unique:
        jt = jhr.build_table_unique(jh1, jh2, jl, jv, slots, 64)[0]
        tt = thr.build_table_unique(th1, th2, tl, tv, slots, 64)[0]
    else:
        jt = jhr.build_table(jh1, jh2, jv, slots, 64)[0]
        tt = thr.build_table(th1, th2, tv, slots, 64)[0]
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    jsh2, jskeys = jhr.slot_payload(jt, jh2, jl)
    records, side = thops.slot_records(tt, th2, tl)
    assert records.dtype == torch.int32
    np.testing.assert_array_equal(records[:, 0].numpy(), np.asarray(jt))
    np.testing.assert_array_equal(records[:, 1].numpy(), _i32(jsh2))
    if lanes <= thr.RECORD_LANES:
        assert side is None and records.shape == (slots, 4)
        keys = records[:, 2:2 + lanes]
        assert not records[:, 2 + lanes:].any()
    else:
        assert records.shape == (slots, 2) and side.shape == (slots, lanes)
        keys = side
    np.testing.assert_array_equal(keys.numpy(), _i32(jskeys))

    (ph1, ph2, pl, pv), (qh1, qh2, ql, qv) = _hashed_lanes(lanes, 300, kind)
    exp = jhr.probe(jt, jsh2, jskeys, ph1, ph2, pl, pv, max_matches,
                    max_probes)
    got = thops.probe(records, side, qh1, qh2, ql, qv, max_matches,
                      max_probes)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    if not unique and max_probes == 64:
        assert int(got[0].max()) > 1  # duplicate build keys chain up
    if not unique and max_probes == 2:
        assert bool(got[2].any())  # the starved walk leaves rows exhausted


def test_probe_kernel_refuses_cpu_tensors():
    """The kernel's wrapper raises on CPU records instead of falling back
    to the plain walk."""
    from repro_torch.kernels.hash_join import kernel as thk

    _, (th1, th2, tl, tv) = _hashed_lanes(3, 64, "int")
    tt, _ = thr.build_table(th1, th2, tv, 256, 64)
    records, side = thops.slot_records(tt, th2, tl)
    with pytest.raises(ValueError, match="CUDA"):
        thk.probe_cuda(records, side, th1, th2, tl, tv)


# ---------------------------------------------------------------------------
# the join operator
# ---------------------------------------------------------------------------
def _jax_join(l, r, how, mm, mp, ctx):
    return jax.jit(lambda a, b: jops.join(
        a, b, ["k"], ctx=ctx, how=how, max_matches=mm, max_probes=mp,
        method="hash"))(l, r)


@pytest.fixture(scope="module")
def jax4():
    inputs = {f"l/{k}": v for k, v in LEFT.items()}
    inputs.update({f"r/{k}": v for k, v in RIGHT.items()})
    return run_jax_4way(f"""
        l, r = table("l", capacity=200), table("r", capacity=80)
        save("l", l)
        save("r", r)
        for how, mm, mp in {JOIN_CASES!r}:
            res, ov = run(lambda a, b: table_ops.join(
                a, b, ["k"], ctx=ctx, how=how, max_matches=mm,
                max_probes=mp, method="hash"), l, r)
            save(f"{{how}}-{{mm}}-{{mp}}", res, ov)
    """, inputs)


@pytest.mark.parametrize("case", JOIN_CASES, ids=_case_id)
def test_join_single_shard_vs_jax(case):
    how, mm, mp = case
    jl = JDistTable.from_local(JTable.from_arrays(
        {k: jnp.asarray(v) for k, v in LEFT.items()}), local_context())
    jr = JDistTable.from_local(JTable.from_arrays(
        {k: jnp.asarray(v) for k, v in RIGHT.items()}), local_context())
    jout, jov = _jax_join(jl, jr, how, mm, mp, local_context())
    tl = DistTable.from_numpy_blocks(*jax_blocks(jl)[:2], device="cpu")
    tr = DistTable.from_numpy_blocks(*jax_blocks(jr)[:2], device="cpu")
    tout, tov = table_ops.join(tl, tr, ["k"], ctx=CPU1, how=how,
                               max_matches=mm, max_probes=mp)
    assert_blocks_equal(tout, *jax_blocks(jout), msg=str(case))
    assert int(tov) == int(jov)
    if mp is not None or mm == 1:
        assert int(jov) > 0  # fan-out / probe overflow is counted


@pytest.mark.parametrize("case", JOIN_CASES, ids=_case_id)
def test_join_4_shards_vs_jax(jax4, case):
    how, mm, mp = case
    tl = DistTable.from_numpy_blocks(*jax_result(jax4, "l")[:2],
                                     device="cpu")
    tr = DistTable.from_numpy_blocks(*jax_result(jax4, "r")[:2],
                                     device="cpu")
    tout, tov = table_ops.join(tl, tr, ["k"], ctx=CPU4, how=how,
                               max_matches=mm, max_probes=mp)
    cols, counts, part, jov = jax_result(jax4, _case_id(case))
    assert_blocks_equal(tout, cols, counts, part, msg=str(case))
    assert int(tov) == jov


def test_join_float_keys_bitwise_identity():
    """NaN keys with equal bits join; -0.0 and +0.0 do not."""
    lk = KEY_POOL[RNG.integers(0, len(KEY_POOL), 200)]
    rk = KEY_POOL.copy()
    jl = JDistTable.from_local(JTable.from_arrays({"k": jnp.asarray(lk)}),
                               local_context())
    jr = JDistTable.from_local(JTable.from_arrays(
        {"k": jnp.asarray(rk), "i": jnp.arange(len(rk), dtype=jnp.int32)}),
        local_context())
    jout, jov = _jax_join(jl, jr, "left", 2, None, local_context())
    tl = DistTable.from_numpy_blocks(*jax_blocks(jl)[:2], device="cpu")
    tr = DistTable.from_numpy_blocks(*jax_blocks(jr)[:2], device="cpu")
    tout, tov = table_ops.join(tl, tr, ["k"], ctx=CPU1, how="left",
                               max_matches=2)
    assert_blocks_equal(tout, *jax_blocks(jout))
    assert int(tov) == int(jov)


def test_sort_join_waits_for_later_slice():
    t = DistTable.from_numpy_blocks({"k": LEFT["k"]}, [400], device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        table_ops.join(t, t, ["k"], ctx=CPU1, method="sort")
    with pytest.raises(NotImplementedError, match="later slice"):
        table_ops.cartesian(t, t, ctx=CPU1)
