"""Parity of the port's exchange engine with the JAX package.

Packing, counting-sort ranks, compaction, the packed exchange and the
shuffle operator, on 1 shard (JAX in process) and 4 shards (JAX on 4 host
devices in one subprocess, the port on 4 virtual shards): placement,
counts and overflow must match bit for bit, and the exchange choke point
counts one call per shuffle and none when the shuffle is elided.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import DistTable as JDistTable  # noqa: E402
from repro.core import Table as JTable  # noqa: E402
from repro.core import exchange as jex  # noqa: E402
from repro.core import local_context  # noqa: E402
from repro.core import table_ops as jops  # noqa: E402
from repro_torch.core import DistTable, HPTMTContext, Table  # noqa: E402
from repro_torch.core import array_ops, table_ops  # noqa: E402
from repro_torch.core import exchange as tex  # noqa: E402
from repro_torch.core.table import as_tensor  # noqa: E402
from torch_parity import (assert_blocks_equal, bits, jax_blocks,  # noqa: E402
                          jax_result, run_jax_4way, valid_rows)

RNG = np.random.default_rng(5)
N = 512
CPU1 = HPTMTContext(n_shards=1, device="cpu")
CPU4 = HPTMTContext(n_shards=4, device="cpu")

DATA = {
    "k": RNG.integers(0, 97, N).astype(np.int32),
    "v": RNG.normal(size=N).astype(np.float32),
    "b": RNG.integers(0, 2, N).astype(bool),
    "s": RNG.integers(-300, 300, N).astype(np.int16),
    "u": RNG.integers(0, 256, N).astype(np.uint8),
}
TRAIL = RNG.normal(size=(N, 3)).astype(np.float32)
BUCKET_FACTORS = [2.0, 0.1]


def _cols(d):
    return {k: as_tensor(v, "cpu") for k, v in d.items()}


def _jcols(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


@pytest.fixture(scope="module")
def jax4():
    """Every 4-shard case of this module, computed by the JAX package."""
    inputs = {f"t/{k}": v for k, v in DATA.items()}
    inputs["trail/m"] = TRAIL
    inputs["trail/k"] = DATA["k"]
    return run_jax_4way("""
        t = table("t")
        save("input", t)
        for bf in (2.0, 0.1):
            sh, ov = run(lambda d: table_ops.shuffle(
                d, ["k"], ctx=ctx, bucket_factor=bf), t)
            save(f"shuffle_{bf}", sh, ov)
            sh2, ov2 = run(lambda d: table_ops.shuffle(
                d, ["k", "s"], ctx=ctx, bucket_factor=bf, out_capacity=100),
                t)
            save(f"shuffle2_{bf}", sh2, ov2)
        sh, ov = run(lambda d: table_ops.shuffle(d, ["k"], ctx=ctx),
                     table("trail"))
        save("trail", sh, ov)
        sh, _ = run(lambda d: table_ops.shuffle(d, ["k"], ctx=ctx), t)
        out["a2a_shuffle"] = np.asarray(a2a_count(
            lambda d: table_ops.shuffle(d, ["k"], ctx=ctx)[0], t))
        out["a2a_elided"] = np.asarray(a2a_count(
            lambda d: table_ops.shuffle(d, ["k"], ctx=ctx)[0], sh))
    """, inputs)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(DATA) + ["trail"])
def test_pack_unpack_roundtrip_bit_exact(name):
    x = TRAIL if name == "trail" else DATA[name]
    jbuf, jspecs = jex.pack_columns({"c": jnp.asarray(x)})
    tbuf, tspecs = tex.pack_columns({"c": as_tensor(x, "cpu")})
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf).view(np.int32))
    assert [(s.start, s.lanes, s.trailing) for s in tspecs] == \
        [(s.start, s.lanes, s.trailing) for s in jspecs]
    back = tex.unpack_columns(tbuf, tspecs)["c"].numpy()
    assert back.dtype == x.dtype
    np.testing.assert_array_equal(bits(back), bits(x))


def test_pack_all_columns_in_one_buffer():
    cols = dict(DATA, m=TRAIL)
    jbuf, _ = jex.pack_columns(_jcols(cols))
    tbuf, specs = tex.pack_columns(_cols(cols))
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf).view(np.int32))
    back = tex.unpack_columns(tbuf, specs)
    for k, v in cols.items():
        np.testing.assert_array_equal(bits(back[k].numpy()), bits(v))


# ---------------------------------------------------------------------------
# sort-free primitives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_parts", [4, 40])
def test_dest_ranks_vs_jax(n_parts):
    dest = RNG.integers(0, n_parts + 1, N).astype(np.int32)  # n_parts = invalid
    ref = jex.dest_ranks(jnp.asarray(dest), n_parts)
    got = tex.dest_ranks(torch.from_numpy(dest), n_parts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("out_capacity", [N, 200])
def test_compact_rows_vs_jax(out_capacity):
    keep = RNG.random(N) < 0.6
    cols = dict(DATA, m=TRAIL)
    jc, jn, jt = jex.compact_rows(_jcols(cols), jnp.asarray(keep),
                                  out_capacity)
    tc, tn, tt = tex.compact_rows(_cols(cols), torch.from_numpy(keep),
                                  out_capacity)
    assert int(tn) == int(jn) and int(tt) == int(jt)
    for k in cols:
        np.testing.assert_array_equal(bits(tc[k].numpy()),
                                      bits(np.asarray(jc[k])))


@pytest.mark.parametrize("bucket", [N, 100, 7])
def test_exchange_rows_local_vs_jax_and_reference(bucket):
    n_shards = 4
    dest = RNG.integers(0, n_shards + 1, N).astype(np.int32)
    jc, jvalid, jov = jex.exchange_rows(_jcols(DATA), jnp.asarray(dest),
                                        n_shards, bucket, None)
    (tc,), (tvalid,), (tov,) = tex.exchange_rows(
        [_cols(DATA)], [torch.from_numpy(dest)], n_shards, bucket)
    (rc,), (rvalid,), (rov,) = tex.exchange_rows_reference(
        [_cols(DATA)], [torch.from_numpy(dest)], n_shards, bucket)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(rvalid.numpy(), np.asarray(jvalid))
    assert int(tov) == int(jov) == int(rov)
    m = tvalid.numpy()
    for k in DATA:
        np.testing.assert_array_equal(bits(tc[k].numpy()),
                                      bits(np.asarray(jc[k])))
        np.testing.assert_array_equal(bits(rc[k].numpy()[m]),
                                      bits(tc[k].numpy()[m]))


def test_exchange_rows_4_shards_vs_reference():
    cols, dests = [], []
    for _ in range(4):
        cols.append(_cols({k: v[:128] for k, v in DATA.items()}))
        dests.append(torch.from_numpy(RNG.integers(0, 5, 128).astype(np.int32)))
    before = array_ops.EXCHANGES.n
    got, gvalid, gov = tex.exchange_rows(cols, dests, 4, 40)
    assert array_ops.EXCHANGES.n - before == 1  # one collective, data + counts
    ref, rvalid, rov = tex.exchange_rows_reference(cols, dests, 4, 40)
    for s in range(4):
        np.testing.assert_array_equal(gvalid[s].numpy(), rvalid[s].numpy())
        assert int(gov[s]) == int(rov[s])
        m = gvalid[s].numpy()
        for k in DATA:
            np.testing.assert_array_equal(bits(got[s][k].numpy()[m]),
                                          bits(ref[s][k].numpy()[m]))


# ---------------------------------------------------------------------------
# the shuffle operator
# ---------------------------------------------------------------------------
def test_from_local_vs_jax_1_and_4_shards(jax4):
    jt = JDistTable.from_local(JTable.from_arrays(_jcols(DATA)),
                               local_context(), capacity=600)
    tt = DistTable.from_local(Table.from_arrays(DATA, device="cpu"), CPU1,
                              capacity=600)
    assert_blocks_equal(tt, *jax_blocks(jt))
    cols, counts, part, _ = jax_result(jax4, "input")
    t4 = DistTable.from_local(Table.from_arrays(DATA, device="cpu"), CPU4)
    assert_blocks_equal(t4, cols, counts, part)


@pytest.mark.parametrize("bucket_factor", BUCKET_FACTORS)
def test_shuffle_single_shard_vs_jax(bucket_factor):
    jt = JDistTable.from_local(JTable.from_arrays(_jcols(DATA)),
                               local_context())
    jsh, jov = jax.jit(lambda d: jops.shuffle(
        d, ["k"], ctx=local_context(), bucket_factor=bucket_factor))(jt)
    tt = DistTable.from_numpy_blocks(*jax_blocks(jt)[:2], device="cpu")
    tsh, tov = table_ops.shuffle(tt, ["k"], ctx=CPU1,
                                 bucket_factor=bucket_factor)
    assert_blocks_equal(tsh, *jax_blocks(jsh))
    assert int(tov) == int(jov)


@pytest.mark.parametrize("bucket_factor", BUCKET_FACTORS)
@pytest.mark.parametrize("case", ["shuffle", "shuffle2"])
def test_shuffle_4_shards_vs_jax(jax4, case, bucket_factor):
    icols, icounts, _, _ = jax_result(jax4, "input")
    t = DistTable.from_numpy_blocks(icols, icounts, device="cpu")
    keys, kw = (["k"], {}) if case == "shuffle" else (["k", "s"],
                                                      {"out_capacity": 100})
    got, ov = table_ops.shuffle(t, keys, ctx=CPU4,
                                bucket_factor=bucket_factor, **kw)
    cols, counts, part, jov = jax_result(jax4, f"{case}_{bucket_factor}")
    assert_blocks_equal(got, cols, counts, part)
    assert int(ov) == jov
    if bucket_factor == 0.1:  # starved: rows are counted, not lost
        assert jov > 0
        assert int(got.num_rows()) + jov == N


def test_shuffle_trailing_dim_column_4_shards(jax4):
    t = DistTable.from_local(
        Table.from_arrays({"k": DATA["k"], "m": TRAIL}, device="cpu"), CPU4)
    got, ov = table_ops.shuffle(t, ["k"], ctx=CPU4)
    cols, counts, part, jov = jax_result(jax4, "trail")
    assert_blocks_equal(got, cols, counts, part)
    assert int(ov) == jov
    rows = valid_rows(*got.to_numpy_blocks()[:2])
    assert len(rows["k"]) + jov == N


def test_exchange_counter_one_per_shuffle_zero_when_elided(jax4):
    t = DistTable.from_local(Table.from_arrays(DATA, device="cpu"), CPU4)
    array_ops.EXCHANGES.reset()
    sh, _ = table_ops.shuffle(t, ["k"], ctx=CPU4)
    assert array_ops.EXCHANGES.n == int(jax4["a2a_shuffle"]) == 1
    array_ops.EXCHANGES.reset()
    again, _ = table_ops.shuffle(sh, ["k"], ctx=CPU4)
    assert again is sh
    assert array_ops.EXCHANGES.n == int(jax4["a2a_elided"]) == 0
    # one shard never exchanges
    t1 = DistTable.from_local(Table.from_arrays(DATA, device="cpu"), CPU1)
    table_ops.shuffle(t1, ["k"], ctx=CPU1)
    assert array_ops.EXCHANGES.n == 0


def test_reserved_hash_column_names_rejected():
    t = DistTable.from_local(
        Table.from_arrays({"_h1": DATA["k"], "k": DATA["k"]}, device="cpu"),
        CPU4)
    with pytest.raises(ValueError, match="reserved"):
        table_ops.join(t, t, ["k"], ctx=CPU4)
