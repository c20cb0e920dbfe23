"""Parity of the port's sort-merge join and cartesian product with the JAX
package.

``join(method="sort")`` for all four ``how`` modes at ``max_matches`` 1
and 3, a probe window narrower than a key's run of equal hashes, float
keys compared by bits (NaN with equal bits, ``-0.0`` apart from ``+0.0``)
and right shards with no rows, on 1 shard and on 4: the same rows in the
same places, the same overflow and the same partitioning.  ``cartesian``
on 1 and 4 shards, including an ``out_capacity`` below the product, where
both packages drop the same rows uncounted.
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
from repro_torch.core import DistTable, HPTMTContext, Table, table_ops  # noqa: E402
from repro_torch.core import array_ops  # noqa: E402
from torch_parity import (assert_blocks_equal, jax_blocks,  # noqa: E402
                          jax_result, run_jax_4way)

RNG = np.random.default_rng(17)
CPU1 = HPTMTContext(n_shards=1, device="cpu")
CPU4 = HPTMTContext(n_shards=4, device="cpu")

KEY_POOL = np.array([0.0, -0.0, 1.0, 2.0, 3.5, np.nan, np.nan, 7.25],
                    np.float32)

#: name -> (left columns, right columns); right keys repeat (about 2.7
#: rows a key), so some runs of equal hashes outgrow the window of 4
DATA = {
    "int": ({"k": RNG.integers(0, 90, 400).astype(np.int32),
             "a": RNG.normal(size=400).astype(np.float32)},
            {"k": RNG.integers(0, 60, 160).astype(np.int32),
             "b": RNG.integers(-9, 9, 160).astype(np.int32)}),
    # one key 7 times on the right: more equal keys than the window
    "wide": ({"k": np.repeat(np.arange(6, dtype=np.int32), 5),
              "a": np.arange(30, dtype=np.float32)},
             {"k": np.r_[np.full(7, 2), np.arange(3, 9)].astype(np.int32),
              "b": np.arange(13, dtype=np.int32)}),
    "float": ({"k": KEY_POOL[RNG.integers(0, len(KEY_POOL), 200)],
               "a": np.arange(200, dtype=np.float32)},
              {"k": KEY_POOL.copy(), "i": np.arange(8, dtype=np.int32)}),
    # every right row on one shard: the other three right shards are empty
    "empty": ({"k": RNG.integers(0, 12, 64).astype(np.int32),
               "a": np.arange(64, dtype=np.float32)},
              {"k": np.full(3, 5, np.int32),
               "b": np.arange(3, dtype=np.int32)}),
}
#: (data, how, max_matches, window)
JOIN_CASES = ([("int", how, mm, 4) for how in ("inner", "left", "right",
                                                "outer") for mm in (1, 3)]
              + [("wide", "outer", 3, 4), ("wide", "inner", 8, 2),
                 ("float", "outer", 2, 4), ("float", "inner", 1, 4),
                 ("empty", "outer", 1, 4), ("empty", "right", 2, 4)])
CART = {"a": {"k": np.arange(12, dtype=np.int32),
              "v": RNG.normal(size=12).astype(np.float32)},
        "b": {"k": np.arange(100, 110, dtype=np.int32),
              "w": RNG.normal(size=10).astype(np.float32)}}
#: (out_capacity on 1 shard, on 4 shards): None is the whole product
CART_CAPS = [(None, None), (50, 20)]


def _case_id(case):
    return "-".join(str(c) for c in case)


def _jax_local(cols):
    return JDistTable.from_local(JTable.from_arrays(
        {k: jnp.asarray(v) for k, v in cols.items()}), local_context())


def _port(cols, counts):
    return DistTable.from_numpy_blocks(cols, counts, device="cpu")


@pytest.fixture(scope="module")
def jax4():
    inputs = {}
    for name, (left, right) in DATA.items():
        inputs.update({f"{name}.l/{k}": v for k, v in left.items()})
        inputs.update({f"{name}.r/{k}": v for k, v in right.items()})
    inputs.update({f"cart.a/{k}": v for k, v in CART["a"].items()})
    inputs.update({f"cart.b/{k}": v for k, v in CART["b"].items()})
    return run_jax_4way(f"""
        sides = {{}}
        for name in {sorted(DATA)!r}:
            n = len(inp[name + ".l/k"])
            sides[name] = (table(name + ".l", capacity=n // 2),
                           table(name + ".r",
                                 capacity=len(inp[name + ".r/k"])))
            save(name + ".l", sides[name][0])
            save(name + ".r", sides[name][1])
        for data, how, mm, w in {JOIN_CASES!r}:
            res, ov = run(lambda a, b: table_ops.join(
                a, b, ["k"], ctx=ctx, how=how, max_matches=mm, window=w,
                method="sort"), *sides[data])
            save(f"{{data}}-{{how}}-{{mm}}-{{w}}", res, ov)
        a, b = table("cart.a"), table("cart.b")
        save("cart.a", a)
        save("cart.b", b)
        for _, cap in {CART_CAPS!r}:
            save(f"cart-{{cap}}", run(lambda x, y: table_ops.cartesian(
                x, y, ctx=ctx, out_capacity=cap), a, b))
    """, inputs)


@pytest.mark.parametrize("case", JOIN_CASES, ids=_case_id)
def test_sort_join_single_shard_vs_jax(case):
    data, how, mm, w = case
    left, right = DATA[data]
    jl, jr = _jax_local(left), _jax_local(right)
    jout, jov = jax.jit(lambda a, b: jops.join(
        a, b, ["k"], ctx=local_context(), how=how, max_matches=mm,
        window=w, method="sort"))(jl, jr)
    tout, tov = table_ops.join(_port(*jax_blocks(jl)[:2]),
                               _port(*jax_blocks(jr)[:2]), ["k"], ctx=CPU1,
                               how=how, max_matches=mm, window=w,
                               method="sort")
    assert_blocks_equal(tout, *jax_blocks(jout), msg=str(case))
    assert int(tov) == int(jov)
    if data == "wide":
        assert int(jov) > 0  # the window or the fan-out cap is counted


@pytest.mark.parametrize("case", JOIN_CASES, ids=_case_id)
def test_sort_join_4_shards_vs_jax(jax4, case):
    data = case[0]
    _, how, mm, w = case
    tl = _port(*jax_result(jax4, f"{data}.l")[:2])
    tr = _port(*jax_result(jax4, f"{data}.r")[:2])
    if data == "empty":  # after the exchange, three right shards are empty
        shuffled, _ = table_ops.shuffle(tr, ["k"], ctx=CPU4)
        assert int((shuffled.counts == 0).sum()) == 3
    tout, tov = table_ops.join(tl, tr, ["k"], ctx=CPU4, how=how,
                               max_matches=mm, window=w, method="sort")
    cols, counts, part, jov = jax_result(jax4, _case_id(case))
    assert_blocks_equal(tout, cols, counts, part, msg=str(case))
    assert int(tov) == jov


def test_sort_join_counts_one_sort_a_shard_and_no_probe(monkeypatch):
    """One ``lex_order`` a shard's local join and the hash join's two
    exchanges on 4 shards; the hash probe never runs."""
    from repro_torch.kernels.hash_join import ops as hjops

    def no_probe(*a, **k):
        raise AssertionError("the sort join probed a hash table")

    monkeypatch.setattr(hjops, "probe", no_probe)
    left, right = DATA["int"]
    for ctx, sorts, exchanges in ((CPU1, 1, 0), (CPU4, 4, 2)):
        tl, tr = (DistTable.from_local(Table.from_arrays(c, device="cpu"),
                                       ctx, capacity=len(c["k"]))
                  for c in (left, right))
        array_ops.SORTS.reset()
        array_ops.EXCHANGES.reset()
        table_ops.join(tl, tr, ["k"], ctx=ctx, how="outer", max_matches=3,
                       method="sort")
        assert (array_ops.SORTS.n, array_ops.EXCHANGES.n) == (sorts,
                                                              exchanges)


def test_sort_join_empty_right_capacity():
    """A right side of capacity 0 joins like one holding no valid row."""
    left = DATA["empty"][0]
    jl = _jax_local(left)
    jr = JDistTable({"k": jnp.zeros((1,), jnp.int32),
                     "b": jnp.zeros((1,), jnp.int32)},
                    jnp.zeros((1,), jnp.int32))
    tl = _port(*jax_blocks(jl)[:2])
    t0 = DistTable({"k": torch.zeros((1, 0), dtype=torch.int32),
                    "b": torch.zeros((1, 0), dtype=torch.int32)},
                   torch.zeros(1, dtype=torch.int32))
    for how in ("inner", "left", "right", "outer"):
        jout, jov = jops.join(jl, jr, ["k"], ctx=local_context(), how=how,
                              method="sort")
        tout, tov = table_ops.join(tl, t0, ["k"], ctx=CPU1, how=how,
                                   method="sort")
        assert_blocks_equal(tout, *jax_blocks(jout), msg=how)
        assert int(tov) == int(jov) == 0


@pytest.mark.parametrize("caps", CART_CAPS, ids=str)
def test_cartesian_single_shard_vs_jax(caps):
    ja, jb = _jax_local(CART["a"]), _jax_local(CART["b"])
    jout = jops.cartesian(ja, jb, ctx=local_context(), out_capacity=caps[0])
    array_ops.EXCHANGES.reset()
    tout = table_ops.cartesian(_port(*jax_blocks(ja)[:2]),
                               _port(*jax_blocks(jb)[:2]), ctx=CPU1,
                               out_capacity=caps[0])
    assert array_ops.EXCHANGES.n == 0
    assert_blocks_equal(tout, *jax_blocks(jout), msg=str(caps))
    if caps[0] is not None:  # truncated, uncounted, as in the reference
        assert int(tout.num_rows()) == caps[0] < 120


@pytest.mark.parametrize("caps", CART_CAPS, ids=str)
def test_cartesian_4_shards_vs_jax(jax4, caps):
    ta = _port(*jax_result(jax4, "cart.a")[:2])
    tb = _port(*jax_result(jax4, "cart.b")[:2])
    array_ops.EXCHANGES.reset()
    tout = table_ops.cartesian(ta, tb, ctx=CPU4, out_capacity=caps[1])
    assert array_ops.EXCHANGES.n == 0  # an all-gather, not an all-to-all
    cols, counts, part, _ = jax_result(jax4, f"cart-{caps[1]}")
    assert_blocks_equal(tout, cols, counts, part, msg=str(caps))
    if caps[1] is None:
        got = tout.to_numpy()
        pairs = sorted(zip(got["a_k"].tolist(), got["b_k"].tolist()))
        assert pairs == sorted((a, b) for a in CART["a"]["k"].tolist()
                               for b in CART["b"]["k"].tolist())


def test_dataframe_join_takes_window_like_jax():
    """``window=`` reaches the sort join through ``DataFrame.join``: a
    window narrower than a run of equal keys overflows and raises in both
    packages, a wide one gives the reference's rows."""
    from repro.core.report import OverflowError as JOverflowError
    from repro.dataframe.frame import DataFrame as JDataFrame
    from repro_torch.core.report import OverflowError as TOverflowError
    from repro_torch.dataframe import DataFrame

    left, right = DATA["wide"]
    frames = [(DataFrame.from_dict(left, CPU1),
               DataFrame.from_dict(right, CPU1)),
              (JDataFrame.from_dict(left, local_context()),
               JDataFrame.from_dict(right, local_context()))]
    for (l, r), err in zip(frames, (TOverflowError, JOverflowError)):
        with pytest.raises(err, match="join"):
            l.join(r, ["k"], method="sort", max_matches=8, window=4)
    (tl, tr), (jl, jr) = frames
    got = tl.join(tr, ["k"], method="sort", max_matches=8, window=8)
    ref = jl.join(jr, ["k"], method="sort", max_matches=8, window=8)
    for k, v in ref.to_numpy().items():
        np.testing.assert_array_equal(got.to_numpy()[k], np.asarray(v), k)
