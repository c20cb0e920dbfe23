"""The port's first slice as a whole: the DataFrame chain
``from_dict → join → groupby → union`` against the JAX package on 1 shard
and on 4, the exchange count against the reference's traced all-to-all
count, the device rule of the entry points, and the import boundary.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import local_context  # noqa: E402
from repro.dataframe.frame import DataFrame as JDataFrame  # noqa: E402
from repro_torch.core import (DistTable, HPTMTContext, array_ops,  # noqa: E402
                              local_context as tlocal, table_ops)
from repro_torch.core.report import OverflowError as TOverflowError  # noqa: E402
from repro_torch.dataframe import DataFrame  # noqa: E402
from torch_parity import (SRC, assert_blocks_equal, assert_sums_close,  # noqa: E402
                          bits, jax_blocks, jax_result, run_jax_4way,
                          valid_rows)

RNG = np.random.default_rng(23)
CPU1 = HPTMTContext(n_shards=1, device="cpu")
CPU4 = HPTMTContext(n_shards=4, device="cpu")
NL, NR = 480, 160
LEFT = {"k": RNG.integers(0, NR, NL).astype(np.int32),
        "g": RNG.integers(0, 12, NL).astype(np.int32),
        "v": RNG.normal(size=NL).astype(np.float32)}
RIGHT = {"k": RNG.permutation(NR).astype(np.int32),
         "w": RNG.normal(size=NR).astype(np.float32)}
GB_AGGS = [("v", "sum"), ("w", "max"), ("v", "count"), ("v", "mean")]


def chain(ldf, rdf):
    """The slice's main path on either package's DataFrame."""
    j = ldf.join(rdf, ["k"])
    gb = j.groupby(["g"], GB_AGGS, out_capacity=32)
    gk = j.groupby(["k"], [("v", "sum")])
    u = j.project(["k", "g"]).union(ldf.project(["k", "g"]))
    return {"j": j, "gb": gb, "gk": gk, "u": u}


@pytest.fixture(scope="module")
def jax4():
    """The chain on 4 shards, by the JAX package's operators under jit (its
    eager DataFrame dispatches shard_map primitive by primitive), plus the
    traced all-to-all count of the chain."""
    inputs = {f"l/{k}": v for k, v in LEFT.items()}
    inputs.update({f"r/{k}": v for k, v in RIGHT.items()})
    return run_jax_4way(f"""
        l, r = table("l", capacity=240), table("r", capacity=80)
        def chain(l, r):
            j, o1 = table_ops.join(l, r, ["k"], ctx=ctx)
            gb, o2 = table_ops.groupby_aggregate(
                j, ["g"], {GB_AGGS!r}, ctx=ctx, out_capacity=32)
            gk, o3 = table_ops.groupby_aggregate(j, ["k"], [("v", "sum")],
                                                 ctx=ctx)
            a = table_ops.project(j, ["k", "g"], ctx=ctx)
            b = table_ops.project(l, ["k", "g"], ctx=ctx)
            u, o4 = table_ops.union(a, b, ctx=ctx)
            return (j, gb, gk, u), (o1, o2, o3, o4)
        tables, ovs = run(chain, l, r)
        for name, t, o in zip(("j", "gb", "gk", "u"), tables, ovs):
            save(name, t, o)
        out["a2a_chain"] = np.asarray(a2a_count(chain, l, r))
    """, inputs)


def _compare(port_df, cols, counts, part, name):
    if name in ("j", "u"):
        assert_blocks_equal(port_df.table, cols, counts, part, msg=name)
        return
    pcols, pcounts, ppart = port_df.table.to_numpy_blocks()
    np.testing.assert_array_equal(pcounts, counts)
    assert repr(ppart) == part
    got, ref = valid_rows(pcols, pcounts), valid_rows(cols, counts)
    assert sorted(got) == sorted(ref)
    n = np.maximum(ref.get("v_count", np.ones(1)), 1)
    for k in ref:
        if k.endswith(("_sum", "_mean")):
            # float sums: the kernels and the reference add in different
            # orders; |v| <= 5 here, so sum|v| <= 5 * count
            scale = 5.0 * (n if k != "v_mean" else 1.0) * (
                1 if name == "gb" else 8)
            assert_sums_close(got[k], ref[k], scale, f"{name}:{k}")
        else:
            np.testing.assert_array_equal(bits(got[k]), bits(ref[k]),
                                          err_msg=f"{name}:{k}")


def test_chain_single_shard_vs_jax_dataframe():
    jl = JDataFrame.from_dict(LEFT, local_context())
    jr = JDataFrame.from_dict(RIGHT, local_context())
    ref = chain(jl, jr)
    got = chain(DataFrame.from_dict(LEFT, CPU1),
                DataFrame.from_dict(RIGHT, CPU1))
    for name in ref:
        _compare(got[name], *jax_blocks(ref[name].table), name)
        assert got[name].partitioning == ref[name].partitioning
        assert dict(got[name].overflow_report) == \
            dict(ref[name].overflow_report)
        assert got[name].overflow_report.is_exact()
        assert len(got[name]) == len(ref[name])


def test_chain_4_shards_vs_jax(jax4):
    array_ops.EXCHANGES.reset()
    got = chain(DataFrame.from_dict(LEFT, CPU4, capacity=240),
                DataFrame.from_dict(RIGHT, CPU4, capacity=80))
    exchanges = array_ops.EXCHANGES.n
    for name, df in got.items():
        cols, counts, part, ov = jax_result(jax4, name)
        assert ov == 0
        _compare(df, cols, counts, part, name)
        assert df.overflow_report.is_exact()
    # the choke-point counter equals the reference's traced all-to-alls:
    # join 2, groupby g 1 (combined), groupby k 0 (elided), union 2
    assert exchanges == int(jax4["a2a_chain"]) == 5


def test_chain_matches_numpy_oracle():
    got = chain(DataFrame.from_dict(LEFT, CPU4, bucket_factor=2.0),
                DataFrame.from_dict(RIGHT, CPU4, bucket_factor=2.0))
    w = np.empty(NR, np.float32)
    w[RIGHT["k"]] = RIGHT["w"]
    j = got["j"].to_numpy()
    assert len(j["k"]) == NL and j["_matched"].all()
    np.testing.assert_array_equal(j["w"], w[j["k"]])
    gb = got["gb"].to_numpy()
    for i, g in enumerate(gb["g"]):
        m = LEFT["g"] == g
        assert gb["v_count"][i] == m.sum()
        assert gb["w_max"][i] == w[LEFT["k"][m]].max()
        assert abs(gb["v_sum"][i] - LEFT["v"][m].astype(np.float64).sum()) \
            <= 1e-5 * np.abs(LEFT["v"][m]).sum()
    u = got["u"].to_numpy()
    assert len(u["k"]) == len({(a, b) for a, b in zip(LEFT["k"], LEFT["g"])})


def test_to_torch_matches_to_jax():
    jdf = JDataFrame.from_dict(LEFT, local_context())
    tdf = DataFrame.from_dict(LEFT, CPU1)
    np.testing.assert_array_equal(tdf.to_torch().numpy(),
                                  np.asarray(jdf.to_jax()))
    assert tdf.agg("v", "count") == jdf.agg("v", "count")


def test_from_dict_narrows_like_jax():
    data = {"k": RNG.integers(0, 50, 64), "v": RNG.normal(size=64)}
    assert data["k"].dtype == np.int64 and data["v"].dtype == np.float64
    jdf = JDataFrame.from_dict(data, local_context())
    tdf = DataFrame.from_dict(data, CPU1)
    assert_blocks_equal(tdf.table, *jax_blocks(jdf.table))
    ref = jdf.repartition(["k"]).to_numpy()
    got = tdf.repartition(["k"]).to_numpy()
    for k in ref:
        np.testing.assert_array_equal(bits(got[k]), bits(ref[k]))


def test_from_dict_capacity_validation():
    with pytest.raises(ValueError, match="cannot hold"):
        DataFrame.from_dict(LEFT, CPU4, capacity=10)
    with pytest.raises(ValueError, match="ragged"):
        DataFrame.from_dict({"a": np.arange(3), "b": np.arange(4)}, CPU1)


def test_overflow_raises_and_report_stays_exact():
    ldf = DataFrame.from_dict(LEFT, CPU4)  # no head-room for hash skew
    rdf = DataFrame.from_dict(RIGHT, CPU4)
    with pytest.raises(TOverflowError):
        ldf.join(rdf, ["k"], bucket_factor=0.1)
    with pytest.raises(OverflowError):  # the builtin family catches it too
        ldf.groupby(["g"], [("v", "sum")], out_capacity=2, method="hash")
    assert ldf.overflow_report.is_exact()


def test_numpy_blocks_carry_partitioning_and_elide():
    jdf = JDataFrame.from_dict(LEFT, local_context())
    blocks = jax_blocks(jdf.table)
    t = DistTable.from_numpy_blocks(blocks[0], blocks[1], device="cpu")
    assert_blocks_equal(t, *blocks)
    cols, counts, _ = DataFrame.from_dict(LEFT, CPU4, bucket_factor=2.0) \
        .repartition(["k"]).table.to_numpy_blocks()
    part = (("k",), 4)
    t4 = DistTable.from_numpy_blocks(cols, counts, part, device="cpu")
    r4 = DataFrame.from_dict(RIGHT, CPU4, bucket_factor=2.0).repartition(["k"])
    array_ops.EXCHANGES.reset()
    out, ov = table_ops.join(t4, r4.table, ["k"], ctx=CPU4)
    assert array_ops.EXCHANGES.n == 0 and int(ov) == 0
    assert out.partitioning == part
    assert int(out.num_rows()) == NL


def test_entry_points_run_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        HPTMTContext()
    with pytest.raises(RuntimeError, match="CUDA"):
        tlocal()
    with pytest.raises(RuntimeError, match="CUDA"):
        DistTable.from_numpy_blocks({"k": LEFT["k"]}, [NL])
    assert HPTMTContext(device="cpu").device == torch.device("cpu")
    with pytest.raises(TypeError, match="process group"):
        HPTMTContext(device="cpu", group=object())


def test_later_slices_raise(monkeypatch):
    # the runtime services are ported: a planned collect runs under a
    # collector and explain(analyze=True) annotates it; the workflow
    # engine runs on a process group (tests/test_torch_group_services.py),
    # and one rank of a torchrun launch whose group is not formed yet
    # raises instead of running alone
    from repro_torch import telemetry
    from repro_torch.workflow import WorkflowEngine

    df = DataFrame.from_dict(LEFT, CPU1)
    lf = df.lazy().groupby(["g"], [("v", "sum")])
    rec = telemetry.Collector()
    lf.collect(telemetry=rec)
    assert rec.audits[-1]["consistent"] is True
    assert "audit: predicted=0 counted=0" in lf.explain(analyze=True)
    monkeypatch.setenv("WORLD_SIZE", "4")  # one rank of a torchrun group
    with pytest.raises(RuntimeError, match="process group"):
        WorkflowEngine()


def test_port_imports_neither_jax_nor_reference():
    code = ("import sys\n"
            "import repro_torch, repro_torch.core, repro_torch.dataframe\n"
            "import repro_torch.kernels.native\n"
            "import repro_torch.window\n"
            "import repro_torch.configs, repro_torch.models.params\n"
            "import repro_torch.serve.engine, repro_torch.launch.serve\n"
            "import repro_torch.io, repro_torch.resilience\n"
            "import repro_torch.spill, repro_torch.plan\n"
            "import repro_torch.core.dataflow\n"
            "for p in ('hash_partition', 'hash_join', 'segment_reduce',\n"
            "          'window_scan', 'flash_attention'):\n"
            "    for m in ('ref', 'kernel', 'ops'):\n"
            "        __import__(f'repro_torch.kernels.{p}.{m}')\n"
            "bad = [m for m in sys.modules if m == 'jax' or\n"
            "       m.startswith(('jax.', 'jaxlib')) or m == 'repro' or\n"
            "       m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "print('CLEAN')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0 and "CLEAN" in r.stdout, r.stderr[-2000:]


def test_table_conversions_vs_jax():
    from repro.core import DistTable as JDistTable, Table as JTable
    from repro_torch.core import Table
    from repro_torch.core.exchange import strip_hidden

    jdt = JDistTable.from_local(JTable.from_arrays(
        {k: jnp.asarray(v) for k, v in LEFT.items()}), local_context(),
        capacity=512)
    tdt = DistTable.from_local(Table.from_arrays(LEFT, device="cpu"), CPU1,
                               capacity=512)
    assert_blocks_equal(tdt, *jax_blocks(jdt))
    for got, ref in ((tdt.to_local(), jdt.to_local()),
                     (tdt.shard_table(0), jdt.shard_table(0))):
        assert got.capacity == ref.capacity
        assert int(got.num_rows) == int(ref.num_rows)
        for k, v in ref.to_numpy().items():
            np.testing.assert_array_equal(bits(got.to_numpy()[k]), bits(v))
    shards = [Table.from_arrays({k: v[i::4] for k, v in LEFT.items()},
                                device="cpu") for i in range(4)]
    t4 = DistTable.from_shard_tables(shards, CPU4, partitioning=(("k",), 4))
    assert t4.partitioning == (("k",), 4)
    assert [int(c) for c in t4.counts] == [NL // 4] * 4
    np.testing.assert_array_equal(t4.shard_table(2).to_numpy()["v"],
                                  LEFT["v"][2::4])
    with pytest.raises(ValueError, match="shard tables"):
        DistTable.from_shard_tables(shards[:3], CPU4)
    hidden = {"k": torch.zeros(2), "_h1": torch.zeros(2), "_h2": torch.zeros(2)}
    assert sorted(strip_hidden(hidden)) == ["k"]


def test_operator_registry_covers_the_slice():
    from repro_torch.core import Abstraction, list_operators

    names = {o.name for o in list_operators(Abstraction.TABLE)}
    for op in ("select", "project", "union", "difference", "intersect",
               "join", "aggregate", "groupby", "shuffle", "cartesian"):
        assert f"table.{op}" in names, op


def test_select_project_intersect_vs_jax():
    jl = JDataFrame.from_dict(LEFT, local_context())
    tl = DataFrame.from_dict(LEFT, CPU4, bucket_factor=2.0)
    ref = jl.select(lambda c: c["v"] > 0).project(["k", "g"])
    got = tl.select(lambda c: c["v"] > 0).project(["k", "g"])
    assert sorted(got.columns) == sorted(ref.columns)
    np.testing.assert_array_equal(np.sort(got.to_numpy()["k"]),
                                  np.sort(ref.to_numpy()["k"]))
    jr = JDataFrame.from_dict({"k": LEFT["k"][:100], "g": LEFT["g"][:100]},
                              local_context())
    tr = DataFrame.from_dict({"k": LEFT["k"][:100], "g": LEFT["g"][:100]},
                             CPU4, bucket_factor=2.0)
    ri, gi = ref.intersect(jr).to_numpy(), got.intersect(tr).to_numpy()
    assert sorted(zip(gi["k"], gi["g"])) == sorted(zip(ri["k"], ri["g"]))
