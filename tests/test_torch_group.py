"""The table path on a ``torch.distributed`` process group.

Every chain of ``tests/torch_group_cases.py`` — hash shuffle, hash and
sort join, the groupby paths (hash, sort, combiner), ``from_numpy_blocks``
and the packed exchange beside its reference, the set operators,
the ordered chain (sort, rolling and cumulative windows, rank, topk,
quantiles), cartesian, the eight Table I operators, ``spmd_ppermute``,
MDS at 24 points, the TSet methods the data pipeline uses and the
training data pipeline — runs on ``gloo`` groups of CPU ranks at
``(world, n_shards)`` = (4, 4), (2, 4) and (1, 4), one ``run_ranks`` call
each, and is held bit for bit against the port's virtual 4-shard run:
blocks (padding included), counts, partitioning and overflow.  The
training launcher runs there too, as a ``world x 1`` mesh.  The join →
groupby chain and the ordered chain are also held against the JAX
package's 4-device run (one subprocess for the file), as the virtual
port is in ``test_torch_frame.py`` and ``test_torch_window.py``.
"""
from __future__ import annotations

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_group_cases as C  # noqa: E402
from torch_parity import (assert_sums_close, bits, jax_result,  # noqa: E402
                          run_jax_4way, valid_rows)
from repro_torch.core import HPTMTContext  # noqa: E402
from repro_torch.kernels import native  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402

LAYOUTS = [(4, 4), (2, 4), (1, 4)]
TIMEOUT_S = 120
#: sorts every process runs on replicated data (each range exchange's
#: splitter sort; the approximate quantile's sample sort): counted once
#: a process, so once a rank on a group and once in the virtual run
REPLICATED_SORTS = {"ordered": 4, "mds": 1, "training_data": 2}


def leaves(tree, prefix=""):
    """``path → leaf`` of a nested dict of results."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def assert_same(got, want, msg):
    """Bit for bit: arrays by dtype, shape and bits; the rest by ``==``."""
    if isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape, msg
        np.testing.assert_array_equal(bits(got), bits(want), err_msg=msg)
    else:
        assert got == want, (msg, got, want)


@pytest.fixture(scope="module")
def virtual():
    return C.run_cases(HPTMTContext(n_shards=4, device="cpu"))


@pytest.fixture(scope="module", params=LAYOUTS,
                ids=[f"world{w}-shards{n}" for w, n in LAYOUTS])
def group(request):
    world, n_shards = request.param
    return run_ranks(C.rank_cases, world, "gloo", "cpu", n_shards=n_shards,
                     timeout_s=TIMEOUT_S)


@pytest.fixture(scope="module")
def jax4():
    """The join → groupby chain and the ordered chain on 4 devices, by the
    JAX package under jit."""
    inputs = {f"l/{k}": v for k, v in C.LEFT.items()}
    inputs.update({f"r/{k}": v for k, v in C.RIGHT.items()})
    inputs.update({f"e/{k}": v for k, v in C.EVENTS.items()})
    return run_jax_4way(f"""
        l, r = table("l", {C.LEFT_CAP}), table("r", {C.RIGHT_CAP})
        def chain(l, r):
            j, o1 = table_ops.join(l, r, ["k"], ctx=ctx)
            gb, o2 = table_ops.groupby_aggregate(
                j, ["g"], {C.GB_AGGS!r}, ctx=ctx, out_capacity=32)
            gk, o3 = table_ops.groupby_aggregate(j, ["k"], [("v", "sum")],
                                                 ctx=ctx)
            a = table_ops.project(j, ["k", "g"], ctx=ctx)
            b = table_ops.project(l, ["k", "g"], ctx=ctx)
            u, o4 = table_ops.union(a, b, ctx=ctx)
            return (j, gb, gk, u), (o1, o2, o3, o4)
        tables, ovs = run(chain, l, r)
        for name, t, o in zip(("j", "gb", "gk", "u"), tables, ovs):
            save(name, t, o)
        e = table("e", {C.EV_CAP})
        srt, o = run(lambda x: table_ops.orderby(x, ["g", "t"], ctx=ctx), e)
        save("sorted", srt, o)
        save("roll", *run(lambda x: table_ops.window_aggregate(
            x, ["g"], ["t"], {C.W_AGGS!r}, rows=8, ctx=ctx), srt))
        save("cum", *run(lambda x: table_ops.window_aggregate(
            x, ["g"], ["t"], {C.CUM_AGGS!r}, rows=None, ctx=ctx), srt))
        save("topk", run(lambda x: table_ops.topk(x, "v", {C.TOPK}, ctx=ctx),
                         srt))
        sv, _ = run(lambda x: table_ops.orderby(x, "v", ctx=ctx), srt)
        out["q_exact"] = np.asarray(run(lambda x: table_ops.quantile(
            x, "v", {C.QS!r}, ctx=ctx), sv))
    """, inputs)


# ---------------------------------------------------------------------------
# the group run against the virtual run
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chain", list(C.CHAINS))
def test_chain_bit_identical_to_virtual(group, virtual, chain):
    got = leaves(group[0]["results"][chain])
    want = leaves(virtual[0][chain])
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        assert_same(got[path], leaf, f"{chain}{path}")


def test_packed_exchange_equals_its_reference_on_a_group(group):
    """The packed single-collective exchange against the per-column
    reference over the group: the same valid rows and overflow."""
    res = group[0]["results"]["exchange"]
    np.testing.assert_array_equal(res["packed_valid"], res["reference_valid"])
    np.testing.assert_array_equal(res["packed_overflow"],
                                  res["reference_overflow"])
    assert res["packed_valid"].sum() == C.BLOCK_COUNTS.sum() \
        - res["packed_overflow"].sum()
    for k in C.LEFT:
        np.testing.assert_array_equal(bits(res[f"packed_{k}"]),
                                      bits(res[f"reference_{k}"]))


def test_every_rank_exchanges_and_sorts_like_the_virtual_run(group, virtual):
    """Each rank counts one exchange a shuffle, as the virtual run does.
    A sort of one shard's rows counts on the rank that holds the shard
    and a sort of replicated data on every rank, so the ranks' sorts sum
    to the virtual run's plus ``world - 1`` times the replicated ones."""
    vcounts = virtual[1]
    world = group[0]["world"]
    for name, (ex, sorts) in vcounts.items():
        for r in group:
            assert r["counts"][name][0] == ex, (name, r["rank"])
        total = sum(r["counts"][name][1] for r in group)
        assert total == sorts + (world - 1) * REPLICATED_SORTS.get(name, 0), \
            (name, [r["counts"][name][1] for r in group], sorts)
    assert vcounts["main"][0] == 5 and vcounts["ordered"][0] == 3


def test_each_rank_holds_its_own_shards(group):
    world = group[0]["world"]
    n_local = 4 // world
    for r in group:
        assert r["world"] == world and r["n_local"] == n_local
        assert r["local_shards"] == list(range(r["rank"] * n_local,
                                               (r["rank"] + 1) * n_local))
        assert r["block_shape"] == (n_local, C.LEFT_CAP)
        if world > 1:
            assert "does not split over a group" in r["bad_split"]
        else:
            assert r["bad_split"] == "accepted"


@pytest.mark.parametrize("name", C.REFUSED)
def test_features_outside_the_slice_refuse_a_group(group, name):
    for r in group:
        kind, msg = r["refusals"][name]
        assert kind == "NotImplementedError", (name, kind, msg)
        assert "ROADMAP Queue 1 item 11b" in msg, msg


def test_every_rank_gets_the_training_stream(group, virtual):
    """Every rank's curated stream and global batches are the virtual
    run's, bit for bit (the chain test holds rank 0's)."""
    want = virtual[0]["training_data"]
    for r in group:
        got = r["training_data"]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert_same(got[k], v, f"rank {r['rank']} {k}")


def test_train_launcher_runs_on_a_group(group):
    """``launch.train.main`` on a ``world x 1`` mesh of the group: every
    rank's losses the same, and within bf16 rounding of the one-card
    step's on the virtual ``world``-shard stream from the same seed."""
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptimizerConfig

    world = group[0]["world"]
    cfg = configs.reduced_config(configs.get_config("smollm-360m"))
    steps = len(group[0]["launcher"])
    tcfg = TS.TrainConfig(optimizer=OptimizerConfig(
        warmup_steps=max(steps // 20, 1), total_steps=steps))
    data = pipeline.make_training_data(
        cfg, HPTMTContext(n_shards=world, device="cpu"), batch=4, seq_len=32,
        ccfg=pipeline.CorpusConfig(vocab_size=cfg.vocab_size))
    state = TS.init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    step = TS.make_train_step(cfg, tcfg)
    want = []
    for _ in range(steps):
        state, m = step(state, next(data))
        want.append(float(m["loss"]))
    for r in group:
        assert r["launcher"] == group[0]["launcher"], r["rank"]
    np.testing.assert_allclose(group[0]["launcher"], want, rtol=2e-3)


# ---------------------------------------------------------------------------
# the group run against the JAX package's 4-device run
# ---------------------------------------------------------------------------
def _frame_vs_jax(res, jax4, name, sums_scale=None):
    cols, counts, part, ov = jax_result(jax4, name)
    assert ov in (None, 0)
    assert res["report"] == []
    np.testing.assert_array_equal(res["counts"], counts, err_msg=name)
    assert res["part"] == part, (name, res["part"], part)
    assert sorted(res["cols"]) == sorted(cols), name
    if sums_scale is None:
        for k in cols:
            assert res["cols"][k].dtype == cols[k].dtype, (name, k)
            np.testing.assert_array_equal(bits(res["cols"][k]), bits(cols[k]),
                                          err_msg=f"{name}:{k}")
        return
    got, ref = valid_rows(res["cols"], counts), valid_rows(cols, counts)
    n = np.maximum(ref.get("v_count", np.ones(1)), 1)
    for k in ref:
        if k.endswith(("_sum", "_mean")):
            # the plain segment sum adds in float64, the reference in
            # float32 (test_torch_frame.py's tolerance); |v| <= 5 here
            scale = 5.0 * (n if k != "v_mean" else 1.0) * sums_scale
            assert_sums_close(got[k], ref[k], scale, f"{name}:{k}")
        else:
            np.testing.assert_array_equal(bits(got[k]), bits(ref[k]),
                                          err_msg=f"{name}:{k}")


def test_main_chain_vs_jax(group, jax4):
    res = group[0]["results"]["main"]
    _frame_vs_jax(res["j"], jax4, "j")
    _frame_vs_jax(res["u"], jax4, "u")
    _frame_vs_jax(res["gb"], jax4, "gb", sums_scale=1)
    _frame_vs_jax(res["gk"], jax4, "gk", sums_scale=8)


def test_ordered_chain_vs_jax(group, jax4):
    res = group[0]["results"]["ordered"]
    for name in ("sorted", "roll", "cum", "topk"):
        _frame_vs_jax(res[name], jax4, name)
    np.testing.assert_array_equal(bits(res["q_exact"]),
                                  bits(jax4["q_exact"]))


# ---------------------------------------------------------------------------
# the launcher and the context
# ---------------------------------------------------------------------------
def test_a_failing_rank_fails_the_run_without_a_hang():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(C.failing_rank, 2, "gloo", "cpu", timeout_s=60)
    assert time.monotonic() - t0 < 60


def test_virtual_context_is_unchanged():
    ctx = HPTMTContext(n_shards=4, device="cpu")
    assert (ctx.group, ctx.world, ctx.rank, ctx.n_local) == (None, 1, 0, 4)
    assert list(ctx.local_shards) == [0, 1, 2, 3]


def test_kernel_launch_refuses_a_tensor_off_the_current_device(monkeypatch):
    """The C entry points launch on the current CUDA device: a tensor on
    another card raises before the launch."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    with pytest.raises(RuntimeError, match="current CUDA device is cuda:1"):
        native.stream(torch.device("cuda", 0))
