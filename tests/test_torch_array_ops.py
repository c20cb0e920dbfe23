"""Paper Table I (``repro_torch.core.array_ops``) and the MDS composition
(``repro_torch.apps.mds``) against the JAX package on the CPU.

Every global-view operator and every ``spmd_*`` function runs on the
same numpy inputs in both packages — float32 and int32, one row a shard
(``(4, 8)``) and more rows than shards (``(16, 8)``, where the global
``allreduce``/``broadcast``/``reduce`` read only each block's first row,
as the reference's do) — for every ``root`` and ``op``, on 1 shard (JAX
in process) and on 4 (the port's virtual shards against JAX on 4 host
devices, every 4-shard case in ONE subprocess, each input's cases in one
jitted program).  Data movement, min/max and integers must agree bit for
bit; float sums, means and products to ``TOL`` (1e-6) of the largest
magnitude.  ``EXCHANGES`` counts exactly one exchange for ``alltoall`` and
``spmd_alltoall`` and none for the rest, as the reference's jaxpr has one
``all_to_all`` for either.

MDS (n = 24 and 30, so that the 4-shard δ pads): the curated points and
ids bit for bit, δ, one Guttman step from the same start on the same δ,
and the 30-iteration stress path and embedding from JAX's start
(``jax.random.normal``, handed to the port through a monkeypatched
``initial_embedding``), each to the tolerance stated beside it; then the
reference's own ``test_mds_composition`` criteria on the port's start.
The reference's 4-shard ``sort_values`` overflows at its default send
buckets (the ids arrive sorted; ROADMAP Queue 3), so its 4-shard pipeline
runs here with ``bucket_factor=4``, the port's setting.
"""
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import bits, run_jax_4way  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import HPTMTContext as JContext  # noqa: E402
from repro.core import array_ops as JA  # noqa: E402
from repro.core import local_context, make_mesh  # noqa: E402
from repro.core.report import OverflowError as JOverflowError  # noqa: E402
from repro_torch.apps import mds  # noqa: E402
from repro_torch.core import Abstraction, HPTMTContext  # noqa: E402
from repro_torch.core import array_ops, list_operators  # noqa: E402
from repro_torch.core.report import OverflowError  # noqa: E402

TOL = 1e-6
REDUCE_OPS = ("sum", "max", "min", "mean")
ALL_OPS = REDUCE_OPS + ("prod",)
ROOTS = range(4)
NAMES = ("float32_S", "int32_S", "float32_N", "int32_N")
CPU1 = HPTMTContext(n_shards=1, device="cpu")
CPU4 = HPTMTContext(n_shards=4, device="cpu")
MDS_N = (24, 30)
MDS_ITERS = 30


def _input(name):
    dtype, rows = name.split("_")
    rng = np.random.default_rng(len(name) + (rows == "N"))
    shape = (4 if rows == "S" else 16, 8)
    if dtype == "int32":
        return rng.integers(-3, 4, shape).astype(np.int32)
    return rng.normal(size=shape).astype(np.float32)


INPUTS = {name: _input(name) for name in NAMES}


def perms(n):
    return [[(s, (s + 1) % n) for s in range(n)],
            [(s, s - 1) for s in range(1, n, 2)]]


# ---------------------------------------------------------------------------
# the cases, shared by both packages: name → thunk of one call
# ---------------------------------------------------------------------------
def global_cases(A, ctx, x, n):
    """Every global-view call on ``x`` (``A`` is either package's
    ``array_ops``)."""
    c = {f"allreduce/{op}": functools.partial(A.allreduce, x, ctx=ctx, op=op)
         for op in ALL_OPS}
    c["allgather"] = functools.partial(A.allgather, x, ctx=ctx)
    if (x.shape[0] // n) % n == 0:
        c["alltoall"] = functools.partial(A.alltoall, x, ctx=ctx)
    c["reduce_scatter"] = functools.partial(A.reduce_scatter, x, ctx=ctx)
    for r in ROOTS:
        for name in ("broadcast", "gather", "scatter"):
            c[f"{name}/{r}"] = functools.partial(getattr(A, name), x,
                                                 ctx=ctx, root=r)
        for op in REDUCE_OPS:
            c[f"reduce/{r}/{op}"] = functools.partial(A.reduce, x, ctx=ctx,
                                                      root=r, op=op)
    return c


def spmd_cases(call, block_shape, n):
    """Every ``spmd_*`` call on shard blocks of ``block_shape``; ``call(name,
    **kw)`` runs ``spmd_<name>`` in either package."""
    c = {f"allreduce/{op}": functools.partial(call, "allreduce", op=op)
         for op in ALL_OPS}
    for tiled in (True, False):
        for axis in (0, 1):
            c[f"allgather/{tiled}/{axis}"] = functools.partial(
                call, "allgather", tiled=tiled, gather_axis=axis)
    for sa in (0, 1):
        if block_shape[sa] % n == 0:
            for ca in (0, 1):
                c[f"alltoall/{sa}/{ca}"] = functools.partial(
                    call, "alltoall", split_axis=sa, concat_axis=ca)
            c[f"reduce_scatter/{sa}"] = functools.partial(
                call, "reduce_scatter", scatter_axis=sa)
    for r in range(n):
        for name in ("broadcast", "gather"):
            c[f"{name}/{r}"] = functools.partial(call, name, root=r)
        if block_shape[0] % n == 0:
            c[f"scatter/{r}"] = functools.partial(call, "scatter", root=r)
        for op in ALL_OPS:
            c[f"reduce/{r}/{op}"] = functools.partial(call, "reduce", root=r,
                                                      op=op)
    for i, perm in enumerate(perms(n)):
        c[f"ppermute/{i}"] = functools.partial(call, "ppermute", perm=perm)
    return c


def jax_global(ctx, x, n):
    return {k: f() for k, f in global_cases(JA, ctx, x, n).items()}


def jax_spmd(ctx, x, n):
    from jax.sharding import PartitionSpec as P
    ax = ctx.data_axis

    def body(v):
        def call(name, **kw):
            return getattr(JA, "spmd_" + name)(v, ax, **kw)
        return {k: f()[None]
                for k, f in spmd_cases(call, v.shape, n).items()}

    return ctx.shard_map(body, in_specs=P(ax), out_specs=P(ax))(x)


class _Jitted:
    """The reference frame's table operators, each call one ``jax.jit``
    program (eager 4-device ``shard_map`` took ~20 s a sort)."""

    def __getattr__(self, name):
        from repro.core import table_ops
        fn = getattr(table_ops, name)
        return lambda t, *a, **kw: jax.jit(lambda t: fn(t, *a, **kw))(t)


def jax_mds(ctx, n, iters):
    """The reference's ``mds_pipeline`` with its curated points, ids, δ and
    one-step SMACOF captured, the send buckets of its sort widened to a
    shard (``bucket_factor=n_shards``), and the traced all-to-all count of
    its table side."""
    import repro.apps.mds as M
    import repro.dataframe.frame as JF
    from repro.core import table_ops

    got = {}
    real = (JF.table_ops, JF.DataFrame.to_jax, JF.DataFrame.select,
            JF.DataFrame.sort_values, M.smacof)

    def to_jax(self, cols):
        got["points"] = real[1](self, cols)
        return got["points"]

    def select(self, pred):
        got["raw"] = self.table
        return real[2](self, pred)

    def sort_values(self, by, **kw):
        out = real[3](self, by, bucket_factor=float(ctx.n_shards), **kw)
        got["ids"] = out.to_numpy()["id"]
        return out

    def smacof(delta, dim, its, seed):
        got["delta"] = delta
        return real[4](delta, dim, its, seed)

    JF.table_ops = _Jitted()
    JF.DataFrame.to_jax, JF.DataFrame.select = to_jax, select
    JF.DataFrame.sort_values, M.smacof = sort_values, smacof
    try:
        path, x = M.mds_pipeline(n, 2, iters, ctx, seed=0)
    finally:
        (JF.table_ops, JF.DataFrame.to_jax, JF.DataFrame.select,
         JF.DataFrame.sort_values, M.smacof) = real
    path1, x1 = M.smacof(got["delta"], 2, 1, 0)
    out = {"path": np.asarray(path), "x": np.asarray(x),
           "path1": np.asarray(path1), "x1": np.asarray(x1),
           **{k: np.asarray(got[k]) for k in ("points", "ids", "delta")}}
    if ctx.is_distributed:
        chain = lambda t: table_ops.orderby(  # noqa: E731
            table_ops.select(t, lambda c: c["quality"] >= 0.5, ctx=ctx),
            ["id"], ctx=ctx, bucket_factor=float(ctx.n_shards))
        out["a2a"] = np.asarray(str(jax.make_jaxpr(chain)(got["raw"]))
                                .count("all_to_all"))
        JF.table_ops = _Jitted()
        try:  # the reference's own sort buckets
            M.mds_pipeline(n, 2, 1, ctx, seed=0)
            out["default_overflow"] = np.asarray(-1)
        except JOverflowError as e:
            out["default_overflow"] = np.asarray(int(str(e).split()[1]))
        finally:
            JF.table_ops = real[0]
    return out


@pytest.fixture(scope="module")
def jax4():
    """Every 4-shard case, by the JAX package on 4 host devices."""
    return run_jax_4way(f"""
        sys.path.insert(0, {os.path.dirname(__file__)!r})
        from test_torch_array_ops import (global_cases, jax_global, jax_mds,
                                          jax_spmd)
        from repro.core import array_ops as A
        for name in {NAMES!r}:
            x = jnp.asarray(inp[name])
            for k, v in jax.jit(lambda x: jax_global(ctx, x, 4))(x).items():
                out[f"g/{{name}}/{{k}}"] = np.asarray(v)
            for k, v in jax.jit(lambda x: jax_spmd(ctx, x, 4))(x).items():
                out[f"s/{{name}}/{{k}}"] = np.asarray(v)
        x = jnp.asarray(inp["float32_N"])
        for k in global_cases(A, ctx, x, 4):
            out["a2a/" + k] = np.asarray(a2a_count(
                lambda x: global_cases(A, ctx, x, 4)[k](), x))
        for n in {MDS_N!r}:
            for k, v in jax_mds(ctx, n, {MDS_ITERS}).items():
                out[f"mds/{{n}}/{{k}}"] = v
    """, INPUTS)


@functools.lru_cache(maxsize=None)
def jax1(name):
    """The 1-shard JAX results of input ``name``: global (local context)
    and in-SPMD (a one-device mesh)."""
    x = jnp.asarray(INPUTS[name])
    res = {f"g/{k}": np.asarray(v)
           for k, v in jax_global(local_context(), x, 1).items()}
    ctx = JContext(mesh=make_mesh((1,), ("data",)))
    res.update({f"s/{k}": np.asarray(v) for k, v in jax.jit(
        lambda x: jax_spmd(ctx, x, 1))(x).items()})
    return res


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------
def _run(thunks, stack=False):
    """Each thunk's result and its exchange count."""
    out = {}
    for k, f in thunks.items():
        array_ops.EXCHANGES.reset()
        res = f()
        out[k] = (torch.stack(res) if stack else res).numpy(), \
            array_ops.EXCHANGES.n
    return out


def port_global(name, ctx):
    x = torch.from_numpy(INPUTS[name])
    return _run(global_cases(array_ops, ctx, x, ctx.n_shards))


def port_spmd(name, n):
    blocks = list(torch.from_numpy(INPUTS[name]).tensor_split(n))

    def call(fn, **kw):
        return getattr(array_ops, "spmd_" + fn)(blocks, **kw)

    return _run(spmd_cases(call, blocks[0].shape, n), stack=True)


def _fuzzy(key, dtype):
    """Float sums, means and products: summation order may differ."""
    return dtype.kind == "f" and (
        key.startswith("reduce_scatter")
        or key.split("/")[-1] in ("sum", "mean", "prod"))


def assert_same(got, exp, key):
    assert got.shape == exp.shape, (key, got.shape, exp.shape)
    assert got.dtype == exp.dtype, (key, got.dtype, exp.dtype)
    if _fuzzy(key, exp.dtype):
        scale = max(float(np.abs(exp).max()), 1.0)
        np.testing.assert_allclose(got, exp, rtol=TOL, atol=TOL * scale,
                                   err_msg=key)
    else:
        np.testing.assert_array_equal(bits(got), bits(exp), err_msg=key)


def _check(port, ref, prefix, local=False):
    """Every case equal to the reference's; one exchange for an
    ``alltoall`` — none for the global one on one shard (``local``), which
    returns its input, as the reference's does."""
    assert sorted(port) == sorted(k[len(prefix):] for k in ref
                                  if k.startswith(prefix)), prefix
    for k, (got, ex) in port.items():
        assert_same(got, ref[prefix + k], prefix + k)
        assert ex == int(k.startswith("alltoall") and not local), (k, ex)


@pytest.mark.parametrize("name", NAMES)
def test_global_ops_single_shard_vs_jax(name):
    _check(port_global(name, CPU1), jax1(name), "g/", local=True)


@pytest.mark.parametrize("name", NAMES)
def test_spmd_single_shard_vs_jax(name):
    _check(port_spmd(name, 1), jax1(name), "s/")


@pytest.mark.parametrize("name", NAMES)
def test_global_ops_4_shards_vs_jax(jax4, name):
    _check(port_global(name, CPU4), jax4, f"g/{name}/")


@pytest.mark.parametrize("name", NAMES)
def test_spmd_4_shards_vs_jax(jax4, name):
    _check(port_spmd(name, 4), jax4, f"s/{name}/")


def test_only_alltoall_is_an_exchange_as_in_the_jaxpr(jax4):
    counts = {k[4:]: int(v) for k, v in jax4.items() if k.startswith("a2a/")}
    assert counts == {k: int(k == "alltoall") for k in counts}
    assert array_ops.axis_size([torch.zeros(1)] * 4) == 4


def test_reference_quirks_copied(jax4):
    """The ``v[0]`` reads, one-shard forms and dtypes the port copies."""
    x = INPUTS["float32_N"]
    g = port_global("float32_N", CPU4)
    heads = x[::4]  # the first row of each shard's 4-row block
    np.testing.assert_array_equal(g["allreduce/max"][0], heads.max(0))
    np.testing.assert_array_equal(g["broadcast/2"][0], heads[2])
    red = g["reduce/1/min"][0]
    assert red.shape == (4, 8) and not red[[0, 2, 3]].any()
    np.testing.assert_array_equal(red[1], heads.min(0))
    gat = g["gather/3"][0]
    assert gat.shape == (4, 16, 8) and not gat[:3].any()
    np.testing.assert_allclose(g["reduce_scatter"][0], 4 * x, rtol=TOL)
    one = port_global("float32_N", CPU1)
    np.testing.assert_array_equal(one["broadcast/3"][0], x[3])
    np.testing.assert_array_equal(one["gather/0"][0], x[None])
    # the mean of an integer input is float32 in both packages
    for key in ("allreduce/mean", "reduce/0/mean"):
        for res, ref in ((port_global("int32_N", CPU4), jax4["g/int32_N/"
                                                             + key]),
                         (port_global("int32_N", CPU1),
                          jax1("int32_N")["g/" + key])):
            assert res[key][0].dtype == ref.dtype == np.float32, key


def test_unsupported_ops_raise_as_reference():
    x = torch.from_numpy(INPUTS["float32_N"])
    with pytest.raises(KeyError):
        JA.reduce(jnp.asarray(INPUTS["float32_N"]), ctx=local_context(),
                  op="prod")
    with pytest.raises(KeyError):
        array_ops.reduce(x, ctx=CPU1, op="prod")
    with pytest.raises(NotImplementedError, match="sum only"):
        JA.spmd_reduce_scatter(jnp.ones(4), "data", op="max")
    with pytest.raises(NotImplementedError, match="sum only"):
        array_ops.spmd_reduce_scatter([x] * 4, op="max")
    with pytest.raises(ValueError, match="does not split"):
        array_ops.alltoall(x[:4], ctx=CPU4)


def test_registry_holds_table_one():
    names = {o.name for o in list_operators(Abstraction.ARRAY)}
    assert names == {f"array.{op}" for op in (
        "allreduce", "allgather", "alltoall", "reduce_scatter", "broadcast",
        "gather", "scatter", "reduce")}


# ---------------------------------------------------------------------------
# MDS
# ---------------------------------------------------------------------------
# Tolerances, each about 10x the largest reading of the four cases (n =
# 24, 30 on 1 and 4 shards; relative to the largest magnitude):
#: δ off the diagonal (read 1.0e-7); its diagonal, the clamp's sqrt(1e-12)
#: in both packages (read 0, absolute)
DELTA_TOL, DELTA_DIAG_TOL = 1e-6, 1e-6
#: one Guttman step on the same δ from the same start: the first stress and
#: x (read 5.1e-7 and 5.9e-7)
STEP_TOL = 5e-6
#: 30 iterations from JAX's start: the stress path (read 5.1e-7) and the
#: embedding (read 1.1e-6)
PATH_TOL, X_TOL = 5e-6, 1e-5


def _oracle(n):
    """The curated ids and points by numpy alone."""
    cols = mds.point_columns(n, 0)
    keep = cols["quality"] >= 0.5
    return (cols["id"][keep],
            np.stack([cols[f][keep] for f in mds.FEATURES], axis=1))


def _jax_start(n):
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (n, 2)) * 0.1)


@functools.lru_cache(maxsize=None)
def jax_mds1(n):
    return jax_mds(local_context(), n, MDS_ITERS)


def _ref(jax4, n, shards):
    if shards == 1:
        return jax_mds1(n)
    pre = f"mds/{n}/"
    return {k[len(pre):]: v for k, v in jax4.items() if k.startswith(pre)}


def _close(got, exp, tol, what):
    scale = float(np.abs(exp).max())
    err = float(np.abs(np.asarray(got, np.float64) - exp).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("n", MDS_N)
def test_mds_table_side_and_delta_vs_jax(jax4, n, shards):
    ref = _ref(jax4, n, shards)
    ctx = CPU1 if shards == 1 else CPU4
    array_ops.EXCHANGES.reset()
    curated = mds.curated_table(n, ctx, 0)
    assert array_ops.EXCHANGES.n == (0 if shards == 1 else int(ref["a2a"]))
    ids, pts = _oracle(n)
    np.testing.assert_array_equal(curated.to_numpy()["id"], ref["ids"])
    np.testing.assert_array_equal(ref["ids"], ids)
    points = curated.to_torch(mds.FEATURES)
    np.testing.assert_array_equal(bits(points.numpy()), bits(ref["points"]))
    np.testing.assert_array_equal(bits(points.numpy()), bits(pts))
    delta = mds.distance_matrix(points, ctx).numpy()
    assert delta.shape == (n, n)
    off = ~np.eye(n, dtype=bool)
    _close(delta[off], ref["delta"][off], DELTA_TOL, "delta")
    assert np.abs(np.diag(delta) - np.diag(ref["delta"])).max() \
        <= DELTA_DIAG_TOL
    if shards == 4:  # the 4-shard δ against the port's own 1-shard δ
        one = mds.distance_matrix(points, CPU1).numpy()
        _close(delta[off], one[off], DELTA_TOL, "delta 4 vs 1 shard")


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("n", MDS_N)
def test_mds_smacof_vs_jax_from_its_start(jax4, monkeypatch, n, shards):
    ref = _ref(jax4, n, shards)
    ctx = CPU1 if shards == 1 else CPU4
    start = torch.from_numpy(_jax_start(n))
    monkeypatch.setattr(mds, "initial_embedding",
                        lambda n_, dim, seed, device: start.clone())
    # one Guttman step on JAX's δ from JAX's start
    path1, x1 = mds.smacof(torch.tensor(ref["delta"]), 2, 1, 0)
    _close(path1, ref["path1"], STEP_TOL, "first stress")
    _close(x1.numpy(), ref["x1"], STEP_TOL, "one Guttman step")
    # the whole pipeline, 30 iterations
    path, x = mds.mds_pipeline(n, 2, MDS_ITERS, ctx, seed=0)
    assert len(path) == MDS_ITERS and x.shape == (n, 2)
    _close(path, ref["path"], PATH_TOL, "stress path")
    _close(x.numpy(), ref["x"], X_TOL, "embedding")


@pytest.mark.parametrize("shards", [1, 4])
def test_mds_composition(shards):
    """The reference's system test (``tests/test_system.py``) on the
    port's own start."""
    ctx = CPU1 if shards == 1 else CPU4
    stress_path, embedding = mds.mds_pipeline(n_points=24, dim=2, iters=30,
                                              ctx=ctx, seed=0)
    assert embedding.shape == (24, 2)
    assert stress_path[-1] < stress_path[0] * 0.8, stress_path[::10]
    assert np.all(np.isfinite(embedding.numpy()))
    # SMACOF majorizes: the stress never rises beyond rounding
    assert all(b <= a * (1 + 1e-6) for a, b in zip(stress_path,
                                                   stress_path[1:]))


@pytest.mark.parametrize("n", MDS_N)
def test_reference_sort_buckets_overflow_alike(jax4, n):
    """At the reference's default send buckets both packages' 4-shard
    table side overflows by the same rows."""
    df = mds.DataFrame.from_dict(mds.point_columns(n, 0), CPU4)
    with pytest.raises(OverflowError) as e:
        df.select(lambda c: c["quality"] >= 0.5).sort_values("id")
    want = int(jax4[f"mds/{n}/default_overflow"])
    assert want > 0 and f"{want} rows overflowed" in str(e.value)


def test_initial_embedding_is_seeded():
    a = mds.initial_embedding(16, 3, 5, torch.device("cpu"))
    b = mds.initial_embedding(16, 3, 5, torch.device("cpu"))
    assert a.shape == (16, 3) and torch.equal(a, b)
    assert not torch.equal(a, mds.initial_embedding(16, 3, 6,
                                                    torch.device("cpu")))
