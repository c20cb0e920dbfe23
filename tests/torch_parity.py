"""Shared helpers of the ``tests/test_torch_*.py`` parity tests.

The PyTorch port (``repro_torch``) is held against the JAX package
(``repro``): the same numpy inputs go through both, and every output is
compared.  Single-shard JAX runs happen in the test process (one CPU
device); 4-shard JAX runs need 4 host devices, so each test module
computes all its 4-shard cases in ONE subprocess (:func:`run_jax_4way`)
that returns them as an ``.npz``.  The port runs its 4 virtual shards in
process on the CPU.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

try:
    import torch
except ImportError:  # the port's test modules skip without torch
    torch = None
else:
    # one intra-op thread a test process: the suite runs several workers
    # on the machine's cores beside multi-threaded JAX subprocesses, and
    # PyTorch's default pool (one thread a core, per process) oversubscribes
    # them — a 64K-element product took 11.8 ms on 8 threads of a loaded
    # 8-core machine and 0.07 ms on one
    torch.set_num_threads(1)

_PRELUDE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.core import DistTable, HPTMTContext, Table, make_mesh, table_ops
ctx = HPTMTContext(mesh=make_mesh((4,), ("data",)))
inp = dict(np.load(sys.argv[1]))
out = {}

def table(prefix, capacity=None):
    cols = {k.split("/", 1)[1]: jnp.asarray(v) for k, v in inp.items()
            if k.startswith(prefix + "/")}
    return DistTable.from_local(Table.from_arrays(cols), ctx,
                                capacity=capacity)

def save(name, dt, ov=None):
    for k, v in dt.columns.items():
        out[f"{name}/col/{k}"] = np.asarray(v)
    out[f"{name}/counts"] = np.asarray(dt.counts)
    out[f"{name}/part"] = np.asarray(repr(dt.partitioning))
    if ov is not None:
        out[f"{name}/ov"] = np.asarray(ov)

def run(fn, *args):
    # eager shard_map dispatches primitive by primitive; one jit of the
    # whole operator compiles once
    return jax.jit(fn)(*args)

def a2a_count(fn, *args):
    return str(jax.make_jaxpr(fn)(*args)).count("all_to_all")
"""


def run_jax_4way(script: str, inputs: dict, timeout: int = 600,
                 devices: int = 4) -> dict:
    """Run ``script`` under the JAX package on 4 host devices (or
    ``devices``, 4 or more).

    The script sees ``inp`` (the ``inputs`` arrays), the helpers
    ``table(prefix)`` / ``save(name, dt, ov)`` / ``run(fn, *args)`` (jit
    and call) / ``a2a_count(fn, *args)``
    and a 4-shard ``ctx`` (on the first 4 devices), and fills the ``out``
    dict, which comes back.
    """
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + f" --xla_force_host_platform_device_count={devices}")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        np.savez(src, **inputs)
        code = (_PRELUDE + textwrap.dedent(script)
                + f"\nnp.savez({dst!r}, **out)\n")
        r = subprocess.run([sys.executable, "-c", code, src],
                           capture_output=True, text=True, timeout=timeout,
                           env=env)
        assert r.returncode == 0, f"stderr:\n{r.stderr[-4000:]}"
        with np.load(dst) as f:
            return dict(f)


def jax_result(res: dict, name: str):
    """``(columns, counts, partitioning repr, overflow)`` saved under
    ``name`` by the 4-shard script."""
    pre = f"{name}/col/"
    cols = {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}
    ov = res.get(f"{name}/ov")
    return (cols, res[f"{name}/counts"], str(res[f"{name}/part"]),
            None if ov is None else int(ov))


def jax_blocks(dt):
    """A JAX ``DistTable`` as ``(columns, counts, partitioning repr)``."""
    return ({k: np.asarray(v) for k, v in dt.columns.items()},
            np.asarray(dt.counts), repr(dt.partitioning))


def bits(a: np.ndarray) -> np.ndarray:
    """Bit view for exact comparison (NaN-safe, ±0.0-distinguishing)."""
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return a.view({2: np.uint16, 4: np.uint32, 8: np.uint64}[a.itemsize])
    return a


def assert_blocks_equal(port_dt, cols, counts, part=None, msg=""):
    """The port's DistTable equals the reference's arrays bit for bit:
    every column block (padding included), the counts and the
    partitioning."""
    pcols, pcounts, ppart = port_dt.to_numpy_blocks()
    np.testing.assert_array_equal(pcounts, counts, err_msg=f"{msg} counts")
    assert sorted(pcols) == sorted(cols), (msg, sorted(pcols), sorted(cols))
    for k in cols:
        assert pcols[k].dtype == cols[k].dtype, (msg, k, pcols[k].dtype,
                                                 cols[k].dtype)
        np.testing.assert_array_equal(bits(pcols[k]), bits(cols[k]),
                                      err_msg=f"{msg} column {k}")
    if part is not None:
        assert repr(ppart) == part, (msg, ppart, part)


def valid_rows(cols, counts):
    """Valid rows of global ``(n_shards * cap, ...)`` blocks, shard order."""
    p = len(counts)
    out = {}
    for k, v in cols.items():
        blocks = np.asarray(v).reshape((p, -1) + np.shape(v)[1:])
        out[k] = np.concatenate([blocks[i, :counts[i]] for i in range(p)])
    return out


def canon_rows(got):
    """Canonical bitwise row multiset: every column viewed as bits, rows
    lexsorted."""
    names = sorted(got)
    cols = [bits(got[k]).astype(np.int64) for k in names]
    order = np.lexsort(tuple(reversed(cols)))
    return {k: c[order] for k, c in zip(names, cols)}


def assert_rows_equal(a, b, msg=""):
    ca, cb = canon_rows(a), canon_rows(b)
    assert sorted(ca) == sorted(cb), (msg, sorted(ca), sorted(cb))
    for k in ca:
        np.testing.assert_array_equal(ca[k], cb[k], err_msg=f"{msg}:{k}")


def assert_sums_close(got, ref, values_abs_sum, msg=""):
    """Float sums to ``|got - ref| <= 1e-5 * sum|v|`` per group (NaN must
    match NaN).  The port and the reference add in different orders (a
    sort-based float64 plain version, scatter or atomics), so bit equality
    is not expected."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=msg)
    tol = 1e-5 * np.asarray(values_abs_sum, np.float64) + 1e-30
    err = np.abs(got - ref)
    bad = ~nan & ~(err <= np.broadcast_to(tol, err.shape))
    assert not bad.any(), (msg, got[bad][:5], ref[bad][:5])
