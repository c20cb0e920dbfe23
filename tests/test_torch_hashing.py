"""Parity of the port's hashing with the JAX package, bit for bit.

``_as_u32``/``hash_columns`` (``core/table.py``) and the plain version of
the hash-partition kernel against the JAX reference and the Pallas kernel
in interpret mode: destinations, histograms and both hash lanes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import table as jtable  # noqa: E402
from repro.kernels.hash_partition import kernel as jhk  # noqa: E402
from repro.kernels.hash_partition import ref as jhr  # noqa: E402
from repro_torch.core import table as ttable  # noqa: E402
from repro_torch.kernels import native  # noqa: E402
from repro_torch.kernels.hash_partition import kernel as thk  # noqa: E402
from repro_torch.kernels.hash_partition import ops as thops  # noqa: E402
from repro_torch.kernels.hash_partition import ref as thr  # noqa: E402

RNG = np.random.default_rng(11)
N = 777


def _column(kind):
    if kind == "int32":
        return RNG.integers(-2**31, 2**31 - 1, N, dtype=np.int64).astype(
            np.int32)
    if kind == "float32":
        x = RNG.normal(size=N).astype(np.float32)
        x[:8] = [0.0, -0.0, np.nan, np.inf, -np.inf, -np.nan, 1.0, -1.0]
        return x
    if kind == "bool":
        return RNG.integers(0, 2, N).astype(bool)
    if kind == "int16":
        return RNG.integers(-2**15, 2**15, N).astype(np.int16)
    if kind == "uint8":
        return RNG.integers(0, 256, N).astype(np.uint8)
    if kind == "int64":  # narrows to int32 in both packages
        return RNG.integers(-2**31, 2**31 - 1, N, dtype=np.int64)
    if kind == "float64":  # narrows to float32 in both packages
        return RNG.normal(size=N)
    raise ValueError(kind)


KINDS = ["int32", "float32", "bool", "int16", "uint8", "int64", "float64"]


def _i32(a):
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("kind", KINDS)
def test_as_u32_bit_exact(kind):
    x = _column(kind)
    ref = _i32(jtable._as_u32(jnp.asarray(x)))
    got = ttable._as_u32(ttable.as_tensor(x, "cpu")).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kinds", [["int32"], ["float32"], ["bool"],
                                   ["int16", "uint8"],
                                   ["int32", "float32", "bool"],
                                   ["float64", "int64"]])
def test_hash_columns_bit_exact(kinds):
    cols = [_column(k) for k in kinds]
    rh1, rh2 = jtable.hash_columns([jnp.asarray(c) for c in cols])
    th1, th2 = ttable.hash_columns([ttable.as_tensor(c, "cpu") for c in cols])
    np.testing.assert_array_equal(th1.numpy(), _i32(rh1))
    np.testing.assert_array_equal(th2.numpy(), _i32(rh2))


def test_narrowing_matches_jax_asarray():
    for kind in ("int64", "float64"):
        x = _column(kind)
        assert ttable.as_tensor(x, "cpu").numpy().dtype == \
            np.asarray(jnp.asarray(x)).dtype


@pytest.mark.parametrize("n_parts", [1, 3, 4, 16])
def test_hash_partition_plain_vs_jax_ref_and_pallas(n_parts):
    cols = [_column("int32"), _column("float32")]
    valid = RNG.random(N) < 0.9
    jcols = [jnp.asarray(c) for c in cols]
    rd, rhist, rh1, rh2 = jhr.hash_partition_full(jcols, n_parts,
                                                  jnp.asarray(valid))
    keys = jnp.stack([jtable._as_u32(c) for c in jcols], axis=1)
    pd, phist, ph1, ph2 = jhk.hash_partition_pallas(
        keys, jnp.asarray(valid), n_parts, interpret=True,
        return_hashes=True)

    tkeys = torch.stack([ttable._as_u32(ttable.as_tensor(c, "cpu"))
                         for c in cols], dim=1)
    td, thist, th1, th2 = thr.hash_partition_lanes(
        tkeys, torch.from_numpy(valid), n_parts, return_hashes=True)
    for ref in ((rd, rhist, rh1, rh2), (pd, phist, ph1, ph2)):
        np.testing.assert_array_equal(td.numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(thist.numpy(), np.asarray(ref[1]))
        np.testing.assert_array_equal(th1.numpy(), _i32(ref[2]))
        np.testing.assert_array_equal(th2.numpy(), _i32(ref[3]))
    assert int(thist.sum()) == int(valid.sum())


def test_hash_partition_ops_cpu_dispatch_without_hashes():
    x = ttable.as_tensor(_column("int32"), "cpu")
    valid = torch.from_numpy(RNG.random(N) < 0.5)
    dest, hist = thops.hash_partition([x], 4, valid)
    rd, rhist = jhr.hash_partition([jnp.asarray(x.numpy())], 4,
                                   jnp.asarray(valid.numpy()))
    np.testing.assert_array_equal(dest.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(rhist))


def test_no_silent_fallback_between_kernel_and_plain_version():
    x = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        native.on_cuda(x)
    with pytest.raises(ValueError, match="CUDA"):
        thk.hash_partition_cuda(torch.zeros((8, 1), dtype=torch.int32),
                                torch.ones(8, dtype=torch.bool), 4)
