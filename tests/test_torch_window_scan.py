"""Parity of the port's windowed-scan plain version with the JAX package.

The port's ``kernels/window_scan/ref.py`` runs the reference's ladder step
for step, so it must be bit-identical to JAX's ``ref.windowed_scan`` and to
the Pallas kernel in interpret mode (which reuses that ladder), sums
included, and ``segmented_cumulative`` bit-identical to its reference.  A
window wider than half the rows (which the JAX package never sends to
Pallas) is held against a brute-force loop.  The CUDA kernel's own cases
are in ``tests/test_torch_kernels_cuda.py`` and run on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.window_scan import ops as jops  # noqa: E402
from repro.kernels.window_scan import ref as jref  # noqa: E402
from repro_torch.kernels.window_scan import kernel as tkernel  # noqa: E402
from repro_torch.kernels.window_scan import ops as tops  # noqa: E402
from repro_torch.kernels.window_scan import ref as tref  # noqa: E402
from torch_parity import bits  # noqa: E402

RNG = np.random.default_rng(31)
N, LANES = 1500, 3
FLAGS = RNG.random(N) < 0.03
FLAGS[0] = True
SEG = np.maximum.accumulate(np.where(FLAGS, np.arange(N), 0)).astype(np.int32)
VALS = RNG.normal(size=(N, LANES)).astype(np.float32)
VALS[RNG.random((N, LANES)) < 0.005] = np.nan
VALS[10:14, 0] = [-0.0, 0.0, 0.0, -0.0]  # min/max order -0.0 below +0.0


def _port(fn, *args):
    return fn(torch.from_numpy(VALS), torch.from_numpy(SEG), *args).numpy()


@pytest.mark.parametrize("window", [1, 7, 64, 512])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_windowed_scan_bit_identical_to_jax_and_pallas(window, op):
    got = _port(tref.windowed_scan, window, op)
    ref = np.asarray(jref.windowed_scan(jnp.asarray(VALS), jnp.asarray(SEG),
                                        window, op))
    pallas = np.asarray(jops.windowed_scan(jnp.asarray(VALS),
                                           jnp.asarray(SEG), window, op,
                                           force="pallas"))
    np.testing.assert_array_equal(bits(got), bits(ref))
    np.testing.assert_array_equal(bits(got), bits(pallas))


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_segmented_cumulative_bit_identical(op):
    got = _port(tref.segmented_cumulative, op)
    ref = np.asarray(jref.segmented_cumulative(jnp.asarray(VALS),
                                               jnp.asarray(SEG), op))
    np.testing.assert_array_equal(bits(got), bits(ref))


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_wide_window_matches_brute_force(op):
    """w = 5000 > n/2, n not a multiple of w: every window clips to its
    segment start, the answer of a loop over the rows."""
    n, w = 7001, 5000
    flags = RNG.random(n) < 1e-3
    flags[0] = True
    seg = np.maximum.accumulate(np.where(flags, np.arange(n), 0))
    v = RNG.normal(size=(n, 2)).astype(np.float32)
    got = tref.windowed_scan(torch.from_numpy(v), torch.from_numpy(seg), w,
                             op).numpy()
    red = {"sum": np.sum, "min": np.min, "max": np.max}[op]
    exp = np.stack([red(v[max(i - w + 1, seg[i]):i + 1].astype(np.float64),
                        axis=0) for i in range(n)])
    if op == "sum":
        scale = np.stack([np.abs(v[max(i - w + 1, seg[i]):i + 1]).sum(0)
                          for i in range(n)])
        assert np.all(np.abs(got - exp) <= 1e-5 * scale)
    else:
        np.testing.assert_array_equal(got, exp.astype(np.float32))


def test_ops_dispatch_on_the_cpu():
    """A CPU tensor takes the plain version; (n,) values squeeze; the
    kernel wrapper refuses a CPU tensor instead of falling back."""
    v, s = torch.from_numpy(VALS), torch.from_numpy(SEG)
    for op in ("sum", "max"):
        np.testing.assert_array_equal(
            bits(tops.windowed_scan(v, s, 9, op).numpy()),
            bits(tref.windowed_scan(v, s, 9, op).numpy()))
    one = tops.windowed_scan(v[:, 1], s, 9, "min")
    assert one.shape == (N,)
    np.testing.assert_array_equal(
        bits(one.numpy()), bits(tref.windowed_scan(v[:, 1:2], s, 9,
                                                   "min")[:, 0].numpy()))
    with pytest.raises(ValueError, match="unknown windowed_scan op"):
        tops.windowed_scan(v, s, 9, "mean")
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.windowed_scan_cuda(v, s.to(torch.int32), 9)
