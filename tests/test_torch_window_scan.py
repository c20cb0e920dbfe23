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


# ---------------------------------------------------------------------------
# the CUDA kernel's fused schedule, emulated on the CPU
# ---------------------------------------------------------------------------
def _shfl_up(v, d):
    """``__shfl_up_sync`` over the last-but-one axis of 32 lanes: lane t
    reads lane t - d, the lanes below d keep their own value."""
    return torch.cat([v[:, :d], v[:, :-d]], dim=1)


def _shfl_down(v, d):
    return torch.cat([v[:, d:], v[:, -d:]], dim=1)


def _bit_length(m):
    """``32 - __clz(m)`` for non-negative int64 ``m`` below 2^32."""
    pos = torch.floor(torch.log2(torch.clamp(m, min=1).double())).long()
    return torch.where(m > 0, pos + 1, 0)


def _warp_ladders(x, start, o, w, op):
    """Both ladders of ``window_scan_warp`` on steps of 32 lanes: ``x (S,
    32, L)``, ``start (S, 32)`` segment starts, ``o (32,)`` offsets in the
    chunk.  As in the kernel, each lane runs the first ``kp`` prefix and
    ``ks`` suffix steps, from its distance back to its segment start and
    on to the next row followed by a start, read off the ballots of
    segment starts (``starts``) and of "next row starts one" (``gs``)."""
    ident = torch.tensor(tref._IDENTITY[op], dtype=x.dtype)
    t = torch.arange(32)
    weights = torch.tensor([1 << i for i in range(32)], dtype=torch.int64)
    starts = (start.to(torch.int64) * weights).sum(1)[:, None]
    nxt = (starts >> torch.clamp(t + 1, max=31)) & 1
    g0 = (t < 31) & (o + 1 < w) & (nxt == 1)
    gs = (g0.to(torch.int64) * weights).sum(1)[:, None]
    back = starts & ((1 << (t + 1)) - 1)  # lanes <= t
    dist = torch.where(back > 0, t - (_bit_length(back) - 1), 32)
    on = gs >> t  # lanes >= t
    gdist = torch.where(on > 0, _bit_length(on & -on) - 1, 32)
    kp = _bit_length(torch.minimum(o + 1, dist))
    ks = _bit_length(torch.minimum(w - o, gdist))
    v, u = x.clone(), x.clone()
    k, d = 0, 1
    while d < w:
        sv, su = _shfl_up(v, d), _shfl_down(u, d)
        left = torch.where((o >= d)[None, :, None], sv, ident)
        right = torch.where((o + d < w)[None, :, None], su, ident)
        v = torch.where((k < kp)[..., None], tref._combine(op, left, v), v)
        u = torch.where((k < ks)[..., None], tref._combine(op, right, u), u)
        k, d = k + 1, d * 2
    return v, u


def emulate_fused_scan(values, seg, w, op, run=3):
    """The tile schedule of ``csrc/window_scan.cu`` for ``w <= TILE``, step
    for step: for ``w <= 32`` warps of 32 lanes holding ``32 // w`` whole
    chunks, each warp a run of ``run`` steps that first recomputes the
    step before it, suffixes of the previous step kept for the cross-chunk
    combine; above 32 a CTA tile of whole chunks plus its lead-in chunk."""
    n, lanes = values.shape
    ident = tref._IDENTITY[op]
    seg = seg.to(torch.int64)
    out = torch.full((n, lanes), float("nan"))
    if w <= 32:
        R = (32 // w) * w
        t = torch.arange(32)
        o = t % w
        n_steps = -(-n // R)
        for s0 in range(0, n_steps, run):
            s1 = min(s0 + run, n_steps)
            first = max(s0 - 1, 0)
            j = torch.arange(first, s1)[:, None] * R + t[None, :]
            real = (t < R)[None, :] & (j < n)
            jc = torch.clamp(j, max=n - 1)
            x = torch.where(real[..., None], values[jc], ident)
            sj = torch.where(real, seg[jc], 0)
            pre, suf = _warp_ladders(x, ~real | (sj == j), o, w, op)
            prev = torch.cat([torch.full_like(suf[:1], ident), suf[:-1]])
            # a lane of the step's last chunk publishes the previous step's
            # suffix, any other lane this step's
            pub = torch.where((t >= R - w)[None, :, None], prev, suf)
            base = torch.arange(first, s1)[:, None] * R
            a = torch.maximum(j - w + 1, sj)
            straddle = real & (a < j - o)
            src = torch.where(straddle, torch.where(a >= base, a - base,
                                                    a - base + R), t)
            sa = torch.gather(pub, 1, src[..., None].expand_as(pub))
            r = torch.where(straddle[..., None], tref._combine(op, sa, pre),
                            pre)
            keep = real & (torch.arange(first, s1) >= s0)[:, None]
            out[j[keep]] = r[keep]
        return out
    tile = (tkernel.TILE // w) * w

    def rows_of(lo, hi):
        """values and segment starts of rows [lo, hi) as ``(chunks, w)``
        blocks; rows past n are identity padding, each its own segment"""
        j = torch.arange(lo, hi)
        real = j < n
        jc = torch.clamp(j, max=n - 1)
        x = torch.where(real[:, None], values[jc], ident)
        start = ~real | (seg[jc] == j)
        c = (hi - lo) // w
        return x.reshape(c, w, lanes), start.reshape(c, w)

    for r0 in range(0, n, tile):
        # the suffix ladder covers the lead-in chunk and every tile chunk
        # but the last; the prefix ladder covers the tile
        e0 = r0 - w if r0 else 0
        suf = tref._chunk_suffix(*rows_of(e0, r0 + tile - w), op)
        suf = suf.reshape(-1, lanes)
        pre = tref._chunk_scan(*rows_of(r0, r0 + tile), op).reshape(-1, lanes)
        j = torch.arange(r0, min(r0 + tile, n))
        pre = pre[:j.shape[0]]
        if suf.shape[0]:  # the first tile of one chunk has no lead-in
            a = torch.maximum(j - w + 1, seg[j])
            sa = suf[torch.clamp(a - e0, 0, suf.shape[0] - 1)]
            pre = torch.where((a < (j // w) * w)[:, None],
                              tref._combine(op, sa, pre), pre)
        out[j] = pre
    return out


def _scan_case(n, lanes, seed):
    rng = np.random.default_rng(seed)
    flags = rng.random(n) < 0.02
    flags[0] = True
    seg = np.maximum.accumulate(np.where(flags, np.arange(n), 0))
    v = rng.normal(size=(n, lanes)).astype(np.float32)
    v[rng.random((n, lanes)) < 0.004] = np.nan
    v[5:9, 0] = [-0.0, 0.0, 0.0, -0.0]
    return v, seg.astype(np.int32)


@pytest.mark.parametrize("window", [1, 2, 5, 7, 16, 31, 32])
@pytest.mark.parametrize("lanes", [1, 3, 5])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_fused_warp_schedule_bit_identical_to_jax(window, lanes, op):
    """Warp-sized ladders (w <= 32): shuffles with the plain ladder's
    steps, operand order and identity fills, per-run recompute of the
    previous step's suffixes — bit-identical to JAX's ``ref``."""
    v, seg = _scan_case(1503, lanes, window * 7 + lanes)
    got = emulate_fused_scan(torch.from_numpy(v), torch.from_numpy(seg),
                             window, op)
    exp = np.asarray(jref.windowed_scan(jnp.asarray(v), jnp.asarray(seg),
                                        window, op))
    np.testing.assert_array_equal(bits(got.numpy()), bits(exp))


@pytest.mark.parametrize("window", [33, 64, 3000, 4096])
@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_fused_tile_schedule_bit_identical_to_jax(window, lanes, op):
    """A CTA tile of whole chunks plus the lead-in chunk whose suffixes it
    recomputes (32 < w <= TILE; 3000 tiles unevenly)."""
    v, seg = _scan_case(9001, lanes, window + lanes)
    got = emulate_fused_scan(torch.from_numpy(v), torch.from_numpy(seg),
                             window, op)
    exp = np.asarray(jref.windowed_scan(jnp.asarray(v), jnp.asarray(seg),
                                        window, op))
    np.testing.assert_array_equal(bits(got.numpy()), bits(exp))


def test_kernel_reads_strided_rows_without_copy():
    """The engine's column views keep their row stride for the kernel;
    a layout with lanes apart is copied."""
    table = torch.zeros((10, 4))
    view, ld = tkernel._rows(table[:, :2])
    assert ld == 4 and view.data_ptr() == table.data_ptr()
    col = table[:, 3][:, None]
    view, ld = tkernel._rows(col)
    assert ld == 4 and view.data_ptr() == table[:, 3].data_ptr()
    view, ld = tkernel._rows(table[:, ::2])
    assert ld == 2 and view.is_contiguous()
