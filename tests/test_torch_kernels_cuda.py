"""The hand-written CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one (marker
``cuda``).  Run them on a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

The first test builds the kernels (``nvcc``, ``sm_90a``) and prints what
``ptxas -v`` reports.  Shapes are small; ``chip_smoke.py`` holds the
kernels at the main path's full shapes.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.exchange import key_compare_u32  # noqa: E402
from repro_torch.core.table import as_tensor, hash_columns  # noqa: E402
from repro_torch.kernels import native  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fak  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fao  # noqa: E402
from repro_torch.kernels.flash_attention import ref as far  # noqa: E402
from repro_torch.kernels.hash_join import kernel as hjk  # noqa: E402
from repro_torch.kernels.hash_join import ref as hjr  # noqa: E402
from repro_torch.kernels.hash_partition import kernel as hpk  # noqa: E402
from repro_torch.kernels.hash_partition import ref as hpr  # noqa: E402
from repro_torch.kernels.segment_reduce import kernel as srk  # noqa: E402
from repro_torch.kernels.segment_reduce import ref as srr  # noqa: E402
from repro_torch.kernels.window_scan import kernel as wsk  # noqa: E402
from repro_torch.kernels.window_scan import ref as wsr  # noqa: E402

pytestmark = pytest.mark.cuda
RNG = np.random.default_rng(29)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    native.library(verbose=True)
    return torch.device("cuda")


@pytest.mark.parametrize("n_parts,n_keys", [(1, 1), (4, 1), (16, 3), (1000, 2)])
def test_hash_partition_kernel_bit_exact(dev, n_parts, n_keys):
    n = 100_003
    keys = torch.from_numpy(RNG.integers(-2**31, 2**31 - 1, (n, n_keys))
                            .astype(np.int32)).to(dev)
    valid = torch.from_numpy(RNG.random(n) < 0.9).to(dev)
    got = hpk.hash_partition_cuda(keys, valid, n_parts, return_hashes=True)
    exp = hpr.hash_partition_lanes(keys, valid, n_parts, return_hashes=True)
    for g, e in zip(got, exp):
        assert torch.equal(g, e)
    d, h = hpk.hash_partition_cuda(keys, valid, n_parts)
    assert torch.equal(d, exp[0]) and torch.equal(h, exp[1])


#: float key pool: NaN (equal bits match), -0.0 vs +0.0 (distinct)
KEY_POOL = np.array([0.0, -0.0, 1.0, 2.0, np.nan, 7.25], np.float32)


def _probe_keys(dev, kind, lanes, n, combos):
    """``lanes`` key columns (one 32-bit lane each) over about ``combos``
    distinct keys → hashes and lanes; float columns hold 1% of ±0.0, NaN
    and other specials."""
    pool = max(2, round(combos ** (1 / lanes)))
    cols = [RNG.integers(0, pool, n).astype(np.int32) for _ in range(lanes)]
    if kind == "float":
        cols = [np.where(RNG.random(n) < 0.01,
                         KEY_POOL[RNG.integers(0, len(KEY_POOL), n)],
                         c.astype(np.float32)) for c in cols]
    ts = [as_tensor(c, dev) for c in cols]
    h1, h2 = hash_columns(ts)
    keys = key_compare_u32({f"c{i}": t for i, t in enumerate(ts)},
                           [f"c{i}" for i in range(lanes)])
    return h1, h2, keys


def _probe_both(table, bh2, bkeys, ph1, ph2, pkeys, pvalid, mm, mp):
    """The kernel over the packed records and the reference's walk over its
    three slot arrays, which must agree bit for bit."""
    records, side = hjr.slot_records(table, bh2, bkeys)
    assert (side is None) == (bkeys.shape[1] <= 2)
    got = hjk.probe_cuda(records, side, ph1, ph2, pkeys, pvalid, mm, mp)
    sh2, skeys = hjr.slot_payload(table, bh2, bkeys)
    exp = hjr.probe(table, sh2, skeys, ph1, ph2, pkeys, pvalid, mm, mp)
    for g, e in zip(got, exp):
        assert torch.equal(g, e)
    return got


@pytest.mark.parametrize("lanes", [1, 2, 3])
@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("max_matches,max_probes", [(1, 64), (8, 64), (4, 3)])
def test_probe_kernel_bit_exact(dev, lanes, kind, max_matches, max_probes):
    """16-byte records (1-2 lanes) and 8-byte records with a side array (3
    lanes); duplicate build keys; float keys with ±0.0 and NaN; a short
    ``max_probes`` that leaves rows exhausted."""
    bh1, bh2, bk = _probe_keys(dev, kind, lanes, 20_000, 5000)
    ph1, ph2, pk = _probe_keys(dev, kind, lanes, 50_000, 6000)
    bvalid = torch.ones(20_000, dtype=torch.bool, device=dev)
    pvalid = torch.from_numpy(RNG.random(50_000) < 0.95).to(dev)
    slots = 1 << 17
    table, _ = hjr.build_table(bh1, bh2, bvalid, slots, max_probes)
    cnt, _, exhausted = _probe_both(table, bh2, bk, ph1, ph2, pk, pvalid,
                                    max_matches, max_probes)
    if max_probes == 64:
        assert int(cnt.max()) > max_matches  # more matches than registers
    else:
        assert bool(exhausted.any())


@pytest.mark.parametrize("lanes", [1, 2, 3])
def test_probe_kernel_nearly_full_table(dev, lanes):
    """1000 rows in 1024 slots: long chains that wrap past the table's
    end, walks that hit max_probes, and a unique-key (set-op) table."""
    bh1, bh2, bk = _probe_keys(dev, "int", lanes, 1000, 1 << 20)
    ph1, ph2, pk = _probe_keys(dev, "int", lanes, 5000, 1 << 20)
    ph1, ph2, pk = (torch.cat([bh1, ph1]), torch.cat([bh2, ph2]),
                    torch.cat([bk, pk]))
    pvalid = torch.ones(ph1.shape[0], dtype=torch.bool, device=dev)
    bvalid = torch.ones(1000, dtype=torch.bool, device=dev)
    table, failed = hjr.build_table(bh1, bh2, bvalid, 1024, 1024)
    assert int(failed) == 0
    for mp in (1024, 16):
        cnt, _, exhausted = _probe_both(table, bh2, bk, ph1, ph2, pk, pvalid,
                                        8, mp)
        assert bool((cnt[:1000] >= 1).all()) or mp == 16
        assert bool(exhausted.any()) == (mp == 16)
    owner, _, _ = hjr.build_table_unique(bh1, bh2, bk, bvalid, 1024, 1024)
    _probe_both(owner, bh2, bk, ph1, ph2, pk, pvalid, 1, 64)


@pytest.mark.parametrize("lanes", [1, 3])
def test_probe_kernel_misaligned_records(dev, lanes):
    """Records in a contiguous view that starts off their vector width (16
    or 8 bytes) are copied, not read misaligned."""
    bh1, bh2, bk = _probe_keys(dev, "int", lanes, 2000, 1 << 20)
    ph1, ph2, pk = _probe_keys(dev, "int", lanes, 5000, 1 << 20)
    pk = torch.cat([bk, pk])
    ph1, ph2 = torch.cat([bh1, ph1]), torch.cat([bh2, ph2])
    pvalid = torch.ones(ph1.shape[0], dtype=torch.bool, device=dev)
    table, _ = hjr.build_table(bh1, bh2, torch.ones_like(pvalid[:2000]),
                               4096, 64)
    records, side = hjr.slot_records(table, bh2, bk)
    flat = torch.empty(records.numel() + 1, dtype=torch.int32, device=dev)
    off = flat[1:].view(records.shape)  # 4 bytes past the vector width
    off.copy_(records)
    assert off.data_ptr() % (4 * records.shape[1])
    got = hjk.probe_cuda(off, side, ph1, ph2, pk, pvalid, 2, 64)
    exp = hjk.probe_cuda(records, side, ph1, ph2, pk, pvalid, 2, 64)
    for g, e in zip(got, exp):
        assert torch.equal(g, e)
    assert bool((got[0][:2000] >= 1).all())


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_segment_reduce_kernel(dev, op):
    n, s = 200_000, 1000
    v = torch.from_numpy(RNG.normal(size=n).astype(np.float32)).to(dev)
    v[torch.from_numpy(RNG.integers(0, n, 5)).to(dev)] = float("nan")
    seg = torch.from_numpy(RNG.integers(-5, s + 5, n).astype(np.int32)).to(dev)
    got = srk.segment_reduce_cuda(v, seg, s, op)
    exp = srr.segment_reduce(v, seg, s, op)
    if op == "sum":
        scale = srr.segment_reduce(v.abs().nan_to_num(), seg, s, "sum")
        assert torch.equal(got.isnan(), exp.isnan())
        ok = ~exp.isnan()
        assert bool(((got - exp).abs()[ok] <= 1e-5 * scale[ok]).all())
    else:
        assert torch.equal(got.nan_to_num(7.0), exp.nan_to_num(7.0))
        assert torch.equal(got.isnan(), exp.isnan())


def test_segment_reduce_fused_kernel(dev):
    n, s, lanes = 300_000, 4097, 3
    v = torch.from_numpy(RNG.normal(size=(n, lanes)).astype(np.float32)).to(dev)
    v[:, 0] = 1.0
    seg = torch.from_numpy(RNG.integers(0, s + 3, n).astype(np.int32)).to(dev)
    got = srk.segment_reduce_fused_cuda(v, seg, s)
    exp = srr.segment_reduce_fused(v, seg, s)
    assert torch.equal(got[:, 0], exp[:, 0])  # counts are exact
    scale = srr.segment_reduce_fused(v.abs(), seg, s)
    assert bool(((got - exp).abs() <= 1e-5 * scale).all())


def test_minmax_nan_propagation(dev):
    v = torch.tensor([1.0, float("nan"), 3.0, 2.0], device=dev)
    s = torch.tensor([0, 0, 1, 1], dtype=torch.int32, device=dev)
    lo = srk.segment_reduce_cuda(v, s, 3, "min").cpu().numpy()
    hi = srk.segment_reduce_cuda(v, s, 3, "max").cpu().numpy()
    np.testing.assert_array_equal(lo, [np.nan, 2.0, np.inf])
    np.testing.assert_array_equal(hi, [np.nan, 3.0, -np.inf])


def _nan_equal(a, b):
    """Equal values, NaN where the other has NaN (min/max are exact)."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def _scan_inputs(dev, n, lanes):
    flags = RNG.random(n) < 1 / 300
    flags[0] = True
    seg = np.maximum.accumulate(np.where(flags, np.arange(n), 0))
    v = RNG.normal(size=(n, lanes)).astype(np.float32)
    v[RNG.random((n, lanes)) < 1e-4] = np.nan
    v[3:7, 0] = [-0.0, 0.0, 0.0, -0.0]
    return (torch.from_numpy(v).to(dev),
            torch.from_numpy(seg.astype(np.int32)).to(dev))


def _check_scan(got, exp, vt, st, window, op):
    if op != "sum" or window <= wsk.TILE:
        # min/max are exact; sums over windows up to a tile run the plain
        # version's ladder and are bit-identical
        assert _nan_equal(got, exp)
        assert torch.equal(got.nan_to_num(7.0).view(torch.int32),
                           exp.nan_to_num(7.0).view(torch.int32))
    else:
        scale = wsr.windowed_scan(vt.abs().nan_to_num(), st, window, "sum")
        assert torch.equal(got.isnan(), exp.isnan())
        ok = ~exp.isnan()
        assert bool(((got - exp).abs()[ok] <= 1e-5 * scale[ok]).all())


@pytest.mark.parametrize("window", [1, 7, 31, 32, 33, 64, 3000, 4096, 4097,
                                    10_000])
@pytest.mark.parametrize("lanes", [1, 2, 3, 5])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_windowed_scan_kernel(dev, window, lanes, op):
    """Warp path (w <= 32), CTA tiles with a lead-in chunk (3000 tiles
    unevenly), the three-pass carry path past the 4096-row tile; 1-5
    lanes."""
    vt, st = _scan_inputs(dev, 100_003, lanes)
    got = wsk.windowed_scan_cuda(vt, st, window, op)
    exp = wsr.windowed_scan(vt, st, window, op)
    _check_scan(got, exp, vt, st, window, op)


@pytest.mark.parametrize("window", [32, 33, 4096, 10_000])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_windowed_scan_kernel_strided_views(dev, window, op):
    """The window engine's views — sum lanes ``ext[:, :n_sum]`` and a
    min/max column ``ext[:, n_sum + i]`` of one table — read through their
    row stride with no copy, the same bits as a contiguous input."""
    table, st = _scan_inputs(dev, 70_001, 5)
    view = table[:, :3] if op == "sum" else table[:, 3][:, None]
    assert not view.is_contiguous()
    got = wsk.windowed_scan_cuda(view, st, window, op)
    dense = view.contiguous()
    assert torch.equal(got.view(torch.int32),
                       wsk.windowed_scan_cuda(dense, st, window, op)
                       .view(torch.int32))
    _check_scan(got, wsr.windowed_scan(dense, st, window, op), dense, st,
                window, op)


# b, hq, hkv, sq, sk, d, causal, window, q_offset: the JAX package's
# FLASH_CASES (tests/test_kernels.py), then the serving path's head dims
# (96: phi3, 64 with 15/5 heads: smollm) and a ragged kv_len
FLASH_CASES = [
    (2, 4, 2, 128, 128, 64, True, None, 0),
    (1, 8, 8, 100, 100, 32, True, None, 0),
    (1, 4, 1, 64, 256, 64, False, None, 0),
    (2, 2, 2, 1, 512, 64, True, None, 511),
    (1, 4, 2, 256, 256, 64, True, 64, 0),
    (1, 2, 2, 1, 384, 128, True, 128, 383),
    (1, 1, 1, 16, 16, 128, True, None, 0),
    (2, 4, 4, 200, 200, 96, True, None, 0),
    (1, 15, 5, 130, 130, 64, True, None, 0),
    (1, 3, 1, 70, 70, 8, True, 16, 0),
]


@contextlib.contextmanager
def _ran(dtype, n=1):
    """The block launches ``n`` flash kernels, all of the instance its
    dtype picks: bfloat16 the tensor-core kernel, float32 the SIMT one."""
    want = {"wgmma": 0, "simt": 0}
    want[{torch.bfloat16: "wgmma", torch.float32: "simt"}[dtype]] = n
    before = {k: c.n for k, c in fak.INSTANCE_LAUNCHES.items()}
    yield
    assert {k: c.n - before[k] for k, c in
            fak.INSTANCE_LAUNCHES.items()} == want


def _qkv(dev, b, hq, hkv, sq, sk, d, dtype):
    q = torch.from_numpy(RNG.normal(size=(b, hq, sq, d))).to(dev, dtype)
    k = torch.from_numpy(RNG.normal(size=(b, hkv, sk, d))).to(dev, dtype)
    v = torch.from_numpy(RNG.normal(size=(b, hkv, sk, d))).to(dev, dtype)
    return q, k, v


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel(dev, case, dtype):
    b, hq, hkv, sq, sk, d, causal, window, qoff = case
    dt = getattr(torch, dtype)
    q, k, v = _qkv(dev, b, hq, hkv, sq, sk, d, dt)
    kw = dict(causal=causal, window=window, q_offset=qoff)
    before = fak.LAUNCHES.n
    with _ran(dt):
        got = fao.flash_attention(q, k, v, **kw)
    assert fak.LAUNCHES.n == before + 1
    exp = far.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == exp.shape
    tol = 2e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               exp.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("kv_len", [0, 50, 64, 1000])
def test_flash_attention_kernel_kv_len(dev, kv_len):
    q, k, v = _qkv(dev, 1, 2, 2, 8, 128, 64, torch.float32)
    with _ran(torch.float32):
        got = fak.flash_attention_cuda(q, k, v, causal=False, kv_len=kv_len)
    exp = far.flash_attention(q, k, v, causal=False, kv_len=kv_len)
    np.testing.assert_allclose(got.cpu().numpy(), exp.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)


def test_flash_attention_kernel_strided_views(dev):
    """The model's q/k/v are (B, S, H, D) → (B, H, S, D) transposes."""
    b, s, hq, hkv, d = 2, 77, 6, 2, 40
    x = torch.from_numpy(RNG.normal(size=(b, s, hq + 2 * hkv, d))).to(
        dev, torch.bfloat16)
    q = x[:, :, :hq].transpose(1, 2)
    k = x[:, :, hq:hq + hkv].transpose(1, 2)
    v = x[:, :, hq + hkv:].transpose(1, 2)
    copies = fak.ALIGN_COPIES.n
    with _ran(torch.bfloat16):
        got = fak.flash_attention_cuda(q, k, v)
    assert fak.ALIGN_COPIES.n == copies  # TMA reads the views in place
    exp = far.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               exp.float().cpu().numpy(), rtol=2e-2,
                               atol=2e-2)
    # the output's memory is (B, S, H, D): the inverse transpose is free
    assert got.transpose(1, 2).is_contiguous()


# b, hq, hkv, sq, sk, d, causal, window, kv_len, q_offset: the tensor-core
# kernel's head dims (40 pads to 48 columns of 16, 96 and 128 take two TMA
# boxes), GQA groups 1, 3 and 4, lengths that fill no tile, a window, a
# right-padded cache and a decode query
WGMMA_CASES = [
    (2, 4, 4, 77, 77, 16, True, None, None, 0),
    (1, 6, 2, 1000, 1000, 40, True, None, None, 0),
    (1, 8, 2, 1024, 1024, 64, True, None, None, 0),
    (1, 3, 1, 1024, 1024, 96, True, None, None, 0),
    (1, 4, 1, 1000, 1000, 128, True, None, None, 0),
    (1, 4, 4, 1024, 1024, 96, False, None, None, 0),
    (1, 6, 2, 1000, 1000, 64, True, 200, None, 0),
    (2, 4, 4, 1, 1096, 96, True, None, 1024, 1023),
    (1, 8, 2, 1, 1024, 128, True, 256, None, 1023),
    (1, 3, 1, 77, 1024, 64, False, None, 1000, 0),
    (1, 4, 1, 1024, 1, 96, True, None, None, 0),
]


@pytest.mark.parametrize("case", WGMMA_CASES)
def test_flash_attention_wgmma_kernel(dev, case):
    b, hq, hkv, sq, sk, d, causal, window, kv_len, qoff = case
    q, k, v = _qkv(dev, b, hq, hkv, sq, sk, d, torch.bfloat16)
    kw = dict(causal=causal, window=window, kv_len=kv_len, q_offset=qoff)
    with _ran(torch.bfloat16):
        got = fao.flash_attention(q, k, v, **kw)
    exp = far.flash_attention(q, k, v, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == exp.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               exp.float().cpu().numpy(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("kv_len", [0, 50, 1000])
def test_flash_attention_wgmma_kernel_kv_len(dev, kv_len):
    q, k, v = _qkv(dev, 1, 4, 2, 77, 1024, 96, torch.bfloat16)
    with _ran(torch.bfloat16):
        got = fak.flash_attention_cuda(q, k, v, causal=False, kv_len=kv_len)
    exp = far.flash_attention(q, k, v, causal=False, kv_len=kv_len)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               exp.float().cpu().numpy(), rtol=2e-2,
                               atol=2e-2)
    if kv_len == 0:
        assert not got.float().any()


@pytest.mark.parametrize("where", ["base", "stride"])
def test_flash_attention_wgmma_kernel_misaligned_view_is_copied(dev, where):
    """A view TMA cannot read in place (a base off 16 bytes, or a sequence
    stride of 41 elements) is copied explicitly, never read wrong."""
    b, h, s, d = 1, 2, 100, 40
    if where == "base":
        flat = torch.from_numpy(RNG.normal(size=b * h * s * d + 1)).to(
            dev, torch.bfloat16)
        q = flat[1:].view(b, h, s, d)
    else:
        q = torch.from_numpy(RNG.normal(size=(b, h, s, d + 1))).to(
            dev, torch.bfloat16)[..., :d]
    _, k, v = _qkv(dev, b, h, h, s, s, d, torch.bfloat16)
    copies = fak.ALIGN_COPIES.n
    with _ran(torch.bfloat16):
        got = fak.flash_attention_cuda(q, k, v)
    assert fak.ALIGN_COPIES.n == copies + 1
    exp = far.flash_attention(q, k, v)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               exp.float().cpu().numpy(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("d", [4, 100, 136])
def test_flash_attention_kernel_rejects_head_dim(dev, d):
    q, k, v = _qkv(dev, 1, 1, 1, 4, 4, d, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        fao.flash_attention(q, k, v)


@pytest.mark.parametrize("window", [None, 32])
def test_model_prefill_and_decode_flash_vs_plain(dev, window):
    """A reduced phi3 on the card, float32: the prefill through the flash
    kernel against the plain ``attend`` path, then decode steps (plain on
    both, from each path's cache) into the ring when windowed."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models.transformer import LM

    cfg = dataclasses.replace(reduced_config(get_config("phi3-mini-3.8b")),
                              dtype="float32", window=window)
    out = {}
    for flash in (True, False):
        model = LM(dataclasses.replace(cfg, use_flash=flash),
                   torch.Generator(device=dev).manual_seed(3), dev)
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 43), dtype=np.int32)).to(dev)
        before = fak.LAUNCHES.n
        with torch.inference_mode(), _ran(torch.float32,
                                          cfg.n_layers if flash else 0):
            logits, cache = model(toks[:, :40], mode="prefill",
                                  cache_len=32 if window else 48)
        assert fak.LAUNCHES.n - before == (cfg.n_layers if flash else 0)
        with torch.inference_mode():
            steps = [logits]
            for pos in range(40, 43):
                logits, cache = model(
                    toks[:, pos:pos + 1], mode="decode", cache=cache,
                    positions=torch.tensor([pos], dtype=torch.int32,
                                           device=dev))
                steps.append(logits)
        out[flash] = [s.cpu().numpy() for s in steps]
    for got, exp in zip(out[True], out[False]):
        np.testing.assert_allclose(got, exp, rtol=1e-4, atol=1e-4)
