"""The port's plain flash attention and masked ``attend`` against the JAX
package on the CPU.

The same numpy inputs (bf16 cases round the same float32 values to
bfloat16 on both sides) go through the JAX reference
(``repro.kernels.flash_attention.ref``), the Pallas kernel in interpret
mode, and the port's ``ref.py``; tolerances are those of
``tests/test_kernels.py``: 2e-4 in float32 (summation order), 2e-2 in
bfloat16 (one output rounding).  The CUDA kernel is held to the port's
``ref.py`` on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import kernel as jfk  # noqa: E402
from repro.kernels.flash_attention import ref as jfr  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fo  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fr  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

RNG = np.random.default_rng(13)

# b, hq, hkv, sq, sk, d, causal, window, q_offset (tests/test_kernels.py)
FLASH_CASES = [
    (2, 4, 2, 128, 128, 64, True, None, 0),
    (1, 8, 8, 100, 100, 32, True, None, 0),      # ragged (non-multiple)
    (1, 4, 1, 64, 256, 64, False, None, 0),      # MQA, bidirectional
    (2, 2, 2, 1, 512, 64, True, None, 511),      # decode
    (1, 4, 2, 256, 256, 64, True, 64, 0),        # sliding window
    (1, 2, 2, 1, 384, 128, True, 128, 383),      # SWA decode
    (1, 1, 1, 16, 16, 128, True, None, 0),       # tiny
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _both(shape, dtype):
    x = RNG.normal(size=shape).astype(np.float32)
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(got_t, exp_j, tol):
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(exp_j, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("oracle", ["ref", "pallas"])
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_ref_vs_jax(case, dtype, oracle):
    b, hq, hkv, sq, sk, d, causal, window, qoff = case
    jq, tq = _both((b, hq, sq, d), dtype)
    jk, tk = _both((b, hkv, sk, d), dtype)
    jv, tv = _both((b, hkv, sk, d), dtype)
    kw = dict(causal=causal, window=window, q_offset=qoff)
    if oracle == "ref":
        exp = jfr.flash_attention(jq, jk, jv, **kw)
    else:
        exp = jfk.flash_attention_pallas(jq, jk, jv, interpret=True,
                                         block_q=64, block_k=64, **kw)
    got = fo.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == DTYPES[dtype][1] and got.shape == tq.shape
    _close(got, exp, DTYPES[dtype][2])


@pytest.mark.parametrize("kv_len", [0, 50, 128, 500])
def test_flash_kv_len_mask_vs_jax(kv_len):
    jq, tq = _both((1, 2, 8, 64), "float32")
    jk, tk = _both((1, 2, 128, 64), "float32")
    jv, tv = _both((1, 2, 128, 64), "float32")
    got = fr.flash_attention(tq, tk, tv, causal=False, kv_len=kv_len)
    _close(got, jfr.flash_attention(jq, jk, jv, causal=False, kv_len=kv_len),
           2e-4)
    if kv_len <= 128:
        pal = jfk.flash_attention_pallas(jq, jk, jv, causal=False,
                                         kv_len=kv_len, interpret=True,
                                         block_q=8, block_k=32)
        _close(got, pal, 2e-4)
    if kv_len == 0:  # every row fully masked: zeros, as the kernel writes
        assert not got.any()


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 16)])
def test_attend_with_empty_slots_vs_jax(causal, window):
    """Decode-style attend over a cache with ``kv_pos == -1`` slots."""
    b, hq, hkv, s, length, d = 2, 4, 2, 3, 40, 16
    jq, tq = _both((b, hq, s, d), "float32")
    jk, tk = _both((b, hkv, length, d), "float32")
    jv, tv = _both((b, hkv, length, d), "float32")
    kv_pos = np.arange(length, dtype=np.int32)
    kv_pos[[3, 17, 30, 31, 39]] = -1
    q_pos = np.array([33, 34, 35], np.int32)
    exp = jlayers.attend(jq, jk, jv, q_pos=jnp.asarray(q_pos),
                         kv_pos=jnp.asarray(kv_pos), causal=causal,
                         window=window, q_chunk=2)
    got = tlayers.attend(tq, tk, tv, q_pos=torch.from_numpy(q_pos),
                         kv_pos=torch.from_numpy(kv_pos), causal=causal,
                         window=window)
    _close(got, exp, 1e-5)


def test_flash_matches_port_attend():
    """Kernel semantics == the model's plain path, as in the reference."""
    b, hq, hkv, s, d = 1, 4, 2, 96, 32
    _, q = _both((b, hq, s, d), "float32")
    _, k = _both((b, hkv, s, d), "float32")
    _, v = _both((b, hkv, s, d), "float32")
    pos = torch.arange(s, dtype=torch.int32)
    got = tlayers.attend(q, k, v, q_pos=pos, kv_pos=pos, causal=True)
    np.testing.assert_allclose(got.numpy(), fr.flash_attention(q, k, v)
                               .numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("d", [4, 12, 100, 136])
def test_head_dims_the_kernel_refuses_raise_on_every_device(d):
    q = torch.zeros((1, 1, 4, d))
    with pytest.raises(ValueError, match="head dim"):
        fo.flash_attention(q, q, q)


def test_kernel_wrapper_needs_cuda_tensors():
    q = torch.zeros((1, 2, 4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fk.flash_attention_cuda(q, q, q)
    with pytest.raises(TypeError, match="dtype"):
        fk.flash_attention_cuda(q.half(), q.half(), q.half())


# ---------------------------------------------------------------------------
# the bfloat16 tensor-core kernel's arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------
LOG2E = np.float32(1.4426950408889634)


def emulate_wgmma_flash(q, k, v, *, causal=True, window=None, kv_len=None,
                        q_offset=0, sm_scale=None):
    """What ``csrc/flash_attention_sm90.cu`` computes, step for step: each
    64-row warpgroup walks the 64-key blocks its CTA's 128 rows need in
    ascending order and skips the blocks fully masked for its rows; S in
    float32 from the bf16 inputs, scaled by ``sm_scale * log2(e)`` and
    exponentiated with exp2; masked scores -1e30 and masked P exactly 0;
    per tile, P enters P·V as three bf16 terms (``bf16(P)``, then the
    rounded remainders) in three products summed afresh for the tile, and
    ``O = alpha O + P·V`` in float32; the row sum ``l`` sums the float32 P;
    O is scaled by ``1 / l`` (rows with ``l == 0`` write 0) and rounded to
    bf16."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g = hq // hkv
    kv = sk if kv_len is None else max(0, min(int(kv_len), sk))
    scale = np.float32(d ** -0.5 if sm_scale is None else sm_scale) * LOG2E
    qf = q.float().reshape(b, hkv, g, sq, d)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    out = torch.zeros((b, hkv, g, sq, d))
    neg = torch.tensor(-1e30)
    for q0 in range(0, sq, 128):                        # one CTA
        last = q_offset + min(q0 + 127, sq - 1)
        kb_hi = -(-kv // 64)
        if causal:
            kb_hi = 0 if last < 0 else min(kb_hi, last // 64 + 1)
        first = q_offset + q0 - window + 1 if window is not None else 0
        kb_lo = first // 64 if first > 0 else 0
        for row0 in (q0, q0 + 64):                      # its two warpgroups
            if row0 >= sq:
                continue
            rows = torch.arange(row0, min(row0 + 64, sq))
            pos = q_offset + rows[:, None]
            pmin, pmax = q_offset + row0, q_offset + int(rows[-1])
            m = torch.full((b, hkv, g, rows.numel(), 1), -1e30)
            l = torch.zeros_like(m)
            o = torch.zeros((b, hkv, g, rows.numel(), d))
            for kb in range(kb_lo, kb_hi):
                k0 = kb * 64
                if causal and k0 > pmax or (window is not None
                                            and pmin - (k0 + 63) >= window):
                    continue
                cols = torch.arange(k0, min(k0 + 64, sk))
                allow = (cols[None, :] < kv).repeat(rows.numel(), 1)
                if causal:
                    allow = allow & (cols[None, :] <= pos)
                if window is not None:
                    allow = allow & (pos - cols[None, :] < window)
                s = qf[:, :, :, rows] @ kf[:, :, :, cols].transpose(-1, -2)
                s = torch.where(allow, s * scale, neg)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha = torch.exp2(m - m_new)
                p = torch.where(allow, torch.exp2(s - m_new), 0.0)
                l = l * alpha + p.sum(-1, keepdim=True)
                ot, rest = 0.0, p
                for _ in range(3):
                    part = rest.to(torch.bfloat16).float()
                    ot = ot + part @ vf[:, :, :, cols]
                    rest = rest - part
                o = o * alpha + ot
                m = m_new
            inv = torch.where(l > 0, 1.0 / l.clamp(min=1e-30), 0.0)
            out[:, :, :, rows] = torch.where(l > 0, o * inv, 0.0)
    return out.reshape(b, hq, sq, d).to(q.dtype)


@pytest.mark.parametrize("oracle", ["ref", "pallas", "port_ref"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_wgmma_emulation_vs_jax(case, oracle):
    """The tensor-core kernel's arithmetic (P as three bf16 terms) holds
    bf16's 2e-2 against the JAX reference, the Pallas kernel and the
    port's plain version on the same cases as the plain version."""
    b, hq, hkv, sq, sk, d, causal, window, qoff = case
    jq, tq = _both((b, hq, sq, d), "bfloat16")
    jk, tk = _both((b, hkv, sk, d), "bfloat16")
    jv, tv = _both((b, hkv, sk, d), "bfloat16")
    kw = dict(causal=causal, window=window, q_offset=qoff)
    got = emulate_wgmma_flash(tq, tk, tv, **kw)
    if oracle == "ref":
        exp = jfr.flash_attention(jq, jk, jv, **kw)
    elif oracle == "pallas":
        exp = jfk.flash_attention_pallas(jq, jk, jv, interpret=True,
                                         block_q=64, block_k=64, **kw)
    else:
        exp = fr.flash_attention(tq, tk, tv, **kw).float().numpy()
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    _close(got, exp, 2e-2)


@pytest.mark.parametrize("kv_len", [0, 50, 1000])
def test_wgmma_emulation_kv_len_and_ragged_tiles(kv_len):
    """kv_len masks, a length that fills no tile (77 queries, 1000 keys)
    and GQA 3, against the JAX reference."""
    jq, tq = _both((1, 6, 77, 40), "bfloat16")
    jk, tk = _both((1, 2, 1000, 40), "bfloat16")
    jv, tv = _both((1, 2, 1000, 40), "bfloat16")
    kw = dict(causal=False, kv_len=kv_len)
    got = emulate_wgmma_flash(tq, tk, tv, **kw)
    _close(got, jfr.flash_attention(jq, jk, jv, **kw), 2e-2)
    if kv_len == 0:
        assert not got.float().any()


def test_reduced_phi3_prefill_with_wgmma_emulation(monkeypatch):
    """A bf16 phi3 prefill (phi3's head dim 96, 4 layers, a 200-token
    prompt) with the tensor-core kernel's arithmetic in every layer
    against the plain ``attend`` path: last-position logits within the
    2e-2 of the largest logit that ``chip_smoke.py`` holds at full size."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models.transformer import LM

    cfg = dataclasses.replace(
        reduced_config(get_config("phi3-mini-3.8b")), n_layers=4,
        d_model=384, n_heads=4, n_kv_heads=4, d_head=96, d_ff=1024,
        vocab_size=512, dtype="bfloat16")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 200), dtype=np.int32))
    calls = []

    def counted(*a, **kw):
        calls.append(1)
        return emulate_wgmma_flash(*a, **kw)

    monkeypatch.setattr(fo, "flash_attention", counted)
    logits = {}
    for flash in (True, False):
        model = LM(dataclasses.replace(cfg, use_flash=flash),
                   torch.Generator().manual_seed(3), "cpu")
        with torch.inference_mode():
            out, _, _ = model(toks, mode="prefill", cache_len=200)
        logits[flash] = out[:, -1].float()
    assert len(calls) == cfg.n_layers
    rel = float((logits[True] - logits[False]).abs().max()
                / logits[False].abs().max())
    assert torch.isfinite(logits[True]).all() and rel < 2e-2, rel
