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
