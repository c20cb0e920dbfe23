"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

Replaces the TPU kernel ``flash_attention_pallas``
(``src/repro/kernels/flash_attention/kernel.py``).  The TPU kernel carries
the online-softmax state in VMEM scratch across a sequential key-block grid
axis; here one CTA owns a (batch·head, 64-query block) pair and loops over
the key blocks itself, and GQA reads kv head ``h // (Hq / Hkv)`` without
repeating K/V.  The kernel reads strided views (only the head dimension
must be contiguous), so the model's ``(B, S, H, D) → (B, H, S, D)``
transposes reach it without a copy, and the output is allocated with
``(B, Sq, Hq, D)`` memory so the model's inverse transpose is free.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.array_ops import Counter
from .. import native

#: launches of the flash-attention kernel
LAUNCHES = Counter()

#: rows of one CTA's query block; must equal ``kBQ`` in the CUDA source
BLOCK_Q = 64
MAX_D = 128

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_head_dim(d: int) -> None:
    """The kernel takes head dims that are multiples of 8 up to 128."""
    if d < 8 or d > MAX_D or d % 8:
        raise ValueError(f"flash attention kernel: head dim {d} must be a "
                         f"multiple of 8 in [8, {MAX_D}]")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         kv_len: Optional[int] = None, q_offset: int = 0,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, Sq, D); k, v (B, Hkv, Sk, D) → (B, Hq, Sq, D) in q's dtype;
    see ``ref.flash_attention``."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} must be (B, H, S, D) with equal "
                         "k and v")
    b, hq, sq, d = q.shape
    _, hkv, sk, dk = k.shape
    if k.shape[0] != b or dk != d or hkv == 0 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree (batch, head dim, or Hq % Hkv != 0)")
    check_head_dim(d)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: need "
                        "one of float32, bfloat16 for all three")
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {dev}")
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    if -(-sq // BLOCK_Q) > 65535 or b * hq >= 2**31:
        raise ValueError(f"q {tuple(q.shape)} exceeds the kernel's grid")
    scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    kv = sk if kv_len is None else max(0, min(int(kv_len), sk))
    w = -1 if window is None else int(window)
    out = torch.empty((b, sq, hq, d), dtype=q.dtype,
                      device=dev).transpose(1, 2)
    err = native.library().hptmt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], b, hq, hkv, sq, sk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(bool(causal)), w, kv, int(q_offset), scale, native.stream(dev))
    native.check("hptmt_flash_attention", err)
    LAUNCHES.add()
    return out
