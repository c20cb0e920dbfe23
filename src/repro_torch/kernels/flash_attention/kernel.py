"""Wrappers of the two CUDA flash-attention kernels.

Replace the TPU kernel ``flash_attention_pallas``
(``src/repro/kernels/flash_attention/kernel.py``).  The input dtype picks
the kernel, and nothing else does:

* bfloat16 → ``csrc/flash_attention_sm90.cu`` (instance ``"wgmma"``): both
  products on the tensor cores (``wgmma``), K/V tiles brought by TMA, P
  rounded to bfloat16 for the P·V product.
* float32 → ``csrc/flash_attention.cu`` (instance ``"simt"``): both products
  on the 32-bit FMA units, so float32 keeps its 2e-4 tolerance (TF32 would
  not).

The TPU kernel carries the online-softmax state in VMEM scratch across a
sequential key-block grid axis; here one CTA owns a block of query rows
of one (batch, head) and loops over the key blocks itself, and GQA reads
kv head ``h // (Hq / Hkv)`` without repeating K/V.  Both kernels read
strided views (only the head dimension must be contiguous), so the
model's ``(B, S, H, D) → (B, H, S, D)`` transposes reach them without a
copy, and the output is allocated with ``(B, Sq, Hq, D)`` memory so the
model's inverse transpose is free.  TMA also needs a 16-byte-aligned base
and strides that are multiples of 16 bytes; a bfloat16 view that breaks
them is copied explicitly (``ALIGN_COPIES``), never read wrong.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.array_ops import Counter
from .. import native

#: launches of either flash-attention kernel
LAUNCHES = Counter()
#: the kernel each dtype runs, and the launches of each
INSTANCES = {torch.bfloat16: "wgmma", torch.float32: "simt"}
INSTANCE_LAUNCHES = {"wgmma": Counter(), "simt": Counter()}
_ENTRY = {"wgmma": "hptmt_flash_attention_sm90",
          "simt": "hptmt_flash_attention"}
#: bfloat16 views copied because TMA cannot read them in place
ALIGN_COPIES = Counter()

#: rows of the smaller query block (``kBQ`` of the SIMT kernel)
BLOCK_Q = 64
MAX_D = 128


def check_head_dim(d: int) -> None:
    """The kernel takes head dims that are multiples of 8 up to 128."""
    if d < 8 or d > MAX_D or d % 8:
        raise ValueError(f"flash attention kernel: head dim {d} must be a "
                         f"multiple of 8 in [8, {MAX_D}]")


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when TMA can read it in place (16-byte-aligned base,
    the batch, head and sequence strides of dimensions longer than 1
    multiples of 16 bytes), else a contiguous copy."""
    size = t.element_size()
    if t.data_ptr() % 16 == 0 and all(
            st * size % 16 == 0
            for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1):
        return t
    ALIGN_COPIES.add()
    return t.clone(memory_format=torch.contiguous_format)


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
    if q.dtype not in INSTANCES or k.dtype != q.dtype or v.dtype != q.dtype:
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
    impl = INSTANCES[q.dtype]
    if impl == "wgmma":
        q, k, v = (_tma_ready(t) for t in (q, k, v))
    name = _ENTRY[impl]
    err = getattr(native.library(), name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, hq, hkv, sq, sk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(bool(causal)), w, kv, int(q_offset), scale, native.stream(dev))
    native.check(name, err)
    LAUNCHES.add()
    INSTANCE_LAUNCHES[impl].add()
    return out
