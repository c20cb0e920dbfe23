"""Public flash-attention entry point.

The device and the dtype pick what runs, and nothing else does:

* a bfloat16 CUDA tensor → the tensor-core kernel
  (``csrc/flash_attention_sm90.cu``, wgmma fed by TMA);
* a float32 CUDA tensor → the SIMT kernel (``csrc/flash_attention.cu``,
  the 32-bit FMA units; float32 serves no other dtype);
* a CPU tensor → the plain version (``ref.py``).

Nothing falls back from one to another: a build or launch failure raises.
A head dim the kernels do not take raises on both devices, so the CPU
never accepts a shape the card would refuse.  The kernels are forward
only, as the reference's is (it has no vjp): with autograd recording and
``q``, ``k`` or ``v`` requiring grad the op raises on both devices,
instead of returning an output the graph does not reach.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import native
from . import kernel as _kernel
from . import ref as _ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    kv_len: Optional[int] = None, q_offset: int = 0,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, Sq, D); k, v (B, Hkv, Sk, D) → (B, Hq, Sq, D)."""
    _kernel.check_head_dim(q.shape[-1])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention is forward only (no backward kernel): train "
            "with use_flash=False, the plain attend path")
    fn = (_kernel.flash_attention_cuda if native.on_cuda(q)
          else _ref.flash_attention)
    return fn(q, k, v, causal=causal, window=window, kv_len=kv_len,
              q_offset=q_offset, sm_scale=sm_scale)
