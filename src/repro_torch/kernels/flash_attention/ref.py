"""Plain PyTorch version of flash attention (masked softmax attention).

The reference's oracle (``src/repro/kernels/flash_attention/ref.py``)
op for op; the hand-written kernel must agree with it:

  * GQA: ``Hq = G * Hkv``; query head ``h`` attends kv head ``h // G``.
  * ``kv_len``: keys at positions >= kv_len are padding (masked out).
  * ``causal``: query at absolute position ``q_offset + i`` sees keys
    ``<= q_offset + i`` (``q_offset`` supports decode, where a single query
    sits at the end of a long cache).
  * ``window``: sliding-window attention — key j visible iff
    ``q_pos - j < window`` (Mistral-style).

Scores, softmax and the value product run in float32; fully masked rows
return zeros; the output has ``q``'s dtype.
"""
from __future__ import annotations

from typing import Optional

import torch


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    kv_len: Optional[int] = None, q_offset: int = 0,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, Sq, D); k, v (B, Hkv, Sk, D) → (B, Hq, Sq, D)."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g = hq // hkv
    if sm_scale is None:
        sm_scale = d ** -0.5
    qf = q.to(torch.float32).reshape(b, hkv, g, sq, d)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * sm_scale

    dev = q.device
    q_pos = q_offset + torch.arange(sq, device=dev)[:, None]
    k_pos = torch.arange(sk, device=dev)[None, :]
    allow = torch.ones((sq, sk), dtype=torch.bool, device=dev)
    if kv_len is not None:
        allow &= k_pos < kv_len
    if causal:
        allow &= k_pos <= q_pos
    if window is not None:
        allow &= (q_pos - k_pos) < window
    s = torch.where(allow, s, float("-inf"))

    m = torch.amax(s, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)  # fully-masked rows
    p = torch.exp(s - m)
    p = torch.where(allow, p, 0.0)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, vf) / torch.clamp(l, min=1e-30)
    o = torch.where(l > 0, o, 0.0)
    return o.reshape(b, hq, sq, d).to(q.dtype)
