"""Mamba selective-state-space mixer (Jamba's SSM blocks).

Ports ``src/repro/models/ssm.py``.  Prefill runs over sequence chunks of
``cfg.scan_chunk`` steps, as the reference does (the last one padded
with steps that multiply by exactly 1 and add exactly 0), carrying the
SSM state from chunk to chunk.  Inside a chunk the linear recurrence
``h_t = a_t * h_{t-1} + b_t`` runs as the reference's
``lax.associative_scan``: the same odd/even recursion, so the products
are grouped as XLA groups them.  The recurrence of one ``(batch, d_inner,
N)`` entry does not read another's, so a chunk is scanned in blocks of
``d_inner`` that bound its ``(chunk, B, block, N)`` float32 tensors to
``SCAN_ELEMS`` elements each; the blocks change no result.

Decode carries ``(conv, ssm)`` state, O(1) a token, with the reference's
one-step update.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from .layers import Cache, RMSNorm, dense_param, f32_param


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    dt_rank = cfg.dt_rank or -(-cfg.d_model // 16)
    return d_inner, dt_rank, cfg.ssm_state_dim, cfg.ssm_conv_width


#: elements of one (chunk, B, d_inner block, N) float32 scan tensor
SCAN_ELEMS = 1 << 26


def _combine(a1, b1, a2, b2):
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    out = even.new_empty((even.shape[0] + odd.shape[0],) + even.shape[1:])
    out[0::2] = even
    out[1::2] = odd
    return out


def associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of ``h_t = a_t * h_{t-1} + b_t`` (``h_{-1} = 0``)
    along dim 0, grouped as ``lax.associative_scan`` groups it.  Returns
    (prefix products of ``a``, ``h``)."""
    n = a.shape[0]
    if n < 2:
        return a, b
    ra, rb = _combine(a[0:-1:2], b[0:-1:2], a[1::2], b[1::2])
    oa, ob = associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:-1], ob[:-1], a[2::2], b[2::2])
    else:
        ea, eb = _combine(oa, ob, a[2::2], b[2::2])
    ea = torch.cat([a[:1], ea])
    eb = torch.cat([b[:1], eb])
    return _interleave(ea, oa), _interleave(eb, ob)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along the sequence. x (B,S,C); w (W,C).
    Returns (y, the last W-1 inputs as the next state)."""
    width = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                         # (B, S+W-1, C)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0].to(x.dtype)
    for i in range(1, width):
        y = y + xp[:, i:i + s] * w[i].to(x.dtype)
    new_state = xp[:, -(width - 1):] if width > 1 else pad
    return y + b.to(x.dtype), new_state


class Mamba(nn.Module):
    """Pre-norm Mamba block; ``forward`` returns (residual_delta,
    new_cache)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 dtype: torch.dtype, device: torch.device):
        super().__init__()
        d = cfg.d_model
        din, dtr, n, w = dims(cfg)
        self.cfg = cfg

        def dense(shape, fan_in=None):
            return dense_param(shape, generator, dtype, device, fan_in)

        self.norm = RMSNorm(d, dtype, device)
        self.in_proj = dense((d, 2 * din))
        self.conv_w = dense((w, din), fan_in=w)
        self.conv_b = nn.Parameter(torch.zeros(din, dtype=dtype,
                                               device=device),
                                   requires_grad=False)
        self.x_proj = dense((din, dtr + 2 * n))
        self.dt_proj = dense((dtr, din))
        # dt_bias, a_log and d_skip are used in float32 by the reference
        u = torch.rand((din,), generator=generator, device=device)
        self.dt_bias = f32_param(torch.log(torch.expm1(
            torch.clamp(u * 0.099 + 0.001, min=1e-4))))
        self.a_log = f32_param(torch.log(torch.arange(
            1, n + 1, dtype=torch.float32, device=device).expand(din, n)))
        self.d_skip = f32_param(torch.ones(din, device=device))
        self.out_proj = dense((din, d), fan_in=din)

    def forward(self, x: torch.Tensor, *, mode: str = "train",
                cache: Optional[Cache] = None
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
        cfg = self.cfg
        b, s, d = x.shape
        din, dtr, n, _ = dims(cfg)
        dt_ = x.dtype
        f32 = torch.float32
        xn = self.norm(x, cfg.norm_eps)

        xz = xn @ self.in_proj.to(dt_)
        xs, z = xz[..., :din], xz[..., din:]
        xs, new_conv = causal_conv(xs, self.conv_w, self.conv_b,
                                   cache["conv"] if mode == "decode"
                                   else None)
        xs = torch.nn.functional.silu(xs)

        dbc = xs @ self.x_proj.to(dt_)
        dt_raw, bm, cm = (dbc[..., :dtr], dbc[..., dtr:dtr + n],
                          dbc[..., dtr + n:])
        dt_full = torch.nn.functional.softplus(
            (dt_raw @ self.dt_proj.to(dt_)).to(f32) + self.dt_bias)
        a = -torch.exp(self.a_log)                            # (Din, N)
        xs_f, bm_f, cm_f = xs.to(f32), bm.to(f32), cm.to(f32)

        if mode == "decode":
            h0 = cache["ssm"]                                  # (B,Din,N)
            da = torch.exp(dt_full[:, 0, :, None] * a)
            dbx = (dt_full[:, 0, :, None] * bm_f[:, 0, None, :]
                   * xs_f[:, 0, :, None])
            h = da * h0 + dbx
            y = torch.einsum("bdn,bn->bd", h, cm_f[:, 0])[:, None]
            new_cache = {"conv": new_conv, "ssm": h}
        else:
            chunk = min(cfg.scan_chunk, s)
            n_chunks = -(-s // chunk)
            pad = n_chunks * chunk - s
            if pad:
                dt_full, bm_f, cm_f, xs_p = (
                    torch.nn.functional.pad(t, (0, 0, 0, pad))
                    for t in (dt_full, bm_f, cm_f, xs_f))
            else:
                xs_p = xs_f
            # (chunk, B, ·) views: the scan runs along dim 0
            dt_c, b_c, c_c, x_c = (t.transpose(0, 1) for t in
                                   (dt_full, bm_f, cm_f, xs_p))
            h = torch.zeros((b, din, n), dtype=f32, device=x.device)
            y = torch.empty((n_chunks * chunk, b, din), dtype=f32,
                            device=x.device)
            blk = max(1, min(din, SCAN_ELEMS // (chunk * b * n)))
            for c0 in range(0, n_chunks * chunk, chunk):
                t = slice(c0, c0 + chunk)
                h_next = torch.empty_like(h)
                for d0 in range(0, din, blk):
                    d = slice(d0, d0 + blk)
                    dtc = dt_c[t, :, d, None]                  # (L,B,blk,1)
                    da = torch.exp(dtc * a[d])
                    dbx = dtc * b_c[t, :, None, :] * x_c[t, :, d, None]
                    # fold the carried state into the first step
                    dbx[0] = dbx[0] + da[0] * h[:, d]
                    _, hs = associative_scan(da, dbx)
                    y[t, :, d] = torch.einsum("lbdn,lbn->lbd", hs, c_c[t])
                    h_next[:, d] = hs[-1]
                    del da, dbx, hs
                h = h_next
            y = y[:s].transpose(0, 1)
            new_cache = ({"conv": new_conv, "ssm": h}
                         if mode == "prefill" else None)

        y = (y + xs_f * self.d_skip).to(dt_)
        y = y * torch.nn.functional.silu(z)
        return y @ self.out_proj.to(dt_), new_cache


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: torch.device) -> Cache:
    din, _, n, w = dims(cfg)
    return {"conv": torch.zeros((batch, w - 1, din), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, din, n), dtype=torch.float32,
                               device=device)}
