"""xLSTM mixers: chunkwise-parallel mLSTM and recurrent sLSTM.

Ports ``src/repro/models/xlstm.py`` (stabilized gating of Beck et al.,
arXiv:2405.04517).  mLSTM prefill splits the sequence into chunks of
``cfg.mlstm_chunk``: inside a chunk the stabilized closed form is two
matrix products (q·kᵀ weighted by the gate-decay matrix, then ·v), and a
loop over chunks carries the ``(C, n, m)`` state.  The last chunk is
padded as in the reference, with input-gate logits of ``-1e30`` (``-inf``
would give ``-inf - -inf = NaN``).  Decode is the one-step recurrence.

sLSTM keeps the scalar-memory recurrence with exponential gating and a
recurrent gate path, a true loop over time, in float32.

The gate parameters the reference uses in float32 without a cast
(mLSTM's ``w_gates``/``b_gates``, sLSTM's ``w_h``/``b``) stay float32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from .layers import Cache, RMSNorm, dense_param, f32_param

F = torch.nn.functional
NEG = -1e30


def dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    din = cfg.ssm_expand * cfg.d_model
    nh = cfg.n_heads
    return din, nh, din // nh


# ===========================================================================
# mLSTM
# ===========================================================================
def mlstm_chunk(q, k, v, i_log, f_log, state):
    """One chunk of stabilized mLSTM. q,k,v (B,H,L,D); gates (B,H,L)."""
    l, dh = q.shape[2], q.shape[3]
    c0, n0, m0 = state                      # (B,H,D,D), (B,H,D), (B,H)
    b_cum = torch.cumsum(f_log, dim=-1)     # inclusive sum of log f
    # intra-chunk log weights: w[t,s] = b_t - b_s + i_s  (s <= t)
    w_log = b_cum[..., :, None] - b_cum[..., None, :] + i_log[..., None, :]
    tri = torch.tril(torch.ones((l, l), dtype=torch.bool, device=q.device))
    w_log = torch.where(tri, w_log, -torch.inf)
    m_intra = torch.amax(w_log, dim=-1)                       # (B,H,L)
    m_inter = b_cum + m0[..., None]
    m_t = torch.maximum(m_intra, m_inter)
    d_mat = torch.exp(w_log - m_t[..., None])                 # (B,H,L,L)
    inter_w = torch.exp(m_inter - m_t)                        # (B,H,L)

    scale = dh ** -0.5
    qk = torch.einsum("bhld,bhsd->bhls", q, k) * scale
    num = (torch.einsum("bhls,bhsd->bhld", qk * d_mat, v)
           + inter_w[..., None] * torch.einsum("bhld,bhde->bhle", q * scale,
                                               c0))
    den = (torch.sum(qk * d_mat, dim=-1)
           + inter_w * torch.einsum("bhld,bhd->bhl", q * scale, n0))
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None]

    # state for the next chunk
    b_tot = b_cum[..., -1]                                     # (B,H)
    m_state_intra = torch.amax(b_tot[..., None] - b_cum + i_log, dim=-1)
    m_next = torch.maximum(b_tot + m0, m_state_intra)
    kv_w = torch.exp(b_tot[..., None] - b_cum + i_log - m_next[..., None])
    decay = torch.exp(b_tot + m0 - m_next)
    c_next = (decay[..., None, None] * c0
              + torch.einsum("bhs,bhsd,bhse->bhde", kv_w, k, v))
    n_next = decay[..., None] * n0 + torch.einsum("bhs,bhsd->bhd", kv_w, k)
    return h, (c_next, n_next, m_next)


class MLSTM(nn.Module):
    """Pre-norm mLSTM block; ``forward`` returns (residual_delta,
    new_cache)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 dtype: torch.dtype, device: torch.device):
        super().__init__()
        d = cfg.d_model
        din, nh, _ = dims(cfg)
        self.cfg = cfg

        def dense(shape, fan_in=None):
            return dense_param(shape, generator, dtype, device, fan_in)

        self.norm = RMSNorm(d, dtype, device)
        self.w_up = dense((d, 2 * din))
        self.wq = dense((din, din))
        self.wk = dense((din, din))
        self.wv = dense((din, din))
        self.w_gates = dense_param((din, 2 * nh), generator, torch.float32,
                                   device)
        # input gate bias 0, forget gate bias open (3 to 6)
        self.b_gates = f32_param(torch.cat([
            torch.zeros(nh, device=device),
            torch.linspace(3.0, 6.0, nh, device=device)]))
        self.out_norm = RMSNorm(din, dtype, device)
        self.w_down = dense((din, d), fan_in=din)

    def forward(self, x: torch.Tensor, *, mode: str = "train",
                cache: Optional[Cache] = None
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
        cfg = self.cfg
        b, s, d = x.shape
        din, nh, dh = dims(cfg)
        dt = x.dtype
        f32 = torch.float32
        xn = self.norm(x, cfg.norm_eps)
        up = xn @ self.w_up.to(dt)
        a, z = up[..., :din], up[..., din:]

        def heads(t):
            return t.reshape(b, -1, nh, dh).transpose(1, 2).to(f32)

        q = heads(a @ self.wq.to(dt))
        k = heads(a @ self.wk.to(dt))
        v = heads(a @ self.wv.to(dt))
        gates = a.to(f32) @ self.w_gates + self.b_gates       # (B,S,2H)
        i_log = gates[..., :nh].transpose(1, 2)               # (B,H,S)
        f_log = F.logsigmoid(gates[..., nh:]).transpose(1, 2)

        if mode == "decode":
            c0, n0, m0 = cache["c"], cache["n"], cache["m"]
            i1, f1 = i_log[..., 0], f_log[..., 0]
            m_t = torch.maximum(f1 + m0, i1)
            ip = torch.exp(i1 - m_t)
            fp = torch.exp(f1 + m0 - m_t)
            c1 = fp[..., None, None] * c0 + ip[..., None, None] * (
                k[:, :, 0, :, None] * v[:, :, 0, None, :])
            n1 = fp[..., None] * n0 + ip[..., None] * k[:, :, 0]
            qs = q[:, :, 0] * dh ** -0.5
            num = torch.einsum("bhd,bhde->bhe", qs, c1)
            den = torch.maximum(
                torch.abs(torch.einsum("bhd,bhd->bh", qs, n1)),
                torch.exp(-m_t))
            h = (num / den[..., None])[:, :, None]            # (B,H,1,D)
            new_cache = {"c": c1, "n": n1, "m": m_t}
        else:
            chunk = min(cfg.mlstm_chunk, s)
            n_chunks = -(-s // chunk)
            pad = n_chunks * chunk - s
            if pad:
                q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
                i_log = F.pad(i_log, (0, pad), value=NEG)
                f_log = F.pad(f_log, (0, pad))
            state = (torch.zeros((b, nh, dh, dh), dtype=f32, device=x.device),
                     torch.zeros((b, nh, dh), dtype=f32, device=x.device),
                     torch.full((b, nh), NEG, dtype=f32, device=x.device))
            hs = []
            for c0 in range(0, n_chunks * chunk, chunk):
                sl = slice(c0, c0 + chunk)
                h_c, state = mlstm_chunk(q[:, :, sl], k[:, :, sl],
                                         v[:, :, sl], i_log[..., sl],
                                         f_log[..., sl], state)
                hs.append(h_c)
            h = torch.cat(hs, dim=2)[:, :, :s]
            new_cache = ({"c": state[0], "n": state[1], "m": state[2]}
                         if mode == "prefill" else None)

        h = h.transpose(1, 2).reshape(b, -1, din).to(dt)
        h = self.out_norm(h, cfg.norm_eps)
        return (h * F.silu(z)) @ self.w_down.to(dt), new_cache


def init_mlstm_cache(cfg: ModelConfig, batch: int,
                     device: torch.device) -> Cache:
    _, nh, dh = dims(cfg)
    f32 = torch.float32
    return {"c": torch.zeros((batch, nh, dh, dh), dtype=f32, device=device),
            "n": torch.zeros((batch, nh, dh), dtype=f32, device=device),
            "m": torch.full((batch, nh), NEG, dtype=f32, device=device)}


# ===========================================================================
# sLSTM
# ===========================================================================
class SLSTM(nn.Module):
    """Pre-norm sLSTM block; ``forward`` returns (residual_delta,
    new_cache)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 dtype: torch.dtype, device: torch.device):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.norm = RMSNorm(d, dtype, device)
        self.w_x = dense_param((d, 4 * d), generator, dtype, device)
        # the recurrent path runs in float32: h @ w_h + b
        self.w_h = dense_param((d, 4 * d), generator, torch.float32, device)
        self.b = f32_param(torch.cat([
            torch.zeros(d, device=device), torch.full((d,), 3.0,
                                                      device=device),
            torch.zeros(2 * d, device=device)]))
        self.out_norm = RMSNorm(d, dtype, device)
        self.w_down = dense_param((d, d), generator, dtype, device)

    def step(self, carry, xw):
        """carry (h, c, n, m), each (B,D); xw: W_x·x_t (B,4D)."""
        h, c, n, m = carry
        d = h.shape[-1]
        pre = xw + h @ self.w_h + self.b
        i_log = pre[..., :d]
        f_log = F.logsigmoid(pre[..., d:2 * d])
        z = torch.tanh(pre[..., 2 * d:3 * d])
        o = torch.sigmoid(pre[..., 3 * d:])
        m_new = torch.maximum(f_log + m, i_log)
        ip = torch.exp(i_log - m_new)
        fp = torch.exp(f_log + m - m_new)
        c_new = fp * c + ip * z
        n_new = fp * n + ip
        # jnp.maximum, not clamp: n_new is exactly 1 at the first step,
        # where the maximum's gradient splits between its arguments
        h_new = o * c_new / torch.maximum(n_new, n_new.new_ones(()))
        return h_new, c_new, n_new, m_new

    def forward(self, x: torch.Tensor, *, mode: str = "train",
                cache: Optional[Cache] = None
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
        cfg = self.cfg
        b, s, d = x.shape
        dt = x.dtype
        xn = self.norm(x, cfg.norm_eps)
        xw = (xn @ self.w_x.to(dt)).to(torch.float32)          # (B,S,4D)

        if cache is not None and mode == "decode":
            carry = (cache["h"], cache["c"], cache["n"], cache["m"])
        else:
            zeros = torch.zeros((b, d), dtype=torch.float32, device=x.device)
            carry = (zeros, zeros, zeros, torch.full_like(zeros, NEG))
        hs = []
        for t in range(s):
            carry = self.step(carry, xw[:, t])
            hs.append(carry[0])
        h = torch.stack(hs, dim=1).to(dt)                       # (B,S,D)
        new_cache = None
        if mode in ("prefill", "decode"):
            new_cache = dict(zip(("h", "c", "n", "m"), carry))
        h = self.out_norm(h, cfg.norm_eps)
        return h @ self.w_down.to(dt), new_cache


def init_slstm_cache(cfg: ModelConfig, batch: int,
                     device: torch.device) -> Cache:
    zeros = torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                        device=device)
    return {"h": zeros, "c": zeros.clone(), "n": zeros.clone(),
            "m": torch.full_like(zeros, NEG)}
