"""Mixture-of-Experts FFN with shuffle-style token dispatch.

Ports the einsum path of ``src/repro/models/moe.py`` (``_moe_ffn_einsum``):
routing a token to its experts is the paper's shuffle applied to tensors.
Top-k picks each token's destination experts, a stable sort by expert id
packs the rows into a static ``(groups, E, capacity, d)`` buffer, every
expert runs over its bucket, and the combine gathers each row back and
sums a token's k weighted rows.  Rows beyond an expert's capacity are
dropped (weight zero) and counted, the overflow contract of the table
shuffle.

Groups are the batch rows when a sequence has 64 tokens or more, else the
whole batch (decode).  The semantics are exact: a stable sort, ``left``
ranks, slot ``E * cap`` for a dropped row, top-k ties to the lower index.
The combine sums each token's k rows in the order the reference's
scatter-add applies them (ascending expert id), so it is the same on
every run; an atomic ``index_add_`` on the card would not be.

The reference's expert-parallel ``shard_map`` path needs a device mesh and
waits for shards across cards.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from .layers import RMSNorm, dense_param

METRICS = ("moe_aux_loss", "router_z_loss", "moe_dropped_frac")


def padded_experts(cfg: ModelConfig, model_axis: int = 16) -> int:
    """Expert count padded so expert parallelism divides the model axis
    (dead experts, as the reference pads them)."""
    e = cfg.n_experts
    if e % model_axis == 0 or model_axis % e == 0:
        return e
    return -(-e // model_axis) * model_axis


def capacity(tokens_per_group: int, k: int, e: int, factor: float) -> int:
    return max(4, math.ceil(tokens_per_group * k / e * factor))


def router_logits(xn: torch.Tensor, router: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """float32 router logits, the padded (dead) experts masked to -1e30."""
    e = router.shape[1]
    logits = xn.to(torch.float32) @ router
    if e > cfg.n_experts:
        dead = torch.arange(e, device=xn.device) >= cfg.n_experts
        logits = torch.where(dead, -1e30, logits)
    return logits


def routing(xn: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """Router logits → (top-k gates, top-k ids, aux loss, router z-loss),
    all in float32."""
    e = router.shape[1]
    k = cfg.experts_per_token
    logits = router_logits(xn, router, cfg)
    gates = torch.softmax(logits, dim=-1)
    # a stable descending sort: equal gates go to the lower index first,
    # as jax.lax.top_k breaks ties
    top_g, top_i = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_g, top_i = top_g[..., :k], top_i[..., :k]
    top_g = top_g / torch.clamp(top_g.sum(-1, keepdim=True), min=1e-9)
    me = gates.reshape(-1, e).mean(dim=0)
    counts = torch.zeros((e,), dtype=torch.float32, device=xn.device)
    counts.index_add_(0, top_i.reshape(-1),
                      torch.ones(top_i.numel(), device=xn.device))
    ce = counts / (top_i.numel() // k) / k
    aux = torch.sum(me * ce) * cfg.n_experts
    router_z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return top_g, top_i, aux, router_z


def pack(xg: torch.Tensor, ig: torch.Tensor, gg: torch.Tensor, e: int,
         cap: int):
    """Sort-by-destination bucket pack (the shuffle's local step).

    xg (g, tg, d); ig/gg (g, tg, k) → (buf (g, e, cap, d), slot, tok_idx,
    g_tok, ok), each of the last four (g, tg*k) in sorted order; ``slot``
    is ``e * cap`` for a row over its expert's capacity."""
    g, tg, d = xg.shape
    k = ig.shape[-1]
    flat_e = ig.reshape(g, tg * k)
    flat_g = gg.reshape(g, tg * k).to(xg.dtype)
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(tg * k, device=xg.device)[None] - first
    ok = rank < cap
    slot = torch.where(ok, sorted_e * cap + rank, e * cap)
    tok_idx = order // k
    x_tok = torch.gather(xg, 1, tok_idx[..., None].expand(g, tg * k, d))
    g_tok = torch.gather(flat_g, 1, order)
    # one spare row takes the dropped rows' writes, then is cut off
    buf = xg.new_zeros((g, e * cap + 1, d))
    rows = torch.arange(g, device=xg.device)[:, None]
    buf[rows, slot] = x_tok
    return buf[:, :e * cap].reshape(g, e, cap, d), slot, tok_idx, g_tok, ok


class SharedExperts(nn.Module):
    def __init__(self, d: int, fs: int, generator: torch.Generator,
                 dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.w_gate = dense_param((d, fs), generator, dtype, device)
        self.w_in = dense_param((d, fs), generator, dtype, device)
        self.w_out = dense_param((fs, d), generator, dtype, device, fan_in=fs)

    def forward(self, xn: torch.Tensor) -> torch.Tensor:
        dt = xn.dtype
        g = torch.nn.functional.silu(xn @ self.w_gate.to(dt))
        return (g * (xn @ self.w_in.to(dt))) @ self.w_out.to(dt)


class MoE(nn.Module):
    """Routed SwiGLU experts (stacked ``(E, d, f)`` weights) plus optional
    shared experts; ``forward`` returns (y, metrics)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 dtype: torch.dtype, device: torch.device):
        super().__init__()
        d, f = cfg.d_model, cfg.expert_d_ff
        e = padded_experts(cfg)
        self.cfg = cfg
        self.norm = RMSNorm(d, dtype, device)
        # the reference routes in float32 with a float32 router
        self.router = dense_param((d, e), generator, torch.float32, device)
        # the reference's scale: fan-in from the leading (expert) axis
        self.w_gate = dense_param((e, d, f), generator, dtype, device)
        self.w_in = dense_param((e, d, f), generator, dtype, device)
        self.w_out = dense_param((e, f, d), generator, dtype, device,
                                 fan_in=f)
        self.shared = (SharedExperts(d, cfg.n_shared_experts * f, generator,
                                     dtype, device)
                       if cfg.n_shared_experts else None)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        b, s, d = x.shape
        dt = x.dtype
        e = self.router.shape[1]
        k = cfg.experts_per_token
        xn = self.norm(x, cfg.norm_eps)
        top_g, top_i, aux, router_z = routing(xn, self.router, cfg)

        # groups: a batch row when sequences are long, the whole batch when
        # decoding
        if s >= 64:
            g, tg = b, s
        else:
            g, tg = 1, b * s
        xg = xn.reshape(g, tg, d)
        ig, gg = top_i.reshape(g, tg, k), top_g.reshape(g, tg, k)
        cap = capacity(tg, k, e, cfg.capacity_factor)
        buf, slot, tok_idx, g_tok, ok = pack(xg, ig, gg, e, cap)
        dropped = 1.0 - ok.to(torch.float32).mean()

        hidden = (torch.nn.functional.silu(
            torch.einsum("gecd,edf->gecf", buf, self.w_gate.to(dt)))
            * torch.einsum("gecd,edf->gecf", buf, self.w_in.to(dt)))
        out = torch.einsum("gecf,efd->gecd", hidden, self.w_out.to(dt))

        # combine: each sorted row back to its token, weighted
        safe = torch.clamp(slot, max=e * cap - 1)
        y_tok = torch.gather(out.reshape(g, e * cap, d), 1,
                             safe[..., None].expand(g, tg * k, d))
        y_tok = torch.where(ok[..., None], y_tok, 0.0) * g_tok[..., None]
        # sorted position of each (token, choice): the rows of a token in
        # ascending expert id, the order the reference's scatter-add
        # applies them
        pos = torch.argsort(tok_idx, dim=1, stable=True)
        rows = torch.gather(y_tok, 1, pos[..., None].expand(g, tg * k, d))
        rows = rows.reshape(g, tg, k, d)
        y = rows[:, :, 0]
        for j in range(1, k):
            y = y + rows[:, :, j]
        y = y.reshape(b, s, d)
        if self.shared is not None:
            y = y + self.shared(xn)
        return y, {"moe_aux_loss": aux, "router_z_loss": router_z,
                   "moe_dropped_frac": dropped}
