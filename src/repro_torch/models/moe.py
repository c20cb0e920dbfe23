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

On a mesh of ranks (a bound ``sharding.axes.GroupMesh``) the MoE takes
the reference's dispatch (``moe_ffn``): expert parallel over ``model``
when it divides the expert count (``_moe_ffn_ep_shardmap``), else the
expert-internal TP fallback (``_MOE_TP_RULES``, the einsum path over
local ``ff`` columns).  Either way each rank packs buckets from its own
``model``-replicated rows, runs its share of the expert work and joins
ONE ``model`` all-reduce; the dispatch input and the gates enter through
``copy_to_axis`` (their gradients are partial per rank), routing runs
replicated.  The EP path's metrics are means over the DP axes of each
rank's own — a different quantity from the einsum path's global means,
as in the reference — and a decode-shaped input groups the *local*
batch.  The TP fallback keeps the einsum path's global metrics, and
groups a decode-shaped input over the global batch as the einsum path
does: the DP ranks' rows are gathered, routed and packed in the global
order, and each rank keeps its own rows (serving; no gradient).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..core import array_ops
from ..sharding import axes as shard_axes
from ..sharding import partition
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


def _top_k(xn: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """→ (router logits, gates, normalized top-k gates, top-k ids)."""
    k = cfg.experts_per_token
    logits = router_logits(xn, router, cfg)
    gates = torch.softmax(logits, dim=-1)
    # a stable descending sort: equal gates go to the lower index first,
    # as jax.lax.top_k breaks ties
    top_g, top_i = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_g, top_i = top_g[..., :k], top_i[..., :k]
    top_g = top_g / torch.clamp(top_g.sum(-1, keepdim=True), min=1e-9)
    return logits, gates, top_g, top_i


def _expert_counts(top_i: torch.Tensor, e: int) -> torch.Tensor:
    """How many of the chosen (token, slot) pairs each expert got."""
    counts = torch.zeros((e,), dtype=torch.float32, device=top_i.device)
    counts.index_add_(0, top_i.reshape(-1),
                      torch.ones(top_i.numel(), device=top_i.device))
    return counts


def routing(xn: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """Router logits → (top-k gates, top-k ids, aux loss, router z-loss),
    all in float32."""
    e = router.shape[1]
    k = cfg.experts_per_token
    logits, gates, top_g, top_i = _top_k(xn, router, cfg)
    me = gates.reshape(-1, e).mean(dim=0)
    ce = _expert_counts(top_i, e) / (top_i.numel() // k) / k
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
        self.fs = fs
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
        mesh = shard_axes.group_mesh()
        if mesh is not None:
            return self._forward_mesh(x, mesh)
        cfg = self.cfg
        b, s, d = x.shape
        xn = self.norm(x, cfg.norm_eps)
        top_g, top_i, aux, router_z = routing(xn, self.router, cfg)
        y, dropped = self._experts(xn, top_g, top_i, self.router.shape[1])
        if self.shared is not None:
            y = y + self.shared(xn)
        return y, {"moe_aux_loss": aux, "router_z_loss": router_z,
                   "moe_dropped_frac": dropped}

    def _experts(self, xn, top_g, top_i, e: int, lo: int = 0, hi=None):
        """Group, pack, run experts ``lo..hi`` (this module's stacked
        weights hold those) and combine → (y, dropped); a row of another
        expert adds zero."""
        cfg = self.cfg
        b, s, d = xn.shape
        dt = xn.dtype
        k = cfg.experts_per_token
        hi = e if hi is None else hi
        wg, wi, wo = self.w_gate, self.w_in, self.w_out
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

        mine = buf[:, lo:hi]
        hidden = (torch.nn.functional.silu(
            torch.einsum("gecd,edf->gecf", mine, wg.to(dt)))
            * torch.einsum("gecd,edf->gecf", mine, wi.to(dt)))
        out = torch.einsum("gecf,efd->gecd", hidden, wo.to(dt))
        out = out.reshape(g, (hi - lo) * cap, d)
        if hi - lo != e:
            out = torch.cat([out.new_zeros((g, lo * cap, d)), out,
                             out.new_zeros((g, (e - hi) * cap, d))], dim=1)

        # combine: each sorted row back to its token, weighted
        safe = torch.clamp(slot, max=e * cap - 1)
        y_tok = torch.gather(out, 1, safe[..., None].expand(g, tg * k, d))
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
        return y.reshape(b, s, d), dropped

    # -- on a mesh of ranks -------------------------------------------------
    def _forward_mesh(self, x: torch.Tensor, mesh):
        """The reference's ``moe_ffn`` dispatch on this rank's rows: EP
        when ``model`` divides the experts, else the TP fallback."""
        cfg = self.cfg
        e = self.router.shape[1]
        m = mesh.get("model", 1)
        dp = shard_axes.batch_axes()
        n = shard_axes.axes_size(mesh, dp)
        xn = self.norm(x, cfg.norm_eps)
        xin = array_ops.copy_to_axis(xn, mesh, "model")
        ep = "model" in mesh and e % m == 0
        one_group = not ep and x.shape[1] < 64 and n > 1
        if ep:
            top_g, top_i, aux, router_z = routing(xn, self.router, cfg)
            gates = array_ops.copy_to_axis(top_g, mesh, "model")
            lo = mesh.coords.get("model", 0) * (e // m)
            y, dropped = self._experts(xin, gates, top_i, e, lo,
                                       lo + e // m)
        elif one_group:
            # a decode-shaped batch is ONE group over the global batch, as
            # the reference's einsum path sees it: every DP rank's rows,
            # routed and packed in the global order; this rank keeps its
            # own rows of the combine
            if torch.is_grad_enabled():
                raise NotImplementedError(
                    "training a batch of < 64-token rows through the "
                    "MoE's expert-TP fallback across data-parallel ranks "
                    "is not ported (ROADMAP Queue 1 item 11b)")
            rows = xn
            for a in reversed(dp):
                rows = array_ops.axis_all_gather(rows, mesh, a)
            top_g, top_i, aux, router_z = routing(rows, self.router, cfg)
            y, dropped = self._experts(rows, top_g, top_i, e)
            y = y.narrow(0, partition.block_index(dp, mesh) * x.shape[0],
                         x.shape[0])
        else:
            top_g, top_i, aux, router_z = _global_routing(xn, self.router,
                                                          cfg, mesh, dp)
            gates = array_ops.copy_to_axis(top_g, mesh, "model")
            y, dropped = self._experts(xin, gates, top_i, e)
        # the routed output is partial over model (an EP slice, or the
        # fallback's ff columns) unless the expert weights are whole
        # there; shared experts likewise
        partial, whole = [], []
        (partial if ep or self.w_gate.shape[-1] != cfg.expert_d_ff
         else whole).append(y)
        if self.shared is not None:
            sh = self.shared
            if sh.w_gate.shape[1] != sh.fs:     # ff split over model
                partial.append(sh(xin))
            else:
                whole.append(sh(xn))
        y = None
        if partial:
            y = partial[0] + partial[1] if len(partial) == 2 else partial[0]
            y = array_ops.reduce_from_axis(y, mesh, "model")
        for t in whole:
            y = t if y is None else y + t
        metrics = {"moe_aux_loss": aux, "router_z_loss": router_z,
                   "moe_dropped_frac": dropped}
        if n > 1 and not one_group:
            # EP: each rank's own metrics, meaned over the DP axes; the
            # fallback's aux and z are global already, its dropped share a
            # mean of equal groups
            keys = METRICS if ep else ("moe_dropped_frac",)
            for key in keys:
                v = metrics[key]
                for a in dp:
                    v = array_ops.reduce_from_axis(v, mesh, a)
                metrics[key] = v / n
        return y, metrics


def _global_routing(xn, router, cfg: ModelConfig, mesh, dp):
    """:func:`routing` of the einsum path over every DP rank's rows: the
    gates, expert counts and squared log-normalizers summed over the DP
    axes (each rank's rows the same count), so aux and z are the global
    batch's."""
    e = router.shape[1]
    k = cfg.experts_per_token
    logits, gates, top_g, top_i = _top_k(xn, router, cfg)
    g_sum = gates.reshape(-1, e).sum(dim=0)
    counts = _expert_counts(top_i, e)
    z_sum = torch.sum(torch.square(torch.logsumexp(logits, dim=-1)))
    for a in dp:
        g_sum = array_ops.reduce_from_axis(g_sum, mesh, a)
        z_sum = array_ops.reduce_from_axis(z_sum, mesh, a)
        counts = array_ops.axis_all_reduce(counts, mesh, a)
    total = gates.reshape(-1, e).shape[0] * shard_axes.axes_size(mesh, dp)
    aux = torch.sum((g_sum / total) * (counts / total / k)) * cfg.n_experts
    return top_g, top_i, aux, z_sum / total
