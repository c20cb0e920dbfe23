"""Core tensor-operator layers: norms, RoPE, GQA attention with a KV cache
(self- and cross-attention), MLA, SwiGLU MLP.

Ports ``src/repro/models/layers.py``.  Each block is an ``nn.Module``
holding the reference's parameters under the reference's names and layouts
(``x @ w`` with ``w`` stored ``(in, out)``), stored in the dtype the model
is built with: float32 masters for training (the reference's
``param_dtype``), or the compute dtype for serving.  Every use casts to
the activations' dtype (``params["wq"].astype(dt)`` in the reference), so
both storages round the same way.  Leaves the reference uses in float32
without a cast are stored in float32 (:func:`f32_param`).  Parameters are
made with ``requires_grad=False``; a trainer turns it on for its masters.

Attention dispatch: in prefill the flash kernel
(``repro_torch.kernels.flash_attention``) runs GQA self-attention by
default on the card — the CUDA kernel for CUDA tensors, its plain version
for CPU tensors when a config asks for it (``use_flash=True``); decode,
training, cross-attention and MLA use the plain masked-softmax
:func:`attend`, whose query chunks are rematerialized under autograd as
the reference's ``lax.map(jax.checkpoint(...))`` is.  Caches are
updated in place: the decode step writes the new K/V (or MLA latent)
into the tensors the prefill built instead of copying the cache, and
returns the same tensors.

On a mesh of ranks (a bound ``sharding.axes.GroupMesh``) the GQA
self-attention and the SwiGLU MLP are tensor parallel over ``model``
(Megatron's pair: :func:`array_ops.copy_to_axis` on the input, one
:func:`array_ops.reduce_from_axis` all-reduce after ``wo`` / ``w_out``).
The reference's rules shard a *dimension* and leave GSPMD to reshard;
the port's leaves are stored as ``param_specs`` says, and the layer
decides from their blocks: attention keeps its local heads only when
every projection splits on head boundaries (q and kv head counts divide
the axis), else it gathers each split projection whole over ``model``
and computes replicated — smollm's ``wq`` is ``(960, 15 * 64)``, whose
960 columns split in two but whose 15 heads do not.  In serving the
prefill runs the flash kernel on the rank's heads (all of them when
replicated), and the KV cache is placed as ``cache_specs`` says: the
local heads, else a slice of the cache length (:func:`attend_sharded`
merges the ranks' softmax statistics in decode), else whole.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core import array_ops
from ..kernels.flash_attention import ops as flash_ops
from ..sharding import axes as shard_axes

Cache = Dict[str, object]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def dense_param(shape, generator: torch.Generator, dtype: torch.dtype,
                device: torch.device, fan_in: Optional[int] = None):
    """Normal / sqrt(fan_in) in float32, stored in ``dtype`` (the
    reference's ``_dense_init``; other random numbers from the seed)."""
    fan_in = fan_in or shape[0]
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32) / math.sqrt(fan_in)
    return nn.Parameter(w.to(dtype), requires_grad=False)


def f32_param(w: torch.Tensor) -> nn.Parameter:
    """A leaf the reference uses in float32 without a cast (router, gate
    and decay parameters): kept in float32 whatever the compute dtype."""
    return nn.Parameter(w.to(torch.float32), requires_grad=False)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rms_norm(scale: torch.Tensor, x: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with float32 *accumulation* of products taken in ``x``'s
    dtype, as the reference reduces ``jnp.square(x)`` with ``dtype=f32``."""
    dt = x.dtype
    var = torch.mean(torch.square(x), dim=-1, keepdim=True,
                     dtype=torch.float32)
    inv = torch.rsqrt(var + eps)
    return (x * inv.to(dt)) * scale.to(dt)


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                                  requires_grad=False)

    def forward(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        return rms_norm(self.scale, x, eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10_000.0) -> torch.Tensor:
    """x (..., S, D) with D even; positions (..., S) absolute indices.

    The rotation runs in float32 (``x`` times the float32 tables promotes)
    and the result is cast back to ``x``'s dtype.
    """
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    angles = positions[..., None].to(torch.float32) * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


# ---------------------------------------------------------------------------
# masked attention core (plain path; same semantics as the flash kernel)
# ---------------------------------------------------------------------------
def _mask_for_chunk(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
                    window: Optional[int]) -> torch.Tensor:
    """(S, L) visibility from absolute positions (kv_pos == -1 → empty)."""
    qp = q_pos[:, None]
    kp = kv_pos[None, :]
    allow = kp >= 0
    if causal:
        allow = allow & (kp <= qp)
    if window is not None:
        allow = allow & ((qp - kp) < window)
    return allow


def _kv_f32(q, k, v, sm_scale):
    """K and V repeated up to q's heads, in float32, and the scale."""
    hq, hkv = q.shape[1], k.shape[1]
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    if hkv != hq:
        rep = hq // hkv
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    return k.to(torch.float32), v.to(torch.float32), scale


def _softmax_parts(qc, kf, vf, qp, kv_pos, causal, window, scale):
    """One query chunk's masked softmax, unnormalized: (``sum_l p v``, the
    row max ``m``, ``sum_l p``) in float32, ``p = exp(score - m)`` over
    the visible keys (``m`` = -1e30 where none is)."""
    scores = torch.einsum("bhsd,bhld->bhsl", qc.to(torch.float32), kf) * scale
    allow = _mask_for_chunk(qp, kv_pos, causal, window)
    scores = torch.where(allow, scores, -1e30)
    # the row max carries no gradient (the reference's stop_gradient)
    m = torch.amax(scores, dim=-1, keepdim=True).detach()
    p = torch.exp(scores - m)
    p = torch.where(allow, p, 0.0)
    denom = torch.sum(p, dim=-1, keepdim=True)
    return torch.einsum("bhsl,bhld->bhsd", p, vf), m, denom


def attend_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis: str, *, q_pos: torch.Tensor, kv_pos: torch.Tensor,
                   causal: bool = True,
                   window: Optional[int] = None) -> torch.Tensor:
    """:func:`attend` over keys split along ``axis``: ``k``, ``v`` and
    ``kv_pos`` are this rank's slice of the cache length; each rank's
    softmax statistics are merged (``array_ops.merge_softmax``), so every
    rank gets the attention over the whole cache.  One query chunk (a
    decode step's); no gradient."""
    kf, vf, scale = _kv_f32(q, k, v, None)
    o, m, denom = _softmax_parts(q, kf, vf, q_pos, kv_pos, causal, window,
                                 scale)
    return array_ops.merge_softmax(o, m, denom, mesh, axis).to(q.dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool = True,
           window: Optional[int] = None, sm_scale: Optional[float] = None,
           q_chunk: int = 256) -> torch.Tensor:
    """Masked softmax attention, over query chunks of ``q_chunk`` rows.

    q (B,Hq,S,D); k (B,Hkv,L,D); v (B,Hkv,L,Dv) → (B,Hq,S,Dv); q_pos (S,),
    kv_pos (L,) absolute positions (-1 = empty cache slot).  KV heads are
    repeated up to Hq, as in the reference.  The chunks bound the float32
    score tile to ``(B, Hq, q_chunk, L)``; each row's arithmetic is the
    same whatever the chunk (the reference pads the last chunk, which
    changes no real row).  Under autograd each chunk of a longer query is
    rematerialized in the backward pass, so one chunk's score tile is
    alive at a time.
    """
    kf, vf, scale = _kv_f32(q, k, v, sm_scale)

    def one_chunk(qc, qp):
        o, _, denom = _softmax_parts(qc, kf, vf, qp, kv_pos, causal, window,
                                     scale)
        return (o / torch.clamp(denom, min=1e-30)).to(q.dtype)

    s = q.shape[2]
    if s <= q_chunk:
        return one_chunk(q, q_pos)
    if torch.is_grad_enabled():
        def run(qc, qp):
            return checkpoint(one_chunk, qc, qp, use_reentrant=False)
    else:
        run = one_chunk
    return torch.cat([run(q[:, :, i:i + q_chunk], q_pos[i:i + q_chunk])
                      for i in range(0, s, q_chunk)], dim=2)


def _use_flash_kernel(cfg: ModelConfig, device: torch.device) -> bool:
    """The flash kernel for self-attention: on the card by default, opt-in
    on the CPU (its plain version; tests force it)."""
    if cfg.use_flash is not None:
        return cfg.use_flash
    return device.type == "cuda"


# ---------------------------------------------------------------------------
# int8 KV quantization (halves the resident cache and its reads)
# ---------------------------------------------------------------------------
def kv_quantize(x: torch.Tensor):
    """(B,H,L,D) → (int8 values, f32 per-vector scales (B,H,L,1))."""
    xf = x.to(torch.float32)
    scale = torch.amax(torch.abs(xf), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def _write_slots(buf: torch.Tensor, new: torch.Tensor, slot: int,
                 dim: int, length: Optional[int] = None, lo: int = 0) -> None:
    """``cache[..., slot:slot+n, ...] = new`` in place along ``dim``, with
    the start clamped so the update fits the cache's ``length`` slots
    (``buf``'s own by default), as ``dynamic_update_slice`` does.  ``buf``
    holds slots ``lo ..`` of them (a rank's slice of a sequence-sharded
    cache) and takes the part of the update that falls there."""
    n = new.shape[dim]
    length = buf.shape[dim] if length is None else length
    start = min(max(slot, 0), length - n)
    a, b = max(start, lo), min(start + n, lo + buf.shape[dim])
    if a < b:
        buf.narrow(dim, a - lo, b - a).copy_(new.narrow(dim, a - start,
                                                       b - a))


def _build_prefill_cache(cfg: ModelConfig, k, v, positions,
                         cache_len: int) -> Cache:
    """Size a decode cache of ``cache_len`` slots from prefill K/V.

    Sliding-window archs keep a ring of the last ``window`` entries; others
    right-pad to the full decode length.  ``pos`` tracks the absolute
    position per slot (-1 = empty) so decode masking is position-exact;
    ``cursor`` (a Python int) is the next write slot.
    """
    b, hk, s, dh = k.shape
    positions = positions.to(torch.int32)
    if cfg.window is not None and cache_len <= cfg.window:
        w = cache_len
        if s >= w:
            # last w entries, placed at slot = pos % w (ring order)
            src = (s - w) + torch.remainder(
                torch.arange(w, device=k.device) - s, w)
            ck, cv = k[:, :, src], v[:, :, src]
            cpos = positions[src]
        else:
            ck, cv, cpos = _pad_cache(k, v, positions, w)
        cursor = s % w
    else:
        ck, cv, cpos = _pad_cache(k, v, positions, cache_len)
        cursor = s
    out: Cache = {"pos": cpos, "cursor": cursor}
    if cfg.kv_quant:
        out["k"], out["k_s"] = kv_quantize(ck)
        out["v"], out["v_s"] = kv_quantize(cv)
    else:
        out["k"], out["v"] = ck, cv
    return out


def _kv_layout(cfg: ModelConfig, mesh, split: bool,
               length: int) -> Optional[str]:
    """How ``sharding/partition.py:cache_specs`` places a layer's KV
    cache of ``length`` slots over ``model``: ``"heads"`` (the attention's
    local heads), ``"seq"`` (a slice of the length: the heads do not
    split) or ``None`` (whole on every rank)."""
    m = mesh.get("model", 1)
    if m == 1:
        return None
    if cfg.n_kv_heads % m == 0:
        if not split:
            raise NotImplementedError(
                f"{cfg.name}: a KV cache split over heads beside an "
                f"attention replicated over model ({cfg.n_heads} query "
                f"heads on {m} ranks) is not ported")
        return "heads"
    return "seq" if length % m == 0 else None


def _seq_block(cache: Cache, mesh) -> Cache:
    """This rank's slice of the length of a whole layer cache (``pos`` and
    ``cursor`` stay whole: they are replicated)."""
    m, c = mesh["model"], mesh.coords["model"]
    out = dict(cache)
    for name in ("k", "v", "k_s", "v_s"):
        if name in cache:
            span = cache[name].shape[2] // m
            out[name] = cache[name].narrow(2, c * span, span).clone()
    return out


def _check_block(k: torch.Tensor, cfg: ModelConfig, layout: Optional[str],
                 length: int) -> None:
    """A cache block's shape against the bound rules' spec for its
    layout (``kv_heads`` or ``kv_seq`` on the split dimension)."""
    heads = "kv_heads" if layout == "heads" else None
    seq = "kv_seq" if layout == "seq" else None
    shard_axes.constrain(k, "batch", heads, seq, None, shape=(
        shard_axes.global_dim(k.shape[0], "batch"), cfg.n_kv_heads, length,
        k.shape[-1]))


def _pad_cache(k, v, positions, length: int):
    """K/V right-padded with zeros to ``length`` slots, ``pos`` with -1."""
    b, hk, s, dh = k.shape
    ck = k.new_zeros((b, hk, length, dh))
    cv = v.new_zeros((b, hk, length, dh))
    cpos = torch.full((length,), -1, dtype=torch.int32, device=k.device)
    ck[:, :, :s] = k
    cv[:, :, :s] = v
    cpos[:s] = positions
    return ck, cv, cpos


# ---------------------------------------------------------------------------
# GQA attention block (SWA + self/cross + KV cache)
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    """Pre-norm GQA attention; ``forward`` returns (residual_delta,
    new_cache).  With ``kv_source`` it is cross-attention: K/V from the
    normed source, no RoPE, no mask but empty slots, no cache."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 dtype: torch.dtype, device: torch.device):
        super().__init__()
        d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.cfg = cfg
        self.wq = dense_param((d, h * dh), generator, dtype, device)
        self.wk = dense_param((d, hk * dh), generator, dtype, device)
        self.wv = dense_param((d, hk * dh), generator, dtype, device)
        self.wo = dense_param((h * dh, d), generator, dtype, device,
                              fan_in=h * dh)
        self.norm = RMSNorm(d, dtype, device)

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                mode: str = "train", cache: Optional[Cache] = None,
                kv_source: Optional[torch.Tensor] = None,
                causal: bool = True,
                cache_len: int = 0) -> Tuple[torch.Tensor, Optional[Cache]]:
        cfg = self.cfg
        b, s, d = x.shape
        h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        dt = x.dtype
        xn = self.norm(x, cfg.norm_eps)
        wq, wk, wv, wo = self.wq, self.wk, self.wv, self.wo
        mesh = shard_axes.group_mesh()
        split = False
        if mesh is not None:
            if kv_source is not None:
                raise NotImplementedError(
                    "cross-attention on a mesh of ranks is not ported "
                    "(ROADMAP Queue 1 item 11b: encoder-decoders)")
            wq, wk, wv, wo, split = self._mesh_weights(mesh)
            if split:
                m = mesh["model"]
                h, hk = h // m, hk // m
                xn = array_ops.copy_to_axis(xn, mesh, "model")
        is_cross = kv_source is not None
        kv_in = self.norm(kv_source, cfg.norm_eps) if is_cross else xn
        lk = kv_in.shape[1]

        q = (xn @ wq.to(dt)).reshape(b, s, h, dh).transpose(1, 2)
        k = (kv_in @ wk.to(dt)).reshape(b, lk, hk, dh).transpose(1, 2)
        v = (kv_in @ wv.to(dt)).reshape(b, lk, hk, dh).transpose(1, 2)
        if split:
            shard_axes.constrain(q, "batch", "heads", "seq", None, shape=(
                shard_axes.global_dim(b, "batch"), cfg.n_heads, s, dh))
        if not is_cross:
            q = rope(q, positions[None, None, :], cfg.rope_theta)
            k = rope(k, positions[None, None, :], cfg.rope_theta)

        new_cache = None
        if is_cross:
            kv_pos = torch.arange(lk, dtype=torch.int32, device=x.device)
            o = attend(q, k, v, q_pos=positions, kv_pos=kv_pos, causal=False,
                       q_chunk=cfg.attn_q_chunk)
        elif mode == "decode":
            # write into the ring/linear cache in place and attend over
            # it; on a sequence-sharded cache (this rank holds ``span`` of
            # its ``length`` slots) the slot's owner writes K/V, every
            # rank the replicated ``pos``, and the ranks' softmax
            # statistics merge
            slot = cache["cursor"]
            length, span = cache["pos"].shape[0], cache["k"].shape[2]
            lo = 0 if span == length else mesh.coords["model"] * span
            if mesh is not None:
                _check_block(cache["k"], cfg, _kv_layout(
                    cfg, mesh, split, length), length)
            if cfg.kv_quant:
                kq, ks = kv_quantize(k)
                vq, vs = kv_quantize(v)
                for name, new in (("k", kq), ("k_s", ks), ("v", vq),
                                  ("v_s", vs)):
                    _write_slots(cache[name], new, slot, 2, length, lo)
                ck = kv_dequantize(cache["k"], cache["k_s"], dt)
                cv = kv_dequantize(cache["v"], cache["v_s"], dt)
            else:
                _write_slots(cache["k"], k, slot, 2, length, lo)
                _write_slots(cache["v"], v, slot, 2, length, lo)
                ck, cv = cache["k"], cache["v"]
            _write_slots(cache["pos"], positions.to(torch.int32), slot, 0)
            new_cache = {**cache, "cursor": (slot + s) % length
                         if cfg.window else slot + s}
            if span == length:
                o = attend(q, ck, cv, q_pos=positions, kv_pos=cache["pos"],
                           causal=causal, window=cfg.window,
                           q_chunk=cfg.attn_q_chunk)
            else:
                o = attend_sharded(q, ck, cv, mesh, "model", q_pos=positions,
                                   kv_pos=cache["pos"][lo:lo + span],
                                   causal=causal, window=cfg.window)
        else:
            if _use_flash_kernel(cfg, x.device) and (mode != "train"
                                                     or cfg.use_flash):
                # the flash kernel: native GQA, no KV repeat, no score tile
                # in device memory; training keeps the plain path (the
                # forward kernel has no backward)
                o = flash_ops.flash_attention(q, k, v, causal=causal,
                                              window=cfg.window)
            else:
                o = attend(q, k, v, q_pos=positions, kv_pos=positions,
                           causal=causal, window=cfg.window,
                           q_chunk=cfg.attn_q_chunk)
            if mode == "prefill":
                new_cache = _build_prefill_cache(cfg, k, v, positions,
                                                 cache_len or k.shape[2])
                if mesh is not None:
                    length = new_cache["pos"].shape[0]
                    layout = _kv_layout(cfg, mesh, split, length)
                    if layout == "seq":
                        new_cache = _seq_block(new_cache, mesh)
                    _check_block(new_cache["k"], cfg, layout, length)

        y = o.transpose(1, 2).reshape(b, s, h * dh) @ wo.to(dt)
        if split:
            y = array_ops.reduce_from_axis(y, mesh, "model")
        return y, new_cache

    def _mesh_weights(self, mesh):
        """``(wq, wk, wv, wo, split)`` on a mesh: the local heads' blocks
        when every projection splits on head boundaries over ``model``
        (``split``), else each split projection gathered whole for a
        replicated attention (every rank keeps its slice's gradient)."""
        cfg = self.cfg
        h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        m = mesh.get("model", 1)
        wq, wk, wv, wo = self.wq, self.wk, self.wv, self.wo
        if (m > 1 and h % m == 0 and hk % m == 0
                and wq.shape[1] == h * dh // m == wo.shape[0]
                and wk.shape[1] == hk * dh // m == wv.shape[1]):
            return wq, wk, wv, wo, True

        def whole(w, dim, n):
            if w.shape[dim] == n:
                return w
            return array_ops.axis_all_gather(w, mesh, "model", dim,
                                             backward="slice")
        return (whole(wq, 1, h * dh), whole(wk, 1, hk * dh),
                whole(wv, 1, hk * dh), whole(wo, 0, h * dh), False)


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (MiniCPM3 / DeepSeek-V2 style)
# ---------------------------------------------------------------------------
class MLA(nn.Module):
    """Latent attention: KV compressed to ``kv_lora_rank`` plus a RoPE key
    shared by the heads.  The cache holds only the latent ``c_kv`` and the
    RoPE key.  Decode re-expands K/V from the latent each step;
    ``cfg.mla_absorb`` scores in the latent space instead."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 dtype: torch.dtype, device: torch.device):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        qd = cfg.qk_nope_dim + cfg.qk_rope_dim
        r, vd = cfg.kv_lora_rank, cfg.v_head_dim
        self.cfg = cfg

        def dense(shape, fan_in=None):
            return dense_param(shape, generator, dtype, device, fan_in)

        self.wdq = dense((d, cfg.q_lora_rank))
        self.wuq = dense((cfg.q_lora_rank, h * qd))
        self.wdkv = dense((d, r + cfg.qk_rope_dim))
        self.wukv = dense((r, h * (cfg.qk_nope_dim + vd)))
        self.wo = dense((h * vd, d), fan_in=h * vd)
        self.norm = RMSNorm(d, dtype, device)
        self.q_norm = RMSNorm(cfg.q_lora_rank, dtype, device)
        self.kv_norm = RMSNorm(r, dtype, device)

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                mode: str = "train", cache: Optional[Cache] = None,
                cache_len: int = 0) -> Tuple[torch.Tensor, Optional[Cache]]:
        cfg = self.cfg
        b, s, d = x.shape
        h, r = cfg.n_heads, cfg.kv_lora_rank
        nope, rdim, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        dt = x.dtype
        eps = cfg.norm_eps
        xn = self.norm(x, eps)

        cq = self.q_norm(xn @ self.wdq.to(dt), eps)
        q = (cq @ self.wuq.to(dt)).reshape(b, s, h, nope + rdim)
        q = q.transpose(1, 2)
        q_nope, q_rope = q[..., :nope], q[..., nope:]
        q_rope = rope(q_rope, positions[None, None, :], cfg.rope_theta)

        dkv = xn @ self.wdkv.to(dt)                     # (B,S,r + rdim)
        c_kv = self.kv_norm(dkv[..., :r], eps)
        k_rope = rope(dkv[..., None, r:].transpose(1, 2),
                      positions[None, None, :], cfg.rope_theta)  # (B,1,S,rd)

        new_cache = None
        if mode == "decode":
            slot = cache["cursor"]
            _write_slots(cache["c_kv"], c_kv, slot, 1)
            _write_slots(cache["k_rope"], k_rope, slot, 2)
            _write_slots(cache["pos"], positions.to(torch.int32), slot, 0)
            new_cache = {**cache, "cursor": slot + s}
            c_kv_full, k_rope_full, kpos = (cache["c_kv"], cache["k_rope"],
                                            cache["pos"])
        else:
            c_kv_full, k_rope_full, kpos = c_kv, k_rope, positions
            if mode == "prefill":
                clen = cache_len or s
                cc = c_kv.new_zeros((b, clen, r))
                cr = k_rope.new_zeros((b, 1, clen, rdim))
                cpos = torch.full((clen,), -1, dtype=torch.int32,
                                  device=x.device)
                cc[:, :s] = c_kv
                cr[:, :, :s] = k_rope
                cpos[:s] = positions
                new_cache = {"c_kv": cc, "k_rope": cr, "pos": cpos,
                             "cursor": s}

        scale = (nope + rdim) ** -0.5
        if cfg.mla_absorb and mode == "decode":
            # absorbed: score in the latent space, never re-expand K
            wukv = self.wukv.to(dt).reshape(r, h, nope + vdim)
            q_lat = torch.einsum("bhsn,rhn->bhsr", q_nope, wukv[..., :nope])
            s_nope = torch.einsum("bhsr,blr->bhsl", q_lat, c_kv_full)
            s_rope = torch.einsum("bhsr,blr->bhsl", q_rope,
                                  k_rope_full[:, 0])
            scores = (s_nope + s_rope).to(torch.float32) * scale
            allow = _mask_for_chunk(positions, kpos, True, None)
            scores = torch.where(allow, scores, -1e30)
            p = torch.softmax(scores, dim=-1)
            o_lat = torch.einsum("bhsl,blr->bhsr", p.to(dt), c_kv_full)
            o = torch.einsum("bhsr,rhv->bhsv", o_lat, wukv[..., nope:])
        else:
            # expand K/V from the latent (the paper's path)
            kv = (c_kv_full @ self.wukv.to(dt)).reshape(
                b, -1, h, nope + vdim).transpose(1, 2)
            k_nope, v = kv[..., :nope], kv[..., nope:]
            k_r = k_rope_full.expand(b, h, *k_rope_full.shape[2:])
            k = torch.cat([k_nope, k_r], dim=-1)
            qc = torch.cat([q_nope, q_rope], dim=-1)
            o = attend(qc, k, v, q_pos=positions, kv_pos=kpos, causal=True,
                       sm_scale=scale, q_chunk=cfg.attn_q_chunk)

        y = o.transpose(1, 2).reshape(b, s, h * vdim) @ self.wo.to(dt)
        return y, new_cache


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 dtype: torch.dtype, device: torch.device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.eps = cfg.norm_eps
        self.d_ff = f
        self.w_gate = dense_param((d, f), generator, dtype, device)
        self.w_in = dense_param((d, f), generator, dtype, device)
        self.w_out = dense_param((f, d), generator, dtype, device, fan_in=f)
        self.norm = RMSNorm(d, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """On a mesh whose ``model`` axis splits ``d_ff``: local ``ff``
        columns, one all-reduce after ``w_out``."""
        dt = x.dtype
        xn = self.norm(x, self.eps)
        mesh = shard_axes.group_mesh()
        tp = mesh is not None and self.w_gate.shape[1] != self.d_ff
        if tp:
            xn = array_ops.copy_to_axis(xn, mesh, "model")
        g = torch.nn.functional.silu(xn @ self.w_gate.to(dt))
        u = xn @ self.w_in.to(dt)
        y = (g * u) @ self.w_out.to(dt)
        if tp:
            y = array_ops.reduce_from_axis(y, mesh, "model")
        return y
