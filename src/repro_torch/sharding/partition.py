"""Parameter and cache partitioning: the port's parameter names → specs.

Ports ``src/repro/sharding/partition.py``.  Strategy (DESIGN.md §5): FSDP
(ZeRO-3) over the ``data`` axis × tensor parallelism over ``model`` —
heads/ff/vocab/experts on ``model``, the d_model ("fsdp") dimension on
``data``.  Rules are *shape-validated*: if a dimension is not divisible by
its mapped mesh axes the axis is dropped (e.g. kv_heads=8 on a 16-way
model axis ⇒ replicated KV projections; mixtral's 8 experts ⇒
expert-internal TP fallback instead of EP).

The port's layers are not stacked: a parameter is named
``layers.{i}.mixer.wq`` where the reference has ``decoder/layer_{i %
group_size}/mixer/wq`` with a leading group axis, and its leaves keep the
reference's layouts (``models/params.py:params_from_jax`` copies each
group's slice as it is).  So a port spec is the reference's without the
leading ``None`` of the group axis, and a layer's kind is
``cfg.block_pattern[i % cfg.group_size]``.  Caches likewise: one dict a
layer, no group axis.  Specs are tuples (see ``axes.py``).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from . import axes as axes_mod
from .axes import Mesh

# rules keyed by (context, leaf name): logical axes per dim
_ATTN_RULES = {
    "wq": ("fsdp", "heads"), "wk": ("fsdp", "kv_heads"),
    "wv": ("fsdp", "kv_heads"), "wo": ("heads", "fsdp"),
    "wdq": ("fsdp", None), "wuq": (None, "heads"),
    "wdkv": ("fsdp", None), "wukv": (None, "heads"),
}
_MAMBA_RULES = {
    "in_proj": ("fsdp", "ssm_inner"), "conv_w": (None, "ssm_inner"),
    "conv_b": ("ssm_inner",), "x_proj": ("ssm_inner", None),
    "dt_proj": (None, "ssm_inner"), "dt_bias": ("ssm_inner",),
    "a_log": ("ssm_inner", None), "d_skip": ("ssm_inner",),
    "out_proj": ("ssm_inner", "fsdp"),
}
_XLSTM_RULES = {
    "w_up": ("fsdp", "ssm_inner"), "wq": (None, "ssm_inner"),
    "wk": (None, "ssm_inner"), "wv": (None, "ssm_inner"),
    "w_gates": (None, None), "b_gates": (None,),
    "w_down": ("ssm_inner", "fsdp"),
    "w_x": ("fsdp", None), "w_h": (None, None), "b": (None,),
}
_DENSE_FFN_RULES = {
    "w_gate": ("fsdp", "ff"), "w_in": ("fsdp", "ff"), "w_out": ("ff", "fsdp"),
}
_MOE_RULES = {
    "router": ("fsdp", None),
    "w_gate": ("expert", "fsdp", None), "w_in": ("expert", "fsdp", None),
    "w_out": ("expert", None, "fsdp"),
}
_MOE_TP_RULES = {  # fallback when E doesn't divide the model axis
    "router": ("fsdp", None),
    "w_gate": (None, "fsdp", "ff"), "w_in": (None, "fsdp", "ff"),
    "w_out": (None, "ff", "fsdp"),
}


def _axis_size(mesh: Mesh, logical: Optional[str], rules) -> int:
    if logical is None:
        return 1
    mapped = rules.get(logical)
    if mapped is None:
        return 1
    mapped = (mapped,) if isinstance(mapped, str) else mapped
    return math.prod(mesh.get(a, 1) for a in mapped)


def _layer_kind(names: Tuple[str, ...], cfg: ModelConfig) -> str:
    """The kind of the layer a mixer leaf belongs to.  An encoder's stack
    has one pattern entry, so the reference reads it at index 0."""
    i = int(names[1]) if names[0] == "layers" else 0
    return cfg.block_pattern[i % cfg.group_size]


def _logical_for(names: Tuple[str, ...], shape, cfg: ModelConfig,
                 mesh: Mesh) -> Tuple[Optional[str], ...]:
    name = names[-1]
    ndim = len(shape)

    if name == "embed":
        logical = (None, "embed_d")
    elif name == "lm_head":
        logical = ("fsdp", "vocab")
    elif name == "scale":
        logical = (None,) * ndim
    elif "mixer" in names or "cross" in names:
        kind = "attn" if "cross" in names else _layer_kind(names, cfg)
        table = {"attn": _ATTN_RULES, "mamba": _MAMBA_RULES,
                 "mlstm": _XLSTM_RULES, "slstm": _XLSTM_RULES}[kind]
        logical = table.get(name, (None,) * ndim)
    elif "shared" in names:
        logical = _DENSE_FFN_RULES.get(name, (None,) * ndim)
    elif "ffn" in names:
        if ndim == 3 or name == "router":
            # experts padded to E: EP when E divides the model axis
            e_pad = shape[-3] if ndim == 3 else 0
            model_size = _axis_size(mesh, "expert", axes_mod.DEFAULT_RULES)
            ep_ok = e_pad > 0 and e_pad % max(model_size, 1) == 0
            table = _MOE_RULES if ep_ok or name == "router" else _MOE_TP_RULES
            logical = table.get(name, (None,) * ndim)
        else:
            logical = _DENSE_FFN_RULES.get(name, (None,) * ndim)
    else:
        logical = (None,) * ndim

    if len(logical) != ndim:
        logical = (None,) * ndim
    return logical


def param_spec(name: str, shape, cfg: ModelConfig, mesh: Mesh,
               rules=None) -> tuple:
    """The spec of the port's parameter ``name`` (``layers.3.mixer.wq``)
    of ``shape`` on ``mesh``."""
    rules = rules or axes_mod.DEFAULT_RULES
    logical = _logical_for(tuple(name.split(".")), shape, cfg, mesh)
    # shape-validate: drop axes that do not divide the dimension
    parts = []
    used = set()
    for dim, lg in zip(shape, logical):
        mapped = rules.get(lg) if lg else None
        if mapped is None:
            parts.append(None)
            continue
        cand = (mapped,) if isinstance(mapped, str) else tuple(mapped)
        cand = tuple(a for a in cand if a in mesh and a not in used)
        size = math.prod(mesh[a] for a in cand) if cand else 1
        if not cand or dim % size != 0:
            parts.append(None)
            continue
        used.update(cand)
        parts.append(cand[0] if len(cand) == 1 else cand)
    return tuple(parts)


def param_specs(params: Mapping[str, object], cfg: ModelConfig, mesh: Mesh,
                rules=None) -> Dict[str, tuple]:
    """Specs of a state dict (or any mapping of names to tensors)."""
    return {k: param_spec(k, v.shape, cfg, mesh, rules)
            for k, v in params.items()}


def batch_spec(mesh: Mesh, rules=None) -> tuple:
    rules = rules or axes_mod.DEFAULT_RULES
    mapped = rules.get("batch")
    mapped = (mapped,) if isinstance(mapped, str) else tuple(mapped or ())
    axes = tuple(a for a in mapped if a in mesh)
    if not axes:
        return ()
    return (axes if len(axes) > 1 else axes[0],)


def _cache_spec(name: str, shape, b_axes, mesh: Mesh) -> tuple:
    model_ok = "model" in mesh
    msize = mesh.get("model", 1)
    if name in ("pos", "cursor"):
        return ()
    if name in ("k", "v", "k_s", "v_s"):    # (B, Hkv, L, Dh|1)
        if model_ok and shape[1] % msize == 0:
            return (b_axes, "model", None, None)
        if model_ok and shape[2] % msize == 0:
            return (b_axes, None, "model", None)
        return (b_axes,)
    if name == "c_kv":                      # (B, L, r)
        return (b_axes, "model" if model_ok and shape[1] % msize == 0
                else None, None)
    if name == "k_rope":                    # (B, 1, L, rd)
        return (b_axes, None, "model" if model_ok and shape[2] % msize == 0
                else None, None)
    if name in ("ssm", "conv"):             # mamba states: d_inner on model
        din_axis = 1 if name == "ssm" else 2
        spec = [b_axes] + [None] * (len(shape) - 1)
        if model_ok and len(shape) > din_axis \
                and shape[din_axis] % msize == 0:
            spec[din_axis] = "model"
        return tuple(spec)
    return (b_axes,)                        # xLSTM states (B, ...)


def cache_specs(cache, cfg: ModelConfig, mesh: Mesh, rules=None):
    """KV/state cache specs (the reference's ``cache_shardings``): batch
    over the DP axes, heads/L over model.  ``cache`` is the model's
    ``Caches`` (one dict a layer); the result is a ``Caches`` of dicts of
    specs, its ``enc_out`` the encoder output's spec (or ``None``).

    For archs whose KV-head count doesn't divide the model axis, the cache
    *length* dimension is model-sharded instead (sequence-sharded KV).
    """
    from ..models.transformer import Caches

    bspec = batch_spec(mesh, rules)
    b_axes = bspec[0] if bspec else None
    out = Caches({k: _cache_spec(k, getattr(v, "shape", ()), b_axes, mesh)
                  for k, v in layer.items()} for layer in cache)
    if getattr(cache, "enc_out", None) is not None:
        out.enc_out = (b_axes, None, None)  # (B, F, D)
    return out


#: what an empty cache leaf holds (0 for the others): ``pos`` -1 (an empty
#: slot), the int8 K/V scales 1e-8, as ``models.transformer`` makes them
_CACHE_FILL = {"pos": -1, "k_s": 1e-8, "v_s": 1e-8}


def init_cache_blocks(cfg: ModelConfig, batch: int, cache_len: int,
                      dtype: torch.dtype, mesh, device):
    """This rank's blocks of the empty decode cache of ``batch`` (global)
    sequences under the bound rules' ``cache_specs``: only the blocks are
    allocated (``cursor`` and ``pos`` are replicated, so whole)."""
    from ..models.transformer import Caches, init_group_cache

    meta = Caches(c for _ in range(cfg.n_groups)
                  for c in init_group_cache(cfg, batch, cache_len, dtype,
                                            torch.device("meta")))
    specs = cache_specs(meta, cfg, mesh, axes_mod.current_rules())
    return Caches(
        {k: torch.full(axes_mod.local_shape(v.shape, spec[k], mesh),
                       _CACHE_FILL.get(k, 0), dtype=v.dtype, device=device)
         if torch.is_tensor(v) else v for k, v in layer.items()}
        for layer, spec in zip(meta, specs))


def _map_cache(fn, cache, specs):
    from ..models.transformer import Caches

    return Caches({k: fn(v, spec[k]) if torch.is_tensor(v) else v
                   for k, v in layer.items()}
                  for layer, spec in zip(cache, specs))


def shard_cache(cache, specs, mesh):
    """A whole cache (say, one built on one card) → this rank's blocks
    under ``specs`` (:func:`cache_specs`), as copies."""
    return _map_cache(lambda v, spec: shard_tensor(v, spec, mesh).clone(
        memory_format=torch.contiguous_format), cache, specs)


def gather_cache(cache, specs, mesh):
    """:func:`shard_cache` the other way: every rank's blocks → the whole
    cache on every rank (a collective; for tests and checks)."""
    return _map_cache(lambda v, spec: gather_tensor(v, spec, mesh), cache,
                      specs)


# ---------------------------------------------------------------------------
# placing a state dict on a mesh of ranks
# ---------------------------------------------------------------------------
def block_index(entry, mesh) -> int:
    """This rank's block along a dimension split over ``entry``'s axes:
    its coordinates on them, row-major (the first axis outermost)."""
    i = 0
    for a in axes_mod.entry_axes(entry):
        i = i * mesh[a] + mesh.coords[a]
    return i


def block_slices(shape, spec, mesh) -> Tuple[slice, ...]:
    """The index of this rank's block of a global ``shape`` under
    ``spec`` (for a tensor, or a memory-mapped array on disk)."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        n = axes_mod.axes_size(mesh, entry)
        size = dim // n
        start = block_index(entry, mesh) * size if n > 1 else 0
        out.append(slice(start, start + size))
    return tuple(out)


def shard_tensor(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the global ``x`` under ``spec`` (a view)."""
    return x[block_slices(x.shape, spec, mesh)]


def shard_params(full: Mapping[str, torch.Tensor], specs: Mapping[str, tuple],
                 mesh) -> Dict[str, torch.Tensor]:
    """The global leaves ``full`` → this rank's blocks on ``mesh`` (a
    ``GroupMesh``), as copies (a leaf whose spec splits no dimension is
    copied whole: replicated)."""
    return {k: shard_tensor(v, specs[k], mesh).clone(
        memory_format=torch.contiguous_format) for k, v in full.items()}


def block_keeper(specs: Mapping[str, tuple], mesh):
    """→ ``(keep, kept)``: an ``LM(..., keep=keep)`` callback that puts
    this rank's block (a copy) in place of each parameter as it is drawn,
    and the dict of the kept blocks by name."""
    from torch import nn

    kept: Dict[str, torch.Tensor] = {}

    def keep(prefix: str, module) -> None:
        for name, p in list(module.named_parameters()):
            full = f"{prefix}.{name}" if prefix else name
            if full in kept:
                continue
            kept[full] = shard_tensor(p.detach(), specs[full], mesh).clone()
            owner, _, leaf = name.rpartition(".")
            setattr(module.get_submodule(owner), leaf,
                    nn.Parameter(kept[full], requires_grad=False))

    return keep, kept


def gather_tensor(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """A copy of the global tensor from every rank's block ``x`` (a
    collective over the axes ``spec`` names; no gradient)."""
    from ..core import array_ops

    x = x.detach().clone()
    for dim, entry in enumerate(spec):
        # innermost axis first: its blocks are adjacent
        for a in reversed(axes_mod.entry_axes(entry)):
            x = array_ops.axis_all_gather(x, mesh, a, dim=dim)
    return x


def batch_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a global batch-leading ``x`` under the bound
    rules' ``batch`` spec (they must split evenly)."""
    spec = axes_mod.spec_for(["batch"])
    axes_mod.local_shape(x.shape, spec, mesh)
    return shard_tensor(x, spec, mesh)


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """:func:`batch_rows` the other way: the global batch on every rank."""
    return gather_tensor(x, axes_mod.spec_for(["batch"]), mesh)


def gather_params(local: Mapping[str, torch.Tensor],
                  specs: Mapping[str, tuple], mesh) -> Dict[str, torch.Tensor]:
    """:func:`shard_params` the other way: every rank's blocks → the
    global leaves on every rank (for tests and checks)."""
    return {k: gather_tensor(v, specs[k], mesh) for k, v in local.items()}


def sharded_axes(spec) -> Tuple[str, ...]:
    """The mesh axes a spec splits a tensor over (it is replicated over
    the others)."""
    return tuple(a for entry in spec for a in axes_mod.entry_axes(entry))
