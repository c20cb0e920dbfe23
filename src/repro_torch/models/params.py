"""Carry the reference's parameters across to the port.

``params_from_jax(tree, cfg)`` takes the pytree the JAX package's
``init_lm`` returns, as numpy arrays (``jax.tree.map(np.asarray, params)``),
and returns a state dict for :class:`repro_torch.models.transformer.LM`:

    model.load_state_dict(params_from_jax(tree, cfg))

The reference's ``decoder`` leaves carry a leading ``n_groups`` axis (the
stack is a ``vmap`` over groups of ``cfg.block_pattern``), so layer
``g * group_size + i`` is ``decoder/layer_{i}/…[g]``.  Every leaf must be
consumed: a missing leaf raises ``KeyError``, a leaf left over
``ValueError``.  ``load_state_dict`` casts each weight to the model's
dtype, the rounding the reference applies at every use.
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from .transformer import check_supported


def _flatten(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, object]]:
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _flatten(val, path + "/")
        else:
            yield path, val


def _layer_leaves(cfg: ModelConfig):
    names = ["mixer/wq", "mixer/wk", "mixer/wv", "mixer/wo",
             "mixer/norm/scale"]
    if cfg.d_ff > 0:
        names += ["ffn/w_gate", "ffn/w_in", "ffn/w_out", "ffn/norm/scale"]
    return names


def params_from_jax(tree: Mapping, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The reference's ``init_lm`` pytree → the port's state dict."""
    check_supported(cfg)
    flat = dict(_flatten(tree))

    def take(path: str) -> np.ndarray:
        if path not in flat:
            raise KeyError(f"the JAX parameters lack the leaf {path!r}")
        return np.asarray(flat.pop(path))

    out = {"embed": torch.tensor(take("embed")),
           "final_norm.scale": torch.tensor(take("final_norm/scale"))}
    if not cfg.tie_embeddings:
        out["lm_head"] = torch.tensor(take("lm_head"))
    for i in range(cfg.group_size):
        for name in _layer_leaves(cfg):
            stacked = take(f"decoder/layer_{i}/{name}")
            if stacked.shape[0] != cfg.n_groups:
                raise ValueError(
                    f"decoder/layer_{i}/{name} has {stacked.shape[0]} groups, "
                    f"expected {cfg.n_groups}")
            for g in range(cfg.n_groups):
                key = f"layers.{g * cfg.group_size + i}.{name.replace('/', '.')}"
                out[key] = torch.tensor(stacked[g])
    if flat:
        raise ValueError(f"JAX parameters not consumed: {sorted(flat)}")
    return out
