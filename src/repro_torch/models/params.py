"""Carry the reference's parameters across to the port.

``params_from_jax(tree, cfg)`` takes the pytree the JAX package's
``init_lm`` returns, as numpy arrays (``jax.tree.map(np.asarray, params)``),
and returns a state dict for :class:`repro_torch.models.transformer.LM`:

    model.load_state_dict(params_from_jax(tree, cfg))

The reference's ``decoder`` leaves carry a leading ``n_groups`` axis (the
stack is a ``vmap`` over groups of ``cfg.block_pattern``), so layer
``g * group_size + i`` is ``decoder/layer_{i}/…[g]``; an encoder-decoder's
encoder layer ``j`` is ``encoder/layer_0/…[j]``.  Every leaf must be
consumed: a missing leaf raises ``KeyError``, a leaf left over
``ValueError``.  ``load_state_dict`` casts each weight to its parameter's
dtype: the model's compute dtype, the rounding the reference applies at
every use, or float32 for the leaves the reference uses uncast.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from .transformer import encoder_config, layer_has_ffn, layer_has_moe

_NORM = "norm/scale"
_GQA = ["wq", "wk", "wv", "wo", _NORM]
_MIXER_LEAVES = {
    "mla": ["wdq", "wuq", "wdkv", "wukv", "wo", _NORM, "q_norm/scale",
            "kv_norm/scale"],
    "mamba": [_NORM, "in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
              "dt_bias", "a_log", "d_skip", "out_proj"],
    "mlstm": [_NORM, "w_up", "wq", "wk", "wv", "w_gates", "b_gates",
              "out_norm/scale", "w_down"],
    "slstm": [_NORM, "w_x", "w_h", "b", "out_norm/scale", "w_down"],
}


#: the port's name prefixes of the reference's stacked trees
#: (``decoder`` → ``layers``, ``encoder`` → ``encoder``)
STACKED = ("layers.", "encoder.")


def reference_ndim(name: str, ndim: int) -> int:
    """The rank of the reference's leaf for the port's leaf ``name`` of
    rank ``ndim``: one more under a stacked tree (the ``n_groups`` axis)."""
    return ndim + 1 if name.startswith(STACKED) else ndim


def _flatten(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, object]]:
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _flatten(val, path + "/")
        else:
            yield path, val


def _layer_leaves(cfg: ModelConfig, kind: str, i: int,
                  cross: bool) -> List[str]:
    """The leaves of pattern entry ``i`` (of kind ``kind``)."""
    mixer = _MIXER_LEAVES.get("mla" if (kind == "attn" and
                                        cfg.attention == "mla") else kind,
                              _GQA)
    names = [f"mixer/{n}" for n in mixer]
    if cross:
        names += [f"cross/{n}" for n in _GQA]
    if layer_has_moe(cfg, i, kind):
        names += ["ffn/norm/scale", "ffn/router", "ffn/w_gate", "ffn/w_in",
                  "ffn/w_out"]
        if cfg.n_shared_experts:
            names += ["ffn/shared/w_gate", "ffn/shared/w_in",
                      "ffn/shared/w_out"]
    elif layer_has_ffn(cfg, kind):
        names += ["ffn/w_gate", "ffn/w_in", "ffn/w_out", "ffn/norm/scale"]
    return names


def params_from_jax(tree: Mapping, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The reference's ``init_lm`` pytree → the port's state dict."""
    flat = dict(_flatten(tree))

    def take(path: str) -> np.ndarray:
        if path not in flat:
            raise KeyError(f"the JAX parameters lack the leaf {path!r}")
        return np.asarray(flat.pop(path))

    out = {"embed": torch.tensor(take("embed")),
           "final_norm.scale": torch.tensor(take("final_norm/scale"))}
    if not cfg.tie_embeddings:
        out["lm_head"] = torch.tensor(take("lm_head"))
    stacks = [("decoder", "layers", cfg, cfg.is_encoder_decoder)]
    if cfg.is_encoder_decoder:
        stacks.append(("encoder", "encoder", encoder_config(cfg), False))
        out["enc_norm.scale"] = torch.tensor(take("enc_norm/scale"))
    for src, dst, scfg, cross in stacks:
        for i, kind in enumerate(scfg.block_pattern):
            for name in _layer_leaves(scfg, kind, i, cross):
                path = f"{src}/layer_{i}/{name}"
                stacked = take(path)
                if stacked.shape[0] != scfg.n_groups:
                    raise ValueError(
                        f"{path} has {stacked.shape[0]} groups, expected "
                        f"{scfg.n_groups}")
                for g in range(scfg.n_groups):
                    j = g * scfg.group_size + i
                    out[f"{dst}.{j}.{name.replace('/', '.')}"] = \
                        torch.tensor(stacked[g])
    if flat:
        raise ValueError(f"JAX parameters not consumed: {sorted(flat)}")
    return out

