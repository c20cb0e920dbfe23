"""Logical-axis sharding: rules mapping logical tensor axes → mesh axes.

Ports ``src/repro/sharding/axes.py``.  Model code names the *logical*
axes of a tensor (``batch``, ``seq``, ``heads``, ``ff`` …); a launcher
binds a mesh and a rule set, and :func:`spec_for` translates the names
into a partition spec.  The port has no ``jax.sharding.Mesh``: a mesh is
an ordered mapping from axis name to size (``{"pod": 2, "data": 16,
"model": 16}``, what ``AbstractMesh`` carries), and a spec is a tuple with
``PartitionSpec``'s entries — ``None``, an axis name, or a tuple of names.

Shards across cards are ROADMAP Queue 1 item 11.  Until then nothing can
place a tensor on a mesh: unbound, :func:`constrain` is the identity and
:func:`embed_lookup` the plain gather, as in the reference; under a
binding both raise ``NotImplementedError`` instead of doing nothing.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]
Mesh = Mapping[str, int]

# default logical→mesh rules for the production mesh (pod, data, model)
DEFAULT_RULES: Dict[str, MeshAxes] = {
    "batch": ("pod", "data"),     # DP over pods × data axis
    "seq": None,
    "embed": None,
    "heads": "model",             # TP: attention heads
    "kv_heads": "model",
    "q_lora": None,
    "kv_lora": None,
    "ff": "model",                # TP: FFN hidden
    "vocab": "model",             # TP: vocab / logits
    "embed_d": "model",           # embedding table: shard d_model, NOT vocab
    "expert": "model",            # EP: routed experts
    "moe_ff": None,               # expert-internal hidden (TP fallback: model)
    "fsdp": "data",               # parameter sharding (ZeRO-3 style)
    "ssm_inner": "model",
    "kv_seq": "model",            # sequence-sharded KV (decode)
    "state": None,
}

_NO_GROUP = ("the port has no process group to place a tensor on a mesh "
             "yet (ROADMAP Queue 1 item 11)")


class _Binding(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None
        self.rules: Dict[str, MeshAxes] = dict(DEFAULT_RULES)


_BINDING = _Binding()


@contextlib.contextmanager
def logical_binding(mesh: Optional[Mesh], rules: Optional[Dict] = None):
    """Bind mesh + rules for ``constrain``/``spec_for`` inside the block."""
    old = (_BINDING.mesh, _BINDING.rules)
    _BINDING.mesh = mesh
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    _BINDING.rules = merged
    try:
        yield
    finally:
        _BINDING.mesh, _BINDING.rules = old


def current_mesh() -> Optional[Mesh]:
    return _BINDING.mesh


def spec_for(logical_axes: Sequence[Optional[str]]) -> tuple:
    """Translate logical axis names to a spec under the current rules; a
    mesh axis already used by an earlier dimension is dropped."""
    rules = _BINDING.rules
    mesh = _BINDING.mesh
    used = set()
    parts = []
    for ax in logical_axes:
        mapped = rules.get(ax) if ax is not None else None
        if mapped is None:
            parts.append(None)
            continue
        axes = (mapped,) if isinstance(mapped, str) else tuple(mapped)
        if mesh is not None:
            axes = tuple(a for a in axes if a in mesh)
        axes = tuple(a for a in axes if a not in used)
        used.update(axes)
        if not axes:
            parts.append(None)
        elif len(axes) == 1:
            parts.append(axes[0])
        else:
            parts.append(axes)
    return tuple(parts)


def constrain(x, *logical_axes: Optional[str]):
    """Place ``x`` by logical axes: the identity when unbound."""
    if _BINDING.mesh is None:
        return x
    raise NotImplementedError(f"constrain{spec_for(logical_axes)}: "
                              f"{_NO_GROUP}")


def embed_lookup(embed, tokens):
    """The embedding gather: ``embed[tokens]`` when unbound (the
    reference's shard-local gather needs a mesh of cards)."""
    if _BINDING.mesh is None:
        return embed[tokens]
    raise NotImplementedError(f"embed_lookup: {_NO_GROUP}")


def divisible(n: int, axis: MeshAxes) -> bool:
    """Can dimension ``n`` be sharded over the mapped mesh axes?"""
    mesh = _BINDING.mesh
    if mesh is None or axis is None:
        return True
    axes = (axis,) if isinstance(axis, str) else axis
    size = 1
    for a in axes:
        size *= mesh.get(a, 1)
    return n % size == 0
