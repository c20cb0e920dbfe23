"""Logical-axis sharding: rules mapping logical tensor axes → mesh axes.

Ports ``src/repro/sharding/axes.py``.  Model code names the *logical*
axes of a tensor (``batch``, ``seq``, ``heads``, ``ff`` …); a launcher
binds a mesh and a rule set, and :func:`spec_for` translates the names
into a partition spec.  The port has no ``jax.sharding.Mesh``: a mesh is
an ordered mapping from axis name to size (``{"pod": 2, "data": 16,
"model": 16}``, what ``AbstractMesh`` carries), and a spec is a tuple with
``PartitionSpec``'s entries — ``None``, an axis name, or a tuple of names.

A :class:`GroupMesh` is such a mapping that also carries one
``torch.distributed`` sub-group per axis and this rank's coordinate on
each (``launch/mesh.py:mesh_context`` builds it).  Bound, it places
tensors: every rank holds its blocks, and the model code runs its
collectives over the axes' groups.  :func:`constrain` then checks a local
tensor's shape against the spec (there is no partitioner to reshard, so a
mismatch raises), and :func:`embed_lookup` is the reference's shard-local
gather.  Unbound, :func:`constrain` is the identity and
:func:`embed_lookup` the plain gather, as in the reference.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple, Union

from ..core import array_ops

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



class GroupMesh(Mapping):
    """A mesh of ranks: ``{axis: size}`` in mesh order, plus the
    ``torch.distributed`` sub-group of each axis (``None`` for an axis of
    size 1: nothing to exchange) and this rank's coordinate on it.

    Rank ``r``'s coordinates are ``r`` unravelled row-major over the axes,
    as ``jax.make_mesh`` lays devices out: on ``{"data": 2, "model": 2}``
    ranks 0 and 1 share a data coordinate and form one ``model`` group."""

    def __init__(self, sizes: Mapping[str, int], groups: Mapping,
                 coords: Mapping[str, int]):
        self.sizes = dict(sizes)
        self.groups = dict(groups)
        self.coords = dict(coords)

    def __getitem__(self, axis: str) -> int:
        return self.sizes[axis]

    def __iter__(self) -> Iterator[str]:
        return iter(self.sizes)

    def __len__(self) -> int:
        return len(self.sizes)

    def __repr__(self) -> str:
        return f"GroupMesh({self.sizes}, coords={self.coords})"


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


def current_rules() -> Dict[str, MeshAxes]:
    """The bound rules (``DEFAULT_RULES`` unbound)."""
    return dict(_BINDING.rules)


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


def group_mesh() -> Optional[GroupMesh]:
    """The bound :class:`GroupMesh`, or ``None`` unbound; a bound mesh of
    sizes alone cannot place a tensor and raises."""
    mesh = _BINDING.mesh
    if mesh is None or isinstance(mesh, GroupMesh):
        return mesh
    raise TypeError(f"the bound mesh {dict(mesh)} has no process groups: "
                    f"build one with repro_torch.launch.mesh.mesh_context")


def entry_axes(entry: MeshAxes) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axes_size(mesh: Mesh, axes: MeshAxes) -> int:
    """The number of blocks ``axes`` (one spec entry) split a dim into."""
    return math.prod(mesh.get(a, 1) for a in entry_axes(axes))


def batch_axes() -> Tuple[str, ...]:
    """The bound mesh's data-parallel axes: those ``batch`` maps to."""
    return entry_axes(spec_for(["batch"])[0])


def global_dim(n: int, logical: Optional[str]) -> int:
    """The global size of a dimension of ``logical`` axis whose block on
    this rank is ``n`` (``n`` unbound)."""
    mesh = _BINDING.mesh
    if mesh is None:
        return n
    return n * axes_size(mesh, spec_for([logical])[0])


def local_shape(shape: Sequence[int], spec: Sequence[MeshAxes],
                mesh: Mesh) -> Tuple[int, ...]:
    """The block of a ``shape`` tensor each rank holds under ``spec``; a
    sharded dimension that does not divide raises."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, axes in zip(shape, spec):
        n = axes_size(mesh, axes)
        if dim % n:
            raise ValueError(f"dimension {dim} does not split over {axes} "
                             f"({n} blocks)")
        out.append(dim // n)
    return tuple(out)


def constrain(x, *logical_axes: Optional[str], shape=None):
    """Place ``x`` by logical axes: the identity when unbound.

    Bound, ``x`` is this rank's block of a tensor of global ``shape``;
    its shape must be the block ``spec_for(logical_axes)`` gives, or this
    raises (nothing reshards a tensor behind the model's back)."""
    mesh = _BINDING.mesh
    if mesh is None:
        return x
    if shape is None:
        raise ValueError(f"constrain{tuple(logical_axes)} under a mesh needs "
                         f"the tensor's global shape")
    want = local_shape(shape, spec_for(logical_axes), mesh)
    if tuple(x.shape) != want:
        raise ValueError(f"constrain{tuple(logical_axes)}: a block of "
                         f"{tuple(x.shape)}, the spec "
                         f"{spec_for(logical_axes)} on {dict(mesh)} places "
                         f"{want} of {tuple(shape)}")
    return x


def embed_lookup(embed, tokens, d_model: Optional[int] = None):
    """The embedding gather: ``embed[tokens]`` when unbound.

    Under a :class:`GroupMesh` binding it is the reference's shard-local
    gather: ``embed`` is this rank's block of the ``(V, d_model)`` table
    (``d_model`` split over the ``embed_d`` axis when it divides, vocab
    replicated) and ``tokens`` this rank's batch rows.  Each rank gathers
    its d-slice for its own rows, and one all-gather over the ``embed_d``
    axis makes the result whole, replicated over that axis.  Backward is
    the local scatter-add: the replicated consumers hand every rank the
    whole gradient, and each keeps its own d-slice."""
    mesh = group_mesh()
    if mesh is None:
        return embed[tokens]
    if d_model is None:
        raise ValueError("embed_lookup under a mesh needs d_model")
    d_axis = _BINDING.rules.get("embed_d")
    if isinstance(d_axis, tuple):
        d_axis = d_axis[0] if d_axis else None
    if d_axis is None or d_axis not in mesh or d_model % mesh[d_axis]:
        return embed[tokens]
    return array_ops.axis_all_gather(embed[tokens], mesh, d_axis, dim=-1,
                                     backward="slice")


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
