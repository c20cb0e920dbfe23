"""Array (vector/matrix/tensor) distributed operators — paper Table I.

The MPI-heritage collectives over the port's virtual shards: ``n_shards``
blocks on one device, so a collective is a tensor reshuffle across the
blocks.  Two API levels, as in the reference (``repro/core/array_ops.py``):

  * **in-SPMD** functions (``spmd_*``): take the list of per-shard values,
    one per virtual shard, and return the list each shard would hold —
    the vocabulary the table kernels, the window engine and the gradient
    compression speak.  A replicated result is the same tensor in every
    entry.
  * **global-view** operators (:func:`allreduce` … :func:`reduce`): take
    one tensor and an ``HPTMTContext``; shard ``s`` owns row block
    ``[s*b, (s+1)*b)``.  Outputs have the shapes of the reference's global
    arrays — "replicated" is one tensor, "row-sharded" one tensor of
    ``n_shards`` blocks — and each is registered as ``array.<name>``.
    On one shard they degrade to local reductions (principle (d)).

Global-view calling conventions (each shard owns one leading-dim block):

  ===============  =======================  ==============================
  operator         input (global)           output (global)
  ===============  =======================  ==============================
  allreduce        (S, *rest) row-sharded   (*rest) replicated
  allgather        (N, *rest) row-sharded   (N, *rest) replicated
  alltoall         (N, *rest) row-sharded   (N, *rest) row-sharded
  reduce_scatter   (N, *rest) replicated    (N, *rest) row-sharded
  broadcast        (S, *rest) row-sharded   (*rest) replicated (root block)
  gather           (N, *rest) row-sharded   (S, N, *rest); zeros off-root
  scatter          (N, *rest) replicated    (N, *rest) row-sharded
  reduce           (S, *rest) row-sharded   (S, *rest); zeros off-root
  ===============  =======================  ==============================

The reference's quirks are kept on purpose (ROADMAP Queue 3): the global
``allreduce``/``broadcast``/``reduce`` read only the first row of each
shard's block; rooted operators are masks over unrooted collectives
(a broadcast is a masked sum, so ``-0.0`` arrives as ``+0.0`` on more than
one shard); ``reduce_scatter`` of a replicated input sums the replicas.

:func:`all_to_all` is the ONE exchange choke point of the port: every row
exchange goes through it — :func:`spmd_alltoall` and the global
:func:`alltoall` included — and :data:`EXCHANGES` counts its calls.  The
count stands in for the reference tests' jaxpr ``all_to_all`` count, so
the shuffle-elision contracts (DESIGN.md §4) are asserted on it.  The
other collectives move small per-shard state, not rows of a table, and do
not count as exchanges.

:data:`SORTS` counts the port's stable lexicographic sorts
(``core/exchange.py:lex_order``, the one sort choke point); it stands in
for the reference tests' jaxpr ``"sort["`` check of the ordered
operators (DESIGN.md §9: a window on a range layout sorts nothing).
"""
from __future__ import annotations

import operator as _op
from typing import List, Sequence

import torch

from .context import HPTMTContext
from .operator import Abstraction, operator


class Counter:
    """A plain call counter (reset to 0 before a run, read after).

    ``log``, when a list, also receives each counted exchange's payload
    bytes (``telemetry.audit.exchange_log`` sets it; ``None`` — the
    default — keeps the count the only cost)."""

    def __init__(self):
        self.n = 0
        self.log = None

    def add(self) -> None:
        self.n += 1

    def reset(self) -> None:
        self.n = 0


#: calls of :func:`all_to_all` — one per shuffle
EXCHANGES = Counter()
#: calls of ``exchange.lex_order`` — one per stable lexicographic sort
SORTS = Counter()


def all_to_all(frames: Sequence[torch.Tensor]) -> list:
    """``frames[s]`` is shard ``s``'s ``(P, ...)`` send frame, block ``d``
    bound for shard ``d``; returns the ``(P, ...)`` frame each shard
    receives, block ``s`` from sender ``s``."""
    EXCHANGES.add()
    if EXCHANGES.log is not None:
        EXCHANGES.log.append(sum(f.numel() * f.element_size()
                                 for f in frames))
    return list(torch.stack(list(frames)).transpose(0, 1).unbind(0))


# ---------------------------------------------------------------------------
# in-SPMD collectives: a list of per-shard values in, the list each shard
# holds out
# ---------------------------------------------------------------------------
_COMBINE = {"sum": _op.add, "max": torch.maximum, "min": torch.minimum,
            "prod": _op.mul}


def axis_size(values: Sequence) -> int:
    """The number of shards the values span."""
    return len(values)


def _split(x: torch.Tensor, n: int, axis: int, what: str) -> tuple:
    if x.shape[axis] % n:
        raise ValueError(f"{what}: dimension {axis} of size {x.shape[axis]} "
                         f"does not split into {n} shards")
    return x.tensor_split(n, dim=axis)


def spmd_allreduce(values: Sequence, op: str = "sum") -> list:
    """Combine one value per shard with ``sum/max/min/mean/prod``, in shard
    order; the ``mean`` divides the sum by the shard count in the sum's
    dtype (an integer sum becomes float32, as the reference's does)."""
    fn = _COMBINE["sum" if op == "mean" else op]
    out = values[0]
    for v in values[1:]:
        out = fn(out, v)
    if op == "mean":
        out = out / len(values)
    return [out] * len(values)


def spmd_allgather(values: Sequence[torch.Tensor], *, tiled: bool = True,
                   gather_axis: int = 0) -> list:
    """Every shard's value, concatenated along ``gather_axis`` (``tiled``)
    or stacked along a new axis there."""
    join = torch.cat if tiled else torch.stack
    return [join(list(values), dim=gather_axis)] * len(values)


def spmd_alltoall(values: Sequence[torch.Tensor], *, split_axis: int = 0,
                  concat_axis: int = 0) -> list:
    """Shard ``s`` splits its value into ``n`` chunks along ``split_axis``
    and sends chunk ``d`` to shard ``d``, which concatenates what it
    receives along ``concat_axis`` in sender order: one counted exchange."""
    n = len(values)
    recv = all_to_all([torch.stack(_split(v, n, split_axis, "alltoall"))
                       for v in values])
    return [torch.cat(list(r.unbind(0)), dim=concat_axis) for r in recv]


def spmd_reduce_scatter(values: Sequence[torch.Tensor], *,
                        scatter_axis: int = 0, op: str = "sum") -> list:
    """Sum the shards' values and give shard ``s`` chunk ``s`` of the sum
    along ``scatter_axis``."""
    if op != "sum":
        raise NotImplementedError("reduce_scatter supports sum only")
    total = spmd_allreduce(values)[0]
    return list(_split(total, len(values), scatter_axis, "reduce_scatter"))


def spmd_broadcast(values: Sequence[torch.Tensor], root: int = 0) -> list:
    """Rooted broadcast = mask + allreduce (the reference's form)."""
    return spmd_allreduce([v if s == root else torch.zeros_like(v)
                           for s, v in enumerate(values)])


def spmd_reduce(values: Sequence[torch.Tensor], root: int = 0,
                op: str = "sum") -> list:
    """Rooted reduce: the combined value on ``root``, zeros elsewhere."""
    full = spmd_allreduce(values, op)[0]
    return [full if s == root else torch.zeros_like(full)
            for s in range(len(values))]


def spmd_gather(values: Sequence[torch.Tensor], root: int = 0) -> list:
    """Rooted gather: the concatenation on ``root``, zeros elsewhere."""
    g = spmd_allgather(values)[0]
    return [g if s == root else torch.zeros_like(g)
            for s in range(len(values))]


def spmd_scatter(values: Sequence[torch.Tensor], root: int = 0) -> list:
    """Rooted scatter: ``root``'s buffer split into one block a shard."""
    n = len(values)
    full = spmd_broadcast(values, root)[0]
    piece = values[0].shape[0] // n
    return [full[s * piece:(s + 1) * piece] for s in range(n)]


def spmd_ppermute(frames: Sequence[torch.Tensor], perm) -> list:
    """Shift shard blocks along ``perm``, a sequence of ``(src, dst)``
    pairs: shard ``dst`` receives ``frames[src]``.  A shard no pair sends
    to receives zeros, as JAX's ``ppermute`` delivers."""
    out = [torch.zeros_like(f) for f in frames]
    for src, dst in perm:
        out[dst] = frames[src]
    return out


# ---------------------------------------------------------------------------
# global-view eager operators (paper Table I)
# ---------------------------------------------------------------------------
def _blocks(x: torch.Tensor, ctx: HPTMTContext) -> List[torch.Tensor]:
    """Shard ``s``'s row block of ``x``."""
    return list(_split(x, ctx.n_shards, 0, "row blocks"))


def _heads(x: torch.Tensor, ctx: HPTMTContext) -> List[torch.Tensor]:
    """The first row of each shard's block (the reference reads ``v[0]``)."""
    return [b[0] for b in _blocks(x, ctx)]


def _local_reduce(x: torch.Tensor, op: str, keepdim: bool = False):
    if op == "mean":
        inexact = x.is_floating_point() or x.is_complex()
        return x.to(x.dtype if inexact else torch.float32).mean(
            0, keepdim=keepdim)
    if op in ("max", "min"):
        return getattr(x, "a" + op)(0, keepdim=keepdim)
    return getattr(x, op)(0, keepdim=keepdim, dtype=x.dtype)


@operator("array.allreduce", Abstraction.ARRAY)
def allreduce(x, *, ctx: HPTMTContext, op: str = "sum"):
    """AllReduce: combine one block per shard with SUM/MIN/MAX/MEAN/PROD."""
    if ctx.n_shards == 1:
        if op not in ("sum", "max", "min", "mean", "prod"):
            raise KeyError(op)
        return _local_reduce(x, op)
    return spmd_allreduce(_heads(x, ctx), op)[0]


@operator("array.allgather", Abstraction.ARRAY)
def allgather(x, *, ctx: HPTMTContext):
    """AllGather: every shard receives the concatenation of all shards."""
    if ctx.n_shards == 1:
        return x
    return spmd_allgather(_blocks(x, ctx))[0]


@operator("array.alltoall", Abstraction.ARRAY)
def alltoall(x, *, ctx: HPTMTContext):
    """AllToAll: transpose the (shard, block) layout of a row-sharded array."""
    if ctx.n_shards == 1:
        return x
    return torch.cat(spmd_alltoall(_blocks(x, ctx)))


@operator("array.reduce_scatter", Abstraction.ARRAY)
def reduce_scatter(x, *, ctx: HPTMTContext):
    """ReduceScatter: sum shard contributions, scatter result row-blocks."""
    if ctx.n_shards == 1:
        return x
    return torch.cat(spmd_reduce_scatter([x] * ctx.n_shards))


@operator("array.broadcast", Abstraction.ARRAY)
def broadcast(x, *, ctx: HPTMTContext, root: int = 0):
    """Broadcast: shard ``root``'s block to every shard (replicated)."""
    if ctx.n_shards == 1:
        return x[root]
    return spmd_broadcast(_heads(x, ctx), root)[0]


@operator("array.gather", Abstraction.ARRAY)
def gather(x, *, ctx: HPTMTContext, root: int = 0):
    """Gather: concatenation of all shards on ``root`` (zeros elsewhere)."""
    if ctx.n_shards == 1:
        return x[None]
    return torch.stack(spmd_gather(_blocks(x, ctx), root))


@operator("array.scatter", Abstraction.ARRAY)
def scatter(x, *, ctx: HPTMTContext, root: int = 0):
    """Scatter: split ``root``'s (replicated) buffer into one block/shard."""
    if ctx.n_shards == 1:
        return x
    return torch.cat(spmd_scatter([x] * ctx.n_shards, root))


@operator("array.reduce", Abstraction.ARRAY)
def reduce(x, *, ctx: HPTMTContext, root: int = 0, op: str = "sum"):
    """Reduce: combined value in ``root``'s block, zeros elsewhere."""
    if ctx.n_shards == 1:
        if op not in ("sum", "max", "min", "mean"):
            raise KeyError(op)
        return _local_reduce(x, op, keepdim=True)
    return torch.stack(spmd_reduce(_heads(x, ctx), root, op))
