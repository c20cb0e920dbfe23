"""Array (vector/matrix/tensor) distributed operators — paper Table I.

The MPI-heritage collectives over the port's shards.  Without a process
group the shards are virtual — ``n_shards`` blocks on one device — and a
collective is a tensor reshuffle across the blocks.  With a
``torch.distributed`` group (``core/context.py``) each rank passes the
values of the shards it holds, and the same functions become collectives
over the group.  Two API levels, as in the reference
(``repro/core/array_ops.py``):

  * **in-SPMD** functions (``spmd_*``): take the list of per-shard values
    — one per virtual shard, or one per shard this rank holds when
    ``group=`` is given — and return the list those shards would hold: the
    vocabulary the table kernels, the window engine and the gradient
    compression speak.  A replicated result is the same tensor in every
    entry.
  * **global-view** operators (:func:`allreduce` … :func:`reduce`): take
    one tensor and an ``HPTMTContext``; shard ``s`` owns row block
    ``[s*b, (s+1)*b)``.  Outputs have the shapes of the reference's global
    arrays — "replicated" is one tensor, "row-sharded" one tensor of
    ``n_shards`` blocks — and each is registered as ``array.<name>``.
    On a group, a row-sharded input or output is this rank's blocks only,
    and a replicated one is whole on every rank.  On one shard they
    degrade to local reductions (principle (d)).

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

On a group every collective is one of two ``torch.distributed`` calls,
on the values' bytes (so any dtype travels, ``bool`` included):
``all_to_all_single`` (even splits for the row exchange, uneven ones for
``spmd_ppermute``) and ``all_gather_into_tensor`` (``all_gather_single``
from torch 2.13).  A combine (sum, max, min, prod, mean) gathers the
values and folds them here in shard order — never the backend's
reduction, whose order would change float bits — so a group run is bit
for bit the virtual run.

:func:`all_to_all` is the ONE exchange choke point of the port: every row
exchange goes through it — :func:`spmd_alltoall` and the global
:func:`alltoall` included — and :data:`EXCHANGES` counts its calls (one a
shuffle in each process).  The count stands in for the reference tests'
jaxpr ``all_to_all`` count, so the shuffle-elision contracts (DESIGN.md
§4) are asserted on it.  The other collectives move small per-shard
state, not rows of a table, and do not count as exchanges.

:data:`SORTS` counts the port's stable lexicographic sorts
(``core/exchange.py:lex_order``, the one sort choke point); it stands in
for the reference tests' jaxpr ``"sort["`` check of the ordered
operators (DESIGN.md §9: a window on a range layout sorts nothing).
"""
from __future__ import annotations

import operator as _op
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from .context import HPTMTContext, group_rank, group_size
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


# ---------------------------------------------------------------------------
# the group transport: two torch.distributed calls, on bytes
# ---------------------------------------------------------------------------
#: ``all_gather_into_tensor``, named ``all_gather_single`` from torch 2.13
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes as a flat uint8 tensor (no copy when contiguous)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _unbytes(b: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    return b.view(dtype).reshape(shape)


def _gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather of every rank's ``(n_local, ...)`` stack into the
    ``(world * n_local, ...)`` stack, rank-major (global shard order)."""
    world = group_size(group)
    b = _bytes(x)
    out = torch.empty(world * b.numel(), dtype=torch.uint8, device=b.device)
    _all_gather(out, b, group=group)
    return _unbytes(out, x.dtype, (world * x.shape[0],) + tuple(x.shape[1:]))


def _every_shard(values: Sequence, group) -> list:
    """Every shard's value, in global shard order (the values themselves
    without a group)."""
    if group is None:
        return list(values)
    return list(_gather_stack(torch.stack(list(values)), group).unbind(0))


def shard_span(values: Sequence, group=None) -> Tuple[int, int]:
    """``(global shard count, global id of values[0])`` for one entry a
    shard this process holds."""
    n = len(values)
    return n * group_size(group), n * group_rank(group)


def all_to_all(frames: Sequence[torch.Tensor], group=None) -> list:
    """``frames[s]`` is shard ``s``'s ``(P, ...)`` send frame, block ``d``
    bound for shard ``d``; returns the ``(P, ...)`` frame each shard
    receives, block ``s`` from sender ``s``.

    On a group ``frames`` are this rank's shards' frames; the blocks are
    reordered destination-major, so one even ``all_to_all_single`` hands
    every rank the blocks bound for its shards."""
    EXCHANGES.add()
    if EXCHANGES.log is not None:
        EXCHANGES.log.append(sum(f.numel() * f.element_size()
                                 for f in frames))
    x = torch.stack(list(frames))
    if group is None:
        return list(x.transpose(0, 1).unbind(0))
    n_local, p = x.shape[0], x.shape[1]
    rest = tuple(x.shape[2:])
    world = p // n_local
    # (dst shard, src local shard, ...) == (dst rank, dst local, src local)
    send = _bytes(x.transpose(0, 1))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # (src rank, dst local, src local, ...) → (dst local, src shard, ...)
    recv = _unbytes(recv, x.dtype, (world, n_local, n_local) + rest)
    return list(recv.transpose(0, 1).reshape((n_local, p) + rest).unbind(0))


# ---------------------------------------------------------------------------
# in-SPMD collectives: a list of per-shard values in, the list each shard
# holds out
# ---------------------------------------------------------------------------
_COMBINE = {"sum": _op.add, "max": torch.maximum, "min": torch.minimum,
            "prod": _op.mul}


def axis_size(values: Sequence, group=None) -> int:
    """The number of shards the values span."""
    return shard_span(values, group)[0]


def _split(x: torch.Tensor, n: int, axis: int, what: str) -> tuple:
    if x.shape[axis] % n:
        raise ValueError(f"{what}: dimension {axis} of size {x.shape[axis]} "
                         f"does not split into {n} shards")
    return x.tensor_split(n, dim=axis)


def spmd_allreduce(values: Sequence, op: str = "sum", *, group=None) -> list:
    """Combine one value per shard with ``sum/max/min/mean/prod``, in shard
    order; the ``mean`` divides the sum by the shard count in the sum's
    dtype (an integer sum becomes float32, as the reference's does)."""
    fn = _COMBINE["sum" if op == "mean" else op]
    every = _every_shard(values, group)
    out = every[0]
    for v in every[1:]:
        out = fn(out, v)
    if op == "mean":
        out = out / len(every)
    return [out] * len(values)


def spmd_allgather(values: Sequence[torch.Tensor], *, tiled: bool = True,
                   gather_axis: int = 0, group=None) -> list:
    """Every shard's value, concatenated along ``gather_axis`` (``tiled``)
    or stacked along a new axis there."""
    join = torch.cat if tiled else torch.stack
    return [join(_every_shard(values, group), dim=gather_axis)] * len(values)


def spmd_alltoall(values: Sequence[torch.Tensor], *, split_axis: int = 0,
                  concat_axis: int = 0, group=None) -> list:
    """Shard ``s`` splits its value into ``n`` chunks along ``split_axis``
    and sends chunk ``d`` to shard ``d``, which concatenates what it
    receives along ``concat_axis`` in sender order: one counted exchange."""
    n = axis_size(values, group)
    recv = all_to_all([torch.stack(_split(v, n, split_axis, "alltoall"))
                       for v in values], group)
    return [torch.cat(list(r.unbind(0)), dim=concat_axis) for r in recv]


def spmd_reduce_scatter(values: Sequence[torch.Tensor], *,
                        scatter_axis: int = 0, op: str = "sum",
                        group=None) -> list:
    """Sum the shards' values and give shard ``s`` chunk ``s`` of the sum
    along ``scatter_axis``."""
    if op != "sum":
        raise NotImplementedError("reduce_scatter supports sum only")
    n, base = shard_span(values, group)
    total = spmd_allreduce(values, group=group)[0]
    return list(_split(total, n, scatter_axis,
                       "reduce_scatter")[base:base + len(values)])


def spmd_broadcast(values: Sequence[torch.Tensor], root: int = 0, *,
                   group=None) -> list:
    """Rooted broadcast = mask + allreduce (the reference's form)."""
    base = shard_span(values, group)[1]
    return spmd_allreduce([v if base + s == root else torch.zeros_like(v)
                           for s, v in enumerate(values)], group=group)


def spmd_reduce(values: Sequence[torch.Tensor], root: int = 0,
                op: str = "sum", *, group=None) -> list:
    """Rooted reduce: the combined value on ``root``, zeros elsewhere."""
    base = shard_span(values, group)[1]
    full = spmd_allreduce(values, op, group=group)[0]
    return [full if base + s == root else torch.zeros_like(full)
            for s in range(len(values))]


def spmd_gather(values: Sequence[torch.Tensor], root: int = 0, *,
                group=None) -> list:
    """Rooted gather: the concatenation on ``root``, zeros elsewhere."""
    base = shard_span(values, group)[1]
    g = spmd_allgather(values, group=group)[0]
    return [g if base + s == root else torch.zeros_like(g)
            for s in range(len(values))]


def spmd_scatter(values: Sequence[torch.Tensor], root: int = 0, *,
                 group=None) -> list:
    """Rooted scatter: ``root``'s buffer split into one block a shard."""
    n, base = shard_span(values, group)
    full = spmd_broadcast(values, root, group=group)[0]
    piece = values[0].shape[0] // n
    return [full[(base + s) * piece:(base + s + 1) * piece]
            for s in range(len(values))]


def spmd_ppermute(frames: Sequence[torch.Tensor], perm, *,
                  group=None) -> list:
    """Shift shard blocks along ``perm``, a sequence of global ``(src,
    dst)`` pairs: shard ``dst`` receives ``frames[src]``.  A shard no pair
    sends to receives zeros, as JAX's ``ppermute`` delivers.

    On a group a pair inside one rank is a local move; the pairs across
    ranks ride one uneven ``all_to_all_single`` that every rank joins,
    even one with nothing to send (every frame has one shape and dtype)."""
    n_local = len(frames)
    base = shard_span(frames, group)[1]
    out = [torch.zeros_like(f) for f in frames]
    if group is None:
        for src, dst in perm:
            out[dst] = frames[src]
        return out
    rank = base // n_local
    owner = lambda s: s // n_local  # noqa: E731
    cross = []
    for src, dst in perm:
        if owner(src) == owner(dst):
            if owner(dst) == rank:
                out[dst - base] = frames[src - base]
        else:
            cross.append((src, dst))
    if not cross:
        return out
    world = group_size(group)
    f0 = frames[0]
    nb = f0.numel() * f0.element_size()
    sends = [[s for s, d in cross if owner(s) == rank and owner(d) == q]
             for q in range(world)]
    recvs = [[d for s, d in cross if owner(d) == rank and owner(s) == p]
             for p in range(world)]
    parts = [_bytes(frames[s - base]) for q in sends for s in q]
    send = (torch.cat(parts) if parts else
            torch.empty(0, dtype=torch.uint8, device=f0.device))
    recv = torch.empty(sum(len(r) for r in recvs) * nb, dtype=torch.uint8,
                       device=f0.device)
    dist.all_to_all_single(recv, send, [len(r) * nb for r in recvs],
                           [len(q) * nb for q in sends], group=group)
    off = 0
    for dsts in recvs:
        for d in dsts:
            out[d - base] = _unbytes(recv[off:off + nb], f0.dtype, f0.shape)
            off += nb
    return out


# ---------------------------------------------------------------------------
# global-view eager operators (paper Table I)
# ---------------------------------------------------------------------------
def _blocks(x: torch.Tensor, ctx: HPTMTContext) -> List[torch.Tensor]:
    """The row block of each shard this process holds."""
    return list(_split(x, ctx.n_local, 0, "row blocks"))


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
    return spmd_allreduce(_heads(x, ctx), op, group=ctx.group)[0]


@operator("array.allgather", Abstraction.ARRAY)
def allgather(x, *, ctx: HPTMTContext):
    """AllGather: every shard receives the concatenation of all shards."""
    if ctx.n_shards == 1:
        return x
    return spmd_allgather(_blocks(x, ctx), group=ctx.group)[0]


@operator("array.alltoall", Abstraction.ARRAY)
def alltoall(x, *, ctx: HPTMTContext):
    """AllToAll: transpose the (shard, block) layout of a row-sharded array."""
    if ctx.n_shards == 1:
        return x
    return torch.cat(spmd_alltoall(_blocks(x, ctx), group=ctx.group))


@operator("array.reduce_scatter", Abstraction.ARRAY)
def reduce_scatter(x, *, ctx: HPTMTContext):
    """ReduceScatter: sum shard contributions, scatter result row-blocks."""
    if ctx.n_shards == 1:
        return x
    return torch.cat(spmd_reduce_scatter([x] * ctx.n_local, group=ctx.group))


@operator("array.broadcast", Abstraction.ARRAY)
def broadcast(x, *, ctx: HPTMTContext, root: int = 0):
    """Broadcast: shard ``root``'s block to every shard (replicated)."""
    if ctx.n_shards == 1:
        return x[root]
    return spmd_broadcast(_heads(x, ctx), root, group=ctx.group)[0]


@operator("array.gather", Abstraction.ARRAY)
def gather(x, *, ctx: HPTMTContext, root: int = 0):
    """Gather: concatenation of all shards on ``root`` (zeros elsewhere)."""
    if ctx.n_shards == 1:
        return x[None]
    return torch.stack(spmd_gather(_blocks(x, ctx), root, group=ctx.group))


@operator("array.scatter", Abstraction.ARRAY)
def scatter(x, *, ctx: HPTMTContext, root: int = 0):
    """Scatter: split ``root``'s (replicated) buffer into one block/shard."""
    if ctx.n_shards == 1:
        return x
    return torch.cat(spmd_scatter([x] * ctx.n_local, root, group=ctx.group))


@operator("array.reduce", Abstraction.ARRAY)
def reduce(x, *, ctx: HPTMTContext, root: int = 0, op: str = "sum"):
    """Reduce: combined value in ``root``'s block, zeros elsewhere."""
    if ctx.n_shards == 1:
        if op not in ("sum", "max", "min", "mean"):
            raise KeyError(op)
        return _local_reduce(x, op, keepdim=True)
    return torch.stack(spmd_reduce(_heads(x, ctx), root, op,
                                   group=ctx.group))
