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

The sharded model and train step move activations, weights and
gradients over ONE axis of a mesh of ranks at a time
(:func:`axis_all_gather`, :func:`axis_reduce_scatter`,
:func:`axis_all_reduce`, and Megatron's pair :func:`copy_to_axis` /
:func:`reduce_from_axis`), each a ``torch.autograd.Function`` whose
backward is its dual; built on the same two calls and folded in rank
order, they are counted by kind and axis in :data:`MODEL_COLLECTIVES`,
not in :data:`EXCHANGES`.  Serving adds two without a gradient, one
all-gather each: :func:`vocab_argmax` (greedy sampling over vocab-split
logits) and :func:`merge_softmax` (attention over a sequence-sharded KV
cache).

:data:`SORTS` counts the port's stable lexicographic sorts
(``core/exchange.py:lex_order``, the one sort choke point); it stands in
for the reference tests' jaxpr ``"sort["`` check of the ordered
operators (DESIGN.md §9: a window on a range layout sorts nothing).
"""
from __future__ import annotations

import contextlib
import operator as _op
import pickle
import time
from typing import Dict, List, Sequence, Tuple

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


def transport_device(group) -> torch.device:
    """Where the group's collectives take their tensors: the rank's
    current card under NCCL, the host under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def gather_objects(obj, group=None) -> list:
    """Every rank's picklable ``obj``, in rank order (``[obj]`` without a
    group): the pickles' bytes, padded to the longest, through the
    group's all-gather.  For host metadata (file lists, row counts,
    errors), never for rows of a table; the bytes come only from this
    program's own ranks."""
    if group is None:
        return [obj]
    dev = transport_device(group)
    data = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
    sizes = _gather_stack(torch.tensor([data.numel()], device=dev),
                          group).tolist()
    buf = torch.zeros((1, max(sizes)), dtype=torch.uint8)
    buf[0, :data.numel()] = data
    every = _gather_stack(buf.to(dev), group).cpu()
    return [pickle.loads(every[r, :n].numpy().tobytes())
            for r, n in enumerate(sizes)]


def raise_together(error, group=None) -> None:
    """Make one rank's failure every rank's: each rank passes the
    exception it caught (or ``None``), and if any rank failed, every rank
    raises — its own exception, or else the lowest failing rank's.  No
    rank is left waiting in a later collective its peers never call."""
    raise_first(error, [error] if group is None
                else gather_objects(picklable(error), group))


def raise_first(error, every) -> None:
    """Raise this rank's ``error``, or else the first exception of
    ``every`` (each rank's, in rank order); nothing when all are
    ``None``."""
    if error is not None:
        raise error
    failed = [(r, e) for r, e in enumerate(every) if e is not None]
    if failed:
        rank, exc = failed[0]
        raise exc from RuntimeError(f"rank {rank} failed")


def picklable(error):
    """``error`` itself when it pickles, else a ``RuntimeError`` naming it."""
    if error is None:
        return None
    try:
        pickle.loads(pickle.dumps(error))
        return error
    except Exception:  # noqa: BLE001 — an unpicklable exception
        return RuntimeError(f"{type(error).__name__}: {error}")


def barrier(group=None) -> None:
    """Every rank of ``group`` here before any goes on (through the
    group's all-gather, so it works over gloo and NCCL alike)."""
    if group is not None:
        gather_objects(None, group)


def on_rank0(fn, group=None):
    """``fn()`` on rank 0 alone (the one process, without a group), in
    one round: every rank gets rank 0's value, or raises its failure."""
    out, err = None, None
    if group_rank(group) == 0:
        try:
            out = fn()
        except Exception as e:  # noqa: BLE001 — every rank raises
            err = e
    if group is not None:
        out, first = gather_objects((out, picklable(err)), group)[0]
        raise_first(err, [first])
    elif err is not None:
        raise err
    return out


def shared_tempdir(prefix: str, dir=None, group=None) -> str:
    """A fresh scratch directory for the whole group: rank 0 makes it
    with ``tempfile.mkdtemp(prefix=prefix, dir=dir)`` (first ``dir``
    itself when it is missing) and every rank gets its path.  The ranks
    must see one file system (one host, or a ``dir`` they share); a
    failure on rank 0 raises on every rank."""
    import os
    import tempfile

    def make():
        if dir is not None:
            os.makedirs(dir, exist_ok=True)
        return tempfile.mkdtemp(prefix=prefix, dir=dir)

    return on_rank0(make, group)


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
        # every shard's frame has one shape, so the group's volume is
        # this rank's times the ranks
        EXCHANGES.log.append(group_size(group) * sum(
            f.numel() * f.element_size() for f in frames))
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


# ---------------------------------------------------------------------------
# model collectives over one axis of a mesh of ranks
# ---------------------------------------------------------------------------
# The sharded model and train step (``sharding/axes.py:GroupMesh``) move
# activations, weights and gradients over one mesh axis at a time: the
# axis's sub-group, this rank's coordinate on it.  Built, like the table
# transport above, from ``all_to_all_single`` and ``all_gather_into_tensor``
# on bytes only; every sum is folded here in rank order (never
# ``dist.all_reduce`` or ``dist.reduce_scatter_tensor``: gloo has no
# reduce-scatter, and a backend's order would make ranks differ in their
# last bits), so every rank of an axis holds the same bits.  An axis of
# size 1 moves nothing and is not counted.  None of these is a table
# exchange: they are counted in :data:`MODEL_COLLECTIVES`, by kind and
# axis, never in :data:`EXCHANGES`.
class Tally:
    """Calls counted by key (``"all_reduce/model"``), reset before a run
    and read after.  With ``timed`` set, each call waits for the device
    before and after and adds its seconds under its key too."""

    def __init__(self):
        self.counts: Dict[str, int] = {}
        self.seconds: Dict[str, float] = {}
        self.timed = False

    def reset(self) -> None:
        self.counts, self.seconds = {}, {}

    @contextlib.contextmanager
    def call(self, kind: str, axis: str, device: torch.device):
        key = f"{kind}/{axis}"
        self.counts[key] = self.counts.get(key, 0) + 1
        if not self.timed:
            yield
            return
        sync = (torch.cuda.synchronize if device.type == "cuda"
                else (lambda _d: None))
        sync(device)
        t0 = time.perf_counter()
        yield
        sync(device)
        self.seconds[key] = (self.seconds.get(key, 0.0)
                             + time.perf_counter() - t0)


#: calls of the model collectives below, by kind and axis
MODEL_COLLECTIVES = Tally()


def _axis(mesh, axis: str) -> Tuple[object, int, int]:
    """``(group, size, this rank's coordinate)`` of ``axis`` (size 1 and
    no group for an axis the mesh lacks)."""
    if axis not in mesh:
        return None, 1, 0
    return mesh.groups[axis], mesh[axis], mesh.coords[axis]


def _exchange_blocks(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (n, ...): block ``d`` to rank ``d``; returns (n, ...), block
    ``s`` from rank ``s`` (one even ``all_to_all_single``)."""
    send = _bytes(x)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return _unbytes(recv, x.dtype, x.shape)


def _fold(blocks, op: str = "sum") -> torch.Tensor:
    """Combine a stack's blocks in rank order."""
    fn = _COMBINE[op]
    out = blocks[0]
    for b in blocks[1:]:
        out = fn(out, b)
    return out


def _gather_dim(x, mesh, axis, dim):
    group, n, _ = _axis(mesh, axis)
    with MODEL_COLLECTIVES.call("all_gather", axis, x.device):
        stack = _gather_stack(x.unsqueeze(0), group)
    return torch.cat(list(stack.unbind(0)), dim=dim)


def _scatter_dim(x, mesh, axis, dim):
    group, n, _ = _axis(mesh, axis)
    send = torch.stack(_split(x, n, dim, "reduce_scatter"))
    with MODEL_COLLECTIVES.call("reduce_scatter", axis, x.device):
        recv = _exchange_blocks(send, group)
    return _fold(recv.unbind(0))


def _reduce(x, mesh, axis, op: str = "sum"):
    group, n, _ = _axis(mesh, axis)
    with MODEL_COLLECTIVES.call("all_reduce", axis, x.device):
        if op != "sum":
            return _fold(_gather_stack(x.unsqueeze(0), group).unbind(0), op)
        # a reduce-scatter of the flat value, then an all-gather: each
        # chunk folded in rank order on the rank that owns it
        flat = x.reshape(-1)
        pad = (-flat.numel()) % n
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        send = flat.reshape(n, -1)
        part = _fold(_exchange_blocks(send, group).unbind(0))
        full = _gather_stack(part.unsqueeze(0), group).reshape(-1)
    return full[:x.numel()].reshape(x.shape)


def _dim(x: torch.Tensor, dim: int) -> int:
    return dim % x.dim()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, backward):
        ctx.meta = (mesh, axis, dim, backward)
        return _gather_dim(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, how = ctx.meta
        if how == "slice":
            _, n, coord = _axis(mesh, axis)
            g = g.narrow(dim, coord * (g.shape[dim] // n), g.shape[dim] // n)
        else:
            g = _scatter_dim(g, mesh, axis, dim)
        return g.contiguous(), None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.meta = (mesh, axis, dim)
        return _scatter_dim(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.meta
        return _gather_dim(g, mesh, axis, dim), None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.meta = (mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, *ctx.meta), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _moves(mesh, axis) -> bool:
    return _axis(mesh, axis)[1] > 1


def axis_all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0,
                    backward: str = "reduce_scatter") -> torch.Tensor:
    """The blocks of ``axis``'s ranks concatenated along ``dim``, in
    coordinate order.  Backward ``"reduce_scatter"``: each rank's consumer
    did its own work (an FSDP weight used on the rank's batch rows), so
    the gradients are summed and scattered back.  ``"slice"``: the
    consumers are replicated over ``axis`` (every rank computes the same
    thing from the whole tensor), so each rank's gradient is already the
    whole one and it keeps its own block."""
    if not _moves(mesh, axis):
        return x
    if backward not in ("reduce_scatter", "slice"):
        raise ValueError(f"backward={backward!r}")
    return _AllGather.apply(x, mesh, axis, _dim(x, dim), backward)


def axis_reduce_scatter(x: torch.Tensor, mesh, axis: str,
                        dim: int = 0) -> torch.Tensor:
    """The sum over ``axis``'s ranks, each keeping its block along
    ``dim``; backward is the all-gather."""
    if not _moves(mesh, axis):
        return x
    return _ReduceScatter.apply(x, mesh, axis, _dim(x, dim))


def axis_all_reduce(x: torch.Tensor, mesh, axis: str,
                    op: str = "sum") -> torch.Tensor:
    """The ``sum``/``max``/``min`` over ``axis``'s ranks on every rank (no
    gradient: gradients' own reductions, a row max)."""
    if not _moves(mesh, axis):
        return x
    return _reduce(x.detach(), mesh, axis, op)


def copy_to_axis(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Megatron's "copy into the parallel region": the identity forward;
    backward sums the ranks' partial gradients of the replicated ``x``."""
    if not _moves(mesh, axis):
        return x
    return _CopyTo.apply(x, mesh, axis)


def reduce_from_axis(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Megatron's "reduce out of the parallel region": the sum of the
    ranks' partial ``x`` forward; backward is the identity (the replicated
    result's gradient is every rank's own)."""
    if not _moves(mesh, axis):
        return x
    return _ReduceFrom.apply(x, mesh, axis)


# ---------------------------------------------------------------------------
# inference collectives over one axis (serving; no gradient)
# ---------------------------------------------------------------------------
def _gather_axis(x: torch.Tensor, mesh, axis: str, kind: str) -> list:
    """Every rank's ``x`` over ``axis``, in coordinate order (one
    all-gather, counted under ``kind``)."""
    group, _, _ = _axis(mesh, axis)
    with MODEL_COLLECTIVES.call(kind, axis, x.device):
        return list(_gather_stack(x.unsqueeze(0), group).unbind(0))


def vocab_argmax(logits: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``argmax`` over the last dimension of logits split over ``axis``
    (this rank's block of ``V / M`` columns) → the global indices, int64,
    on every rank: ``torch.argmax`` of the whole row.

    Each rank's largest value and its global index travel in one gather
    (float64 holds both exactly); the fold in coordinate order keeps the
    first of equal values, so a tie goes to the lowest index."""
    idx = torch.argmax(logits, dim=-1)
    if not _moves(mesh, axis):
        return idx
    best = logits.gather(-1, idx.unsqueeze(-1)).squeeze(-1)
    idx = idx + mesh.coords[axis] * logits.shape[-1]
    pair = torch.stack([best.to(torch.float64), idx.to(torch.float64)], -1)
    every = _gather_axis(pair, mesh, axis, "argmax")
    out = every[0]
    for p in every[1:]:
        out = torch.where(p[..., :1] > out[..., :1], p, out)
    return out[..., 1].to(torch.int64)


def merge_softmax(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                  mesh, axis: str) -> torch.Tensor:
    """The softmax attention over a key axis split over ``axis`` from
    each rank's partial statistics: ``o`` the unnormalized float32
    ``sum_j exp(s_j - m) v_j`` over its keys, ``m`` its row max (``-1e30``
    where none of its keys is visible) and ``l`` its ``sum_j exp(s_j -
    m)``, both ``o``'s shape with a last dimension of 1.  Every rank's
    triple travels in one gather; the rescaled sums are added in
    coordinate order.  → ``O / L`` in float32 on every rank."""
    if not _moves(mesh, axis):
        return o / torch.clamp(l, min=1e-30)
    every = _gather_axis(torch.cat([o, m, l], dim=-1), mesh, axis,
                         "softmax_merge")
    top = every[0][..., -2:-1]
    for p in every[1:]:
        top = torch.maximum(top, p[..., -2:-1])
    big_o, big_l = None, None
    for p in every:
        scale = torch.exp(p[..., -2:-1] - top)
        po, pl = p[..., :-2] * scale, p[..., -1:] * scale
        big_o = po if big_o is None else big_o + po
        big_l = pl if big_l is None else big_l + pl
    return big_o / torch.clamp(big_l, min=1e-30)
