"""Process groups for the port: the counterpart of the reference's mesh.

The reference builds a TPU device mesh (``repro/launch/mesh.py``) and runs
its operators under ``shard_map`` on it.  The port's counterpart is a
``torch.distributed`` process group carried by an ``HPTMTContext``
(``core/context.py``): one process a rank, each holding ``n_shards //
world`` shards.  Two ways in:

  * :func:`group_context` — inside a process ``torchrun`` started::

        torchrun --nproc-per-node 4 my_job.py
        # my_job.py
        ctx = group_context(n_shards=4, backend="nccl")
        df = DataFrame.from_dict(data, ctx)      # every rank, same data

  * :func:`run_ranks` — from one Python process: ``world`` processes
    started with the *spawn* method (never fork: the caller may have CUDA
    initialised), meeting through a ``FileStore`` in a temporary
    directory, each calling ``fn(ctx, *args)``.

A mesh of ranks — the reference's ``make_mesh(dims, names)`` — is
:func:`mesh_context`: one sub-group per mesh axis over the group that
exists, each rank at its row-major coordinate.  ``run_ranks(..., dims=,
names=)`` builds it on every rank and hands it to ``fn`` instead of the
table context; the training launcher (``launch/train.py --mesh DxM``)
builds it from ``torchrun``'s group.

The caller names the backend (``"nccl"`` or ``"gloo"``) and the device;
nothing here switches either on its own.  On CUDA each rank's current
device is set before the group forms — a kernel launch goes to the
current device.  Every group gets a timeout, so a rank that waits for a
collective its peers never call fails instead of hanging.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.context import HPTMTContext
from ..sharding.axes import GroupMesh

#: seconds a collective, and a whole :func:`run_ranks` call, may take by
#: default
TIMEOUT_S = 300.0


def _rank_device(device: Optional[str], local_rank: int) -> Optional[str]:
    """Set and name the rank's CUDA device; a CPU device passes through."""
    if device is not None and torch.device(device).type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the ranks on the CPU")
    index = local_rank % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return f"cuda:{index}"


def group_context(n_shards: int, backend: str, *,
                  device: Optional[str] = None,
                  timeout_s: float = TIMEOUT_S) -> HPTMTContext:
    """Join the group ``torchrun`` describes in the environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
    return its context; ``device=None`` means this rank's card."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    dev = _rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
    if not dist.is_initialized():
        dist.init_process_group(
            backend, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
    return HPTMTContext(n_shards=n_shards, device=dev, group=dist.group.WORLD)


def mesh_context(dims: Sequence[int], names: Sequence[str]) -> GroupMesh:
    """The ``names`` mesh of ``dims`` over the world group that exists:
    one sub-group per axis (``None`` for an axis of size 1), this rank at
    coordinates ``np.unravel_index(rank, dims)`` — row-major, as
    ``jax.make_mesh`` lays devices out, so the last axis's ranks are
    neighbours.  ``prod(dims)`` must be the world size.

    Every rank creates every sub-group, in one order (``dist.new_group``
    is a collective over the world): axis by axis, and within an axis by
    the other coordinates, row-major."""
    dims, names = [int(d) for d in dims], tuple(names)
    if len(dims) != len(names):
        raise ValueError(f"mesh dims {dims} and names {names} differ in "
                         f"length")
    world = dist.get_world_size()
    if int(np.prod(dims)) != world:
        raise ValueError(f"a {'x'.join(map(str, dims))} mesh needs "
                         f"{int(np.prod(dims))} ranks; the world size is "
                         f"{world}")
    rank = dist.get_rank()
    grid = np.arange(world).reshape(dims)
    coords = dict(zip(names, (int(c) for c in
                              np.unravel_index(rank, dims))))
    groups = {}
    for i, axis in enumerate(names):
        groups[axis] = None
        if dims[i] == 1:
            continue
        lines = np.moveaxis(grid, i, -1).reshape(-1, dims[i])
        for ranks in lines:
            g = dist.new_group([int(r) for r in ranks])
            if rank in ranks:
                groups[axis] = g
    return GroupMesh(dict(zip(names, dims)), groups, coords)


def _rank_main(fn, rank, world, backend, device, n_shards, store_path,
               timeout_s, args, results, dims, names) -> None:
    """One spawned rank: form the group (and the mesh), run ``fn``, report
    to the parent."""
    try:
        dev = _rank_device(device, rank)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        if dims is not None:
            first = mesh_context(dims, names)
        else:
            first = HPTMTContext(n_shards=n_shards, device=dev,
                                 group=dist.group.WORLD)
        results.put((rank, True, fn(first, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, backend: str,
              device: Optional[str] = None, *,
              n_shards: Optional[int] = None, args: Sequence = (),
              dims: Optional[Sequence[int]] = None,
              names: Optional[Sequence[str]] = None,
              timeout_s: float = TIMEOUT_S) -> list:
    """``fn(ctx, *args)`` on ``world`` ranks, one spawned process each;
    returns what each rank's ``fn`` returned, in rank order.

    ``fn`` must be importable by name (a module-level function) and its
    result picklable.  ``n_shards`` defaults to ``world``.  With ``dims``
    and ``names`` each rank builds ``mesh_context(dims, names)`` and
    ``fn`` receives that mesh in place of ``ctx``.  The first rank
    that raises — or dies, or a run past ``timeout_s`` — makes this raise,
    with that rank's traceback, after every rank is stopped.
    """
    spawn = multiprocessing.get_context("spawn")
    results = spawn.Queue()
    out, deadline = {}, time.monotonic() + timeout_s
    with tempfile.TemporaryDirectory(prefix="hptmt_group_") as tmp:
        procs = [spawn.Process(
            target=_rank_main, daemon=True,
            args=(fn, r, world, backend, device, n_shards or world,
                  os.path.join(tmp, "store"), timeout_s, tuple(args),
                  results, dims, names)) for r in range(world)]
        for p in procs:
            p.start()
        try:
            while len(out) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world)) - set(out))} did "
                        f"not finish within {timeout_s} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    for r, p in enumerate(procs):
                        if r not in out and p.exitcode not in (None, 0):
                            raise RuntimeError(f"rank {r} died with exit "
                                               f"code {p.exitcode}")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                out[rank] = payload
        finally:
            for p in procs:
                p.join(timeout=10 if len(out) == world else 0)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [out[r] for r in range(world)]
