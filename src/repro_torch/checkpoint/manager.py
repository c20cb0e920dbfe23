"""Checkpoint/restart with atomic commits and elastic re-sharding.

Implements the paper's fault-tolerance prescription (§VII-F): recovery
happens *outside* operator code — the trainer periodically snapshots, and
on restart the checkpoint is loaded back onto the device the caller
names (``restore(..., device=...)``) and, on a process group, re-laid out
onto the target mesh (``shardings=``): a state saved by 4 ranks restores
on 2, each rank reading only its own blocks (the reference's
``device_put`` onto a target ``NamedSharding``).

A tree is nested dicts, lists and tuples of tensors — ``nn.Module.
state_dict()`` for instance.  Leaves are named as the reference names
them (its ``_leaf_paths``: dict keys sorted, path parts joined by
``__``), so a checkpoint written by either package is read by the other.

Layout: ``<dir>/step_<n>/`` with one ``.npy`` per leaf (the whole,
global leaf, however many ranks saved it) + ``manifest.json``; a
``LATEST`` file is written last (atomic rename) so a crash mid-save never
corrupts the recovery point.  Saves can run on a background thread; the
leaves are copied to host memory before the thread sees them.

Integrity (reference DESIGN.md §13.5): each manifest leaf records a CRC32
of the host bytes at save time; ``restore`` re-hashes what it read and
raises :class:`CheckpointIntegrityError` on bit-rot, dtype drift
(manifest vs template — no silent casting), or shape mismatch.

bfloat16 leaves are written as the reference writes its ml_dtypes
bfloat16 arrays: the ``.npy`` header's descr is ``'<V2'``, the manifest
dtype ``"bfloat16"``, the CRC over the same two bytes a value.  They are
read back by viewing those bytes as ``int16`` and the result as
``torch.bfloat16`` (numpy has no bfloat16; nothing here imports
ml_dtypes).  The reference cannot restore such a leaf itself on jax
0.9.0: casting numpy's ``|V2`` to bfloat16 raises there.
"""
from __future__ import annotations

import collections
import concurrent.futures
import functools
import json
import os
import shutil
import threading
import zlib
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from ..core.context import DeviceLike, resolve_device


class CheckpointIntegrityError(ValueError):
    """A checkpoint leaf failed validation against its manifest (bad CRC,
    dtype drift, or shape mismatch).  Subclasses ``ValueError`` so callers
    written against the old shape-check contract keep working."""


#: torch dtype → the manifest's dtype name (numpy's, or ml_dtypes' for
#: bfloat16, as the reference's ``str(arr.dtype)`` writes them)
_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.bool: "bool"}


def _dtype_name(dtype: torch.dtype) -> str:
    if dtype in _DTYPE_NAMES:
        return _DTYPE_NAMES[dtype]
    return str(torch.empty((), dtype=dtype).numpy().dtype)


def _flatten(tree, path: Tuple[str, ...], names: List[str],
             leaves: List[torch.Tensor]) -> Callable[[list], Any]:
    """Depth-first leaves of ``tree`` in the reference's order, with a
    rebuild function that takes the leaves back in that order."""
    if isinstance(tree, collections.OrderedDict):
        keys = list(tree)  # the reference keeps an OrderedDict's order
    elif isinstance(tree, dict):
        keys = sorted(tree)
    else:
        keys = None
    if keys is not None:
        subs = [_flatten(tree[k], path + (str(k),), names, leaves)
                for k in keys]
        kind = type(tree)

        def rebuild(it):
            out = {k: f(it) for k, f in zip(keys, subs)}
            return kind(out) if kind is collections.OrderedDict else out
        return rebuild
    if isinstance(tree, (list, tuple)):
        subs = [_flatten(v, path + (str(i),), names, leaves)
                for i, v in enumerate(tree)]
        kind = type(tree)
        return lambda it: kind(f(it) for f in subs)
    if tree is None:  # an empty subtree, as the reference treats it
        return lambda it: None
    names.append("__".join(path) or "leaf")
    leaves.append(tree)
    return lambda it: next(it)


def _leaf_paths(tree):
    names: List[str] = []
    leaves: List[torch.Tensor] = []
    rebuild = _flatten(tree, (), names, leaves)
    return names, leaves, lambda new: rebuild(iter(new))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host tensor → numpy array holding the same bytes (bfloat16 as its
    raw 16-bit patterns, in an ``int16`` array)."""
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy()
    return t.contiguous().numpy()


def _save_npy(path: str, t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """Write one leaf; returns the bytes written (as an array) and the
    manifest dtype name."""
    arr = _to_numpy(t)
    if t.dtype == torch.bfloat16:
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False,
                    "shape": tuple(arr.shape)})
            f.write(arr.tobytes())
    else:
        np.save(path, arr)
    return arr, _dtype_name(t.dtype)


def _world_group():
    """The world group when this process is one rank of several (a
    ``torch.distributed`` group is up), else ``None``."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def _spec_leaves(tree, specs, out: list) -> list:
    """The spec of each of ``tree``'s leaves, in :func:`_leaf_paths`'
    order: ``specs`` mirrors ``tree`` down to its leaves, where it holds a
    spec tuple; ``None`` for a leaf or a subtree means whole on every
    rank."""
    if isinstance(tree, dict):
        keys = (list(tree) if isinstance(tree, collections.OrderedDict)
                else sorted(tree))
        for k in keys:
            _spec_leaves(tree[k], None if specs is None else specs[k], out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _spec_leaves(v, None if specs is None else specs[i], out)
    elif tree is not None:
        out.append(None if specs is None else tuple(specs))
    return out


def _crc(arr: np.ndarray) -> int:
    """CRC32 of an array's bytes (a memory map is read, not copied)."""
    return zlib.crc32(memoryview(np.ascontiguousarray(arr).reshape(-1)
                                 .view(np.uint8))) & 0xFFFFFFFF


class CheckpointManager:
    """Saves and restores trees of tensors under ``directory``.

    On a process group (``torch.distributed`` initialised with more than
    one rank) ``save`` and ``restore`` are collectives every rank calls,
    and ``directory`` is one directory every rank sees.  ``shardings`` is
    ``(specs, mesh)``: ``specs`` mirrors the tree with one partition spec
    a leaf (``sharding.partition.param_specs``'s tuples; ``None`` for a
    leaf whole on every rank) and ``mesh`` is the ``sharding.axes.
    GroupMesh`` the leaves are blocks of.

    Save gathers each leaf whole (``partition.gather_tensor``, one leaf at
    a time) and leaf ``i`` is written by rank ``i % world``: the files
    are what one process writes for the gathered tree, byte for byte.  A
    rank holds one whole leaf at a time on its device, and on the host
    the whole leaves it writes — about ``1 / world`` of the checkpoint.
    The commit stays atomic: rank 0 renames the step directory and then
    replaces ``LATEST``, only after every rank reported its files on
    disk; a rank that fails before leaves the old ``LATEST`` and makes
    every rank raise.  With ``async_save`` the gathers run on the calling
    thread (a second thread's collectives would race the train step's on
    the same group) and only the file writes run in the background; the
    commit, a collective, runs in :meth:`wait` — called by the next
    ``save`` or ``restore``, or by the caller.

    Restore reads, on each rank, only its block of each leaf under the
    target ``shardings`` (a memory map and a slice), whatever mesh saved
    it; ``template`` gives the global shapes and dtypes (meta tensors
    will do).  Leaf ``i``'s CRC is checked by rank ``i % world``, which
    reads the leaf whole; an integrity error on any rank raises on every
    rank.
    """

    def __init__(self, directory: str, async_save: bool = False):
        self.directory = directory
        self._group = _world_group()
        self._rank, self._world = 0, 1
        if self._group is not None:
            import torch.distributed as dist
            self._rank, self._world = dist.get_rank(), dist.get_world_size()
        os.makedirs(directory, exist_ok=True)
        self._pool = (concurrent.futures.ThreadPoolExecutor(max_workers=1)
                      if async_save else None)
        self._pending: Optional[concurrent.futures.Future] = None
        self._pending_step: Optional[int] = None
        self._lock = threading.Lock()

    def _paths(self, step: int) -> Tuple[str, str]:
        final = os.path.join(self.directory, f"step_{step}")
        return final, final + ".tmp"

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, shardings=None) -> None:
        from ..core.array_ops import raise_together
        from ..sharding.partition import gather_tensor

        self.wait()
        names, leaves, _ = _leaf_paths(tree)
        specs, mesh = shardings if shardings is not None else (None, None)
        specs = _spec_leaves(tree, specs, [])
        if self._group is not None:
            err = None
            if self._rank == 0:
                try:
                    self._prepare(step)
                except Exception as e:  # noqa: BLE001 — every rank raises
                    err = e
            raise_together(err, self._group)
        # pull off the device now (a copy even for a host tensor), so the
        # caller may update its parameters while a background save runs
        mine = []
        for i, (name, x, spec) in enumerate(zip(names, leaves, specs)):
            if spec is not None and mesh is not None:
                x = gather_tensor(x, spec, mesh)
            if i % self._world == self._rank:
                mine.append((i, name, x.detach().cpu() if x.is_cuda
                             else x.detach().clone()))
        if self._group is None:
            job = functools.partial(self._write, step, mine)
        else:
            job = functools.partial(self._write_leaves,
                                    self._paths(step)[1], mine)
        if self._pool is not None:
            self._pending = self._pool.submit(job)
            self._pending_step = step
        elif self._group is None:
            job()
        else:
            self._commit_group(step, job)

    def _prepare(self, step: int) -> None:
        _, tmp = self._paths(step)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

    @staticmethod
    def _write_leaves(tmp: str, leaves) -> List[dict]:
        """Write ``(index, name, host tensor)`` leaves → their manifest
        entries, with the index."""
        entries = []
        for i, name, t in leaves:
            fname = f"{name}.npy"
            arr, dtype = _save_npy(os.path.join(tmp, fname), t)
            entries.append({"index": i, "name": name, "file": fname,
                            "shape": list(arr.shape), "dtype": dtype,
                            "crc32": zlib.crc32(arr.tobytes()) & 0xFFFFFFFF})
        return entries

    def _commit(self, step: int, entries: List[dict]) -> None:
        """Manifest, then the atomic renames: the step directory, then
        ``LATEST``."""
        final, tmp = self._paths(step)
        entries = sorted(entries, key=lambda e: e["index"])
        manifest = {"step": step, "leaves": [
            {k: v for k, v in e.items() if k != "index"} for e in entries]}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                    # atomic commit
        with open(os.path.join(self.directory, "LATEST.tmp"), "w") as f:
            f.write(str(step))
        os.replace(os.path.join(self.directory, "LATEST.tmp"),
                   os.path.join(self.directory, "LATEST"))

    def _write(self, step: int, leaves) -> None:
        """One process: write every leaf and commit."""
        with self._lock:
            self._prepare(step)
            self._commit(step, self._write_leaves(self._paths(step)[1],
                                                  leaves))

    def _commit_group(self, step: int, part: Callable[[], List[dict]]
                      ) -> None:
        """Every rank's files on disk (``part`` returns this rank's
        entries), then rank 0 commits; any failure raises on every rank."""
        from ..core.array_ops import gather_objects, raise_together

        err, entries = None, []
        try:
            entries = part()
        except Exception as e:  # noqa: BLE001 — every rank raises
            err = e
        raise_together(err, self._group)
        every = [e for rank in gather_objects(entries, self._group)
                 for e in rank]
        err = None
        if self._rank == 0:
            try:
                self._commit(step, every)
            except Exception as e:  # noqa: BLE001 — every rank raises
                err = e
        raise_together(err, self._group)

    def wait(self) -> None:
        """Finish a background save (on a group: its commit, a collective
        every rank calls)."""
        if self._pending is None:
            return
        fut, self._pending = self._pending, None
        if self._group is None:
            fut.result()
        else:
            self._commit_group(self._pending_step, fut.result)

    # -- restore -----------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.directory, "LATEST")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return int(f.read().strip())

    def restore(self, template: Any, step: Optional[int] = None,
                shardings=None, device: DeviceLike = None) -> Any:
        """Load a checkpoint into ``template``'s structure, every leaf on
        ``device`` (the card unless the caller names another) — with
        ``shardings``, this rank's block of each leaf."""
        from ..core.array_ops import raise_together

        self.wait()
        dev = resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        d = os.path.join(self.directory, f"step_{step}")
        names, leaves, rebuild = _leaf_paths(template)
        specs, mesh = shardings if shardings is not None else (None, None)
        specs = _spec_leaves(template, specs, [])
        out, err = [], None
        try:
            meta = {}
            mpath = os.path.join(d, "manifest.json")
            if os.path.exists(mpath):  # the oldest checkpoints lack one
                with open(mpath) as f:
                    meta = {e["name"]: e for e in json.load(f)["leaves"]}
            for i, (name, tmpl, spec) in enumerate(zip(names, leaves,
                                                       specs)):
                t = self._read_leaf(d, name, tmpl, meta.get(name), spec,
                                    mesh, i % self._world == self._rank)
                out.append(t.to(dev))
        except Exception as e:  # noqa: BLE001 — every rank raises
            err = e
        raise_together(err, self._group)
        return rebuild(out)

    @staticmethod
    def _read_leaf(d: str, name: str, tmpl, entry, spec, mesh,
                   check_crc: bool) -> torch.Tensor:
        """One leaf's block (the whole leaf without a spec), checked
        against the template and the manifest."""
        from ..sharding.partition import block_slices

        path = os.path.join(d, f"{name}.npy")
        try:
            arr = np.load(path, mmap_mode="r")
        except ValueError as e:            # a header or size that lies
            raise CheckpointIntegrityError(
                f"checkpoint leaf {name}: {path} is unreadable ({e})") from e
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise CheckpointIntegrityError(
                f"checkpoint leaf {name}: shape {arr.shape} != "
                f"template {tuple(tmpl.shape)}")
        want = _dtype_name(tmpl.dtype)
        if entry is not None:
            if entry["dtype"] != want:
                raise CheckpointIntegrityError(
                    f"checkpoint leaf {name}: saved dtype "
                    f"{entry['dtype']} != template {want}; refusing to "
                    f"silently cast — resave or fix the template")
            crc = entry.get("crc32")
            if crc is not None and check_crc:
                got = _crc(arr)
                if got != crc:
                    raise CheckpointIntegrityError(
                        f"checkpoint leaf {name}: CRC mismatch "
                        f"(manifest {crc:#010x}, file {got:#010x}) — "
                        f"{path} is corrupt")
        if tmpl.dtype == torch.bfloat16 and arr.dtype.itemsize != 2:
            raise CheckpointIntegrityError(
                f"checkpoint leaf {name}: {arr.dtype} holds no bfloat16")
        if spec is not None and mesh is not None:
            arr = arr[block_slices(arr.shape, spec, mesh)]
        arr = np.array(arr)                      # this block, off the map
        if tmpl.dtype == torch.bfloat16:
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        t = torch.from_numpy(arr)
        if t.dtype != tmpl.dtype:
            raise CheckpointIntegrityError(
                f"checkpoint leaf {name}: file dtype {arr.dtype} != "
                f"template {want}")
        return t
