"""Checkpoint/restart with atomic commits.

Implements the paper's fault-tolerance prescription (§VII-F): recovery
happens *outside* operator code — the trainer periodically snapshots, and
on restart the checkpoint is loaded back onto the device the caller
names (``restore(..., device=...)``, in the place of the reference's
target shardings).

A tree is nested dicts, lists and tuples of tensors — ``nn.Module.
state_dict()`` for instance.  Leaves are named as the reference names
them (its ``_leaf_paths``: dict keys sorted, path parts joined by
``__``), so a checkpoint written by either package is read by the other.

Layout: ``<dir>/step_<n>/`` with one ``.npy`` per leaf + ``manifest.json``;
a ``LATEST`` file is written last (atomic rename) so a crash mid-save never
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
import json
import os
import shutil
import threading
import zlib
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from ..core.context import DeviceLike, refuse_in_group, resolve_device


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


class CheckpointManager:
    def __init__(self, directory: str, async_save: bool = False):
        refuse_in_group("the checkpoint manager", "11c")
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._pool = (concurrent.futures.ThreadPoolExecutor(max_workers=1)
                      if async_save else None)
        self._pending: Optional[concurrent.futures.Future] = None
        self._lock = threading.Lock()

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any) -> None:
        names, leaves, _ = _leaf_paths(tree)
        # pull off the device now (a copy even for a host tensor), so the
        # caller may update its parameters while a background save runs
        host = [x.detach().cpu() if x.is_cuda else x.detach().clone()
                for x in leaves]
        if self._pool is not None:
            self.wait()
            self._pending = self._pool.submit(self._write, step, names, host)
        else:
            self._write(step, names, host)

    def _write(self, step: int, names, host_leaves) -> None:
        with self._lock:
            final = os.path.join(self.directory, f"step_{step}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "leaves": []}
            for name, t in zip(names, host_leaves):
                fname = f"{name}.npy"
                arr, dtype = _save_npy(os.path.join(tmp, fname), t)
                manifest["leaves"].append(
                    {"name": name, "file": fname,
                     "shape": list(arr.shape), "dtype": dtype,
                     "crc32": zlib.crc32(arr.tobytes()) & 0xFFFFFFFF})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)                    # atomic commit
            with open(os.path.join(self.directory, "LATEST.tmp"), "w") as f:
                f.write(str(step))
            os.replace(os.path.join(self.directory, "LATEST.tmp"),
                       os.path.join(self.directory, "LATEST"))

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    # -- restore -----------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.directory, "LATEST")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return int(f.read().strip())

    def restore(self, template: Any, step: Optional[int] = None,
                device: DeviceLike = None) -> Any:
        """Load a checkpoint into ``template``'s structure, every leaf on
        ``device`` (the card unless the caller names another)."""
        self.wait()
        dev = resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        d = os.path.join(self.directory, f"step_{step}")
        names, leaves, rebuild = _leaf_paths(template)
        meta = {}
        mpath = os.path.join(d, "manifest.json")
        if os.path.exists(mpath):  # the oldest checkpoints lack one
            with open(mpath) as f:
                meta = {e["name"]: e for e in json.load(f)["leaves"]}
        out = []
        for name, tmpl in zip(names, leaves):
            arr = np.load(os.path.join(d, f"{name}.npy"))
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise CheckpointIntegrityError(
                    f"checkpoint leaf {name}: shape {arr.shape} != "
                    f"template {tuple(tmpl.shape)}")
            want = _dtype_name(tmpl.dtype)
            entry = meta.get(name)
            if entry is not None:
                if entry["dtype"] != want:
                    raise CheckpointIntegrityError(
                        f"checkpoint leaf {name}: saved dtype "
                        f"{entry['dtype']} != template {want}; refusing to "
                        f"silently cast — resave or fix the template")
                crc = entry.get("crc32")
                if crc is not None:
                    got = zlib.crc32(arr.tobytes()) & 0xFFFFFFFF
                    if got != crc:
                        raise CheckpointIntegrityError(
                            f"checkpoint leaf {name}: CRC mismatch "
                            f"(manifest {crc:#010x}, file {got:#010x}) — "
                            f"{os.path.join(d, name + '.npy')} is corrupt")
            if tmpl.dtype == torch.bfloat16:
                if arr.dtype.itemsize != 2:
                    raise CheckpointIntegrityError(
                        f"checkpoint leaf {name}: {arr.dtype} holds no "
                        f"bfloat16")
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
                if t.dtype != tmpl.dtype:
                    raise CheckpointIntegrityError(
                        f"checkpoint leaf {name}: file dtype {arr.dtype} != "
                        f"template {want}")
            out.append(t.to(dev))
        return rebuild(out)
