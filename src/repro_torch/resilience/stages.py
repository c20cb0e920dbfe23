"""Lineage stage checkpoints for planned pipelines (reference DESIGN.md §13.2).

``LazyFrame.collect(policy=FaultPolicy(checkpoint_dir=...))`` commits a
CRC-checked ``.hpt`` snapshot of every **stage boundary** — a physical
plan step that performs an exchange (``PlanStep.stage``) — as it
completes.  Snapshots are keyed by a deterministic **plan fingerprint**
(a canonical hash of the optimized logical tree + shard count), so a
restarted process recovers exactly the pipeline it crashed out of and
nothing else: recovery walks the planner's lineage, finds the last
committed stage, loads it from disk, and re-runs only the suffix —
bit-exact, because a snapshot stores the *full* static-shape buffers
(padding included) plus counts, partitioning, and the accumulated
overflow lineage.

Files are the reference's: a stage's ``data.hpt`` holds every column as
the reference's global ``(n_shards * capacity, ...)`` array (the port's
``(n_shards, capacity, ...)`` blocks flattened in shard order) and its
``meta.json`` the same keys, so for the same stage both packages write
the same bytes.

The fingerprint canonicalizes a callable payload (an opaque filter, a
``map_columns`` function) as ``module.qualname``, and the port's
modules are not the reference's: a plan holding a callable the port
defines gets a fingerprint of its own in each package.  A plan without
callables (predicate tuples, source tables, datasets) fingerprints the
same in both.

Commit protocol (crash-safe at every point): write ``data.hpt`` +
``meta.json`` into ``stage_<i>.tmp/``, fire the ``checkpoint.commit``
injection site, then ``os.rename`` to ``stage_<i>/`` — the same
tmp-then-rename discipline as ``io.native`` / ``checkpoint.manager``.
A reader only ever sees fully-committed stages; stale ``*.tmp`` dirs
from a crash are swept on open.

On a process group (``StageCheckpointer(..., group=)``, which
``collect(policy=...)`` passes from its context) the stage directory is
one the whole group sees.  A commit gathers the stage's global arrays
(``DistTable.to_numpy_blocks``, a collective) and rank 0 alone writes
``data.hpt`` + ``meta.json`` — the virtual run's files, byte for byte;
every rank then fires the ``checkpoint.commit`` site, and rank 0 renames
only after every rank got there, each step's failure raised on every
rank.  A restore has each rank keep its own shards' blocks, so a
snapshot committed by 4 ranks resumes on 2 of the same ``n_shards`` (the
files are global arrays: resume is elastic).  Rank 0 alone sweeps stale
``*.tmp`` dirs and lists the committed stages for every rank.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import zlib
from typing import List, Optional, Tuple

from .. import telemetry
from ..core.array_ops import barrier, on_rank0, raise_together
from ..core.table import DistTable
from ..io.native import read_hpt, write_hpt

from . import faults


# ---------------------------------------------------------------------------
# plan fingerprint
# ---------------------------------------------------------------------------
def _canon_value(key: str, v) -> str:
    if key == "table":  # source DistTable: schema + counts + data identity
        cols, counts, _ = v.to_numpy_blocks()   # every shard's, on a group
        crc = 0
        for name in sorted(cols):
            crc = zlib.crc32(cols[name].tobytes(), crc)
            crc = zlib.crc32(f"{name}:{cols[name].dtype}".encode(), crc)
        return (f"table(cols={list(sorted(cols))},"
                f"counts={counts.tolist()},"
                f"part={v.partitioning!r},crc={crc:08x})")
    if key == "dataset":
        frags = sorted((f.path, int(f.rows), f.shard)
                       for f in v.fragments)
        return f"dataset({frags!r},schema={list(v.schema.names)!r})"
    if callable(v):
        return f"fn({getattr(v, '__module__', '?')}." \
               f"{getattr(v, '__qualname__', repr(v))})"
    if isinstance(v, (tuple, list)):
        return repr([_canon_value("", x) for x in v])
    if isinstance(v, dict):
        return repr(sorted((k, _canon_value("", x)) for k, x in v.items()))
    return repr(v)


def _canon_node(node) -> str:
    payload = ";".join(f"{k}={_canon_value(k, v)}"
                       for k, v in sorted(node.payload.items()))
    kids = ",".join(_canon_node(i) for i in node.inputs)
    return f"{node.kind}[{payload}]({kids})"


def plan_fingerprint(root, ctx) -> str:
    """Deterministic identity of (optimized logical plan, shard count):
    equal across processes for the same pipeline over the same data, so
    a restart resumes its own stages and never someone else's — on any
    number of ranks (a collective on a group: source tables are read
    whole)."""
    text = f"shards={ctx.n_shards}|{_canon_node(root)}"
    return hashlib.sha256(text.encode()).hexdigest()[:24]


# ---------------------------------------------------------------------------
# partitioning (de)serialization — the three metadata forms of core.table
# ---------------------------------------------------------------------------
def _part_to_json(part):
    if part is None:
        return None
    if part[0] == "range":
        return {"kind": "range", "keys": list(part[1]),
                "ascending": [bool(a) for a in part[2]], "n": int(part[3])}
    return {"kind": "hash", "keys": list(part[0]), "n": int(part[1])}


def _part_from_json(d):
    if d is None:
        return None
    if d["kind"] == "range":
        return ("range", tuple(d["keys"]),
                tuple(bool(a) for a in d["ascending"]), int(d["n"]))
    return (tuple(d["keys"]), int(d["n"]))


# ---------------------------------------------------------------------------
# stage checkpoint store
# ---------------------------------------------------------------------------
class StageCheckpointer:
    """One pipeline's stage snapshots: ``<root>/<fingerprint>/stage_<i>/``
    (``group``: the process group that shares ``root_dir``)."""

    def __init__(self, root_dir: str, fingerprint: str, group=None):
        self.dir = os.path.join(root_dir, fingerprint)
        self.group = group
        on_rank0(self._open, group)

    def _open(self) -> None:
        os.makedirs(self.dir, exist_ok=True)
        for name in os.listdir(self.dir):  # sweep torn commits
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)

    def _stage_dir(self, index: int) -> str:
        return os.path.join(self.dir, f"stage_{index}")

    def committed_stages(self) -> List[int]:
        """The committed stage indices (rank 0's listing, on every rank)."""
        def listing():
            out = []
            for name in os.listdir(self.dir):
                if name.startswith("stage_") and not name.endswith(".tmp") \
                        and os.path.exists(os.path.join(self.dir, name,
                                                        "meta.json")):
                    out.append(int(name[len("stage_"):]))
            return sorted(out)

        return on_rank0(listing, self.group)

    def commit(self, index: int, dt: DistTable,
               ovs: List[Tuple[str, object]], *, op: str = "") -> str:
        """Atomically snapshot one completed stage (full buffers +
        counts + partitioning + overflow lineage so far)."""
        final = self._stage_dir(index)
        tmp = final + ".tmp"
        cols, counts, part = dt.to_numpy_blocks()

        def write():
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            rows = next(iter(cols.values())).shape[0] if cols else 0
            write_hpt(os.path.join(tmp, "data.hpt"), cols, rows)
            meta = {"stage": int(index), "op": op,
                    "n_shards": int(dt.n_shards),
                    "capacity": int(dt.capacity),
                    "counts": counts.tolist(),
                    "partitioning": _part_to_json(part),
                    "ovs": [[label, int(v)] for label, v in ovs]}
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)

        def rename():
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # commit point: all-or-nothing

        on_rank0(write, self.group)
        err = None
        try:
            faults.fire("checkpoint.commit", path=final)
        except Exception as e:  # noqa: BLE001 — every rank raises
            err = e
        raise_together(err, self.group)
        on_rank0(rename, self.group)
        return final

    def restore(self, index: int, ctx) -> Tuple[DistTable,
                                                List[Tuple[str, int]]]:
        """Load a committed stage back into a :class:`DistTable` on the
        context's device (CRC checked by the ``.hpt`` reader) + its
        overflow lineage."""
        d = self._stage_dir(index)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        cols, _ = read_hpt(os.path.join(d, "data.hpt"))
        dt = DistTable.from_numpy_blocks(
            cols, meta["counts"], _part_from_json(meta["partitioning"]),
            ctx=ctx)
        return dt, [(label, int(v)) for label, v in meta["ovs"]]

    def remove(self) -> None:
        """Delete the snapshots (rank 0, once every rank is done)."""
        barrier(self.group)
        on_rank0(lambda: shutil.rmtree(self.dir, ignore_errors=True),
                 self.group)


def stage_hook(ckpt: StageCheckpointer, *, ctx, policy=None,
               committed: Optional[set] = None, record=None):
    """Build the per-stage hook ``PhysicalPlan`` consults at run time.

    For a stage already committed on disk the hook returns the restored
    snapshot WITHOUT running the step's closure — the whole subtree
    below it is skipped, which is what makes a resumed run a strict
    suffix (counted at the exchange choke point).  Otherwise it runs the
    step and commits the result (never while ``torch.compile`` traces:
    commits are host I/O on concrete tensors).  On a group ``ckpt`` is
    the group's and the commit's retry is agreed across its ranks.
    """
    have = set(ckpt.committed_stages()) if committed is None else committed

    def hook(step, layout, thunk):
        if step.index in have:
            with telemetry.span("recovery.restore", stage=step.index,
                                op=step.op):
                out = ckpt.restore(step.index, ctx)
            if record is not None:
                record.metrics.count("recovery.stages_restored")
            return out
        out, ovs = thunk()
        if not telemetry.tracing():
            with telemetry.span("recovery.commit", stage=step.index,
                                op=step.op):
                if policy is not None:
                    policy.run(
                        lambda: ckpt.commit(step.index, out, ovs,
                                            op=step.op),
                        site="checkpoint.commit", group=ctx.group)
                else:
                    ckpt.commit(step.index, out, ovs, op=step.op)
            have.add(step.index)
            if record is not None:
                record.metrics.count("recovery.stages_committed")
        return out, ovs

    return hook
