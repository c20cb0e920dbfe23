"""What each rank runs for ``tests/test_torch_group_storage.py``.

The storage services and the TSet methods on a process group, and the
elastic checkpoint on meshes of ranks.  :func:`storage_cases` runs the
table cases on one context — the port's virtual 4-shard context in the
test process, or one rank of a ``gloo`` group that ``run_ranks`` spawned
(it imports this module by name, so it imports no JAX) — under a root
directory the test process made, and returns each result whole (gathered
column blocks, counts, partitioning, overflow), the files' digests, the
scans' stats and each case's exchange count.  The checkpoint functions
take the mesh ``run_ranks(..., dims=, names=)`` builds, or the table
context of a group on which they build the trainer's mesh themselves.
Inputs come from ``tests/torch_group_cases.py``'s seeded draws.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np
import torch

import torch_parity  # noqa: F401  (one intra-op thread a process)
from torch_group_cases import (EV_CAP, EVENTS, G_AGGS, LEFT, LEFT_CAP, QS,
                               RIGHT, RIGHT_CAP, frame_result, left_right,
                               table_result)
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import CheckpointIntegrityError
from repro_torch.core import DistTable, Table, array_ops
from repro_torch.core.dataflow import TSet
from repro_torch.dataframe import DataFrame
from repro_torch.io import ScanSource, has_pyarrow, pred, read_dataset
from repro_torch.io.native import CorruptFragmentError
from repro_torch.io.dataset import write_dist_table

FORMATS = ("hpt", "parquet") if has_pyarrow() else ("hpt",)
#: rows a fragment of the written datasets (several fragments a shard)
ROWS_PER_GROUP = 64
#: the pushdown dataset: LEFT sorted by k, fragments of 32 rows
K_BELOW = 64
#: ``from_shard_tables``: shard capacities and row counts, unequal
SHARD_CAPS, SHARD_ROWS = (40, 64, 16, 48), (40, 10, 0, 33)
#: the TSet chunks a table is cut into
TSET_CHUNKS = 4
#: the disk corpus: the pipeline's default corpus, reduced vocabulary
CORPUS_VOCAB = 128


def file_digests(root: str) -> dict:
    """``file name → blake2b`` of every file in ``root``."""
    out = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as f:
            out[name] = hashlib.blake2b(f.read(), digest_size=16).hexdigest()
    return out


def barrier(ctx) -> None:
    """Every rank here before any goes on (nothing without a group)."""
    array_ops.gather_objects(None, ctx.group)


class Exchanges:
    """Each case's exchange count in this process."""

    def __init__(self):
        self.n = {}

    def __call__(self, tag, fn):
        array_ops.EXCHANGES.reset()
        out = fn()
        self.n[tag] = array_ops.EXCHANGES.n
        return out


def _stats(st) -> dict:
    return dataclasses.asdict(st)


def dataset_cases(ctx, root: str, ex: Exchanges) -> dict:
    """Partitioned writes in each format, re-entry, the joins and the
    groupby after it, a write whose layout is already proven, an
    unpartitioned write, pushdown, the chunked scan into a TSet and a
    quarantined fragment."""
    out = {}
    left, right = left_right(ctx)
    for fmt in FORMATS:
        lroot, rroot = (os.path.join(root, f"{n}_{fmt}")
                        for n in ("left", "right"))
        ex(f"write_{fmt}", lambda: left.to_parquet(
            lroot, partition_by=["k"], format=fmt,
            rows_per_group=ROWS_PER_GROUP))
        right.to_parquet(rroot, partition_by=["k"], format=fmt)
        out[f"files_{fmt}"] = file_digests(lroot)
        lp = ex(f"read_{fmt}", lambda: DataFrame.read_parquet(lroot, ctx))
        rp = DataFrame.read_parquet(rroot, ctx)
        out[f"lp_{fmt}"] = frame_result(lp)
        out[f"join0_{fmt}"] = frame_result(ex(
            f"join0_{fmt}", lambda: lp.join(rp, ["k"])))
        out[f"join1_{fmt}"] = frame_result(ex(
            f"join1_{fmt}", lambda: lp.join(right, ["k"])))
        out[f"groupby0_{fmt}"] = frame_result(ex(
            f"groupby0_{fmt}", lambda: lp.groupby(["k"], [("v", "sum")])))
    proven = left.repartition(["k"])
    ex("write_proven", lambda: proven.to_hpt(
        os.path.join(root, "proven"), partition_by=["k"]))
    out["files_proven"] = file_digests(os.path.join(root, "proven"))
    plain = os.path.join(root, "plain")
    ex("write_plain", lambda: left.to_hpt(plain, rows_per_group=100))
    out["files_plain"] = file_digests(plain)
    out["plain"] = frame_result(DataFrame.read_dataset(plain, ctx))

    order = np.argsort(LEFT["k"], kind="stable")
    srt = os.path.join(root, "sorted")
    DataFrame.from_dict({k: v[order] for k, v in LEFT.items()}, ctx,
                        capacity=LEFT_CAP).to_hpt(srt, rows_per_group=32)
    dt, ov, st = read_dataset(srt, ctx=ctx, columns=["k", "v"],
                              predicate=pred("k", "<", K_BELOW))
    out["pushdown"] = dict(table_result(dt), ov=ov)
    out["pushdown_stats"] = _stats(st)

    src = ScanSource(os.path.join(root, "left_hpt"), ctx=ctx)
    out["scan_tset"] = table_result(ex("scan_tset", lambda: src.to_tset()
                                       .groupby(["k"], [("v", "sum")])
                                       .collect()))
    out["scan_tset_stats"] = _stats(src.stats)

    # one fragment of the unpartitioned dataset cut short: the strict
    # scan raises on every rank, the quarantining one skips it
    bad = sorted(f for f in os.listdir(plain) if f.endswith(".hpt"))[5]
    barrier(ctx)
    if ctx.rank == 0:
        with open(os.path.join(plain, bad), "rb") as f:
            raw = f.read()
        with open(os.path.join(plain, bad), "wb") as f:
            f.write(raw[:-8])
    barrier(ctx)
    try:
        read_dataset(plain, ctx=ctx)
        out["strict"] = ("returned", "")
    except Exception as e:  # noqa: BLE001 — the type is the answer
        out["strict"] = (type(e).__name__,
                         isinstance(e, CorruptFragmentError),
                         os.path.basename(bad) in str(e))
    dt, ov, st = read_dataset(plain, ctx=ctx, on_error="quarantine")
    out["quarantine"] = dict(table_result(dt), ov=ov)
    out["quarantine_stats"] = _stats(st)
    barrier(ctx)
    with open(os.path.join(plain, "_hptmt_quarantine.json")) as f:
        side = json.load(f)["quarantined"]
    out["sidecar"] = [dict(q, path=os.path.basename(q["path"]),
                           error=q["error"].replace(plain + os.sep, ""))
                      for q in side]
    return out


def shard_tables_case(ctx) -> dict:
    """``DistTable.from_shard_tables`` of four unequal shard tables."""
    rng = np.random.default_rng(11)
    tables = [Table.from_arrays(
        {"k": rng.integers(0, 99, cap).astype(np.int32),
         "v": rng.normal(size=cap).astype(np.float32)},
        num_rows=n, device=ctx.device) for cap, n in zip(SHARD_CAPS,
                                                         SHARD_ROWS)]
    return table_result(DistTable.from_shard_tables(
        tables, ctx, partitioning=(("k",), ctx.n_shards)))


def tset_cases(ctx, ex: Exchanges) -> dict:
    """Every TSet method outside the data pipeline's, on chunked tables."""
    left, right = left_right(ctx)
    ev = DataFrame.from_dict(EVENTS, ctx, capacity=EV_CAP)

    def chunks(df):
        return TSet.from_table(df.table, ctx,
                               chunk_rows=df.table.capacity // TSET_CHUNKS)

    lt, rt, et = chunks(left), chunks(right), chunks(ev)
    sinks = {
        "map_columns": lambda: lt.map_columns(
            lambda c: {"v2": c["v"] * 2.0, "k": c["k"] + 1}).collect(),
        "groupby_g": lambda: lt.groupby(["g"], G_AGGS).collect(),
        "groupby_k": lambda: lt.select(lambda c: c["v"] > 0).groupby(
            ["k"], [("v", "sum"), ("v", "count")]).collect(),
        "join_groupby": lambda: lt.join(rt, ["k"]).groupby(
            ["g"], [("v", "sum"), ("w", "max")]).collect(),
        "orderby": lambda: lt.orderby(["g", "k"]).collect(),
        "union": lambda: lt.project(["k"]).union(rt.project(["k"]))
        .collect(),
        "window": lambda: et.window(["g"], ["t"], [("v", "sum"),
                                                   ("q", "max")],
                                    rows=4).collect(),
        "topk": lambda: et.topk("v", 8).collect(),
        "from_chunks": lambda: TSet.from_chunks(
            [left.table, left.table], ctx).project(["k", "v"]).collect(),
    }
    out = {}
    for name, fn in sinks.items():
        out[name] = table_result(ex(name, fn))
    for op in ("sum", "mean", "min", "max", "count"):
        out[f"reduce_{op}"] = ex(f"reduce_{op}", lambda: lt.reduce(
            "v", op)).cpu().numpy()
    out["quantile"] = ex("quantile", lambda: et.quantile(
        "v", QS, method="exact")).cpu().numpy()
    out["to_numpy"] = ex("to_numpy", lambda: lt.select(
        lambda c: c["g"] < 3).to_numpy())
    ts = lt.groupby(["g"], G_AGGS)
    ts.collect()
    out["report"] = sorted(ts.overflow_report.entries.items())
    return out


def corpus_case(ctx, root: str) -> dict:
    """The pipeline's corpus written to disk by this context's writer,
    then ``make_training_data(data_root=...)`` over it: the stream, two
    global batches and the corpus files' digests."""
    from repro_torch import configs
    from repro_torch.data import pipeline

    ccfg = pipeline.CorpusConfig(vocab_size=CORPUS_VOCAB)
    for name, dt in pipeline.synthetic_corpus(ccfg, ctx).items():
        write_dist_table(dt, os.path.join(root, name), ctx=ctx,
                         format="hpt")
    cfg = configs.reduced_config(configs.get_config("smollm-360m"))
    it = pipeline.make_training_data(cfg, ctx, batch=4, seq_len=16,
                                     ccfg=ccfg, data_root=root)
    out = {"stream": it.stream,
           "files": {n: file_digests(os.path.join(root, n))
                     for n in ("docs", "tokens")}}
    for i in range(2):
        for k, v in next(it).items():
            out[f"batch{i}_{k}"] = v.cpu().numpy()
    return out


def storage_cases(ctx, root: str) -> dict:
    """One process's run of every table case under ``root`` (one
    directory every rank sees): the whole results on rank 0, what must
    agree across ranks from every rank."""
    ex = Exchanges()
    data = dataset_cases(ctx, os.path.join(root, "data"), ex)
    res = {"data": data, "shard_tables": shard_tables_case(ctx),
           "tset": tset_cases(ctx, ex),
           "corpus": corpus_case(ctx, os.path.join(root, "corpus"))}
    every = {k: data[k] for k in data
             if k.endswith("_stats") or k.startswith(("files_", "strict"))}
    return {"rank": ctx.rank, "world": ctx.world, "exchanges": ex.n,
            "every": every, "stream": res["corpus"]["stream"],
            "results": res if ctx.rank == 0 else None}


# ---------------------------------------------------------------------------
# the elastic checkpoint
# ---------------------------------------------------------------------------
#: the reference's ``test_distributed.py`` case: ``arange(32)`` as (8, 4),
#: its rows on ``data``; with it a leaf split on its second dimension and
#: a replicated one
ELASTIC = {"w": np.arange(32, dtype=np.float32).reshape(8, 4),
           "m": np.arange(64, dtype=np.float32).reshape(4, 16) * 0.5,
           "b": np.arange(6, dtype=np.int32)}
ELASTIC_SPECS = {"w": ("data",), "m": (None, "data"), "b": None}


def _template():
    return {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                           device="meta") for k, v in ELASTIC.items()}


def elastic_save(mesh, root: str, async_save: bool) -> dict:
    """Every rank saves its blocks of :data:`ELASTIC` at step 1 → the
    files' digests and, with ``async_save``, whether anything was
    committed before :meth:`CheckpointManager.wait`."""
    from repro_torch.sharding import partition

    tree = {k: torch.from_numpy(v) if ELASTIC_SPECS[k] is None
            else partition.shard_tensor(torch.from_numpy(v),
                                        ELASTIC_SPECS[k], mesh).clone()
            for k, v in ELASTIC.items()}
    mgr = CheckpointManager(root, async_save=async_save)
    mgr.save(1, tree, shardings=(ELASTIC_SPECS, mesh))
    out = {}
    if async_save:
        out["before_wait"] = sorted(os.listdir(root))
        mgr.wait()
    out["after"] = sorted(os.listdir(root))
    out["files"] = file_digests(os.path.join(root, "step_1"))
    return out


def elastic_restore(mesh, root: str) -> dict:
    """This rank's blocks of the checkpoint under ``root`` on its mesh,
    or the exception every rank must raise."""
    mgr = CheckpointManager(root)
    try:
        got = mgr.restore(_template(), shardings=(ELASTIC_SPECS, mesh),
                          device="cpu")
    except Exception as e:  # noqa: BLE001 — the type is the answer
        return {"coords": dict(mesh.coords),
                "error": (type(e).__name__, str(e),
                          isinstance(e, CheckpointIntegrityError))}
    return {"coords": dict(mesh.coords),
            "blocks": {k: v.numpy() for k, v in got.items()}}


#: the trainer's cell: reduced smollm-360m, 2 steps on 2x2 in bf16
#: compute, then a float32-compute step; the restore leg on 2x1
TRAIN = {"batch": 8, "seq": 32, "steps": 2}


def _trainer(mesh_dims):
    from repro_torch import configs
    from repro_torch.data import pipeline as TP
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptimizerConfig

    cfg = configs.reduced_config(configs.get_config("smollm-360m"))
    tcfg = TS.TrainConfig(optimizer=OptimizerConfig(warmup_steps=2,
                                                    total_steps=20))
    return cfg, tcfg, TP.CorpusConfig(vocab_size=cfg.vocab_size)


def _f32_step(cfg, tcfg, mesh, state, batch):
    """One step in float32 compute → its loss."""
    from repro_torch.sharding import axes as am
    from repro_torch.train import train_step as TS

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with am.logical_binding(mesh):
        step, _, _ = TS.make_sharded_train_step(cfg32, tcfg, mesh,
                                                TS.meta_state(cfg32))
        _, m = step(state, TS.local_batch(batch, mesh))
    return float(m["loss"])


def train_save(ctx, root: str) -> dict:
    """The launcher's mesh set-up on 2x2, two steps, a save of the rank's
    ``TrainState`` blocks, then one float32-compute step on the next
    global batch (kept under ``root`` for the restore leg) → its loss and,
    from rank 0, the gathered state that was saved."""
    from repro_torch.launch import train as tlaunch
    from repro_torch.sharding import axes as am
    from repro_torch.train import train_step as TS
    from repro_torch.train.trainer import state_tree

    cfg, tcfg, ccfg = _trainer((2, 2))
    run = tlaunch.mesh_setup(cfg, tcfg, ccfg, (2, 2), ("data", "model"),
                             TRAIN["batch"], TRAIN["seq"], "cpu")
    state = run.state
    with am.logical_binding(run.mesh):
        for _ in range(TRAIN["steps"]):
            state, _ = run.step(state, TS.local_batch(next(run.data),
                                                      run.mesh))
        specs = TS.TrainState(run.specs, TS.OptState(run.specs, run.specs,
                                                     ()))
        CheckpointManager(root).save(
            TRAIN["steps"], state_tree(state),
            shardings=(state_tree(specs), run.mesh))
        whole = TS.gather_state(state, run.specs, run.mesh)
    batch = next(run.data)
    if ctx.rank == 0:
        np.savez(os.path.join(root, "batch.npz"),
                 **{k: v.numpy() for k, v in batch.items()})
    loss = _f32_step(cfg, tcfg, run.mesh, state, batch)
    saved = None
    if ctx.rank == 0:
        saved = {k: v.detach().numpy().copy()
                 for k, v in _flat(state_tree(whole)).items()}
    return {"loss_f32": loss, "saved": saved}


def _flat(tree, prefix="") -> dict:
    """A checkpoint tree's leaves by their ``__``-joined names."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}__{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def train_restore(ctx, root: str) -> dict:
    """The 2x2 checkpoint restored on a 2x1 mesh, then the float32-compute
    step on the kept batch → each restored block and the loss."""
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.sharding import axes as am
    from repro_torch.train import train_step as TS
    from repro_torch.train.trainer import state_tree, tree_state

    cfg, tcfg, _ = _trainer((2, 1))
    mesh = mesh_context((2, 1), ("data", "model"))
    with am.logical_binding(mesh):
        _, sspec, _ = TS.make_sharded_train_step(cfg, tcfg, mesh,
                                                 TS.meta_state(cfg))
    tree = CheckpointManager(root).restore(
        state_tree(TS.meta_state(cfg)), shardings=(state_tree(sspec), mesh),
        device="cpu")
    blocks = {k: v.numpy().copy() for k, v in _flat(tree).items()}
    with np.load(os.path.join(root, "batch.npz")) as f:
        batch = {k: torch.from_numpy(f[k]) for k in f.files}
    state = TS.place_state(tree_state(tree), "cpu")
    return {"coords": dict(mesh.coords), "blocks": blocks,
            "specs": _flat(state_tree(sspec)),
            "loss_f32": _f32_step(cfg, tcfg, mesh, state, batch)}
