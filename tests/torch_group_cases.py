"""The chains ``tests/test_torch_group.py`` runs on a process group.

:func:`run_cases` runs every chain of the table path, the Table I
collectives and MDS on one context and returns each result whole — the
gathered column blocks, counts, partitioning and overflow — with the
exchange and sort counts of each chain.  The test process runs it on the
port's virtual 4-shard context; :func:`rank_cases` runs it on one rank of
a ``gloo`` group started by ``repro_torch.launch.mesh.run_ranks``, which
imports this module by name in each spawned process (so it imports no
JAX).  Inputs are drawn once from a seed, at module import, so every
process holds the same arrays.
"""
from __future__ import annotations

import tempfile

import numpy as np
import torch

import torch_parity  # noqa: F401  (one intra-op thread a process)
from repro_torch.apps import mds
from repro_torch.core import DistTable, HPTMTContext, array_ops, table_ops
from repro_torch.core.array_ops import spmd_allgather, spmd_ppermute
from repro_torch.core.exchange import exchange_rows, exchange_rows_reference
from repro_torch.dataframe import DataFrame

RNG = np.random.default_rng(2023)
NL, NR = 1024, 256
LEFT = {"k": RNG.integers(0, NR, NL).astype(np.int32),
        "g": RNG.integers(0, 12, NL).astype(np.int32),
        "v": RNG.normal(size=NL).astype(np.float32)}
RIGHT = {"k": RNG.permutation(NR).astype(np.int32),
         "w": RNG.normal(size=NR).astype(np.float32)}
LEFT_CAP, RIGHT_CAP = 512, 128  # a shard's capacity: 2x its rows
GB_AGGS = [("v", "sum"), ("w", "max"), ("v", "count"), ("v", "mean"),
           ("v", "min")]
G_AGGS = [("v", "sum"), ("v", "mean"), ("v", "min"), ("v", "max"),
          ("v", "count")]
SETS = {"a": RNG.integers(0, 700, 1024).astype(np.int32),
        "b": RNG.integers(0, 700, 1024).astype(np.int32)}
N_EV = 1024
EVENTS = {"g": RNG.integers(0, 11, N_EV).astype(np.int32),
          "t": RNG.integers(0, 60, N_EV).astype(np.int32),
          "v": RNG.normal(size=N_EV).astype(np.float32),
          "q": RNG.uniform(0, 100, N_EV).astype(np.float32)}
EV_CAP = 512
W_AGGS = [("v", "sum"), ("v", "mean"), ("q", "sum"), ("v", "min"),
          ("q", "max"), (None, "count"), ("v", "lag"), ("v", "lag", 2),
          ("v", "lead"), ("q", "lead", 3), (None, "rank"),
          (None, "row_number")]
CUM_AGGS = [("v", "sum"), ("v", "max"), (None, "row_number")]
QS = (0.0, 0.1, 0.5, 0.9, 1.0)
TOPK = 16
CART = ({"k": RNG.integers(0, 50, 32).astype(np.int32),
         "v": RNG.normal(size=32).astype(np.float32)},
        {"k": RNG.integers(0, 50, 32).astype(np.int32),
         "w": RNG.normal(size=32).astype(np.float32)})
#: Table I input: 16 rows, 4 a shard (alltoall: one row a chunk)
COLL = RNG.normal(size=(16, 8)).astype(np.float32)
COLLECTIVES = [("allreduce", {"op": "sum"}), ("allreduce", {"op": "max"}),
               ("allreduce", {"op": "mean"}), ("allgather", {}),
               ("alltoall", {}), ("reduce_scatter", {}),
               ("broadcast", {"root": 2}), ("gather", {"root": 3}),
               ("scatter", {"root": 1}), ("reduce", {"root": 1, "op": "sum"})]
#: replicated inputs (every rank passes all of ``COLL``)
REPLICATED_IN = ("reduce_scatter", "scatter")
#: row-sharded outputs (each rank returns its shards' blocks)
SHARDED_OUT = ("alltoall", "reduce_scatter", "scatter", "gather", "reduce")
#: global (src, dst) pairs: pairs across ranks and inside one, shards
#: that send nothing, and a round where most ranks only receive
PERMS = {"mixed": [(0, 3), (2, 1), (3, 2)], "one": [(1, 0)]}
MDS_POINTS, MDS_DIM, MDS_ITERS = 24, 2, 5


def table_result(dt: DistTable) -> dict:
    cols, counts, part = dt.to_numpy_blocks()
    return {"cols": cols, "counts": counts, "part": repr(part)}


def frame_result(df: DataFrame) -> dict:
    return dict(table_result(df.table),
                report=sorted(df.overflow_report.entries.items()))


def left_right(ctx):
    return (DataFrame.from_dict(LEFT, ctx, capacity=LEFT_CAP),
            DataFrame.from_dict(RIGHT, ctx, capacity=RIGHT_CAP))


def main_chain(ctx) -> dict:
    """Join → groupbys → union: the chain the JAX package also runs."""
    left, right = left_right(ctx)
    j = left.join(right, ["k"])
    out = {"j": j, "gb": j.groupby(["g"], GB_AGGS, out_capacity=32),
           "gk": j.groupby(["k"], [("v", "sum")]),
           "u": j.project(["k", "g"]).union(left.project(["k", "g"]))}
    return {name: frame_result(df) for name, df in out.items()}


def paths_chain(ctx) -> dict:
    """The other join and groupby paths, the shuffle and the scalars."""
    left, right = left_right(ctx)
    out = {
        "sort_join": left.join(right, ["k"], method="sort"),
        "shuffle": left.repartition(["k"]),
        "gb_sort": left.groupby(["g"], G_AGGS, out_capacity=32,
                                method="sort", combine=False),
        "gb_hash": left.groupby(["g"], G_AGGS, out_capacity=32,
                                method="hash", combine=False),
        "gb_combine": left.groupby(["g"], G_AGGS, out_capacity=32,
                                   method="sort", combine=True),
    }
    res = {name: frame_result(df) for name, df in out.items()}
    res["aggregate"] = np.asarray(
        [left.agg("v", op) for op in ("sum", "mean", "min", "max", "count")])
    return res


#: four shard blocks of LEFT's first rows, with short shards
BLOCK_COUNTS = np.array([256, 200, 256, 100], np.int32)


def exchange_chain(ctx) -> dict:
    """``from_numpy_blocks`` on the context, then the packed exchange and
    its per-column reference on the same destinations (``k % 4``)."""
    dt = DistTable.from_numpy_blocks({k: v[:1024] for k, v in LEFT.items()},
                                     BLOCK_COUNTS, ctx=ctx)
    cols, counts = dt.shards()
    dests = [torch.where(torch.arange(256) < n, c["k"] % 4, 4)
             for c, n in zip(cols, counts)]
    out = {"blocks": table_result(dt)}
    for name, fn in (("packed", exchange_rows),
                     ("reference", exchange_rows_reference)):
        bufs, valid, ov = fn(cols, dests, 4, 128, group=ctx.group)
        for k in sorted(bufs[0]):
            out[f"{name}_{k}"] = spmd_allgather(
                [torch.where(m, b[k], 0) for b, m in zip(bufs, valid)],
                tiled=False, group=ctx.group)[0].numpy()
        out[f"{name}_valid"] = spmd_allgather(
            valid, tiled=False, group=ctx.group)[0].numpy()
        out[f"{name}_overflow"] = spmd_allgather(
            ov, tiled=False, group=ctx.group)[0].numpy()
    return out


def setops_chain(ctx) -> dict:
    a = DataFrame.from_dict({"k": SETS["a"]}, ctx, bucket_factor=2.0)
    b = DataFrame.from_dict({"k": SETS["b"]}, ctx, bucket_factor=2.0)
    return {"union": frame_result(a.union(b)),
            "intersect": frame_result(a.intersect(b)),
            "difference": frame_result(a.difference(b))}


def ordered_chain(ctx) -> dict:
    """sort → rolling and cumulative windows → rank → topk → sort by v →
    quantiles, and a window on an unsorted input (its own sort)."""
    d = DataFrame.from_dict(EVENTS, ctx, capacity=EV_CAP)
    s = d.sort_values(["g", "t"])
    out = {"sorted": s,
           "roll": s.window(["g"], ["t"]).agg(W_AGGS, rows=8),
           "cum": s.window(["g"], ["t"]).agg(CUM_AGGS, rows=None),
           "rank": s.rank(["g"], ["t"]),
           "topk": s.topk("v", TOPK),
           "unsorted_win": d.window(["g"], ["t"]).agg([("v", "sum")],
                                                      rows=4)}
    res = {name: frame_result(df) for name, df in out.items()}
    sv = s.sort_values("v")
    res["q_exact"] = sv.quantile("v", QS, method="exact")
    res["q_approx"] = d.quantile("v", QS, method="approx")
    return res


def cartesian_chain(ctx) -> dict:
    a = DataFrame.from_dict(CART[0], ctx)
    b = DataFrame.from_dict(CART[1], ctx)
    return {"cartesian": table_result(
        table_ops.cartesian(a.table, b.table, ctx=ctx))}


def _whole(t: torch.Tensor, ctx) -> np.ndarray:
    """A row-sharded result of every rank, in shard order."""
    if ctx.group is not None:
        t = spmd_allgather([t], group=ctx.group)[0]
    return t.cpu().numpy()


def table1_chain(ctx) -> dict:
    """The eight global-view Table I operators and ``spmd_ppermute``."""
    b = COLL.shape[0] // ctx.n_shards
    lo = ctx.local_shards.start * b
    mine = torch.from_numpy(COLL[lo:lo + ctx.n_local * b]).to(ctx.device)
    whole = torch.from_numpy(COLL).to(ctx.device)
    res = {}
    for name, kw in COLLECTIVES:
        x = whole if name in REPLICATED_IN else mine
        got = getattr(array_ops, name)(x, ctx=ctx, **kw)
        tag = name + "".join(f"_{k}{v}" for k, v in kw.items())
        res[tag] = (_whole(got, ctx) if name in SHARDED_OUT
                    else got.cpu().numpy())
    for tag, perm in PERMS.items():
        frames = [torch.full((3,), float(s), device=ctx.device)
                  for s in ctx.local_shards]
        got = spmd_ppermute(frames, perm, group=ctx.group)
        res[f"ppermute_{tag}"] = spmd_allgather(
            got, tiled=False, group=ctx.group)[0].cpu().numpy()
    return res


def mds_chain(ctx) -> dict:
    curated = mds.curated_table(MDS_POINTS, ctx, seed=0)
    points = curated.to_torch(mds.FEATURES)
    delta = mds.distance_matrix(points, ctx)
    path, x = mds.smacof(delta, MDS_DIM, MDS_ITERS, 0)
    return {"curated": frame_result(curated), "points": points.numpy(),
            "delta": delta.numpy(), "path": np.asarray(path),
            "x": x.numpy()}


def tset_chain(ctx) -> dict:
    """The TSet methods the data pipeline runs on a group: ``from_table``
    in chunks, ``select``, ``project``, ``join`` and ``collect``."""
    from repro_torch.core.dataflow import TSet

    left, right = left_right(ctx)
    lt = TSet.from_table(left.table, ctx, chunk_rows=LEFT_CAP // 4)
    rt = TSet.from_table(right.table, ctx)
    good = rt.select(lambda c: c["w"] > 0).project(["k", "w"])
    joined = lt.project(["k", "v"]).join(good, keys=["k"],
                                         out_capacity=LEFT_CAP)
    return {"join": table_result(joined.collect()),
            "select": table_result(good.collect())}


#: the training data pipeline's corpus on a group (the port's reduced
#: smollm vocabulary)
CORPUS_VOCAB = 128


def training_data_chain(ctx) -> dict:
    """``make_training_data`` on the context: the curated stream and two
    global batches, every rank the same."""
    from repro_torch import configs
    from repro_torch.data import pipeline

    ccfg = pipeline.CorpusConfig(vocab_size=CORPUS_VOCAB)
    cfg = configs.reduced_config(configs.get_config("smollm-360m"))
    stream = pipeline.preprocess(pipeline.synthetic_corpus(ccfg, ctx), ccfg,
                                 ctx)
    it = pipeline.make_training_data(cfg, ctx, batch=4, seq_len=16,
                                     ccfg=ccfg)
    out = {"stream": stream}
    for i in range(2):
        for k, v in next(it).items():
            out[f"batch{i}_{k}"] = v.cpu().numpy()
    return out


CHAINS = {"main": main_chain, "paths": paths_chain,
          "exchange": exchange_chain, "setops": setops_chain,
          "ordered": ordered_chain, "cartesian": cartesian_chain,
          "table1": table1_chain, "mds": mds_chain, "tset": tset_chain,
          "training_data": training_data_chain}


def run_cases(ctx) -> tuple:
    """``(results, counts)``: every chain's results, and its ``(EXCHANGES,
    SORTS)`` counts in this process."""
    results, counts = {}, {}
    for name, chain in CHAINS.items():
        array_ops.EXCHANGES.reset()
        array_ops.SORTS.reset()
        results[name] = chain(ctx)
        counts[name] = (array_ops.EXCHANGES.n, array_ops.SORTS.n)
    return results, counts


# ---------------------------------------------------------------------------
# what a group refuses (ROADMAP item 11b)
# ---------------------------------------------------------------------------
def _refusals(ctx, tmp: str) -> dict:
    from repro_torch.launch import serve

    return {
        "serve_launcher": lambda: serve.main(["--arch", "smollm-360m"]),
    }


REFUSED = ("serve_launcher",)


#: the training launcher's run on a group: reduced smollm, 2 steps, a
#: ``world x 1`` mesh (``n_shards`` = the world size on the data axis)
LAUNCH = ["--arch", "smollm-360m", "--reduced", "--device", "cpu",
          "--steps", "2", "--batch", "4", "--seq", "32"]


def launcher_run(ctx) -> list:
    """``launch.train.main`` on the group as a ``world x 1`` mesh → its
    losses."""
    from repro_torch.launch import train

    assert train.main(LAUNCH + ["--mesh", f"{ctx.world}x1"]) == 0
    return train.main.last_history


def refusals(ctx) -> dict:
    """``name → (exception type, message)`` of each refused feature (or
    ``("returned", "")`` when it ran)."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, thunk in _refusals(ctx, tmp).items():
            try:
                thunk()
                out[name] = ("returned", "")
            except Exception as e:  # noqa: BLE001 — the type is the answer
                out[name] = (type(e).__name__, str(e))
    return out


def rank_cases(ctx) -> dict:
    """One rank's run: the context's layout, every chain (the whole
    results on rank 0 only) and what the group refuses."""
    try:
        HPTMTContext(n_shards=ctx.world + 1, device=ctx.device,
                     group=ctx.group)
        bad_split = "accepted"
    except ValueError as e:
        bad_split = str(e)
    left = DataFrame.from_dict(LEFT, ctx, capacity=LEFT_CAP).table
    results, counts = run_cases(ctx)
    return {"rank": ctx.rank, "world": ctx.world, "n_local": ctx.n_local,
            "local_shards": list(ctx.local_shards), "bad_split": bad_split,
            "block_shape": tuple(left.columns["k"].shape),
            "counts": counts, "refusals": refusals(ctx),
            "launcher": launcher_run(ctx),
            "training_data": results["training_data"],
            "results": results if ctx.rank == 0 else None}


def failing_rank(ctx) -> None:
    """Rank 1 raises; the others wait in a collective it never joins."""
    if ctx.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    spmd_allgather([torch.zeros(1)], group=ctx.group)
