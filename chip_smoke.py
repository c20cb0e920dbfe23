"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout on a machine with an NVIDIA H100 (Hopper).
It imports the port (``src/repro_torch``), never JAX or the JAX package,
and exits non-zero — printing no result line — when no CUDA device is
available or when the package is missing.

Phases (every failed check raises; nothing is caught):

1. build — compile the hand-written CUDA kernels (``src/repro_torch/csrc``,
   ``nvcc`` for ``sm_90a``; ``ptxas -v`` for each) and print the seconds
   it took and the count of ``HGMMA`` (wgmma) instructions in each kernel's
   SASS (``cuobjdump -sass``), which must be non-zero for the tensor-core
   flash kernel;
2. kernels — each kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it: exact for hash_partition, probe and
   min/max, counts exact, float sums to ``1e-5 * sum|v|`` per group; times
   with CUDA events beside the bytes bound and a library yardstick.  The
   probe walks the packed slot records (``slot_records``, timed as
   ``pack_ms``) and is held against the reference's walk over its three
   slot arrays; its row also counts the slot visits of the walk.
   ``windowed_scan`` runs on ``(2^25 - 3, 2)`` float32 values (a few NaN)
   with random segment starts, for windows 1, 7, 32, 512, 4096 and 8192
   (no multiple of ``n`` but 1) and sum/min/max: min/max exact with NaN
   propagating, sums bit-exact up to the kernel's 4096-row tile and within
   ``1e-5 * sum|v|`` over each window beyond it; then at ``rows=32`` on
   column views of an ``(n, 4)`` table, as the window engine calls it
   (``strided_ms``).  ``flash_attention``
   runs the serving path's prefill shapes — phi3-mini q/k/v (8, 32, 1024,
   96) in bfloat16 and float32, smollm's GQA (8, 15/5, 1024, 64), a
   mixtral-like (1, 32/8, 8192, 128) with ``window=4096``, a decode-like
   query at ``q_offset`` over a right-padded cache (``kv_len``) in float32
   and bfloat16, and a ragged length of 1000 — against its plain version
   to 2e-4 (float32, the SIMT kernel) and 2e-2 (bfloat16, the tensor-core
   kernel), each case naming the instance that ran (``impl``), timed
   beside ``scaled_dot_product_attention``;
3. main path, 1 shard, full size — ``DataFrame.from_dict`` of left = 2^25
   rows ``{k, g, v}`` and right = 2^23 rows ``{k, w}`` (the order of TPC-H
   SF10 ``lineitem`` against ``orders``), inner join on ``k``, a groupby on
   ``g`` (hash path, both segment kernels) and one on ``k`` (sort path),
   checked against a numpy oracle; the exchange counter must read 0;
4. the same data on 4 virtual shards (launches hash_partition): the same
   rows, zero overflow, 3 exchanges;
5. set ops on 4 shards, 2^22 rows a side: union and difference against
   ``np.union1d`` / ``np.setdiff1d``;
6. ordered analytics, 1 shard, full size — ``events`` = 2^25 rows ``{g:
   int32 over 2^16 partitions (~512 rows each), t: int32 over [0, 2^12)
   (ties inside a partition), v: float32 normal, q: float32 uniform [0,
   100)}``, the shape of a TPC-DS ``store_sales`` window query (TPC-DS
   v3 queries 47, 51 and 57: ``rank()``/``avg()`` and a cumulative
   ``sum()`` over ``partition by`` an item, ``order by`` a date) at one
   partition per item.  ``sort_values(["g", "t"])``, a rolling window
   (``rows=32``: sum, mean, min, max, count, lag, lead, rank,
   row_number), a cumulative window (sum, max), ``topk("v", 1000)`` and
   an exact ``quantile`` of ``v`` after ``sort_values("v")``, checked
   against a numpy oracle (order exact; counts, ranks, lag/lead, min/max
   exact; sums and means within ``1e-5 * sum|v|`` of each window); the
   exchange counter must read 0;
7. the same chain on 4 virtual shards: exactly 2 exchanges (the two
   sorts), no sort and no exchange inside the windows or the exact
   quantile, zero overflow, every exact lane equal to phase 6's;
8. serving, phi3-mini-3.8b at its full published width and depth (32
   layers, d_model 3072, 32 heads of 96, vocab 32064, bfloat16), random
   weights drawn on the card from ``--seed``: ``Engine.generate`` on 8
   prompts of 1024 tokens, greedy, 64 new tokens (``max_len`` = 1096, the
   launcher's rule).  The flash kernel must launch once per layer in the
   prefill, every launch on the tensor-core instance; the prefill's
   last-position logits must agree with the plain attention path
   (``use_flash=False``) to 2e-2 of the largest logit, and a float32
   copy of the model must give identical greedy tokens on both paths
   (batch 2, prompt 256, 16 tokens);
9. the same for smollm-360m (GQA 15/5, tied embeddings), full size;
10. summary — the script's seconds so far, the ``kernels`` JSON line, the
   card's name and power limit, and as the last line ``{"ok": true,
   "device": {...}}``.

Wall times of phases 3-9 are medians of 3 runs after one checked warm-up
run; kernel launch counts are those of the checked runs.  ``--profile``
adds one ``torch.profiler`` run of each of phases 3-9 (device busy share,
top kernels; tables in ``chiprun_out/profile_*.txt``).
Float32 matrix products run in full float32 (TF32 off, PyTorch's
default, set here).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM 32-bit rate outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate

LEFT_ROWS, RIGHT_ROWS = 1 << 25, 1 << 23
GROUPS, G_OUT_CAP = 1024, 2048
SET_ROWS = 1 << 22
G_AGGS = [("v", "sum"), ("v", "mean"), ("v", "min"), ("v", "max"),
          ("w", "sum"), ("v", "count")]
EVENTS, ITEMS, DAYS = 1 << 25, 1 << 16, 1 << 12
ROLL = 32
W_AGGS = [("v", "sum"), ("v", "mean"), ("q", "sum"), ("v", "min"),
          ("v", "max"), (None, "count"), ("v", "lag"), ("v", "lead"),
          (None, "rank"), (None, "row_number")]
CUM_AGGS = [("v", "sum"), ("v", "max")]
TOPK = 1000
QS = (0.01, 0.5, 0.99)
WINDOWS = (1, 7, 32, 512, 4096, 8192)
SERVE = {"batch": 8, "prompt": 1024, "gen": 64}
SERVE_F32 = {"batch": 2, "prompt": 256, "gen": 16}


def check(cond, what: str) -> None:
    if not bool(cond):
        raise AssertionError(f"check failed: {what}")


def emit(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` calls, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, nops: float = 0.0, ops_per_s=FP32_OPS_PER_S):
    """Least time for the work on this card: ``(ms, "bytes"|"operations")``."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def bit_key(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def canonical(rows: dict, names) -> torch.Tensor:
    """Rows as an ``(n, len(names))`` int64 matrix, lexsorted — a bitwise
    multiset fingerprint computed on the card."""
    cols = [bit_key(rows[n]).to(torch.int64) for n in names]
    order = torch.arange(cols[0].shape[0], device=cols[0].device)
    for c in reversed(cols):
        order = order[torch.argsort(c[order], stable=True)]
    return torch.stack([c[order] for c in cols], dim=1)


# ---------------------------------------------------------------------------
# data and oracles
# ---------------------------------------------------------------------------
def make_data(seed: int):
    rng = np.random.default_rng(seed)
    left = {"k": rng.integers(0, RIGHT_ROWS, LEFT_ROWS, dtype=np.int32),
            "g": rng.integers(0, GROUPS, LEFT_ROWS, dtype=np.int32),
            "v": rng.standard_normal(LEFT_ROWS, dtype=np.float32)}
    right = {"k": rng.permutation(RIGHT_ROWS).astype(np.int32),
             "w": rng.standard_normal(RIGHT_ROWS, dtype=np.float32)}
    sets = {"a": rng.integers(0, 1 << 23, SET_ROWS, dtype=np.int32),
            "b": rng.integers(0, 1 << 23, SET_ROWS, dtype=np.int32)}
    return left, right, sets


def make_oracle(left, right):
    """float64 numpy answers of the main path."""
    w_of_key = np.empty(RIGHT_ROWS, np.float32)
    w_of_key[right["k"]] = right["w"]
    w = w_of_key[left["k"]]  # every left row matches exactly one right row
    order = np.argsort(left["g"], kind="stable")
    gs = left["g"][order]
    starts = np.flatnonzero(np.r_[True, gs[1:] != gs[:-1]])
    vs, ws = left["v"][order], w[order]
    g = {"g": gs[starts],
         "v_count": np.diff(np.r_[starts, LEFT_ROWS]),
         "v_min": np.minimum.reduceat(vs, starts),
         "v_max": np.maximum.reduceat(vs, starts),
         "v_sum": np.add.reduceat(vs.astype(np.float64), starts),
         "v_abs": np.add.reduceat(np.abs(vs).astype(np.float64), starts),
         "w_sum": np.add.reduceat(ws.astype(np.float64), starts),
         "w_abs": np.add.reduceat(np.abs(ws).astype(np.float64), starts)}
    cnt = np.bincount(left["k"], minlength=RIGHT_ROWS)
    present = np.flatnonzero(cnt)
    k = {"k": present.astype(np.int32),
         "v_sum": np.bincount(left["k"], left["v"].astype(np.float64),
                              RIGHT_ROWS)[present],
         "v_abs": np.bincount(left["k"], np.abs(left["v"]).astype(np.float64),
                              RIGHT_ROWS)[present]}
    return {"w_of_key": w_of_key, "g": g, "k": k}


def check_close(got, ref, scale, what):
    err = np.abs(np.asarray(got, np.float64) - ref)
    check((err <= 1e-5 * scale).all(),
          f"{what}: max |err|/sum|v| = {float((err / scale).max())}")


def check_main_path(res, left_dev, oracle, tag: str):
    """Exact row counts, keys, counts and min/max; sums within
    ``1e-5 * sum|v|`` per group of the float64 oracle."""
    j = res["j"].table.valid_rows()
    check(j["k"].shape[0] == LEFT_ROWS, f"{tag}: join rows")
    check(bool(j["_matched"].all()), f"{tag}: every join row matched")
    wk = torch.from_numpy(oracle["w_of_key"]).to(j["k"].device)
    check(torch.equal(j["w"], wk[j["k"].long()]), f"{tag}: join payload w")
    check(torch.equal(canonical(j, ["k", "g", "v"]),
                      canonical(left_dev, ["k", "g", "v"])),
          f"{tag}: join rows are the left rows")

    g = res["g"].to_numpy()
    order = np.argsort(g["g"])
    g = {k: v[order] for k, v in g.items()}
    o = oracle["g"]
    check(np.array_equal(g["g"], o["g"]), f"{tag}: groupby g keys")
    check(np.array_equal(g["v_count"], o["v_count"]), f"{tag}: g counts")
    check(np.array_equal(g["v_min"], o["v_min"]), f"{tag}: g min")
    check(np.array_equal(g["v_max"], o["v_max"]), f"{tag}: g max")
    check_close(g["v_sum"], o["v_sum"], o["v_abs"], f"{tag}: g v_sum")
    check_close(g["w_sum"], o["w_sum"], o["w_abs"], f"{tag}: g w_sum")
    check_close(g["v_mean"], o["v_sum"] / o["v_count"],
                o["v_abs"] / o["v_count"], f"{tag}: g v_mean")

    k = res["k"].to_numpy()
    order = np.argsort(k["k"], kind="stable")
    o = oracle["k"]
    check(np.array_equal(k["k"][order], o["k"]), f"{tag}: groupby k keys")
    check_close(k["v_sum"][order], o["v_sum"], o["v_abs"], f"{tag}: k v_sum")
    return j, g


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def main_path(DataFrame, ctx, left, right, bucket_factor):
    """The slice's main path through the user entry points."""
    ldf = DataFrame.from_dict(left, ctx, bucket_factor=bucket_factor)
    rdf = DataFrame.from_dict(right, ctx, bucket_factor=bucket_factor)
    j = ldf.join(rdf, ["k"])
    g = j.groupby(["g"], G_AGGS, out_capacity=G_OUT_CAP)
    k = j.groupby(["k"], [("v", "sum")])
    torch.cuda.synchronize()
    return {"j": j, "g": g, "k": k}


def set_ops(DataFrame, ctx, sets):
    a = DataFrame.from_dict({"k": sets["a"]}, ctx, bucket_factor=2.0)
    b = DataFrame.from_dict({"k": sets["b"]}, ctx, bucket_factor=2.0)
    u, d = a.union(b), a.difference(b)
    torch.cuda.synchronize()
    return {"union": u, "difference": d}


class Launches:
    """Reset every kernel's launch counter, then read them."""

    def __init__(self):
        from repro_torch.core import array_ops
        from repro_torch.kernels.hash_join import kernel as hjk
        from repro_torch.kernels.hash_partition import kernel as hpk
        from repro_torch.kernels.segment_reduce import kernel as srk
        from repro_torch.kernels.flash_attention import kernel as fak
        from repro_torch.kernels.window_scan import kernel as wsk
        self.counters = {"hash_partition": hpk.LAUNCHES, "probe": hjk.LAUNCHES,
                         "segment_reduce_fused": srk.FUSED_LAUNCHES,
                         "segment_reduce": srk.LAUNCHES,
                         "windowed_scan": wsk.LAUNCHES,
                         "flash_attention": fak.LAUNCHES}
        self.flash_instances = fak.INSTANCE_LAUNCHES
        self.exchanges = array_ops.EXCHANGES
        self.sorts = array_ops.SORTS
        self.total = dict.fromkeys(self.counters, 0)

    def reset(self):
        for c in (*self.counters.values(), *self.flash_instances.values()):
            c.reset()
        self.exchanges.reset()
        self.sorts.reset()

    def read(self):
        got = {k: c.n for k, c in self.counters.items()}
        for k, n in got.items():
            self.total[k] += n
        return got, self.exchanges.n


def profile_run(tag: str, fn) -> None:
    """One run of ``fn`` under ``torch.profiler``: device busy share and
    the top kernels by device time, written to ``chiprun_out/``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    # device work only: kernels and copies (operator rows repeat their
    # kernels' time; the profiler's own buffer request is not work)
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.key != "Activity Buffer Request"]
    busy_us = sum(getattr(e, key) for e in device)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    path = os.path.join(ROOT, "chiprun_out", f"profile_{tag}.txt")
    with open(path, "w") as f:
        f.write(events.table(sort_by=key, row_limit=40))
    top = sorted(device, key=lambda e: getattr(e, key), reverse=True)[:8]
    emit("profile", run=tag, wall_s=wall, device_busy_s=busy_us / 1e6,
         busy_share=busy_us / 1e6 / wall,
         top=[(e.key, getattr(e, key) / 1e3) for e in top])


def timed_runs(fn, runs: int = 3):
    """Wall seconds of ``runs`` calls (each ends synchronized)."""
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return out


def visited_slots(table_row, ph1, ph2, pvalid, max_probes):
    """``(distinct, total)`` slots the probe walk visits: the distinct ones
    price the bytes bound, the total is the slot reads a walk makes (one
    sector each with the packed records)."""
    slots = table_row.shape[0]
    h1 = ph1.to(torch.int64) & 0xFFFFFFFF
    step = (ph2.to(torch.int64) & 0xFFFFFFFF) | 1
    seen = torch.zeros(slots, dtype=torch.bool, device=table_row.device)
    active = pvalid.clone()
    total, j = 0, 0
    while j < max_probes and bool(active.any()):
        slot = (h1 + j * step) & (slots - 1)
        seen[slot[active]] = True
        total += int(active.sum())
        active &= table_row[slot] >= 0
        j += 1
    return int(seen.sum()), total


def kernel_phase(left, right, dev):
    """Every kernel against its plain version at the main path's shapes."""
    from repro_torch.core import HPTMTContext
    from repro_torch.core.exchange import key_compare_u32
    from repro_torch.core.table import _as_u32, hash_columns
    from repro_torch.core.table_ops import _hash_slots
    from repro_torch.dataframe import DataFrame
    from repro_torch.kernels.hash_join import kernel as hjk
    from repro_torch.kernels.hash_join import ref as hjr
    from repro_torch.kernels.hash_partition import kernel as hpk
    from repro_torch.kernels.hash_partition import ref as hpr
    from repro_torch.kernels.segment_reduce import kernel as srk
    from repro_torch.kernels.segment_reduce import ref as srr

    rows = []

    # 1. hash_partition: one shard of the 4-shard left table (phase 4)
    t4 = DataFrame.from_dict({"k": left["k"]}, HPTMTContext(4, dev),
                             bucket_factor=2.0).table
    keys = _as_u32(t4.columns["k"][0])[:, None].contiguous()
    cap = keys.shape[0]
    valid = torch.arange(cap, device=dev) < t4.counts[0]
    for hashes in (False, True):
        got = hpk.hash_partition_cuda(keys, valid, 4, return_hashes=hashes)
        exp = hpr.hash_partition_lanes(keys, valid, 4, return_hashes=hashes)
        for a, b in zip(got, exp):
            check(torch.equal(a, b), f"hash_partition (hashes={hashes})")
    ms = cuda_ms(lambda: hpk.hash_partition_cuda(keys, valid, 4, True))
    plain = cuda_ms(lambda: hpr.hash_partition_lanes(keys, valid, 4, True))
    b_ms, b_by = bound(cap * (4 + 1) + cap * 12 + 4 * 4, cap * 40)
    rows.append(dict(name="hash_partition", shape=f"keys ({cap}, 1), P=4",
                     max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None))
    del t4, keys, valid, got, exp

    # 2. probe: the 1-shard join (build 2^23 rows into 2^25 slots)
    rk = torch.from_numpy(right["k"]).to(dev)
    lk = torch.from_numpy(left["k"]).to(dev)
    rh1, rh2 = hash_columns([rk])
    lh1, lh2 = hash_columns([lk])
    slots = _hash_slots(RIGHT_ROWS)
    table, unplaced = hjr.build_table(rh1, rh2,
                                      torch.ones_like(rk, dtype=torch.bool),
                                      slots, 64)
    check(int(unplaced) == 0, "build table placed every row")
    rlanes = key_compare_u32({"k": rk}, ["k"])
    llanes = key_compare_u32({"k": lk}, ["k"])
    pvalid = torch.ones_like(lk, dtype=torch.bool)
    records, side = hjr.slot_records(table, rh2, rlanes)
    args = (records, side, lh1, lh2, llanes, pvalid, 1, 64)
    got = hjk.probe_cuda(*args)
    # the yardstick: the reference's walk over its three slot arrays
    sh2, skeys = hjr.slot_payload(table, rh2, rlanes)
    exp = hjr.probe(table, sh2, skeys, lh1, lh2, llanes, pvalid, 1, 64)
    for a, b in zip(got, exp):
        check(torch.equal(a, b), "probe bit-identical")
    check(bool((got[0] == 1).all()), "every probe row matched once")
    del sh2, skeys, exp
    ms = cuda_ms(lambda: hjk.probe_cuda(*args))
    pack = cuda_ms(lambda: hjr.slot_records(table, rh2, rlanes))
    plain = cuda_ms(lambda: hjr.probe_records(*args), reps=2)
    n = LEFT_ROWS
    seen, visits = visited_slots(table, lh1, lh2, pvalid, 64)
    b_ms, b_by = bound(n * (4 + 4 + 4 + 1) + n * (4 + 4 + 1) + seen * 12)
    rows.append(dict(name="probe", shape=f"N={n}, S={slots}, L=1, M=1",
                     max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None, pack_ms=pack,
                     slots_read=seen, visits=visits,
                     visits_per_row=visits / n))
    del got, args, table, records, side

    # 3./4. segment reductions: the 1-shard hash groupby on g
    g = torch.from_numpy(left["g"]).to(dev)
    v = torch.from_numpy(left["v"]).to(dev)
    w_of_key = torch.empty(RIGHT_ROWS, dtype=torch.float32, device=dev)
    w_of_key[rk.long()] = torch.from_numpy(right["w"]).to(dev)
    w = w_of_key[lk.long()]
    gslots = _hash_slots(G_OUT_CAP)
    gh1, gh2 = hash_columns([g])
    _, seg, unres = hjr.build_table_unique(
        gh1, gh2, key_compare_u32({"g": g}, ["g"]),
        torch.ones_like(g, dtype=torch.bool), gslots, 64)
    check(not bool(unres.any()), "every group resolved")
    S = gslots  # the sentinel slot of unresolved rows is dropped
    vals = torch.stack([torch.ones_like(v), v, w], dim=1)
    got = srk.segment_reduce_fused_cuda(vals, seg, S)
    exp = srr.segment_reduce_fused(vals, seg, S)
    scale = srr.segment_reduce_fused(vals.abs(), seg, S)
    err = (got - exp).abs()
    check(torch.equal(got[:, 0], exp[:, 0]), "fused count lane exact")
    check(bool((err <= 1e-5 * scale).all()), "fused sums within 1e-5 sum|v|")
    ms = cuda_ms(lambda: srk.segment_reduce_fused_cuda(vals, seg, S))
    plain = cuda_ms(lambda: srr.segment_reduce_fused(vals, seg, S), reps=2)
    seg64 = seg.long()
    lib = cuda_ms(lambda: torch.zeros(S, 3, device=dev).index_add_(
        0, seg64, vals))
    L = vals.shape[1]
    b_ms, b_by = bound(n * L * 4 + n * 4 + S * L * 4, n * L)
    rows.append(dict(name="segment_reduce_fused", shape=f"N={n}, L={L}, S={S}",
                     max_abs_err=float(err.max()), ms=ms, plain_ms=plain,
                     bound_ms=b_ms, bound_by=b_by, library_ms=lib))

    worst, ms_ops, plain_ops, lib_ops = 0.0, [], [], []
    for op in ("min", "max"):
        got = srk.segment_reduce_cuda(v, seg, S, op)
        exp = srr.segment_reduce(v, seg, S, op)
        check(torch.equal(got, exp), f"segment {op} exact")
        ms_ops.append(cuda_ms(lambda: srk.segment_reduce_cuda(v, seg, S, op)))
        plain_ops.append(cuda_ms(lambda: srr.segment_reduce(v, seg, S, op),
                                 reps=2))
        init = float("inf") if op == "min" else float("-inf")
        lib_ops.append(cuda_ms(lambda: torch.full((S,), init, device=dev)
                               .scatter_reduce_(0, seg64, v, "a" + op,
                                                include_self=True)))
    # NaN propagates through min and max as in the reference
    nv = torch.tensor([1.0, float("nan"), 3.0, 2.0], device=dev)
    ns = torch.tensor([0, 0, 1, 1], dtype=torch.int32, device=dev)
    lo = srk.segment_reduce_cuda(nv, ns, 3, "min").cpu().numpy()
    hi = srk.segment_reduce_cuda(nv, ns, 3, "max").cpu().numpy()
    check(np.array_equal(lo, [np.nan, 2, np.inf], equal_nan=True), "min NaN")
    check(np.array_equal(hi, [np.nan, 3, -np.inf], equal_nan=True), "max NaN")
    b_ms, b_by = bound(n * 4 + n * 4 + S * 4, n)
    rows.append(dict(name="segment_reduce", shape=f"N={n}, S={S}, op=min/max",
                     max_abs_err=worst, ms=statistics.mean(ms_ops),
                     plain_ms=statistics.mean(plain_ops), bound_ms=b_ms,
                     bound_by=b_by, library_ms=statistics.mean(lib_ops)))
    return rows


def window_kernel_phase(dev):
    """``windowed_scan`` against its plain version for every window and
    op; returns the kernels-line row at the main path's shape (the
    rolling window's fused sum lanes) and the per-case rows."""
    from repro_torch.kernels.window_scan import kernel as wsk
    from repro_torch.kernels.window_scan import ref as wsr

    n, lanes = EVENTS - 3, 2  # no multiple of any window but 1
    gen = torch.Generator(device=dev).manual_seed(7)
    v = torch.randn((n, lanes), generator=gen, device=dev)
    v[torch.randint(0, n, (64,), generator=gen, device=dev), 0] = float("nan")
    flags = torch.rand(n, generator=gen, device=dev) < 1 / 512
    flags[0] = True
    seg = torch.cummax(torch.where(flags, torch.arange(n, device=dev), 0),
                       0).values.to(torch.int32)
    absv = v.abs().nan_to_num()
    worst, cases = 0.0, []
    for w in WINDOWS:
        for op in ("sum", "min", "max"):
            got = wsk.windowed_scan_cuda(v, seg, w, op)
            exp = wsr.windowed_scan(v, seg, w, op)
            what = f"windowed_scan w={w} {op}"
            check(torch.equal(got.isnan(), exp.isnan()), f"{what}: NaN rows")
            ok = ~exp.isnan()
            if op != "sum" or w <= wsk.TILE:
                check(torch.equal(got.view(torch.int32)[ok],
                                  exp.view(torch.int32)[ok]),
                      f"{what}: bit-exact")
                err = 0.0
            else:
                scale = wsr.windowed_scan(absv, seg, w, "sum")
                diff = (got - exp).abs()[ok]
                check(bool((diff <= 1e-5 * scale[ok]).all()),
                      f"{what}: within 1e-5 sum|v|")
                err = float(diff.max())
            worst = max(worst, err)
            del got, exp
            ms = cuda_ms(lambda: wsk.windowed_scan_cuda(v, seg, w, op))
            plain = cuda_ms(lambda: wsr.windowed_scan(v, seg, w, op), reps=2)
            cases.append(dict(window=w, op=op, ms=ms, plain_ms=plain,
                              max_abs_err=err))
    # NaN in a window gives NaN under min and max (and sum)
    nv = torch.tensor([[1.0], [float("nan")], [3.0], [2.0], [5.0]],
                      device=dev)
    ns = torch.tensor([0, 0, 0, 3, 3], dtype=torch.int32, device=dev)
    nan = float("nan")
    for op, want in (("min", [1, nan, nan, 2, 2]),
                     ("max", [1, nan, nan, 2, 5]),
                     ("sum", [1, nan, nan, 2, 7])):
        got = wsk.windowed_scan_cuda(nv, ns, 2, op)[:, 0].cpu().numpy()
        check(np.array_equal(got, np.array(want, np.float32), equal_nan=True),
              f"windowed_scan {op} NaN propagation: {got}")
    # the window engine's call: sum lanes and a min/max column sliced out of
    # one (n, 4) table, read through their row stride without a copy
    table = torch.cat([v, torch.randn((n, 2), generator=gen, device=dev)], 1)
    strided = {}
    for op, view in (("sum", table[:, :lanes]), ("min", table[:, 2:3]),
                     ("max", table[:, 3:4])):
        got = wsk.windowed_scan_cuda(view, seg, ROLL, op)
        exp = wsr.windowed_scan(view.contiguous(), seg, ROLL, op)
        check(torch.equal(got.view(torch.int32), exp.view(torch.int32)),
              f"windowed_scan strided {op}: bit-exact")
        strided[op] = cuda_ms(lambda: wsk.windowed_scan_cuda(view, seg, ROLL,
                                                             op))
    del table, got, exp
    head = next(c for c in cases if c["window"] == ROLL and c["op"] == "sum")
    b_ms, b_by = bound(n * lanes * 4 * 2 + n * 4, 3 * n * lanes)
    row = dict(name="windowed_scan",
               shape=f"({n}, {lanes}) f32, w={ROLL}, sum",
               max_abs_err=worst, ms=head["ms"], plain_ms=head["plain_ms"],
               bound_ms=b_ms, bound_by=b_by, library_ms=None,
               strided_ms=strided,
               one_lane_bound_ms=bound(n * 4 * 2 + n * 4, 3 * n)[0])
    return row, cases


# b, hq, hkv, sq, sk, d, dtype, causal, window, kv_len, q_offset: the
# serving path's prefill shapes (the first is the kernels-line row)
FLASH_CASES = [
    ("phi3 prefill", 8, 32, 32, 1024, 1024, 96, "bfloat16", True, None,
     None, 0),
    ("phi3 prefill f32", 8, 32, 32, 1024, 1024, 96, "float32", True, None,
     None, 0),
    ("smollm prefill", 8, 15, 5, 1024, 1024, 64, "bfloat16", True, None,
     None, 0),
    ("mixtral-like window", 1, 32, 8, 8192, 8192, 128, "bfloat16", True,
     4096, None, 0),
    ("decode-like", 8, 32, 32, 1, 1096, 96, "float32", True, None, 1024,
     1023),
    ("decode-like bf16", 8, 32, 32, 1, 1096, 96, "bfloat16", True, None,
     1024, 1023),
    ("ragged", 2, 8, 8, 1000, 1000, 96, "float32", True, None, None, 0),
]


def attn_pairs(sq, sk, causal, window, kv_len, q_offset) -> int:
    """(query, key) pairs the masks allow, per batch-head: the work this
    run's inputs need."""
    p = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.full(sq, min(sk, sk if kv_len is None else kv_len) - 1)
    if causal:
        hi = np.minimum(hi, p)
    lo = np.zeros(sq, np.int64) if window is None else p - window + 1
    return int(np.clip(hi - np.maximum(lo, 0) + 1, 0, None).sum())


def flash_kernel_phase(dev):
    """``flash_attention`` against its plain version on the serving
    shapes; returns the kernels-line row (phi3 prefill, bf16) and the
    per-case rows."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.flash_attention import ref as far

    gen = torch.Generator(device=dev).manual_seed(11)
    cases, row = [], None
    for (name, b, hq, hkv, sq, sk, d, dtype, causal, window, kv_len,
         q_offset) in FLASH_CASES:
        dt = getattr(torch, dtype)
        # q/k/v as the model hands them over: (B, S, H, D) transposed
        q = torch.randn((b, sq, hq, d), generator=gen, device=dev).to(dt)
        kv = torch.randn((b, sk, 2 * hkv, d), generator=gen, device=dev
                         ).to(dt)
        q, k, v = (q.transpose(1, 2), kv[:, :, :hkv].transpose(1, 2),
                   kv[:, :, hkv:].transpose(1, 2))
        kw = dict(causal=causal, window=window, kv_len=kv_len,
                  q_offset=q_offset)
        impl = fak.INSTANCES[dt]
        before = fak.INSTANCE_LAUNCHES[impl].n
        got = fak.flash_attention_cuda(q, k, v, **kw)
        check(fak.INSTANCE_LAUNCHES[impl].n == before + 1,
              f"flash_attention {name}: ran the {impl} kernel")
        exp = far.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        tol = 2e-4 if dtype == "float32" else 2e-2
        err = (got.float() - exp.float()).abs()
        check(bool((err <= tol + tol * exp.float().abs()).all()),
              f"flash_attention {name}: max |err| {float(err.max())}")
        check(got.dtype == dt and got.shape == exp.shape,
              f"flash_attention {name}: dtype/shape")
        del got, exp
        ms = cuda_ms(lambda: fak.flash_attention_cuda(q, k, v, **kw))
        plain = cuda_ms(lambda: far.flash_attention(q, k, v, **kw), reps=2)
        pairs = b * hq * attn_pairs(sq, sk, causal, window, kv_len, q_offset)
        nbytes = (2 * b * hq * sq + 2 * b * hkv * sk) * d * q.element_size()
        # each type at its own peak: bf16 on the tensor cores, float32 on
        # the FMA units
        b_ms, b_by = bound(nbytes, 4 * pairs * d, BF16_OPS_PER_S
                           if dtype == "bfloat16" else FP32_OPS_PER_S)
        lib = None
        if window is None and kv_len is None and q_offset == 0:
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=hq != hkv))
        case = dict(case=name, impl=impl, shape=f"q {tuple(q.shape)} k "
                    f"{tuple(k.shape)} {dtype}", max_abs_err=float(err.max()),
                    ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib)
        cases.append(case)
        if row is None:
            row = dict(name="flash_attention", **{
                k: case[k] for k in ("impl", "shape", "max_abs_err", "ms",
                                     "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")})
        del q, k, v, kv, err
    torch.cuda.empty_cache()
    return row, cases


def set_use_flash(model, flag: bool) -> None:
    """Switch the model's self-attention between the flash kernel and the
    plain ``attend`` (the config every module reads)."""
    import dataclasses
    for m in model.modules():
        if hasattr(m, "cfg"):
            m.cfg = dataclasses.replace(m.cfg, use_flash=flag)


def serve_phase(arch: str, dev, seed: int, launches, profile: bool):
    """Serve ``arch`` at its full published size on the card; check the
    flash launches, the plain path and float32 greedy tokens."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = get_config(arch)
    b, s, n = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    rng = np.random.default_rng(seed + 2)
    prompts = rng.integers(1, cfg.vocab_size, (b, s), dtype=np.int32)
    model = LM(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    engine = Engine(model, ServeConfig(max_len=s + n + 8))

    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    out = engine.generate(prompts, n)
    counts, _ = launches.read()
    instances = {k: c.n for k, c in launches.flash_instances.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(out.shape == (b, n) and out.dtype == np.int32, f"{arch}: tokens")
    check(((out >= 0) & (out < cfg.vocab_size)).all(), f"{arch}: token ids")
    check(counts["flash_attention"] == cfg.n_layers,
          f"{arch}: flash launches {counts['flash_attention']} per prefill, "
          f"expected {cfg.n_layers}")
    check(instances == {"wgmma": cfg.n_layers, "simt": 0},
          f"{arch}: bf16 prefill launches by instance {instances}, expected "
          f"all {cfg.n_layers} on the tensor-core kernel")

    def prefill():
        logits, _ = engine.prefill(prompts)
        torch.cuda.synchronize()
        return logits

    flash_logits = prefill()
    check(bool(flash_logits.isfinite().all()), f"{arch}: finite logits")
    set_use_flash(model, False)
    plain_logits = prefill()
    set_use_flash(model, True)
    rel = float((flash_logits - plain_logits).abs().max()
                / plain_logits.abs().max())
    check(rel < 2e-2, f"{arch}: flash vs plain prefill logits rel {rel}")
    del flash_logits, plain_logits

    pre = timed_runs(prefill)
    gen = timed_runs(lambda: engine.generate(prompts, n))
    if profile:
        profile_run(f"serve_{arch}", lambda: engine.generate(prompts, n))
    del engine, model
    torch.cuda.empty_cache()

    # float32: identical greedy tokens on the kernel and the plain path
    f = SERVE_F32
    model = LM(dataclasses.replace(cfg, dtype="float32"),
               torch.Generator(device=dev).manual_seed(seed), dev)
    engine = Engine(model, ServeConfig(max_len=f["prompt"] + f["gen"] + 8))
    small = prompts[:f["batch"], :f["prompt"]]
    toks = engine.generate(small, f["gen"])
    set_use_flash(model, False)
    plain_toks = engine.generate(small, f["gen"])
    check(np.array_equal(toks, plain_toks),
          f"{arch}: float32 greedy tokens differ between flash and plain")
    del engine, model
    torch.cuda.empty_cache()

    pre_s, gen_s = statistics.median(pre), statistics.median(gen)
    emit(f"serve_{arch}", launches=counts, flash_instances=instances,
         batch=b, prompt=s, new_tokens=n,
         prefill_ms=pre_s * 1e3, decode_ms_per_token=(gen_s - pre_s)
         / (n - 1) * 1e3, generate_s=gen_s, tokens_per_s=b * n / gen_s,
         prefill_runs_s=pre, generate_runs_s=gen, peak_gib=peak,
         flash_vs_plain_rel=rel, f32_tokens_equal=True)


def make_events(seed: int):
    rng = np.random.default_rng(seed + 1)
    return {"g": rng.integers(0, ITEMS, EVENTS, dtype=np.int32),
            "t": rng.integers(0, DAYS, EVENTS, dtype=np.int32),
            "v": rng.standard_normal(EVENTS, dtype=np.float32),
            "q": rng.uniform(0, 100, EVENTS).astype(np.float32)}


def window_reduce(x, a, op: str):
    """Exact ``op(x[a[i] .. i])`` for every ``i``: a sparse table of
    power-of-two spans, each window covered by two overlapping spans."""
    n = x.shape[0]
    i = np.arange(n)
    k = np.frexp((i - a + 1).astype(np.float64))[1] - 1  # floor(log2(len))
    f = np.minimum if op == "min" else np.maximum
    out = np.empty_like(x)
    level = x
    for j in range(int(k.max()) + 1):
        sel = k == j
        out[sel] = f(level[a[sel]], level[i[sel] - (1 << j) + 1])
        span = 1 << j
        level = np.concatenate([f(level[:n - span], level[span:]),
                                level[n - span:]])
    return out


def ordered_oracle(ev):
    """numpy answers of the ordered chain (float64 sums, exact the rest).

    Sums never come from differences of one running sum over the whole
    table: against its magnitude a short window's float64 rounding would
    exceed the ``1e-5 * sum|v|`` the check allows."""
    order = np.lexsort((ev["t"], ev["g"]))
    o = {k: v[order] for k, v in ev.items()}
    n = EVENTS
    i = np.arange(n)
    g, t, v, q = o["g"], o["t"], o["v"], o["q"]
    seg = np.maximum.accumulate(np.where(np.r_[True, g[1:] != g[:-1]], i, 0))
    runs = np.r_[True, (g[1:] != g[:-1]) | (t[1:] != t[:-1])]
    run_start = np.maximum.accumulate(np.where(runs, i, 0))
    a = np.maximum(i - (ROLL - 1), seg)

    def rolling(x):
        """float64 window sums and sums of |x|, one shifted add a row."""
        tot, mag = np.zeros(n), np.zeros(n)
        for j in range(ROLL):
            xj = np.where(i - j >= a, np.roll(x, j), 0).astype(np.float64)
            tot += xj
            mag += np.abs(xj)
        return tot, mag

    def cumulative(x):
        """float64 running sums inside each partition, on a (partitions,
        longest partition) matrix, so no sum cancels against another
        partition's."""
        sid = np.cumsum(seg == i) - 1
        pos = i - seg
        m = np.zeros((sid[-1] + 1, pos.max() + 1))
        m[sid, pos] = x
        tot = np.cumsum(m, axis=1)[sid, pos]
        m[sid, pos] = np.abs(x)
        return tot, np.cumsum(m, axis=1)[sid, pos]

    count = i - a + 1
    v_sum, v_abs = rolling(v)
    q_sum, q_abs = rolling(q)
    same_next = np.r_[seg[1:] == seg[:-1], False]
    roll = {"count": count, "row_number": i - seg + 1,
            "rank": run_start - seg + 1,
            "v_lag": np.where(i - 1 >= seg, np.roll(v, 1), 0),
            "v_lead": np.where(same_next, np.roll(v, -1), 0),
            "v_min": window_reduce(v, a, "min"),
            "v_max": window_reduce(v, a, "max")}
    close = {"v_sum": (v_sum, v_abs), "q_sum": (q_sum, q_abs),
             "v_mean": (v_sum / count, v_abs / count)}
    cum = {"v_max": window_reduce(v, seg, "max")}
    cum_close = {"v_sum": cumulative(v)}
    sv = np.sort(ev["v"])
    tq = np.asarray(QS, np.float32) * np.float32(n - 1)
    lo, hi = np.floor(tq).astype(np.int64), np.ceil(tq).astype(np.int64)
    q_exact = sv[lo] + (tq - lo.astype(np.float32)) * (sv[hi] - sv[lo])
    return {"sorted": o, "roll": roll, "close": close, "cum": cum,
            "cum_close": cum_close, "top": sv[::-1][:TOPK].copy(),
            "q": q_exact, "q_np": np.quantile(ev["v"], QS)}


def ordered_path(DataFrame, ctx, ev, bucket_factor, sorts):
    """The ordered chain through the user entry points; ``sorts`` (the
    sort counter) is read around the windows and the exact quantile."""
    df = DataFrame.from_dict(ev, ctx, bucket_factor=bucket_factor)
    s = df.sort_values(["g", "t"])
    before = sorts.n
    roll = s.window(["g"], ["t"]).agg(W_AGGS, rows=ROLL)
    cum = s.window(["g"], ["t"]).agg(CUM_AGGS, rows=None)
    win_sorts = sorts.n - before
    top = s.topk("v", TOPK)
    sv = s.sort_values("v")
    before = sorts.n
    q = sv.quantile("v", QS, method="exact")
    torch.cuda.synchronize()
    return {"sorted": s, "roll": roll, "cum": cum, "top": top, "sv": sv,
            "q": q, "win_sorts": win_sorts, "q_sorts": sorts.n - before}


def check_ordered(res, oracle, tag: str):
    """Order exact, exact lanes exact, sums within ``1e-5 * sum|v|`` of
    each window; returns the windows' columns."""
    got = res["sorted"].to_numpy()
    for k, want in oracle["sorted"].items():
        check(np.array_equal(got[k], want), f"{tag}: sorted column {k}")
    out = {}
    for name, exact, close in (("roll", oracle["roll"], oracle["close"]),
                               ("cum", oracle["cum"], oracle["cum_close"])):
        w = res[name].to_numpy()
        for k, want in exact.items():
            check(np.array_equal(w[k], want), f"{tag}: {name} {k}")
        for k, (want, scale) in close.items():
            check_close(w[k], want, scale, f"{tag}: {name} {k}")
        check(res[name].overflow_report.is_exact(), f"{tag}: {name} exact")
        out[name] = w
    check(np.array_equal(res["top"].to_numpy()["v"], oracle["top"]),
          f"{tag}: topk values")
    check(np.array_equal(res["q"], oracle["q"]), f"{tag}: exact quantile "
          f"{res['q']} vs {oracle['q']}")
    check(np.allclose(res["q"], oracle["q_np"], rtol=1e-5, atol=1e-6),
          f"{tag}: quantile vs np.quantile")
    check(res["win_sorts"] == 0, f"{tag}: windows sorted {res['win_sorts']}x")
    check(res["q_sorts"] == 0, f"{tag}: exact quantile sorted")
    return out


SOURCES = {
    "hash_partition": ("src/repro_torch/csrc/hash_partition.cu",
                       "src/repro/kernels/hash_partition/kernel.py:75"),
    "probe": ("src/repro_torch/csrc/probe.cu",
              "src/repro/kernels/hash_join/kernel.py:70"),
    "segment_reduce_fused": ("src/repro_torch/csrc/segment_reduce.cu",
                             "src/repro/kernels/segment_reduce/kernel.py:111"),
    "segment_reduce": ("src/repro_torch/csrc/segment_reduce.cu",
                       "src/repro/kernels/segment_reduce/kernel.py:80"),
    "windowed_scan": ("src/repro_torch/csrc/window_scan.cu",
                      "src/repro/kernels/window_scan/kernel.py:75"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention_sm90.cu",
                        "src/repro/kernels/flash_attention/kernel.py:104"),
}


def sass_hgmma(lib) -> dict:
    """Count of ``HGMMA`` (wgmma) instructions in the SASS of each kernel
    of the built library that has any."""
    from repro_torch.kernels import native

    r = subprocess.run([native.cuda_tool("cuobjdump"), "-sass", str(lib)],
                       capture_output=True, text=True, timeout=300)
    check(r.returncode == 0, f"cuobjdump reads the kernels: {r.stderr}")
    counts, fn = {}, None
    for line in r.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif "HGMMA" in line and fn is not None:
            counts[fn] = counts.get(fn, 0) + 1
    return counts


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, "nvidia-smi reads the card")
    return r.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one run of each of phases 3-9")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import HPTMTContext
    from repro_torch.dataframe import DataFrame
    from repro_torch.kernels import native

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit("card", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda)

    # 1. build
    t0 = time.perf_counter()
    native.library(verbose=True)
    build_s, nvcc_s = time.perf_counter() - t0, native.build_seconds
    hgmma = sass_hgmma(native.build())
    sm90 = [f for f in hgmma if "flash_fwd_sm90" in f]
    check(len(sm90) == 3, f"HGMMA in every tensor-core flash instance: "
          f"{hgmma}")
    emit("build", seconds=build_s, nvcc_seconds=nvcc_s, hgmma=hgmma)

    left, right, sets = make_data(args.seed)
    oracle = make_oracle(left, right)

    # 2. kernels vs plain
    krows = kernel_phase(left, right, dev)
    wrow, wcases = window_kernel_phase(dev)
    frow, fcases = flash_kernel_phase(dev)
    krows += [wrow, frow]
    for r in krows:
        emit("kernel", **r)
    for c in wcases:
        emit("window_kernel", **c)
    for c in fcases:
        emit("flash_kernel", **c)

    launches = Launches()
    left_dev = {k: torch.from_numpy(v).to(dev) for k, v in left.items()}

    # 3. main path, 1 shard
    ctx1 = HPTMTContext(n_shards=1, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    res1 = main_path(DataFrame, ctx1, left, right, 1.0)
    counts3, ex3 = launches.read()
    check(ex3 == 0, f"1 shard exchanges: {ex3}")
    j1, g1 = check_main_path(res1, left_dev, oracle, "1 shard")
    peak3 = torch.cuda.max_memory_allocated() / 2**30
    del res1
    runs3 = timed_runs(lambda: main_path(DataFrame, ctx1, left, right, 1.0))
    if args.profile:
        profile_run("main_1shard",
                    lambda: main_path(DataFrame, ctx1, left, right, 1.0))
    emit("main_1shard", launches=counts3, exchanges=ex3,
         median_s=statistics.median(runs3), runs_s=runs3, peak_gib=peak3)

    # 4. the same data on 4 virtual shards
    ctx4 = HPTMTContext(n_shards=4, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    res4 = main_path(DataFrame, ctx4, left, right, 2.0)
    counts4, ex4 = launches.read()
    check(ex4 == 3, f"4 shard exchanges: {ex4} (join 2, groupby g 1, k 0)")
    check(counts4["hash_partition"] > 0, "4 shards launch hash_partition")
    j4, g4 = check_main_path(res4, left_dev, oracle, "4 shards")
    check(torch.equal(canonical(j1, sorted(j1)), canonical(j4, sorted(j4))),
          "4-shard join rows equal the 1-shard rows")
    for key in ("g", "v_count", "v_min", "v_max"):
        check(np.array_equal(g1[key], g4[key]), f"4-shard groupby {key}")
    peak4 = torch.cuda.max_memory_allocated() / 2**30
    del res4, j1, j4
    runs4 = timed_runs(lambda: main_path(DataFrame, ctx4, left, right, 2.0))
    if args.profile:
        profile_run("main_4shards",
                    lambda: main_path(DataFrame, ctx4, left, right, 2.0))
    emit("main_4shards", launches=counts4, exchanges=ex4,
         median_s=statistics.median(runs4), runs_s=runs4, peak_gib=peak4)

    # 5. set ops, 4 shards
    launches.reset()
    res5 = set_ops(DataFrame, ctx4, sets)
    counts5, ex5 = launches.read()
    u = np.sort(res5["union"].to_numpy()["k"])
    check(np.array_equal(u, np.union1d(sets["a"], sets["b"])), "union")
    d = np.sort(res5["difference"].to_numpy()["k"])
    keep = sets["a"][~np.isin(sets["a"], sets["b"])]
    check(np.array_equal(d, np.sort(keep)), "difference rows")
    check(np.array_equal(np.unique(d), np.setdiff1d(sets["a"], sets["b"])),
          "difference vs setdiff1d")
    del res5
    runs5 = timed_runs(lambda: set_ops(DataFrame, ctx4, sets))
    if args.profile:
        profile_run("setops_4shards", lambda: set_ops(DataFrame, ctx4, sets))
    emit("setops_4shards", launches=counts5, exchanges=ex5,
         median_s=statistics.median(runs5), runs_s=runs5,
         union_rows=int(u.shape[0]), difference_rows=int(d.shape[0]))

    # 6. ordered analytics, 1 shard
    events = make_events(args.seed)
    ord_oracle = ordered_oracle(events)
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    res6 = ordered_path(DataFrame, ctx1, events, 1.0, launches.sorts)
    counts6, ex6 = launches.read()
    check(ex6 == 0, f"ordered 1 shard exchanges: {ex6}")
    check(counts6["windowed_scan"] > 0, "ordered 1 shard launches "
          "windowed_scan")
    w1 = check_ordered(res6, ord_oracle, "ordered 1 shard")
    peak6 = torch.cuda.max_memory_allocated() / 2**30
    del res6
    runs6 = timed_runs(lambda: ordered_path(DataFrame, ctx1, events, 1.0,
                                            launches.sorts))
    if args.profile:
        profile_run("ordered_1shard", lambda: ordered_path(
            DataFrame, ctx1, events, 1.0, launches.sorts))
    emit("ordered_1shard", launches=counts6, exchanges=ex6,
         median_s=statistics.median(runs6), runs_s=runs6, peak_gib=peak6)

    # 7. the ordered chain on 4 virtual shards
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    res7 = ordered_path(DataFrame, ctx4, events, 2.0, launches.sorts)
    counts7, ex7 = launches.read()
    check(ex7 == 2, f"ordered 4 shard exchanges: {ex7} (the two sorts)")
    check(counts7["windowed_scan"] > 0, "ordered 4 shards launch "
          "windowed_scan")
    check(res7["sv"].overflow_report.is_exact(), "4 shards sort exact")
    w4 = check_ordered(res7, ord_oracle, "ordered 4 shards")
    for name in ("roll", "cum"):
        for k, v in w1[name].items():
            if not k.endswith(("_sum", "_mean")):
                check(np.array_equal(v, w4[name][k]),
                      f"4-shard {name} {k} equals 1 shard")
    peak7 = torch.cuda.max_memory_allocated() / 2**30
    del res7, w1, w4
    runs7 = timed_runs(lambda: ordered_path(DataFrame, ctx4, events, 2.0,
                                            launches.sorts))
    if args.profile:
        profile_run("ordered_4shards", lambda: ordered_path(
            DataFrame, ctx4, events, 2.0, launches.sorts))
    emit("ordered_4shards", launches=counts7, exchanges=ex7,
         median_s=statistics.median(runs7), runs_s=runs7, peak_gib=peak7)

    # 8./9. serving: phi3-mini-3.8b, then smollm-360m
    for arch in ("phi3-mini-3.8b", "smollm-360m"):
        serve_phase(arch, dev, args.seed, launches, args.profile)

    # 10. summary
    kernels = []
    for r in krows:
        name = r["name"]
        check(launches.total[name] > 0, f"main path launched {name}")
        src, replaces = SOURCES[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": launches.total[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    emit("summary", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
