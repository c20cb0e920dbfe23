"""The segment-reduction kernels against those they replaced, on one card.

    python3 scripts/segment_before_after.py --old DIR [--rounds 3]

Run from the root of a checkout on a machine with an NVIDIA H100.  ``DIR``
holds ``segment_reduce.cu``, ``common.cuh`` and ``errors.cu`` of revision
432e730, the last with one global atomic per (row, lane) and the
compare-and-swap min/max, for example ``git show
432e730:src/repro_torch/csrc/segment_reduce.cu > DIR/segment_reduce.cu``
for each.  Its C entry points have the current signatures, so the old
library is called as the current wrappers call the new one: the output
zeroed (sum) or filled with the identity (min/max), then one call.  The
script builds it with the port's own flags, checks that old and new agree
with the plain version (counts exact, sums within ``1e-5 * sum|v|``,
min/max bit for bit), and times both with CUDA events in turns
(``order``: each round runs the list forward, then backward), mean ms over
``--reps`` launches a turn, beside the library call that computes the
same function (``index_add_``, ``scatter_reduce_``), at the shapes of
``chip_smoke.py``'s main path:

* ``hash``: the 1-shard hash groupby on ``g`` — 2^25 rows, ``g`` uniform
  over 1024 groups in 8192 hash slots: the fused sum over 3 lanes, min,
  max;
* ``hash_partial``: one shard's partial groupby of the 4-shard run — 2^23
  rows, 1024 groups in 32768 slots: the fused sum over 3 lanes (two lane
  chunks), min;
* ``sort``: the sort groupby on ``k`` — 2^25 rows, ids of the rows sorted
  by ``k`` (about 4 rows a run), ``S`` = 2^25, one lane.

One JSON line a measurement (with the new kernel's path and the bytes
bound), then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from kernels_before_after import ROOT, check, load, timed

SOURCES = ("common.cuh", "errors.cu", "segment_reduce.cu")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
_OPS = {"sum": (0, 0.0), "min": (1, float("inf")), "max": (2, float("-inf"))}


def hash_slots(rows: int, groups: int, slots: int, dev):
    """Segment ids of the hash groupby: the slot each row's group claims."""
    from repro_torch.core.exchange import key_compare_u32
    from repro_torch.core.table import hash_columns
    from repro_torch.kernels.hash_join import ref as hjr

    gen = torch.Generator(device=dev).manual_seed(3)
    g = torch.randint(0, groups, (rows,), generator=gen, device=dev,
                      dtype=torch.int32)
    h1, h2 = hash_columns([g])
    _, seg, unres = hjr.build_table_unique(
        h1, h2, key_compare_u32({"g": g}, ["g"]),
        torch.ones_like(g, dtype=torch.bool), slots, 64)
    assert not bool(unres.any())
    return seg.contiguous()


def sorted_ids(rows: int, keys: int, dev):
    """Segment ids of the sort groupby: rows sorted by a key uniform over
    ``keys``, one id a distinct key."""
    gen = torch.Generator(device=dev).manual_seed(5)
    k = torch.sort(torch.randint(0, keys, (rows,), generator=gen,
                                 device=dev, dtype=torch.int32)).values
    new = torch.ones_like(k, dtype=torch.bool)
    new[1:] = k[1:] != k[:-1]
    return (torch.cumsum(new, 0, dtype=torch.int32) - 1).contiguous()


def measure(old, dev, case, seg, num_segments, lanes, ops, rounds, reps):
    from repro_torch.kernels import native
    from repro_torch.kernels.segment_reduce import kernel as srk
    from repro_torch.kernels.segment_reduce import ref as srr

    n = seg.shape[0]
    gen = torch.Generator(device=dev).manual_seed(11)
    vals = torch.randn((n, lanes), generator=gen, device=dev)
    vals[:, 0] = 1.0
    seg64 = seg.long()
    stream = native.stream(dev)

    for op in ops:
        code, init = _OPS[op]
        v = vals if op == "sum" else vals[:, 1].contiguous()

        def run_old():
            if op == "sum":
                out = torch.zeros((num_segments, lanes), device=dev)
                check(old.hptmt_segment_sum_fused(
                    v.data_ptr(), seg.data_ptr(), n, lanes, num_segments,
                    out.data_ptr(), stream), "old fused")
            else:
                out = torch.full((num_segments,), init, device=dev)
                check(old.hptmt_segment_reduce(
                    v.data_ptr(), seg.data_ptr(), n, num_segments, code,
                    out.data_ptr(), stream), "old segment_reduce")
            return out

        if op == "sum":
            def run_new():
                return srk.segment_reduce_fused_cuda(v, seg, num_segments)

            def library():
                return torch.zeros((num_segments, lanes),
                                   device=dev).index_add_(0, seg64, v)
            exp = srr.segment_reduce_fused(v, seg, num_segments)
            scale = srr.segment_reduce_fused(v.abs(), seg, num_segments)
            for name, got in (("old", run_old()), ("new", run_new())):
                assert torch.equal(got[:, 0], exp[:, 0]), f"{case} {name} count"
                assert bool(((got - exp).abs() <= 1e-5 * scale).all()), \
                    f"{case} {name} sums"
            path = srk.path(num_segments, lanes)
            nbytes = n * lanes * 4 + n * 4 + num_segments * lanes * 4
        else:
            def run_new():
                return srk.segment_reduce_cuda(v, seg, num_segments, op)

            def library():
                return torch.full((num_segments,), init,
                                  device=dev).scatter_reduce_(
                    0, seg64, v, "a" + op, include_self=True)
            exp = srr.segment_reduce(v, seg, num_segments, op).view(torch.int32)
            for name, got in (("old", run_old()), ("new", run_new())):
                assert torch.equal(got.view(torch.int32), exp), f"{case} {name}"
            path = srk.path(num_segments, 1)
            nbytes = n * 4 + n * 4 + num_segments * 4
        fns = {"old": run_old, "new": run_new, "library": library}
        order = ["old", "new", "library"]
        ms = timed(fns, order, rounds, reps)
        print(json.dumps({"kernel": "segment_reduce_fused" if op == "sum"
                          else "segment_reduce", "case": case, "op": op,
                          "shape": f"N={n}, L={lanes if op == 'sum' else 1}, "
                                   f"S={num_segments}",
                          "path": path, "order": order, "ms": ms,
                          "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, type=Path,
                    help="directory with the earlier revision's sources")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("segment_before_after: no CUDA device is available",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import native

    dev = torch.device("cuda")
    old_src = ROOT / "src" / "repro_torch" / "build" / "segment_before" / "src"
    shutil.rmtree(old_src, ignore_errors=True)
    old_src.mkdir(parents=True)
    for name in SOURCES:
        shutil.copy(args.old / name, old_src / name)
    old = load(old_src, old_src.parent,
               {k: native.SIGNATURES[k] for k in ("hptmt_segment_sum_fused",
                                                  "hptmt_segment_reduce")})
    native.library()
    measure(old, dev, "hash", hash_slots(1 << 25, 1024, 8192, dev), 8192, 3,
            ("sum", "min", "max"), args.rounds, args.reps)
    measure(old, dev, "hash_partial", hash_slots(1 << 23, 1024, 32768, dev),
            32768, 3, ("sum", "min"), args.rounds, args.reps)
    measure(old, dev, "sort", sorted_ids(1 << 25, 1 << 23, dev), 1 << 25, 1,
            ("sum",), args.rounds, args.reps)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
