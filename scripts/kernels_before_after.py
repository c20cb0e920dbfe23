"""The probe and windowed-scan kernels against those they replaced, on one
card.

    python3 scripts/kernels_before_after.py --old DIR [--rounds 3]

Run from the root of a checkout on a machine with an NVIDIA H100.  ``DIR``
holds ``probe.cu``, ``window_scan.cu``, ``common.cuh`` and ``errors.cu``
of revision a162e0a, the last with the three-array probe (``table_row``,
``slot_h2``, ``slot_keys``) and the three-pass scan (``pre``/``suf``
scratch, contiguous values), for example ``git show
a162e0a:src/repro_torch/csrc/probe.cu > DIR/probe.cu`` for each.
``OLD_SIGNATURES`` and ``run_old`` are those sources' C interfaces and
wrapper, so another revision needs its own.  The script builds them with
the port's own flags beside the current kernels and beside a copy of
``probe.cu`` patched to load the next slot's record with the current one
(``READ_AHEAD``), checks that all give the same bits, and times them with
CUDA events in turns (``order``: each round runs the list forward, then
backward), mean ms over ``--reps`` launches per turn:

* probe at the main path's join (2^25 probe rows, 2^23 build rows, 2^25
  slots, one int32 key lane, ``max_matches=1``): each kernel alone; the
  slot-record build (``slot_records``), its ``index_select`` alone
  (``records_gather``), earlier builds of the same records (an
  interleaved table by three column writes gathered by advanced indexing,
  ``records_columns``; by ``torch.cat``, ``records_cat``), the old payload
  gather (``slot_payload``), and the records' gather done as a gather of
  ``(rows, 4)`` int32 rows (``row_gather``);
* windowed_scan at ``(2^25 - 3, 2)`` float32, ``rows=32`` (sum over both
  lanes, min and max over one): each kernel on contiguous values, and as
  the window engine calls it — column views of an ``(n, 4)`` table, which
  the old wrapper copied and gave ``pre``/``suf`` scratch; also sums at
  w = 512 and 4096.

One JSON line a measurement, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

P, I64, INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
OLD_SIGNATURES = {
    # table_row, slot_h2, slot_keys, slots, lanes, ph1, ph2, pkeys, pvalid,
    # n, max_matches, max_probes, cnt, rimat, exhausted, stream
    "hptmt_probe": [P, P, P, I64, INT, P, P, P, P, I64, INT, INT, P, P, P, P],
    # values, seg, n, lanes, window, op, tile, pre, suf, carry_pre,
    # carry_suf, out, stream
    "hptmt_windowed_scan": [P, P, I64, INT, I64, INT, INT, P, P, P, P, P, P],
}
SOURCES = ("common.cuh", "errors.cu", "probe.cu", "window_scan.cu")
#: probe.cu patched to issue the load of visit j + 1 with visit j's
#: (``asm volatile`` keeps each load before the branch on the last record)
READ_AHEAD = [
    ("    return __ldg(rec + slot);\n",
     "    int4 r;\n"
     "    asm volatile(\"ld.global.nc.v4.s32 {%0, %1, %2, %3}, [%4];\"\n"
     "                 : \"=r\"(r.x), \"=r\"(r.y), \"=r\"(r.z), \"=r\"(r.w)\n"
     "                 : \"l\"(rec + slot));\n"
     "    return r;\n"),
    ("            for (int j = 0; j < max_probes; ++j) {\n"
     "                const int4 cur = load_record(rec, slot);\n",
     "            int4 cur = max_probes > 0 ? load_record(rec, slot) : int4{};\n"
     "            for (int j = 0; j < max_probes; ++j) {\n"
     "                const uint32_t next = (slot + step) & slot_mask;\n"
     "                int4 ahead = cur;\n"
     "                if (j + 1 < max_probes) ahead = load_record(rec, next);\n"),
    ("                slot = (slot + step) & slot_mask;\n",
     "                slot = next;\n"
     "                cur = ahead;\n"),
]
OPS = {"sum": 0, "min": 1, "max": 2}


def load(csrc: Path, out: Path, signatures) -> ctypes.CDLL:
    from repro_torch.kernels import native

    lib = ctypes.CDLL(str(native.build(csrc=csrc, out=out)))
    for name, argtypes in signatures.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def timed(fns: dict, order, rounds: int, reps: int) -> dict:
    """Mean ms of each ``fns[name]`` over ``reps`` launches a turn, turns
    in ``order`` then reversed, ``rounds`` times."""
    times = {k: [] for k in fns}
    for name in fns:
        fns[name]()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(rounds):
        for name in list(order) + list(reversed(order)):
            start.record()
            for _ in range(reps):
                fns[name]()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / reps)
    return {k: sum(v) / len(v) for k, v in times.items()}


def probe_phase(old, ahead, dev, rounds, reps):
    from repro_torch.core.exchange import key_compare_u32
    from repro_torch.core.table import hash_columns
    from repro_torch.core.table_ops import _hash_slots
    from repro_torch.kernels import native
    from repro_torch.kernels.hash_join import kernel as hjk
    from repro_torch.kernels.hash_join import ref as hjr

    n, nb = 1 << 25, 1 << 23
    gen = torch.Generator(device=dev).manual_seed(0)
    rk = torch.randperm(nb, generator=gen, device=dev).to(torch.int32)
    lk = torch.randint(0, nb, (n,), generator=gen, device=dev,
                       dtype=torch.int32)
    rh1, rh2 = hash_columns([rk])
    lh1, lh2 = hash_columns([lk])
    slots = _hash_slots(nb)
    table, unplaced = hjr.build_table(rh1, rh2, torch.ones_like(
        rk, dtype=torch.bool), slots, 64)
    assert int(unplaced) == 0
    rl = key_compare_u32({"k": rk}, ["k"])
    ll = key_compare_u32({"k": lk}, ["k"])
    pvalid = torch.ones(n, dtype=torch.bool, device=dev)
    sh2, skeys = hjr.slot_payload(table, rh2, rl)
    records, side = hjr.slot_records(table, rh2, rl)
    stream = native.stream(dev)

    def outputs():
        return (torch.empty(n, dtype=torch.int32, device=dev),
                torch.empty((n, 1), dtype=torch.int32, device=dev),
                torch.empty(n, dtype=torch.bool, device=dev))

    def run_old():
        c, r, e = outs["old"]
        check(old.hptmt_probe(table.data_ptr(), sh2.data_ptr(),
                              skeys.data_ptr(), slots, 1, lh1.data_ptr(),
                              lh2.data_ptr(), ll.data_ptr(),
                              pvalid.data_ptr(), n, 1, 64, c.data_ptr(),
                              r.data_ptr(), e.data_ptr(), stream), "old")

    def run_ahead():
        c, r, e = outs["ahead"]
        check(ahead.hptmt_probe(records.data_ptr(), None, slots, 1,
                               lh1.data_ptr(), lh2.data_ptr(), ll.data_ptr(),
                               pvalid.data_ptr(), n, 1, 64, c.data_ptr(),
                               r.data_ptr(), e.data_ptr(), stream), "ahead")

    outs = {"old": outputs(), "ahead": outputs()}
    run_old()
    run_ahead()
    new = hjk.probe_cuda(records, side, lh1, lh2, ll, pvalid, 1, 64)
    for name in ("old", "ahead"):
        for a, b in zip(outs[name], new):
            assert torch.equal(a, b), f"probe {name} differs from the new"
    # the same records by the build's index_select alone, by earlier
    # builds (an interleaved table by three column writes or by torch.cat,
    # gathered by advanced indexing with the empty record last) and by a
    # gather of (rows, 4) int32 rows
    i32, c128 = torch.int32, torch.complex128
    first = torch.cat([torch.tensor([[-1, 0, 0, 0]], dtype=i32, device=dev),
                       torch.stack([torch.arange(nb, dtype=i32, device=dev),
                                    rh2, rl[:, 0], torch.zeros_like(rh2)],
                                   1)])
    last = torch.cat([first[1:], first[:1]])

    def records_gather():
        return first.view(c128)[:, 0].index_select(0, table + 1)

    def records_columns():
        build = torch.zeros((nb + 1, 4), dtype=i32, device=dev)
        build[:nb, 0] = torch.arange(nb, dtype=i32, device=dev)
        build[nb, 0] = -1
        build[:nb, 1] = rh2
        build[:nb, 2:3] = rl
        return build.view(c128)[:, 0][table]

    def records_cat():
        build = torch.empty((nb + 1, 4), dtype=i32, device=dev)
        build[0] = 0
        build[0, 0] = -1
        torch.cat([torch.arange(nb, dtype=i32, device=dev)[:, None],
                   rh2[:, None], rl, rl.new_zeros((nb, 1))], 1,
                  out=build[1:])
        return build.view(c128)[:, 0].index_select(0, table + 1)

    for got in (records_gather(), records_columns(), records_cat()):
        assert torch.equal(got.view(i32).reshape(-1, 4), records)
    assert torch.equal(last[table], records)
    fns = {"old": run_old,
           "new": lambda: hjk.probe_cuda(records, side, lh1, lh2, ll, pvalid,
                                         1, 64),
           "new_read_ahead": run_ahead,
           "slot_records": lambda: hjr.slot_records(table, rh2, rl),
           "records_gather": records_gather,
           "records_columns": records_columns,
           "records_cat": records_cat,
           "slot_payload": lambda: hjr.slot_payload(table, rh2, rl),
           "row_gather": lambda: last[table]}
    order = ["old", "new", "new_read_ahead", "slot_records", "records_gather",
             "records_columns", "records_cat", "slot_payload", "row_gather"]
    ms = timed(fns, order, rounds, reps)
    print(json.dumps({"kernel": "probe", "shape": f"N={n}, S={slots}, "
                      f"build {nb}, L=1, M=1", "order": order, "ms": ms,
                      "new_with_records": ms["new"] + ms["slot_records"],
                      "old_with_payload": ms["old"] + ms["slot_payload"]}),
          flush=True)


def scan_phase(old, dev, rounds, reps):
    from repro_torch.kernels import native
    from repro_torch.kernels.window_scan import kernel as wsk

    n = (1 << 25) - 3
    gen = torch.Generator(device=dev).manual_seed(7)
    table = torch.randn((n, 4), generator=gen, device=dev)
    flags = torch.rand(n, generator=gen, device=dev) < 1 / 512
    flags[0] = True
    seg = torch.cummax(torch.where(flags, torch.arange(n, device=dev), 0),
                       0).values.to(torch.int32)
    stream = native.stream(dev)
    views = {"sum": table[:, :2], "min": table[:, 2:3], "max": table[:, 3:4]}
    dense = {op: v.contiguous() for op, v in views.items()}

    def run_old(values, w, op):
        """The old wrapper: a contiguous copy and pre/suf scratch."""
        values = values.contiguous()
        lanes = values.shape[1]
        out = torch.empty_like(values)
        pre, suf = torch.empty_like(values), torch.empty_like(values)
        k = -(-w // wsk.TILE) if w > wsk.TILE else 0
        carry = torch.empty((2, -(-n // w) * k, lanes), device=dev)
        check(old.hptmt_windowed_scan(
            values.data_ptr(), seg.data_ptr(), n, lanes, w, OPS[op],
            wsk.TILE, pre.data_ptr(), suf.data_ptr(), carry[0].data_ptr(),
            carry[1].data_ptr(), out.data_ptr(), stream), "old scan")
        return out

    cases = [(32, "sum"), (32, "min"), (32, "max"), (512, "sum"),
             (4096, "sum")]
    for w, op in cases:
        new = wsk.windowed_scan_cuda(views[op], seg, w, op)
        for got in (run_old(dense[op], w, op),
                    wsk.windowed_scan_cuda(dense[op], seg, w, op)):
            assert torch.equal(got.view(torch.int32), new.view(torch.int32)), \
                f"windowed_scan w={w} {op} differs"
        fns = {"old": lambda: run_old(dense[op], w, op),
               "new": lambda: wsk.windowed_scan_cuda(dense[op], seg, w, op),
               "old_engine_view": lambda: run_old(views[op], w, op),
               "new_engine_view": lambda: wsk.windowed_scan_cuda(
                   views[op], seg, w, op)}
        order = ["old", "new", "old_engine_view", "new_engine_view"]
        ms = timed(fns, order, rounds, reps)
        print(json.dumps({"kernel": "windowed_scan", "window": w, "op": op,
                          "shape": f"({n}, {views[op].shape[1]}) f32",
                          "order": order, "ms": ms}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, type=Path,
                    help="directory with the earlier revision's sources")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernels_before_after: no CUDA device is available",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import native

    dev = torch.device("cuda")
    build = ROOT / "src" / "repro_torch" / "build"
    old_src = build / "before" / "src"
    shutil.rmtree(old_src, ignore_errors=True)
    old_src.mkdir(parents=True)
    for name in SOURCES:
        shutil.copy(args.old / name, old_src / name)
    old = load(old_src, old_src.parent, OLD_SIGNATURES)
    src = build / "variants" / "probe-read-ahead" / "src"
    shutil.rmtree(src, ignore_errors=True)
    src.mkdir(parents=True)
    for f in ("common.cuh", "errors.cu"):
        shutil.copy(native.CSRC / f, src / f)
    text = (native.CSRC / "probe.cu").read_text()
    for before, after in READ_AHEAD:
        if before not in text:
            raise ValueError(f"read-ahead patch: {before!r} is not in probe.cu")
        text = text.replace(before, after)
    (src / "probe.cu").write_text(text)
    ahead = load(src, src.parent,
                 {"hptmt_probe": native.SIGNATURES["hptmt_probe"]})
    native.library()
    probe_phase(old, ahead, dev, args.rounds, args.reps)
    scan_phase(old, dev, args.rounds, args.reps)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
