"""Variants of the segment-reduction kernels, side by side on one card.

    python3 scripts/segment_variants.py [--rounds 3]

Run from the root of a checkout on a machine with an NVIDIA H100.  It
builds ``src/repro_torch/csrc/segment_reduce.cu`` as it is and patched
copies of it, each into its own library, and times them in turns (CUDA
events, mean ms over ``--reps`` launches a turn, each round forward then
backward) at the shapes of ``scripts/segment_before_after.py``:

* ``current`` — the source as it is;
* ``cta512`` — shared-memory CTAs of 512 threads always (the source takes
  1024 where only one tile fits on an SM);
* ``one_chunk`` — the direct path's warps load one chunk of 32 rows before
  they reduce it (the source loads four);
* ``plain_add`` — the shared-memory sum adds with a plain read-add-write
  in place of ``atomicAdd``: racy and wrong, timed only to price the
  atomic (its sums are not checked).

Every other variant is checked against the plain version (counts exact,
sums within ``1e-5 * sum|v|``, min/max bit for bit).  Then it counts, in
the SASS of ``current`` (``cuobjdump -sass``), the shared-memory atomic
instructions of each segment kernel by opcode: the float add compiles to
a compare-and-swap loop (``ATOMS.CAST.SPIN``), min/max to native integer
atomics.  One JSON line a shape and op, one for the census, then the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys

import torch

from kernels_before_after import check, load, timed
from segment_before_after import hash_slots, sorted_ids

VARIANTS = {
    "current": [],
    "cta512": [("    if (err == cudaSuccess && per_sm < 2) {",
                "    if (err == cudaSuccess && per_sm < 0) {")],
    "one_chunk": [("    constexpr int kChunks = 4;",
                   "    constexpr int kChunks = 1;")],
    "plain_add": [("    static __device__ __forceinline__ void atomic(T* a, T v) "
                   "{ atomicAdd(a, v); }",
                   "    static __device__ __forceinline__ void atomic(T* a, T v) "
                   "{ *a += v; }")],
}
UNCHECKED = {"plain_add"}
_OPS = {"sum": (0, 0.0), "min": (1, float("inf")), "max": (2, float("-inf"))}


def build(native):
    base = (native.CSRC / "segment_reduce.cu").read_text()
    sigs = {k: native.SIGNATURES[k] for k in ("hptmt_segment_sum_fused",
                                              "hptmt_segment_reduce")}
    libs, paths = {}, {}
    for name, patches in VARIANTS.items():
        text = base
        for before, after in patches:
            if before not in text:
                raise ValueError(f"{name}: {before!r} is not in the source")
            text = text.replace(before, after)
        src = native.BUILD / "segment_variants" / name / "src"
        shutil.rmtree(src, ignore_errors=True)
        src.mkdir(parents=True)
        for f in ("common.cuh", "errors.cu"):
            shutil.copy(native.CSRC / f, src / f)
        (src / "segment_reduce.cu").write_text(text)
        libs[name] = load(src, src.parent, sigs)
        paths[name] = sorted(src.parent.glob("libhptmt_*.so"))[0]
    return libs, paths


def measure(libs, dev, case, seg, num_segments, lanes, ops, rounds, reps):
    from repro_torch.kernels import native
    from repro_torch.kernels.segment_reduce import ref as srr

    n = seg.shape[0]
    gen = torch.Generator(device=dev).manual_seed(11)
    vals = torch.randn((n, lanes), generator=gen, device=dev)
    vals[:, 0] = 1.0
    stream = native.stream(dev)
    for op in ops:
        code, init = _OPS[op]
        v = vals if op == "sum" else vals[:, 1].contiguous()

        def runner(lib):
            def run():
                if op == "sum":
                    out = torch.zeros((num_segments, lanes), device=dev)
                    check(lib.hptmt_segment_sum_fused(
                        v.data_ptr(), seg.data_ptr(), n, lanes, num_segments,
                        out.data_ptr(), stream), "fused")
                else:
                    out = torch.full((num_segments,), init, device=dev)
                    check(lib.hptmt_segment_reduce(
                        v.data_ptr(), seg.data_ptr(), n, num_segments, code,
                        out.data_ptr(), stream), op)
                return out
            return run

        fns = {name: runner(lib) for name, lib in libs.items()}
        if op == "sum":
            exp = srr.segment_reduce_fused(v, seg, num_segments)
            scale = srr.segment_reduce_fused(v.abs(), seg, num_segments)
        else:
            exp = srr.segment_reduce(v, seg, num_segments, op)
        for name, fn in fns.items():
            if name in UNCHECKED:
                continue
            got = fn()
            if op == "sum":
                assert torch.equal(got[:, 0], exp[:, 0]), f"{case} {name}"
                assert bool(((got - exp).abs() <= 1e-5 * scale).all()), \
                    f"{case} {name} sums"
            else:
                assert torch.equal(got.view(torch.int32),
                                   exp.view(torch.int32)), f"{case} {name}"
        order = list(fns)
        ms = timed(fns, order, rounds, reps)
        print(json.dumps({"case": case, "op": op,
                          "shape": f"N={n}, L={lanes if op == 'sum' else 1}, "
                                   f"S={num_segments}",
                          "order": order, "ms": ms}), flush=True)


def shared_atomics(native, lib) -> dict:
    """``{kernel: {opcode: count}}`` of shared-memory atomics in the SASS."""
    r = subprocess.run([native.cuda_tool("cuobjdump"), "-sass", str(lib)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"cuobjdump: {r.stderr}")
    counts, fn = {}, None
    for line in r.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn and "segment" in fn and "ATOMS." in line:
            opcode = line.split("ATOMS.")[1].split()[0]
            kernel = counts.setdefault(fn, {})
            kernel["ATOMS." + opcode] = kernel.get("ATOMS." + opcode, 0) + 1
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("segment_variants: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import native

    dev = torch.device("cuda")
    libs, paths = build(native)
    measure(libs, dev, "hash", hash_slots(1 << 25, 1024, 8192, dev), 8192, 3,
            ("sum", "min"), args.rounds, args.reps)
    measure(libs, dev, "hash_partial", hash_slots(1 << 23, 1024, 32768, dev),
            32768, 3, ("sum", "min"), args.rounds, args.reps)
    measure(libs, dev, "sort", sorted_ids(1 << 25, 1 << 23, dev), 1 << 25, 1,
            ("sum",), args.rounds, args.reps)
    print(json.dumps({"shared_atomics": shared_atomics(native,
                                                        paths["current"])}),
          flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
