"""Phase 29's services legs alone, at phase 13's size, on process groups.

    python3 scripts/group_services.py [--cut]

Run from the root of a checkout on a machine with an H100 (or four). It
builds the kernels, writes phase 12's left frame (2^25 rows) partitioned
on ``k``, runs the services legs on 4 virtual shards (``chip_smoke``'s
``services_ref``: phase 13's spilled join → groupby and window on 2^25 x
2^23 rows and 2^25 events under ``budget_rows = 2^21``, phase 14's
planned chain over that dataset, phase 17's resume chain committed in
full over the left frame, unpartitioned), then the same legs on 4
spawned ranks — NCCL with a card a rank where 4 cards exist, else gloo
with every rank on card 0 — with phase 17's workflow (a transient scan
fault on the last rank), and phase 17's kill-and-resume: a spawn of 4
ranks dies by SIGKILL at the second stage commit and 2 ranks of the same
4 shards resume (phase 29's leg B ranks die there themselves instead).  Every check of phase 29's services legs applies (rows bit for
bit against the virtual run, atomic sums against float64 oracles on each
rank's shards, ``SpillStats``, exchanges, sorts, launches, the committed
stage byte for byte, the journal); a failed one raises.  It prints the
card, one ``group_services`` line with each leg's seconds a rank, run-file
bytes and GB/s and peak GiB, and the script's seconds.  ``--cut`` runs
``chip_smoke.py``'s cut sizes instead.
"""
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    from repro_torch.core import HPTMTContext
    from repro_torch.dataframe import DataFrame
    from repro_torch.kernels import native
    from repro_torch.launch.mesh import run_ranks

    if not torch.cuda.is_available():
        print("group_services: no CUDA device is available", file=sys.stderr)
        return 2
    sizes = cs.GROUP_SPILL if "--cut" in sys.argv[1:] else cs.FULL_SPILL
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    native.library()
    cs.emit("build", seconds=time.perf_counter() - t0)
    left, right, _ = cs.make_data(0)
    oracle = cs.make_oracle(left, right)
    launches = cs.Launches()
    ctx4 = HPTMTContext(n_shards=4, device="cuda")
    backend = ("nccl" if torch.cuda.device_count() >= cs.GROUP_WORLD
               else "gloo")
    with tempfile.TemporaryDirectory(prefix="hptmt_services_") as tmp:
        lroot = os.path.join(tmp, "left")
        DataFrame.from_dict(left, ctx4, bucket_factor=2.0).to_hpt(
            lroot, partition_by=["k"])
        del left
        sref = cs.services_ref(ctx4, 0, sizes, lroot, tmp, right, launches)
        del right
        cs.emit("services_virtual", seconds=sref["seconds"],
                **{leg: {k: v for k, v in f.items() if k != "explain"}
                   for leg, f in sref["fields"].items()})
        torch.cuda.empty_cache()
        svc = {"sizes": sizes, "legs": cs.SERVICES, "lroot": lroot,
               "root": os.path.join(tmp, "group")}
        t0 = time.perf_counter()
        ranks = run_ranks(cs.services_rank, cs.GROUP_WORLD, backend, "cuda",
                          n_shards=4, args=(0, svc),
                          timeout_s=cs.GROUP_TIMEOUT_S)
        leg_s = time.perf_counter() - t0
        ckdir = os.path.join(tmp, "stages")
        crash_s = cs.crash_leg(backend, 0, sizes, sref, ckdir)
        resume = dict(cs.resume_leg(backend, 0, sizes, sref, ckdir),
                      crash_spawn_s=crash_s)
        line = cs.check_services("services", ranks, sref, oracle)
    cs.emit("group_services", backend=backend, world=cs.GROUP_WORLD,
            sizes=sizes, seconds=leg_s, resume=resume, **line)
    cs.emit("summary", seconds=time.perf_counter() - t_start)
    return 0


if __name__ == "__main__":
    sys.exit(main())
