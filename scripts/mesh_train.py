"""Phases 25 and 30 of ``chip_smoke.py`` alone: a train step on one card,
then the training launcher's mesh path on 4 ranks.

    python3 scripts/mesh_train.py [--seed 0] [--skip-one-card]

Run from the root of a checkout on a machine with an H100 (or four). It
builds the kernels, runs phase 25 (smollm-360m's one-card step at batch
8 x 1024, the yardstick of phase 30's step times; ``--skip-one-card``
leaves it out) and ``chip_smoke``'s ``mesh_train_phase``: smollm-360m
whole (``chip_smoke.py`` cuts it to 4 of its 32 layers and its corpus to
2^13 documents) with its elastic
checkpoint — the 4.34 GB ``TrainState`` saved on 2x2 and restored by a
second spawn of 2 ranks on 2x1 — and qwen2-moe-a2.7b (2 of 24 layers) on
a 2x2 mesh of 4 spawned ranks — NCCL with a card a rank where 4 cards
exist, else gloo with every rank on card 0 — printing one ``mesh_train``
line a config and the launch totals.  Every check of both phases
applies; a failed one raises.
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-one-card", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mesh_train: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import native

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    native.library()
    cs.emit("build", seconds=time.perf_counter() - t0)
    launches = cs.Launches()
    if not args.skip_one_card:
        t0 = time.perf_counter()
        cs.emit("train_step", **cs.train_phase(torch.device("cuda"),
                                               args.seed, launches, False))
        cs.emit("train_step_seconds", total=time.perf_counter() - t0)
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    cs.MESH_TRAIN["smollm"] = dict(
        cs.MESH_TRAIN["smollm"], layers=None,
        corpus={"n_docs": 1 << 15, "mean_doc_len": 512})
    cs.mesh_train_phase(args.seed, launches)
    cs.emit("mesh_train_seconds", total=time.perf_counter() - t0)
    cs.emit("launches", **launches.total)
    cs.emit("summary", seconds=time.perf_counter() - t_start)
    return 0


if __name__ == "__main__":
    sys.exit(main())
