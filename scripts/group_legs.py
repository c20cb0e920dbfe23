"""Phase 29 of ``chip_smoke.py`` alone: the table path on process groups.

    python3 scripts/group_legs.py

Run from the root of a checkout on a machine with an H100 (or four). It
builds the kernels, runs phases 4, 5 and 7's chains on 4 virtual shards
(the reference the group legs are held against; one checked run, then 3
timed, printed as a ``virtual_4shards`` line), phases 12 and 15 (whose
partitioned files, re-entry results and TSet pipelines the storage legs
are held against) and phase 26's curation of its corpus on 4 virtual
shards (the stream the disk-corpus leg must give), then ``chip_smoke``'s
``group_phase``: leg A on a 1-rank NCCL group in this process, leg B on 4
spawned ranks — NCCL with a card a rank where 4 cards exist, else gloo
with every rank on card 0 — printing one ``group`` line a leg and the
launch totals.  Every check of phase 29 applies; a failed one raises.
"""
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def corpus_ref(ctx4, launches) -> dict:
    """Phase 26's corpus curated on 4 virtual shards: the stream's digest,
    the exchanges and the seconds."""
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline as TP

    ccfg = cs.workflow_corpus(get_config(cs.TRAIN_ARCH), 0)
    launches.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stream = TP.preprocess(TP.synthetic_corpus(ccfg, ctx4), ccfg, ctx4)
    seconds = time.perf_counter() - t0
    _, exchanges = launches.read()
    return {"stream_digest": cs.digest(torch.from_numpy(stream)),
            "exchanges": exchanges, "preprocess_s": seconds}


def main():
    from repro_torch.core import HPTMTContext
    from repro_torch.dataframe import DataFrame
    from repro_torch.kernels import native

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    native.library()
    print("build", time.perf_counter() - t0, flush=True)
    left, right, sets = cs.make_data(0)
    oracle = cs.make_oracle(left, right)
    events = cs.make_events(0)
    launches = cs.Launches()
    ctx4 = HPTMTContext(n_shards=4, device="cuda")
    t0 = time.perf_counter()
    launches.reset()
    res4 = cs.main_path(DataFrame, ctx4, left, right, 2.0)
    _, ex4 = launches.read()
    ref_main = cs.shard_prints(res4, 0)
    del res4
    launches.reset()
    res5 = cs.set_ops(DataFrame, ctx4, sets)
    _, ex5 = launches.read()
    ref_set = cs.shard_prints(res5, 0)
    del res5
    launches.reset()
    res7 = cs.ordered_path(DataFrame, ctx4, events, 2.0, launches.sorts)
    _, ex7 = launches.read()
    ref = {"main": ref_main, "setops": ref_set, "right": right,
           "ordered": cs.shard_prints(res7, 0),
           "exchanges": {"main": ex4, "setops": ex5, "ordered": ex7}}
    del res7
    print("virtual + prints", time.perf_counter() - t0, ref["exchanges"],
          flush=True)
    vt = {"main": cs.timed_runs(lambda: cs.main_path(DataFrame, ctx4, left,
                                                     right, 2.0)),
          "setops": cs.timed_runs(lambda: cs.set_ops(DataFrame, ctx4,
                                                     sets)),
          "ordered": cs.timed_runs(lambda: cs.ordered_path(
              DataFrame, ctx4, events, 2.0, launches.sorts))}
    cs.emit("virtual_4shards",
            median_s={k: statistics.median(v) for k, v in vt.items()},
            runs_s=vt)
    ctx1 = HPTMTContext(n_shards=1, device="cuda")
    left_dev = {k: torch.from_numpy(v).to(dev) for k, v in left.items()}
    storage = cs.storage_phase(DataFrame, ctx1, ctx4, left, right, left_dev,
                               oracle, launches, False)
    ref["storage"] = storage.pop("group_ref")
    tset = cs.tset_phase(DataFrame, ctx1, ctx4, left, right, events, oracle,
                         cs.ordered_oracle(events), launches, False)
    ref["tset"] = tset.pop("group_ref")
    for tag, fields in {**storage, **tset}.items():
        cs.emit(tag, **fields)
    del left_dev, storage, tset
    ref["corpus"] = corpus_ref(ctx4, launches)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for line in cs.group_phase(ref, oracle, dev, 0, launches):
        cs.emit("group", **line)
    print("phase 29 s", time.perf_counter() - t0, "total",
          time.perf_counter() - t_start, flush=True)
    print(json.dumps(launches.total))


if __name__ == "__main__":
    main()
