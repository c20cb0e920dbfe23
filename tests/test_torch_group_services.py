"""The runtime services on a process group: spill, the lazy planner,
stage checkpoints and the workflow engine.

``tests/torch_group_services_cases.py`` runs on ``gloo`` groups of CPU
ranks at ``(world, n_shards)`` = (4, 4), (2, 4) and (1, 4), one
``run_ranks`` call a layout, and every rank is held bit for bit against
the port's virtual 4-shard run: the spilled join (inner, left, outer),
groupby and window, a skewed input refined once and left oversized,
``spill="auto"`` by the budget and on an in-memory overflow,
``SpillStats``, the store removed and the workdir's own file kept,
``TSet.from_spill``; the three planner contract chains (rows, predicted
== counted exchanges on every rank, ``explain()`` text, fired rules, the
audit, q-errors, ``refine()`` and the ledger rank 0 appends),
``TSet.lazy``; every stage of a planned chain committed (the files byte
for byte), a fully committed rerun, and a ``plan.step`` fault armed on
one rank retried by every rank; a 3-task workflow whose transient scan
fault on one rank every rank retries, its journal, its resume and the
stale-journal refusal on every rank.  A run-write fault armed on one rank
raises ``SpillWriteError`` on every rank, an empty window source on one
rank a ``ValueError`` on every rank, and an agreed retry stops on every
rank when any rank's error is fatal.

Kill-and-resume: 4 ranks die by SIGKILL at the second stage commit; 4
ranks, and 2 ranks of the same 4 shards, resume from the snapshot and
re-run only the suffix (1 exchange), with the virtual resume's rows and
files.  The spilled join is also held against the JAX package's spill on
4 forced host devices.
"""
from __future__ import annotations

import os
import pathlib

import pytest

torch = pytest.importorskip("torch")

import torch_group_services_cases as S  # noqa: E402
from test_torch_group import assert_same, leaves  # noqa: E402
from torch_parity import run_jax_4way  # noqa: E402
from repro_torch.core import HPTMTContext  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402

LAYOUTS = [(4, 4), (2, 4), (1, 4)]
TIMEOUT_S = 180
CPU4 = HPTMTContext(n_shards=4, device="cpu")
SPILL = ["join_inner", "join_left", "join_outer", "groupby", "window",
         "stats_join", "stats_groupby", "stats_window", "skew", "from_spill",
         "auto_budget", "auto_overflow"]
PLAN = ["chain", "gbob", "scan", "tset_lazy"]
STAGES = ["committed", "rerun", "retried"]
#: spilled cases: no exchange, and each shard's sorts on its own rank
SPILLED = ["join_inner", "join_left", "join_outer", "groupby", "window",
           "stats_join", "stats_groupby", "stats_window", "skew",
           "auto_budget"]


@pytest.fixture(scope="module")
def scan_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scan") / "left")
    S.write_scan_dataset(path)
    return path


@pytest.fixture(scope="module")
def virtual(scan_path, tmp_path_factory):
    return S.services_cases(CPU4, str(tmp_path_factory.mktemp("virtual")),
                            scan_path)


@pytest.fixture(scope="module", params=LAYOUTS,
                ids=[f"world{w}-shards{n}" for w, n in LAYOUTS])
def group(request, scan_path, tmp_path_factory):
    world, n_shards = request.param
    root = str(tmp_path_factory.mktemp(f"world{world}"))
    return run_ranks(S.services_cases, world, "gloo", "cpu",
                     n_shards=n_shards, args=(root, scan_path),
                     timeout_s=TIMEOUT_S)


def _same_tree(got, want, what):
    got, want = leaves(got), leaves(want)
    assert sorted(got) == sorted(want), what
    for path, leaf in want.items():
        assert_same(got[path], leaf, f"{what}{path}")


# ---------------------------------------------------------------------------
# every rank against the virtual run
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", SPILL)
def test_spill_case_bit_identical_to_virtual(group, virtual, case):
    for r in group:
        _same_tree(r["results"]["spill"][case],
                   virtual["results"]["spill"][case],
                   f"rank {r['rank']} {case}")


@pytest.mark.parametrize("case", PLAN)
def test_planned_case_bit_identical_to_virtual(group, virtual, case):
    for r in group:
        _same_tree(r["results"]["plan"][case],
                   virtual["results"]["plan"][case],
                   f"rank {r['rank']} {case}")


@pytest.mark.parametrize("case", STAGES)
def test_stage_case_bit_identical_to_virtual(group, virtual, case):
    for r in group:
        _same_tree(r["results"]["stages"][case],
                   virtual["results"]["stages"][case],
                   f"rank {r['rank']} {case}")


def test_workflow_result_bit_identical_to_virtual(group, virtual):
    for r in group:
        _same_tree(r["results"]["workflow"], virtual["results"]["workflow"],
                   f"rank {r['rank']} workflow")


@pytest.mark.parametrize("area", ["spill", "plan", "stages", "workflow",
                                  "agree"])
def test_every_rank_reports_the_virtual_runs_facts(group, virtual, area):
    """SpillStats, the stores and workdirs, the explain text, fired
    rules, audits, q-errors and ledger, the stage files, retries, the
    journal and the stale-journal refusal: the virtual run's on every
    rank."""
    for r in group:
        _same_tree(r["every"][area], virtual["every"][area],
                   f"rank {r['rank']} {area}")


def test_every_rank_exchanges_like_the_virtual_run(group, virtual):
    want = virtual["counts"]
    for r in group:
        assert {k: v[0] for k, v in r["counts"].items()} == \
            {k: v[0] for k, v in want.items()}, r["rank"]
    for case in SPILLED:
        assert want[case][0] == 0, case
        assert sum(r["counts"][case][1] for r in group) == want[case][1], \
            case
    for r in group:
        assert r["counts"]["window"][1] == 0
        assert r["counts"]["stats_window"][1] == 0


def test_a_fault_on_one_rank_fired_once(group):
    """The run-write and the ``plan.step`` faults were armed on the last
    rank only and fired there once; every rank raised, and retried."""
    for site in ("spill.write", "plan.step"):
        assert [r["fires"][site] for r in group] == \
            [0] * (len(group) - 1) + [1], site


def test_a_fatal_error_on_any_rank_stops_every_rank(group, virtual):
    """A fatal error on the last rank while rank 0's is transient, or a
    fatal error on rank 0 that does not pickle: one attempt on every
    rank, and each raises its own error, or else the fatal one."""
    assert virtual["agree"] == {
        "fatal_beside_transient": (1, "FatalInjectedFault"),
        "unpicklable_fatal": (1, "ValueError")}
    for r in group:
        first = r["rank"] == 0 and len(group) > 1
        assert r["agree"] == {
            "fatal_beside_transient": (
                1, "InjectedFault" if first else "FatalInjectedFault"),
            "unpicklable_fatal": (
                1, "RuntimeError" if r["rank"] else "ValueError")}, \
            r["rank"]


# ---------------------------------------------------------------------------
# what the virtual run shows (and so every rank)
# ---------------------------------------------------------------------------
def test_spill_facts(virtual):
    ev = virtual["every"]["spill"]
    st = ev["skew"]
    assert st["refined"] >= 1 and st["oversized"] >= 1
    for name in ("stats_join", "stats_groupby", "stats_window", "skew"):
        assert ev[name]["pairs"] > 1 and ev[name]["bytes_spilled"] > 0, name
        assert ev[f"{name}_tmp"] == [] and ev[f"{name}_removed"], name
    assert all(v for k, v in ev.items() if k.startswith("kept_"))
    assert ev["fault"] == ("SpillWriteError", True)
    assert ev["auto_budget_recovered"] == [("spill.groupby", S.NL)]
    assert ev["auto_overflow_recovered"] == [("spill.join", S.NL + S.NR)]
    assert ev["from_spill_report"] == [("spill.groupby", S.NL)]


def test_planner_facts(virtual):
    ev, counts = virtual["every"]["plan"], virtual["counts"]
    for name, want in (("chain", (4, 2)), ("gbob", (2, 1)),
                       ("scan", (3, 2))):
        assert (counts[f"{name}_eager"][0], counts[f"{name}_planned"][0],
                ev[f"{name}_predicted"]) == want + (want[1],), name
        audit = ev[f"{name}_audit"]
        assert audit["consistent"] and audit["observed_a2a"] == want[1]
        assert audit["observed_bytes"] > 0
    assert ev["scan_rules"]          # the filter reaches the scan
    assert len(ev["ledger"]) == 3
    assert [r["observed_a2a"] for r in ev["ledger"]] == [2, 1, 2]


def test_stage_and_workflow_facts(virtual):
    ev, counts = virtual["every"]["stages"], virtual["counts"]
    assert len(ev["stages"]) == 2
    assert len(ev["stage_files"]) == 2
    for files in ev["stage_files"].values():
        assert sorted(files) == ["data.hpt", "meta.json"]
    assert counts["rerun"][0] == 0 and ev["retries"] == 1
    assert counts["retried"] == counts["committed"]
    wf = virtual["every"]["workflow"]
    assert wf["calls"] == {"scan": 2, "join_groupby": 1, "check": 1}
    assert wf["retries"] == 1 and wf["replayed"] == 3
    assert wf["resumed_calls"] == wf["calls"] and wf["stale"] is True
    ag = virtual["every"]["agree"]
    assert ag["transient_together"] == (2, "done")
    assert ag["empty_window"] == ("ValueError", True)
    assert ag["kept_empty_window"]


def test_armed_names_unfired_plan_faults():
    """``faults.armed`` — what a planned run agrees on once, before its
    steps — sees an armed fault until it fires."""
    from repro_torch.resilience import faults

    faults.reset()
    try:
        assert not faults.armed("plan.step.")
        faults.arm("plan.step.3", "io_error")
        assert faults.armed("plan.step.") and not faults.armed("scan.")
        with pytest.raises(OSError):
            faults.fire("plan.step.3")
        assert not faults.armed("plan.step.")
    finally:
        faults.reset()


# ---------------------------------------------------------------------------
# kill and resume, on 4 ranks and on 2
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def resumed(scan_path, tmp_path_factory):
    root = tmp_path_factory.mktemp("resume")
    crashed = str(root / "crashed")
    with pytest.raises(RuntimeError, match="died with exit code -9"):
        run_ranks(S.crash_rank, 4, "gloo", "cpu", args=(scan_path, crashed),
                  timeout_s=TIMEOUT_S)
    listing = {fp: sorted(os.listdir(os.path.join(crashed, fp)))
               for fp in os.listdir(crashed)}
    out = {"listing": listing,
           "virtual": S.resume_rank(CPU4, scan_path, S.copy_tree(
               crashed, str(root / "virtual")))}
    for world in (4, 2):
        out[world] = run_ranks(
            S.resume_rank, world, "gloo", "cpu", n_shards=4,
            args=(scan_path, S.copy_tree(crashed, str(root / f"r{world}"))),
            timeout_s=TIMEOUT_S)
    return out


def test_the_kill_leaves_one_committed_stage(resumed, virtual):
    (fp, names), = resumed["listing"].items()
    first, second = virtual["every"]["stages"]["stages"]
    assert names == [f"stage_{first}", f"stage_{second}.tmp"]
    assert f"{fp}/stage_{first}" in virtual["every"]["stages"]["stage_files"]


@pytest.mark.parametrize("world", [4, 2])
def test_resume_reruns_only_the_suffix(resumed, virtual, world):
    want = resumed["virtual"]
    assert want["counts"][0] == 1 and want["restored"] == 1
    for r in resumed[world]:
        assert r["counts"][0] == 1, r["rank"]
        assert (r["restored"], r["resumed_from"]) == (
            want["restored"], want["resumed_from"])


@pytest.mark.parametrize("world", [4, 2])
def test_resumed_rows_and_files_are_the_virtual_runs(resumed, virtual,
                                                     world):
    """The resumed rows are the uncrashed run's, and the stage files after
    the resume those the virtual run committed, byte for byte."""
    want = virtual["results"]["stages"]["committed"]
    _same_tree(resumed["virtual"]["result"], want, "virtual resume")
    for r in resumed[world]:
        _same_tree(r["result"], want, f"rank {r['rank']} of {world}")
        assert r["files"] == virtual["every"]["stages"]["stage_files"]


# ---------------------------------------------------------------------------
# the spilled join against the JAX package on 4 devices
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax4():
    inputs = {f"l/{k}": v for k, v in S.LEFT.items()}
    inputs.update({f"r/{k}": v for k, v in S.RIGHT.items()})
    return run_jax_4way(f"""
        from repro.dataframe.frame import DataFrame
        from repro.spill import spill_join

        def frame(prefix):
            d = {{k.split("/", 1)[1]: v for k, v in inp.items()
                  if k.startswith(prefix + "/")}}
            rows = len(next(iter(d.values())))
            return DataFrame.from_dict(d, ctx,
                                       capacity=2 * -(-rows // ctx.n_shards))

        # the output runs in collect()'s order (partition, then shard),
        # read from the store
        with spill_join(frame("l").table, frame("r").table, ("k",), ctx=ctx,
                        budget_rows={S.BUDGET}, how="outer") as res:
            st = res.store
            pieces = [st.read_partition("out", q, s)[0]
                      for q in st.partitions("out") for s in range(4)
                      if st.rows("out", q, s)]
            for k in pieces[0]:
                out["join/" + k] = np.concatenate([p[k] for p in pieces])
            for k, v in vars(res.stats).items():
                out["stats/" + k] = np.asarray(v)
    """, inputs)


def test_spilled_join_on_the_group_is_the_jax_packages(group, jax4):
    """The group's outer spilled join: the JAX package's rows in its order
    (sums bit for bit: a join adds nothing), and its ``SpillStats``."""
    want = {k[len("join/"):]: v for k, v in jax4.items()
            if k.startswith("join/")}
    stats = {k[len("stats/"):]: int(v) for k, v in jax4.items()
             if k.startswith("stats/")}
    for r in group:
        got = r["results"]["spill"]["stats_join"]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert_same(got[k], v, f"rank {r['rank']} {k}")
        st = dict(r["every"]["spill"]["stats_join"])
        assert {k: st[k] for k in stats} == stats


# ---------------------------------------------------------------------------
# the port no longer refuses these services on a group
# ---------------------------------------------------------------------------
def test_no_port_module_refuses_the_services_on_a_group():
    src = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    named = [str(p.relative_to(src)) for p in sorted(src.rglob("*.py"))
             if "11c, part c" in p.read_text()]
    assert named == []
