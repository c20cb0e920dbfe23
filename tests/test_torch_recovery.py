"""The port's recovery services against the JAX package: model
checkpoints (``repro_torch.checkpoint``), lineage stage checkpoints
(``repro_torch.resilience.stages`` + ``collect(policy=...)``) and the
workflow engine (``repro_torch.workflow``), after the reference's
``tests/test_resilience.py`` and ``tests/test_checkpoint_workflow.py``.

  * checkpoints — the files either package writes are byte-identical
    (float32, int32 and bfloat16 leaves), each restores the other's, CRC
    and dtype drift raise, async saves; the reference's own restore of a
    bfloat16 leaf raises on jax 0.9.0 (ROADMAP Queue 3), the port's does
    not;
  * stages — ``plan_fingerprint`` equal to JAX's on plans without
    callables, each stage's ``data.hpt`` / ``meta.json`` byte-identical
    to JAX's, torn commits swept, a real SIGKILL mid-commit in a child
    process then a bit-exact resume, and suffix-only re-execution on 4
    shards counted at the exchange choke point (0 when every stage is
    committed);
  * workflow — DAG order, retries through the policy, fatal fails fast,
    journal resume (journals byte-identical to JAX's), a stale DAG
    refused, the legacy bool journal, spans and counters, the straggler
    monitor.
"""
import filecmp
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.core import local_context  # noqa: E402
from repro.dataframe.frame import DataFrame as JDataFrame  # noqa: E402
from repro.io.scan import pred as jpred  # noqa: E402
from repro.plan.frame import LazyFrame as JLazyFrame  # noqa: E402
from repro.plan.rules import optimize as joptimize  # noqa: E402
from repro.resilience import (StageCheckpointer as JStages,  # noqa: E402
                              plan_fingerprint as jfingerprint)
from repro.workflow.engine import (Task as JTask,  # noqa: E402
                                   WorkflowEngine as JEngine)
from repro_torch import telemetry  # noqa: E402
from repro_torch.checkpoint import (CheckpointIntegrityError,  # noqa: E402
                                    CheckpointManager)
from repro_torch.core import HPTMTContext, array_ops  # noqa: E402
from repro_torch.dataframe import DataFrame  # noqa: E402
from repro_torch.io import pred, write_dataset  # noqa: E402
from repro_torch.plan import LazyFrame, optimize  # noqa: E402
from repro_torch.plan.physical import PhysicalPlan  # noqa: E402
from repro_torch.resilience import (FaultPolicy, InjectedFault,  # noqa: E402
                                    StageCheckpointer, arm, fires,
                                    plan_fingerprint, reset, stage_hook)
from repro_torch.workflow import (StragglerMonitor, Stopwatch, Task,  # noqa: E402
                                  WorkflowEngine, WorkflowError)

CPU1 = HPTMTContext(n_shards=1, device="cpu")
CPU4 = HPTMTContext(n_shards=4, device="cpu")
JCTX = local_context()
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


@pytest.fixture(autouse=True)
def _clean_faults():
    reset()
    yield
    reset()


def _dirs_identical(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)), (names, sorted(os.listdir(b)))
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if os.path.isdir(pa):
            _dirs_identical(pa, pb)
        else:
            assert filecmp.cmp(pa, pb, shallow=False), n


# ---------------------------------------------------------------------------
# model checkpoints
# ---------------------------------------------------------------------------
def _trees(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    i = rng.integers(-50, 50, 7).astype(np.int32)
    h = rng.standard_normal(6).astype(np.float32)
    port = {"layers": [{"w": torch.from_numpy(w)},
                       {"i": torch.from_numpy(i)}],
            "emb": torch.from_numpy(h).to(torch.bfloat16)}
    ref = {"layers": [{"w": jnp.asarray(w)}, {"i": jnp.asarray(i)}],
           "emb": jnp.asarray(h).astype(jnp.bfloat16)}
    return port, ref


def _assert_tree_equal(got, want):
    for k in ("w", "i"):
        layer = 0 if k == "w" else 1
        a = got["layers"][layer][k]
        b = want["layers"][layer][k]
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert got["emb"].dtype == torch.bfloat16
    assert torch.equal(got["emb"].view(torch.int16),
                       want["emb"].view(torch.int16))


def test_checkpoints_cross_read_both_ways(tmp_path):
    port, ref = _trees()
    CheckpointManager(str(tmp_path / "t")).save(3, port)
    JManager(str(tmp_path / "j")).save(3, ref)
    # byte for byte the same files: every leaf, the manifest, LATEST
    _dirs_identical(str(tmp_path / "t"), str(tmp_path / "j"))
    man = json.load(open(tmp_path / "t" / "step_3" / "manifest.json"))
    assert [(e["name"], e["dtype"]) for e in man["leaves"]] == [
        ("emb", "bfloat16"), ("layers__0__w", "float32"),
        ("layers__1__i", "int32")]
    # the port restores the reference's checkpoint, bfloat16 included
    tmpl = {"layers": [{"w": torch.zeros(3, 5)},
                       {"i": torch.zeros(7, dtype=torch.int32)}],
            "emb": torch.zeros(6, dtype=torch.bfloat16)}
    _assert_tree_equal(CheckpointManager(str(tmp_path / "j")).restore(
        tmpl, device="cpu"), port)
    # the reference restores the port's float32 and int32 leaves; its
    # bfloat16 restore raises on its own files and on the port's alike
    jtmpl = {"layers": [{"w": jnp.zeros((3, 5))},
                        {"i": jnp.zeros(7, jnp.int32)}]}
    for d in ("t", "j"):
        jm = JManager(str(tmp_path / d))
        for name, leaf in (("w", ref["layers"][0]["w"]),
                           ("i", ref["layers"][1]["i"])):
            arr = np.load(tmp_path / d / "step_3" /
                          f"layers__{0 if name == 'w' else 1}__{name}.npy")
            np.testing.assert_array_equal(arr, np.asarray(leaf))
        with pytest.raises(ValueError, match="cast"):
            jm.restore({"emb": jnp.zeros(6, jnp.bfloat16), **jtmpl})


def test_leaf_names_are_the_references():
    import collections

    from repro.checkpoint.manager import _leaf_paths as jleaf_paths
    from repro_torch.checkpoint.manager import _leaf_paths

    for tree in (collections.OrderedDict([("b", 1), ("a", 2)]),
                 {"b": 1, "a": {"z": 3, "c": [4, None, (5, 6)]}},
                 [1, (2,)], 7):
        assert _leaf_paths(tree)[0] == jleaf_paths(tree)[0], tree
    names, leaves, rebuild = _leaf_paths({"b": [1, None], "a": 2})
    assert rebuild([10, 20]) == {"a": 10, "b": [20, None]}


def test_services_import_neither_jax_nor_reference():
    code = ("import sys\n"
            "import repro_torch.telemetry, repro_torch.checkpoint\n"
            "import repro_torch.workflow, repro_torch.resilience.stages\n"
            "import repro_torch.core.dataflow, repro_torch.plan\n"
            "bad = [m for m in sys.modules if m == 'jax' or\n"
            "       m.startswith(('jax.', 'jaxlib', 'ml_dtypes')) or\n"
            "       m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "print('CLEAN')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0 and "CLEAN" in r.stdout, r.stderr[-2000:]


def test_checkpoint_crc_and_dtype_drift_raise(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"w": torch.arange(8, dtype=torch.float32), "b": torch.ones(3)}
    mgr.save(1, tree)
    man = json.load(open(tmp_path / "step_1" / "manifest.json"))
    assert all("crc32" in leaf for leaf in man["leaves"])
    ok = mgr.restore({k: torch.zeros_like(v) for k, v in tree.items()},
                     device="cpu")
    assert torch.equal(ok["w"], tree["w"])
    with pytest.raises(CheckpointIntegrityError, match="dtype"):
        mgr.restore({"w": torch.zeros(8, dtype=torch.int32),
                     "b": torch.ones(3)}, device="cpu")
    with pytest.raises(CheckpointIntegrityError, match="shape"):
        mgr.restore({"w": torch.zeros(9), "b": torch.ones(3)}, device="cpu")
    leaf = tmp_path / "step_1" / "w.npy"
    raw = bytearray(leaf.read_bytes())
    raw[-1] ^= 0xFF
    leaf.write_bytes(bytes(raw))
    with pytest.raises(CheckpointIntegrityError, match="CRC mismatch"):
        mgr.restore({k: torch.zeros_like(v) for k, v in tree.items()},
                    device="cpu")
    assert issubclass(CheckpointIntegrityError, ValueError)


def test_checkpoint_async_latest_and_state_dict(tmp_path):
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.ReLU(),
                                torch.nn.Linear(3, 2))
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, model.state_dict())
    with torch.no_grad():  # the host copy was taken before save returned
        for p in model.parameters():
            p.add_(1.0)
    mgr.save(2, model.state_dict())
    mgr.wait()
    assert mgr.latest_step() == 2
    got = mgr.restore(model.state_dict(), device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(got[k], v), k
    first = mgr.restore(model.state_dict(), step=1, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(first[k] + 1.0, v), k
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({}, device="cpu")


# ---------------------------------------------------------------------------
# lineage stage checkpoints
# ---------------------------------------------------------------------------
def _dataset(tmp_path, n=64, name="ds"):
    rng = np.random.default_rng(3)
    cols = {"a": np.arange(n, dtype=np.float32),
            "b": (np.arange(n) % 8).astype(np.float32),
            "c": rng.normal(size=n).astype(np.float32)}
    root = str(tmp_path / name)
    write_dataset(root, [(cols, n)], format="hpt", rows_per_group=8)
    return root


def _pipeline(L, P, path, ctx, aggs=(("c", "sum"), ("c", "count")),
              by="b"):
    return (L.read_parquet(path, ctx)
            .filter([P("a", "<", 48.0)])
            .groupby(["b"], list(aggs))
            .sort_values(by))


def test_plan_fingerprint_equals_jax_without_callables(tmp_path):
    path = _dataset(tmp_path)
    r1, _ = optimize(_pipeline(LazyFrame, pred, path, CPU1).logical_plan)
    r2, _ = optimize(_pipeline(LazyFrame, pred, path, CPU1).logical_plan)
    fp = plan_fingerprint(r1, CPU1)
    assert fp == plan_fingerprint(r2, CPU1)
    jr, _ = joptimize(_pipeline(JLazyFrame, jpred, path, JCTX).logical_plan)
    assert fp == jfingerprint(jr, JCTX)
    # a source table's canonical form reads the same blocks in both
    data = {"k": np.arange(10, dtype=np.float32)}
    lf = DataFrame.from_dict(data, CPU1).lazy().groupby(["k"],
                                                        [("k", "count")])
    jlf = JDataFrame.from_dict(data, JCTX).lazy().groupby(["k"],
                                                          [("k", "count")])
    assert plan_fingerprint(optimize(lf.logical_plan)[0], CPU1) == \
        jfingerprint(joptimize(jlf.logical_plan)[0], JCTX)
    other = (LazyFrame.read_parquet(path, CPU1)
             .filter([pred("a", "<", 32.0)])
             .groupby(["b"], [("c", "sum"), ("c", "count")])
             .sort_values("b"))
    assert plan_fingerprint(optimize(other.logical_plan)[0], CPU1) != fp
    assert plan_fingerprint(r1, CPU4) != fp  # the shard count is identity
    # a callable canonicalizes as module.qualname, so one the packages
    # define (a predicate's bound mask) fingerprints apart
    cl = DataFrame.from_dict(data, CPU1).lazy().filter(
        pred("k", "<", 5.0).mask)
    jcl = JDataFrame.from_dict(data, JCTX).lazy().filter(
        jpred("k", "<", 5.0).mask)
    assert plan_fingerprint(optimize(cl.logical_plan)[0], CPU1) != \
        jfingerprint(joptimize(jcl.logical_plan)[0], JCTX)


def test_stage_files_byte_identical_to_jax(tmp_path):
    path = _dataset(tmp_path)
    aggs = (("c", "count"), ("c", "min"), ("c", "max"))
    pol = FaultPolicy(checkpoint_dir=str(tmp_path / "t"),
                      keep_checkpoints=True)
    # sorting by a value (not the group key) makes a second stage
    got = _pipeline(LazyFrame, pred, path, CPU1, aggs, "c_max").collect(
        policy=pol).to_numpy()
    # the reference's stage hook never commits on jax 0.9.0 (its
    # tracing() is always True, ROADMAP Queue 3), so its plan runs here
    # with a hook that commits every stage through its own writer
    from repro.plan.physical import PhysicalPlan as JPhysicalPlan

    jlf = _pipeline(JLazyFrame, jpred, path, JCTX, aggs, "c_max")
    jroot, _ = joptimize(jlf.logical_plan)
    jck = JStages(str(tmp_path / "j"), jfingerprint(jroot, JCTX))
    jp = JPhysicalPlan(jroot, JCTX)

    def commit_all(step, layout, thunk):
        out, ovs = thunk()
        jck.commit(step.index, out, ovs, op=step.op)
        return out, ovs

    jp.stage_hook = commit_all
    want = jp.fn(*jp.inputs())[0].to_numpy()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    [fp] = os.listdir(tmp_path / "t")
    assert os.listdir(tmp_path / "j") == [fp]
    stages = sorted(os.listdir(tmp_path / "t" / fp))
    assert len(stages) >= 2, stages
    _dirs_identical(str(tmp_path / "t"), str(tmp_path / "j"))
    # and a table committed directly, on 4 shards: the port's blocks
    # flatten to the reference's global arrays
    data = {"k": np.arange(10, dtype=np.float32),
            "v": np.ones(10, dtype=np.int32)}
    StageCheckpointer(str(tmp_path / "t4"), "fp").commit(
        2, DataFrame.from_dict(data, CPU4).table, [("plan.x", 3)],
        op="groupby")
    JStages(str(tmp_path / "j4"), "fp").commit(
        2, JDataFrame.from_dict(data, JCTX).table, [("plan.x", 3)],
        op="groupby")
    for f in ("data.hpt", "meta.json"):  # the 1-device JAX table's rows
        assert os.path.exists(tmp_path / "j4" / "fp" / "stage_2" / f)
    dt, ovs = StageCheckpointer(str(tmp_path / "t4"), "fp").restore(2, CPU4)
    assert ovs == [("plan.x", 3)]
    np.testing.assert_array_equal(dt.to_numpy()["k"], data["k"])


def test_stage_checkpointer_roundtrip_and_torn_commit_sweep(tmp_path):
    df = DataFrame.from_dict({"k": np.arange(6, dtype=np.float32),
                              "v": np.ones(6, dtype=np.float32)}, CPU4)
    ck = StageCheckpointer(str(tmp_path), "fp0")
    ck.commit(2, df.table, [("plan.x", 3)], op="groupby")
    assert ck.committed_stages() == [2]
    dt, ovs = ck.restore(2, CPU4)
    assert ovs == [("plan.x", 3)]
    for k in df.table.column_names:
        assert torch.equal(df.table.columns[k], dt.columns[k])
    assert torch.equal(df.table.counts, dt.counts)
    os.makedirs(tmp_path / "fp0" / "stage_5.tmp")
    ck2 = StageCheckpointer(str(tmp_path), "fp0")
    assert ck2.committed_stages() == [2]
    assert not os.path.exists(tmp_path / "fp0" / "stage_5.tmp")
    # a failed commit (before the rename) leaves nothing half-visible
    arm("checkpoint.commit", "io_error", nth=1)
    with pytest.raises(InjectedFault):
        ck2.commit(0, df.table, [])
    assert ck2.committed_stages() == [2]
    ck2.commit(0, df.table, [])
    assert ck2.committed_stages() == [0, 2]


def test_resilient_collect_bit_exact_and_resumes(tmp_path):
    path = _dataset(tmp_path)
    oracle = _pipeline(LazyFrame, pred, path, CPU1).collect(
        strict=False).to_numpy()
    pol = FaultPolicy(max_retries=1, checkpoint_dir=str(tmp_path / "st"),
                      keep_checkpoints=True)
    rec = telemetry.Collector("c1")
    got = _pipeline(LazyFrame, pred, path, CPU1).collect(
        strict=False, policy=pol, telemetry=rec).to_numpy()
    for k, v in oracle.items():
        np.testing.assert_array_equal(v, got[k], err_msg=k)
    assert rec.metrics.counters["recovery.stages_committed"] >= 1
    rec2 = telemetry.Collector("c2")
    got2 = _pipeline(LazyFrame, pred, path, CPU1).collect(
        strict=False, policy=pol, telemetry=rec2).to_numpy()
    for k, v in oracle.items():
        np.testing.assert_array_equal(v, got2[k], err_msg=k)
    assert rec2.metrics.counters["recovery.stages_restored"] >= 1
    assert "recovery.resumed_from_stage" in rec2.metrics.gauges
    spans = [s.name for s in rec2.all_spans()]
    assert "recovery.restore" in spans and "recovery.collect" in spans


def test_collect_without_policy_adds_nothing_and_cleans_up(tmp_path):
    import tempfile

    path = _dataset(tmp_path)
    before = {d for d in os.listdir(tempfile.gettempdir())
              if d.startswith("hptmt-stages-")}
    lf = _pipeline(LazyFrame, pred, path, CPU1)
    assert lf.physical_plan().stage_hook is None
    lf.collect(strict=False)
    assert {d for d in os.listdir(tempfile.gettempdir())
            if d.startswith("hptmt-stages-")} == before
    assert fires() == 0
    ckdir = str(tmp_path / "stages")
    lf.collect(strict=False, policy=FaultPolicy(checkpoint_dir=ckdir))
    assert os.listdir(ckdir) == []             # removed after success


_CHILD = """
    import os, sys, zlib
    import numpy as np
    from repro_torch import telemetry as T
    from repro_torch.core import HPTMTContext
    from repro_torch.io import pred, write_dataset
    from repro_torch.plan import LazyFrame
    from repro_torch.resilience import FaultPolicy

    root, ckdir, mode = sys.argv[1], sys.argv[2], sys.argv[3]
    ds = os.path.join(root, "ds")
    if not os.path.exists(ds):
        rng = np.random.default_rng(5)
        n = 96
        cols = {"k": (np.arange(n) % 12).astype(np.float32),
                "u": np.arange(n, dtype=np.float32),
                "v": rng.normal(size=n).astype(np.float32)}
        write_dataset(ds, [(cols, n)], format="hpt", rows_per_group=12)
    ctx = HPTMTContext(n_shards=1, device="cpu")
    lf = (LazyFrame.read_parquet(ds, ctx)
          .filter([pred("u", "<", 72.0)])
          .groupby(["k"], [("v", "sum"), ("v", "count")])
          .sort_values("v_sum"))  # non-key order: a second exchange stage
    if mode == "plain":
        out = lf.collect(strict=False)
    else:
        rec = T.Collector("child")
        pol = FaultPolicy(max_retries=1, checkpoint_dir=ckdir,
                          keep_checkpoints=True)
        out = lf.collect(strict=False, policy=pol, telemetry=rec)
        print("RESTORED", rec.metrics.counters.get(
            "recovery.stages_restored", 0))
    d = out.to_numpy()
    crc = 0
    for k in sorted(d):
        crc = zlib.crc32(np.ascontiguousarray(d[k]).tobytes(), crc)
    print("CRC", f"{crc:08x}")
"""


def _run_child(tmp_path, mode, extra_env=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("HPTMT_FAULTS", None)
    env.update(extra_env or {})
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_CHILD),
         str(tmp_path), str(tmp_path / "stages"), mode],
        capture_output=True, text=True, timeout=300, env=env)


def test_sigkill_during_commit_then_resume_bit_exact(tmp_path):
    oracle = _run_child(tmp_path, "plain")
    assert oracle.returncode == 0, oracle.stderr[-2000:]
    [ocrc] = [ln for ln in oracle.stdout.splitlines() if ln.startswith("CRC")]
    # SIGKILL at the SECOND commit fire: the first stage lands durably,
    # the second dies between its snapshot and its rename
    r1 = _run_child(tmp_path, "resilient",
                    {"HPTMT_FAULTS": "checkpoint.commit:crash:2"})
    assert r1.returncode == -9, (r1.returncode, r1.stderr[-2000:])
    [fp] = os.listdir(tmp_path / "stages")
    names = os.listdir(tmp_path / "stages" / fp)
    assert [n for n in names if n.endswith(".tmp")], names  # torn commit
    assert [n for n in names if not n.endswith(".tmp")], names
    r2 = _run_child(tmp_path, "resilient")
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert ocrc in r2.stdout, (ocrc, r2.stdout)   # bit-exact vs oracle
    assert "RESTORED 1" in r2.stdout
    assert not any(n.endswith(".tmp")
                   for n in os.listdir(tmp_path / "stages" / fp))


def test_suffix_only_reexecution_4shards(tmp_path):
    rng = np.random.default_rng(7)
    n = 128
    cols = {"k": (np.arange(n) % 16).astype(np.float32),
            "u": np.arange(n, dtype=np.float32),
            "v": rng.normal(size=n).astype(np.float32)}
    ds = str(tmp_path / "ds")
    write_dataset(ds, [(cols, n)], format="hpt", rows_per_group=16)
    ckdir = str(tmp_path / "stages")

    def build():
        return (LazyFrame.read_parquet(ds, CPU4)
                .groupby(["k"], [("v", "sum")]).sort_values("v_sum"))

    array_ops.EXCHANGES.reset()
    out1 = build().collect(strict=False, policy=FaultPolicy(
        checkpoint_dir=ckdir, keep_checkpoints=True)).to_numpy()
    n_fresh = array_ops.EXCHANGES.n
    root, _ = optimize(build().logical_plan)
    fresh = PhysicalPlan(root, CPU4)
    assert n_fresh == fresh.predicted_collectives == 2
    ck = StageCheckpointer(ckdir, plan_fingerprint(root, CPU4))
    committed = ck.committed_stages()
    assert len(committed) == 2, committed

    def resumed(stages):
        plan = PhysicalPlan(root, CPU4)
        plan.stage_hook = stage_hook(ck, ctx=CPU4, committed=set(stages))
        inputs = plan.inputs()
        array_ops.EXCHANGES.reset()
        out, _ = plan.fn(*inputs)
        return out, array_ops.EXCHANGES.n

    out, n_all = resumed(committed)
    assert n_all == 0, "every stage committed: nothing exchanges"
    for k, v in out1.items():
        np.testing.assert_array_equal(out.to_numpy()[k], v, err_msg=k)
    out, n_first = resumed(committed[:1])     # only the groupby restored
    assert n_first == 1, "only the orderby's exchange re-runs"
    for k, v in out1.items():
        np.testing.assert_array_equal(out.to_numpy()[k], v, err_msg=k)


# ---------------------------------------------------------------------------
# workflow engine
# ---------------------------------------------------------------------------
def _dag(E, T, calls):
    return (E().add(T("a", lambda: calls.append("a") or 1))
            .add(T("b", lambda a: calls.append("b") or a + 1, deps=("a",)))
            .add(T("c", lambda a, b: calls.append("c") or a + b,
                   deps=("a", "b"))))


def test_workflow_dag_order_matches_jax():
    calls, jcalls = [], []
    res = _dag(WorkflowEngine, Task, calls).run()
    jres = _dag(JEngine, JTask, jcalls).run()
    assert res == jres and res["c"] == 3
    assert calls == jcalls == ["a", "b", "c"]
    with pytest.raises(WorkflowError, match="cycle"):
        (WorkflowEngine().add(Task("x", lambda y: 1, deps=("y",)))
         .add(Task("y", lambda x: 1, deps=("x",))).run())


def test_workflow_retries_through_policy_and_fatal_fails_fast():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return 7

    wf = WorkflowEngine(policy=FaultPolicy(max_retries=3, backoff_base=0.0,
                                           backoff_max=0.0))
    with telemetry.trace("wf") as rec:
        assert wf.add(Task("t", flaky)).run()["t"] == 7
    assert calls["n"] == 3
    assert rec.metrics.counters["retry.workflow.t"] == 2
    assert rec.metrics.counters["workflow.retries"] == 2
    sp = next(s for s in rec.all_spans() if s.name == "workflow.t")
    assert sp.attrs["attempts"] == 3
    bad = {"n": 0}

    def bug():
        bad["n"] += 1
        raise ValueError("bug")

    with pytest.raises(WorkflowError, match="non-retryable ValueError"):
        WorkflowEngine().add(Task("t", bug, retries=5)).run()
    assert bad["n"] == 1
    with pytest.raises(WorkflowError, match="failed after 2 attempts"):
        WorkflowEngine().add(Task("dead", lambda: 1 / 0, retries=1)).run()


def test_workflow_journal_resume_stale_dag_and_legacy(tmp_path):
    j, jj = str(tmp_path / "journal.json"), str(tmp_path / "jjournal.json")
    calls = []
    wf = WorkflowEngine(j)
    wf.add(Task("a", lambda: calls.append("a"))).add(
        Task("b", lambda a: calls.append("b"), deps=("a",)))
    wf.run()
    JEngine(jj).add(JTask("a", lambda: 1)).add(
        JTask("b", lambda a: 2, deps=("a",))).run()
    assert filecmp.cmp(j, jj, shallow=False), "journals differ"
    # a restart skips journaled tasks (either package's journal)
    for path in (j, jj):
        with telemetry.trace("resume") as rec:
            assert (WorkflowEngine(path).add(Task("a", lambda: 99))
                    .add(Task("b", lambda a: 0, deps=("a",))).run()) == {}
        assert rec.metrics.counters["workflow.replayed"] == 2
        assert not any(s.name.startswith("workflow.")
                       for s in rec.all_spans())
    assert calls == ["a", "b"]
    with pytest.raises(WorkflowError, match="stale journal"):
        (WorkflowEngine(j).add(Task("a", lambda: 1))
         .add(Task("b", lambda: 2)).run())
    legacy = str(tmp_path / "legacy.json")
    with open(legacy, "w") as f:
        json.dump({"a": True}, f)
    assert WorkflowEngine(legacy).add(Task("a", lambda: 1 / 0)).run() == {}


def test_straggler_monitor_and_stopwatch():
    mon = StragglerMonitor(window=10, threshold=2.0)
    flags = [mon.record(t) for t in [1.0] * 6 + [5.0, 1.0, 2.5]]
    assert flags == [False] * 6 + [True, False, True]
    assert mon.flagged == [6, 8]
    with Stopwatch() as sw:
        pass
    assert sw.seconds >= 0.0
