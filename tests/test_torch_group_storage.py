"""Storage, the rest of TSet and the elastic checkpoint on a process group.

``tests/torch_group_storage_cases.py`` runs on ``gloo`` groups of CPU
ranks at ``(world, n_shards)`` = (4, 4), (2, 4) and (1, 4), one
``run_ranks`` call a layout, and is held bit for bit against the port's
virtual 4-shard run: the partitioned ``.hpt`` and parquet writes (files
and manifest byte for byte), the re-entry scans and their joins and
groupby (0 exchanges against a re-entered side, 1 against an
unpartitioned one), a write whose layout is proven (0 exchanges), the
unpartitioned write, pushdown, the chunked scan into a TSet, a strict and
a quarantining scan of a corrupt fragment (``ScanStats`` and the sidecar
the same on every rank), ``DistTable.from_shard_tables``, every TSet
method outside the data pipeline's, and the training data pipeline from
a corpus the ranks wrote to disk; every rank's exchange count equals the
virtual run's.

The checkpoint manager across ranks: the reference's elastic case
(``tests/test_distributed.py``: ``arange(32)`` as (8, 4), saved by 4
ranks on ``("data",)``, restored by 2), its files byte for byte the JAX
package's from 4 forced devices, the JAX package's checkpoint restored on
the port's ranks, an ``async_save`` that commits once every rank's files
are down, a corrupt leaf raising on every rank, and the reduced
smollm-360m mesh trainer saved on 2x2 and restored on 2x1 — each block
the saved leaf's, and the next float32-compute step's loss the 2x2
step's to 1e-6.
"""
from __future__ import annotations

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_group_storage_cases as S  # noqa: E402
from test_torch_group import assert_same, leaves  # noqa: E402
from torch_parity import run_jax_4way  # noqa: E402
from repro_torch.core import HPTMTContext  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.sharding import partition  # noqa: E402
from repro_torch.sharding.axes import GroupMesh  # noqa: E402

LAYOUTS = [(4, 4), (2, 4), (1, 4)]
TIMEOUT_S = 180
DATA_CASES = ([f"{c}_{fmt}" for fmt in S.FORMATS
               for c in ("files", "lp", "join0", "join1", "groupby0")]
              + ["files_proven", "files_plain", "plain", "pushdown",
                 "pushdown_stats", "scan_tset", "scan_tset_stats", "strict",
                 "quarantine", "quarantine_stats", "sidecar"])
TSET_CASES = ["map_columns", "groupby_g", "groupby_k", "join_groupby",
              "orderby", "union", "window", "topk", "from_chunks",
              "reduce_sum", "reduce_mean", "reduce_min", "reduce_max",
              "reduce_count", "quantile", "to_numpy", "report"]
CASES = ([f"data/{c}" for c in DATA_CASES]
         + [f"tset/{c}" for c in TSET_CASES]
         + ["shard_tables", "corpus"])
#: exchanges a rank, as the JAX package counts them on 4 devices
#: (``tests/test_torch_io.py``'s re-entry cases): one for a partitioned
#: write, none once the layout is proven or the input re-entered
ZERO = (["write_proven", "write_plain", "scan_tset"]
        + [f"{c}_{fmt}" for fmt in S.FORMATS
           for c in ("read", "join0", "groupby0")])
ONE = [f"{c}_{fmt}" for fmt in S.FORMATS for c in ("write", "join1")]


@pytest.fixture(scope="module")
def virtual(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("virtual"))
    return S.storage_cases(HPTMTContext(n_shards=4, device="cpu"), root)


@pytest.fixture(scope="module", params=LAYOUTS,
                ids=[f"world{w}-shards{n}" for w, n in LAYOUTS])
def group(request, tmp_path_factory):
    world, n_shards = request.param
    root = str(tmp_path_factory.mktemp(f"world{world}"))
    return run_ranks(S.storage_cases, world, "gloo", "cpu",
                     n_shards=n_shards, args=(root,), timeout_s=TIMEOUT_S)


def _case(res, case):
    for part in case.split("/"):
        res = res[part]
    return res


# ---------------------------------------------------------------------------
# storage and TSet on a group against the virtual run
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", CASES)
def test_case_bit_identical_to_virtual(group, virtual, case):
    got = leaves(_case(group[0]["results"], case))
    want = leaves(_case(virtual["results"], case))
    assert sorted(got) == sorted(want), case
    for path, leaf in want.items():
        assert_same(got[path], leaf, f"{case}{path}")


def test_every_rank_exchanges_like_the_virtual_run(group, virtual):
    want = virtual["exchanges"]
    for tag in ZERO:
        assert want[tag] == 0, tag
    for tag in ONE:
        assert want[tag] == 1, tag
    for r in group:
        assert r["exchanges"] == want, r["rank"]


def test_every_rank_reads_the_same_stats_files_and_stream(group, virtual):
    """``ScanStats``, the written files' digests, the strict scan's
    refusal and the curated stream: the virtual run's on every rank."""
    for r in group:
        for k, v in virtual["every"].items():
            assert r["every"][k] == v, (r["rank"], k)
        assert_same(r["stream"], virtual["stream"], f"rank {r['rank']}")
    assert virtual["every"]["strict"][1:] == (True, True)
    st = virtual["every"]["quarantine_stats"]
    assert st["fragments_quarantined"] == 1 and st["rows_quarantined"] > 0
    st = virtual["every"]["pushdown_stats"]
    assert 0 < st["row_groups_skipped"] < st["row_groups_total"]


def test_disk_corpus_stream_is_the_in_memory_one(virtual):
    """The corpus written to disk and curated from there gives the
    in-memory pipeline's stream on the same 4 virtual shards, bit for bit
    (so ``chip_smoke.py`` phase 29 holds its groups' disk stream to phase
    26's)."""
    from repro_torch.data import pipeline as TP

    ctx = HPTMTContext(n_shards=4, device="cpu")
    ccfg = TP.CorpusConfig(vocab_size=S.CORPUS_VOCAB)
    want = TP.preprocess(TP.synthetic_corpus(ccfg, ctx), ccfg, ctx)
    assert_same(virtual["stream"], want, "disk stream vs in memory")


def test_reentered_tables_carry_their_layout(group):
    res = group[0]["results"]["data"]
    for fmt in S.FORMATS:
        assert res[f"lp_{fmt}"]["part"] == repr((("k",), 4))
        assert res[f"join0_{fmt}"]["report"] == []
    assert res["plain"]["part"] == "None"


# ---------------------------------------------------------------------------
# the elastic checkpoint
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The saves: 4 ranks (sync and async), the JAX package on 4 devices,
    and one process; then the restores on 2 ranks."""
    root = str(tmp_path_factory.mktemp("ckpt"))
    d = {k: os.path.join(root, k) for k in
         ("sync", "async", "jax", "one", "corrupt")}
    out = {"dirs": d}
    out["sync"] = run_ranks(S.elastic_save, 4, "gloo", "cpu", dims=[4],
                            names=["data"], args=(d["sync"], False),
                            timeout_s=TIMEOUT_S)
    out["async"] = run_ranks(S.elastic_save, 4, "gloo", "cpu", dims=[4],
                             names=["data"], args=(d["async"], True),
                             timeout_s=TIMEOUT_S)
    run_jax_4way(f"""
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro.checkpoint.manager import CheckpointManager
        m4 = make_mesh((4,), ("data",))
        tree = {{"w": jax.device_put(inp["w"], NamedSharding(m4, P("data"))),
                 "m": jax.device_put(inp["m"],
                                     NamedSharding(m4, P(None, "data"))),
                 "b": jnp.asarray(inp["b"])}}
        assert len(tree["w"].sharding.device_set) == 4
        CheckpointManager({d["jax"]!r}).save(1, tree)
    """, S.ELASTIC)
    from repro_torch.checkpoint import CheckpointManager
    CheckpointManager(d["one"]).save(1, {k: torch.from_numpy(v)
                                         for k, v in S.ELASTIC.items()})
    for name in ("sync", "jax"):
        out[f"restore_{name}"] = run_ranks(
            S.elastic_restore, 2, "gloo", "cpu", dims=[2], names=["data"],
            args=(d[name],), timeout_s=TIMEOUT_S)
    return out


def _files(root):
    return S.file_digests(os.path.join(root, "step_1"))


def test_elastic_reshard_4_ranks_to_2(ckpt):
    """The reference's case: saved under a 4-way ``data`` mesh, each of 2
    ranks restores its block exactly."""
    for rank, r in enumerate(ckpt["restore_sync"]):
        assert r["coords"] == {"data": rank}
        mesh = GroupMesh({"data": 2}, {}, r["coords"])
        for k, v in S.ELASTIC.items():
            want = v if S.ELASTIC_SPECS[k] is None else v[
                partition.block_slices(v.shape, S.ELASTIC_SPECS[k], mesh)]
            assert r["blocks"][k].dtype == v.dtype
            np.testing.assert_array_equal(r["blocks"][k], want, err_msg=k)
    w = np.concatenate([r["blocks"]["w"] for r in ckpt["restore_sync"]])
    np.testing.assert_array_equal(w, S.ELASTIC["w"])


def test_group_checkpoint_files_are_the_jax_packages(ckpt):
    """4 ranks' files are the JAX package's from 4 forced devices, and one
    process's from the gathered tree, byte for byte."""
    d = ckpt["dirs"]
    want = _files(d["jax"])
    assert sorted(want) == ["b.npy", "m.npy", "manifest.json", "w.npy"]
    for r in ckpt["sync"]:
        assert r["files"] == want
        assert r["after"] == ["LATEST", "step_1"]
    assert _files(d["one"]) == want


def test_jax_checkpoint_restores_on_the_ports_ranks(ckpt):
    for a, b in zip(ckpt["restore_jax"], ckpt["restore_sync"]):
        for k in S.ELASTIC:
            np.testing.assert_array_equal(a["blocks"][k], b["blocks"][k])


def test_async_save_on_a_group_commits_once_after_every_rank(ckpt):
    """Nothing is committed before ``wait`` on any rank; after it, one
    step directory and ``LATEST``, with the sync save's files."""
    for r in ckpt["async"]:
        assert r["before_wait"] == ["step_1.tmp"], r
        assert r["after"] == ["LATEST", "step_1"]
        assert r["files"] == ckpt["sync"][0]["files"]
    with open(os.path.join(ckpt["dirs"]["async"], "LATEST")) as f:
        assert f.read() == "1"


def test_corrupt_leaf_raises_on_every_rank(ckpt, tmp_path):
    """A flipped byte in ``w.npy`` (checked by rank 0 only) raises
    ``CheckpointIntegrityError`` on both ranks, well within the
    timeout; a truncated ``m.npy`` too."""
    import shutil
    import time

    src = ckpt["dirs"]["sync"]
    for leaf, cut in (("w", False), ("m", True)):
        root = str(tmp_path / leaf)
        shutil.copytree(src, root)
        path = os.path.join(root, "step_1", f"{leaf}.npy")
        raw = bytearray(open(path, "rb").read())
        if cut:
            raw = raw[:-4]
        else:
            raw[-1] ^= 0x40
        open(path, "wb").write(bytes(raw))
        t0 = time.monotonic()
        got = run_ranks(S.elastic_restore, 2, "gloo", "cpu", dims=[2],
                        names=["data"], args=(root,), timeout_s=60)
        assert time.monotonic() - t0 < 60
        for r in got:
            kind, msg, integrity = r["error"]
            assert integrity, (kind, msg)
            assert f"checkpoint leaf {leaf}" in msg, msg


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train"))
    saved = run_ranks(S.train_save, 4, "gloo", "cpu", args=(root,),
                      timeout_s=TIMEOUT_S)
    restored = run_ranks(S.train_restore, 2, "gloo", "cpu", args=(root,),
                         timeout_s=TIMEOUT_S)
    return saved, restored


def test_trainer_state_saved_on_2x2_restores_on_2x1(trained):
    """Each restored block is ``shard_tensor`` of the saved leaf on the
    2x1 mesh, bit for bit."""
    saved, restored = trained
    whole = saved[0]["saved"]
    for r in restored:
        mesh = GroupMesh({"data": 2, "model": 1}, {}, r["coords"])
        assert sorted(r["blocks"]) == sorted(whole)
        for k, v in whole.items():
            want = partition.shard_tensor(torch.from_numpy(v),
                                          r["specs"][k], mesh).numpy()
            assert_same(r["blocks"][k], want, k)


def test_trainer_step_after_the_restore(trained):
    """The restored 2x1 state's float32-compute step on the next global
    batch: the uninterrupted 2x2 step's loss to 1e-6."""
    saved, restored = trained
    loss = saved[0]["loss_f32"]
    assert all(r["loss_f32"] == loss for r in saved)
    for r in restored:
        np.testing.assert_allclose(r["loss_f32"], loss, rtol=1e-6)
