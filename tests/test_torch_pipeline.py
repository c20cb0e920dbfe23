"""The port's table→tensor data pipeline (``repro_torch.data.pipeline``),
int8 gradient compression (``repro_torch.train.grad_compress``) and the
train loop against the JAX package's, and the pipeline → train → serve
workflow of ``tests/test_system.py``.

  * ``synthetic_corpus_arrays`` equal; ``preprocess``'s curated stream
    bit for bit on 1 shard (its 4-shard case runs in
    ``tests/test_torch_dataflow.py``'s one JAX subprocess); the disk
    corpus written with the port's ``io.write_dataset`` equal to the
    in-memory stream; ``batch_iterator`` and ``make_training_data``
    (with a stub frontend) batch for batch;
  * ``ef_allreduce_mean`` / ``tree_ef_allreduce`` on 4 virtual shards
    against JAX's under ``jax.vmap(axis_name="pod")``, with the
    exchange count;
  * ``train_loop`` killed and resumed (``tests/test_checkpoint_workflow.py``)
    and the end-to-end workflow, on the reduced smollm.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_parity  # noqa: E402,F401  (one intra-op thread)
from repro.core import local_context  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro.train import grad_compress as JG  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core import HPTMTContext, array_ops  # noqa: E402
from repro_torch.data import pipeline as TP  # noqa: E402
from repro_torch.io import write_dataset  # noqa: E402
from repro_torch.train import grad_compress as TG  # noqa: E402

CPU1 = HPTMTContext(n_shards=1, device="cpu")
CORPORA = {"seed3": dict(n_docs=32, mean_doc_len=48, vocab_size=128, seed=3),
           "wide": dict(n_docs=96, mean_doc_len=20, vocab_size=49152,
                        quality_threshold=0.5, seed=11)}


def jax_preprocess(ccfg, ctx):
    """The reference's ``preprocess`` with its TSet ``collect`` and its
    ``orderby`` each run as one jitted program (eager, 4-device
    shard_map took 100 s for the 32-document corpus).  The collect's
    overflow counts are traced there, so the report's adds are taken
    out of the program and returned beside the table."""
    import repro.core.dataflow as jflow
    from repro.core.report import OverflowReport

    real_collect, real_add = jflow.TSet.collect, OverflowReport.add
    real_ops = JP.table_ops
    seen = []

    def collect(self):
        def prog():
            counts = []
            OverflowReport.add = lambda rep, source, c: counts.append(c) \
                or rep
            try:
                return real_collect(self), counts
            finally:
                OverflowReport.add = real_add
        res, counts = jax.jit(prog)()
        seen.extend(int(c) for c in counts)
        return res

    class Ops:
        def __getattr__(self, name):
            return getattr(real_ops, name)

        @staticmethod
        def orderby(t, by, **kw):
            return jax.jit(lambda t: real_ops.orderby(t, by, **kw))(t)

    jflow.TSet.collect, JP.table_ops = collect, Ops()
    try:
        stream = JP.preprocess(JP.synthetic_corpus(ccfg, ctx), ccfg, ctx)
    finally:
        jflow.TSet.collect, JP.table_ops = real_collect, real_ops
    return stream, seen


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_synthetic_corpus_arrays_equal(name):
    ja = JP.synthetic_corpus_arrays(JP.CorpusConfig(**CORPORA[name]))
    ta = TP.synthetic_corpus_arrays(TP.CorpusConfig(**CORPORA[name]))
    assert sorted(ja) == sorted(ta)
    for t in ja:
        assert sorted(ja[t]) == sorted(ta[t])
        for k, v in ja[t].items():
            assert ta[t][k].dtype == v.dtype, (t, k)
            np.testing.assert_array_equal(ta[t][k], v, err_msg=f"{t}/{k}")


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_preprocess_1shard_matches_jax(name):
    jstream, counts = jax_preprocess(JP.CorpusConfig(**CORPORA[name]),
                                     local_context())
    assert not any(counts)
    ccfg = TP.CorpusConfig(**CORPORA[name])
    array_ops.EXCHANGES.reset()
    got = TP.preprocess(TP.synthetic_corpus(ccfg, CPU1), ccfg, CPU1)
    assert array_ops.EXCHANGES.n == 0
    assert got.dtype == jstream.dtype == np.int32
    np.testing.assert_array_equal(got, jstream)
    # the numpy oracle: the good documents' tokens in (doc, position) order
    arrays = TP.synthetic_corpus_arrays(ccfg)
    good = arrays["docs"]["quality"] >= ccfg.quality_threshold
    toks = arrays["tokens"]
    np.testing.assert_array_equal(got, toks["token"][good[toks["doc_id"]]])


@pytest.mark.parametrize("threshold", [None, 0.3])
def test_disk_corpus_equals_in_memory(tmp_path, threshold):
    """The corpus written as datasets (``scripts/make_dataset.py``'s
    layout, eight row groups a table) and scanned back — with the
    quality predicate pushed into the docs scan or not — curates the
    in-memory stream."""
    ccfg = TP.CorpusConfig(**CORPORA["seed3"])
    for name, cols in TP.synthetic_corpus_arrays(ccfg).items():
        n = next(iter(cols.values())).shape[0]
        write_dataset(os.path.join(tmp_path, name), [(cols, n)],
                      format="hpt", rows_per_group=max(n // 8, 1))
    disk = TP.preprocess(TP.disk_corpus(str(tmp_path), CPU1, threshold),
                         ccfg, CPU1)
    mem = TP.preprocess(TP.synthetic_corpus(ccfg, CPU1), ccfg, CPU1)
    np.testing.assert_array_equal(disk, mem)


def test_batch_iterator_matches_jax():
    stream = (np.arange(500) % 97).astype(np.int32)
    for length, seq in ((500, 16), (10, 24)):       # the second tiles
        jit_ = JP.batch_iterator(stream[:length], 3, seq, seed=5)
        tit = TP.batch_iterator(stream[:length], 3, seq, seed=5,
                                device="cpu")
        for _ in range(4):
            jb, tb = next(jit_), next(tit)
            for k in ("tokens", "labels"):
                assert tb[k].dtype == torch.int32
                np.testing.assert_array_equal(tb[k].numpy(),
                                              np.asarray(jb[k]))


@pytest.mark.parametrize("arch", ["smollm-360m", "internvl2-76b",
                                  "whisper-medium"])
def test_make_training_data_matches_jax(arch):
    from repro import configs as jconfigs
    jc = jconfigs.reduced_config(jconfigs.get_config(arch))
    tc = reduced_config(get_config(arch))
    kw = dict(n_docs=24, mean_doc_len=30, vocab_size=tc.vocab_size, seed=2)
    jdata = JP.make_training_data(jc, local_context(), 2, 12,
                                  JP.CorpusConfig(**kw))
    tdata = TP.make_training_data(tc, CPU1, 2, 12, TP.CorpusConfig(**kw))
    for _ in range(3):
        jb, tb = next(jdata), next(tdata)
        assert sorted(jb) == sorted(tb)
        assert ("frontend" in tb) == (arch != "smollm-360m")
        for k, v in jb.items():
            assert tb[k].dtype == {"frontend": torch.float32}.get(
                k, torch.int32), k
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(v),
                                          err_msg=k)


# ---------------------------------------------------------------------------
# int8 error-feedback compression on 4 shards
# ---------------------------------------------------------------------------
SHARDS = 4


def _grads(seed, shapes):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal((SHARDS,) + s) * 10 ** rng.uniform(
        -3, 1)).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("shape", [(37,), (8, 6), (3, 5, 7), ()])
def test_ef_allreduce_mean_matches_jax(shape):
    x = _grads(0, {"x": shape})["x"]
    err = _grads(1, {"e": shape})["e"] * 1e-3
    jr, je = jax.vmap(lambda a, b: JG.ef_allreduce_mean(a, b, "pod"),
                      axis_name="pod")(jnp.asarray(x), jnp.asarray(err))
    array_ops.EXCHANGES.reset()
    tr, te = TG.ef_allreduce_mean(torch.tensor(x), torch.tensor(err))
    assert array_ops.EXCHANGES.n == 1       # the int8 reduce-scatter
    assert tr.shape == x.shape and tr.dtype == torch.float32
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    # every shard holds the same mean, within the int8 rounding of it
    mean = (x + err).mean(axis=0)
    step = np.abs(mean).max() / 127 + np.abs(x + err).max() / 127
    assert np.abs(tr.numpy() - mean).max() <= 2 * step


def test_tree_ef_allreduce_matches_jax_over_steps():
    """Three steps of a two-leaf tree, the error state carried."""
    shapes = {"a": (16, 3), "b": (5,)}
    jerr = jax.tree.map(jnp.asarray, {k: np.zeros((SHARDS,) + s, np.float32)
                                      for k, s in shapes.items()})
    terr = TG.init_error_state({k: torch.zeros((SHARDS,) + s)
                                for k, s in shapes.items()})
    for step in range(3):
        g = _grads(10 + step, shapes)
        jout, jerr = jax.vmap(lambda a, b: JG.tree_ef_allreduce(a, b, "pod"),
                              axis_name="pod")(
            jax.tree.map(jnp.asarray, g), jerr)
        array_ops.EXCHANGES.reset()
        tout, terr = TG.tree_ef_allreduce(
            {k: torch.tensor(v) for k, v in g.items()}, terr)
        assert array_ops.EXCHANGES.n == len(shapes)
        for k in shapes:
            np.testing.assert_array_equal(tout[k].numpy(),
                                          np.asarray(jout[k]))
            np.testing.assert_array_equal(terr[k].numpy(),
                                          np.asarray(jerr[k]))


# ---------------------------------------------------------------------------
# the train loop and the workflow
# ---------------------------------------------------------------------------
def test_trainer_resume_from_checkpoint(tmp_path):
    """Kill-and-restart: the loop resumes from the last snapshot, and the
    resumed steps give an uninterrupted run's losses and, to 1e-6 of
    each leaf's largest magnitude, its state (a few leaves differ in
    the last bits)."""
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import TrainConfig
    from repro_torch.train.trainer import LoopConfig, train_loop

    cfg = reduced_config(get_config("smollm-360m"))
    tcfg = TrainConfig(optimizer=OptimizerConfig(warmup_steps=1,
                                                 total_steps=20))
    stream = (np.arange(500) % cfg.vocab_size).astype(np.int32)

    def run(total, root, data):
        logs = []
        loop = LoopConfig(total_steps=total, log_every=2, checkpoint_every=3,
                          checkpoint_dir=str(root))
        state = train_loop(cfg, tcfg, loop, data, log_fn=logs.append,
                           device="cpu")
        return state, logs, list(train_loop.last_history)

    data = TP.batch_iterator(stream, 2, 16, device="cpu")
    _, logs, hist = run(6, tmp_path / "a", data)
    assert any("step     0" in line for line in logs)
    assert sorted(os.listdir(tmp_path / "a")) == ["LATEST", "step_3",
                                                  "step_6"]
    # "crash" after step 6; resume to 8 with the batches that come next
    state, logs2, hist2 = run(8, tmp_path / "a", data)
    assert any("resumed from checkpoint step 6" in line for line in logs2)
    assert len(hist2) == 2 and int(state.opt.count) == 8
    # uninterrupted: the same 8 batches
    full_data = TP.batch_iterator(stream, 2, 16, device="cpu")
    full, _, full_hist = run(8, tmp_path / "b", full_data)
    np.testing.assert_allclose(hist + hist2, full_hist, rtol=1e-6)
    for tree, got in ((full.params, state.params), (full.opt.mu,
                                                    state.opt.mu),
                      (full.opt.nu, state.opt.nu)):
        for k, v in tree.items():
            err = float((v - got[k]).detach().abs().max())
            assert err <= 1e-6 * float(v.detach().abs().max()), k


def test_end_to_end_pipeline_train_serve(tmp_path):
    """tests/test_system.py's flagship case in the port: the table
    pipeline prepares batches, the loop trains, the engine serves the
    trained weights, under a journaled ``WorkflowEngine``."""
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import TrainConfig
    from repro_torch.train.trainer import LoopConfig, train_loop
    from repro_torch.workflow.engine import Task, WorkflowEngine

    cfg = reduced_config(get_config("smollm-360m"))
    tcfg = TrainConfig(optimizer=OptimizerConfig(
        learning_rate=3e-3, warmup_steps=2, total_steps=30))
    results = {}

    def prepare():
        return TP.make_training_data(
            cfg, CPU1, batch=4, seq_len=24,
            ccfg=TP.CorpusConfig(n_docs=32, mean_doc_len=48,
                                 vocab_size=cfg.vocab_size, seed=3))

    def train(prepare):
        loop = LoopConfig(total_steps=25, log_every=10, checkpoint_every=10,
                          checkpoint_dir=str(tmp_path / "ckpt"))
        state = train_loop(cfg, tcfg, loop, prepare, log_fn=lambda s: None,
                           device="cpu")
        results["history"] = train_loop.last_history
        return state

    def serve(train):
        model = LM.from_state_dict(cfg, train.params, "cpu")
        eng = Engine(model, ServeConfig(max_len=48))
        prompts = np.random.default_rng(0).integers(1, cfg.vocab_size,
                                                    (2, 8))
        return eng.generate(prompts, n_tokens=5)

    wf = WorkflowEngine(str(tmp_path / "journal.json"))
    wf.add(Task("prepare", prepare))
    wf.add(Task("train", train, deps=("prepare",)))
    wf.add(Task("serve", serve, deps=("train",)))
    out = wf.run()

    hist = results["history"]
    assert hist[-1] < hist[0], f"loss did not decrease: {hist[0]}→{hist[-1]}"
    gen = out["serve"]
    assert gen.shape == (2, 5)
    assert gen.dtype == np.int32
    assert np.all((gen >= 0) & (gen < cfg.vocab_size))
