"""The port's training (``repro_torch.train``) against the JAX package's.

  * the optimizer pieces — ``lr_schedule``, ``adamw_update`` (clipping,
    bias correction, weight decay by the reference's stacked rank),
    ``global_norm``, ``cross_entropy`` and ``cast_params_for_compute`` —
    on the same numpy inputs;
  * one ``make_train_step`` from the same state (``train_state_from_jax``)
    for the dense, MLA, encoder-decoder and VLM reduced configs: loss,
    every metric, every gradient leaf, the new masters, ``mu`` and ``nu``
    (``tests/torch_train_parity.py``; MoE, hybrid and xLSTM are in
    ``test_torch_train_moe_ssm.py`` so that the two files run on two
    workers);
  * the cases of ``tests/test_train.py``: micro-batches against JAX's,
    a falling loss; remat on and off; the flash op's refusal under
    autograd; the launcher.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train import optimizer as JO  # noqa: E402
from repro.train import train_step as JS  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.params import params_from_jax  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from torch_train_parity import (TOL, cfgs, close, jax_state,  # noqa: E402
                                make_batch, port_state, step_both, tcfgs)


# ---------------------------------------------------------------------------
# optimizer pieces
# ---------------------------------------------------------------------------
SCHEDULES = [dict(learning_rate=1e-3, warmup_steps=10, total_steps=100,
                  min_lr_ratio=0.1),
             dict(learning_rate=3e-4, warmup_steps=0, total_steps=7),
             dict(learning_rate=2.5e-3, warmup_steps=3, total_steps=3)]


def _schedule64(opt, step):
    """The schedule in float64 (numpy), the yardstick of both."""
    lr, w, total = opt["learning_rate"], opt["warmup_steps"], \
        opt["total_steps"]
    low = opt.get("min_lr_ratio", 0.1)
    if step < w:
        return lr * step / max(w, 1)
    prog = min(max((step - w) / max(total - w, 1), 0.0), 1.0)
    return lr * (low + (1 - low) * 0.5 * (1 + np.cos(np.pi * prog)))


@pytest.mark.parametrize("opt", SCHEDULES)
def test_lr_schedule_matches_jax(opt):
    """To one float32 ulp (2^-22 relative) of JAX's, and to 1e-6 of the
    float64 schedule.  The one-ulp gap: XLA's float32 cos is one ulp off
    the correctly rounded value at some angles (cos(0.7 pi) at step 80
    of the first schedule), where torch's (and numpy's) is not."""
    jcfg, tcfg = JO.OptimizerConfig(**opt), TO.OptimizerConfig(**opt)
    for step in range(0, 121):
        exp = float(JO.lr_schedule(jcfg, jnp.asarray(step)))
        got = float(TO.lr_schedule(tcfg, torch.tensor(step)))
        assert abs(got - exp) <= 2.0 ** -22 * abs(exp), (step, got, exp)
        ref = _schedule64(opt, step)
        assert abs(got - ref) <= 1e-6 * abs(ref), (step, got, ref)


def test_lr_schedule_shape():
    cfg = TO.OptimizerConfig(learning_rate=1e-3, warmup_steps=10,
                             total_steps=100, min_lr_ratio=0.1)
    lrs = [float(TO.lr_schedule(cfg, torch.tensor(s)))
           for s in range(0, 101, 5)]
    assert lrs[0] == 0.0
    assert abs(lrs[2] - 1e-3) < 1e-9
    assert lrs[-1] == pytest.approx(1e-4, rel=1e-3)
    assert all(a >= b - 1e-12 for a, b in zip(lrs[2:], lrs[3:]))


def _tree(seed, shapes):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


#: names as the port spells them; the JAX tree takes the same keys (its
#: rank test sees the arrays as given)
SHAPES = {"w": (4, 5), "b": (5,), "big": (3, 4, 2), "s": ()}


@pytest.mark.parametrize("clip,wd,steps", [(1.0, 0.1, 3), (100.0, 0.0, 2),
                                           (0.5, 0.3, 4)])
def test_adamw_update_matches_jax(clip, wd, steps):
    opt = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10,
               weight_decay=wd, clip_norm=clip)
    jcfg, tcfg = JO.OptimizerConfig(**opt), TO.OptimizerConfig(**opt)
    params = _tree(0, SHAPES)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    jst, tst = JO.init_opt_state(jp), TO.init_opt_state(tp)
    for i in range(steps):
        grads = _tree(10 + i, SHAPES)
        jp, jst, jm = JO.adamw_update(
            jcfg, jp, {k: jnp.asarray(v) for k, v in grads.items()}, jst)
        tp, tst, tm = TO.adamw_update(
            tcfg, tp, {k: torch.tensor(v) for k, v in grads.items()}, tst)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(tst.mu[k].numpy(),
                                       np.asarray(jst.mu[k]), rtol=1e-6,
                                       atol=1e-9, err_msg=k)
            np.testing.assert_allclose(tst.nu[k].numpy(),
                                       np.asarray(jst.nu[k]), rtol=1e-6,
                                       atol=1e-12, err_msg=k)
        assert int(tst.count) == int(jst.count) == i + 1
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)


def test_adamw_moves_against_gradient():
    params = {"w": torch.ones((4, 4))}
    state = TO.init_opt_state(params)
    cfg = TO.OptimizerConfig(learning_rate=0.1, warmup_steps=0,
                             total_steps=10, weight_decay=0.0)
    new, state2, m = TO.adamw_update(cfg, params,
                                     {"w": torch.ones((4, 4))}, state)
    assert bool((new["w"] < 1.0).all())
    assert int(state2.count) == 1
    assert float(m["grad_norm"]) == pytest.approx(4.0)


def test_grad_clipping():
    params = {"w": torch.zeros((10,))}
    cfg = TO.OptimizerConfig(learning_rate=1.0, warmup_steps=0,
                             clip_norm=1.0, weight_decay=0.0)
    new, _, m = TO.adamw_update(cfg, params, {"w": torch.full((10,), 100.0)},
                                TO.init_opt_state(params))
    assert float(m["grad_norm"]) == pytest.approx(np.sqrt(10) * 100)
    assert bool((new["w"].abs() < 1.5).all())


def test_global_norm_matches_jax():
    tree = _tree(3, SHAPES)
    exp = float(JO.global_norm({k: jnp.asarray(v) for k, v in tree.items()}))
    got = float(TO.global_norm(torch.tensor(v) for v in tree.values()))
    assert got == pytest.approx(exp, rel=1e-6)


@pytest.mark.parametrize("shape,vocab", [((2, 5), 7), ((3, 17), 128)])
def test_cross_entropy_matches_jax(shape, vocab):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=shape + (vocab,)).astype(np.float32)
    labels = rng.integers(0, vocab, shape).astype(np.int32)
    labels[0, 0] = -1
    labels[-1, -2:] = -1
    # a tie at the row max: gold >= row max counts as correct
    logits[0, 1, labels[0, 1]] = logits[0, 1].max()
    jl, ja = JS.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    tl, ta = TS.cross_entropy(torch.tensor(logits), torch.tensor(labels))
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    assert float(ta) == pytest.approx(float(ja), rel=1e-6)
    # the gather's gradient equals the one-hot contraction's
    jg = jax.grad(lambda x: JS.cross_entropy(x, jnp.asarray(labels))[0])(
        jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    TS.cross_entropy(x, torch.tensor(labels))[0].backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("arch", ["smollm-360m", "whisper-medium"])
def test_cast_params_for_compute_matches_jax(arch):
    """Leaf by leaf the port casts what the reference casts, by the
    reference's stacked rank (conv_b and d_skip go to bf16)."""
    jc, tc = cfgs(arch)
    jcast = JS.cast_params_for_compute(jax_state(jc).params, jnp.bfloat16)
    # 1 marks a leaf JAX cast to bfloat16, 0 one it kept in float32
    marks = params_from_jax(jax.tree.map(
        lambda a: np.full(a.shape, float(a.dtype == jnp.bfloat16),
                          np.float32), jcast), tc)
    tcast = TS.cast_params_for_compute(
        port_state(jax_state(jc), tc).params, torch.bfloat16)
    assert set(tcast) == set(marks)
    for k, m in marks.items():
        assert m.min() == m.max(), k
        want = torch.bfloat16 if float(m.max()) else torch.float32
        assert tcast[k].dtype == want, (k, tcast[k].dtype, want)


# ---------------------------------------------------------------------------
# one train step against JAX's, family by family
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["smollm-360m", "minicpm3-4b",
                                  "whisper-medium", "internvl2-76b"])
def test_train_step_matches_jax(arch):
    drift, _, _ = step_both(arch)
    print(arch, drift)


def test_weight_decay_by_stacked_rank():
    """After a step with weight decay 0.1 a layer's norm scale has decayed
    (the reference stacks it to rank 2) and ``final_norm.scale`` has not,
    in both packages."""
    jc, tc = cfgs("smollm-360m")
    jt, tt = tcfgs(weight_decay=0.1)
    state = port_state(jax_state(jc), tc)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    tb = {k: torch.from_numpy(v) for k, v in make_batch(tc).items()}
    new, m = TS.make_train_step(tc, tt)(state, tb)
    jt0, tt0 = tcfgs(weight_decay=0.0)
    state0 = port_state(jax_state(jc), tc)
    new0, _ = TS.make_train_step(tc, tt0)(state0, tb)
    lr = float(m["lr"])
    norm = "layers.0.mixer.norm.scale"
    d = (new.params[norm] - new0.params[norm]).detach()
    # decay moves each element by -lr * 0.1 * p (p = 1 before the step)
    # (to two float32 ulps of 1.0, the masters' rounding)
    np.testing.assert_allclose(d.numpy(), -lr * 0.1 * before[norm].numpy(),
                               rtol=0, atol=2.0 ** -22)
    torch.testing.assert_close(new.params["final_norm.scale"],
                               new0.params["final_norm.scale"], rtol=0,
                               atol=0)
    assert TO.decays(norm, before[norm]) and not TO.decays(
        "final_norm.scale", before["final_norm.scale"])
    # the same in JAX, from the same state
    from torch_train_parity import jax_step
    batch = {k: jnp.asarray(v) for k, v in make_batch(tc).items()}
    _, (jnew, _) = jax_step(jc, jt)(jax_state(jc), batch)
    jp = params_from_jax(jnew.params, tc)
    close(new.params[norm], jp[norm], TOL, norm)
    close(new.params["final_norm.scale"], jp["final_norm.scale"], TOL,
          "final_norm")


def test_micro_batches_match_jax_micro_batches():
    """micro_batches=4 against JAX's micro_batches=4, and against the
    port's full batch (tests/test_train.py's case)."""
    drift4, new4, _ = step_both("smollm-360m", micro_batches=4, batch=8)
    print("micro 4", drift4)
    jc, tc = cfgs("smollm-360m")
    _, tt = tcfgs(1)
    state = port_state(jax_state(jc), tc)
    tb = {k: torch.from_numpy(v)
          for k, v in make_batch(tc, batch=8).items()}
    new1, _ = TS.make_train_step(tc, tt)(state, tb)
    d = max(float((new1.params[k] - new4.params[k]).detach().abs().max())
            for k in new1.params)
    assert d < 5e-3


def test_loss_decreases_on_tiny_problem():
    _, tc = cfgs("smollm-360m")
    tt = TS.TrainConfig(optimizer=TO.OptimizerConfig(
        learning_rate=3e-3, warmup_steps=2, total_steps=40))
    state = TS.init_train_state(tc, torch.Generator().manual_seed(0), "cpu")
    step = TS.make_train_step(tc, tt)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, tc.vocab_size, (4, 32)).astype(np.int32))
    batch = {"tokens": tokens, "labels": tokens}   # memorize one batch
    losses = []
    for _ in range(30):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses[::6]


@pytest.mark.parametrize("arch", ["smollm-360m", "whisper-medium"])
def test_remat_on_and_off_give_identical_gradients(arch):
    """Group and query-chunk rematerialization recompute the same
    arithmetic: gradients bit for bit."""
    grads = []
    for remat in (True, False):
        jc, tc = cfgs(arch, remat=remat)
        _, tt = tcfgs()
        state = port_state(jax_state(cfgs(arch)[0]), tc)
        model = TS.bind(TS.skeleton(tc), state.params)
        tb = {k: torch.from_numpy(v) for k, v in make_batch(tc).items()}
        grads.append(TS.compute_grads(model, tc, tt, tb, state.params)[0])
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


def test_flash_op_raises_under_grad():
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    k, v = torch.randn(1, 2, 8, 16), torch.randn(1, 2, 8, 16)
    with pytest.raises(RuntimeError, match="forward only"):
        flash_ops.flash_attention(q, k, v)
    with torch.no_grad():
        assert flash_ops.flash_attention(q, k, v).shape == (1, 2, 8, 16)
    # a model trained with use_flash=True fails as the reference does
    _, tc = cfgs("smollm-360m", use_flash=True)
    _, tt = tcfgs()
    state = TS.init_train_state(tc, torch.Generator().manual_seed(0), "cpu")
    tb = {k: torch.from_numpy(v) for k, v in make_batch(tc).items()}
    with pytest.raises(RuntimeError, match="forward only"):
        TS.make_train_step(tc, tt)(state, tb)


def test_train_launcher_runs_on_cpu_and_refuses_a_mesh(tmp_path, capsys):
    assert tlaunch.main(["--arch", "smollm-360m", "--reduced", "--device",
                         "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
                         "--ckpt", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "[trainer] step     0" in out and "train launcher done" in out
    assert (tmp_path / "LATEST").read_text() == "3"
    # a mesh needs as many ranks (tests/test_torch_mesh_train.py runs it)
    with pytest.raises(ValueError, match="not in a process group"):
        tlaunch.main(["--arch", "smollm-360m", "--mesh", "2x1", "--reduced",
                      "--device", "cpu"])
