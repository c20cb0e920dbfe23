"""Shared helpers of the training parity tests (``tests/test_torch_train.py``,
``test_torch_train_moe_ssm.py``).

A reduced config is built in both packages in float32 with the same
overrides (``attn_q_chunk=32``, so a 40-token batch runs ``attend`` in
two query chunks and the chunk rematerialization is on the path); the
JAX ``init_train_state`` reaches the port through
``train_state_from_jax``; the same numpy batch goes through JAX's
jitted ``make_train_step`` and the port's.  One jitted JAX program per
config returns ``jax.grad``'s tree beside the step's new state and
metrics, and is cached, so each config compiles once per test module.

Tolerances are of each leaf's largest magnitude (``close(...,
of_max=True)``).  The new masters add what the gradient tolerance
admits through AdamW's normalization: from a zero optimizer state the
first step moves a master by ``lr * g / (|g| + eps)``, which turns a
gradient element at ``eps`` (1e-8; rounding noise beside a leaf's
largest gradient of ~1e-2) into a move of up to ``lr`` whatever the
gradient's accuracy.  :func:`adam_slack` bounds that move from the
reference's gradient, element by element; where ``|g| >> eps`` it is 0.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch import nn
from torch.overrides import TorchFunctionMode

import torch_parity  # noqa: F401  (one intra-op thread a test process)
from repro import configs as jconfigs
from repro.train import train_step as JS
from repro.train.optimizer import OptimizerConfig as JOptimizerConfig
from repro_torch import configs as tconfigs
from repro_torch.models.params import params_from_jax
from repro_torch.train import train_step as TS
from repro_torch.train.optimizer import OptimizerConfig

TOL = 1e-5
#: a step from init: warm-up of 2, so the first step's lr is 1.5e-4
OPT = dict(warmup_steps=2, total_steps=20)
BATCH, SEQ = 2, 40


def cfgs(name: str, **over):
    over = {"dtype": "float32", "attn_q_chunk": 32, **over}
    jc = dataclasses.replace(
        jconfigs.reduced_config(jconfigs.get_config(name)), **over)
    tc = dataclasses.replace(
        tconfigs.reduced_config(tconfigs.get_config(name)), **over)
    return jc, tc


def tcfgs(micro_batches: int = 1, **opt):
    opt = {**OPT, **opt}
    return (JS.TrainConfig(optimizer=JOptimizerConfig(**opt),
                           micro_batches=micro_batches),
            TS.TrainConfig(optimizer=OptimizerConfig(**opt),
                           micro_batches=micro_batches))


@functools.lru_cache(maxsize=None)
def jax_state(jc):
    return JS.init_train_state(jax.random.PRNGKey(7), jc)


@functools.lru_cache(maxsize=None)
def jax_step(jc, jt):
    """Jitted ``(state, batch) → (grads, (new state, metrics))``: the
    reference's step and the gradient tree it hands to ``adamw_update``
    (tapped while the step traces, so the program holds one backward)."""
    adamw = JS.adamw_update

    def step(state, batch):
        seen = {}

        def tap(ocfg, params, grads, opt):
            seen["grads"] = grads
            return adamw(ocfg, params, grads, opt)

        with mock.patch.object(JS, "adamw_update", tap):
            out = JS.make_train_step(jc, jt)(state, batch)
        return seen["grads"], out
    return jax.jit(step)


def make_batch(cfg, batch=BATCH, seq=SEQ, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    out["labels"][:, -1] = -1                  # a masked position
    if cfg.frontend is not None or cfg.is_encoder_decoder:
        out["frontend"] = (0.02 * rng.normal(
            size=(batch, cfg.frontend_seq, cfg.d_model))).astype(np.float32)
    return out


def port_state(jstate, tc):
    return TS.place_state(TS.train_state_from_jax(jstate, tc), "cpu")


def close(got, exp, tol, msg, slack=None):
    """``|got - exp| <= tol * max|exp| (+ slack)`` elementwise."""
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    assert got.shape == exp.shape, (msg, got.shape, exp.shape)
    err = np.abs(got - exp)
    allow = tol * float(np.abs(exp).max(initial=0.0))
    if slack is not None:
        allow = allow + slack
    bad = err > allow
    assert not bad.any(), (
        f"{msg}: {int(bad.sum())} elements over; worst err "
        f"{float(err.max())}, tol * max {tol * float(np.abs(exp).max())}")


def worst(got, exp) -> float:
    """The largest error of a leaf over its largest magnitude."""
    got = got.detach().numpy().astype(np.float64)
    exp = np.asarray(exp, np.float64)
    scale = float(np.abs(exp).max(initial=0.0))
    return float(np.abs(got - exp).max(initial=0.0)) / (scale or 1.0)


def adam_slack(g, gnorm, ocfg, lr, tol):
    """The largest change of a first-step master (zero optimizer state)
    when the gradient moves within ``tol`` of its leaf's largest
    magnitude: ``lr * |u(g' ± d) - u(g')|`` with ``u(x) = x / (|x| +
    eps)``, ``g'`` the clipped gradient and ``d`` the tolerance."""
    g = np.asarray(g, np.float64)
    scale = min(1.0, ocfg.clip_norm / max(gnorm, 1e-9))
    gs = g * scale
    d = tol * float(np.abs(gs).max(initial=0.0))

    def u(x):
        return x / (np.abs(x) + ocfg.eps)

    return lr * np.maximum(np.abs(u(gs + d) - u(gs)),
                           np.abs(u(gs - d) - u(gs)))


def step_both(name, tol=TOL, micro_batches=1, seed=0, batch=BATCH,
              **over):
    """One step from the same state in both packages; holds loss, every
    metric, every gradient leaf, the new masters, ``mu`` and ``nu``.
    Returns the worst relative error of each kind (the measured drift)
    and the port's new state."""
    jc, tc = cfgs(name, **over)
    jt, tt = tcfgs(micro_batches)
    jstate = jax_state(jc)
    batch = make_batch(tc, batch=batch, seed=seed)
    jgrads, (jnew, jm) = jax_step(jc, jt)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state = port_state(jstate, tc)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    model = TS.bind(TS.skeleton(tc), state.params)
    grads = None
    if micro_batches == 1:
        grads, _ = TS.compute_grads(model, tc, tt, tb, state.params)
    new, tm = TS.make_train_step(tc, tt, model)(state, tb)

    drift = {}
    assert set(tm) == set(jm), (sorted(tm), sorted(jm))
    for k, v in jm.items():
        if k == "moe_dropped_frac":
            # counts over rows: 1e-6 as tests/torch_model_parity.py holds it
            assert abs(float(tm[k]) - float(v)) <= 1e-6, (k, float(tm[k]),
                                                          float(v))
        else:
            close(tm[k], v, tol, f"{name} metric {k}")
    trees = {"mu": (new.opt.mu, jnew.opt.mu), "nu": (new.opt.nu,
                                                       jnew.opt.nu)}
    if grads is not None:
        trees["grads"] = (grads, jgrads)
    for kind, (got, exp) in trees.items():
        exp = params_from_jax(exp, tc)
        assert set(got) == set(exp), kind
        drift[kind] = max(worst(got[k], exp[k]) for k in exp)
        for k in exp:
            close(got[k], exp[k], tol, f"{name} {kind} {k}")
    assert int(new.opt.count) == int(jnew.opt.count) == 1
    jg = params_from_jax(jgrads, tc)
    exp = params_from_jax(jnew.params, tc)
    lr = float(jm["lr"])
    gnorm = float(jm["grad_norm"])
    drift["masters"] = max(worst(new.params[k], exp[k]) for k in exp)
    for k in exp:
        close(new.params[k], exp[k], tol, f"{name} master {k}",
              slack=adam_slack(jg[k], gnorm, tt.optimizer, lr, tol))
    return drift, new, jnew


#: the reference modules a train step runs; :func:`jax_float64` reads
#: their ``jnp.float32`` as float64
_JAX_STEP_MODULES = ("repro.models.layers", "repro.models.transformer",
                     "repro.models.moe", "repro.models.ssm",
                     "repro.models.xlstm", "repro.train.optimizer",
                     "repro.train.train_step")


class _Jnp64:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


@contextlib.contextmanager
def jax_float64():
    """The reference in float64 throughout: x64 on, and every explicit
    ``jnp.float32`` of the step's modules read as float64 (the gates,
    recurrences and the router the models keep in float32)."""
    mods = [importlib.import_module(m) for m in _JAX_STEP_MODULES]
    with jax.enable_x64(True), contextlib.ExitStack() as stack:
        for m in mods:
            stack.enter_context(mock.patch.object(m, "jnp", _Jnp64()))
        yield


class _Torch64(TorchFunctionMode):
    """Every ``torch.float32`` argument read as ``torch.float64``.  The
    backward runs with the mode on, so remat recomputes are float64 too
    (``torch.autograd.grad`` would run it with the mode off)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func is torch.autograd.grad:
            out, inputs = args[0], tuple(args[1])
            out = out[0] if isinstance(out, (tuple, list)) else out
            with _Torch64():
                return torch.autograd.graph._engine_run_backward(
                    (out,), (torch.ones_like(out),), False, False, inputs,
                    kwargs.get("allow_unused", False),
                    accumulate_grad=False)
        args = tuple(torch.float64 if a is torch.float32 else a
                     for a in args)
        if kwargs.get("dtype") is torch.float32:
            kwargs["dtype"] = torch.float64
        return func(*args, **kwargs)


@contextlib.contextmanager
def port_float64():
    """The port in float64 throughout (default dtype and every explicit
    ``torch.float32``)."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with _Torch64():
            yield
    finally:
        torch.set_default_dtype(old)


def float64_witness(name):
    """One step's gradients in four runs from the same state and batch:
    port and reference, each in float32 and in float64.  → the worst
    error over each leaf's largest magnitude of port64 vs jax64 (the
    same function?), port32 vs jax64 and jax32 vs jax64 (how far each
    float32 step is from the float64 one)."""
    jc, tc = cfgs(name)
    jt, tt = tcfgs()
    jstate = jax_state(jc)
    batch = make_batch(tc)
    j32, _ = jax_step(jc, jt)(jstate, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    with jax_float64():
        jc64 = dataclasses.replace(jc, dtype="float64")
        p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                           jstate.params)
        b64 = {k: jnp.asarray(v.astype(np.float64) if v.dtype == np.float32
                              else v) for k, v in batch.items()}
        j64 = jax.jit(jax.grad(
            lambda p, b: JS.loss_fn(p, jc64, jt, b)[0]))(p64, b64)
        j64 = jax.tree.map(np.asarray, j64)
    j32, j64 = params_from_jax(j32, tc), params_from_jax(j64, tc)

    state = port_state(jstate, tc)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    model = TS.bind(TS.skeleton(tc), state.params)
    t32, _ = TS.compute_grads(model, tc, tt, tb, state.params)
    with port_float64():
        masters = {k: nn.Parameter(v.detach().double())
                   for k, v in state.params.items()}
        tb64 = {k: v.double() if v.dtype == torch.float32 else v
                for k, v in tb.items()}
        t64, _ = TS.compute_grads(TS.bind(TS.skeleton(tc), masters), tc,
                                  tt, tb64, masters)
    assert all(g.dtype == torch.float64
               for g in list(t64.values()) + list(j64.values()))

    def far(got):
        return max(worst(got[k], j64[k]) for k in j64)

    return {"port64": far(t64), "port32": far(t32), "jax32": far(j32)}
