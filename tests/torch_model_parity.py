"""Shared helpers of the model parity tests (``tests/test_torch_mla.py``,
``test_torch_moe.py``, ``test_torch_ssm.py``, ``test_torch_encdec.py``).

A reduced config (``reduced_config``) is built in both packages with the
same overrides; the JAX parameters (``init_lm``) reach the port through
``params_from_jax``, and the same numpy tokens (and stub frontend
embeddings) go through both.  The jitted JAX steps are cached per config
and cache length, so each compiles once per test module.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_parity  # noqa: F401  (one intra-op thread a test process)
from repro import configs as jconfigs
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.models.params import params_from_jax
from repro_torch.models.transformer import LM, Caches, init_cache

TOL = 1e-5


def cfgs(name: str, **over):
    """(JAX config, port config): ``reduced_config`` in float32 with
    ``over`` applied to both."""
    over = {"dtype": "float32", **over}
    jc = dataclasses.replace(
        jconfigs.reduced_config(jconfigs.get_config(name)), **over)
    tc = dataclasses.replace(
        tconfigs.reduced_config(tconfigs.get_config(name)), **over)
    return jc, tc


@functools.lru_cache(maxsize=None)
def jax_params(jc):
    return JT.init_lm(jax.random.PRNGKey(7), jc)


def port_model(tc, params) -> LM:
    model = LM(tc, torch.Generator().manual_seed(0), "cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          tc))
    return model


def models(name: str, **over):
    """(JAX config, JAX params, port model) sharing one set of weights."""
    jc, tc = cfgs(name, **over)
    params = jax_params(jc)
    return jc, params, port_model(tc, params)


@functools.lru_cache(maxsize=None)
def jax_steps(jc, cache_len: int):
    """Jitted JAX prefill and decode steps, returning (logits, cache,
    metrics)."""
    prefill = jax.jit(lambda p, t, fe: JT.apply_lm(
        p, jc, t, mode="prefill", frontend_embeds=fe, cache_len=cache_len))
    decode = jax.jit(lambda p, c, t, pos: JT.apply_lm(
        p, jc, t, mode="decode", cache=c, positions=pos))
    return prefill, decode


def tokens(shape, seed=0, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def frontend(cfg, batch, seed=0):
    """The reference launcher's stub embeddings, ``0.02 * normal``, or
    None for a model without a frontend."""
    if cfg.frontend is None and not cfg.is_encoder_decoder:
        return None
    rng = np.random.default_rng(seed + 100)
    return (0.02 * rng.normal(size=(batch, cfg.frontend_seq, cfg.d_model))
            ).astype(np.float32)


def close(got, exp, tol=TOL, msg="", of_max=False):
    """Elementwise to ``tol`` (absolute and relative), or with ``of_max``
    to ``tol`` of the largest magnitude of ``exp``."""
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    if of_max:
        assert got.shape == exp.shape, msg
        err = float(np.abs(got - exp).max(initial=0.0))
        scale = float(np.abs(exp).max(initial=0.0))
        assert err <= tol * scale, f"{msg}: max |err| {err} > {tol} * {scale}"
    else:
        np.testing.assert_allclose(got, exp, rtol=tol, atol=tol,
                                   err_msg=msg)


def check_caches(tcache, jcache, cfg, tol=TOL, of_max=False):
    """Every leaf of every layer's cache; ``cursor`` and ``pos`` exactly."""
    groups = jcache["groups"]
    assert len(tcache) == cfg.n_layers
    for j, tc in enumerate(tcache):
        g, i = divmod(j, cfg.group_size)
        jm = groups[f"layer_{i}"]["mixer"]
        assert set(tc) == set(jm), (j, sorted(tc), sorted(jm))
        for name, exp in jm.items():
            exp = np.asarray(exp[g])
            got = tc[name]
            if name == "cursor":
                assert got == int(exp), f"layer {j} cursor"
            elif name == "pos":
                np.testing.assert_array_equal(got.numpy(), exp)
            else:
                assert tuple(got.shape) == exp.shape, (j, name)
                assert str(got.dtype) == f"torch.{exp.dtype.name}", (j, name)
                close(got, exp, tol, f"layer {j} {name}", of_max)
    if "enc_out" in jcache:
        close(tcache.enc_out, jcache["enc_out"], tol, "enc_out", of_max)
    else:
        assert tcache.enc_out is None


def check_metrics(taux, jaux, tol=TOL):
    """The MoE metrics summed over the layers.  The dropped fraction is
    ``1 - count / rows`` in the port; jitted XLA multiplies the count by
    the float32 reciprocal of ``rows``, which can land one unit of 2^-24
    off a layer (``-5.96e-08`` for no drop), so it is held to 1e-6 here;
    the dropped rows themselves (the ``ok`` mask) are held bit for bit in
    ``tests/test_torch_moe.py``."""
    assert set(taux) == set(jaux)
    for k, v in jaux.items():
        if k == "moe_dropped_frac":
            assert abs(float(taux[k]) - float(v)) <= 1e-6, (float(taux[k]),
                                                           float(v))
        else:
            close(taux[k], v, tol, k)


def port_cache(jcache, cfg) -> Caches:
    """The reference's cache in the port's layout (copies)."""
    out = Caches()
    for j in range(cfg.n_layers):
        g, i = divmod(j, cfg.group_size)
        jm = jcache["groups"][f"layer_{i}"]["mixer"]
        out.append({k: int(v[g]) if k == "cursor"
                    else torch.from_numpy(np.array(v[g]))
                    for k, v in jm.items()})
    if "enc_out" in jcache:
        out.enc_out = torch.from_numpy(np.array(jcache["enc_out"]))
    return out


def prefill_and_decode(jc, params, model, *, batch, prompt, steps,
                       cache_len, seed=0, tol=TOL, of_max=False,
                       decode_from_reference=False):
    """Prefill ``prompt`` tokens, then ``steps`` decode steps, in both
    packages: logits, every cache leaf and the metrics at every step
    (``tol`` and ``of_max`` as in :func:`close`).  With
    ``decode_from_reference`` each port decode step after the first
    starts from the reference's cache, so a later step's error is its
    own."""
    cfg = model.cfg
    toks = tokens((batch, prompt + steps), seed, cfg.vocab_size)
    fe = frontend(cfg, batch, seed)
    prefix = cfg.frontend_seq if cfg.frontend == "vision" else 0
    jprefill, jdecode = jax_steps(jc, cache_len)
    jl, jcache, jaux = jprefill(params, jnp.asarray(toks[:, :prompt]),
                                None if fe is None else jnp.asarray(fe))
    with torch.inference_mode():
        tl, tcache, taux = model(
            torch.from_numpy(toks[:, :prompt]), mode="prefill",
            cache_len=cache_len,
            frontend_embeds=None if fe is None else torch.from_numpy(fe))
    close(tl, jl, tol, "prefill logits", of_max)
    check_caches(tcache, jcache, cfg, tol, of_max)
    check_metrics(taux, jaux, tol)
    for step in range(steps):
        pos = prompt + prefix + step
        tok = toks[:, prompt + step:prompt + step + 1]
        if decode_from_reference and step:
            tcache = port_cache(jcache, cfg)
        jl, jcache, jaux = jdecode(params, jcache, jnp.asarray(tok),
                                   jnp.asarray([pos], jnp.int32))
        with torch.inference_mode():
            tl, tcache, taux = model(
                torch.from_numpy(tok), mode="decode", cache=tcache,
                positions=torch.tensor([pos], dtype=torch.int32))
        close(tl, jl, tol, f"decode step {step} logits", of_max)
        check_caches(tcache, jcache, cfg, tol, of_max)
        check_metrics(taux, jaux, tol)
    return tcache


def check_init_cache(arch: str):
    """The port's empty decode cache has the reference's leaves, shapes,
    dtypes and values, layer by layer."""
    jc, tc = cfgs(arch)
    jcache = JT.init_cache(jc, 2, 40, jnp.float32)
    tcache = init_cache(tc, 2, 40, torch.float32, "cpu")
    assert len(tcache) == tc.n_layers
    for j, c in enumerate(tcache):
        g, i = divmod(j, tc.group_size)
        jm = jcache[f"layer_{i}"]["mixer"]
        assert set(c) == set(jm)
        for name, exp in jm.items():
            exp = np.asarray(exp[g])
            if name == "cursor":
                assert c[name] == int(exp)
            else:
                assert str(c[name].dtype) == f"torch.{exp.dtype.name}"
                np.testing.assert_array_equal(c[name].numpy(), exp)
