"""The port's serving slice against the JAX package on the CPU.

Reduced configs (``reduced_config``: 2 layers, 16-dim heads, vocab 128) of
phi3-mini (MHA), smollm (GQA 3/1, tied embeddings), phi3 with a 32-token
sliding window, and one 5-layer group of deepseek-67b (GQA 8/1).  The JAX parameters (``init_lm``) reach the port
through ``params_from_jax``; the same numpy tokens go through both.  In
float32 every logit and cache entry agrees to 1e-5 (XLA and PyTorch take
exp, sin and cos and sum in other orders, nothing else differs); in
bfloat16, where XLA may keep float32 inside fusions that PyTorch rounds
per op, last-position logits agree to the JAX package's own model
tolerance, 2e-2 of the largest logit (``tests/test_models.py``).  Every
other family builds and takes every JAX leaf here; their parity tests
are ``tests/test_torch_{mla,moe,ssm,encdec}.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models.params import params_from_jax  # noqa: E402
from repro_torch.models.transformer import LM, init_cache  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402

TOL = 1e-5
ARCHS = {"phi3": ("phi3-mini-3.8b", {}),
         "smollm": ("smollm-360m", {}),
         "phi3_window": ("phi3-mini-3.8b", {"window": 32}),
         # one 5-layer group of deepseek-67b's nineteen, GQA 8:1 kept
         "deepseek": ("deepseek-67b", {"n_layers": 5})}


def _cfgs(arch: str, **over):
    name, extra = ARCHS[arch]
    over = {"dtype": "float32", **extra, **over}
    jc = dataclasses.replace(jconfigs.reduced_config(jconfigs.get_config(name)),
                             **over)
    tc = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config(name)),
                             **over)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _init_params(jc):
    return JT.init_lm(jax.random.PRNGKey(7), jc)


def _jax_params(arch: str):
    jc, _ = _cfgs(arch)
    return _init_params(jc)


def _models(arch: str, **over):
    """(jax cfg, jax params, port model) sharing one set of weights."""
    jc, tc = _cfgs(arch, **over)
    params = _jax_params(arch)
    model = LM(tc, torch.Generator().manual_seed(0), "cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          tc))
    return jc, params, model


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 128, shape,
                                                dtype=np.int32)


def _close(got, exp, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(exp, np.float64), rtol=tol,
                               atol=tol)


def _check_caches(tcache, jcache, cfg, int8=False):
    """Every layer's k, v (and scales), pos and cursor."""
    groups = jcache["groups"]
    for j, tc in enumerate(tcache):
        g, i = divmod(j, cfg.group_size)
        jm = groups[f"layer_{i}"]["mixer"]
        assert tc["cursor"] == int(jm["cursor"][g]), f"layer {j} cursor"
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jm["pos"][g]))
        for name in ("k", "v", "k_s", "v_s"):
            if name not in jm:
                assert name not in tc
                continue
            got, exp = tc[name].numpy(), np.asarray(jm[name][g])
            assert got.shape == exp.shape, (j, name)
            if int8 and name in ("k", "v"):
                assert got.dtype == np.int8
                # a value within an ulp of a rounding boundary may flip
                assert np.abs(got.astype(int) - exp.astype(int)).max() <= 1
            else:
                _close(got, exp)


def _jax_steps(jc, cache_len):
    prefill = jax.jit(lambda p, t: JT.apply_lm(
        p, jc, t, mode="prefill", cache_len=cache_len)[:2])
    decode = jax.jit(lambda p, c, t, pos: JT.apply_lm(
        p, jc, t, mode="decode", cache=c, positions=pos)[:2])
    return prefill, decode


# prompt length and cache length of each decode scenario: phi3 and smollm
# fill a linear cache so the third write clamps to the last slot (as
# ``dynamic_update_slice`` does); the windowed config builds a padded ring
# whose third write wraps to slot 0, and a full ring (prompt > window)
DECODE_CASES = [("phi3", 12, 14, {}), ("smollm", 12, 14, {}),
                ("phi3_window", 30, 32, {}), ("phi3_window", 40, 32, {}),
                ("phi3", 12, 16, {"kv_quant": True}),
                ("smollm", 12, 16, {"kv_quant": True}),
                ("deepseek", 12, 14, {})]


@pytest.mark.parametrize("arch,prompt,cache_len,over", DECODE_CASES)
def test_prefill_and_decode_vs_jax(arch, prompt, cache_len, over):
    jc, params, model = _models(arch, **over)
    cfg = model.cfg
    quant = cfg.kv_quant
    b = 2
    toks = _tokens((b, prompt + 3), seed=prompt)
    jprefill, jdecode = _jax_steps(jc, cache_len)

    jl, jcache = jprefill(params, jnp.asarray(toks[:, :prompt]))
    with torch.inference_mode():
        tl, tcache, _ = model(torch.from_numpy(toks[:, :prompt]),
                           mode="prefill", cache_len=cache_len)
    _close(tl, jl)
    _check_caches(tcache, jcache, cfg, int8=quant)
    if cfg.window is not None and prompt >= cache_len:
        assert tcache[0]["cursor"] == prompt % cache_len  # a full ring

    for step in range(3):
        pos = prompt + step
        tok = toks[:, pos:pos + 1]
        jl, jcache = jdecode(params, jcache, jnp.asarray(tok),
                             jnp.asarray([pos], jnp.int32))
        with torch.inference_mode():
            tl, tcache, _ = model(torch.from_numpy(tok), mode="decode",
                               cache=tcache,
                               positions=torch.tensor([pos],
                                                      dtype=torch.int32))
        _close(tl, jl)
        _check_caches(tcache, jcache, cfg, int8=quant)
    if cfg.window is not None and prompt < cache_len:
        assert tcache[0]["cursor"] == (prompt + 3) % cache_len  # wrapped


@pytest.mark.parametrize("arch", list(ARCHS))
def test_flash_prefill_vs_jax_pallas(arch):
    """``use_flash=True``: the Pallas kernel (interpret mode) in JAX, the
    flash kernel's plain version in the port."""
    jc, params, model = _models(arch, use_flash=True)
    toks = _tokens((2, 40), seed=3)
    jl, jcache = jax.jit(lambda p, t: JT.apply_lm(
        p, jc, t, mode="prefill", cache_len=48)[:2])(params, jnp.asarray(toks))
    with torch.inference_mode():
        tl, tcache, _ = model(torch.from_numpy(toks), mode="prefill",
                              cache_len=48)
    _close(tl, jl)
    _check_caches(tcache, jcache, model.cfg)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_generate_greedy_tokens_equal_jax(arch):
    jc, params, model = _models(arch)
    prompts = _tokens((2, 20), seed=5)
    scfg = dict(max_len=20 + 8 + 8)
    exp = jengine.Engine(jc, params, jengine.ServeConfig(**scfg)).generate(
        jnp.asarray(prompts), n_tokens=8)
    got = Engine(model, ServeConfig(**scfg)).generate(prompts, n_tokens=8)
    assert got.dtype == np.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got, np.asarray(exp))


def test_generate_stops_at_eos_like_jax():
    jc, params, model = _models("smollm")
    prompts = _tokens((1, 10), seed=9)
    free = Engine(model, ServeConfig(max_len=30)).generate(prompts, 8)
    eos = int(free[0, 2])
    scfg = dict(max_len=30, eos_id=eos)
    exp = jengine.Engine(jc, params, jengine.ServeConfig(**scfg)).generate(
        jnp.asarray(prompts), n_tokens=8)
    got = Engine(model, ServeConfig(**scfg)).generate(prompts, 8)
    np.testing.assert_array_equal(got, np.asarray(exp))
    assert got.shape[1] == list(free[0]).index(eos) + 1


@pytest.mark.parametrize("arch", ["phi3", "smollm", "deepseek"])
def test_bf16_logits_within_model_tolerance(arch):
    jc, params, model = _models(arch, dtype="bfloat16")
    assert model.embed.dtype == torch.bfloat16
    toks = _tokens((2, 24), seed=11)
    jl, jcache = JT.apply_lm(params, jc, jnp.asarray(toks[:, :-1]),
                             mode="prefill", cache_len=32)[:2]
    jd, _ = JT.apply_lm(params, jc, jnp.asarray(toks[:, -1:]), mode="decode",
                        cache=jcache, positions=jnp.asarray([23], jnp.int32))[:2]
    with torch.inference_mode():
        tl, tcache, _ = model(torch.from_numpy(toks[:, :-1]),
                              mode="prefill", cache_len=32)
        td, _, _ = model(torch.from_numpy(toks[:, -1:]), mode="decode",
                         cache=tcache, positions=torch.tensor(
                             [23], dtype=torch.int32))
    for got, exp in ((tl[:, -1], np.asarray(jl)[:, -1]), (td, jd)):
        exp = np.asarray(exp, np.float32)
        rel = np.abs(got.numpy() - exp).max() / (np.abs(exp).max() + 1e-9)
        assert rel < 2e-2, f"bf16 logits deviate: {rel}"


def test_sampling_at_temperature_is_seeded():
    _, _, model = _models("phi3")
    eng = Engine(model, ServeConfig(max_len=24, temperature=1.0))
    prompts = _tokens((3, 8), seed=2)
    a = eng.generate(prompts, 6, torch.Generator().manual_seed(4))
    b = eng.generate(prompts, 6, torch.Generator().manual_seed(4))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (3, 6) and a.min() >= 0 and a.max() < 128


# the leaf of layer 0 each case drops, extends beside or cuts: a dense
# attention weight, a MoE router (float32), a Mamba decay (float32)
LEAF_CASES = [pytest.param(name, leaf, change, id=f"{tag}{change}")
              for name, leaf, tag in (
                  ("phi3-mini-3.8b", "mixer/wq", ""),
                  ("qwen2-moe-a2.7b", "ffn/router", "moe-"),
                  ("jamba-v0.1-52b", "mixer/a_log", "hybrid-"))
              for change in ("drop", "extra", "groups")]


@pytest.mark.parametrize("name,leaf,change", LEAF_CASES)
def test_params_from_jax_consumes_every_leaf(name, leaf, change):
    over = {"dtype": "float32"}
    tc = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config(
        name)), **over)
    jc = dataclasses.replace(jconfigs.reduced_config(jconfigs.get_config(
        name)), **over)
    tree = jax.tree.map(np.asarray, _init_params(jc))
    part, key = leaf.split("/")
    layer = {**tree["decoder"]["layer_0"],
             part: dict(tree["decoder"]["layer_0"][part])}
    tree = {**tree, "decoder": {**tree["decoder"], "layer_0": layer}}
    sub = layer[part]
    if change == "drop":
        del sub[key]
        with pytest.raises(KeyError, match=leaf):
            params_from_jax(tree, tc)
    elif change == "extra":
        sub["bias"] = np.zeros(3, np.float32)
        with pytest.raises(ValueError, match=f"{part}/bias"):
            params_from_jax(tree, tc)
    else:
        sub[key] = sub[key][:1]
        with pytest.raises(ValueError, match="groups"):
            params_from_jax(tree, tc)


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_configs_mirror_jax(arch):
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert (dataclasses.asdict(tconfigs.reduced_config(tc))
            == dataclasses.asdict(jconfigs.reduced_config(jc)))
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "minicpm3-4b",
                                  "jamba-v0.1-52b", "xlstm-125m",
                                  "whisper-medium", "internvl2-76b"])
def test_later_families_build_and_load_every_leaf(arch):
    """Every family builds on the CPU and takes every JAX leaf (a strict
    ``load_state_dict``: no key missing, none left over, each shape and
    dtype-cast as the model holds it)."""
    cfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    jc = jconfigs.reduced_config(jconfigs.get_config(arch))
    model = LM(cfg, torch.Generator().manual_seed(0), "cpu")
    tree = jax.tree.map(np.asarray, _init_params(jc))
    state = params_from_jax(tree, cfg)
    assert len(state) == len(model.state_dict())
    model.load_state_dict(state)
    for key, val in model.state_dict().items():
        np.testing.assert_array_equal(
            val.float().numpy(), state[key].to(val.dtype).float().numpy())


def test_entry_points_run_on_the_card_unless_asked(monkeypatch):
    _, tc = _cfgs("phi3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LM(tc, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(tc, 1, 8, torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlaunch.main(["--arch", "phi3-mini-3.8b", "--reduced"])


def test_init_cache_matches_jax_layout():
    jc, tc = _cfgs("phi3_window", kv_quant=True)
    jcache = JT.init_cache(jc, 2, 40, jnp.float32)
    tcache = init_cache(tc, 2, 40, torch.float32, "cpu")
    assert len(tcache) == tc.n_layers
    _check_caches(tcache, {"groups": jcache}, tc, int8=True)


def test_serve_launcher_on_cpu(capsys):
    assert tlaunch.main(["--arch", "smollm-360m", "--reduced", "--device",
                         "cpu", "--batch", "2", "--prompt-len", "8",
                         "--gen", "4"]) == 0
    assert "generated (2, 4) on cpu" in capsys.readouterr().out
