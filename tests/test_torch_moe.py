"""The port's MoE FFN (qwen2-moe, mixtral) against the JAX package on the
CPU.

Routing and packing are integer work and must match bit for bit: top-k
ids, the stable sort by expert, the ranks, the slots (``E * cap`` for a
dropped row), the token of each sorted row, the ``ok`` mask and the
dropped fraction.  Gates, the packed buffer, the FFN output and the aux
metrics agree to 1e-5 in float32.  Cases: groups of one batch row (S >=
64) and of the whole batch (S < 64, as in decode), a capacity overflow
(``capacity_factor=0.25``), 6 experts padded to 16 dead ones, and shared
experts.  The whole reduced LMs are held to JAX through prefill, every
cache leaf, 3 decode steps (capacity 4 drops tokens in decode, as in
the reference), the summed metrics and greedy tokens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402

from torch_model_parity import (check_caches, check_metrics,  # noqa: E402
                                close, frontend, models, prefill_and_decode,
                                tokens)

QWEN, MIXTRAL = "qwen2-moe-a2.7b", "mixtral-8x7b"

# one compile a shape instead of one a primitive
_routing = jax.jit(JM._routing, static_argnums=1)
_pack = jax.jit(JM._pack, static_argnums=(3, 4, 5))
_moe_ffn = jax.jit(JM._moe_ffn_einsum, static_argnums=1)

# name, arch, overrides, batch, seq
FFN_CASES = [
    ("qwen_rows_s64", QWEN, {}, 2, 64),
    ("qwen_batch_s8", QWEN, {}, 3, 8),
    ("mixtral_overflow", MIXTRAL, {"capacity_factor": 0.25}, 2, 80),
    ("qwen_padded_6_to_16", QWEN, {"n_experts": 6}, 2, 70),
    ("mixtral_decode_batch", MIXTRAL, {}, 8, 1),
]


def _ffn(case):
    """(JAX layer params, JAX config, port MoE, x) of the case's first MoE
    layer."""
    _, arch, over, b, s = case
    jc, params, model = models(arch, **over)
    layer = next(i for i, ly in enumerate(model.layers)
                 if isinstance(ly.ffn, TM.MoE))
    g, i = divmod(layer, jc.group_size)
    jp = jax.tree.map(lambda a: a[g], params["decoder"][f"layer_{i}"]["ffn"])
    rng = np.random.default_rng(b * 1000 + s)
    x = rng.standard_normal((b, s, jc.d_model), dtype=np.float32)
    return jp, jc, model.layers[layer].ffn, x


@pytest.mark.parametrize("case", FFN_CASES, ids=lambda c: c[0])
def test_routing_and_pack_bit_exact(case):
    jp, jc, moe, x = _ffn(case)
    b, s, d = x.shape
    e, k = moe.router.shape[1], jc.experts_per_token
    xn = moe.norm(torch.from_numpy(x), jc.norm_eps)
    jg, ji, jaux, jz = _routing(jp, jc, jnp.asarray(xn.numpy()))
    tg, ti, taux, tz = TM.routing(xn, moe.router, moe.cfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    close(tg, jg)
    close(taux, jaux)
    close(tz, jz)
    g, n = (b, s) if s >= 64 else (1, b * s)
    cap = TM.capacity(n, k, e, jc.capacity_factor)
    assert cap == JM._capacity(n, k, e, jc.capacity_factor)
    jbuf, jslot, jtok, jgt, jok = _pack(
        jnp.asarray(xn.numpy()).reshape(g, n, d), ji.reshape(g, n, k),
        jg.reshape(g, n, k), e, cap, jnp.float32)
    tbuf, tslot, ttok, tgt, tok = TM.pack(
        xn.reshape(g, n, d), ti.reshape(g, n, k), tg.reshape(g, n, k), e,
        cap)
    for got, exp in ((tslot, jslot), (ttok, jtok), (tok, jok)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    close(tbuf, jbuf)
    close(tgt, jgt)
    if case[0] == "mixtral_overflow":
        assert not bool(tok.all()), "the case must overflow"
    if case[0] == "qwen_padded_6_to_16":
        assert e == 16 and int(ti.max()) < 6, "dead experts never routed"


@pytest.mark.parametrize("case", FFN_CASES, ids=lambda c: c[0])
def test_moe_ffn_vs_jax(case):
    jp, jc, moe, x = _ffn(case)
    exp, jm = _moe_ffn(jp, jc, jnp.asarray(x))
    with torch.inference_mode():
        got, tm = moe(torch.from_numpy(x))
    close(got, exp)
    assert set(tm) == set(jm) == set(TM.METRICS)
    close(tm["moe_aux_loss"], jm["moe_aux_loss"])
    close(tm["router_z_loss"], jm["router_z_loss"])
    # jitted XLA multiplies by the float32 reciprocal of the row count
    assert abs(float(tm["moe_dropped_frac"])
               - float(jm["moe_dropped_frac"])) <= 2 ** -24


def test_padded_experts_carry_the_padded_width():
    """qwen2-moe's 60 experts pad to 64 (model axis 16); 6 pad to 16."""
    _, _, model = models(QWEN, n_experts=6)
    moe = model.layers[0].ffn
    assert TM.padded_experts(model.cfg) == 16
    assert moe.router.shape == (model.cfg.d_model, 16)
    assert moe.router.dtype == torch.float32
    assert moe.w_gate.shape[0] == moe.w_in.shape[0] == moe.w_out.shape[0] == 16
    from repro_torch.configs import get_config
    assert TM.padded_experts(get_config(QWEN)) == 64


# arch, overrides, prompt: qwen2-moe with shared experts, S < 64 and S >=
# 64 in prefill; mixtral with its window; a starved capacity
LM_CASES = [("qwen_s12", QWEN, {}, 12), ("qwen_s64", QWEN, {}, 64),
            ("mixtral_s40", MIXTRAL, {}, 40),
            ("mixtral_overflow_s70", MIXTRAL, {"capacity_factor": 0.25}, 70),
            ("qwen_padded_s64", QWEN, {"n_experts": 6}, 64)]


@pytest.mark.parametrize("case", LM_CASES, ids=lambda c: c[0])
def test_prefill_and_decode_vs_jax(case):
    _, arch, over, prompt = case
    jc, params, model = models(arch, **over)
    prefill_and_decode(jc, params, model, batch=2, prompt=prompt, steps=3,
                       cache_len=prompt + 4, seed=prompt)


@pytest.mark.parametrize("arch", [QWEN, MIXTRAL])
def test_generate_greedy_tokens_equal_jax(arch):
    jc, params, model = models(arch)
    prompts = tokens((2, 20), seed=5)
    scfg = dict(max_len=20 + 8 + 8)
    exp = jengine.Engine(jc, params, jengine.ServeConfig(**scfg)).generate(
        jnp.asarray(prompts), n_tokens=8)
    got = Engine(model, ServeConfig(**scfg)).generate(prompts, n_tokens=8)
    np.testing.assert_array_equal(got, np.asarray(exp))


def test_flash_prefill_vs_jax_pallas():
    """``use_flash=True``: the Pallas kernel (interpret mode) in JAX, the
    flash kernel's plain version in the port, under the MoE layers."""
    jc, params, model = models(QWEN, use_flash=True)
    toks = tokens((2, 40), seed=3)
    assert frontend(model.cfg, 2) is None
    jl, jcache, jaux = jax.jit(lambda p, t: JT.apply_lm(
        p, jc, t, mode="prefill", cache_len=48))(params, jnp.asarray(toks))
    with torch.inference_mode():
        tl, tcache, taux = model(torch.from_numpy(toks), mode="prefill",
                                 cache_len=48)
    close(tl, jl)
    check_caches(tcache, jcache, model.cfg)
    check_metrics(taux, jaux)
