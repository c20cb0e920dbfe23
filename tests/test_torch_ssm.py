"""The port's Mamba (jamba) and xLSTM (mLSTM, sLSTM) mixers against the
JAX package on the CPU.

Reduced jamba (two 8-layer groups, each 7 Mamba layers and 1 attention
layer, MoE on pattern slots 1, 3, 5, 7) with ``scan_chunk=32`` and a
48-token prompt (two chunks, the second padded in the reference), and
reduced xlstm
(mLSTM, mLSTM, mLSTM, sLSTM) with ``mlstm_chunk=16`` and a 40-token prompt
(three chunks, the last padded with input-gate logits of -1e30), in
float32 with the JAX parameters: prefill logits, every cache leaf, decode
logits over 3 steps, the metrics and greedy tokens.

Tolerance.  Each layer alone (``test_layer_alone_vs_jax``: one layer of
every kind, the same input in both packages, a prefill and three decode
steps from each package's own cache) is held elementwise to 1e-5, the
scans included: measured, the worst is 8.7e-6 of ``1 + |x|`` on jamba's
MoE output.  The whole models compose many such layers, and the gaps
grow with depth: the port groups Mamba's scan as the reference's
associative scan does, but XLA and PyTorch take exp and softplus (and
sum the mLSTM chunk's decay-weighted products) to within a few ulps of
each other, not bit for bit; a recurrent state carries that into every
later step, and every later layer reads it.  So reduced jamba (16
layers) is held to 1e-5 of each tensor's largest magnitude (measured
elementwise, 2.4e-5 on a logit of 0.9 fails 1e-5 of ``1 + |x|``), and
reduced xLSTM to 5e-5 of it: its exponential gates amplify the gap from
5e-6 on mLSTM states of magnitude 8 in layer 0 to 3e-4 on magnitude 19
in layer 6, and to 1.5e-4 on logits of 3.9 (3.9e-5 of the largest).
xLSTM's first decode step runs from the port's own cache; each later
one starts from the reference's cache, since the normalizer ``q·n`` of
an mLSTM step can nearly cancel and ``h = num / |q·n|`` then magnifies
the prefill's gap past these limits within two steps.  Greedy tokens of
``Engine.generate`` carry the port's own states end to end.  Routing ids
and the dropped counts stay exact: a flipped expert would differ by far
more.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import transformer as JT  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.models import ssm, xlstm  # noqa: E402
from repro_torch.models.moe import MoE  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402

from torch_model_parity import (check_init_cache,  # noqa: E402
                                check_metrics, close, models,
                                prefill_and_decode, tokens)

JAMBA, XLSTM = "jamba-v0.1-52b", "xlstm-125m"
MODEL_TOL = {JAMBA: 1e-5, XLSTM: 5e-5}  # of the largest magnitude
CASES = {"jamba_two_chunks": (JAMBA, {"scan_chunk": 32}, 48),
         "jamba_one_chunk": (JAMBA, {"scan_chunk": 32}, 20),
         "xlstm_three_chunks": (XLSTM, {"mlstm_chunk": 16}, 40),
         "xlstm_one_chunk": (XLSTM, {"mlstm_chunk": 16}, 12)}


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_vs_jax(case):
    arch, over, prompt = CASES[case]
    jc, params, model = models(arch, **over)
    prefill_and_decode(jc, params, model, batch=2, prompt=prompt, steps=3,
                       cache_len=prompt + 4, seed=prompt,
                       tol=MODEL_TOL[arch], of_max=True,
                       decode_from_reference=arch == XLSTM)


@functools.lru_cache(maxsize=None)
def jax_layer(jc, kind, i, mode, cache_len):
    return jax.jit(lambda p, x, cache, pos: JT.apply_layer(
        p, jc, x, kind, i, mode=mode, cache=cache, positions=pos,
        cache_len=cache_len))


# one layer of each kind and FFN: (arch, overrides, pattern slot)
LAYERS = {"jamba_mamba_mlp": (JAMBA, {"scan_chunk": 32}, 0),
          "jamba_mamba_moe": (JAMBA, {"scan_chunk": 32}, 1),
          "jamba_attn_mlp": (JAMBA, {"scan_chunk": 32}, 4),
          "xlstm_mlstm": (XLSTM, {"mlstm_chunk": 16}, 0),
          "xlstm_slstm": (XLSTM, {"mlstm_chunk": 16}, 3)}


@pytest.mark.parametrize("case", list(LAYERS))
def test_layer_alone_vs_jax(case):
    """One layer of the last group on the same random input in both
    packages (``apply_layer`` against ``Layer``): a 48-token prefill, then
    3 decode steps, each package from its own cache; output, every cache
    leaf and the MoE metrics elementwise to 1e-5."""
    arch, over, i = LAYERS[case]
    jc, params, model = models(arch, **over)
    cfg = model.cfg
    g, kind = cfg.n_groups - 1, cfg.block_pattern[i]
    lp = jax.tree.map(lambda a: a[g], params["decoder"][f"layer_{i}"])
    layer = model.layers[g * cfg.group_size + i]
    b, s, steps = 2, 48, 3
    x = np.random.default_rng(i).normal(
        size=(b, s + steps, cfg.d_model)).astype(np.float32)
    jcache = tcache = None
    for start, stop in [(0, s)] + [(t, t + 1) for t in range(s, s + steps)]:
        mode = "prefill" if start == 0 else "decode"
        pos = np.arange(start, stop, dtype=np.int32)
        jx, jcache, jm = jax_layer(jc, kind, i, mode, s + steps)(
            lp, jnp.asarray(x[:, start:stop]), jcache, jnp.asarray(pos))
        with torch.inference_mode():
            tx, tcache, tm = layer(
                torch.from_numpy(x[:, start:stop]), mode=mode, cache=tcache,
                positions=torch.from_numpy(pos), cache_len=s + steps)
        close(tx, jx, msg=f"{mode} at {start} output")
        for name, exp in jcache["mixer"].items():
            if name == "cursor":
                assert tcache[name] == int(exp), (start, name)
            else:
                close(tcache[name], exp, msg=f"{mode} at {start} {name}")
        if tm is None:
            assert all(float(v) == 0.0 for v in jm.values())
        else:
            check_metrics(tm, jm)
        jcache = {"mixer": jcache["mixer"]}


def test_jamba_layer_kinds_follow_the_pattern():
    """MoE on pattern slots 1, 3, 5, 7 (``moe_every=2`` counts inside the
    pattern), the dense FFN elsewhere; Mamba's float32 leaves stay float32
    in a bfloat16 model."""
    _, _, model = models(JAMBA, dtype="bfloat16")
    kinds = [(ly.kind, type(ly.ffn).__name__) for ly in model.layers]
    assert kinds == 2 * [("mamba", "MLP"), ("mamba", "MoE"),
                         ("mamba", "MLP"), ("mamba", "MoE"), ("attn", "MLP"),
                         ("mamba", "MoE"), ("mamba", "MLP"), ("mamba", "MoE")]
    mamba = model.layers[0].mixer
    assert isinstance(mamba, ssm.Mamba)
    for name in ("dt_bias", "a_log", "d_skip"):
        assert getattr(mamba, name).dtype == torch.float32, name
    assert mamba.in_proj.dtype == torch.bfloat16
    assert isinstance(model.layers[1].ffn, MoE)
    assert model.layers[1].ffn.router.dtype == torch.float32


def test_xlstm_float32_leaves_in_bf16():
    _, _, model = models(XLSTM, dtype="bfloat16")
    mlstm, slstm = model.layers[0].mixer, model.layers[3].mixer
    assert isinstance(mlstm, xlstm.MLSTM) and isinstance(slstm, xlstm.SLSTM)
    for p in (mlstm.w_gates, mlstm.b_gates, slstm.w_h, slstm.b):
        assert p.dtype == torch.float32
    assert mlstm.wq.dtype == slstm.w_x.dtype == torch.bfloat16
    assert all(ly.ffn is None for ly in model.layers)


@pytest.mark.parametrize("arch", [JAMBA, XLSTM])
def test_bf16_decode_matches_prefill(arch):
    """The reference's prefill/decode consistency check on the port in
    bfloat16 (``tests/test_models.py``: 3e-2 of the largest logit, MoE
    capacity 8 so that the prefill's per-row groups and the decode's
    batch group drop nothing)."""
    over = {"dtype": "bfloat16"}
    if arch == JAMBA:
        over["capacity_factor"] = 8.0
    _, _, model = models(arch, **over)
    b, s = 2, 48
    toks = torch.from_numpy(tokens((b, s), seed=4))
    with torch.inference_mode():
        full, _, _ = model(toks, mode="prefill", cache_len=s + 4)
        _, cache, _ = model(toks[:, :-1], mode="prefill", cache_len=s + 4)
        dec, _, aux = model(toks[:, -1:], mode="decode", cache=cache,
                            positions=torch.tensor([s - 1],
                                                   dtype=torch.int32))
    rel = float((dec[:, 0] - full[:, -1]).abs().max()
                / (full[:, -1].abs().max() + 1e-9))
    assert rel < 3e-2, rel
    assert float(aux["moe_dropped_frac"]) == 0.0


@pytest.mark.parametrize("arch", [JAMBA, XLSTM])
def test_generate_greedy_tokens_equal_jax(arch):
    jc, params, model = models(arch)
    prompts = tokens((2, 20), seed=5)
    scfg = dict(max_len=20 + 8 + 8)
    exp = jengine.Engine(jc, params, jengine.ServeConfig(**scfg)).generate(
        jnp.asarray(prompts), n_tokens=8)
    got = Engine(model, ServeConfig(**scfg)).generate(prompts, n_tokens=8)
    np.testing.assert_array_equal(got, np.asarray(exp))


@pytest.mark.parametrize("arch", [JAMBA, XLSTM])
def test_init_cache_matches_jax_layout(arch):
    check_init_cache(arch)


def test_xlstm_three_chunk_prefill_rounding_sensitivity():
    """``xlstm_three_chunks``' cache sits near its 5e-5 limit because both
    packages round, not because they compute different things: the same
    chunked prefill in float64 agrees across the packages to 1e-9 of each
    leaf's largest magnitude, and each package's float32 cache is about as
    far from the float64 one as the other's (within 2x, leaf by leaf
    worst)."""
    import dataclasses

    from torch_train_parity import jax_float64, port_float64
    from repro_torch.models.transformer import LM

    arch, over, prompt = CASES["xlstm_three_chunks"]
    jc, params, model = models(arch, **over)
    cfg, cache_len = model.cfg, prompt + 4
    toks = tokens((2, prompt + 3), prompt, cfg.vocab_size)[:, :prompt]

    def jax_prefill(jcfg, p):
        return jax.jit(lambda p, t: JT.apply_lm(
            p, jcfg, t, mode="prefill", cache_len=cache_len))(
                p, jnp.asarray(toks))[1]

    j32 = jax_prefill(jc, params)
    with jax_float64():
        j64 = jax.tree.map(np.asarray, jax_prefill(
            dataclasses.replace(jc, dtype="float64"),
            jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                         params)))
    with torch.inference_mode():
        t32 = model(torch.from_numpy(toks), mode="prefill",
                    cache_len=cache_len)[1]
    with port_float64():
        m64 = LM(cfg, torch.Generator().manual_seed(0), "cpu").double()
        m64.load_state_dict({k: v.double()
                             for k, v in model.state_dict().items()})
        with torch.inference_mode():
            t64 = m64(torch.from_numpy(toks), mode="prefill",
                      cache_len=cache_len)[1]
    far = {"jax64": 0.0, "jax32": 0.0, "port32": 0.0}
    for j, layer in enumerate(t64):
        g, i = divmod(j, cfg.group_size)
        for name, ref in layer.items():
            if name in ("cursor", "pos"):
                continue
            ref = ref.numpy()
            assert ref.dtype == np.float64, (j, name)
            scale = np.abs(ref).max()
            for tag, got in (
                    ("jax64", j64["groups"][f"layer_{i}"]["mixer"][name][g]),
                    ("jax32", j32["groups"][f"layer_{i}"]["mixer"][name][g]),
                    ("port32", t32[j][name].numpy())):
                err = np.abs(np.asarray(got, np.float64) - ref).max() / scale
                far[tag] = max(far[tag], float(err))
    print("xLSTM three-chunk prefill, worst leaf error from the port's "
          "float64 run", far)
    assert far["jax64"] <= 1e-9
    assert far["port32"] <= 2 * far["jax32"] \
        and far["jax32"] <= 2 * far["port32"], far
