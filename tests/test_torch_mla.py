"""The port's MLA (minicpm3) and the extended ``attend`` against the JAX
package on the CPU.

``attend`` takes the reference's ``sm_scale``, ``q_chunk`` and a value
head dim other than the query's (MLA: q/k 24, v 16 at the reduced size).
Reduced minicpm3 (2 layers of MLA, q_lora 32, kv_lora 16, rope 8) in
float32 with the JAX parameters: prefill logits, every latent-cache leaf,
decode logits over 3 steps (naive expansion and ``mla_absorb``), greedy
tokens of ``Engine.generate``, all to 1e-5 (XLA and PyTorch take exp,
sin and cos and sum in other orders, nothing else differs).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402

from torch_model_parity import (check_init_cache, close,  # noqa: E402
                                models, prefill_and_decode, tokens)

ARCH = "minicpm3-4b"

# b, hq, hkv, s, l, d, dv, sm_scale, q_chunk, causal, window, empty slots
ATTEND_CASES = [
    ("mla_shape", 2, 4, 4, 40, 40, 24, 16, 24 ** -0.5, 16, True, None, 0),
    ("gqa_scale_chunk", 2, 6, 2, 33, 33, 16, 16, 0.3, 8, True, None, 0),
    ("cache_with_empty", 1, 4, 1, 3, 20, 16, 8, None, 2, True, None, 5),
    ("cross_noncausal", 2, 4, 4, 17, 9, 16, 16, None, 5, False, None, 0),
    ("window_chunked", 1, 2, 2, 30, 30, 8, 12, None, 7, True, 6, 0),
]


@pytest.mark.parametrize("case", ATTEND_CASES, ids=lambda c: c[0])
def test_attend_vs_jax(case):
    (_, b, hq, hkv, s, l, d, dv, scale, chunk, causal, window,
     empty) = case
    rng = np.random.default_rng(len(case[0]))
    q = rng.standard_normal((b, hq, s, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, l, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, l, dv), dtype=np.float32)
    q_pos = np.arange(l - s, l, dtype=np.int32)
    kv_pos = np.arange(l, dtype=np.int32)
    kv_pos[l - empty:] = -1                 # empty cache slots
    if empty:
        q_pos = np.arange(l - empty - s, l - empty, dtype=np.int32)
    kw = dict(causal=causal, window=window, sm_scale=scale, q_chunk=chunk)
    exp = JL.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos),
                    **kw)
    got = TL.attend(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), q_pos=torch.from_numpy(q_pos),
                    kv_pos=torch.from_numpy(kv_pos), **kw)
    assert tuple(got.shape) == (b, hq, s, dv)
    close(got, exp)
    # the chunks change no row: one chunk of all queries gives the same
    whole = TL.attend(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), q_pos=torch.from_numpy(q_pos),
                      kv_pos=torch.from_numpy(kv_pos),
                      **{**kw, "q_chunk": s})
    close(got, whole, 1e-6)


@pytest.mark.parametrize("absorb", [False, True], ids=["naive", "absorb"])
def test_prefill_and_decode_vs_jax(absorb):
    """The latent cache (``c_kv``, ``k_rope``, ``pos``, ``cursor``) is
    built in prefill and written in place in decode; with a cache one
    slot short the third write clamps to the last slot, as
    ``dynamic_update_slice`` does."""
    jc, params, model = models(ARCH, mla_absorb=absorb)
    cache = prefill_and_decode(jc, params, model, batch=2, prompt=12,
                               steps=3, cache_len=14, seed=1)
    assert cache[0]["cursor"] == 15
    assert cache[0]["c_kv"].shape == (2, 14, model.cfg.kv_lora_rank)
    assert cache[0]["k_rope"].shape == (2, 1, 14, model.cfg.qk_rope_dim)


def test_absorbed_decode_matches_naive_decode():
    """The reference's own check (``tests/test_models.py``): absorbed MLA
    decode agrees with the naive expansion to 2e-2 of the largest logit;
    in float32 the two agree far closer."""
    _, _, naive = models(ARCH)
    _, _, absorbed = models(ARCH, mla_absorb=True)
    toks = torch.from_numpy(tokens((2, 24), seed=10))
    pos = torch.tensor([23], dtype=torch.int32)
    out = []
    with torch.inference_mode():
        for model in (naive, absorbed):
            _, cache, _ = model(toks[:, :-1], mode="prefill", cache_len=26)
            logits, _, _ = model(toks[:, -1:], mode="decode", cache=cache,
                                 positions=pos)
            out.append(logits)
    rel = float((out[1] - out[0]).abs().max() / out[0].abs().max())
    assert rel < 1e-5, rel


def test_generate_greedy_tokens_equal_jax():
    jc, params, model = models(ARCH)
    prompts = tokens((2, 20), seed=5)
    scfg = dict(max_len=20 + 8 + 8)
    exp = jengine.Engine(jc, params, jengine.ServeConfig(**scfg)).generate(
        jnp.asarray(prompts), n_tokens=8)
    got = Engine(model, ServeConfig(**scfg)).generate(prompts, n_tokens=8)
    np.testing.assert_array_equal(got, np.asarray(exp))


def test_init_cache_matches_jax_layout():
    check_init_cache(ARCH)


def test_mla_bf16_logits_within_model_tolerance():
    """bfloat16, where XLA may keep float32 inside fusions that PyTorch
    rounds per op: the JAX package's model tolerance, 2e-2 of the
    largest logit."""
    jc, params, model = models(ARCH, dtype="bfloat16")
    assert model.layers[0].mixer.wdq.dtype == torch.bfloat16
    toks = tokens((2, 16), seed=3)
    jl, _, _ = JT.apply_lm(params, jc, jnp.asarray(toks), mode="prefill",
                           cache_len=20)
    with torch.inference_mode():
        tl, _, _ = model(torch.from_numpy(toks), mode="prefill",
                         cache_len=20)
    exp = np.asarray(jl, np.float32)[:, -1]
    rel = np.abs(tl.numpy()[:, -1] - exp).max() / np.abs(exp).max()
    assert rel < 2e-2, rel


def test_attention_takes_kv_source():
    """Cross-attention replaces the refusal: K/V from the normed source,
    no RoPE, no cache, equal to the reference's ``gqa_attention``."""
    jc, params, model = models("phi3-mini-3.8b")
    attn = model.layers[0].mixer
    jp = jax.tree.map(lambda a: a[0], params["decoder"]["layer_0"]["mixer"])
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, jc.d_model), dtype=np.float32)
    src = rng.standard_normal((2, 7, jc.d_model), dtype=np.float32)
    pos = np.arange(5, dtype=np.int32)
    exp, ec = JL.gqa_attention(jp, jc,
                               jnp.asarray(x), positions=jnp.asarray(pos),
                               mode="train", kv_source=jnp.asarray(src),
                               causal=False)
    with torch.inference_mode():
        got, gc = attn(torch.from_numpy(x), positions=torch.from_numpy(pos),
                       kv_source=torch.from_numpy(src), causal=False)
    assert ec is None and gc is None
    close(got, exp)
