"""The port's encoder-decoder (whisper) and VLM (internvl2) serving paths
against the JAX package on the CPU.

Reduced whisper (2 encoder and 2 decoder layers, 8 stub audio frames) and
reduced internvl2 (2 layers, 8 stub patch embeddings prefixing the
prompt) in float32 with the JAX parameters, and the reference launcher's
stub embeddings (``0.02 * normal``): prefill logits, every cache leaf
(whisper's also carries the encoder output), decode logits over 3 steps
(VLM positions start after the patches), greedy tokens of
``Engine.generate``, all to 1e-5.  The encoder is non-causal and runs in
``train`` mode; with ``use_flash=True`` it takes the flash kernel's plain
version with ``causal=False``, held against JAX's Pallas interpret mode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import transformer as JT  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models.layers import Attention  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402

from torch_model_parity import (check_caches, close, frontend,  # noqa: E402
                                models, prefill_and_decode, tokens)

WHISPER, INTERNVL = "whisper-medium", "internvl2-76b"


@pytest.mark.parametrize("arch", [WHISPER, INTERNVL])
def test_prefill_and_decode_vs_jax(arch):
    jc, params, model = models(arch)
    cache = prefill_and_decode(jc, params, model, batch=2, prompt=12,
                               steps=3, cache_len=32, seed=6)
    if arch == WHISPER:
        assert cache.enc_out.shape == (2, jc.frontend_seq, jc.d_model)
    else:
        # the patches take the first frontend_seq positions of the cache
        assert cache[0]["cursor"] == jc.frontend_seq + 12 + 3
        assert cache.enc_out is None


def test_whisper_encoder_vs_jax():
    jc, params, model = models(WHISPER)
    fe = frontend(jc, 2, seed=1)
    exp = JT._encode(params, jc, jnp.asarray(fe))
    with torch.inference_mode():
        got = model.encode(torch.from_numpy(fe))
    close(got, exp)
    assert all(isinstance(ly.cross, Attention) for ly in model.layers)
    assert all(ly.cross is None for ly in model.encoder)


@pytest.mark.parametrize("arch", [WHISPER, INTERNVL])
def test_generate_greedy_tokens_equal_jax(arch):
    jc, params, model = models(arch)
    prompts = tokens((2, 20), seed=5)
    fe = frontend(jc, 2, seed=5)
    scfg = dict(max_len=20 + jc.frontend_seq + 8 + 8)
    exp = jengine.Engine(jc, params, jengine.ServeConfig(**scfg)).generate(
        jnp.asarray(prompts), n_tokens=8, frontend_embeds=jnp.asarray(fe))
    got = Engine(model, ServeConfig(**scfg)).generate(
        prompts, n_tokens=8, frontend_embeds=fe)
    np.testing.assert_array_equal(got, np.asarray(exp))


@pytest.mark.parametrize("arch", [WHISPER, INTERNVL])
def test_flash_prefill_vs_jax_pallas(arch):
    """``use_flash=True``: the Pallas kernel (interpret mode) in JAX, the
    flash kernel's plain version in the port — whisper's non-causal
    encoder and causal decoder, internvl2's patch-prefixed stream."""
    jc, params, model = models(arch, use_flash=True)
    toks = tokens((2, 16), seed=3)
    fe = frontend(jc, 2, seed=3)
    jl, jcache, _ = jax.jit(lambda p, t, f: JT.apply_lm(
        p, jc, t, mode="prefill", frontend_embeds=f, cache_len=40))(
            params, jnp.asarray(toks), jnp.asarray(fe))
    with torch.inference_mode():
        tl, tcache, _ = model(torch.from_numpy(toks), mode="prefill",
                              frontend_embeds=torch.from_numpy(fe),
                              cache_len=40)
    close(tl, jl)
    check_caches(tcache, jcache, model.cfg)


def test_serve_launcher_stubs_frontends_on_cpu(capsys):
    for arch in (WHISPER, INTERNVL):
        assert tlaunch.main(["--arch", arch, "--reduced", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "8",
                             "--gen", "4"]) == 0
        assert "generated (2, 4) on cpu" in capsys.readouterr().out
