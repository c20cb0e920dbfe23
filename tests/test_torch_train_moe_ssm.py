"""One train step of the port against the JAX package's for the MoE
(mixtral), hybrid Mamba (jamba) and xLSTM reduced configs, the MoE
metrics of ``tests/test_train.py``, and the bf16 cast of the stacked
Mamba leaves (``tests/torch_train_parity.py`` holds the step; the dense,
MLA, encoder-decoder and VLM configs are in ``test_torch_train.py``).

jamba and xLSTM are held wider than 1e-5 of each leaf's largest
magnitude, xLSTM above the 1e-4 the port aimed for: their float32
gradients are that far from the exact ones in either package.
``test_gradient_rounding_sensitivity`` runs the same step in float64 in
both packages (the reference with x64 and its explicit float32 read as
float64): there the port's gradients equal the reference's to 1e-9, and
each package's float32 step is about as far from the float64 one as the
two float32 steps are from each other.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train import train_step as JS  # noqa: E402
from repro_torch.models.params import params_from_jax  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from torch_train_parity import (TOL, cfgs, float64_witness,  # noqa: E402
                                jax_state, port_state, step_both, tcfgs)

#: the tolerance of each config, of each leaf's largest magnitude.  The
#: worst drift measured here (CPU, float32, 2 x 40 tokens, attn_q_chunk
#: 32), grads / mu / nu: mixtral 1.7e-6 / 1.9e-6 / 3.0e-6; jamba 2.0e-5 /
#: 2.0e-5 / 3.7e-5; xLSTM 2.7e-4 / 2.8e-4 / 5.5e-4 (nu squares the
#: gradient).  From the float64 step, port32 / jax32 gradients: jamba
#: 1.5e-5 / 1.9e-5, xLSTM 3.2e-4 / 2.6e-4; port64 vs jax64 4.2e-14
#: (jamba) and 3.9e-13 (xLSTM).
HELD = {"mixtral-8x7b": TOL,
        "jamba-v0.1-52b": 1e-4,
        "xlstm-125m": 1e-3}


@pytest.mark.parametrize("arch", sorted(HELD))
def test_train_step_matches_jax(arch):
    drift, _, _ = step_both(arch, tol=HELD[arch])
    print(arch, drift)


def test_moe_metrics_present_and_dropping_bounded():
    jc, tc = cfgs("mixtral-8x7b")
    _, tt = tcfgs()
    state = port_state(jax_state(jc), tc)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, tc.vocab_size, (4, 64)).astype(np.int32))
    _, m = TS.make_train_step(tc, tt)(state, {"tokens": tokens,
                                              "labels": tokens})
    assert float(m["moe_aux_loss"]) > 0
    assert 0.0 <= float(m["moe_dropped_frac"]) < 0.5


def test_cast_params_for_compute_stacked_mamba_leaves():
    """The reference casts the stacked ``conv_b`` and ``d_skip`` (rank 2
    there) to bf16 and keeps ``dt_bias``/``a_log`` (named) and
    ``final_norm.scale`` (rank 1) in float32: leaf by leaf the same."""
    jc, tc = cfgs("jamba-v0.1-52b")
    jcast = JS.cast_params_for_compute(jax_state(jc).params, jnp.bfloat16)
    marks = params_from_jax(jax.tree.map(
        lambda a: np.full(a.shape, float(a.dtype == jnp.bfloat16),
                          np.float32), jcast), tc)
    tcast = TS.cast_params_for_compute(
        port_state(jax_state(jc), tc).params, torch.bfloat16)
    for k, m in marks.items():
        want = torch.bfloat16 if float(m.max()) else torch.float32
        assert tcast[k].dtype == want, (k, tcast[k].dtype, want)
    for k in tcast:
        leaf = k.rpartition(".")[2]
        if leaf in ("conv_b", "d_skip"):
            assert tcast[k].dtype == torch.bfloat16, k
        if leaf in ("dt_bias", "a_log") or k == "final_norm.scale":
            assert tcast[k].dtype == torch.float32, k


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-125m"])
def test_gradient_rounding_sensitivity(arch):
    """The drift is float32 rounding: in float64 the port's gradients
    equal the reference's to 1e-9 of each leaf's largest magnitude (the
    same function), and in float32 the port is no further from that
    float64 step than the reference's float32 step is, within 2x."""
    far = float64_witness(arch)
    print(arch, "from the float64 step", far)
    assert far["port64"] <= 1e-9, far
    assert far["port32"] <= 2 * far["jax32"], far
