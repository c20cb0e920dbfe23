"""The port's sharding rules (``repro_torch.sharding``) against the JAX
package's (``repro.sharding``), with no devices.

For each of the ten configs at full width, on the two production meshes
(16x16 ``data x model`` and 2x16x16 ``pod x data x model``), every leaf
of the reference's ``jax.eval_shape(init_lm)`` gets its ``param_spec`` on
an ``AbstractMesh``; the port's leaves are not stacked, so each port leaf
``layers.{g * group_size + i}.…`` of a meta-device ``LM`` must carry the
reference's spec of ``decoder/layer_{i}/…`` with the leading group axis's
``None`` dropped.  The same for the decode caches (``cache_specs`` against
``cache_shardings``).  The reference's own rule cases
(``tests/test_sharding_rules.py``) run here as parametrised cases, in the
port's names.
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.sharding import axes as jaxes  # noqa: E402
from repro.sharding import partition as jpart  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import sharding  # noqa: E402
from repro_torch.models.transformer import (LM, encoder_config,  # noqa: E402
                                            init_cache)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = sorted(tconfigs.ARCHS)
CACHE_BATCH, CACHE_LEN = 64, 4096


def _meshes(key):
    """(JAX AbstractMesh, the port's mesh mapping)."""
    shape, names = MESHES[key]
    return AbstractMesh(shape, names), dict(zip(names, shape))


def _names(path):
    return tuple(str(p.key) for p in path)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = jconfigs.get_config(arch)
    tree = jax.eval_shape(lambda: JT.init_lm(jax.random.PRNGKey(0), cfg))
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    model = LM(tconfigs.get_config(arch), torch.Generator(), "meta")
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def _port_names(names, cfg):
    """The port's leaves of the reference leaf at ``names``: one per
    group of a stacked tree, else the same name with dots."""
    if names[0] not in ("decoder", "encoder"):
        return [".".join(names)], False
    scfg = cfg if names[0] == "decoder" else encoder_config(cfg)
    i = int(names[1].split("_")[1])
    dst = "layers" if names[0] == "decoder" else "encoder"
    rest = ".".join(names[2:])
    return [f"{dst}.{g * scfg.group_size + i}.{rest}"
            for g in range(scfg.n_groups)], True


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh):
    jmesh, tmesh = _meshes(mesh)
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    port = _port_params(arch)
    got = sharding.param_specs(
        {k: torch.empty(s, device="meta") for k, s in port.items()}, tcfg,
        tmesh)
    seen = set()
    for path, leaf in _ref_params(arch):
        names = _names(path)
        ref = tuple(jpart.param_spec(names, leaf.shape, jcfg, jmesh))
        keys, stacked = _port_names(names, tcfg)
        for key in keys:
            assert port[key] == tuple(leaf.shape[stacked:]), key
            assert got[key] == ref[stacked:], (key, got[key], ref)
            seen.add(key)
    assert seen == set(port), sorted(set(port) ^ seen)


@functools.lru_cache(maxsize=None)
def _ref_cache(arch):
    cfg = jconfigs.get_config(arch)
    tree = jax.eval_shape(lambda: JT.init_cache(cfg, CACHE_BATCH, CACHE_LEN,
                                                jnp.bfloat16))
    if cfg.is_encoder_decoder:  # apply_lm adds the encoder output
        tree["enc_out"] = jax.ShapeDtypeStruct(
            (CACHE_BATCH, cfg.frontend_seq, cfg.d_model), jnp.bfloat16)
    return tree


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, mesh):
    jmesh, tmesh = _meshes(mesh)
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    ref_tree = _ref_cache(arch)
    ref = jax.tree_util.tree_flatten_with_path(
        jpart.cache_shardings(ref_tree, jcfg, jmesh))[0]
    cache = init_cache(tcfg, CACHE_BATCH, CACHE_LEN, torch.bfloat16, "meta")
    if tcfg.is_encoder_decoder:
        cache.enc_out = torch.empty(ref_tree["enc_out"].shape, device="meta")
    got = sharding.cache_specs(cache, tcfg, tmesh)
    assert len(got) == tcfg.n_layers
    n_leaves = 0
    for path, shd in ref:
        names = _names(path)
        spec = tuple(shd.spec)
        if names == ("enc_out",):
            assert got.enc_out == spec
            continue
        i, leaf = int(names[0].split("_")[1]), names[-1]
        for g in range(tcfg.n_groups):
            layer = got[g * tcfg.group_size + i]
            # the leading group axis's None, where the spec has one
            assert layer[leaf] == (spec[1:] if spec else ()), (
                names, g, layer[leaf], spec)
            n_leaves += 1
    assert n_leaves == sum(len(layer) for layer in got)
    if not tcfg.is_encoder_decoder:
        assert got.enc_out is None


# the reference's rule cases (tests/test_sharding_rules.py), in the port's
# names: (arch, reference path, reference shape, expected reference spec)
RULE_CASES = {
    "wq_tp_fsdp": ("deepseek-67b", "decoder/layer_0/mixer/wq",
                   (19, 8192, 8192), (None, "data", "model")),
    "wk_flat_kv": ("deepseek-67b", "decoder/layer_0/mixer/wk",
                   (19, 8192, 1024), (None, "data", "model")),
    "wo_transposed": ("deepseek-67b", "decoder/layer_0/mixer/wo",
                      (19, 8192, 8192), (None, "model", "data")),
    "embed_d": ("deepseek-67b", "embed", (102400, 8192), (None, "model")),
    "lm_head": ("deepseek-67b", "lm_head", (8192, 102400),
                ("data", "model")),
    "moe_ep": ("jamba-v0.1-52b", "decoder/layer_1/ffn/w_gate",
               (4, 16, 4096, 14336), (None, "model", "data", None)),
    "moe_tp_fallback": ("mixtral-8x7b", "decoder/layer_0/ffn/w_gate",
                        (32, 8, 4096, 14336), (None, None, "data", "model")),
    "mamba_in_proj": ("jamba-v0.1-52b", "decoder/layer_0/mixer/in_proj",
                      (4, 4096, 16384), (None, "data", "model")),
    "mamba_a_log": ("jamba-v0.1-52b", "decoder/layer_0/mixer/a_log",
                    (4, 8192, 16), (None, "model", None)),
    "norm_replicated": ("deepseek-67b", "decoder/layer_0/mixer/norm/scale",
                        (19, 8192), (None, None)),
    "flat_heads_divide": ("smollm-360m", "decoder/layer_0/mixer/wq",
                          (32, 960, 960), (None, "data", "model")),
    "indivisible_dropped": ("deepseek-67b", "decoder/layer_0/mixer/wq",
                            (32, 8192, 1000), (None, "data", None)),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_reference_rule_cases(case):
    arch, path, shape, expected = RULE_CASES[case]
    jmesh, tmesh = _meshes("16x16")
    names = tuple(path.split("/"))
    ref = tuple(jpart.param_spec(names, shape, jconfigs.get_config(arch),
                                 jmesh))
    assert ref == expected
    keys, stacked = _port_names(names, tconfigs.get_config(arch))
    got = sharding.param_spec(keys[0], shape[stacked:],
                              tconfigs.get_config(arch), tmesh)
    assert got == expected[stacked:]


@pytest.mark.parametrize("mesh", [None, "16x16", "2x16x16"])
def test_spec_for_dedups_axes(mesh):
    jmesh, tmesh = _meshes(mesh) if mesh else (None, None)
    rules = {"batch": ("pod", "data"), "heads": "model", "fsdp": "data"}
    logical = ["batch", "heads", None, "fsdp", "ff"]
    with jaxes.logical_binding(jmesh, rules):
        ref = tuple(jaxes.spec_for(logical))
    with sharding.logical_binding(tmesh, rules):
        assert sharding.current_mesh() == tmesh
        got = sharding.spec_for(logical)
    assert got == ref
    if mesh is None:
        assert got == (("pod", "data"), "model", None, None, None)
    assert sharding.current_mesh() is None


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_spec_and_divisible(mesh):
    jmesh, tmesh = _meshes(mesh)
    assert sharding.batch_spec(tmesh) == tuple(jpart.batch_spec(jmesh))
    for n in (1, 8, 16, 24, 32, 64):
        for axis in ("data", ("pod", "data"), "model", None):
            with jaxes.logical_binding(jmesh):
                ref = jaxes.divisible(n, axis)
            with sharding.logical_binding(tmesh):
                assert sharding.divisible(n, axis) == ref, (n, axis)


def test_constrain_and_embed_lookup_unbound_and_bound():
    x = torch.arange(12.0).reshape(3, 4)
    assert sharding.constrain(x, "batch", "embed") is x
    embed = np.random.default_rng(0).normal(size=(10, 4)).astype(np.float32)
    toks = np.array([[1, 9, 0], [3, 3, 7]], np.int32)
    ref = np.asarray(jaxes.embed_lookup(jnp.asarray(embed), jnp.asarray(toks)))
    got = sharding.embed_lookup(torch.from_numpy(embed),
                                torch.from_numpy(toks).long())
    np.testing.assert_array_equal(got.numpy(), ref)
    with sharding.logical_binding({"data": 16, "model": 16}):
        # bound, constrain checks the block against the spec's: batch
        # over data's 16 ranks, embed replicated
        assert sharding.constrain(x, "batch", "embed", shape=(48, 4)) is x
        with pytest.raises(ValueError, match="places"):
            sharding.constrain(x, "batch", "embed", shape=(32, 4))
        with pytest.raises(ValueError, match="global shape"):
            sharding.constrain(x, "batch", "embed")
        # a mesh of sizes alone has no ranks to gather the table over
        with pytest.raises(TypeError, match="no process groups"):
            sharding.embed_lookup(torch.from_numpy(embed),
                                  torch.from_numpy(toks).long(), 4)
    assert sharding.constrain(x, "batch") is x


def test_new_modules_import_neither_jax_nor_reference():
    code = ("import sys\n"
            "import repro_torch.sharding, repro_torch.apps.mds\n"
            "import repro_torch.core.array_ops\n"
            "bad = [m for m in sys.modules if m == 'jax' or\n"
            "       m.startswith(('jax.', 'jaxlib')) or m == 'repro' or\n"
            "       m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "print('CLEAN')\n")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=dict(os.environ, PYTHONPATH=src),
                       timeout=120)
    assert r.returncode == 0 and "CLEAN" in r.stdout, r.stderr[-2000:]
