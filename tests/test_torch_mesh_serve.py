"""Serving across ranks: the reference's prefill and decode cells on a mesh
against the JAX package.

gloo CPU ranks run ``tests/torch_mesh_serve_cases.py`` on meshes ``(data,
model)`` = (2, 2), (1, 4) and (2, 3) — one ``run_ranks`` call a layout,
made once a module — each rank holding its blocks of the JAX package's
weights (``params_from_jax``, then ``serve_cell(..., params=)``, which
cuts them by ``param_specs``).  The reference's cells come from ONE
subprocess with 6 forced host devices: ``make_prefill_fn`` and
``make_decode_fn`` jitted under ``logical_binding`` with
``param_shardings`` and ``cache_shardings`` (``lower_cell``'s prefill and
decode set-up, run instead of lowered).  Held in float32:

  * the prefill's last logits, gathered, to 1e-5 of the largest;
  * every cache leaf, gathered, after the prefill and after the decode
    steps, and after the decode cell alone from an empty cache (the
    rank's ``init_cache`` blocks; ``pos`` and ``cursor`` exactly; an int8
    cache within one quantization step);
  * the greedy tokens of the prefill and every decode step, exactly.

Cases: heads split (phi3 on 2x2 and 1x4: flash on each rank's local
heads), replicated attention with the sequence-sharded cache (smollm,
and with ``kv_quant``), a ring under ``window`` wrapping across the
slices (mixtral), EP decode (qwen2-moe on 2x2) and the expert-TP fallback
with one global decode group (qwen2-moe on 2x3, 6 ranks).  The serve
launcher's ``--mesh`` path runs on 2x2.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_mesh_serve_cases as C  # noqa: E402
from torch_parity import run_jax_4way  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import ShapeCell  # noqa: E402
from repro_torch.launch import cells  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.launch import serve as slaunch  # noqa: E402
from repro_torch.models.params import params_from_jax  # noqa: E402

TOL = C.TOL
TIMEOUT_S = 300


def jax_cfg(tag: str):
    arch, over = C.CASES[tag][:2]
    return dataclasses.replace(
        jconfigs.reduced_config(jconfigs.get_config(arch)), dtype="float32",
        **over)


@pytest.fixture(scope="module")
def inputs():
    params, tokens = {}, {}
    for i, (tag, case) in enumerate(C.CASES.items()):
        b, s = case[3], case[4]
        tree = jax.tree.map(np.asarray,
                            JT.init_lm(jax.random.PRNGKey(7), jax_cfg(tag)))
        params[tag] = {k: v.numpy() for k, v in
                       params_from_jax(tree, C.case_cfg(tag)).items()}
        tokens[tag] = np.random.default_rng(i).integers(
            0, 128, (b, s), dtype=np.int32)
    return {"params": params, "tokens": tokens}


@pytest.fixture(scope="module")
def ranks(inputs):
    """``layout → every rank's results``, each layout run once."""
    got = {}

    def get(layout):
        if layout not in got:
            dims = C.LAYOUTS[layout]
            got[layout] = run_ranks(
                C.rank_cases, dims[0] * dims[1], "gloo", "cpu", dims=dims,
                names=("data", "model"), args=(layout, inputs),
                timeout_s=TIMEOUT_S)
        return got[layout]
    return get


@pytest.fixture(scope="module")
def jax6(inputs):
    """The reference's serving cells on 6 host devices (a 2x2 and a 1x4
    mesh on the first 4)."""
    arrays = {f"{tag}/tokens": v for tag, v in inputs["tokens"].items()}
    return run_jax_4way(f"""
        import dataclasses
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro.configs import ShapeCell, get_config, reduced_config
        from repro.launch import cells as JC
        from repro.models import transformer as JT
        from repro.sharding import axes as am
        from repro.sharding import partition as JP

        def put(prefix, tree):
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
                key = "/".join(str(getattr(p, "key", p)) for p in path)
                out[prefix + "/" + key] = np.asarray(v)

        for tag, (arch, over, dims, b, s, clen, steps) in {C.CASES!r}.items():
            jc = dataclasses.replace(reduced_config(get_config(arch)),
                                     dtype="float32", **over)
            params = JT.init_lm(jax.random.PRNGKey(7), jc)
            mesh = make_mesh(dims, ("data", "model"))
            cell = ShapeCell(tag, clen, b, "prefill")
            rules = JC.cell_rules(jc, cell)
            batch = {{"tokens": jnp.asarray(inp[tag + "/tokens"])}}
            with am.logical_binding(mesh, rules):
                psh = JP.param_shardings(params, jc, mesh, rules)
                bspec = JP.batch_spec(mesh, rules)
                rows = NamedSharding(mesh, P(bspec[0] if len(bspec) else None))
                prefill = JC.make_prefill_fn(jc, clen)
                cshapes = jax.eval_shape(lambda p, x: prefill(p, x)[1],
                                         params, batch)
                csh = JP.cache_shardings(cshapes, jc, mesh, rules)
                logits, cache = jax.jit(
                    prefill, in_shardings=(psh, {{"tokens": rows}}),
                    out_shardings=(rows, csh))(params, batch)
                out[tag + "/logits"] = np.asarray(logits)
                put(tag + "/cache0", cache)
                jd = dataclasses.replace(jc, remat=False, mla_absorb=True)
                decode = jax.jit(
                    JC.make_decode_fn(jd),
                    in_shardings=(psh, csh, rows, NamedSharding(mesh, P())),
                    out_shardings=(rows, csh))
                tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
                toks = [tok]
                for t in range(steps):
                    tok, cache = decode(params, cache, tok[:, None],
                                        jnp.asarray([s + t], jnp.int32))
                    toks.append(tok)
                put(tag + "/cache1", cache)
                out[tag + "/tokens"] = np.stack(
                    [np.asarray(t) for t in toks], 1)
                # the decode cell as lower_cell sets it up: an empty cache
                empty = {{"groups": JT.init_cache(jd, b, clen, jnp.float32)}}
                esh = JP.cache_shardings(empty, jd, mesh, rules)
                decode = jax.jit(
                    JC.make_decode_fn(jd),
                    in_shardings=(psh, esh, rows, NamedSharding(mesh, P())),
                    out_shardings=(rows, esh))
                tok, empty = decode(params, empty, batch["tokens"][:, :1],
                                    jnp.asarray([0], jnp.int32))
                out[tag + "/init_tokens"] = np.asarray(tok)
                put(tag + "/cache2", empty)
    """, arrays, devices=6)


def _jax_cache(res: dict, prefix: str) -> dict:
    """A flattened cache saved under ``prefix`` → the nested tree."""
    tree, pre = {}, prefix + "/"
    for key, v in res.items():
        if key.startswith(pre):
            node = tree
            *path, leaf = key[len(pre):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return tree


def check_caches(got: list, jcache: dict, cfg, what: str) -> None:
    """Every layer's gathered leaves against the reference's: ``pos`` and
    ``cursor`` exactly, int8 K/V within one step, the rest to ``TOL`` of
    the largest."""
    groups = jcache["groups"]
    assert len(got) == cfg.n_layers
    for j, layer in enumerate(got):
        g, i = divmod(j, cfg.group_size)
        jm = groups[f"layer_{i}"]["mixer"]
        assert set(layer) == set(jm), (what, j, sorted(layer), sorted(jm))
        assert layer["cursor"] == int(jm["cursor"][g]), (what, j)
        np.testing.assert_array_equal(layer["pos"], jm["pos"][g])
        for name in ("k", "v", "k_s", "v_s"):
            if name not in jm:
                continue
            v, exp = layer[name], np.asarray(jm[name][g])
            assert v.shape == exp.shape and v.dtype == exp.dtype, (
                what, j, name, v.shape, exp.shape)
            if v.dtype == np.int8:
                # a value within an ulp of a rounding boundary may flip
                assert np.abs(v.astype(int) - exp.astype(int)).max() <= 1
            else:
                err = np.abs(v - exp).max()
                assert err <= TOL * np.abs(exp).max(), (what, j, name, err)


def _results(ranks, tag):
    return ranks("x".join(map(str, C.CASES[tag][2])))


@pytest.mark.parametrize("tag", list(C.CASES))
def test_prefill_logits_vs_jax(ranks, jax6, tag):
    want = jax6[f"{tag}/logits"]
    for r in _results(ranks, tag):
        got = r[tag]["logits"]
        assert got.shape == want.shape
        err = np.abs(got - want).max()
        assert err <= TOL * np.abs(want).max(), (tag, err)


@pytest.mark.parametrize("tag", list(C.CASES))
@pytest.mark.parametrize("when", [0, 1, 2], ids=[
    "after_prefill", "after_decode", "decode_cell_from_init_cache"])
def test_caches_vs_jax(ranks, jax6, tag, when):
    jcache = _jax_cache(jax6, f"{tag}/cache{when}")
    cfg = C.case_cfg(tag)
    for r in _results(ranks, tag):
        check_caches(r[tag]["caches"][when], jcache, cfg, f"{tag} {when}")


@pytest.mark.parametrize("tag", list(C.CASES))
def test_greedy_tokens_vs_jax(ranks, jax6, tag):
    for r in _results(ranks, tag):
        np.testing.assert_array_equal(r[tag]["tokens"],
                                      jax6[f"{tag}/tokens"])
        np.testing.assert_array_equal(r[tag]["init_tokens"],
                                      jax6[f"{tag}/init_tokens"])


@pytest.mark.parametrize("tag", list(C.CASES))
def test_rank_blocks_and_calls(ranks, tag):
    """Each rank's cache block is the layout ``cache_specs`` names (its
    KV heads, a slice of the length, or whole; ``pos`` replicated), the
    prefill calls the flash op once a layer on the rank's heads (all of
    them where they do not split), and a decode step's collectives are
    the layout's: a ``model`` all-reduce per TP block, a softmax merge per
    sequence-sharded layer, one vocab-split argmax."""
    arch, _, (dp, m), b, s, clen, _ = C.CASES[tag]
    cfg = C.case_cfg(tag)
    split = cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0
    h, hk = (cfg.n_heads // m, cfg.n_kv_heads // m) if split else (
        cfg.n_heads, cfg.n_kv_heads)
    seq = not split and clen % m == 0
    n = cfg.n_layers
    every = _results(ranks, tag)
    for r in every:
        got = r[tag]
        assert got["flash"] == [((b // dp, h, s, cfg.head_dim),
                                 (b // dp, hk, s, cfg.head_dim))] * n, tag
        assert got["local_k"] == (b // dp, hk, clen // m if seq else clen,
                                  cfg.head_dim), tag
        assert got["empty_k"] == got["local_k"], tag
        assert got["empty_is_cut"], tag     # init_cache's blocks: the cut
        np.testing.assert_array_equal(got["local_pos"],
                                      every[0][tag]["local_pos"])
        counts = got["step_counts"]
        assert counts.get("softmax_merge/model", 0) == (n if seq else 0)
        assert counts.get("argmax/model", 0) == (
            1 if cfg.vocab_size % m == 0 else 0)
        if split:
            assert counts["all_reduce/model"] == 2 * n, counts


def test_input_specs_and_rules_follow_the_reference():
    from repro.launch import cells as JC

    for arch in ("phi3-mini-3.8b", "qwen2-moe-a2.7b"):
        tc = tconfigs.get_config(arch)
        jc = jconfigs.get_config(arch)
        for shape in tconfigs.SHAPES.values():
            cell = ShapeCell(shape.name, shape.seq_len, shape.global_batch,
                             shape.kind)
            want = JC.input_specs(jc, jconfigs.SHAPES[shape.name])
            got = cells.input_specs(tc, cell)
            assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                    for k, v in got.items()} == \
                {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
            assert cells.cell_rules(tc, cell) == JC.cell_rules(
                jc, jconfigs.SHAPES[shape.name])


def test_sampling_and_eos_on_a_mesh(ranks, inputs):
    """At a temperature the mesh draws what one card draws from the same
    weights and generator seed (the global batch's logits, gathered); an
    EOS stop needs every rank's rows at EOS."""
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import Engine, ServeConfig

    temp, seed, n = C.SAMPLING
    tokens = inputs["tokens"]["phi3_2x2"]
    cfg = C.case_cfg("phi3_2x2")
    model = LM(cfg, torch.Generator(), "meta").to_empty(device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           inputs["params"]["phi3_2x2"].items()})
    engine = Engine(model, ServeConfig(max_len=tokens.shape[1] + n + 8,
                                       temperature=temp, eos_id=7))
    want = engine.generate(tokens, n,
                           generator=torch.Generator().manual_seed(seed))
    for r in ranks("2x2"):
        got = r["sampling"]
        np.testing.assert_array_equal(got["tokens"], want)
        assert got["stop_one_coordinate"] is False
        assert got["stop_all"] is True


def test_serve_launcher_on_a_2x2_mesh(ranks):
    """The launcher's tokens are the serving cell's by hand (seed 0, the
    engine), the same global tokens on every rank; a mesh of the wrong
    size raises ``ValueError``; MLA, Mamba, xLSTM, encoder-decoder and VLM
    configs raise ``NotImplementedError`` naming item 11b."""
    every = ranks("2x2")
    for r in every:
        got = r["launch"]
        assert got["rc"] == 0
        assert got["tokens"].shape == (4, 4)
        np.testing.assert_array_equal(got["tokens"], got["by_hand"])
        np.testing.assert_array_equal(got["tokens"],
                                      every[0]["launch"]["tokens"])
        kind, msg = got["raised"]["bad_mesh"]
        assert kind == "ValueError" and "world size is 4" in msg, msg
        for arch in C.OFF_MESH:
            kind, msg = got["raised"][arch]
            assert kind == "NotImplementedError" and "item 11b" in msg, (
                arch, kind, msg)


def test_serve_launcher_mesh_needs_a_group():
    with pytest.raises(ValueError, match="not in a process group"):
        slaunch.main(C.LAUNCH + ["--mesh", "2x2"])
