"""Training across ranks: the launcher's ``--mesh DxM`` path against the
JAX package.

Four ``gloo`` CPU ranks run ``tests/torch_mesh_cases.py`` on meshes
``(data, model)`` = (2, 2), (4, 1) and (1, 4) — one ``run_ranks`` call a
layout, made once a module — and the JAX package's mesh runs come from
ONE subprocess with 4 forced host devices (the reference's
``make_sharded_train_step`` shardings around its step, with the gradient
tree it hands to ``adamw_update`` tapped, and ``moe_ffn``'s EP path under
``logical_binding``).  Held to ``TOL`` = 1e-5 of each tensor's largest
magnitude in float32:

  * ``make_sharded_train_step`` on reduced phi3 (heads divide ``model``)
    and reduced smollm (3 heads: attention gathered whole), 1 and 2
    micro-batches, both layouts: loss, accuracy, grad norm, every
    gathered master, ``mu`` and ``nu`` — against JAX's step on the same
    mesh, and against the port's own one-card step;
  * the EP MoE (reduced qwen2-moe, 4 experts on ``model`` = 2) against
    JAX's ``_moe_ffn_ep_shardmap`` — output and the three EP metrics, a
    prefill and a decode-shaped input, float32 and bf16 (2e-2 of the
    largest); the TP fallback (6 experts on ``model`` = 4) against JAX's
    einsum path, which GSPMD partitions there;
  * ``embed_lookup`` and its gradient against the plain gather, exactly;
    ``ef_allreduce_mean`` over a 4-rank ``pod`` group against JAX's;
  * ``make_training_data`` on the data axis bit for bit against the
    virtual run at that shard count; ``launch.train.main(["--mesh",
    "2x2", ...])`` against the one-card step on the same stream;
  * the model collectives' counts.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_mesh_cases as C  # noqa: E402
from torch_parity import bits, run_jax_4way  # noqa: E402
from torch_train_parity import adam_slack, close  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.train import grad_compress as JG  # noqa: E402
from repro.train import train_step as JS  # noqa: E402
from repro_torch.core import HPTMTContext  # noqa: E402
from repro_torch.data import pipeline as TP  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models.params import params_from_jax  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig  # noqa: E402

TOL = C.TOL
LAYOUTS = {"2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}
STEP_LAYOUTS = ("2x2", "4x1")
EP_TAGS = [f"ep_{shape}_{dt}" for shape in C.MOE_SHAPES
           for dt in ("f32", "bf16")]
TP_TAGS = [f"tp_{shape}_f32" for shape in C.MOE_SHAPES]
TIMEOUT_S = 300
#: the launcher trains reduced smollm in bf16 compute: its sharded losses
#: against the one-card step's, relative (summation order under bf16)
BF16_LOSS = 2e-3


def jax_cfg(name: str):
    over = {"dtype": "float32", "attn_q_chunk": 32, **C.STEP_CFGS[name]}
    return dataclasses.replace(
        jconfigs.reduced_config(jconfigs.get_config(name)), **over)


def jax_moe_cfg(**over):
    return dataclasses.replace(
        jconfigs.reduced_config(jconfigs.get_config(C.MOE_ARCH)),
        **{**C.MOE_OVER, **over})


def _flat_moe(p, n=None) -> dict:
    """The JAX MoE tree → the port's leaf names (the first ``n`` experts)."""
    out = {"norm.scale": p["norm"]["scale"], "router": p["router"]}
    for k in ("w_gate", "w_in", "w_out"):
        out[k] = p[k]
    for k, v in p.get("shared", {}).items():
        out[f"shared.{k}"] = v
    out = {k: np.asarray(v, np.float32) for k, v in out.items()}
    if n is not None:
        out["router"] = out["router"][:, :n]
        for k in ("w_gate", "w_in", "w_out"):
            out[k] = out[k][:n]
    return out


def _batch():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 128, (C.BATCH, C.SEQ)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1                           # a masked position
    return {"tokens": toks, "labels": labels}


def _x(rows, seq, d, seed):
    return np.random.default_rng(seed).standard_normal(
        (rows, seq, d), dtype=np.float32)


@pytest.fixture(scope="module")
def inputs():
    states = {}
    for name in C.STEP_CFGS:
        st = TS.train_state_from_jax(
            JS.init_train_state(jax.random.PRNGKey(7), jax_cfg(name)),
            C.step_cfg(name))
        states[name] = {"params": {k: v.numpy() for k, v in
                                   st.params.items()},
                        "mu": {k: v.numpy() for k, v in st.opt.mu.items()},
                        "nu": {k: v.numpy() for k, v in st.opt.nu.items()}}
    d = C.moe_cfg().d_model
    moe_x = {}
    for i, (shape, (rows, seq)) in enumerate(C.MOE_SHAPES.items()):
        x = _x(rows, seq, d, 10 + i)
        moe_x.update({f"ep_{shape}_f32": x, f"ep_{shape}_bf16": x})
    tp_x = {f"tp_{shape}_f32": _x(rows, seq, d, 20 + i)
            for i, (shape, (rows, seq)) in enumerate(C.MOE_SHAPES.items())}
    rng = np.random.default_rng(3)
    embed = (rng.normal(size=(64, 16)).astype(np.float32),
             rng.integers(0, 64, (8, 5)).astype(np.int32),
             rng.integers(-3, 4, (8, 5, 16)).astype(np.float32))
    ef_rng = np.random.default_rng(0)    # the reference's :127-161 data
    gs = ef_rng.normal(size=(4, 33)).astype(np.float32)
    jp = JM.init_moe(jax.random.PRNGKey(0), jax_moe_cfg())
    jp6 = JM.init_moe(jax.random.PRNGKey(0), jax_moe_cfg(n_experts=16))
    return {"states": states, "batch": _batch(), "vocab": 128,
            "moe_params": {"ep": _flat_moe(jp),
                           "tp": _flat_moe(jp6, C.TP_EXPERTS)},
            "moe_x": moe_x, "tp_x": tp_x, "embed": embed,
            "ef": (gs, np.zeros_like(gs))}


@pytest.fixture(scope="module")
def ranks(inputs):
    """``layout → every rank's results``, each layout run once."""
    cache = {}

    def get(layout):
        if layout not in cache:
            cache[layout] = run_ranks(
                C.rank_cases, 4, "gloo", "cpu", dims=LAYOUTS[layout],
                names=("data", "model"), args=(layout, inputs),
                timeout_s=TIMEOUT_S)
        return cache[layout]
    return get


@pytest.fixture(scope="module")
def jax4(inputs):
    """The reference on 4 host devices: the sharded steps and the EP MoE."""
    arrays = {f"batch/{k}": v for k, v in inputs["batch"].items()}
    arrays.update({f"moe/{k}": v for k, v in inputs["moe_x"].items()})
    return run_jax_4way(f"""
        import dataclasses
        from unittest import mock
        from repro.configs import get_config, reduced_config
        from repro.models import moe as JM
        from repro.sharding import axes as am
        from repro.train import train_step as JS
        from repro.train.optimizer import OptimizerConfig

        def put(prefix, tree):
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
                key = "/".join(str(p.key) for p in path)
                out[prefix + "/" + key] = np.asarray(v)

        batch = {{k: jnp.asarray(inp["batch/" + k])
                  for k in ("tokens", "labels")}}
        adamw = JS.adamw_update
        for name, over in {C.STEP_CFGS!r}.items():
            jc = dataclasses.replace(reduced_config(get_config(name)),
                                     dtype="float32", attn_q_chunk=32, **over)
            state0 = JS.init_train_state(jax.random.PRNGKey(7), jc)
            for dims in ((2, 2), (4, 1)):
                mesh = make_mesh(dims, ("data", "model"))
                for micro in {C.MICROS!r}:
                    jt = JS.TrainConfig(
                        optimizer=OptimizerConfig(**{C.OPT!r}),
                        micro_batches=micro)

                    def tapped(st, b):
                        seen = {{}}

                        def tap(ocfg, params, grads, opt):
                            seen["g"] = grads
                            return adamw(ocfg, params, grads, opt)

                        with mock.patch.object(JS, "adamw_update", tap):
                            res = JS.make_train_step(jc, jt)(st, b)
                        return seen["g"], res

                    state = jax.tree.map(jnp.array, state0)
                    with am.logical_binding(mesh):
                        _, sshard, bshard = JS.make_sharded_train_step(
                            jc, jt, mesh, state)
                        grads, (new, m) = jax.jit(
                            tapped, in_shardings=(sshard, bshard),
                            out_shardings=(sshard.params, (sshard, None)))(
                                state, batch)
                    tag = f"{{name}}/{{dims[0]}}x{{dims[1]}}/{{micro}}"
                    put(tag + "/grads", grads)
                    put(tag + "/params", new.params)
                    put(tag + "/mu", new.opt.mu)
                    put(tag + "/nu", new.opt.nu)
                    for k, v in m.items():
                        out[tag + "/m/" + k] = np.asarray(v)

        jmc = dataclasses.replace(reduced_config(get_config({C.MOE_ARCH!r})),
                                  **{C.MOE_OVER!r})
        mp = JM.init_moe(jax.random.PRNGKey(0), jmc)
        mesh = make_mesh((2, 2), ("data", "model"))
        ffn = jax.jit(lambda p, x: JM.moe_ffn(p, jmc, x))
        for tag in {EP_TAGS!r}:
            x = jnp.asarray(inp["moe/" + tag])
            if tag.endswith("bf16"):
                x = x.astype(jnp.bfloat16)
            with am.logical_binding(mesh):
                y, m = ffn(mp, x)
            out["moe/" + tag + "/y"] = np.asarray(y.astype(jnp.float32))
            for k, v in m.items():
                out["moe/" + tag + "/m/" + k] = np.asarray(v)
    """, arrays)


def _jax_tree(res: dict, prefix: str, tc) -> dict:
    """A flattened JAX tree saved under ``prefix`` → the port's names."""
    tree = {}
    pre = prefix + "/"
    for key, v in res.items():
        if key.startswith(pre):
            node = tree
            *path, leaf = key[len(pre):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return params_from_jax(tree, tc)


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------
STEP_CASES = [(name, layout, micro) for name in C.STEP_CFGS
              for layout in STEP_LAYOUTS for micro in C.MICROS]


def _ids(case):
    return f"{case[0].split('-')[0]}-{case[1]}-micro{case[2]}"


def _check_step(got, exp_tree, exp_metrics, jgrads, name, what, micro):
    tc = C.step_cfg(name)
    for k in ("loss", "accuracy", "grad_norm", "lr"):
        close(got["metrics"][k], exp_metrics[k], TOL, f"{what} {k}")
    assert got["count"] == 1
    lr, gnorm = float(exp_metrics["lr"]), float(exp_metrics["grad_norm"])
    ocfg = OptimizerConfig(**C.OPT)
    for kind in ("mu", "nu"):
        exp = exp_tree[kind]
        assert set(got[kind]) == set(exp), kind
        for k in exp:
            close(got[kind][k], exp[k], TOL, f"{what} {kind} {k}")
    for k, v in exp_tree["params"].items():
        close(got["params"][k], v, TOL, f"{what} master {k}",
              slack=adam_slack(jgrads[k], gnorm, ocfg, lr, TOL))
    assert set(got["params"]) == set(TS.meta_state(tc).params)


@pytest.mark.parametrize("case", STEP_CASES, ids=_ids)
def test_sharded_step_vs_jax(ranks, jax4, case):
    name, layout, micro = case
    tc = C.step_cfg(name)
    got = ranks(layout)[0]["steps"][f"{name}/{micro}"]
    assert got["bspec"] == ("data",)
    tag = f"{name}/{layout}/{micro}"
    exp = {kind: _jax_tree(jax4, f"{tag}/{kind}", tc)
           for kind in ("params", "mu", "nu")}
    metrics = {k[len(tag) + 3:]: v for k, v in jax4.items()
               if k.startswith(tag + "/m/")}
    _check_step(got, exp, metrics, _jax_tree(jax4, f"{tag}/grads", tc),
                name, f"{tag} vs jax", micro)


@pytest.mark.parametrize("case", STEP_CASES, ids=_ids)
def test_sharded_step_vs_one_card(ranks, jax4, inputs, case):
    name, layout, micro = case
    tc = C.step_cfg(name)
    g = inputs["states"][name]
    # copies: the step updates its state in place
    state = TS.place_state(TS.TrainState(
        {k: torch.tensor(v) for k, v in g["params"].items()},
        TS.OptState({k: torch.tensor(v) for k, v in g["mu"].items()},
                    {k: torch.tensor(v) for k, v in g["nu"].items()},
                    torch.tensor(0, dtype=torch.int32))), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    new, m = TS.make_train_step(tc, C.tcfg(micro))(state, batch)
    one = {"params": {k: v.detach().numpy() for k, v in new.params.items()},
           "mu": {k: v.numpy() for k, v in new.opt.mu.items()},
           "nu": {k: v.numpy() for k, v in new.opt.nu.items()}}
    tag = f"{name}/{layout}/{micro}"
    _check_step(ranks(layout)[0]["steps"][f"{name}/{micro}"], one,
                {k: float(v) for k, v in m.items()},
                _jax_tree(jax4, f"{tag}/grads", tc), name,
                f"{tag} vs one card", micro)


@pytest.mark.parametrize("layout", STEP_LAYOUTS)
def test_collective_counts(ranks, layout):
    """One ``model`` all-reduce a TP block forward (attention, MLP, MoE),
    one ``data`` gather a FSDP leaf, one ``model`` gather for the
    embedding, the MoE's three metrics meaned over ``data``; nothing over
    an axis of size 1."""
    dp, m = LAYOUTS[layout]
    for r in ranks(layout):
        for name, c in r["counts"].items():
            counts, n = c["counts"], c["layers"]
            want = {"all_gather/data": len(c["fsdp"])}
            if m > 1:
                want["all_reduce/model"] = 2 * n
                want["all_gather/model"] = 1
            if name == C.MOE_ARCH and dp > 1:
                want["all_reduce/data"] = 3 * n
            assert counts == want, (name, layout, counts)


# ---------------------------------------------------------------------------
# the MoE
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tag", EP_TAGS)
def test_ep_moe_vs_jax(ranks, jax4, tag):
    got = ranks("2x2")[0]["moe"][tag]
    tol = 2e-2 if tag.endswith("bf16") else TOL
    close(got["y"], jax4[f"moe/{tag}/y"], tol, f"{tag} y")
    for k, v in got["metrics"].items():
        close(v, jax4[f"moe/{tag}/m/{k}"], tol, f"{tag} {k}")
    assert got["counts"]["all_reduce/model"] == 1
    for r in ranks("2x2")[1:]:
        np.testing.assert_array_equal(bits(r["moe"][tag]["y"]),
                                      bits(got["y"]))


@pytest.mark.parametrize("tag", TP_TAGS)
def test_tp_fallback_moe_vs_jax_einsum(ranks, inputs, tag):
    cfg = jax_moe_cfg(n_experts=C.TP_EXPERTS)
    p = jax.tree.map(jnp.asarray, inputs["moe_params"]["tp"])
    jp = {"norm": {"scale": p["norm.scale"]}, "router": p["router"],
          "w_gate": p["w_gate"], "w_in": p["w_in"], "w_out": p["w_out"],
          "shared": {k[7:]: v for k, v in p.items()
                     if k.startswith("shared.")}}
    y, m = jax.jit(JM._moe_ffn_einsum, static_argnums=1)(
        jp, cfg, jnp.asarray(inputs["tp_x"][tag]))
    got = ranks("1x4")[0]["moe"][tag]
    close(got["y"], np.asarray(y), TOL, f"{tag} y")
    for k, v in got["metrics"].items():
        close(v, m[k], TOL, f"{tag} {k}")
    assert got["counts"] == {"all_reduce/model": 1}


# ---------------------------------------------------------------------------
# the embedding lookup, the EF all-reduce
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", STEP_LAYOUTS)
def test_embed_lookup_exact(ranks, inputs, layout):
    embed, tokens, cot = inputs["embed"]
    want = embed[tokens]
    e = torch.from_numpy(embed).requires_grad_(True)
    (grad,) = torch.autograd.grad(
        (e[torch.from_numpy(tokens).long()] * torch.from_numpy(cot)).sum(),
        [e])
    dims = LAYOUTS[layout]
    for r in ranks(layout):
        got = r["embed"]
        assert got["local_shape"] == (tokens.shape[0] // dims[0],
                                      tokens.shape[1], embed.shape[1])
        np.testing.assert_array_equal(bits(got["out"]), bits(want))
        np.testing.assert_array_equal(bits(got["grad"]), bits(grad.numpy()))


def test_ef_allreduce_over_a_pod_group(ranks, inputs):
    gs, errs = inputs["ef"]
    jr, je = jax.vmap(lambda a, b: JG.ef_allreduce_mean(a, b, "pod"),
                      axis_name="pod")(jnp.asarray(gs), jnp.asarray(errs))
    scale = np.abs(gs).max() / 127
    every = ranks("1x4")
    for i, r in enumerate(every):
        got = r["ef"]
        np.testing.assert_allclose(got["result"], np.asarray(jr)[i],
                                   atol=1e-6 * scale, rtol=0)
        np.testing.assert_allclose(got["err"], np.asarray(je)[i],
                                   atol=1e-6 * scale, rtol=0)
        np.testing.assert_array_equal(bits(got["result"]),
                                      bits(every[0]["ef"]["result"]))
    np.testing.assert_allclose(every[0]["ef"]["result"], gs.mean(0),
                               atol=4 * scale)


# ---------------------------------------------------------------------------
# the data pipeline and the launcher on a mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_training_data_on_the_data_axis(ranks, layout):
    """Every rank's stream and batches: the virtual run's at the data
    axis's shard count, bit for bit."""
    n = LAYOUTS[layout][0]
    ctx = HPTMTContext(n_shards=n, device="cpu")
    ccfg = TP.CorpusConfig(vocab_size=128)
    stream = TP.preprocess(TP.synthetic_corpus(ccfg, ctx), ccfg, ctx)
    it = TP.make_training_data(C.step_cfg("smollm-360m"), ctx, batch=4,
                               seq_len=16, ccfg=ccfg)
    batches = [next(it) for _ in range(2)]
    for r in ranks(layout):
        got = r["data"]
        np.testing.assert_array_equal(got["stream"], stream)
        for gb, b in zip(got["batches"], batches):
            for k in b:
                np.testing.assert_array_equal(gb[k], b[k].numpy())


def test_train_launcher_on_a_2x2_mesh(ranks):
    """The launcher's losses are the sharded step's on the data axis's
    stream from seed 0, bit for bit, and within bf16 rounding of the
    one-card step's on the 2-shard stream; a mesh of the wrong size and
    ``--ckpt`` raise."""
    cfg = tconfigs.reduced_config(tconfigs.get_config("smollm-360m"))
    steps = C.LAUNCH_STEPS
    tcfg = TS.TrainConfig(optimizer=OptimizerConfig(
        warmup_steps=max(steps // 20, 1), total_steps=steps))
    data = TP.make_training_data(
        cfg, HPTMTContext(n_shards=2, device="cpu"), batch=4, seq_len=32,
        ccfg=TP.CorpusConfig(vocab_size=cfg.vocab_size))
    state = TS.init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    step = TS.make_train_step(cfg, tcfg)
    one_card = []
    for _ in range(steps):
        state, m = step(state, next(data))
        one_card.append(float(m["loss"]))
    for r in ranks("2x2"):
        got = r["launch"]
        assert got["rc"] == 0
        assert got["losses"] == got["by_hand"], got
        close(np.asarray(got["losses"]), np.asarray(one_card), BF16_LOSS,
              "launcher losses vs one card (bf16 compute)")
        kind, msg = got["bad_mesh"]
        assert kind == "ValueError" and "world size is 4" in msg, msg
        kind, msg = got["ckpt"]
        assert kind == "NotImplementedError" and \
            "mesh branch takes no checkpoints" in msg and \
            "shardings=" in msg, msg


def test_mesh_coordinates_are_row_major(ranks):
    for layout, dims in LAYOUTS.items():
        for rank, r in enumerate(ranks(layout)):
            want = dict(zip(("data", "model"),
                            (int(c) for c in np.unravel_index(rank, dims))))
            assert r["coords"] == want, (layout, rank, r["coords"])


# ---------------------------------------------------------------------------
# what a mesh does not run yet
# ---------------------------------------------------------------------------
OFF_MESH = ["minicpm3-4b", "jamba-v0.1-52b", "xlstm-125m", "whisper-medium",
            "internvl2-76b"]


def _one_rank_mesh():
    """A mesh of sizes 1: bound, the model takes its mesh branch without
    any collective (nothing moves over an axis of size 1)."""
    from repro_torch.sharding.axes import GroupMesh

    return GroupMesh({"data": 1, "model": 1}, {"data": None, "model": None},
                     {"data": 0, "model": 0})


@pytest.mark.parametrize("arch", OFF_MESH)
def test_families_outside_the_slice_refuse_a_mesh(arch):
    from repro_torch.models.transformer import LM
    from repro_torch.sharding import axes as am

    cfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    model = LM(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((2, 8), dtype=torch.long)
    with am.logical_binding(_one_rank_mesh()):
        with pytest.raises(NotImplementedError, match="item 11b"):
            model(tokens, mode="train")


def test_serving_refuses_a_mesh():
    """Serving a GQA decoder runs on a mesh (its prefill on a mesh of
    sizes 1 is the unbound prefill); serving the families outside the
    slice and cross-attention still refuse, naming item 11b."""
    from repro_torch.models.transformer import LM
    from repro_torch.sharding import axes as am

    cfg = C.step_cfg("smollm-360m")
    model = LM(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((2, 8), dtype=torch.long)
    with torch.inference_mode():
        want, _, _ = model(tokens, mode="prefill", cache_len=12)
        with am.logical_binding(_one_rank_mesh()):
            logits, _, _ = model(tokens, mode="train")
            assert logits.shape == (2, 8, cfg.vocab_size)
            got, cache, _ = model(tokens, mode="prefill", cache_len=12)
            np.testing.assert_array_equal(bits(got.numpy()),
                                          bits(want.numpy()))
            assert cache[0]["k"].shape == (2, cfg.n_kv_heads, 12,
                                           cfg.head_dim)
            attn = model.layers[0].mixer
            with pytest.raises(NotImplementedError, match="item 11b"):
                attn(torch.zeros((2, 8, cfg.d_model)),
                     positions=torch.arange(8), kv_source=torch.zeros(
                         (2, 4, cfg.d_model)))
    mla = tconfigs.reduced_config(tconfigs.get_config("minicpm3-4b"))
    with am.logical_binding(_one_rank_mesh()):
        with pytest.raises(NotImplementedError, match="item 11b"):
            LM(mla, torch.Generator().manual_seed(0), "cpu")(
                tokens, mode="prefill")
