"""What each rank runs for ``tests/test_torch_mesh_train.py``.

``run_ranks(rank_cases, 4, "gloo", "cpu", dims=..., names=("data",
"model"), args=(layout, inputs))`` spawns four CPU ranks on a mesh; each
imports this module by name (so it imports no JAX) and runs the layout's
cases on its blocks: the sharded train step from a global state the test
process took from the JAX package, the MoE on ``model``, the embedding
lookup, the collectives' counts, the data pipeline on the data axis and
the training launcher.  Global results (gathered) come back from rank 0;
what must agree across ranks comes back from every rank.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

import torch_parity  # noqa: F401  (one intra-op thread a process)
from repro_torch import configs
from repro_torch.core import HPTMTContext, array_ops
from repro_torch.data import pipeline as TP
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import mesh_context
from repro_torch.models import moe as TM
from repro_torch.sharding import axes as am
from repro_torch.sharding import partition
from repro_torch.train import grad_compress as TG
from repro_torch.train import train_step as TS
from repro_torch.train.optimizer import OptimizerConfig

TOL = 1e-5
#: a step from init: warm-up of 2 (``tests/torch_train_parity.py``)
OPT = dict(warmup_steps=2, total_steps=20)
#: the sharded steps' configs: reduced phi3 as the reference's
#: ``test_distributed.py:97-99`` sizes it (heads divide the model axis)
#: and reduced smollm (3 heads, 1 kv head: attention gathered whole)
STEP_CFGS = {"phi3-mini-3.8b": dict(d_model=64, n_heads=4, n_kv_heads=4,
                                    d_ff=128),
             "smollm-360m": {}}
MICROS = (1, 2)
BATCH, SEQ = 8, 40
#: the reference's ``test_distributed.py:217-219`` MoE
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_OVER = dict(n_experts=4, experts_per_token=2, capacity_factor=8.0)
#: (rows, seq): a prefill (row groups) and a decode-shaped input (S < 64:
#: one group of the local rows)
MOE_SHAPES = {"prefill": (4, 128), "decode": (4, 8)}
#: the TP fallback: 6 experts on a 4-way model axis
TP_EXPERTS = 6
#: the launcher's run: reduced smollm (bf16 compute), 3 steps
LAUNCH_STEPS = 3
LAUNCH = ["--arch", "smollm-360m", "--reduced", "--device", "cpu",
          "--steps", str(LAUNCH_STEPS), "--batch", "4", "--seq", "32"]


def step_cfg(name: str):
    over = {"dtype": "float32", "attn_q_chunk": 32, **STEP_CFGS[name]}
    return dataclasses.replace(
        configs.reduced_config(configs.get_config(name)), **over)


def moe_cfg(dtype: str = "float32", **over):
    return dataclasses.replace(
        configs.reduced_config(configs.get_config(MOE_ARCH)),
        dtype=dtype, **{**MOE_OVER, **over})


def tcfg(micro: int):
    return TS.TrainConfig(optimizer=OptimizerConfig(**OPT),
                          micro_batches=micro)


def _np(tree):
    return {k: v.detach().cpu().numpy().copy() for k, v in tree.items()}


def _rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every DP rank's rows, in order (no gradient)."""
    for a in reversed(am.batch_axes()):
        x = array_ops.axis_all_gather(x.detach(), mesh, a)
    return x


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------
def step_cases(mesh, states, batch) -> dict:
    """Each config's step from the global state, 1 and 2 micro-batches →
    the gathered new state and the metrics."""
    out = {}
    for name in STEP_CFGS:
        cfg = step_cfg(name)
        g = states[name]
        full = TS.TrainState(
            {k: torch.from_numpy(v) for k, v in g["params"].items()},
            TS.OptState({k: torch.from_numpy(v) for k, v in g["mu"].items()},
                        {k: torch.from_numpy(v) for k, v in g["nu"].items()},
                        torch.tensor(0, dtype=torch.int32)))
        for micro in MICROS:
            with am.logical_binding(mesh):
                step, sspec, bspec = TS.make_sharded_train_step(
                    cfg, tcfg(micro), mesh, TS.meta_state(cfg))
                state = TS.shard_state(full, sspec.params, mesh, "cpu")
                tb = TS.local_batch({k: torch.from_numpy(v)
                                     for k, v in batch.items()}, mesh, micro)
                new, m = step(state, tb)
                got = TS.gather_state(new, sspec.params, mesh)
            out[f"{name}/{micro}"] = {
                "params": _np(got.params), "mu": _np(got.opt.mu),
                "nu": _np(got.opt.nu), "count": int(new.opt.count),
                "metrics": {k: float(v) for k, v in m.items()},
                "bspec": bspec}
    return out


def collective_counts(mesh) -> dict:
    """The model collectives of one no-grad forward of reduced phi3 and
    of reduced qwen2-moe, and the leaves they gather."""
    out = {}
    for name, cfg in (("phi3-mini-3.8b", step_cfg("phi3-mini-3.8b")),
                      (MOE_ARCH, moe_cfg())):
        with am.logical_binding(mesh):
            _, sspec, _ = TS.make_sharded_train_step(
                cfg, tcfg(1), mesh, TS.meta_state(cfg))
            state = TS.init_sharded_state(cfg, torch.Generator().manual_seed(0),
                                          mesh, sspec.params, "cpu")
            model = TS.bind(TS.sharded_model(cfg, sspec.params), state.params)
            tokens = torch.zeros((BATCH // mesh["data"], SEQ), dtype=torch.long)
            array_ops.MODEL_COLLECTIVES.reset()
            with torch.no_grad():
                model(tokens, mode="train")
            out[name] = {"counts": dict(array_ops.MODEL_COLLECTIVES.counts),
                         "fsdp": sorted(model.fsdp), "layers": cfg.n_layers}
    return out


# ---------------------------------------------------------------------------
# the MoE on a mesh
# ---------------------------------------------------------------------------
def moe_module(cfg, full: dict, mesh) -> TM.MoE:
    """The port's MoE holding this rank's ``model`` blocks of the global
    leaves ``full`` (FSDP already gathered, as the layer sees them)."""
    moe = TM.MoE(cfg, torch.Generator(), torch.float32, torch.device("cpu"))
    for name, v in full.items():
        spec = partition.param_spec(f"layers.0.ffn.{name}", v.shape, cfg,
                                    mesh)
        spec = tuple(None if e == "data" else e for e in spec)
        owner, _, leaf = name.rpartition(".")
        setattr(moe.get_submodule(owner), leaf, torch.nn.Parameter(
            partition.shard_tensor(torch.from_numpy(v), spec, mesh)
            .contiguous(), requires_grad=False))
    return moe


def moe_cases(mesh, params: dict, xs: dict) -> dict:
    """The EP MoE (or the TP fallback) on this rank's rows of each input
    → the gathered output and the metrics."""
    out = {}
    for tag, x in xs.items():
        dtype = "bfloat16" if tag.endswith("bf16") else "float32"
        kind = tag.split("_")[0]
        cfg = moe_cfg(dtype, **({"n_experts": TP_EXPERTS} if kind == "tp"
                                else {}))
        moe = moe_module(cfg, params[kind], mesh)
        xt = TS.local_batch({"x": torch.from_numpy(x)}, mesh)["x"]
        with am.logical_binding(mesh), torch.no_grad():
            array_ops.MODEL_COLLECTIVES.reset()
            y, m = moe(xt.to(getattr(torch, dtype)))
            counts = dict(array_ops.MODEL_COLLECTIVES.counts)
            y = _rows(y, mesh)
        out[tag] = {"y": y.float().numpy(),
                    "metrics": {k: float(v) for k, v in m.items()},
                    "counts": counts}
    return out


# ---------------------------------------------------------------------------
# the embedding lookup, the EF all-reduce
# ---------------------------------------------------------------------------
def embed_case(mesh, embed: np.ndarray, tokens: np.ndarray,
               cot: np.ndarray) -> dict:
    """``embed_lookup`` on this rank's block and rows; its gradient under
    an integer cotangent (sums exact in any order), summed over the DP
    axes and gathered whole."""
    full = torch.from_numpy(embed)
    spec = (None, "model") if embed.shape[1] % mesh["model"] == 0 \
        else (None, None)
    block = partition.shard_tensor(full, spec, mesh).clone() \
        .requires_grad_(True)
    toks = TS.local_batch({"t": torch.from_numpy(tokens)}, mesh)["t"]
    c = TS.local_batch({"c": torch.from_numpy(cot)}, mesh)["c"]
    with am.logical_binding(mesh):
        out = am.embed_lookup(block, toks.long(), embed.shape[1])
        (g,) = torch.autograd.grad((out * c).sum(), [block])
        for a in am.batch_axes():
            g = array_ops.axis_all_reduce(g, mesh, a)
        g = partition.gather_tensor(g, spec, mesh)
        rows = _rows(out, mesh)
    return {"out": rows.numpy(), "grad": g.numpy(),
            "local_shape": tuple(out.shape)}


def ef_case(x: np.ndarray, err: np.ndarray) -> dict:
    """``ef_allreduce_mean`` over a 4-rank ``pod`` axis: each rank passes
    its row of ``x`` and ``err``."""
    pod = mesh_context((4,), ("pod",))
    i = pod.coords["pod"]
    with am.logical_binding(pod):
        res, new_err = TG.ef_allreduce_mean(torch.from_numpy(x[i]),
                                            torch.from_numpy(err[i]), "pod")
    return {"result": res.numpy(), "err": new_err.numpy()}


# ---------------------------------------------------------------------------
# the data pipeline and the launcher on the mesh
# ---------------------------------------------------------------------------
def data_case(mesh, vocab: int) -> dict:
    """``make_training_data`` on the data axis's sub-group: the curated
    stream and two global batches."""
    ctx = HPTMTContext(n_shards=mesh["data"], device="cpu",
                       group=mesh.groups["data"])
    ccfg = TP.CorpusConfig(vocab_size=vocab)
    stream = TP.preprocess(TP.synthetic_corpus(ccfg, ctx), ccfg, ctx)
    it = TP.make_training_data(step_cfg("smollm-360m"), ctx, batch=4,
                               seq_len=16, ccfg=ccfg)
    batches = [{k: v.numpy() for k, v in next(it).items()} for _ in range(2)]
    return {"stream": stream, "batches": batches}


def launcher_case(mesh, argv) -> dict:
    """``launch.train.main`` in this group: its losses, the same run made
    by hand (pipeline on the data axis, the seed-0 init, the sharded
    step) and what a mesh of the wrong size and ``--ckpt`` raise."""
    out = {"rc": tlaunch.main(argv), "losses": tlaunch.main.last_history}
    cfg = configs.reduced_config(configs.get_config("smollm-360m"))
    steps = LAUNCH_STEPS
    tc = TS.TrainConfig(optimizer=OptimizerConfig(
        warmup_steps=max(steps // 20, 1), total_steps=steps))
    ctx = HPTMTContext(n_shards=mesh["data"], device="cpu",
                       group=mesh.groups["data"])
    data = TP.make_training_data(cfg, ctx, batch=4, seq_len=32,
                                 ccfg=TP.CorpusConfig(vocab_size=128))
    out["by_hand"] = []
    with am.logical_binding(mesh):
        step, sspec, _ = TS.make_sharded_train_step(cfg, tc, mesh,
                                                    TS.meta_state(cfg))
        state = TS.init_sharded_state(cfg, torch.Generator().manual_seed(0),
                                      mesh, sspec.params, "cpu")
        for _ in range(steps):
            state, m = step(state, TS.local_batch(next(data), mesh))
            out["by_hand"].append(float(m["loss"]))
    for tag, extra in (("bad_mesh", ["--mesh", "3x3"]),
                       ("ckpt", argv[-2:] + ["--ckpt", "/nonexistent"])):
        try:
            tlaunch.main(LAUNCH + extra)
            out[tag] = ("returned", "")
        except Exception as e:  # noqa: BLE001 — the type is the answer
            out[tag] = (type(e).__name__, str(e))
    return out


def rank_cases(mesh, layout: str, inputs: dict) -> dict:
    """One rank of ``layout``'s run."""
    out = {"coords": dict(mesh.coords),
           "data": data_case(mesh, inputs["vocab"])}
    if layout in ("2x2", "4x1"):
        out["steps"] = step_cases(mesh, inputs["states"], inputs["batch"])
        out["counts"] = collective_counts(mesh)
        out["embed"] = embed_case(mesh, *inputs["embed"])
    if layout == "2x2":
        out["moe"] = moe_cases(mesh, inputs["moe_params"], inputs["moe_x"])
        out["launch"] = launcher_case(mesh, LAUNCH + ["--mesh", "2x2"])
    if layout == "1x4":
        out["moe"] = moe_cases(mesh, inputs["moe_params"], inputs["tp_x"])
        out["ef"] = ef_case(*inputs["ef"])
    if mesh.coords != {a: 0 for a in mesh}:
        out.pop("steps", None)
    return out
