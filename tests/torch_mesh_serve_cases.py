"""What each rank runs for ``tests/test_torch_mesh_serve.py``.

``run_ranks(rank_cases, world, "gloo", "cpu", dims=..., names=("data",
"model"), args=(layout, inputs))`` spawns CPU ranks on a mesh; each
imports this module by name (so it imports no JAX) and runs the layout's
serving cases on its blocks of the JAX package's weights
(``serve_cell(..., params=...)``): a prefill, then greedy decode steps,
every cache leaf gathered after each, the flash calls' shapes and the
model collectives of one decode step.  On the 2x2 layout it also runs
the serve launcher.  Numpy copies come back from every rank.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

import torch_parity  # noqa: F401  (one intra-op thread a process)
from repro_torch import configs
from repro_torch.configs import ShapeCell
from repro_torch.core import array_ops
from repro_torch.launch import cells
from repro_torch.launch import serve as slaunch
from repro_torch.models import layers
from repro_torch.models.transformer import init_cache
from repro_torch.serve.engine import sample
from repro_torch.sharding import partition

TOL = 1e-5
#: tag → (arch, config overrides, mesh, batch, prompt, cache length,
#: decode steps).  phi3 splits its 4/4 heads over model; smollm's 3/1
#: heads do not split, so attention runs replicated and the cache is
#: sharded over its length (with an int8 cache too); mixtral's single KV
#: head likewise, its 32-slot ring wrapping from slot 31 (model rank 1's
#: slice) to 0 (rank 0's); qwen2-moe runs EP over model = 2, and on a
#: 2x3 mesh its 4 experts do not divide model = 3: the expert-TP
#: fallback with one global decode group, its ff of 96 split in three or
#: of 128 whole on every rank
CASES = {
    "phi3_2x2": ("phi3-mini-3.8b", {}, (2, 2), 4, 24, 32, 3),
    "phi3_1x4": ("phi3-mini-3.8b", {}, (1, 4), 4, 24, 32, 3),
    "smollm_2x2": ("smollm-360m", {}, (2, 2), 4, 24, 32, 3),
    "smollm_kvq_2x2": ("smollm-360m", {"kv_quant": True}, (2, 2), 4, 24,
                       32, 3),
    "mixtral_2x2": ("mixtral-8x7b", {}, (2, 2), 4, 29, 32, 5),
    "qwen2moe_2x2": ("qwen2-moe-a2.7b", {}, (2, 2), 4, 24, 32, 3),
    "qwen2moe_tp_2x3": ("qwen2-moe-a2.7b", {"moe_d_ff": 96}, (2, 3), 4, 24,
                        33, 3),
    "qwen2moe_tp_whole_2x3": ("qwen2-moe-a2.7b", {}, (2, 3), 4, 24, 33, 3),
}
LAYOUTS = {"2x2": (2, 2), "1x4": (1, 4), "2x3": (2, 3)}
#: the serve launcher's run on the 2x2 mesh: reduced smollm (bf16)
LAUNCH = ["--arch", "smollm-360m", "--reduced", "--device", "cpu",
          "--batch", "4", "--prompt-len", "12", "--gen", "4"]
#: families a mesh does not serve yet
OFF_MESH = ("minicpm3-4b", "jamba-v0.1-52b", "xlstm-125m", "whisper-medium",
            "internvl2-76b")


def case_cfg(tag: str):
    """The port's config of a case: float32, the flash op's plain
    version in prefill (the reference's own config runs ``attend``)."""
    arch, over = CASES[tag][:2]
    return dataclasses.replace(
        configs.reduced_config(configs.get_config(arch)), dtype="float32",
        use_flash=True, **over)


def _np_cache(cache) -> list:
    return [{k: v.numpy().copy() if torch.is_tensor(v) else v
             for k, v in layer.items()} for layer in cache]


def _whole_logits(cell, logits: torch.Tensor) -> np.ndarray:
    with cell.binding():
        if logits.shape[-1] != cell.cfg.vocab_size:
            logits = array_ops.axis_all_gather(logits, cell.mesh, "model",
                                               -1)
        return partition.gather_rows(logits, cell.mesh).numpy()


def serve_case(mesh, tag: str, params: dict, tokens: np.ndarray) -> dict:
    """One case on this rank: prefill, greedy decode steps, the gathered
    logits and caches, the flash calls' q/k shapes and one decode step's
    model collectives."""
    arch, over, _, b, s, cache_len, steps = CASES[tag]
    cfg = case_cfg(tag)
    cell = cells.serve_cell(cfg, ShapeCell(tag, cache_len, b, "prefill"),
                            mesh, device="cpu", params=params)
    shapes, real = [], layers.flash_ops.flash_attention

    def flash(q, k, v, **kw):
        shapes.append((tuple(q.shape), tuple(k.shape)))
        return real(q, k, v, **kw)

    layers.flash_ops.flash_attention = flash
    try:
        logits, cache = cell.prefill(
            {"tokens": cell.rows(torch.from_numpy(tokens))})
    finally:
        layers.flash_ops.flash_attention = real
    out = {"logits": _whole_logits(cell, logits), "flash": shapes,
           "caches": [_np_cache(cell.gather_cache(cache))],
           "local_k": tuple(cache[0]["k"].shape),
           "local_pos": cache[0]["pos"].numpy().copy()}
    with cell.binding(), torch.inference_mode():
        tok = sample(logits, vocab_size=cfg.vocab_size)[:, 0]
    toks = [tok]
    for t in range(steps):
        array_ops.MODEL_COLLECTIVES.reset()
        tok, cache = cell.decode(cache, tok[:, None],
                                 torch.tensor([s + t], dtype=torch.int32))
        if t == 0:
            out["step_counts"] = dict(array_ops.MODEL_COLLECTIVES.counts)
        toks.append(tok)
    out["caches"].append(_np_cache(cell.gather_cache(cache)))
    with cell.binding():
        out["tokens"] = partition.gather_rows(torch.stack(toks, 1),
                                              mesh).numpy()
    # the decode cell alone, as the reference lowers it: the first prompt
    # token against an empty cache (``init_cache``: the rank's blocks)
    empty = cell.init_cache()
    out["empty_k"] = tuple(empty[0]["k"].shape)
    whole = init_cache(cfg, b, cache_len, torch.float32, "cpu")
    cut = partition.shard_cache(whole, cell.cache_specs(empty), mesh)
    out["empty_is_cut"] = all(
        torch.equal(c[k], v) if torch.is_tensor(v) else c[k] == v
        for c, e in zip(cut, empty) for k, v in e.items())
    tok, empty = cell.decode(empty, cell.rows(torch.from_numpy(
        tokens[:, :1])), torch.tensor([0], dtype=torch.int32))
    with cell.binding():
        out["init_tokens"] = partition.gather_rows(tok, mesh).numpy()
    out["caches"].append(_np_cache(cell.gather_cache(empty)))
    return out


#: sampling on the 2x2 mesh: phi3_2x2's weights and prompts, this
#: temperature and generator seed, this many tokens
SAMPLING = (1.0, 5, 6)


def sampling_case(mesh, params: dict, tokens: np.ndarray) -> dict:
    """The engine on the mesh at a temperature (the global batch's
    logits gathered, one generator seeded alike on every rank), and its
    EOS stop agreed over the batch axes: all rows of one data coordinate
    at EOS stops no rank, all rows of both stop every rank."""
    from repro_torch.serve.engine import Engine, ServeConfig

    temp, seed, n = SAMPLING
    b, s = tokens.shape
    cell = cells.serve_cell(case_cfg("phi3_2x2"),
                            ShapeCell("t", s + n + 8, b, "prefill"), mesh,
                            device="cpu", params=params)
    with cell.binding():
        engine = Engine(cell.model, ServeConfig(max_len=s + n + 8,
                                                temperature=temp, eos_id=7))
    out = {"tokens": engine.generate(
        tokens, n, generator=torch.Generator().manual_seed(seed))}
    mine = 7 if mesh.coords["data"] == 0 else 8
    with engine._bound():
        out["stop_one_coordinate"] = engine._all_stopped(
            torch.full((b // mesh["data"], 1), mine))
        out["stop_all"] = engine._all_stopped(
            torch.full((b // mesh["data"], 1), 7))
    return out


def launcher_case(mesh) -> dict:
    """``launch.serve.main`` on this group: its tokens, the same run made
    by hand (``serve_cell`` from seed 0 and the engine), and what a mesh
    of the wrong size and the families off the mesh raise."""
    from repro_torch.serve.engine import Engine, ServeConfig

    out = {"rc": slaunch.main(LAUNCH + ["--mesh", "2x2"]),
           "tokens": slaunch.main.last_tokens}
    cfg = configs.reduced_config(configs.get_config("smollm-360m"))
    scfg = ServeConfig(max_len=12 + 4 + 8)
    cell = cells.serve_cell(cfg, ShapeCell("serve", scfg.max_len, 4,
                                           "prefill"), mesh, 0, "cpu")
    with cell.binding():
        engine = Engine(cell.model, scfg)
    prompts = np.random.default_rng(0).integers(1, cfg.vocab_size, (4, 12),
                                                dtype=np.int32)
    out["by_hand"] = engine.generate(prompts, 4)
    raised = {}
    for tag, argv in [("bad_mesh", LAUNCH + ["--mesh", "3x3"])] + [
            (arch, ["--arch", arch] + LAUNCH[2:] + ["--mesh", "2x2"])
            for arch in OFF_MESH]:
        try:
            slaunch.main(argv)
            raised[tag] = ("returned", "")
        except Exception as e:  # noqa: BLE001 — the type is the answer
            raised[tag] = (type(e).__name__, str(e))
    out["raised"] = raised
    return out


def rank_cases(mesh, layout: str, inputs: dict) -> dict:
    """One rank of ``layout``'s run."""
    out = {"coords": dict(mesh.coords)}
    for tag, case in CASES.items():
        if case[2] == LAYOUTS[layout]:
            out[tag] = serve_case(mesh, tag, inputs["params"][tag],
                                  inputs["tokens"][tag])
    if layout == "2x2":
        out["sampling"] = sampling_case(mesh, inputs["params"]["phi3_2x2"],
                                        inputs["tokens"]["phi3_2x2"])
        out["launch"] = launcher_case(mesh)
    return out
