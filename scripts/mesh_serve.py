"""Phase 31 of ``chip_smoke.py`` alone: serving across ranks.

    python3 scripts/mesh_serve.py [--seed 0]

Run from the root of a checkout on a machine with an H100 (or four). It
builds the kernels, serves smollm-360m and deepseek-67b (10 of 95
layers) on one card as phases 9 and 28 do (phase 31's yardsticks), then
runs ``chip_smoke``'s ``mesh_serve_phase``: deepseek-67b on a 1x4 mesh,
smollm-360m and qwen2-moe-a2.7b (2 of 24 layers) on 2x2, 4 spawned ranks
— NCCL with a card a rank where 4 cards exist, else gloo with every rank
on card 0 — printing one ``mesh_serve`` line a config.

On a machine with 4 cards it then serves deepseek-67b at full depth (95
layers, ~33.5 GB of bf16 weights a card) on a 1x4 NCCL mesh, a card a
rank, at phase 28's serve shape.  No one card holds that model, so
decode is held against prefill on the mesh itself: the logits of decode
step t against a prefill of the prompt and the first t generated tokens,
to 3e-2 of the largest (the reference's own tolerance); it prints
prefill ms, decode ms a token, tokens/s and peak GiB a card.  Every
check applies; a failed one raises.
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

#: decode steps whose logits are held against a prefill (full depth),
#: to the reference's own bf16 tolerance for that comparison
#: (``tests/test_models.py::test_prefill_decode_consistency``, 3e-2 of
#: the largest logit; phases 18-24 hold it too): over the 95 layers
#: step 1 read 0.0258 on four H100s (700 W)
CHECKED_STEPS = (1, 8)
DECODE_VS_PREFILL = 3e-2


def deepseek_full_rank(ctx, seed: int) -> dict:
    """One rank of the full-depth deepseek-67b run on a 1x4 mesh."""
    import torch.distributed as dist

    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.core import array_ops
    from repro_torch.launch.cells import serve_cell
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.serve.engine import Engine, ServeConfig, sample

    dev = ctx.device
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("deepseek-67b")
    b, s, n = cs.SERVE["batch"], cs.SERVE["prompt"], cs.SERVE["gen"]
    prompts = cs.serve_prompts(cfg, seed)
    t0 = time.perf_counter()
    cell = serve_cell(cfg, ShapeCell("serve", s + n + 8, b, "prefill"),
                      mesh_context((1, 4), ("data", "model")), seed, dev)
    with cell.binding():
        engine = Engine(cell.model, ServeConfig(max_len=s + n + 8))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    launches = cs.Launches()
    launches.reset()

    # decode against prefill: greedy steps from the prompt, then a
    # prefill of the prompt and the first t tokens for each checked t
    mesh, v, clen = cell.mesh, cfg.vocab_size, s + n + 8
    toks = cell.rows(torch.as_tensor(prompts, device=dev))
    step_logits, made, gaps = {}, [], {}
    with cell.binding(), torch.inference_mode():
        logits, cache, _ = cell.model(toks, mode="prefill", cache_len=clen,
                                      last_logit_only=True)
        tok = sample(logits[:, -1], vocab_size=v)
        for t in range(1, max(CHECKED_STEPS) + 1):
            made.append(tok)
            lg, cache, _ = cell.model(
                tok, mode="decode", cache=cache,
                positions=torch.tensor([s + t - 1], dtype=torch.int32,
                                       device=dev))
            if t in CHECKED_STEPS:
                step_logits[t] = lg[:, -1]
            tok = sample(lg[:, -1], vocab_size=v)
        del cache
        for t, dec in step_logits.items():
            full, _, _ = cell.model(torch.cat([toks] + made[:t], 1),
                                    mode="prefill", cache_len=clen,
                                    last_logit_only=True)
            full = full[:, -1]
            big = torch.stack([(dec - full).abs().max(), full.abs().max()])
            big = array_ops.axis_all_reduce(big, mesh, "model", "max")
            gaps[t] = float(big[0] / big[1])
    counts, _ = launches.read()

    def prefill():
        engine.prefill(prompts)
        torch.cuda.synchronize()

    pre = cs.timed_runs(prefill, 1)[0]
    t0 = time.perf_counter()
    out = engine.generate(prompts, n)
    gen = time.perf_counter() - t0
    return {"rank": dist.get_rank(), "tokens": out, "init_s": init_s,
            "decode_vs_prefill_rel": gaps, "launches": counts,
            "prefill_ms": pre * 1e3, "generate_s": gen,
            "decode_ms_per_token": (gen - pre) / (n - 1) * 1e3,
            "tokens_per_s": b * n / gen,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def deepseek_full(seed: int) -> None:
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks

    t0 = time.perf_counter()
    ranks = run_ranks(deepseek_full_rank, 4, "nccl", "cuda", args=(seed,),
                      timeout_s=1800)
    cfg = get_config("deepseek-67b")
    r0 = ranks[0]
    cs.emit("mesh_serve_full", arch="deepseek-67b", layers=cfg.n_layers,
            backend="nccl", world=4, cards=4, mesh="1x4",
            batch=cs.SERVE["batch"], prompt=cs.SERVE["prompt"],
            new_tokens=cs.SERVE["gen"],
            decode_vs_prefill_rel=[r["decode_vs_prefill_rel"] for r in ranks],
            prefill_ms=r0["prefill_ms"],
            decode_ms_per_token=r0["decode_ms_per_token"],
            tokens_per_s=r0["tokens_per_s"], generate_s=r0["generate_s"],
            peak_gib=[r["peak_gib"] for r in ranks],
            init_s=[r["init_s"] for r in ranks],
            launches=[r["launches"]["flash_attention"] for r in ranks],
            seconds=time.perf_counter() - t0)
    for r in ranks:
        np.testing.assert_array_equal(r["tokens"], r0["tokens"])
        cs.check(r["launches"]["flash_attention"]
                 == cs.flash_layers(cfg) * (1 + len(CHECKED_STEPS)),
                 f"rank {r['rank']}: flash launches {r['launches']}")
        for t, gap in r["decode_vs_prefill_rel"].items():
            cs.check(gap <= DECODE_VS_PREFILL,
                     f"decode step {t} vs prefill: {gap}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mesh_serve: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import native

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    native.library()
    cs.emit("build", seconds=time.perf_counter() - t0)
    launches = cs.Launches()
    t0 = time.perf_counter()
    yard = {"smollm": cs.serve_phase("smollm-360m", dev, args.seed, launches,
                                     False)}
    arch, depth, runs = cs.DEEPSEEK
    yard["deepseek"] = cs.serve_phase(arch, dev, args.seed, launches, False,
                                      depth, runs)
    cs.emit("yardsticks_seconds", total=time.perf_counter() - t0)
    torch.cuda.empty_cache()
    cs.mesh_serve_phase(dev, args.seed, launches, yard)
    del yard
    if torch.cuda.device_count() >= 4:
        torch.cuda.empty_cache()
        deepseek_full(args.seed)
    cs.emit("launches", **launches.total)
    cs.emit("summary", seconds=time.perf_counter() - t_start)
    return 0


if __name__ == "__main__":
    sys.exit(main())
