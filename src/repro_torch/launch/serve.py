"""Serving launcher: batched prefill and decode of any configured LM.

Usage (on the card; random weights drawn from ``--seed``):
    python -m repro_torch.launch.serve --arch phi3-mini-3.8b \\
        --batch 8 --prompt-len 1024 --gen 64
On the CPU, at a reduced size:
    python -m repro_torch.launch.serve --arch phi3-mini-3.8b --reduced \\
        --device cpu --batch 4 --prompt-len 16 --gen 16
On a mesh of ranks, one process a card (``--mesh DATAxMODEL`` or
``PODxDATAxMODEL``, whose product must be the world size):
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
        --arch deepseek-67b --mesh 1x4 --batch 8 --prompt-len 1024 --gen 64
Encoder-decoder (whisper) and VLM (internvl2) configs get stub audio
frames / image patches, ``0.02 * normal`` of shape ``(batch,
frontend_seq, d_model)``, as the reference launcher makes them.

The mesh branch runs the reference's serving cells
(``launch/cells.py:serve_cell``): every rank joins the group (NCCL on the
cards, gloo with ``--device cpu``), builds the mesh, draws the model from
``--seed`` keeping its parameter blocks, and generates its rows of the
global prompts through the engine; every rank ends with the global
tokens.  Called as ``main([...])`` inside a group that already exists
(``run_ranks``), it uses that group.  Only dense and MoE GQA decoders
run on a mesh.  A group run without ``--mesh`` raises.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..core.context import refuse_in_group


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL (e.g. 1x4) or PODxDATAxMODEL")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from repro_torch.configs import ShapeCell, get_config, reduced_config
    from repro_torch.core.context import resolve_device
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    in_group = dist.is_available() and (
        dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) > 1)
    dims = [int(d) for d in (args.mesh or "1x1").split("x")]
    if args.mesh is None:
        refuse_in_group("the serving launcher without --mesh", "11b")
    elif not in_group and any(d != 1 for d in dims):
        raise ValueError(
            f"--mesh {args.mesh} needs {'x'.join(map(str, dims))} ranks; "
            f"this process is not in a process group (world size 1): "
            f"start the ranks with torchrun")
    # a VLM's image patches take cache slots ahead of the prompt
    prefix = cfg.frontend_seq if cfg.frontend == "vision" else 0
    scfg = ServeConfig(max_len=prefix + args.prompt_len + args.gen + 8,
                       temperature=args.temperature)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(1, cfg.vocab_size, (args.batch, args.prompt_len),
                           dtype=np.int32)
    fe = None
    if cfg.frontend is not None or cfg.is_encoder_decoder:
        # stub audio frames / image patches, as the reference launcher's
        fe = torch.from_numpy(0.02 * rng.normal(
            size=(args.batch, cfg.frontend_seq, cfg.d_model))).to(
                torch.float32)
    if in_group:
        from repro_torch.launch.cells import serve_cell
        from repro_torch.launch.mesh import mesh_context
        from repro_torch.launch.train import _join_group

        dev = torch.device(_join_group(args.device))
        names = (("pod", "data", "model") if len(dims) == 3
                 else ("data", "model"))[:len(dims)]
        cell = serve_cell(cfg, ShapeCell("serve", scfg.max_len, args.batch,
                                         "prefill"),
                          mesh_context(dims, names), args.seed, dev)
        with cell.binding():
            engine = Engine(cell.model, scfg)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
    else:
        dev = resolve_device(args.device)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        engine = Engine(LM(cfg, gen, dev), scfg)
    t0 = time.perf_counter()
    out = engine.generate(prompts, n_tokens=args.gen, generator=gen,
                          frontend_embeds=fe)
    dt = time.perf_counter() - t0
    main.last_tokens = out
    if not in_group or dist.get_rank() == 0:
        print(f"generated {out.shape} on {dev} in {dt:.2f}s "
              f"({out.size / dt:.0f} tok/s)"
              + (f" on a {args.mesh} mesh" if in_group else ""))
        print("serve launcher done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
