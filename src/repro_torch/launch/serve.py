"""Serving launcher: batched prefill and decode of any configured LM.

Usage (on the card; random weights drawn from ``--seed``):
    python -m repro_torch.launch.serve --arch phi3-mini-3.8b \\
        --batch 8 --prompt-len 1024 --gen 64
On the CPU, at a reduced size:
    python -m repro_torch.launch.serve --arch phi3-mini-3.8b --reduced \\
        --device cpu --batch 4 --prompt-len 16 --gen 16
Encoder-decoder (whisper) and VLM (internvl2) configs get stub audio
frames / image patches, ``0.02 * normal`` of shape ``(batch,
frontend_seq, d_model)``, as the reference launcher makes them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core.context import refuse_in_group


def main(argv=None):
    refuse_in_group("the serving launcher", "11b")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.context import resolve_device
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = LM(cfg, gen, dev)
    # a VLM's image patches take cache slots ahead of the prompt
    prefix = cfg.frontend_seq if cfg.frontend == "vision" else 0
    engine = Engine(model, ServeConfig(
        max_len=prefix + args.prompt_len + args.gen + 8,
        temperature=args.temperature))
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(1, cfg.vocab_size, (args.batch, args.prompt_len),
                           dtype=np.int32)
    fe = None
    if cfg.frontend is not None or cfg.is_encoder_decoder:
        # stub audio frames / image patches, as the reference launcher's
        fe = torch.from_numpy(0.02 * rng.normal(
            size=(args.batch, cfg.frontend_seq, cfg.d_model))).to(
                torch.float32)
    t0 = time.perf_counter()
    out = engine.generate(prompts, n_tokens=args.gen, generator=gen,
                          frontend_embeds=fe)
    dt = time.perf_counter() - t0
    print(f"generated {out.shape} on {dev} in {dt:.2f}s "
          f"({out.size / dt:.0f} tok/s)")
    print("serve launcher done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
