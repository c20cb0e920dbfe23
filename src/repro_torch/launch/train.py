"""Training launcher: the HPTMT data pipeline feeding a checkpointed
train loop on one card.

Usage (on the card; random float32 masters drawn from seed 0):
    python -m repro_torch.launch.train --arch smollm-360m --steps 20 \\
        --batch 8 --seq 1024 [--micro 4] [--ckpt DIR]
On the CPU, at a reduced size:
    python -m repro_torch.launch.train --arch smollm-360m --reduced \\
        --device cpu --steps 4 --batch 4 --seq 32

``--mesh`` other than ``1x1`` raises: the sharded train step over a mesh
of cards is not ported yet.
"""
from __future__ import annotations

import argparse

from ..core.context import refuse_in_group


def main(argv=None):
    refuse_in_group("the training launcher", "11b")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL; only 1x1 (one card) is ported")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true",
                    help="family-preserving reduced config (CPU demo)")
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dims = [int(d) for d in args.mesh.split("x")]
    if any(d != 1 for d in dims):
        raise NotImplementedError(
            f"--mesh {args.mesh}: the sharded train step over a mesh of "
            f"cards is not ported (ROADMAP Queue 1 items 10h and 11); "
            f"run with --mesh 1x1")

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core import HPTMTContext
    from repro_torch.data.pipeline import CorpusConfig, make_training_data
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import TrainConfig
    from repro_torch.train.trainer import LoopConfig, train_loop

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    tcfg = TrainConfig(
        optimizer=OptimizerConfig(warmup_steps=max(args.steps // 20, 1),
                                  total_steps=args.steps),
        micro_batches=args.micro)
    loop = LoopConfig(total_steps=args.steps, log_every=5,
                      checkpoint_every=max(args.steps // 2, 5),
                      checkpoint_dir=args.ckpt)
    ctx = HPTMTContext(device=args.device)
    data = make_training_data(cfg, ctx, batch=args.batch, seq_len=args.seq,
                              ccfg=CorpusConfig(vocab_size=cfg.vocab_size))
    train_loop(cfg, tcfg, loop, data, device=ctx.device)
    print("train launcher done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
