"""Training launcher: the HPTMT data pipeline feeding a checkpointed
train loop on one card, or a sharded train step on a mesh of ranks.

Usage (on the card; random float32 masters drawn from seed 0):
    python -m repro_torch.launch.train --arch smollm-360m --steps 20 \\
        --batch 8 --seq 1024 [--micro 4] [--ckpt DIR]
On the CPU, at a reduced size:
    python -m repro_torch.launch.train --arch smollm-360m --reduced \\
        --device cpu --steps 4 --batch 4 --seq 32
On a mesh of ranks, one process a card (``--mesh DATAxMODEL`` or
``PODxDATAxMODEL``, whose product must be the world size):
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch smollm-360m --mesh 2x2 --batch 8 --seq 1024 --steps 20

The mesh branch is the reference's: every rank joins the group (NCCL on
the cards, gloo with ``--device cpu``), builds the mesh
(``launch/mesh.py:mesh_context``), runs the data pipeline on its data
axis's sub-group (``n_shards`` = the data axis; the tables replicated
over ``model``), draws the same global masters from seed 0 and keeps its
blocks, and steps its data-parallel rows of each global batch through
``make_sharded_train_step``.  Called as ``main([...])`` inside a group
that already exists (``run_ranks``), it uses that group.  ``--ckpt``
with a mesh raises: the reference's mesh branch takes no checkpoints (it
ignores the flag), and the launcher adds no feature the reference lacks.
A sharded state is saved and restored, onto any mesh, with
``CheckpointManager.save/restore(..., shardings=(specs, mesh))``.
"""
from __future__ import annotations

import argparse
import datetime
import os
import time
from typing import Callable, NamedTuple


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL (e.g. 2x2) or PODxDATAxMODEL")
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

    import torch.distributed as dist

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core import HPTMTContext
    from repro_torch.data.pipeline import CorpusConfig, make_training_data
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import TrainConfig

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    dims = [int(d) for d in args.mesh.split("x")]
    names = (("pod", "data", "model") if len(dims) == 3
             else ("data", "model"))[:len(dims)]
    tcfg = TrainConfig(
        optimizer=OptimizerConfig(warmup_steps=max(args.steps // 20, 1),
                                  total_steps=args.steps),
        micro_batches=args.micro)
    ccfg = CorpusConfig(vocab_size=cfg.vocab_size)

    in_group = dist.is_available() and (
        dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) > 1)
    if not in_group:
        if any(d != 1 for d in dims):
            raise ValueError(
                f"--mesh {args.mesh} needs {'x'.join(map(str, dims))} ranks; "
                f"this process is not in a process group (world size 1): "
                f"start the ranks with torchrun")
        from repro_torch.train.trainer import LoopConfig, train_loop

        loop = LoopConfig(total_steps=args.steps, log_every=5,
                          checkpoint_every=max(args.steps // 2, 5),
                          checkpoint_dir=args.ckpt)
        ctx = HPTMTContext(device=args.device)
        data = make_training_data(cfg, ctx, batch=args.batch,
                                  seq_len=args.seq, ccfg=ccfg)
        train_loop(cfg, tcfg, loop, data, device=ctx.device)
        main.last_history = train_loop.last_history
    else:
        if args.ckpt is not None:
            raise NotImplementedError(
                "--ckpt with --mesh: the reference's mesh branch takes no "
                "checkpoints (it ignores the flag), so this launcher adds "
                "none; save and restore a sharded state with "
                "CheckpointManager.save/restore(..., shardings=(specs, "
                "mesh))")
        main.last_history = _mesh_loop(args, cfg, tcfg, ccfg, dims, names)
    print("train launcher done")
    return 0


def _join_group(device):
    """This rank's device; forms the group from ``torchrun``'s
    environment unless one exists (NCCL on the cards, gloo on the
    CPU)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import TIMEOUT_S, _rank_device

    if dist.is_initialized():
        if device is not None:
            return device
        return f"cuda:{torch.cuda.current_device()}"
    dev = _rank_device(device, int(os.environ.get("LOCAL_RANK",
                                                  os.environ["RANK"])))
    dist.init_process_group(
        "gloo" if torch.device(dev).type == "cpu" else "nccl",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dev


class MeshRun(NamedTuple):
    """What the mesh branch sets up on a rank (:func:`mesh_setup`)."""
    mesh: object           # sharding.axes.GroupMesh
    ctx: object            # the data axis's HPTMTContext
    data: object           # data.pipeline.TrainingData: global batches
    step: Callable         # make_sharded_train_step's step
    specs: dict            # each parameter's spec
    state: object          # this rank's TrainState blocks


def mesh_setup(cfg, tcfg, ccfg, dims, names, batch: int, seq: int,
               device, seed: int = 0) -> MeshRun:
    """The reference's mesh branch up to the loop, on this rank of the
    world group: the mesh, the data pipeline on its data axis's sub-group
    (``n_shards`` = the data axis), the sharded step, and the rank's
    blocks of the masters drawn from ``seed``.  The loop takes
    ``local_batch(next(run.data), run.mesh, micro_batches)`` a step."""
    import torch

    from repro_torch.core import HPTMTContext
    from repro_torch.data.pipeline import make_training_data
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.sharding import axes as am
    from repro_torch.train import train_step as TS

    dev = torch.device(device)
    mesh = mesh_context(dims, names)
    ctx = HPTMTContext(n_shards=mesh["data"], device=dev,
                       group=mesh.groups["data"])
    data = make_training_data(cfg, ctx, batch=batch, seq_len=seq, ccfg=ccfg)
    with am.logical_binding(mesh):
        step, sspec, _ = TS.make_sharded_train_step(cfg, tcfg, mesh,
                                                    TS.meta_state(cfg))
        state = TS.init_sharded_state(
            cfg, torch.Generator(device=dev).manual_seed(seed), mesh,
            sspec.params, dev)
    return MeshRun(mesh, ctx, data, step, sspec.params, state)


def _mesh_loop(args, cfg, tcfg, ccfg, dims, names) -> list:
    """The reference's mesh branch on this rank → the losses of its
    steps."""
    import torch.distributed as dist

    from repro_torch.sharding import axes as am
    from repro_torch.train.train_step import local_batch

    run = mesh_setup(cfg, tcfg, ccfg, dims, names, args.batch, args.seq,
                     _join_group(args.device))
    state, history = run.state, []
    with am.logical_binding(run.mesh):
        for i in range(args.steps):
            batch = local_batch(next(run.data), run.mesh, tcfg.micro_batches)
            t0 = time.perf_counter()
            state, metrics = run.step(state, batch)
            loss = float(metrics["loss"])       # waits for the step
            history.append(loss)
            if i % 5 == 0 and dist.get_rank() == 0:
                print(f"step {i} loss={loss:.4f} "
                      f"dt={(time.perf_counter() - t0) * 1e3:.0f}ms",
                      flush=True)
    return history


if __name__ == "__main__":
    raise SystemExit(main())
