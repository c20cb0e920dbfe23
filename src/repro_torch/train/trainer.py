"""Training loop: the table-operator data pipeline feeding tensor-operator
train steps, with workflow-level fault tolerance.

Ports ``src/repro/train/trainer.py``.  The loop snapshots the whole
``TrainState`` (float32 masters, ``mu``, ``nu``, the step count) through
``CheckpointManager(async_save=True)`` — ``save`` copies the tensors off
the card before it returns, so the next steps may update them while the
files are written — and a restart resumes from the last snapshot.
Per-step wall times (the step's metrics read back on the host) feed the
straggler monitor.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from ..checkpoint.manager import CheckpointManager
from ..configs.base import ModelConfig
from ..core.context import DeviceLike, resolve_device
from ..workflow.engine import StragglerMonitor, Stopwatch
from .optimizer import OptState
from .train_step import (TrainConfig, TrainState, init_train_state,
                         make_train_step, place_state)


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None


def state_tree(state: TrainState) -> Dict[str, Any]:
    """The state as the checkpoint's tree of named tensors."""
    return {"params": state.params,
            "opt": {"mu": state.opt.mu, "nu": state.opt.nu,
                    "count": state.opt.count}}


def tree_state(tree: Dict[str, Any]) -> TrainState:
    opt = tree["opt"]
    return TrainState(tree["params"],
                      OptState(opt["mu"], opt["nu"], opt["count"]))


def train_loop(cfg: ModelConfig, tcfg: TrainConfig, loop: LoopConfig,
               batches: Iterator[Dict[str, torch.Tensor]],
               generator: Optional[torch.Generator] = None,
               state: Optional[TrainState] = None,
               log_fn: Callable[[str], None] = print,
               device: DeviceLike = None) -> TrainState:
    """Train to ``loop.total_steps`` on ``device`` (the card unless the
    caller names another); a fresh state draws its masters from
    ``generator`` (seed 0 by default) or resumes from the checkpoint
    directory's latest step."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    ckpt = (CheckpointManager(loop.checkpoint_dir, async_save=True)
            if loop.checkpoint_dir else None)

    start_step = 0
    if state is None:
        state = init_train_state(cfg, generator, dev)
        if ckpt is not None and ckpt.latest_step() is not None:
            start_step = ckpt.latest_step()
            state = place_state(tree_state(ckpt.restore(
                state_tree(state), device=dev)), dev)
            log_fn(f"[trainer] resumed from checkpoint step {start_step}")

    step_fn = make_train_step(cfg, tcfg)
    monitor = StragglerMonitor()
    history = []
    for step in range(start_step, loop.total_steps):
        batch = next(batches)
        with Stopwatch() as sw:
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])       # waits for the step
        slow = monitor.record(sw.seconds)
        history.append(loss)
        if step % loop.log_every == 0 or step == loop.total_steps - 1:
            log_fn(f"[trainer] step {step:5d} "
                   f"loss={loss:.4f} "
                   f"acc={float(metrics['accuracy']):.3f} "
                   f"lr={float(metrics['lr']):.2e} "
                   f"gnorm={float(metrics['grad_norm']):.2f} "
                   f"dt={sw.seconds * 1e3:.0f}ms"
                   + (" [straggler]" if slow else ""))
        if ckpt is not None and (step + 1) % loop.checkpoint_every == 0:
            ckpt.save(step + 1, state_tree(state))
    if ckpt is not None:
        ckpt.save(loop.total_steps, state_tree(state))
        ckpt.wait()
    train_loop.last_history = history  # introspection for tests/examples
    return state
