"""Workflow orchestration — the paper's separation-of-concerns layer (§VII-D/E).

The parallel program (operators) does the computing; the *workflow engine*
owns scheduling, retries, and fault tolerance (§VII-F: "we can always handle
the faults outside of the operator code").  Tasks form a DAG; completed
tasks are journaled so a crashed run resumes from the last barrier instead
of recomputing — the same contract a Pegasus/Kubeflow deployment gives the
multi-pod trainer, scaled down to one process.

Retries route through the shared
:class:`~repro_torch.resilience.FaultPolicy` (reference DESIGN.md §13.4):
transient failures back off exponentially with deterministic jitter;
typed-fatal exceptions (``ValueError``/
``TypeError``/...) fail fast instead of burning the budget on a
deterministic bug.  The journal records a content hash per completed
task (its name + dependency edges), so resuming against a *changed* DAG
is detected and refused instead of silently skipping different work.

Inside a process group (one formed in this process, or one ``torchrun``
launched it into) every rank runs the same DAG over its own shards, and
tasks may hold collectives.  Each task's outcome is the group's: a
failure on any rank is a failure on every rank, retried together under
the policy (``FaultPolicy.run(..., group=)``) or raised together as
:class:`WorkflowError`.  The journal is one file every rank sees: every
rank reads it when the engine is built (so the stale-journal refusal
fires on every rank), and rank 0 writes it once every rank finished the
task, before any rank goes on.

Also hosts the straggler monitor: per-step wall-time dispersion tracking
that a production launcher would use to evict/replace slow hosts.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from .. import telemetry
from ..core.array_ops import on_rank0
from ..resilience.policy import FaultPolicy, RetryBudgetExceeded


@dataclasses.dataclass
class Task:
    name: str
    fn: Callable[..., Any]
    deps: Sequence[str] = ()
    retries: int = 2
    policy: Optional[FaultPolicy] = None  # overrides retries/backoff
    # results of deps are passed as kwargs keyed by dep name


class WorkflowError(RuntimeError):
    pass


def _task_hash(name: str, deps: Sequence[str]) -> str:
    """Journal identity of a task: its name + dependency edges.

    Deliberately NOT the function body — a restarted process rebuilds
    the DAG with fresh closures (different bytecode addresses, same
    work), and those must still match their journal entries.
    """
    text = json.dumps([name, sorted(deps)])
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def _world_group():
    """The process group this process runs in (``None``: one process); a
    ``torchrun`` launch whose group is not formed yet raises."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD if dist.get_world_size() > 1 else None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise RuntimeError(
            "the workflow engine runs inside a process group of "
            f"WORLD_SIZE={os.environ['WORLD_SIZE']} ranks, which is not "
            "formed yet: call torch.distributed.init_process_group first")
    return None


class WorkflowEngine:
    def __init__(self, journal_path: Optional[str] = None,
                 policy: Optional[FaultPolicy] = None):
        self.group = _world_group()
        self.tasks: Dict[str, Task] = {}
        self.journal_path = journal_path
        self.policy = policy  # engine-wide default retry policy
        self._done: Dict[str, Any] = {}
        if journal_path and os.path.exists(journal_path):
            with open(journal_path) as f:
                self._done = json.load(f)

    def add(self, task: Task) -> "WorkflowEngine":
        if task.name in self.tasks:
            raise ValueError(f"duplicate task {task.name}")
        self.tasks[task.name] = task
        return self

    def _journal(self):
        """Write the journal (rank 0) before any rank goes on."""
        if not self.journal_path:
            return

        def write():
            tmp = self.journal_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self._done, f)
            os.replace(tmp, self.journal_path)

        on_rank0(write, self.group)

    def run(self, context: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Execute the DAG; returns {task: result}. Resumes past journaled
        tasks (their results must be re-derivable from ``context`` or
        checkpoints — the HPTMT contract: state lives in checkpoints, not
        in the workflow engine)."""
        results: Dict[str, Any] = dict(context or {})
        order = self._topo_order()
        rec = telemetry.current()
        for name in order:
            task = self.tasks[name]
            digest = _task_hash(name, task.deps)
            done = self._done.get(name)
            if done:
                # Dict entries carry a content hash; a mismatch means the
                # journal describes a *different* DAG (renamed deps, edited
                # edges) and silently skipping would corrupt the resume.
                # Legacy `true` entries predate hashing and skip as before.
                if isinstance(done, dict) and done.get("hash") != digest:
                    raise WorkflowError(
                        f"stale journal: task {name} was journaled with a "
                        f"different definition (hash {done.get('hash')!r} != "
                        f"{digest!r}); delete {self.journal_path} to rerun")
                if rec is not None:
                    rec.metrics.count("workflow.replayed")
                continue
            kwargs = {d: results.get(d) for d in task.deps}
            pol = task.policy or self.policy or FaultPolicy(
                max_retries=task.retries, backoff_base=0.005,
                backoff_max=0.1)
            attempts = [0]

            def call(_task=task, _kwargs=kwargs, _attempts=attempts):
                _attempts[0] += 1
                return _task.fn(**_kwargs)

            try:
                with telemetry.span(f"workflow.{name}",
                                    deps=list(task.deps)) as sp:
                    results[name] = pol.run(call, site=f"workflow.{name}",
                                            group=self.group)
                    sp.attrs["attempts"] = attempts[0]
            except RetryBudgetExceeded as e:
                raise WorkflowError(
                    f"task {name} failed after {pol.max_retries + 1} attempts"
                ) from e
            except Exception as e:  # typed-fatal: don't mask the bug class
                raise WorkflowError(
                    f"task {name} raised non-retryable "
                    f"{type(e).__name__}: {e}") from e
            finally:
                if rec is not None and attempts[0] > 1:
                    rec.metrics.count("workflow.retries", attempts[0] - 1)
            if rec is not None:
                rec.metrics.count("workflow.tasks_run")
            self._done[name] = {"hash": digest}
            self._journal()
        return results

    def _topo_order(self) -> List[str]:
        seen: Dict[str, int] = {}
        order: List[str] = []

        def visit(n: str):
            state = seen.get(n, 0)
            if state == 1:
                raise WorkflowError(f"cycle at task {n}")
            if state == 2:
                return
            seen[n] = 1
            for d in self.tasks[n].deps:
                if d not in self.tasks:
                    raise WorkflowError(f"task {n} depends on unknown {d}")
                visit(d)
            seen[n] = 2
            order.append(n)

        for n in self.tasks:
            visit(n)
        return order


class StragglerMonitor:
    """Flags steps (or peers) whose wall time exceeds k× the running median.

    On a real pod this drives re-scheduling / hot-spare swap; here it feeds
    trainer logs and is unit-tested against synthetic timings.
    """

    def __init__(self, window: int = 50, threshold: float = 2.0):
        self.window = window
        self.threshold = threshold
        self.samples: List[float] = []
        self.flagged: List[int] = []
        self._i = 0

    def record(self, seconds: float) -> bool:
        self.samples.append(seconds)
        if len(self.samples) > self.window:
            self.samples.pop(0)
        slow = False
        if len(self.samples) >= 5:
            srt = sorted(self.samples)
            median = srt[len(srt) // 2]
            slow = seconds > self.threshold * median
        if slow:
            self.flagged.append(self._i)
        self._i += 1
        return slow


class Stopwatch:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.seconds = time.perf_counter() - self.t0
