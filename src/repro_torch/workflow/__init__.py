"""Workflow orchestration: a journaled task DAG with policy retries."""
from .engine import (StragglerMonitor, Stopwatch, Task, WorkflowEngine,
                     WorkflowError)

__all__ = ["StragglerMonitor", "Stopwatch", "Task", "WorkflowEngine",
           "WorkflowError"]
