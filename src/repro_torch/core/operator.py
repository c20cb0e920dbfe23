"""Operator taxonomy and registry (paper §V, §VII).

HPTMT classifies operators along three axes:

  * **data abstraction** — ARRAY (vectors/matrices/tensors), TABLE
    (heterogeneous columns), TENSOR (model compute);
  * **style** — EAGER (whole-input → whole-output, in-memory, Cylon-like) or
    DATAFLOW (piecewise streaming, external-memory capable, Twister2-like);
  * **execution** — SPMD (same program on every shard, loosely synchronous)
    or MPMD (producer/consumer stages).

The registry makes the operator inventory introspectable.  Under an
active telemetry collector every registered operator call becomes a
``<name>`` span with its rows in and out (``telemetry.record.
operator_call``); with none active the hook is one global ``None`` check.
"""
from __future__ import annotations

import dataclasses
import enum
import functools
from typing import Callable, Dict, List

from ..telemetry import record as _telemetry


class Abstraction(enum.Enum):
    ARRAY = "array"
    TABLE = "table"
    TENSOR = "tensor"


class Style(enum.Enum):
    EAGER = "eager"
    DATAFLOW = "dataflow"


class Execution(enum.Enum):
    SPMD = "spmd"
    MPMD = "mpmd"


@dataclasses.dataclass(frozen=True)
class OperatorInfo:
    name: str
    abstraction: Abstraction
    style: Style
    execution: Execution
    distributed: bool
    doc: str
    fn: Callable


_REGISTRY: Dict[str, OperatorInfo] = {}


def operator(name: str, abstraction: Abstraction, *,
             style: Style = Style.EAGER,
             execution: Execution = Execution.SPMD,
             distributed: bool = True):
    """Decorator registering an HPTMT operator.

    Registered functions must take an ``HPTMTContext`` (keyword ``ctx``) so
    they remain independent of any global parallel runtime (principle (c)).
    """

    def wrap(fn: Callable) -> Callable:
        info = OperatorInfo(
            name=name, abstraction=abstraction, style=style,
            execution=execution, distributed=distributed,
            doc=(fn.__doc__ or "").strip().split("\n")[0], fn=fn)
        if name in _REGISTRY:
            raise ValueError(f"operator {name!r} registered twice")
        _REGISTRY[name] = info

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            # telemetry hook: ONE global check when off (the overhead
            # contract); under an active collector every registered
            # operator call becomes a span with rows in/out recorded
            if _telemetry._ACTIVE is None:
                return fn(*args, **kwargs)
            return _telemetry.operator_call(name, fn, args, kwargs)

        inner.op_info = info  # type: ignore[attr-defined]
        return inner

    return wrap


def get_operator(name: str) -> OperatorInfo:
    return _REGISTRY[name]


def list_operators(abstraction: Abstraction | None = None) -> List[OperatorInfo]:
    ops = list(_REGISTRY.values())
    if abstraction is not None:
        ops = [o for o in ops if o.abstraction is abstraction]
    return sorted(ops, key=lambda o: o.name)
