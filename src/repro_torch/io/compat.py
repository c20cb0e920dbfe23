"""Optional pyarrow dependency gate.

pyarrow is an *optional* extra (``pip install .[io]``): the native ``.hpt``
path and every scan feature must work without it, and tier-1 collection
must never hard-fail on its absence (mirrors the hypothesis shim in
``tests/conftest.py``).

``HPTMT_DISABLE_PYARROW=1`` force-disables pyarrow even when installed —
this is how the "pyarrow absent" CI leg and local tests exercise the
fallback paths on machines that do have the package.
"""
from __future__ import annotations

import os

_DISABLE_ENV = "HPTMT_DISABLE_PYARROW"


def get_pyarrow():
    """The ``pyarrow`` module, or ``None`` when absent/disabled."""
    if os.environ.get(_DISABLE_ENV):
        return None
    try:
        import pyarrow
        return pyarrow
    except ImportError:
        return None


def has_pyarrow() -> bool:
    return get_pyarrow() is not None


def require_pyarrow(what: str):
    """Return pyarrow or raise an actionable error naming the feature."""
    pa = get_pyarrow()
    if pa is None:
        raise RuntimeError(
            f"{what} requires pyarrow, which is "
            + ("disabled via $" + _DISABLE_ENV
               if os.environ.get(_DISABLE_ENV) else "not installed")
            + " — `pip install hptmt-repro[io]` (or plain `pip install "
            "pyarrow`), or use the native .hpt format which has no "
            "dependency (repro_torch.io.native / format='hpt')")
    return pa
