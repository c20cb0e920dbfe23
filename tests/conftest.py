"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests see 1 device;
multi-device behaviour is exercised via subprocesses (test_distributed.py)."""
import os
import sys

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
if SRC not in sys.path:
    sys.path.insert(0, os.path.abspath(SRC))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs a hand-written CUDA kernel on the card; "
        "skips where no CUDA device is available")


@pytest.fixture(scope="session")
def rng():
    import jax
    return jax.random.PRNGKey(0)


# ---------------------------------------------------------------------------
# hypothesis fallback: when the package is missing, property tests skip but
# the rest of the module still collects and runs (tier-1 must never hard-fail
# on an optional dependency).  Test modules do
# ``try: from hypothesis import ... except ImportError: from conftest import ...``.
# ---------------------------------------------------------------------------
class _AbsentStrategies:
    """Stands in for ``hypothesis.strategies``; builds inert placeholders."""

    def __getattr__(self, _name):
        return lambda *a, **k: None


st = _AbsentStrategies()


def given(*_args, **_kwargs):
    return pytest.mark.skip(reason="hypothesis not installed")


def settings(*_args, **_kwargs):
    return lambda fn: fn


# ---------------------------------------------------------------------------
# pyarrow fallback (mirrors the hypothesis shim): pyarrow is the optional
# [io] extra — Arrow/Parquet tests skip when it is missing (or disabled via
# HPTMT_DISABLE_PYARROW=1, the "absent" CI leg), while the native .hpt
# storage tests always run.  Tier-1 collection never hard-fails on it.
# ---------------------------------------------------------------------------
def _pyarrow_available() -> bool:
    try:
        from repro.io.compat import has_pyarrow
    except ImportError:
        return False
    return has_pyarrow()


HAS_PYARROW = _pyarrow_available()

requires_pyarrow = pytest.mark.skipif(
    not HAS_PYARROW,
    reason="pyarrow not installed/disabled (optional [io] extra)")
