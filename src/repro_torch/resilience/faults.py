"""Unified chaos-injection registry (reference DESIGN.md §13.3).

One module-level registry of *armed* faults, addressed by **site** — a
dotted name for an injection point the runtime passes through::

    scan.read            per fragment-run read in ``io.scan``
    spill.write          per run-file write in ``spill.store``
    plan.step.<idx>      entry of physical plan step ``<idx>``
    checkpoint.commit    just before a stage checkpoint's atomic rename

Every site calls :func:`fire` with its name; when nothing is armed the
call is a cheap no-op (two env lookups, no allocation), so production
paths carry no chaos overhead.  An armed fault counts down ``nth``
occurrences at its site, raises (or kills the process) on the ``nth``,
then **disarms** — so a
retry under the same environment succeeds, which is exactly the contract
the retry/backoff layer is tested against.

Arming is programmatic (:func:`arm`, :func:`arm_schedule` for seeded
deterministic schedules) or via environment::

    HPTMT_FAULTS="scan.read:io_error:2;checkpoint.commit:crash:1"

The legacy ``HPTMT_SPILL_FAULT="<point>:<n>"`` knob is kept as a
back-compat alias for site ``spill.write`` (``point`` one of
``disk_full`` / ``partial_write``) with identical semantics.

Fault kinds:

  io_error       raise :class:`InjectedFault` (``EIO``) — retryable
  disk_full      raise :class:`InjectedFault` (``ENOSPC``) — retryable
  partial_write  tear a half-written ``<path>.tmp`` then raise ``EIO``
  fatal          raise :class:`FatalInjectedFault` (a ``ValueError``) —
                 the typed-fatal family, must fail fast, never retry
  crash          ``SIGKILL`` the current process (kill-and-resume tests)

Fires are counted per site (:func:`fires`) and published to an active
telemetry collector as ``fault.injected.<site>`` counters.
"""
from __future__ import annotations

import dataclasses
import errno
import os
import signal
from typing import Dict, List, Optional, Sequence, Tuple

FAULTS_ENV = "HPTMT_FAULTS"
SPILL_FAULT_ENV = "HPTMT_SPILL_FAULT"
SPILL_FAULT_POINTS = ("disk_full", "partial_write")
KINDS = ("io_error", "disk_full", "partial_write", "fatal", "crash")


class InjectedFault(OSError):
    """A chaos-injected *transient* failure (an ``OSError``): the
    retryable family — a retry after the injector disarms succeeds."""


class FatalInjectedFault(ValueError):
    """A chaos-injected *fatal* failure (a ``ValueError``): the typed
    non-retryable family — policies must fail fast, never retry."""


@dataclasses.dataclass
class _Arm:
    site: str
    kind: str
    remaining: int
    fired: bool = False


# programmatic arms + env-derived arms are tracked separately so an env
# change mid-run re-arms the env set without clobbering test-armed faults
_prog_arms: List[_Arm] = []
_env_arms: List[_Arm] = []
_env_cache: Dict[str, Optional[str]] = {"faults": None, "spill": None}
_counts: Dict[str, int] = {}


def _parse_env_faults(spec: str) -> List[_Arm]:
    arms = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        if len(bits) < 2:
            raise ValueError(
                f"{FAULTS_ENV}={spec!r}: entry {part!r} is not "
                f"'<site>:<kind>[:<nth>]'")
        site, kind = bits[0], bits[1]
        if kind not in KINDS:
            raise ValueError(f"{FAULTS_ENV}={spec!r}: unknown fault kind "
                             f"{kind!r}; expected one of {KINDS}")
        nth = int(bits[2]) if len(bits) > 2 and bits[2] else 1
        arms.append(_Arm(site, kind, nth))
    return arms


def _parse_env_spill(spec: str) -> List[_Arm]:
    point, _, count = spec.partition(":")
    if point not in SPILL_FAULT_POINTS:
        raise ValueError(
            f"{SPILL_FAULT_ENV}={spec!r}: unknown fault point {point!r}; "
            f"expected one of {SPILL_FAULT_POINTS}")
    return [_Arm("spill.write", point, int(count) if count else 1)]


def _sync_env() -> None:
    """Re-arm from the environment iff it changed since the last look —
    keeps the one-shot "fired" memory stable under an unchanged env."""
    faults = os.environ.get(FAULTS_ENV)
    spill = os.environ.get(SPILL_FAULT_ENV)
    if faults == _env_cache["faults"] and spill == _env_cache["spill"]:
        return
    _env_cache["faults"] = faults
    _env_cache["spill"] = spill
    _env_arms.clear()
    if faults:
        _env_arms.extend(_parse_env_faults(faults))
    if spill:
        _env_arms.extend(_parse_env_spill(spill))


def arm(site: str, kind: str, nth: int = 1) -> None:
    """Arm one fault: the ``nth`` future :func:`fire` at ``site`` raises
    ``kind``; the arm then disarms (one-shot)."""
    if kind not in KINDS:
        raise ValueError(f"unknown fault kind {kind!r}; "
                         f"expected one of {KINDS}")
    if nth < 1:
        raise ValueError(f"nth={nth} must be >= 1")
    _prog_arms.append(_Arm(site, kind, nth))


def arm_schedule(seed: int, sites: Sequence[str], *,
                 kinds: Sequence[str] = ("io_error",), n_faults: int = 1,
                 max_nth: int = 3) -> List[Tuple[str, str, int]]:
    """Arm a seeded deterministic schedule of ``n_faults`` faults drawn
    over ``sites`` × ``kinds``; returns the armed ``(site, kind, nth)``
    tuples so a harness can log / bound-check what it injected."""
    import numpy as np

    rng = np.random.default_rng(seed)
    armed = []
    for _ in range(n_faults):
        site = sites[int(rng.integers(len(sites)))]
        kind = kinds[int(rng.integers(len(kinds)))]
        nth = int(rng.integers(1, max_nth + 1))
        arm(site, kind, nth)
        armed.append((site, kind, nth))
    return armed


def clear() -> None:
    """Disarm everything and zero the fire counters (env stays cached:
    an unchanged env does not re-arm)."""
    _prog_arms.clear()
    _env_arms.clear()
    _counts.clear()


def reset() -> None:
    """Full reset: disarm, zero counters, and re-arm from the current
    environment on the next :func:`fire` (test fixtures call this)."""
    clear()
    _env_cache["faults"] = None
    _env_cache["spill"] = None


def fires(site: Optional[str] = None) -> int:
    """How many faults have fired (at ``site``, or in total)."""
    if site is not None:
        return _counts.get(site, 0)
    return sum(_counts.values())


def _trigger(a: _Arm, path: Optional[str]) -> None:
    _counts[a.site] = _counts.get(a.site, 0) + 1
    from .. import telemetry

    rec = telemetry.current()
    if rec is not None:
        rec.metrics.count(f"fault.injected.{a.site}")
    where = path or a.site
    if a.kind == "crash":
        os.kill(os.getpid(), signal.SIGKILL)
    if a.kind == "fatal":
        raise FatalInjectedFault(
            f"injected fatal fault at {a.site} ({where})")
    if a.kind == "disk_full":
        raise InjectedFault(errno.ENOSPC, "injected disk-full", where)
    if a.kind == "partial_write":
        if path is not None:  # tear a half-written tmp, then die mid-write
            with open(path + ".tmp", "wb") as f:
                f.write(b"HPT1\x00")
        raise InjectedFault(errno.EIO, "injected partial write", where)
    raise InjectedFault(errno.EIO, "injected io error", where)


def armed(prefix: str = "") -> bool:
    """Whether a fault not yet fired is armed at a site starting with
    ``prefix`` (programmatically or from the environment)."""
    _sync_env()
    return any(not a.fired and a.site.startswith(prefix)
               for a in _prog_arms + _env_arms)


def fire(site: str, path: Optional[str] = None) -> None:
    """Injection point: no-op unless a matching fault is armed.

    Every IO/exec layer calls this with its site name; ``path`` (when
    the site writes a file) lets ``partial_write`` tear ``<path>.tmp``
    exactly like a mid-write crash would.
    """
    _sync_env()
    if not _prog_arms and not _env_arms:
        return
    for a in _prog_arms + _env_arms:
        if a.fired or a.site != site:
            continue
        a.remaining -= 1
        if a.remaining > 0:
            return
        a.fired = True  # disarm: the retry under the same env succeeds
        _trigger(a, path)
        return
