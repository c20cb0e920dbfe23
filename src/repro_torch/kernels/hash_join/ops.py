"""Public entry points for the hash-join build/probe engine.

The probe walk runs the hand-written CUDA kernel for CUDA tensors and the
plain version for CPU tensors, both over the packed slot records of
:func:`slot_records` (built once per build table).  Build (contended
scatter-min with batched retries), the record gather and emit (binary
search + gather) are plain PyTorch on every device, as they are jnp
references in the JAX package.

These primitives serve three operators (reference DESIGN.md §8): join
(``build_table`` + probe), set-op membership/dedup and the groupby hash
kernel (``build_table_unique``).
"""
from __future__ import annotations

from .. import native
from . import kernel as _kernel
from . import ref as _ref

build_table = _ref.build_table
build_table_unique = _ref.build_table_unique
slot_records = _ref.slot_records
emit_lookup = _ref.emit_lookup


def probe(records, side, ph1, ph2, pkeys_u32, pvalid, max_matches: int = 1,
          max_probes: int = 64):
    """Fused probe over :func:`slot_records`' table: match counts,
    first-match registers, exhausted flags.

    Returns ``(cnt (N,) int32, rimat (N, max_matches) int32,
    exhausted (N,) bool)``.
    """
    fn = _kernel.probe_cuda if native.on_cuda(ph1) else _ref.probe_records
    return fn(records, side, ph1, ph2, pkeys_u32, pvalid, max_matches,
              max_probes)
