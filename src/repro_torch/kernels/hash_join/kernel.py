"""Wrapper of the CUDA probe kernel (``csrc/probe.cu``).

Replaces the TPU kernel ``probe_pallas``
(``src/repro/kernels/hash_join/kernel.py``).  The walk is bound by the
card's rate of random reads from a slot table far larger than L2, so the
kernel reads one aligned record per visited slot (``ref.slot_records``:
16 bytes ``{row, h2, k0, k1}`` for keys of up to two lanes, one sector a
visit where the three-array layout cost up to three dependent ones; 8
bytes ``{row, h2}`` plus a side array of key lanes for wider keys) and
runs one thread per probe row with no shared memory, each stopping at its
own first empty slot (see the source).  Unlike the TPU kernel it has no
table-size cap: the table stays in device memory.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.array_ops import Counter
from .. import native
from .ref import RECORD_LANES

#: launches of the kernel
LAUNCHES = Counter()


def probe_cuda(records: torch.Tensor, side: Optional[torch.Tensor],
               ph1: torch.Tensor, ph2: torch.Tensor, pkeys_u32: torch.Tensor,
               pvalid: torch.Tensor, max_matches: int = 1,
               max_probes: int = 64):
    """Same contract as ``ref.probe_records``, on CUDA tensors;
    bit-identical."""
    dev = ph1.device
    if dev.type != "cuda":
        raise ValueError(f"probe_cuda needs CUDA tensors, got {dev}")
    slots = records.shape[0]
    if slots < 1 or slots & (slots - 1):
        raise ValueError(f"slot count {slots} is not a power of two")
    if max_matches < 1:
        raise ValueError(f"max_matches={max_matches} must be >= 1")
    i32 = torch.int32
    records = native.require(records, "records", i32, dev)
    ph1 = native.require(ph1, "ph1", i32, dev)
    ph2 = native.require(ph2, "ph2", i32, dev)
    pkeys = native.require(pkeys_u32, "pkeys_u32", i32, dev)
    pvalid = native.require(pvalid, "pvalid", torch.bool, dev)
    n, lanes = pkeys.shape
    inline = lanes <= RECORD_LANES
    if records.shape != (slots, 4 if inline else 2):
        raise ValueError(f"records {tuple(records.shape)} do not fit keys "
                         f"of {lanes} lanes")
    if inline != (side is None):
        raise ValueError("keys of up to 2 lanes sit in the records, wider "
                         "ones in a side array")
    if not inline:
        side = native.require(side, "side", i32, dev)
        if side.shape != (slots, lanes):
            raise ValueError(f"side {tuple(side.shape)} does not fit keys "
                             f"of {lanes} lanes")
    if records.data_ptr() % (4 * records.shape[1]):
        records = records.clone()  # the kernel reads a record as one vector
    if lanes == 2 and pkeys.data_ptr() % 8:
        pkeys = pkeys.clone()  # the kernel reads both lanes as one vector
    cnt = torch.empty(n, dtype=i32, device=dev)
    rimat = torch.empty((n, max_matches), dtype=i32, device=dev)
    exhausted = torch.empty(n, dtype=torch.bool, device=dev)
    if n > 0:
        err = native.library().hptmt_probe(
            records.data_ptr(), native.ptr(side), slots, lanes,
            ph1.data_ptr(), ph2.data_ptr(), pkeys.data_ptr(),
            pvalid.data_ptr(), n, max_matches, max_probes, cnt.data_ptr(),
            rimat.data_ptr(), exhausted.data_ptr(), native.stream(dev))
        native.check("hptmt_probe", err)
        LAUNCHES.add()
    return cnt, rimat, exhausted
