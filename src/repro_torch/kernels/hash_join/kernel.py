"""Wrapper of the CUDA probe kernel (``csrc/probe.cu``).

Replaces the TPU kernel ``probe_pallas``
(``src/repro/kernels/hash_join/kernel.py``).  The walk is bound by
dependent random reads of the slot table — three 32-byte sectors per
visited slot — so the kernel runs one thread per probe row with no
shared memory and lets each thread stop at its own first empty slot;
occupancy hides the gather latency (see the source).  Unlike the TPU
kernel it has no table-size cap: the table stays in device memory.
"""
from __future__ import annotations

import torch

from ...core.array_ops import Counter
from .. import native

#: launches of the kernel
LAUNCHES = Counter()


def probe_cuda(table_row: torch.Tensor, slot_h2: torch.Tensor,
               slot_keys: torch.Tensor, ph1: torch.Tensor, ph2: torch.Tensor,
               pkeys_u32: torch.Tensor, pvalid: torch.Tensor,
               max_matches: int = 1, max_probes: int = 64):
    """Same contract as ``ref.probe``, on CUDA tensors; bit-identical."""
    dev = ph1.device
    if dev.type != "cuda":
        raise ValueError(f"probe_cuda needs CUDA tensors, got {dev}")
    slots = table_row.shape[0]
    if slots & (slots - 1):
        raise ValueError(f"slot count {slots} is not a power of two")
    if max_matches < 1:
        raise ValueError(f"max_matches={max_matches} must be >= 1")
    i32 = torch.int32
    table_row = native.require(table_row, "table_row", i32, dev)
    slot_h2 = native.require(slot_h2, "slot_h2", i32, dev)
    slot_keys = native.require(slot_keys, "slot_keys", i32, dev)
    ph1 = native.require(ph1, "ph1", i32, dev)
    ph2 = native.require(ph2, "ph2", i32, dev)
    pkeys = native.require(pkeys_u32, "pkeys_u32", i32, dev)
    pvalid = native.require(pvalid, "pvalid", torch.bool, dev)
    n = ph1.shape[0]
    lanes = slot_keys.shape[1]
    if pkeys.shape != (n, lanes) or slot_keys.shape != (slots, lanes):
        raise ValueError(f"key lanes disagree: probe {tuple(pkeys.shape)}, "
                         f"table {tuple(slot_keys.shape)}")
    cnt = torch.empty(n, dtype=i32, device=dev)
    rimat = torch.empty((n, max_matches), dtype=i32, device=dev)
    exhausted = torch.empty(n, dtype=torch.bool, device=dev)
    if n > 0:
        err = native.library().hptmt_probe(
            table_row.data_ptr(), slot_h2.data_ptr(), slot_keys.data_ptr(),
            slots, lanes, ph1.data_ptr(), ph2.data_ptr(), pkeys.data_ptr(),
            pvalid.data_ptr(), n, max_matches, max_probes, cnt.data_ptr(),
            rimat.data_ptr(), exhausted.data_ptr(), native.stream(dev))
        native.check("hptmt_probe", err)
        LAUNCHES.add()
    return cnt, rimat, exhausted
