"""Plain PyTorch version of the sort-free hash-join engine (reference
DESIGN.md §8).

Build/probe over a double-hash open-addressing slot table, seeded by the
``(h1, h2)`` row hashes the exchange already carries — zero rehash.  The
probe sequence of a row is ``slot_j = (h1 + j * (h2 | 1)) & (slots-1)``
(odd step over a power-of-two table → full cycle), identical for
bitwise-equal keys since their hashes are equal.

Hashes arrive as int32 tensors holding uint32 bits (``core/table.py``);
the slot arithmetic widens them to int64, where ``& (slots - 1)`` after
the add gives the same slot as the reference's uint32 wraparound.

Two build flavours share that sequence:

  * :func:`build_table` — the JOIN table: every valid build row claims its
    OWN slot, so duplicate keys occupy successive reachable slots of the
    shared sequence.  A probe walk that stops at the first EMPTY slot has
    visited every equal-key build row.
  * :func:`build_table_unique` — the GROUPBY/SET-OP table: bitwise-equal
    keys SHARE one slot, claimed by the lowest row index (scatter-min),
    and every row learns its slot.

Both must match the reference's tables bit for bit: the lowest row wins a
contended slot (``scatter_reduce_(..., "amin")``), and losers retry in
batches of ``m = min(n, max(256, n // 8))`` lowest-index rows for at most
``n // m + 2`` rounds.  Those rules decide which rows fill which slots, the
probe chain order, and so which rows survive ``max_matches``.  The
reference's ``while_loop``s are Python loops on ``.any()``.

:func:`probe` is the plain version of the CUDA probe kernel
(``csrc/probe.cu``); :func:`emit_lookup` turns its registers into packed
``(probe row, build row)`` pairs.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ...core.table import u32

_BIG = 2**31 - 1  # empty-slot sentinel during construction (scatter-min)


def _probe_slots(h1: torch.Tensor, step: torch.Tensor, j, slots: int
                 ) -> torch.Tensor:
    """j-th probe slot of each row (int64); ``h1``/``step`` are uint32
    values in int64, ``j`` a scalar or per-row tensor."""
    return (h1 + j * step) & (slots - 1)


def _take_first(eligible: torch.Tensor, m: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row indices of the first ``m`` eligible rows (scatter-free).

    Returns ``(indices (m,) int64 clipped in-range, ok (m,) bool)``.
    """
    n = eligible.shape[0]
    cs = torch.cumsum(eligible, dim=0, dtype=torch.int64)
    k = torch.arange(1, m + 1, device=eligible.device)
    ok = k <= cs[n - 1]
    pos = torch.searchsorted(cs, k)
    return torch.clamp(pos, 0, n - 1), ok


def _claim(table: torch.Tensor, slot: torch.Tensor, rows: torch.Tensor,
           sel: torch.Tensor) -> None:
    """``table[slot[i]] = min(table[slot[i]], rows[i])`` where ``sel``."""
    table.scatter_reduce_(0, slot[sel], rows[sel].to(torch.int32), "amin",
                          include_self=True)


def build_table(h1: torch.Tensor, h2: torch.Tensor, valid: torch.Tensor,
                slots: int, max_probes: int = 64
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Insert every valid row into its own slot (the join build table).

    Round 0 scatter-mins every valid row at its first probe slot.  The
    rows that lost a contended slot retry in compacted batches of
    ``~n/8``: each round selects the lowest-index still-unplaced rows,
    attempts their next FREE slot, and advances the losers.  Rows still
    unplaced after ``max_probes`` probes (or when the retry budget runs
    out) are missing from the table; the caller counts them as overflow.

    Returns ``(table_row (slots,) int32 with -1 = empty, n_unplaced)``.
    """
    n = h1.shape[0]
    dev = h1.device
    h1 = u32(h1)
    step = u32(h2) | 1
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    m = min(n, max(256, n // 8))
    outer_cap = n // m + 2  # each batch retires all its rows

    table = torch.full((slots,), _BIG, dtype=torch.int32, device=dev)
    slot0 = _probe_slots(h1, step, 0, slots)
    _claim(table, slot0, rows, valid)
    pending = valid & (table[slot0] != rows)
    failed = torch.zeros((), dtype=torch.int32, device=dev)

    it = 0
    while it < outer_cap and bool(pending.any()):
        si, ok = _take_first(pending, m)
        sh1, sstep = h1[si], step[si]
        jm = torch.ones(m, dtype=torch.int64, device=dev)
        alive, placed = ok.clone(), torch.zeros_like(ok)
        while bool(alive.any()):
            slot = _probe_slots(sh1, sstep, jm, slots)
            att = alive & (table[slot] == _BIG)
            _claim(table, slot, si, att)
            won = att & (table[slot] == si)
            placed |= won
            jm = jm + (alive & ~won)
            alive = alive & ~won & (jm < max_probes)
        failed += (ok & ~placed).sum(dtype=torch.int32)
        pending[si[ok]] = False
        it += 1
    # rows still pending here only if the outer budget ran out
    failed += pending.sum(dtype=torch.int32)
    return torch.where(table == _BIG, -1, table), failed


def build_table_unique(h1: torch.Tensor, h2: torch.Tensor,
                       keys_u32: torch.Tensor, valid: torch.Tensor,
                       slots: int, max_probes: int = 64
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One slot per distinct key, claimed by the lowest row index.

    A row joins a slot only after comparing its ACTUAL key lanes against
    the claimant — hash equality is never trusted.  Slot collisions
    between distinct keys retry in compacted ``~n/8`` batches exactly like
    :func:`build_table`.  Rows unresolved after ``max_probes`` probes or
    the retry budget are the caller's overflow count.

    Returns ``(owner (slots,) int32 claimant row or -1 = empty,
    seg (n,) int32 slot of each resolved row with ``slots`` as the
    unresolved sentinel, unresolved (n,) bool)``.
    """
    n = h1.shape[0]
    dev = h1.device
    h1 = u32(h1)
    step = u32(h2) | 1
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    m = min(n, max(256, n // 8))
    outer_cap = n // m + 2  # each batch retires all its rows

    owner = torch.full((slots,), _BIG, dtype=torch.int32, device=dev)
    slot0 = _probe_slots(h1, step, 0, slots)
    _claim(owner, slot0, rows, valid)
    own0 = owner[slot0]
    same0 = valid & (own0 < _BIG)
    safe0 = torch.where(same0, own0, 0)
    same0 &= (keys_u32 == keys_u32[safe0]).all(dim=1)
    seg = torch.where(same0, slot0, slots).to(torch.int32)
    pending = valid & ~same0
    unresolved = pending.clone()

    it = 0
    while it < outer_cap and bool(pending.any()):
        si, ok = _take_first(pending, m)
        sh1, sstep, skeys = h1[si], step[si], keys_u32[si]
        jm = torch.ones(m, dtype=torch.int64, device=dev)
        alive, resolved = ok.clone(), torch.zeros_like(ok)
        segm = torch.full((m,), slots, dtype=torch.int64, device=dev)
        while bool(alive.any()):
            slot = _probe_slots(sh1, sstep, jm, slots)
            free = owner[slot] == _BIG
            _claim(owner, slot, si, alive & free)
            own = owner[slot]
            same = alive & (own < _BIG)
            safe = torch.where(same, own, 0)
            same &= (skeys == keys_u32[safe]).all(dim=1)
            segm = torch.where(same, slot, segm)
            resolved |= same
            jm = jm + (alive & ~same)
            alive = alive & ~same & (jm < max_probes)
        done = ok & resolved
        seg[si[done]] = segm[done].to(torch.int32)
        unresolved[si[done]] = False
        pending[si[ok]] = False
        it += 1
    return torch.where(owner == _BIG, -1, owner), seg, unresolved


def slot_payload(table_row: torch.Tensor, bh2: torch.Tensor,
                 bkeys_u32: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slot-indexed verification payload: ``(h2, key lanes)`` per slot."""
    occ = table_row >= 0
    safe = torch.where(occ, table_row, 0)
    slot_h2 = torch.where(occ, bh2[safe], 0)
    keys = bkeys_u32[safe]
    slot_keys = torch.where(occ[:, None], keys, torch.zeros_like(keys))
    return slot_h2, slot_keys


def probe(table_row: torch.Tensor, slot_h2: torch.Tensor,
          slot_keys: torch.Tensor, ph1: torch.Tensor, ph2: torch.Tensor,
          pkeys_u32: torch.Tensor, pvalid: torch.Tensor,
          max_matches: int = 1, max_probes: int = 64
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused probe pass: match counts + the first-match registers.

    Each probe row walks its sequence until the first empty slot;
    candidates verify by ``h2`` plus the actual key lanes.  The walk counts
    every match and records the first ``max_matches`` build rows in an
    ``(n, max_matches)`` register matrix.

    Returns ``(cnt (n,) int32, rimat (n, max_matches) int32 with -1 =
    empty register, exhausted (n,) bool)`` — exhausted rows hit
    ``max_probes`` while still on an occupied chain.
    """
    slots = table_row.shape[0]
    n = ph1.shape[0]
    dev = ph1.device
    h1 = u32(ph1)
    step = u32(ph2) | 1
    ords = torch.arange(max_matches, dtype=torch.int32, device=dev)
    cnt = torch.zeros(n, dtype=torch.int32, device=dev)
    rimat = torch.full((n, max_matches), -1, dtype=torch.int32, device=dev)
    active = pvalid.clone()
    j = 0
    while j < max_probes and bool(active.any()):
        slot = _probe_slots(h1, step, j, slots)
        brow = table_row[slot]
        occ = brow >= 0
        match = active & occ & (ph2 == slot_h2[slot])
        match &= (pkeys_u32 == slot_keys[slot]).all(dim=1)
        rimat = torch.where(match[:, None] & (cnt[:, None] == ords[None, :]),
                            brow[:, None], rimat)
        cnt = cnt + match.to(torch.int32)
        active = active & occ
        j += 1
    return cnt, rimat, active


def emit_lookup(rimat: torch.Tensor, base: torch.Tensor,
                emit_n: torch.Tensor, total: torch.Tensor, out_capacity: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Turn probe registers into packed ``(probe_row, build_row)`` pairs.

    Output slot ``p`` belongs to probe row ``i`` with ``base[i] <= p <
    base[i] + emit_n[i]``, recovered by a binary search over the scan.  An
    output slot owed to an unmatched keep-all row reads an empty register
    and keeps ``ri = -1``.

    Returns ``(li, ri)`` int32 index pairs, ``-1`` for an absent side;
    slots at or past ``total`` are ``(-1, -1)`` padding.
    """
    n, max_matches = rimat.shape
    dev = rimat.device
    p = torch.arange(out_capacity, device=dev)
    ends = (base + emit_n).to(torch.int64)
    i = torch.clamp(torch.searchsorted(ends, p, right=True), 0, n - 1)
    valid_p = p < total
    k_target = torch.clamp(p - base.to(torch.int64)[i], 0, max_matches - 1)
    ri = torch.where(valid_p, rimat[i, k_target], -1)
    return torch.where(valid_p, i, -1).to(torch.int32), ri
