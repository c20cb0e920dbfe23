"""Chunked dataflow helpers (reference ``core/dataflow.py``).

Only :func:`_concat_chunks` is ported so far: the frame's spill path
(``DataFrame._from_spill``) merges a spilled operator's output chunks
with it.  The TSet dataflow of the reference (the combiner barrier,
``TSet.window``/``topk``, ``from_spill``) comes with the runtime services
(ROADMAP Queue 1 item 9), in this module.
"""
from __future__ import annotations

from typing import List

import torch

from .context import HPTMTContext
from .exchange import compact_rows
from .table import DistTable, partitioning_kind


def _concat_chunks(chunks: List[DistTable], ctx: HPTMTContext) -> DistTable:
    """Concatenate chunks shard-wise and re-compact each shard.

    Shard ``s`` of the result holds every chunk's shard-``s`` rows, in
    chunk order, at capacity ``sum(chunk capacities)``.
    """
    if len(chunks) == 1:
        return chunks[0]
    names = chunks[0].column_names
    cap = sum(c.capacity for c in chunks)
    outs, counts = [], []
    for shard in range(ctx.n_shards):
        cols = {name: torch.cat([c.columns[name][shard] for c in chunks])
                for name in names}
        # rows are valid-prefix within each chunk block, not globally
        valid = torch.cat([torch.arange(c.capacity, device=c.device)
                           < c.counts[shard] for c in chunks])
        out, n, _ = compact_rows(cols, valid, cap)
        outs.append(out)
        counts.append(n)
    # shard-wise concatenation keeps every row on its shard: when all
    # chunks agree on a hash layout, the merged table still has it.  A
    # RANGE layout does NOT survive: concatenating two sorted chunks
    # interleaves their orders, so only the single-chunk early return
    # above can keep it (reference DESIGN.md §4, §9).
    parts = {c.partitioning for c in chunks}
    part = parts.pop() if len(parts) == 1 else None
    if partitioning_kind(part) == "range":
        part = None
    return DistTable.from_shards(outs, counts, part)
