"""Ordered-analytics subsystem: windowed aggregation over range layouts.

``segments`` turns the sorted layout into partition boundaries and the
cross-shard halo/carry state; ``engine`` evaluates rolling/cumulative
aggregates, lag/lead, row_number and rank in one pass over the
``kernels/window_scan`` surface.  The operators are surfaced in
``core.table_ops`` (``window_aggregate``/``rank``) and the DataFrame.
"""
from .engine import WINDOW_OPS, eval_window, normalize_aggs
from .segments import boundary_flags, chain_carries, flag_starts

__all__ = ["WINDOW_OPS", "eval_window", "normalize_aggs", "boundary_flags",
           "chain_carries", "flag_starts"]
