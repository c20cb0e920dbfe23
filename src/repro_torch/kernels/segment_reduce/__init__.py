"""Segment sum/min/max reductions of the groupby."""
