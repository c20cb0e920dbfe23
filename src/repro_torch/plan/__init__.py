"""Lazy query planner: whole-pipeline exchange optimization (reference
DESIGN.md §11).

``DataFrame.lazy()`` / ``LazyFrame.read_parquet`` build a logical
expression graph (``plan.logical``); a rule-based rewriter
(``plan.rules``) pushes predicates/projections into the scan, reorders
join inputs from manifest cardinality estimates and picks hash-vs-range
layouts globally; the physical planner (``plan.physical``) lowers the
whole pipeline into ONE program over the eager ``table_ops`` engines,
eliding exchanges across operator chains via true-layout tracking.
``.explain()`` renders all three stages with predicted collective
counts; the eager DataFrame remains the parity oracle, and the
plan-contract tests count at the exchange choke point that planned
pipelines never make more exchanges than their eager equivalents.
"""
from . import logical
from .explain import render_explain
from .frame import LazyFrame, LazyWindow, PlanAuditError
from .physical import Layout, PhysicalPlan, PlanStep
from .rules import RULES, estimated_rows, optimize

__all__ = ["LazyFrame", "LazyWindow", "Layout", "PhysicalPlan",
           "PlanAuditError", "PlanStep", "RULES", "estimated_rows",
           "logical", "optimize", "render_explain"]
