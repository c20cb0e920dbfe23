"""Logical plan: a lazy expression graph over the eager operator set.

Each :class:`LogicalNode` is one operator application (reference
DESIGN.md §11);
the graph is an immutable tree built bottom-up by the constructor
functions here.  Builders validate eagerly — unknown columns, bad agg
specs and malformed key lists fail at graph-construction time with the
same error style as the eager operators, long before anything traces —
and compute the node's output ``schema`` (the sorted column-name tuple
that ``DistTable.column_names`` would report), so the rewriter
(``plan.rules``) and the physical planner (``plan.physical``) reason
about column sets without touching data.

Node kinds and payloads:

  source       table (DistTable), name
  scan         dataset (Dataset), columns, predicate, capacity,
               bucket_factor, allow_narrowing
  filter       predicate — a tuple of ColumnPredicate (AND), or a
               callable ``cols -> bool mask`` (opaque to the rewriter)
  project      columns
  join         keys, how, method, max_matches, swap, reorder, kw
  groupby      keys, aggs, layout ("hash" | "range"), layout_ascending, kw
  orderby      by, ascending
  window       partition_by, order_by, ascending, aggs, rows
  topk         by, k, ascending
  repartition  keys, mode ("hash" | "range"), ascending
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

from ..core.table import DistTable
from ..core.table_ops import _JOIN_HOWS, _SEGMENT_OPS, _normalize_order
from ..io.scan import ColumnPredicate, _normalize_predicate


@dataclasses.dataclass(frozen=True, eq=False)
class LogicalNode:
    """One operator application; identity equality (nodes are unique)."""
    kind: str
    inputs: Tuple["LogicalNode", ...]
    payload: Dict
    schema: Tuple[str, ...]  # sorted output column names

    def with_payload(self, **updates) -> "LogicalNode":
        """Copy with payload entries replaced (schema unchanged)."""
        return LogicalNode(self.kind, self.inputs, {**self.payload,
                                                    **updates}, self.schema)

    def with_inputs(self, *inputs) -> "LogicalNode":
        return LogicalNode(self.kind, tuple(inputs), self.payload,
                           self.schema)


Predicate = Union[Tuple[ColumnPredicate, ...], Callable]


def _check_columns(cols, schema, what: str) -> None:
    missing = [c for c in cols if c not in schema]
    if missing:
        raise ValueError(f"{what} names unknown column(s) {missing}; "
                         f"input has {list(schema)}")


# -- leaves -----------------------------------------------------------------
def source(table: DistTable, name: str = "table") -> LogicalNode:
    return LogicalNode("source", (), {"table": table, "name": name},
                       tuple(sorted(table.column_names)))


def scan(dataset, *, columns=None, predicate=None, capacity=None,
         bucket_factor: float = 1.0, allow_narrowing: bool = False,
         on_error: str = "raise") -> LogicalNode:
    """Lazy dataset scan; column/predicate pushdown lands here.

    ``on_error="quarantine"`` opts the physical scan into skipping
    corrupt fragments (recorded in stats + sidecar) instead of raising.
    """
    from ..io.dataset import open_dataset

    if isinstance(dataset, str):
        dataset = open_dataset(dataset)
    if on_error not in ("raise", "quarantine"):
        raise ValueError(f"scan on_error={on_error!r}; expected 'raise' "
                         f"or 'quarantine'")
    names = dataset.schema.names
    out = tuple(columns) if columns is not None else tuple(names)
    _check_columns(out, names, "scan columns=")
    preds = _normalize_predicate(predicate)
    _check_columns([p.column for p in preds], names, "scan predicate=")
    return LogicalNode("scan", (), {
        "dataset": dataset, "columns": out, "predicate": preds,
        "capacity": capacity, "bucket_factor": bucket_factor,
        "allow_narrowing": allow_narrowing, "on_error": on_error},
        tuple(sorted(out)))


# -- row / column ops -------------------------------------------------------
def filter_(child: LogicalNode, predicate) -> LogicalNode:
    if callable(predicate):
        preds: Predicate = predicate
    else:
        preds = _normalize_predicate(predicate)
        if not preds:
            raise ValueError("filter needs a predicate")
        _check_columns([p.column for p in preds], child.schema,
                       "filter predicate=")
    return LogicalNode("filter", (child,), {"predicate": preds},
                       child.schema)


def project(child: LogicalNode, columns) -> LogicalNode:
    cols = (columns,) if isinstance(columns, str) else tuple(columns)
    if not cols:
        raise ValueError("project needs at least one column")
    _check_columns(cols, child.schema, "project columns=")
    return LogicalNode("project", (child,), {"columns": cols},
                       tuple(sorted(dict.fromkeys(cols))))


# -- relational ops ---------------------------------------------------------
def join_schema(left_schema, right_schema, keys) -> Tuple[str, ...]:
    """Output columns of ``table_ops.join``: keys + left non-keys +
    right non-keys (``_r``-suffixed on name clash) + ``_matched``."""
    out = list(keys)
    out += [c for c in left_schema if c not in keys]
    for c in right_schema:
        if c in keys:
            continue
        out.append(f"{c}_r" if c in left_schema else c)
    out.append("_matched")
    return tuple(sorted(dict.fromkeys(out)))


def join(left: LogicalNode, right: LogicalNode, keys, *,
         how: str = "inner", max_matches: int = 1, method: str = "auto",
         reorder: bool = False, **kw) -> LogicalNode:
    """``reorder=True`` opts this join into the ``reorder-join-inputs``
    rewrite (the caller promises ``max_matches`` cannot bind — see
    ``plan.rules``); ``swap`` is the rewriter's decision output."""
    keys = tuple(keys)
    if how not in _JOIN_HOWS:
        raise ValueError(f"unknown join type how={how!r}; "
                         f"expected one of {_JOIN_HOWS}")
    _check_columns(keys, left.schema, "join keys= (left)")
    _check_columns(keys, right.schema, "join keys= (right)")
    return LogicalNode(
        "join", (left, right),
        {"keys": keys, "how": how, "max_matches": max_matches,
         "method": method, "swap": False, "reorder": bool(reorder),
         "kw": dict(kw)},
        join_schema(left.schema, right.schema, keys))


def groupby(child: LogicalNode, keys, aggs, **kw) -> LogicalNode:
    keys = tuple(keys)
    aggs = tuple((c, op) for c, op in aggs)
    _check_columns(keys, child.schema, "groupby keys=")
    for c, op in aggs:
        if op not in _SEGMENT_OPS:
            raise ValueError(f"unknown aggregate {op!r}")
        if c not in child.schema:
            raise ValueError(f"aggregate column {c!r} not in input "
                             f"{list(child.schema)}")
    labels = [f"{c}_{op}" for c, op in aggs]
    return LogicalNode(
        "groupby", (child,),
        {"keys": keys, "aggs": aggs, "layout": "hash",
         "layout_ascending": None, "kw": dict(kw)},
        tuple(sorted(dict.fromkeys(list(keys) + labels))))


def orderby(child: LogicalNode, by, ascending=True) -> LogicalNode:
    keys, asc = _normalize_order(by, ascending, child.schema, "by")
    return LogicalNode("orderby", (child,),
                       {"by": keys, "ascending": asc}, child.schema)


def window(child: LogicalNode, partition_by, order_by, aggs, *,
           rows: Optional[int] = None, ascending=True) -> LogicalNode:
    from ..window import normalize_aggs

    pkeys = (partition_by,) if isinstance(partition_by, str) \
        else tuple(partition_by)
    _check_columns(pkeys, child.schema, "window partition_by=")
    okeys, asc_o = _normalize_order(order_by, ascending, child.schema,
                                    "order_by")
    norm = normalize_aggs(aggs, child.schema, rows)
    labels = [lbl for lbl, _, _, _ in norm]
    return LogicalNode(
        "window", (child,),
        {"partition_by": pkeys, "order_by": okeys, "ascending": asc_o,
         "aggs": tuple(tuple(a) for a in aggs), "rows": rows},
        tuple(sorted(list(child.schema) + labels)))


def topk(child: LogicalNode, by, k: int, ascending=True) -> LogicalNode:
    keys, asc = _normalize_order(by, ascending, child.schema, "by")
    if not isinstance(k, int) or k < 1:
        raise ValueError(f"topk k={k!r} must be a positive int")
    return LogicalNode("topk", (child,),
                       {"by": keys, "k": k, "ascending": asc}, child.schema)


def repartition(child: LogicalNode, keys, *, mode: str = "hash",
                ascending=True) -> LogicalNode:
    if mode not in ("hash", "range"):
        raise ValueError(f"repartition mode={mode!r}; "
                         f"expected 'hash' or 'range'")
    keys, asc = _normalize_order(keys, ascending, child.schema, "keys")
    return LogicalNode("repartition", (child,),
                       {"keys": keys, "mode": mode, "ascending": asc},
                       child.schema)


def walk(node: LogicalNode):
    """Post-order traversal (inputs before node)."""
    for inp in node.inputs:
        yield from walk(inp)
    yield node
