"""Rule-based logical-plan rewriter (reference DESIGN.md §11).

``optimize(root)`` returns ``(new_root, fired)`` where ``fired`` is the
ordered tuple of rule names that changed the tree.  Every rule preserves
the result the eager pipeline would compute (the parity oracle); rules
only move work earlier, drop provably dead work, or change *layout*
decisions the physical planner exploits:

  push-filter-through-project   filter commutes with a projection that
                                keeps its columns
  push-filter-through-join      inner joins only: per-side structured
                                predicates move below the join (a filter
                                below a left/right/outer join would also
                                drop the zero-filled unmatched rows —
                                never pushed)
  push-filter-into-scan         structured predicates land in the scan's
                                predicate pushdown (fragment pruning +
                                residual filter)
  push-projection-into-scan     scans read only columns some consumer
                                needs (predicate columns are added back
                                by ``ScanSource.read_columns``)
  drop-redundant-exchange       a user ``repartition`` whose layout is
                                immediately destroyed by a re-exchanging
                                consumer is dead work (never fired before
                                ``topk``: its tie selection and its
                                ``k <= capacity`` validation are
                                placement-sensitive)
  reorder-join-inputs           inner joins put the smaller estimated
                                side on the right — the hash build side
                                (manifest min/max cardinality estimates).
                                Opt-in per join (``join(..., reorder=
                                True)``): ``table_ops.join`` caps fan-out
                                per LEFT row, so swapping sides changes
                                which side ``max_matches`` caps and
                                overflow accounting could diverge from
                                the eager oracle unless the caller knows
                                the cap cannot bind
  choose-range-layout           groupby feeding an orderby on the same
                                keys exchanges by RANGE once instead of
                                hash + range twice

Structured predicates are tuples of :class:`ColumnPredicate`; callable
filters are opaque — they block predicate pushdown and force scans below
them to keep every column a consumer might touch.
"""
from __future__ import annotations

from typing import List, Optional, Set, Tuple

from ..io.scan import ColumnPredicate

from . import logical as L
from .logical import LogicalNode

__all__ = ["optimize", "estimated_rows", "RULES"]

RULES = (
    "push-filter-through-project",
    "push-filter-through-join",
    "push-filter-into-scan",
    "push-projection-into-scan",
    "drop-redundant-exchange",
    "reorder-join-inputs",
    "choose-range-layout",
)

# crude per-op selectivity priors for cardinality estimates; exact
# numbers matter less than their ORDER (== is tighter than a range,
# which is tighter than !=)
_SELECTIVITY = {"==": 0.1, "<": 0.4, "<=": 0.4, ">": 0.4, ">=": 0.4,
                "!=": 0.9}


def _structured(pred) -> bool:
    return not callable(pred)


# ===========================================================================
# cardinality estimation (manifest min/max stats)
# ===========================================================================
def _pred_selectivity(p: ColumnPredicate, dataset) -> float:
    """Fraction of rows estimated to survive ``p``, refined by the
    dataset's global min/max when available (uniformity assumption)."""
    if dataset is not None:
        bounds = dataset.stat_bounds(p.column)
        if bounds is not None and p.op in ("<", "<=", ">", ">="):
            lo, hi = bounds
            span = float(hi) - float(lo)
            if span > 0:
                frac = (float(p.value) - float(lo)) / span
                frac = min(1.0, max(0.0, frac))
                return frac if p.op in ("<", "<=") else 1.0 - frac
            # degenerate single-value fragment range
            return 1.0 if ColumnPredicate(p.column, p.op, p.value
                                          ).maybe_satisfied(bounds) else 0.0
    return _SELECTIVITY[p.op]


def _key_width(node: LogicalNode, column: str) -> Optional[float]:
    """Distinct-value bound for ``column`` from the manifest stats of
    scans below ``node``: an integer-valued global ``(min, max)`` range
    admits at most ``max - min + 1`` distinct values.  ``None`` when no
    scan below carries integral bounds for the column (sources have no
    manifests — estimates never read data)."""
    best = None
    for sub in L.walk(node):
        if sub.kind != "scan":
            continue
        bounds = sub.payload["dataset"].stat_bounds(column)
        if bounds is None:
            continue
        lo, hi = float(bounds[0]), float(bounds[1])
        if lo != int(lo) or hi != int(hi) or hi < lo:
            continue
        width = hi - lo + 1.0
        best = width if best is None else min(best, width)
    return best


def _distinct_combos(node: LogicalNode) -> Optional[float]:
    """Upper bound on distinct key-combos a groupby can emit, from the
    per-key manifest ranges (``None`` when any key is unbounded)."""
    combos = 1.0
    for key in node.payload["keys"]:
        width = _key_width(node.inputs[0], key)
        if width is None:
            return None
        combos *= width
    return combos


def estimated_rows(node: LogicalNode, cache: Optional[dict] = None) -> float:
    """Upper-ish row estimate from manifest stats and selectivity priors.

    Orders join inputs (rule ``reorder-join-inputs``) and is stamped on
    every :class:`~repro_torch.plan.physical.PlanStep` as ``est_rows`` for the
    cardinality audit (reference DESIGN.md §14.1) — deterministic,
    manifests only, no data is ever read.  ``cache`` (id-keyed) amortizes the recursion
    when the physical planner estimates every node of one tree."""
    if cache is not None and id(node) in cache:
        return cache[id(node)]
    est = _estimated_rows(node, cache)
    if cache is not None:
        cache[id(node)] = est
    return est


def _estimated_rows(node: LogicalNode, cache: Optional[dict]) -> float:
    if node.kind == "source":
        return float(int(node.payload["table"].num_rows()))
    if node.kind == "scan":
        ds = node.payload["dataset"]
        kept = 0.0
        for frag in ds.fragments:
            if all(p.maybe_satisfied(frag.stats.get(p.column))
                   for p in node.payload["predicate"]):
                kept += frag.rows
        for p in node.payload["predicate"]:
            kept *= _pred_selectivity(p, ds)
        return kept
    if node.kind == "filter":
        est = estimated_rows(node.inputs[0], cache)
        pred = node.payload["predicate"]
        if _structured(pred):
            for p in pred:
                est *= _pred_selectivity(p, None)
            return est
        return est * 0.5
    if node.kind == "join":
        return max(estimated_rows(node.inputs[0], cache),
                   estimated_rows(node.inputs[1], cache))
    if node.kind == "groupby":
        est = estimated_rows(node.inputs[0], cache)
        combos = _distinct_combos(node)
        return est if combos is None else min(est, combos)
    if node.kind == "topk":
        return float(node.payload["k"])
    return estimated_rows(node.inputs[0], cache)


# ===========================================================================
# local rewrite rules (applied bottom-up to fixpoint)
# ===========================================================================
def _push_filter(node: LogicalNode, fired: List[str]) -> LogicalNode:
    """Rewrite one Filter node downward where legal."""
    child = node.inputs[0]
    pred = node.payload["predicate"]
    if not _structured(pred):
        return node

    if child.kind == "project":
        # predicate columns ⊆ projected columns (validated at build), so
        # the filter commutes with the projection
        fired.append("push-filter-through-project")
        return L.project(L.filter_(child.inputs[0], pred),
                         child.payload["columns"])

    if child.kind == "filter" and _structured(child.payload["predicate"]):
        # fuse ANDed structured filters so join/scan pushes see all preds
        return L.filter_(child.inputs[0],
                         child.payload["predicate"] + pred)

    if child.kind == "join" and child.payload["how"] == "inner":
        left, right = child.inputs
        keys = child.payload["keys"]
        to_l, to_r, residual = [], [], []
        for p in pred:
            c = p.column
            # generated (_matched) and _r-suffixed names refer to THIS
            # join's output, not to either input — never pushed; so does
            # any name the join's dup-suffixing would shadow
            generated = (c == "_matched" or (
                c.endswith("_r") and c[:-2] in left.schema
                and c[:-2] in right.schema and c[:-2] not in keys))
            if generated:
                residual.append(p)
            elif c in keys:
                # key values are identical on both sides of a matched
                # inner pair — push into BOTH builds
                to_l.append(p)
                to_r.append(p)
            elif c in left.schema:
                to_l.append(p)
            elif c in right.schema:
                to_r.append(p)
            else:
                residual.append(p)
        if not to_l and not to_r:
            return node
        fired.append("push-filter-through-join")
        if to_l:
            left = L.filter_(left, tuple(to_l))
        if to_r:
            right = L.filter_(right, tuple(to_r))
        new_join = LogicalNode(child.kind, (left, right), child.payload,
                               child.schema)
        return L.filter_(new_join, tuple(residual)) if residual else new_join

    if child.kind == "scan":
        schema = child.payload["dataset"].schema
        push = [p for p in pred if not schema[p.column].trailing]
        if not push:
            return node
        fired.append("push-filter-into-scan")
        new_scan = L.scan(
            child.payload["dataset"], columns=child.payload["columns"],
            predicate=child.payload["predicate"] + tuple(push),
            capacity=child.payload["capacity"],
            bucket_factor=child.payload["bucket_factor"],
            allow_narrowing=child.payload["allow_narrowing"],
            on_error=child.payload["on_error"])
        rest = tuple(p for p in pred if p not in push)
        return L.filter_(new_scan, rest) if rest else new_scan

    return node


def _serves(rep: LogicalNode, consumer: LogicalNode, side: int) -> bool:
    """Could ``rep``'s layout elide any exchange of ``consumer``?"""
    keys = rep.payload["keys"]
    mode = rep.payload["mode"]
    k = consumer.kind
    if k == "join":
        return mode == "hash" and keys == consumer.payload["keys"]
    if k == "groupby":
        return set(keys) == set(consumer.payload["keys"])
    if k == "orderby":
        return (mode == "range" and keys == consumer.payload["by"]
                and rep.payload["ascending"]
                == consumer.payload["ascending"])
    if k == "window":
        pk = consumer.payload["partition_by"]
        full = tuple(pk) + tuple(consumer.payload["order_by"])
        return (set(keys) == set(pk)
                or (mode == "range" and keys == full))
    if k == "repartition":
        return False  # immediately re-exchanged by the consumer
    # anything else (incl. topk: tie selection is per-shard and
    # ``k <= capacity`` validation is per-shard too, so placement — and
    # the rebalanced capacity a repartition brings — is observable):
    # layout flows through, keep it
    return True


def _drop_dead_repartition(node: LogicalNode,
                           fired: List[str]) -> LogicalNode:
    """Drop a repartition child whose layout this node destroys unused."""
    if node.kind not in ("join", "groupby", "orderby", "window",
                         "repartition"):
        return node
    new_inputs, changed = [], False
    for i, inp in enumerate(node.inputs):
        if inp.kind == "repartition" and not _serves(inp, node, i):
            fired.append("drop-redundant-exchange")
            new_inputs.append(inp.inputs[0])
            changed = True
        else:
            new_inputs.append(inp)
    return node.with_inputs(*new_inputs) if changed else node


def _rewrite_up(node: LogicalNode, fired: List[str]) -> LogicalNode:
    """Bottom-up pass; re-applies locally until the node stops changing."""
    node = node.with_inputs(*[_rewrite_up(i, fired) for i in node.inputs])
    for _ in range(16):  # fixpoint bound (a push can expose another)
        new = node
        if new.kind == "filter":
            new = _push_filter(new, fired)
        new = _drop_dead_repartition(new, fired)
        if new is node:
            return node
        node = new.with_inputs(*[_rewrite_up(i, fired)
                                 for i in new.inputs])
    return node


# ===========================================================================
# whole-tree passes
# ===========================================================================
def _push_projection(node: LogicalNode, req: Set[str],
                     fired: List[str]) -> LogicalNode:
    """Top-down required-column analysis; narrows scan reads."""
    if node.kind == "scan":
        cur = node.payload["columns"]
        keep = tuple(c for c in cur if c in req)
        if keep and set(keep) != set(cur):
            fired.append("push-projection-into-scan")
            return L.scan(node.payload["dataset"], columns=keep,
                          predicate=node.payload["predicate"],
                          capacity=node.payload["capacity"],
                          bucket_factor=node.payload["bucket_factor"],
                          allow_narrowing=node.payload["allow_narrowing"],
                          on_error=node.payload["on_error"])
        return node
    if node.kind == "source":
        return node

    k, p = node.kind, node.payload
    if k == "filter":
        pred = p["predicate"]
        if _structured(pred):
            child_req = req | {q.column for q in pred}
        else:  # opaque callable: every input column may be touched
            child_req = set(node.inputs[0].schema)
        reqs = [child_req]
    elif k == "project":
        reqs = [set(p["columns"])]
    elif k == "join":
        keys = set(p["keys"])
        lsch, rsch = node.inputs[0].schema, node.inputs[1].schema
        lreq, rreq = set(keys), set(keys)
        for c in req:
            if c == "_matched":
                continue
            if c in lsch and c not in keys:
                lreq.add(c)
            # join-generated dup suffix requires right's base column —
            # but join_schema never suffixes KEYS, so "k_r" with k a
            # join key can only be a literal input column (same guard
            # as _push_filter's `generated` test): fall through to the
            # plain rsch handling so the literal column stays required
            if c.endswith("_r") and c[:-2] in rsch and c[:-2] in lsch \
                    and c[:-2] not in keys:
                rreq.add(c[:-2])
            elif c in rsch and c not in lsch and c not in keys:
                rreq.add(c)
        reqs = [lreq, rreq]
    elif k == "groupby":
        reqs = [set(p["keys"]) | {c for c, _ in p["aggs"]}]
    elif k == "orderby" or k == "topk":
        reqs = [req | set(p["by"])]
    elif k == "window":
        child = set(c for c in req if c in node.inputs[0].schema)
        from ..window import normalize_aggs
        norm = normalize_aggs(p["aggs"], node.inputs[0].schema, p["rows"])
        reqs = [child | set(p["partition_by"]) | set(p["order_by"])
                | {c for _, c, _, _ in norm if c is not None}]
    elif k == "repartition":
        reqs = [req | set(p["keys"])]
    else:  # pragma: no cover — exhaustive over node kinds
        reqs = [set(i.schema) for i in node.inputs]
    return node.with_inputs(*[_push_projection(i, r, fired)
                              for i, r in zip(node.inputs, reqs)])


def _reorder_joins(node: LogicalNode, fired: List[str]) -> LogicalNode:
    node = node.with_inputs(*[_reorder_joins(i, fired)
                              for i in node.inputs])
    # opt-in only: the local kernels cap fan-out per PROBE (left) row,
    # so a swap silently moves the max_matches cap to the other side —
    # a 1:N join whose fan-out exceeds the cap on the swapped-to-left
    # side would overflow where the eager oracle is exact (or vice
    # versa).  ``reorder=True`` is the caller's promise the cap cannot
    # bind either way.
    if node.kind != "join" or node.payload["how"] != "inner" \
            or node.payload["swap"] or not node.payload["reorder"]:
        return node
    left, right = node.inputs
    if not (estimated_rows(left) < estimated_rows(right)):
        return node
    # renaming safety: after the swap every duplicate non-key column c
    # swaps names with c_r — refuse when a literal "c_r" column already
    # exists on either side (the rename would collide)
    keys = node.payload["keys"]
    dups = [c for c in left.schema
            if c in right.schema and c not in keys]
    names = set(left.schema) | set(right.schema)
    if any(f"{c}_r" in names for c in dups):
        return node
    fired.append("reorder-join-inputs")
    return node.with_payload(swap=True)


def _choose_layouts(node: LogicalNode, fired: List[str]) -> LogicalNode:
    node = node.with_inputs(*[_choose_layouts(i, fired)
                              for i in node.inputs])
    if node.kind == "orderby" and node.inputs[0].kind == "groupby":
        gb = node.inputs[0]
        if tuple(node.payload["by"]) == tuple(gb.payload["keys"]) \
                and gb.payload["layout"] == "hash":
            fired.append("choose-range-layout")
            gb = gb.with_payload(layout="range",
                                 layout_ascending=node.payload["ascending"])
            return node.with_inputs(gb)
    return node


def optimize(root: LogicalNode) -> Tuple[LogicalNode, Tuple[str, ...]]:
    """Run every rewrite pass; returns ``(optimized_root, fired_rules)``."""
    fired: List[str] = []
    root = _rewrite_up(root, fired)
    root = _push_projection(root, set(root.schema), fired)
    root = _reorder_joins(root, fired)
    root = _choose_layouts(root, fired)
    return root, tuple(dict.fromkeys(fired))
