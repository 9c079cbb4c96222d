"""Query planner — paper §III-B, the four heuristics; a copy of the
reference's core/planner.py.

The planner chooses which equality conditions run as index scans (key
sets intersected or unioned on the device) and which run as the
tablet-server filter, from densities d_i read from the aggregate table
and a global threshold w that avoids intersecting sets of very different
sizes:

  1. root is Eq                   -> index scan.
  2. root is OR, all children Eq  -> index scan every child, union.
  3. root is AND                  -> index scan every Eq child with
       d_i < w * min_i d_i; intersect the key sets; the remaining tree
       runs as the filter.
  4. otherwise                    -> full tablet-server filtering.

An indexed equality whose density over the query range is zero proves
the (intersected) result empty, since the aggregate buckets cover a
superset of [t_start, t_stop]: the plan is mode 'empty' and no scan runs.

The density source is duck-typed: anything with .schema, .dictionaries
and .agg_count — the host EventStore reads its aggregate table,
DistQueryProcessor (and the snapshot-pinned source a QueryRun plans
through) the device's aggregate tablets.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from .filter import And, Eq, Node, Or, TrueNode

DEFAULT_W = 10.0  # paper: "a global, empirically derived parameter"


@dataclass
class IndexCond:
    field: str
    value: str
    density: float  # d_i: estimated matching rows in the time range


@dataclass
class QueryPlan:
    mode: str  # 'index' | 'filter' | 'empty'
    combine: str  # 'intersect' | 'union' (index mode)
    index_conds: List[IndexCond] = field(default_factory=list)
    residual: Optional[Node] = None  # tablet-server filter after the index step

    def describe(self) -> str:
        if self.mode == "filter":
            return "full tablet-server filter"
        if self.mode == "empty":
            conds = ", ".join(f"{c.field}={c.value}" for c in self.index_conds)
            return f"provably empty (zero-density condition: {conds})"
        conds = ", ".join(f"{c.field}={c.value}(d={c.density:.0f})" for c in self.index_conds)
        res = "none" if isinstance(self.residual, TrueNode) or self.residual is None else "tree"
        return f"index[{self.combine}]({conds}) residual={res}"


def _density(store, cond: Eq, t_start: int, t_stop: int) -> float:
    """d_i, read from the aggregate table over the query's time range."""
    return float(store.agg_count(cond.field, cond.value, t_start, t_stop))


def plan_query(store, tree: Optional[Node], t_start: int, t_stop: int,
               w: float = DEFAULT_W, use_index: bool = True) -> QueryPlan:
    if tree is None or isinstance(tree, TrueNode):
        return QueryPlan(mode="filter", combine="intersect", residual=TrueNode())
    if not use_index:
        return QueryPlan(mode="filter", combine="intersect", residual=tree)

    # Heuristic 1: root equality condition; zero density proves it empty.
    if isinstance(tree, Eq) and store.schema.is_indexed(tree.field):
        d = _density(store, tree, t_start, t_stop)
        if d <= 0:
            return QueryPlan(mode="empty", combine="intersect",
                             index_conds=[IndexCond(tree.field, tree.value, 0.0)])
        return QueryPlan(mode="index", combine="intersect",
                         index_conds=[IndexCond(tree.field, tree.value, d)],
                         residual=TrueNode())

    # Heuristic 2: root OR with all-equality children.
    if isinstance(tree, Or) and all(
        isinstance(c, Eq) and store.schema.is_indexed(c.field) for c in tree.children
    ):
        conds = [IndexCond(c.field, c.value, _density(store, c, t_start, t_stop))
                 for c in tree.children]
        return QueryPlan(mode="index", combine="union", index_conds=conds, residual=TrueNode())

    # Heuristic 3: root AND — index the rare equality children. A zero
    # density among them proves the whole AND empty.
    if isinstance(tree, And):
        eq_children = [c for c in tree.children
                       if isinstance(c, Eq) and store.schema.is_indexed(c.field)]
        if eq_children:
            dens = {c: _density(store, c, t_start, t_stop) for c in eq_children}
            d_min = min(dens.values())
            if d_min <= 0:
                zero = [c for c in eq_children if dens[c] <= 0]
                return QueryPlan(mode="empty", combine="intersect",
                                 index_conds=[IndexCond(c.field, c.value, 0.0) for c in zero])
            selected = [c for c in eq_children if dens[c] < w * max(d_min, 1.0)]
            if selected:
                rest = tuple(c for c in tree.children if c not in selected)
                residual: Node = And(*rest) if rest else TrueNode()
                return QueryPlan(
                    mode="index", combine="intersect",
                    index_conds=[IndexCond(c.field, c.value, dens[c]) for c in selected],
                    residual=residual,
                )

    # Heuristic 4: everything else — tablet-server filtering.
    return QueryPlan(mode="filter", combine="intersect", residual=tree)
