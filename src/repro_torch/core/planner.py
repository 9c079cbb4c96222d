"""Query planner — paper §III-B; the part of the reference's
core/planner.py that the scan schemes reach.

The scan schemes plan with use_index=False, which returns a filter plan
(the whole tree runs as the tablet-server filter) before any density is
read. The four density heuristics choose index plans; they come with the
index schemes, which also bring the device density read they need.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .filter import Node, TrueNode


@dataclass
class QueryPlan:
    mode: str  # 'filter' here; 'index' and 'empty' come with the index schemes
    residual: Optional[Node] = None


def plan_query(store, tree: Optional[Node], t_start: int, t_stop: int,
               use_index: bool = True) -> QueryPlan:
    if tree is None or isinstance(tree, TrueNode):
        return QueryPlan(mode="filter", residual=TrueNode())
    if not use_index:
        return QueryPlan(mode="filter", residual=tree)
    raise NotImplementedError(
        "index planning reads densities from the aggregate tablets; it comes "
        "with the index-scheme slice of the port"
    )
