"""Filter condition trees and their compilation to the device predicate
program; a copy of the reference's core/filter.py.

The tree compiles to a postfix program over a boolean stack (opcodes in
kernels/program_eval.py), the format the ``filter_scan`` kernel runs.
String conditions resolve to dictionary code sets on the host (Match to
the codes of its prefix, Cmp on a numeric-string field to the codes whose
value passes the comparison), so the device only compares int32 codes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..kernels.program_eval import (
    MAX_STACK,
    OP_AND,
    OP_NOT,
    OP_OR,
    OP_PUSH_EQ,
    OP_PUSH_IN,
    OP_PUSH_TRUE,
)


class Node:
    """Base class for filter syntax tree nodes."""


@dataclass(frozen=True)
class Eq(Node):
    field: str
    value: str


@dataclass(frozen=True)
class Cmp(Node):
    """Inequality on a numeric-string field (the paper's 'field1 <
    value1'); op is one of '<', '<=', '>', '>='."""

    field: str
    op: str
    value: float


@dataclass(frozen=True)
class Match(Node):
    """Prefix match: the host-resolvable core of the paper's regex
    conditions."""

    field: str
    prefix: str


@dataclass(frozen=True)
class In(Node):
    field: str
    values: Tuple[str, ...]


@dataclass(frozen=True)
class And(Node):
    children: Tuple[Node, ...]

    def __init__(self, *children: Node):
        object.__setattr__(self, "children", tuple(children))


@dataclass(frozen=True)
class Or(Node):
    children: Tuple[Node, ...]

    def __init__(self, *children: Node):
        object.__setattr__(self, "children", tuple(children))


@dataclass(frozen=True)
class Not(Node):
    child: Node


@dataclass(frozen=True)
class TrueNode(Node):
    """Matches everything."""


@dataclass
class FilterProgram:
    """Device-executable predicate program."""

    opcodes: np.ndarray  # int32 [P]
    arg0: np.ndarray  # int32 [P]   field id
    arg1: np.ndarray  # int32 [P]   code (PUSH_EQ) or codeset row (PUSH_IN)
    codesets: np.ndarray  # int32 [n_sets, max_set] padded with -1
    max_depth: int

    @property
    def length(self) -> int:
        return int(self.opcodes.shape[0])


class _Compiler:
    def __init__(self, store):
        self.store = store
        self.ops: List[Tuple[int, int, int]] = []
        self.codesets: List[np.ndarray] = []

    def _codeset(self, codes: np.ndarray) -> int:
        self.codesets.append(np.asarray(codes, dtype=np.int32))
        return len(self.codesets) - 1

    def emit(self, node: Node) -> int:
        """Returns the stack depth the subtree needs."""
        if isinstance(node, TrueNode):
            self.ops.append((OP_PUSH_TRUE, 0, 0))
            return 1
        if isinstance(node, Eq):
            fid = self.store.schema.field_id(node.field)
            code = self.store.dictionaries[node.field].lookup(node.value)
            if code is None:
                # Never-ingested value: matches nothing == IN(empty set).
                self.ops.append((OP_PUSH_IN, fid, self._codeset(np.empty(0, np.int32))))
            else:
                self.ops.append((OP_PUSH_EQ, fid, int(code)))
            return 1
        if isinstance(node, (Match, In, Cmp)):
            fid = self.store.schema.field_id(node.field)
            codes = resolve_codes(self.store, node)
            self.ops.append((OP_PUSH_IN, fid, self._codeset(codes)))
            return 1
        if isinstance(node, Not):
            d = self.emit(node.child)
            self.ops.append((OP_NOT, 0, 0))
            return d
        if isinstance(node, (And, Or)):
            opc = OP_AND if isinstance(node, And) else OP_OR
            if not node.children:
                raise ValueError("empty boolean node")
            depth = self.emit(node.children[0])
            for child in node.children[1:]:
                depth = max(depth, 1 + self.emit(child))
                self.ops.append((opc, 0, 0))
            return depth
        raise TypeError(f"unknown node {node!r}")


_CMP = {
    "<": lambda x, v: x < v,
    "<=": lambda x, v: x <= v,
    ">": lambda x, v: x > v,
    ">=": lambda x, v: x >= v,
}


def resolve_codes(store, node: Node) -> np.ndarray:
    """The int32 code set of a Match, In or Cmp condition, in dictionary
    order (Match, Cmp) or the order of the values (In)."""
    d = store.dictionaries[node.field]
    if isinstance(node, Match):
        return d.prefix_codes(node.prefix)
    if isinstance(node, In):
        codes = [d.lookup(v) for v in node.values]
        return np.asarray([c for c in codes if c is not None], dtype=np.int32)
    if isinstance(node, Cmp):
        # An unknown op matches nothing, as in the reference.
        test = _CMP.get(node.op, lambda x, v: False)
        out = []
        for s, c in d._fwd.items():
            try:
                x = float(s)
            except ValueError:
                continue
            if test(x, node.value):
                out.append(c)
        return np.asarray(out, dtype=np.int32)
    raise TypeError(node)


def compile_tree(store, tree: Optional[Node]) -> FilterProgram:
    """Compile a filter tree against a store's schema and dictionaries."""
    comp = _Compiler(store)
    depth = comp.emit(tree if tree is not None else TrueNode())
    if depth > MAX_STACK:
        raise ValueError(f"filter tree too deep for device stack ({depth} > {MAX_STACK})")
    ops = np.asarray(comp.ops, dtype=np.int32).reshape(-1, 3)
    max_set = max((len(c) for c in comp.codesets), default=0)
    n_sets = max(len(comp.codesets), 1)
    codesets = np.full((n_sets, max(max_set, 1)), -1, dtype=np.int32)
    for i, cs in enumerate(comp.codesets):
        codesets[i, : len(cs)] = cs
    return FilterProgram(
        opcodes=ops[:, 0].copy(),
        arg0=ops[:, 1].copy(),
        arg1=ops[:, 2].copy(),
        codesets=codesets,
        max_depth=depth,
    )


def eval_tree_rows(store, tree: Optional[Node], cols: np.ndarray) -> np.ndarray:
    """Host oracle: the tree evaluated over (n, n_fields) int32 code rows."""
    if tree is None or isinstance(tree, TrueNode):
        return np.ones(cols.shape[0], dtype=bool)
    if isinstance(tree, Eq):
        code = store.dictionaries[tree.field].lookup(tree.value)
        fid = store.schema.field_id(tree.field)
        if code is None:
            return np.zeros(cols.shape[0], dtype=bool)
        return cols[:, fid] == code
    if isinstance(tree, (Match, In, Cmp)):
        fid = store.schema.field_id(tree.field)
        return np.isin(cols[:, fid], resolve_codes(store, tree))
    if isinstance(tree, Not):
        return ~eval_tree_rows(store, tree.child, cols)
    if isinstance(tree, (And, Or)):
        out = eval_tree_rows(store, tree.children[0], cols)
        for c in tree.children[1:]:
            if isinstance(tree, And):
                out &= eval_tree_rows(store, c, cols)
            else:
                out |= eval_tree_rows(store, c, cols)
        return out
    raise TypeError(tree)
