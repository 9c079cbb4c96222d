"""Trees of tensors (nested dicts, tuples and lists, None an empty
subtree) walked in JAX's flatten order: dict keys sorted, sequences in
order. The optimizer walks parameters, gradients and its state in this
order, and a checkpoint writes its leaves in it, so that the JAX
package's checkpoints and the port's hold the same leaf at the same
index."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Tuple

PyTree = Any


@dataclass(frozen=True)
class TreeDef:
    """A tree's structure without its leaves: kind is 'leaf', 'none',
    'dict', 'tuple' or 'list'; a dict's keys are sorted."""

    kind: str
    keys: Tuple = ()
    children: Tuple["TreeDef", ...] = ()

    @property
    def num_leaves(self) -> int:
        if self.kind == "leaf":
            return 1
        return sum(c.num_leaves for c in self.children)

    def __str__(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        inner = [str(c) for c in self.children]
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {c}" for k, c in zip(self.keys, inner)) + "}"
        if self.kind == "tuple":
            return "(" + ", ".join(inner) + ("," if len(inner) == 1 else "") + ")"
        return "[" + ", ".join(inner) + "]"


def tree_flatten(tree: PyTree) -> Tuple[List[Any], TreeDef]:
    leaves: List[Any] = []

    def walk(node) -> TreeDef:
        if node is None:
            return TreeDef("none")
        if isinstance(node, dict):
            keys = tuple(sorted(node))
            return TreeDef("dict", keys, tuple(walk(node[k]) for k in keys))
        if isinstance(node, (tuple, list)):
            kind = "tuple" if isinstance(node, tuple) else "list"
            return TreeDef(kind, (), tuple(walk(c) for c in node))
        leaves.append(node)
        return TreeDef("leaf")

    treedef = walk(tree)
    return leaves, treedef


def tree_leaves(tree: PyTree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_unflatten(treedef: TreeDef, leaves) -> PyTree:
    it = iter(leaves)

    def build(td: TreeDef):
        if td.kind == "leaf":
            return next(it)
        if td.kind == "none":
            return None
        children = [build(c) for c in td.children]
        if td.kind == "dict":
            return dict(zip(td.keys, children))
        return tuple(children) if td.kind == "tuple" else children

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError(f"more leaves than the tree's {treedef.num_leaves}")
    return out


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """fn over the leaves of ``tree`` and, leaf for leaf, of each tree in
    ``rest``, which must have the same structure."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for r in rest:
        r_leaves, r_def = tree_flatten(r)
        if r_def != treedef:
            raise ValueError(f"tree structures differ: {treedef} and {r_def}")
        others.append(r_leaves)
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
