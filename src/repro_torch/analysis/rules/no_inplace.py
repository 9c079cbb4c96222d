"""no-inplace-in-plane: the plane modules must not write published buffers.

The counterpart of ``repro/analysis/rules/no_donate.py``. There the
hazard is buffer donation; in the port it is an in-place write.
``DistIngestPlane.publish()`` hands out ZERO-COPY snapshots: the
published DistStore aliases the plane's state tensors, and every
in-flight QueryRun pins such a snapshot for its whole lifetime. Each
compaction step therefore returns new tensors, and one stray in-place
write to a base slab would change rows under a live query. The single
sanctioned write — the memtable append, which publish() never aliases
(it seals a sorted COPY) — carries inline suppressions with that
justification; any new in-place write in ``core/dist_ingest.py`` /
``core/dist_query.py`` is a correctness bug until proven otherwise.

In those two files the rule flags three forms of in-place write:

  * a trailing-underscore method (``index_add_``, ``copy_``,
    ``scatter_``, ``scatter_reduce_``, ``index_put_``, ``masked_fill_``,
    ``fill_``, ``zero_``, ``add_``, ...) — the write goes to its receiver
  * an ``out=`` keyword — the write goes to its value
  * a subscript store, plain or augmented (``x[i] = v``, ``x[i] += v``)
    — the write goes to ``x``

and reports one only when the written object is rooted (through
attributes, subscripts and view methods such as ``.view()``,
``.reshape()``, ``.unbind()``) at ``self``, at a parameter of the
enclosing function, or at a local that function bound to such an
expression (``slab = st["ev_base_k"]``). A name the function binds to a
fresh allocation — ``torch.empty``/``zeros``/``ones``/``full`` and their
``*_like`` forms, ``arange``, ``.clone()``, ``.copy()``, ``torch.where``,
the ``np`` allocators, or a list, dict or set display — is its own and
stays clean, as does anything else not rooted at a parameter or ``self``
(the rule cannot know types, so it stays quiet rather than guess).

Two narrowings, pinned by the tests, keep host containers out:

  * a subscript store whose key is a string literal or an f-string
    (``out[f"{p}_base_k"] = ...``) is a dict entry, never a tensor
    element — torch and numpy take no string index;
  * a subscript store straight into an attribute that the same file
    declares a container — annotated ``Dict``/``List``/``Set``/``Deque``
    (or their builtins), or assigned a display, ``dict()``/``list()``/
    ``set()``/``deque()``, ``[x] * n`` or ``field(default_factory=...)``
    of one — is an entry of that container (``d.density_cache[k] = n``,
    ``self._gauge_gens[g] = gen``). An element of such an entry is
    still checked: ``self.state[k] = t`` rebinds an entry, while
    ``self.state[k][i] = v`` writes a tensor in place and is reported.

Augmented assignment to a bare name or attribute (``x += y``) is not
flagged: on numbers it rebinds, and the rule cannot tell.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from ..engine import FileContext, Finding, Rule, norm_path
from .common import dotted_name, func_params

RULE = "no-inplace-in-plane"

_PLANE_FILES = {"repro_torch/core/dist_ingest.py", "repro_torch/core/dist_query.py"}
_ALLOCATORS = {
    "empty", "zeros", "ones", "full", "empty_like", "zeros_like", "ones_like",
    "full_like", "arange", "where",
}
_ALLOCATOR_MODULES = {"torch", "np", "numpy"}
_FRESH_METHODS = {"clone", "copy"}
# Methods whose result shares its receiver's storage.
_VIEW_METHODS = {
    "view", "view_as", "reshape", "unbind", "split", "chunk", "narrow", "select",
    "t", "transpose", "permute", "squeeze", "unsqueeze", "expand", "expand_as",
    "flatten", "unflatten", "diagonal", "movedim", "as_strided", "contiguous",
    "detach", "to",
}
_DISPLAYS = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp, ast.SetComp)
_CONTAINER_TYPES = {
    "Dict", "List", "Set", "Deque", "DefaultDict", "OrderedDict", "MutableMapping",
    "dict", "list", "set", "deque", "defaultdict",
}

_FRESH = "fresh"


def _is_fresh(node: ast.AST) -> bool:
    """A new allocation that no snapshot can alias."""
    if isinstance(node, _DISPLAYS):
        return True
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func)
    if name in ("dict", "list", "set"):
        return True
    if name and "." in name:
        mod, last = name.rsplit(".", 1)
        if mod in _ALLOCATOR_MODULES and last in _ALLOCATORS:
            return True
    return isinstance(node.func, ast.Attribute) and node.func.attr in _FRESH_METHODS


def _origin(node: ast.AST) -> Optional[str]:
    """The name an expression's storage is rooted at (through attributes,
    subscripts and view methods), ``_FRESH`` for a new allocation, or
    None when it cannot be told."""
    while True:
        if _is_fresh(node):
            return _FRESH
        if isinstance(node, (ast.Attribute, ast.Subscript)):
            node = node.value
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _VIEW_METHODS
        ):
            node = node.func.value
        elif isinstance(node, ast.Name):
            return node.id
        else:
            return None


def _is_str_key(target: ast.Subscript) -> bool:
    key = target.slice
    return isinstance(key, ast.JoinedStr) or (
        isinstance(key, ast.Constant) and isinstance(key.value, str)
    )


def _is_container_value(node: Optional[ast.AST]) -> bool:
    if isinstance(node, _DISPLAYS):
        return True
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        return isinstance(node.left, ast.List) or isinstance(node.right, ast.List)
    if not isinstance(node, ast.Call):
        return False
    name = (dotted_name(node.func) or "").split(".")[-1]
    if name == "field":
        return any(kw.arg == "default_factory"
                   and (dotted_name(kw.value) or "").split(".")[-1] in _CONTAINER_TYPES
                   for kw in node.keywords)
    return name in _CONTAINER_TYPES


def _container_attrs(tree: ast.Module) -> Set[str]:
    """Attribute names the file declares as host containers: annotated
    with a container type, or assigned a container (``self.x = {}``,
    ``x: dict = field(default_factory=dict)`` in a class body)."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.AnnAssign):
            targets, value = [node.target], node.value
            ann = node.annotation
            ann = ann.value if isinstance(ann, ast.Subscript) else ann
            declared = (dotted_name(ann) or "").split(".")[-1] in _CONTAINER_TYPES
        elif isinstance(node, ast.Assign):
            targets, value, declared = node.targets, node.value, False
        else:
            continue
        if not (declared or _is_container_value(value)):
            continue
        for tgt in targets:
            if isinstance(tgt, ast.Attribute):
                names.add(tgt.attr)
            elif isinstance(tgt, ast.Name) and isinstance(node, ast.AnnAssign):
                names.add(tgt.id)  # a class-level (dataclass) field
    return names


class _Scope:
    """One function's parameters and what its own body binds each local
    name to: fresh allocations, and the names other bindings root at."""

    def __init__(self, fn: ast.AST):
        self.params: Set[str] = func_params(fn)
        self.fresh: Set[str] = set()
        self.roots: Dict[str, Set[Optional[str]]] = {}

        def bind(target: ast.AST, value: Optional[ast.AST]) -> None:
            if isinstance(target, ast.Name):
                origin = None if value is None else _origin(value)
                if origin == _FRESH:
                    self.fresh.add(target.id)
                else:
                    self.roots.setdefault(target.id, set()).add(origin)
            elif isinstance(target, (ast.Tuple, ast.List)):
                pair = (
                    isinstance(value, (ast.Tuple, ast.List))
                    and len(value.elts) == len(target.elts)
                )
                for i, elt in enumerate(target.elts):
                    bind(elt, value.elts[i] if pair else value)

        for node in _own_nodes(fn):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    bind(tgt, node.value)
            elif isinstance(node, (ast.AnnAssign, ast.NamedExpr)) and node.value is not None:
                bind(node.target, node.value)
            elif isinstance(node, (ast.For, ast.AsyncFor, ast.comprehension)):
                bind(node.target, None)
            elif isinstance(node, ast.withitem) and node.optional_vars is not None:
                bind(node.optional_vars, None)

    def binds(self, name: str) -> bool:
        return name in self.params or name in self.fresh or name in self.roots


def _own_nodes(fn: ast.AST):
    """Every node of ``fn``'s body outside nested defs and lambdas."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                                      ast.ClassDef)):
                stack.append(child)


class NoInplaceInPlaneRule(Rule):
    name = RULE
    description = (
        "in-place tensor writes (x.op_(...), out=, x[i] = v) to buffers rooted at "
        "self or a parameter are forbidden in the plane modules — publish() "
        "zero-copy snapshots alias plane buffers"
    )

    def check_file(self, ctx: FileContext) -> List[Finding]:
        if norm_path(ctx.path) not in _PLANE_FILES:
            return []
        findings: List[Finding] = []
        containers = _container_attrs(ctx.tree)

        def visit(node: ast.AST, scopes: List[_Scope]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scopes = scopes + [_Scope(node)]
            elif scopes:
                self._check_node(ctx, node, scopes, containers, findings)
            for child in ast.iter_child_nodes(node):
                visit(child, scopes)

        visit(ctx.tree, [])
        return findings

    # ------------------------------------------------------------------
    def _check_node(self, ctx: FileContext, node: ast.AST, scopes: List[_Scope],
                    containers: Set[str], findings: List[Finding]) -> None:
        writes = []  # (anchor node, written expression, form)
        if isinstance(node, ast.Call):
            func = node.func
            if (
                isinstance(func, ast.Attribute)
                and func.attr.endswith("_")
                and not func.attr.startswith("_")
            ):
                writes.append((node, func.value, f".{func.attr}(...)"))
            for kw in node.keywords:
                if kw.arg == "out":
                    writes.append((kw.value, kw.value, "out="))
        elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for tgt in targets:
                for leaf in ast.walk(tgt):
                    if (
                        isinstance(leaf, ast.Subscript)
                        and isinstance(leaf.ctx, ast.Store)
                        and not _is_str_key(leaf)
                        and not (isinstance(leaf.value, ast.Attribute)
                                 and leaf.value.attr in containers)
                    ):
                        form = "augmented subscript store" if isinstance(
                            node, ast.AugAssign) else "subscript store"
                        writes.append((leaf, leaf.value, form))
        for anchor, written, form in writes:
            root = self._root(_origin(written), scopes)
            if root is not None:
                findings.append(ctx.finding(
                    RULE, anchor,
                    f"in-place write ({form}) to a buffer rooted at '{root}' in a "
                    "plane module: published snapshots alias plane buffers zero-copy, "
                    "so an in-place write changes rows an in-flight query still "
                    "reads — write a fresh tensor (torch.where, .clone()) instead",
                ))

    @staticmethod
    def _root(origin: Optional[str], scopes: List[_Scope]) -> Optional[str]:
        """``self`` or the parameter ``origin`` roots at, following local
        aliases through the innermost scope that binds each name; None
        when the write goes to a fresh or unknown object."""
        seen: Set[str] = set()
        todo = [origin]
        while todo:
            name = todo.pop()
            if name is None or name == _FRESH or name in seen:
                continue
            seen.add(name)
            if name == "self":
                return name
            scope = next((s for s in reversed(scopes) if s.binds(name)), None)
            if scope is None or name in scope.fresh:
                continue
            if name in scope.params:
                return name
            todo.extend(scope.roots.get(name, ()))
        return None
