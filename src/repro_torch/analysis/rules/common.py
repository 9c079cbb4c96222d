"""Small AST helpers shared by the port's lint rules (the counterpart of
``repro/analysis/rules/common.py``; ``is_fence_call`` walks receiver
chains, since torch reads a fenced value through method calls)."""
from __future__ import annotations

import ast
from typing import Iterator, Optional

#: with-item methods that take/hold a lock when called on one
LOCK_CALL_METHODS = {"hold", "reowner", "acquire"}


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def self_path(node: ast.AST) -> Optional[str]:
    """For an attribute chain rooted at ``self``, the path after it
    (``self.scheduler._cv`` -> ``scheduler._cv``); else None."""
    name = dotted_name(node)
    if name and name.startswith("self."):
        return name[len("self."):]
    return None


def lock_path_of_with_item(expr: ast.AST) -> Optional[str]:
    """The lock a ``with`` item holds, as a self-relative path.

    Recognizes ``with self.<lock>:``, ``with self.<lock>.hold(o):``,
    ``with self.<lock>.reowner(o):`` and bare ``self.<lock>.acquire(...)``
    call forms. Returns e.g. ``_lock`` or ``scheduler._cv``.
    """
    if isinstance(expr, ast.Call):
        func = expr.func
        if isinstance(func, ast.Attribute) and func.attr in LOCK_CALL_METHODS:
            return self_path(func.value)
        return None
    return self_path(expr)


def receiver_chain(node: ast.AST) -> Iterator[ast.AST]:
    """``node`` and every receiver below it, outermost first: through
    attributes, subscripts and method calls (``a.f(x)[i].g()`` yields the
    whole expression, ``a.f(x)[i]``, ``a.f(x)``, ``a``)."""
    while True:
        yield node
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            node = node.func.value
        elif isinstance(node, (ast.Attribute, ast.Subscript)):
            node = node.value
        else:
            return


def is_fence_call(node: ast.AST) -> bool:
    """True for ``<anything>.fence(...)`` — a span-charged device wait —
    and for any method chain that starts at one
    (``sp.fence(t).cpu().numpy()``)."""
    return any(
        isinstance(n, ast.Call)
        and isinstance(n.func, ast.Attribute)
        and n.func.attr == "fence"
        for n in receiver_chain(node)
    )


def func_params(fn: ast.AST) -> set:
    a = fn.args
    names = set()
    for group in (a.posonlyargs, a.args, a.kwonlyargs):
        names.update(p.arg for p in group)
    if a.vararg:
        names.add(a.vararg.arg)
    if a.kwarg:
        names.add(a.kwarg.arg)
    return names


def local_names(fn: ast.AST) -> set:
    """Names bound inside ``fn``'s own scope: params plus every Store-ctx
    Name, loop/with/comprehension target, and nested def/class name.
    Nested function bodies are NOT descended into (they are their own
    scope)."""
    names = func_params(fn)

    def visit(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.add(child.name)
                continue  # own scope
            if isinstance(child, ast.Lambda):
                continue
            if isinstance(child, ast.Name) and isinstance(
                child.ctx, (ast.Store, ast.Del)
            ):
                names.add(child.id)
            visit(child)

    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for stmt in body:
        visit(stmt)
        if isinstance(stmt, ast.Name) and isinstance(stmt.ctx, (ast.Store, ast.Del)):
            names.add(stmt.id)
    return names


def imported_names(tree: ast.AST) -> set:
    """Every name an import statement binds anywhere in the module —
    used to keep module aliases (np, torch, F...) out of the
    closed-over-container mutation check."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                names.add(alias.asname or alias.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            for alias in node.names:
                names.add(alias.asname or alias.name)
    return names


def base_name(node: ast.AST) -> Optional[str]:
    """The root Name of an attribute/subscript chain (``a.b[c].d`` -> a)."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None
