"""guarded-by: lock discipline on annotated shared fields.

The counterpart of ``repro/analysis/rules/guarded_by.py``, with the same
rule id and semantics: lock discipline has nothing JAX-specific in it.

Declare a field's lock with a trailing comment on the assignment that
introduces it (usually in ``__init__``)::

    self._fill = np.zeros(T, np.int64)  # guarded-by: _lock

From then on, every ``self._fill`` access anywhere in the class must be
(a) lexically inside ``with self._lock:`` / ``with self._lock.hold(o):``
/ ``with self._lock.reowner(o):``, or (b) inside a method annotated
``# holds: _lock`` (on the def line or the line above it) — the
annotation is the method's documented precondition, checked at its call
sites by eyeball and at its body by this rule. Dotted lock paths
(``# guarded-by: scheduler._cv``) are supported. ``__init__`` is exempt
(construction happens-before sharing), as is any line carrying a
``# guarded-by:`` declaration itself.

The rule is lexical: it cannot see locks taken by a caller (annotate the
callee with ``# holds:``) or callbacks invoked under a lock elsewhere
(suppress with a justification). That is the point — the annotation
makes the locking protocol reviewable text instead of tribal knowledge.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set

from ..engine import FileContext, Finding, Rule
from .common import lock_path_of_with_item, self_path

RULE = "guarded-by"


class GuardedByRule(Rule):
    name = RULE
    description = (
        "fields annotated '# guarded-by: <lock>' must be accessed under that "
        "lock or inside a method annotated '# holds: <lock>'"
    )

    def check_file(self, ctx: FileContext) -> List[Finding]:
        if not ctx.guarded:
            return []
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(self._check_class(ctx, node))
        return findings

    # ------------------------------------------------------------------
    def _check_class(self, ctx: FileContext, cls: ast.ClassDef) -> List[Finding]:
        guarded: Dict[str, str] = {}  # field -> lock path
        decl_lines: Set[int] = set()
        # Pass 1: find guarded declarations (any self.X assignment whose
        # statement overlaps a '# guarded-by:' line).
        for node in ast.walk(cls):
            if not isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                continue
            span = range(node.lineno, (node.end_lineno or node.lineno) + 1)
            lock = next((ctx.guarded[ln] for ln in span if ln in ctx.guarded), None)
            if lock is None:
                continue
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for tgt in targets:
                path = self_path(tgt)
                if path is not None and "." not in path:
                    guarded[path] = lock
                    decl_lines.update(span)
        if not guarded:
            return []

        findings: List[Finding] = []
        seen: Set[tuple] = set()

        def flag(node: ast.Attribute, lock: str) -> None:
            key = (node.lineno, node.attr)
            if key in seen:
                return
            seen.add(key)
            findings.append(
                ctx.finding(
                    RULE,
                    node,
                    f"'self.{node.attr}' is guarded by 'self.{lock}' but accessed "
                    f"without holding it (wrap in `with self.{lock}` / "
                    f"`.hold(owner)`, or annotate the method `# holds: {lock}`)",
                )
            )

        def visit(node: ast.AST, held: Set[str]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                inner = held | ctx.holds_for_def(node)
                for child in node.body:
                    visit(child, inner)
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                inner = set(held)
                for item in node.items:
                    lock = lock_path_of_with_item(item.context_expr)
                    if lock is not None:
                        inner.add(lock)
                    visit(item.context_expr, held)
                for child in node.body:
                    visit(child, inner)
                return
            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and node.attr in guarded
                and node.lineno not in decl_lines
            ):
                if guarded[node.attr] not in held:
                    flag(node, guarded[node.attr])
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for stmt in cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if stmt.name == "__init__":
                    continue
                visit(stmt, set())
            elif isinstance(stmt, ast.ClassDef):
                continue  # nested classes have their own field namespace
            else:
                visit(stmt, set())
        return findings
