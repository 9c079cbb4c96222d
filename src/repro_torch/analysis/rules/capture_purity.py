"""capture-purity: code captured into a CUDA graph or compiled must be pure.

The counterpart of ``repro/analysis/rules/jit_purity.py``, with its three
checks on the same lexical resolution, for torch's capturing entry
points. A function handed (positionally, through ``functools.partial``,
inside the tuple ``make_graphed_callables`` takes, or as a decorator) to
``torch.cuda.make_graphed_callables`` / ``torch.compile`` /
``torch.jit.script`` / ``torch.jit.trace`` runs its Python body at
capture (or trace) time, and a replay runs only the recorded device
work; so does the body of ``with torch.cuda.graph(g):``. Host side
effects there either happen once and never again on replay or leak
capture-time values into live state. The rule flags, inside such a
function (and its nested helpers) or ``with`` body:

  * assignments to ``self.<attr>``        — capture-time object mutation
  * calls into ``time.*`` / ``random.*`` / ``np.random.*`` — host
    nondeterminism baked into the graph (a ``torch.Generator`` is fine:
    its state is explicit)
  * mutation of closed-over host containers — ``xs.append(...)``,
    ``d[k] = v``, ``s.add(...)`` etc. where the receiver is a free
    variable of the captured code (for a ``with`` body: a name the body
    does not bind itself; locals and parameters of a function are fine)

Only callees defined in the same file are checked (a Name that resolves
to an import or a runtime-built closure is skipped — dynamic tests cover
those); that keeps the rule zero-false-positive on idiomatic code. It
guards the CUDA-graph capture of the decode step, the next step past the
hand-written kernels.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from ..engine import FileContext, Finding, Rule
from .common import base_name, dotted_name, imported_names, local_names

RULE = "capture-purity"

_CAPTURERS = {
    "torch.cuda.make_graphed_callables", "cuda.make_graphed_callables",
    "make_graphed_callables", "torch.compile", "torch.jit.script", "torch.jit.trace",
    "jit.script", "jit.trace",
}
_GRAPH_CONTEXTS = {"torch.cuda.graph", "cuda.graph", "torch.cuda.graphs.graph"}
_IMPURE_PREFIXES = ("time.", "random.", "np.random.", "numpy.random.")
_MUTATORS = {
    "append",
    "extend",
    "insert",
    "add",
    "update",
    "setdefault",
    "pop",
    "popitem",
    "remove",
    "discard",
    "clear",
    "appendleft",
    "extendleft",
}


def _captured_args(call: ast.Call) -> List[ast.AST]:
    """The function arguments of a capturing call, unwrapping partial(...)
    and the callables tuple of make_graphed_callables."""
    if not call.args:
        return []
    arg = call.args[0]
    elts = arg.elts if isinstance(arg, (ast.Tuple, ast.List)) else [arg]
    out = []
    for elt in elts:
        if isinstance(elt, ast.Call):
            inner = dotted_name(elt.func)
            if inner and inner.split(".")[-1] == "partial" and elt.args:
                out.append(elt.args[0])
            continue
        out.append(elt)
    return out


def _stored_names(body: List[ast.AST]) -> Set[str]:
    """Every name a block of statements binds (targets, loop and with
    variables, nested def and class names)."""
    names: Set[str] = set()
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Name) and isinstance(node.ctx, (ast.Store, ast.Del)):
                names.add(node.id)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.add(node.name)
    return names


class CapturePurityRule(Rule):
    name = RULE
    description = (
        "functions captured by torch.cuda.make_graphed_callables/torch.compile/"
        "torch.jit.script/torch.jit.trace and 'with torch.cuda.graph' bodies "
        "must not assign self.*, call time./random., or mutate closed-over "
        "containers"
    )

    def check_file(self, ctx: FileContext) -> List[Finding]:
        findings: List[Finding] = []
        checked: Set[int] = set()  # id() of FunctionDefs already checked

        def walk_scope(body, scopes: List[Dict[str, ast.AST]]) -> None:
            scope: Dict[str, ast.AST] = {}
            for node in body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    scope[node.name] = node
            frames = scopes + [scope]

            def resolve(name: str) -> Optional[ast.AST]:
                for frame in reversed(frames):
                    if name in frame:
                        return frame[name]
                return None

            def scan(node: ast.AST) -> None:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    for dec in node.decorator_list:
                        if dotted_name(dec) in _CAPTURERS or (
                            isinstance(dec, ast.Call) and dotted_name(dec.func) in _CAPTURERS
                        ):
                            self._check_pure(ctx, node, findings, checked)
                    walk_scope(node.body, frames)
                    return
                if isinstance(node, ast.ClassDef):
                    walk_scope(node.body, frames)
                    return
                if isinstance(node, ast.Call) and dotted_name(node.func) in _CAPTURERS:
                    for target in _captured_args(node):
                        if isinstance(target, ast.Name):
                            fn = resolve(target.id)
                            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                                self._check_pure(ctx, fn, findings, checked)
                        elif isinstance(target, ast.Lambda):
                            self._check_pure(ctx, target, findings, checked)
                if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                    isinstance(item.context_expr, ast.Call)
                    and dotted_name(item.context_expr.func) in _GRAPH_CONTEXTS
                    for item in node.items
                ):
                    bound = _stored_names(node.body) | imported_names(ctx.tree)
                    self._scan_body(ctx, "with torch.cuda.graph body", node.body, bound,
                                    findings)
                for child in ast.iter_child_nodes(node):
                    scan(child)

            for node in body:
                scan(node)

        walk_scope(ctx.tree.body, [])
        return findings

    # ------------------------------------------------------------------
    def _check_pure(
        self,
        ctx: FileContext,
        fn: ast.AST,
        findings: List[Finding],
        checked: Set[int],
    ) -> None:
        if id(fn) in checked:
            return
        checked.add(id(fn))
        name = f"captured function '{getattr(fn, 'name', '<lambda>')}'"
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        # Module aliases (np, torch, functools...) are never "closed-over
        # containers" — treat them as bound.
        bound = local_names(fn) | imported_names(ctx.tree)
        self._scan_body(ctx, name, body, bound, findings)

    def _scan_body(
        self,
        ctx: FileContext,
        name: str,
        body: List[ast.AST],
        bound: Set[str],
        findings: List[Finding],
    ) -> None:
        def flag(node: ast.AST, what: str) -> None:
            findings.append(ctx.finding(RULE, node, f"{name} {what}"))

        def scan(node: ast.AST) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # nested helper: captured too; its locals shadow, outer
                # locals become part of its (allowed) closure only if
                # they are OUR locals — keep them in `bound`.
                self._scan_body(ctx, name, node.body, bound | local_names(node), findings)
                return
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for tgt in targets:
                    for leaf in ast.walk(tgt):
                        if (
                            isinstance(leaf, ast.Attribute)
                            and isinstance(leaf.value, ast.Name)
                            and leaf.value.id == "self"
                            and isinstance(leaf.ctx, ast.Store)
                        ):
                            flag(leaf, f"assigns 'self.{leaf.attr}' at capture time")
                        elif isinstance(leaf, ast.Subscript) and isinstance(
                            leaf.ctx, ast.Store
                        ):
                            root = base_name(leaf.value)
                            if root and root not in bound and root != "self":
                                flag(
                                    leaf,
                                    f"mutates closed-over container '{root}' via "
                                    "subscript store",
                                )
            if isinstance(node, ast.Call):
                dn = dotted_name(node.func)
                if dn and dn.startswith(_IMPURE_PREFIXES):
                    flag(node, f"calls host-impure '{dn}' (runs once at capture time)")
                elif (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in _MUTATORS
                ):
                    root = base_name(node.func.value)
                    if (
                        root
                        and root not in bound
                        and root != "self"
                        and isinstance(node.func.value, ast.Name)
                    ):
                        flag(
                            node,
                            f"mutates closed-over container '{root}."
                            f"{node.func.attr}(...)'",
                        )
            for child in ast.iter_child_nodes(node):
                scan(child)

        for stmt in body:
            scan(stmt)
