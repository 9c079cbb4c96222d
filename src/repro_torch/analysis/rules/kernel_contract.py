"""kernel-contract: every CUDA kernel package ships a checked plain version.

The counterpart of ``repro/analysis/rules/kernel_contract.py``. The
kernel inventory's value is the exact-agreement story: each
``kernels/<name>/`` package pairs its CUDA wrappers with the plain
PyTorch versions that the CPU tests oracle against and that every
wrapper runs on CPU tensors. The rule enforces the package shape so a new
kernel cannot silently skip it:

  * ``ops.py`` and ``ref.py`` must both exist;
  * the package ``__init__`` must re-export from BOTH ``.ops`` and
    ``.ref`` (callers and tests import the pair from one place);
  * every launching wrapper in ``ops.py`` — a top-level function that
    calls ``count_launch(globals())`` — must have a CPU branch (an ``if``
    whose test compares with ``"cpu"``) that calls a function imported
    from the package's ``.ref``, and must hold no ``try``: a failed
    launch raises, and is never hidden behind the plain version;
  * shared helpers (top-level defs of ``kernels/common.py`` and
    ``kernels/program_eval.py``, e.g. ``pow2``, ``count_launch``,
    ``as_program``) must be imported, not re-implemented — names compare
    with leading underscores stripped, so a private ``_pow2`` clone is
    still caught.

The reference's ``<stem>_pallas``/``<stem>_ref`` pairing has no
counterpart: the port's wrappers keep their public names, and the CPU
branch is the pairing. The wrapper checks apply only where ``ops.py``
calls ``count_launch``, so pointed at the reference's tree the rule holds
it to the shape checks alone, which it meets.

This is a project rule: it needs the package view, and anchors package-
level findings on the package ``__init__.py``.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..engine import FileContext, Finding, ProjectRule
from .common import dotted_name

RULE = "kernel-contract"

_SHARED_MODULES = ("common.py", "program_eval.py")


def _top_level_defs(tree: ast.Module):
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _parse(path: str) -> Optional[ast.Module]:
    try:
        with open(path, "r", encoding="utf-8") as fh:
            return ast.parse(fh.read(), filename=path)
    except (OSError, SyntaxError, ValueError):
        return None


def _calls(node: ast.AST, names: Set[str]) -> bool:
    """Whether ``node`` holds a call to a function whose dotted name is
    in ``names``."""
    return any(
        isinstance(n, ast.Call) and dotted_name(n.func) in names for n in ast.walk(node)
    )


def _ref_names(tree: ast.Module) -> Set[str]:
    """The dotted names through which a module calls into its package's
    ``.ref``: ``f`` for ``from .ref import f``, ``ref.*`` for
    ``from . import ref``."""
    names: Set[str] = set()
    for node in tree.body:
        if not isinstance(node, ast.ImportFrom) or node.level != 1:
            continue
        for alias in node.names:
            if node.module == "ref":
                names.add(alias.asname or alias.name)
            elif node.module is None and alias.name == "ref":
                names.add(f"{alias.asname or alias.name}.*")
    return names


def _is_cpu_test(test: ast.AST) -> bool:
    return any(
        isinstance(n, ast.Compare)
        and any(isinstance(c, ast.Constant) and c.value == "cpu"
                for c in [n.left, *n.comparators])
        for n in ast.walk(test)
    )


def _calls_ref(node: ast.AST, ref_names: Set[str]) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            name = dotted_name(n.func) or ""
            if name in ref_names or f"{name.rsplit('.', 1)[0]}.*" in ref_names:
                return True
    return False


class KernelContractRule(ProjectRule):
    name = RULE
    description = (
        "kernels/<name>/ must ship ops.py + ref.py, export both, give every "
        "launching wrapper (count_launch) a CPU branch into .ref and no try, "
        "and import shared helpers instead of re-implementing them"
    )

    def check_file(self, ctx: FileContext) -> List[Finding]:
        return []

    def check_project(self, ctxs: Sequence[FileContext]) -> List[Finding]:
        # A kernel package = a directory whose PARENT is named 'kernels'
        # and which contains an __init__.py, discovered from the scanned
        # file set (so the rule follows whatever tree it is pointed at).
        packages: Dict[str, FileContext] = {}
        ctx_by_abs: Dict[str, FileContext] = {}
        for ctx in ctxs:
            ap = os.path.abspath(ctx.path)
            ctx_by_abs[ap] = ctx
            d = os.path.dirname(ap)
            if os.path.basename(os.path.dirname(d)) == "kernels":
                pkg_init = os.path.join(d, "__init__.py")
                if os.path.exists(pkg_init):
                    packages.setdefault(d, None)
        findings: List[Finding] = []
        for pkg_dir in sorted(packages):
            findings.extend(self._check_package(pkg_dir, ctx_by_abs))
        return findings

    # ------------------------------------------------------------------
    def _ctx_or_parse(
        self, path: str, ctx_by_abs: Dict[str, FileContext]
    ) -> Tuple[Optional[FileContext], Optional[ast.Module]]:
        ctx = ctx_by_abs.get(os.path.abspath(path))
        if ctx is not None:
            return ctx, ctx.tree
        return None, _parse(path)

    def _check_package(
        self, pkg_dir: str, ctx_by_abs: Dict[str, FileContext]
    ) -> List[Finding]:
        findings: List[Finding] = []
        pkg = os.path.basename(pkg_dir)
        init_path = os.path.join(pkg_dir, "__init__.py")
        init_ctx, init_tree = self._ctx_or_parse(init_path, ctx_by_abs)

        def pkg_finding(message: str, ctx=None, node_or_line=1) -> Finding:
            if ctx is not None:
                return ctx.finding(RULE, node_or_line, message)
            # Anchor on the __init__ when the offending file is not in
            # the scanned set (or does not exist).
            anchor = init_ctx
            if anchor is not None:
                return anchor.finding(RULE, 1, message)
            return Finding(RULE, init_path, 1, message, snippet=f"kernels/{pkg}")

        # (a) ops.py + ref.py exist
        ops_path = os.path.join(pkg_dir, "ops.py")
        ref_path = os.path.join(pkg_dir, "ref.py")
        for req in (ops_path, ref_path):
            if not os.path.exists(req):
                findings.append(
                    pkg_finding(
                        f"kernel package '{pkg}' is missing {os.path.basename(req)} "
                        "— every kernel ships its wrappers (ops.py) AND the plain "
                        "versions (ref.py) the tests oracle against"
                    )
                )
        if not (os.path.exists(ops_path) and os.path.exists(ref_path)):
            return findings

        # (b) __init__ exports from both .ops and .ref
        if init_tree is not None:
            modules = {
                node.module
                for node in ast.walk(init_tree)
                if isinstance(node, ast.ImportFrom) and node.level >= 1
            }
            for missing in {"ops", "ref"} - modules:
                findings.append(
                    pkg_finding(
                        f"kernel package '{pkg}' __init__ does not re-export from "
                        f".{missing} — callers and tests import the wrapper/plain "
                        "pair from the package root",
                        ctx=init_ctx,
                        node_or_line=1,
                    )
                )

        # (c) every launching wrapper branches to .ref on CPU tensors and
        # never falls back from a failed launch.
        ops_ctx, ops_tree = self._ctx_or_parse(ops_path, ctx_by_abs)
        if ops_tree is not None:
            ref_names = _ref_names(ops_tree)
            for fn in _top_level_defs(ops_tree):
                if not _calls(fn, {"count_launch"}):
                    continue
                if not any(
                    isinstance(n, ast.If) and _is_cpu_test(n.test)
                    and any(_calls_ref(s, ref_names) for s in n.body)
                    for n in ast.walk(fn)
                ):
                    findings.append(
                        pkg_finding(
                            f"launching wrapper '{fn.name}' has no CPU branch into "
                            ".ref — on CPU tensors every wrapper runs its kernel's "
                            "plain version, imported from the package's ref.py",
                            ctx=ops_ctx,
                            node_or_line=fn,
                        )
                    )
                for n in ast.walk(fn):
                    if isinstance(n, ast.Try) or type(n).__name__ == "TryStar":
                        findings.append(
                            pkg_finding(
                                f"launching wrapper '{fn.name}' holds a try — a "
                                "failed launch must raise, never fall back to the "
                                "plain version behind the caller's back",
                                ctx=ops_ctx,
                                node_or_line=n,
                            )
                        )

        # (d) no re-implementation of shared kernel helpers
        kernels_dir = os.path.dirname(pkg_dir)
        shared: Set[str] = set()
        for mod in _SHARED_MODULES:
            tree = _parse(os.path.join(kernels_dir, mod))
            if tree is not None:
                shared.update(fn.name.lstrip("_") for fn in _top_level_defs(tree))
        if shared:
            for fname in sorted(
                f for f in os.listdir(pkg_dir) if f.endswith(".py")
            ):
                fpath = os.path.join(pkg_dir, fname)
                mctx, mtree = self._ctx_or_parse(fpath, ctx_by_abs)
                if mtree is None:
                    continue
                for fn in _top_level_defs(mtree):
                    if fn.name.lstrip("_") in shared:
                        findings.append(
                            pkg_finding(
                                f"'{fn.name}' re-implements shared kernel helper "
                                f"'{fn.name.lstrip('_')}' — import it from "
                                "kernels/common.py / kernels/program_eval.py "
                                "instead of cloning it per package",
                                ctx=mctx,
                                node_or_line=fn,
                            )
                        )
        return findings
