"""no-sync-in-hot-path: hidden device syncs in latency-critical code.

The counterpart of ``repro/analysis/rules/hot_path.py``, with the same
rule id and tag, for torch's sync points. Tag a function hot with
``# reprolint: hot-path`` on (or directly above) its ``def`` line — the
dist_query step, scan, density and aggregate paths and the serve_db turn
path carry the tag. Inside a hot function (nested defs inherit), the
rule flags the host-device syncs that silently serialize the pipeline:

  * ``x.item()`` / ``x.tolist()`` / ``x.cpu()`` / ``x.numpy()`` and
    ``x.to("cpu")`` / ``x.to(device="cpu")`` — a device->host copy that
    waits for the card, allowed only on a fenced chain
    (``sp.fence(x).cpu().numpy()``)
  * ``np.asarray(x)`` / ``np.array(x)``  — host materialization, allowed
                                          only on a fenced value
                                          (``np.asarray(sp.fence(x))``)
  * ``float(f(...))`` / ``int(f(...))`` / ``bool(f(...))`` — coercing a call
                                          result forces the sync inline;
                                          fence it first (``int(sp.fence(...))``)
  * ``torch.cuda.synchronize()`` and ``.synchronize()`` on a stream or
    event — an explicit wait that bypasses span accounting; use
    ``sp.fence(x)`` on an open span so the wait is charged as device time
  * ``torch.nonzero`` / ``.nonzero()``, ``torch.unique`` / ``.unique()``,
    ``torch.masked_select``, ``torch.repeat_interleave`` without
    ``output_size=`` and one-argument ``torch.where(cond)`` — ops whose
    output size depends on the data, so on CUDA they copy a count to the
    host inside the op; no fence can move that wait

A chain is fenced when it starts at ``<anything>.fence(...)``: only the
innermost sync of an unfenced chain is reported (``x.cpu().numpy()`` is
one finding). The scalar-coercion check only fires when the operand is
itself a call (the common ``int(step(...))`` shape); coercing an
already-materialized name (``int(total)`` after ``total =
sp.fence(...)``) is clean.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from ..engine import FileContext, Finding, Rule
from .common import dotted_name, is_fence_call, receiver_chain

RULE = "no-sync-in-hot-path"

_COPY_METHODS = {"item", "tolist", "cpu", "numpy"}
_MATERIALIZERS = {"np.asarray", "numpy.asarray", "np.array", "numpy.array"}
_COERCIONS = {"float", "int", "bool"}
_SYNCHRONIZERS = {"torch.cuda.synchronize", "cuda.synchronize"}
# Data-dependent output sizes: the op itself waits for the card.
_IMPLICIT = {"nonzero", "unique", "masked_select"}
_DISPLAYS = (ast.Constant, ast.List, ast.Tuple, ast.Dict, ast.Set, ast.ListComp,
             ast.SetComp, ast.DictComp, ast.GeneratorExp)


def _is_cpu_device(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (
        isinstance(node, ast.Call)
        and dotted_name(node.func) in ("torch.device", "device")
        and bool(node.args)
        and _is_cpu_device(node.args[0])
    )


def _copy_to_host(node: ast.AST) -> Optional[str]:
    """The form of a device->host copy call, or None."""
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
        return None
    attr = node.func.attr
    if attr in _COPY_METHODS:
        return f".{attr}()"
    if attr == "to":
        dev = [kw.value for kw in node.keywords if kw.arg == "device"]
        if any(_is_cpu_device(a) for a in node.args[:1] + dev):
            return '.to("cpu")'
    return None


class HotPathSyncRule(Rule):
    name = RULE
    description = (
        "no .item()/.tolist()/.cpu()/.numpy()/.to('cpu')/np.asarray/scalar-"
        "coercion syncs inside '# reprolint: hot-path' functions unless the "
        "chain starts at sp.fence(...); no torch.cuda.synchronize or "
        "data-dependent-size ops (nonzero, unique, masked_select, ...)"
    )

    def check_file(self, ctx: FileContext) -> List[Finding]:
        if not ctx.hot_lines:
            return []
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if ctx.is_hot_def(node):
                    self._check_hot(ctx, node, findings)
        return findings

    def _check_hot(self, ctx: FileContext, fn: ast.AST, findings: List[Finding]) -> None:
        # ast.walk descends into nested defs too — they run on the same
        # hot path unless they are separately (not) tagged; inherit.
        def flag(node: ast.AST, message: str) -> None:
            findings.append(ctx.finding(RULE, node, message))

        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            name = dotted_name(func)
            attr = func.attr if isinstance(func, ast.Attribute) else None
            copy = _copy_to_host(node)
            if copy is not None:
                below = list(receiver_chain(func.value))
                if is_fence_call(func.value) or any(_copy_to_host(n) for n in below):
                    continue  # fenced, or reported at the inner copy
                flag(node, f"{copy} copies a device value to the host inside a hot "
                           "path — fence it first: sp.fence(x)" + copy)
            elif name in _SYNCHRONIZERS or attr == "synchronize":
                flag(node, "bare synchronize() in a hot path bypasses span accounting "
                           "— use sp.fence(x) on the enclosing span so the wait is "
                           "charged as device time")
            elif (
                (attr in _IMPLICIT and (name or "").split(".")[0] not in ("np", "numpy"))
                or (attr == "repeat_interleave"
                    and not any(kw.arg == "output_size" for kw in node.keywords))
                or (name == "torch.where" and len(node.args) == 1 and not node.keywords)
            ):
                op = "where(cond)" if attr == "where" else attr
                flag(node, f"{op} has a data-dependent output size: on CUDA it waits "
                           "for the card inside the op (no fence can move it) — keep "
                           "it off the hot path or give it a static size")
            elif name in _MATERIALIZERS:
                arg = node.args[0] if node.args else None
                if arg is None or isinstance(arg, _DISPLAYS) or is_fence_call(arg):
                    continue
                flag(node, f"{name}(...) on a device value syncs inline in a hot "
                           f"path — fence it first: {name}(sp.fence(...))")
            elif (
                isinstance(func, ast.Name)
                and func.id in _COERCIONS
                and len(node.args) == 1
                and isinstance(node.args[0], ast.Call)
                and not is_fence_call(node.args[0])
            ):
                flag(node, f"{func.id}(...) on a call result forces a device sync in "
                           f"a hot path — fence it: {func.id}(sp.fence(...))")
