"""The port's lint engine: file walking, directive parsing, baselines,
reporters — the counterpart of ``repro/analysis/engine.py``, with the
same behaviour, so one annotation serves both linters.

The engine is deliberately small — rules do the real work. It owns the
pieces every rule shares:

  * ``FileContext`` — one parsed source file plus its comment directives
    (``# guarded-by:``, ``# holds:``, ``# reprolint: hot-path``,
    ``# reprolint: disable=...``), extracted per physical line so rules
    never re-scan source text.
  * ``Finding`` — rule id + file:line + message + the offending source
    line (the *fingerprint* used for baseline matching; line numbers
    churn, stripped line text rarely does).
  * Inline suppression — a finding whose line carries
    ``# reprolint: disable=<rule>[,<rule>...]`` (or ``disable=all``) is
    dropped before reporting.
  * ``Baseline`` — grandfathered findings checked into
    ``analysis/baseline.json``, each with a mandatory one-line
    justification. The baseline is a RATCHET: an entry that no longer
    matches any real finding is *stale* and fails the run, so the list
    only shrinks.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

# --------------------------------------------------------------------------
# Comment-directive grammar. Directives attach to the physical line they sit
# on; rules decide which lines they consult (e.g. a ``def``'s directives may
# live on the def line or the line above it — see FileContext.def_lines).
# --------------------------------------------------------------------------
_DISABLE_RE = re.compile(r"#\s*reprolint:\s*disable=([A-Za-z0-9_,\- ]+)")
_HOT_RE = re.compile(r"#\s*reprolint:\s*hot-path\b")
_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][\w.]*)")
_HOLDS_RE = re.compile(r"#\s*holds:\s*([A-Za-z_][\w.]*(?:\s*,\s*[A-Za-z_][\w.]*)*)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str  # as given on the command line (usually repo-relative)
    line: int  # 1-based
    message: str
    snippet: str = ""  # stripped source line — the baseline fingerprint

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, norm_path(self.path), self.snippet)


class FileContext:
    """A parsed source file plus its per-line reprolint directives."""

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.lines: List[str] = source.splitlines()
        self.tree = tree
        # line -> payload, all 1-based
        self.disable: Dict[int, Set[str]] = {}
        self.hot_lines: Set[int] = set()
        self.guarded: Dict[int, str] = {}
        self.holds: Dict[int, Tuple[str, ...]] = {}
        for i, text in enumerate(self.lines, start=1):
            if "#" not in text:
                continue
            m = _DISABLE_RE.search(text)
            if m:
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                self.disable.setdefault(i, set()).update(rules)
            if _HOT_RE.search(text):
                self.hot_lines.add(i)
            m = _GUARDED_RE.search(text)
            if m:
                self.guarded[i] = m.group(1)
            m = _HOLDS_RE.search(text)
            if m:
                self.holds[i] = tuple(p.strip() for p in m.group(1).split(","))

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    @staticmethod
    def def_lines(node: ast.AST) -> List[int]:
        """Lines where a function/class-level directive may sit: the def
        line itself, each decorator line, and the line directly above the
        first of those (a full-line comment)."""
        lines = [node.lineno]
        for dec in getattr(node, "decorator_list", []):
            lines.append(dec.lineno)
        lines.append(min(lines) - 1)
        return lines

    def is_hot_def(self, node: ast.AST) -> bool:
        return any(ln in self.hot_lines for ln in self.def_lines(node))

    def holds_for_def(self, node: ast.AST) -> Set[str]:
        out: Set[str] = set()
        for ln in self.def_lines(node):
            out.update(self.holds.get(ln, ()))
        return out

    def suppressed(self, finding: Finding) -> bool:
        rules = self.disable.get(finding.line)
        if not rules:
            return False
        return finding.rule in rules or "all" in rules

    def finding(self, rule: str, node_or_line, message: str) -> Finding:
        lineno = getattr(node_or_line, "lineno", node_or_line)
        return Finding(
            rule=rule,
            path=self.path,
            line=int(lineno),
            message=message,
            snippet=self.line_text(int(lineno)),
        )


# --------------------------------------------------------------------------
# Rule protocol. File rules run once per file; project rules run once over
# the whole file set (kernel-contract needs the package view).
# --------------------------------------------------------------------------
class Rule:
    name = "rule"
    description = ""

    def check_file(self, ctx: FileContext) -> List[Finding]:  # pragma: no cover
        return []


class ProjectRule(Rule):
    def check_project(self, ctxs: Sequence[FileContext]) -> List[Finding]:  # pragma: no cover
        return []


def all_rules() -> List[Rule]:
    from .rules import REGISTRY

    return [cls() for cls in REGISTRY]


# --------------------------------------------------------------------------
# Baseline: grandfathered findings with justifications, matched by
# (rule, normalized path, stripped line text) so line-number churn does not
# invalidate entries. Stale entries (matching nothing) fail the run.
# --------------------------------------------------------------------------
def norm_path(path: str) -> str:
    p = path.replace("\\", "/")
    if "src/" in p:
        p = p[p.rindex("src/") + len("src/"):]
    return p.lstrip("./")


@dataclasses.dataclass
class BaselineEntry:
    rule: str
    file: str
    snippet: str
    justification: str

    def matches(self, f: Finding) -> bool:
        return (
            self.rule == f.rule
            and norm_path(self.file) == norm_path(f.path)
            and self.snippet.strip() == f.snippet
        )


@dataclasses.dataclass
class Baseline:
    path: Optional[str]
    entries: List[BaselineEntry]

    def split(self, findings: Sequence[Finding]):
        """Partition findings into (fresh, baselined) and return the stale
        baseline entries that matched nothing."""
        used = [False] * len(self.entries)
        fresh: List[Finding] = []
        baselined: List[Finding] = []
        for f in findings:
            hit = False
            for i, e in enumerate(self.entries):
                if e.matches(f):
                    used[i] = True
                    hit = True
            (baselined if hit else fresh).append(f)
        stale = [e for i, e in enumerate(self.entries) if not used[i]]
        return fresh, baselined, stale


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline.json")


def load_baseline(path: Optional[str]) -> Baseline:
    if path is None or not os.path.exists(path):
        return Baseline(path=path, entries=[])
    with open(path, "r", encoding="utf-8") as fh:
        raw = json.load(fh)
    entries = []
    for e in raw.get("entries", []):
        if not str(e.get("justification", "")).strip():
            raise ValueError(
                f"baseline entry for {e.get('file')} rule={e.get('rule')} "
                "has no justification — every grandfathered finding must say why"
            )
        entries.append(
            BaselineEntry(
                rule=str(e["rule"]),
                file=str(e["file"]),
                snippet=str(e["snippet"]),
                justification=str(e["justification"]),
            )
        )
    return Baseline(path=path, entries=entries)


# --------------------------------------------------------------------------
# Runner
# --------------------------------------------------------------------------
@dataclasses.dataclass
class AnalysisResult:
    findings: List[Finding]  # post-suppression, pre-baseline (fresh + baselined)
    fresh: List[Finding]
    baselined: List[Finding]
    stale_baseline: List[BaselineEntry]
    parse_errors: List[Tuple[str, str]]

    @property
    def failed(self) -> bool:
        return bool(self.fresh or self.stale_baseline or self.parse_errors)


def collect_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs if d not in {"__pycache__", ".git", ".venv"}
                )
                for name in sorted(files):
                    if name.endswith(".py"):
                        out.append(os.path.join(root, name))
        elif p.endswith(".py"):
            out.append(p)
    # De-dup while preserving order
    seen: Set[str] = set()
    uniq = []
    for p in out:
        ap = os.path.abspath(p)
        if ap not in seen:
            seen.add(ap)
            uniq.append(p)
    return uniq


def _load_context(path: str) -> Tuple[Optional[FileContext], Optional[str]]:
    try:
        with open(path, "r", encoding="utf-8") as fh:
            source = fh.read()
        tree = ast.parse(source, filename=path)
    except (OSError, SyntaxError, ValueError) as exc:
        return None, f"{exc}"
    return FileContext(path, source, tree), None


def run_analysis(
    paths: Sequence[str],
    rules: Optional[Sequence[Rule]] = None,
    baseline: Optional[Baseline] = None,
) -> AnalysisResult:
    rules = list(rules) if rules is not None else all_rules()
    baseline = baseline if baseline is not None else Baseline(None, [])
    files = collect_files(paths)
    ctxs: List[FileContext] = []
    parse_errors: List[Tuple[str, str]] = []
    for path in files:
        ctx, err = _load_context(path)
        if ctx is None:
            parse_errors.append((path, err or "parse error"))
        else:
            ctxs.append(ctx)

    findings: List[Finding] = []
    by_path = {c.path: c for c in ctxs}
    for rule in rules:
        raw: List[Finding] = []
        for ctx in ctxs:
            raw.extend(rule.check_file(ctx))
        if isinstance(rule, ProjectRule):
            raw.extend(rule.check_project(ctxs))
        for f in raw:
            ctx = by_path.get(f.path)
            if ctx is not None and ctx.suppressed(f):
                continue
            findings.append(f)

    findings.sort(key=lambda f: (norm_path(f.path), f.line, f.rule))
    fresh, baselined, stale = baseline.split(findings)
    return AnalysisResult(
        findings=findings,
        fresh=fresh,
        baselined=baselined,
        stale_baseline=stale,
        parse_errors=parse_errors,
    )


# --------------------------------------------------------------------------
# Reporters
# --------------------------------------------------------------------------
def render_text(result: AnalysisResult, verbose: bool = False) -> str:
    out: List[str] = []
    for path, err in result.parse_errors:
        out.append(f"{path}: [parse-error] {err}")
    for f in result.fresh:
        out.append(f"{f.path}:{f.line}: [{f.rule}] {f.message}")
    if verbose:
        for f in result.baselined:
            out.append(f"{f.path}:{f.line}: [{f.rule}] (baselined) {f.message}")
    for e in result.stale_baseline:
        out.append(
            f"{e.file}: [stale-baseline] entry for rule '{e.rule}' "
            f"(snippet {e.snippet!r}) no longer matches any finding — "
            "remove it from baseline.json (the baseline only shrinks)"
        )
    n_fresh, n_base = len(result.fresh), len(result.baselined)
    out.append(
        f"reprolint: {n_fresh} finding(s), {n_base} baselined, "
        f"{len(result.stale_baseline)} stale baseline entr(ies), "
        f"{len(result.parse_errors)} parse error(s)"
    )
    return "\n".join(out)


def render_json(result: AnalysisResult) -> str:
    payload = {
        "version": 1,
        "findings": [
            {
                "rule": f.rule,
                "file": f.path,
                "line": f.line,
                "message": f.message,
                "snippet": f.snippet,
                "baselined": f in result.baselined,
            }
            for f in result.findings
        ],
        "stale_baseline": [dataclasses.asdict(e) for e in result.stale_baseline],
        "parse_errors": [{"file": p, "error": e} for p, e in result.parse_errors],
        "counts": {
            "fresh": len(result.fresh),
            "baselined": len(result.baselined),
            "stale_baseline": len(result.stale_baseline),
            "parse_errors": len(result.parse_errors),
        },
        "failed": result.failed,
    }
    return json.dumps(payload, indent=2, sort_keys=True)
