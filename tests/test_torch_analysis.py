"""repro_torch.analysis, the port's static analysis, held to the reference
linter (repro.analysis) on the CPU, AST only.

Four parts:

  * one test for each of tests/test_analysis.py's cases, with torch
    corpora for the rules that changed (no-sync-in-hot-path's torch syncs,
    capture-purity for jit-purity, no-inplace-in-plane for
    no-donate-in-plane, kernel-contract's wrapper checks), plus good and
    bad snippets for each new check as cases of one parametrised test;
  * parity with the reference: both engines and both guarded-by rules on
    the same files (the reference's guarded-by snippets and copies of the
    port's dist_ingest.py and serve_db/service.py) give identical finding
    keys, directive maps and baseline ratchet outcomes — exact sets, no
    tolerance;
  * the tree gate: src/repro_torch lints clean against the port's
    baseline, through the library and through the CLI;
  * mutation tests on scratch copies of the port's real files: each rule
    fires on one injected fault and stays quiet on the original.
"""
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import repro.analysis.engine as ref_engine
from repro.analysis.rules.guarded_by import GuardedByRule as RefGuardedByRule
from repro_torch.analysis import (
    load_baseline,
    render_json,
    render_text,
    run_analysis,
)
from repro_torch.analysis import engine
from repro_torch.analysis.engine import Baseline, BaselineEntry, default_baseline_path
from repro_torch.analysis.rules import REGISTRY
from repro_torch.analysis.rules.capture_purity import CapturePurityRule
from repro_torch.analysis.rules.guarded_by import GuardedByRule
from repro_torch.analysis.rules.hot_path import HotPathSyncRule
from repro_torch.analysis.rules.kernel_contract import KernelContractRule
from repro_torch.analysis.rules.no_inplace import NoInplaceInPlaneRule

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
PLANE = "src/repro_torch/core/dist_ingest.py"


def lint(tmp_path, source, name="mod.py", rules=None):
    """Write one snippet and run the given rules over it (no baseline)."""
    p = tmp_path / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(source))
    return run_analysis([str(p)], rules=rules)


# ----------------------------------------------------------------- guarded-by
GUARDED_SRC = """
    import threading

    class Plane:
        def __init__(self):
            self._lock = threading.Lock()
            self._fill = 0  # guarded-by: _lock

        def bad(self):
            return self._fill + 1

        def good_with(self):
            with self._lock:
                return self._fill

        def good_hold(self):
            with self._lock.hold("x"):
                self._fill += 1

        def good_holds(self):  # holds: _lock
            return self._fill

        def good_suppressed(self):
            return self._fill  # reprolint: disable=guarded-by
"""

GUARDED_DOTTED_SRC = """
    import threading

    def deco(f):
        return f

    class P:
        def __init__(self, sched):
            self.sched = sched
            self._q = []  # guarded-by: sched._cv

        # holds: sched._cv
        @deco
        def annotated_above(self):
            return len(self._q)

        def locked(self):
            with self.sched._cv:
                return list(self._q)

        def bad(self):
            return self._q
"""


def test_guarded_by_flags_only_unlocked_access(tmp_path):
    res = lint(tmp_path, GUARDED_SRC, rules=[GuardedByRule()])
    assert [f.rule for f in res.fresh] == ["guarded-by"]
    assert "self._fill + 1" in res.fresh[0].snippet
    assert "_lock" in res.fresh[0].message


def test_guarded_by_decorator_annotation_and_dotted_lock(tmp_path):
    res = lint(tmp_path, GUARDED_DOTTED_SRC, rules=[GuardedByRule()])
    assert [f.snippet for f in res.fresh] == ["return self._q"]


# ------------------------------------------------------- no-sync-in-hot-path
HOT_SRC = """
    import numpy as np
    import torch

    # reprolint: hot-path
    def hot(step, sp, x, stream):
        a = x.item()
        torch.cuda.synchronize()
        b = np.asarray(x)
        c = float(step(x))
        g = x.cpu().numpy()
        h = x.tolist()
        i = torch.nonzero(x)
        stream.synchronize()
        d = np.asarray(sp.fence(x))
        e = int(sp.fence(step(x)))
        f = int(a)
        k = sp.fence(x).cpu().numpy()
        m = int(sp.fence(x).sum())
        n = x.to(x.device)
        return a, b, c, d, e, f, g, h, i, k, m, n

    def cold(step, x):
        torch.cuda.synchronize()
        return float(step(x.cpu().item()))
"""


def test_hot_path_sync_corpus(tmp_path):
    res = lint(tmp_path, HOT_SRC, rules=[HotPathSyncRule()])
    assert all(f.rule == "no-sync-in-hot-path" for f in res.fresh)
    snippets = [f.snippet for f in res.fresh]
    # Exactly the eight syncs in hot(), one per unfenced chain; the fenced
    # forms, the Name coercion, a device-to-device .to() and everything
    # in the untagged cold() stay clean.
    assert snippets == [
        "a = x.item()",
        "torch.cuda.synchronize()",
        "b = np.asarray(x)",
        "c = float(step(x))",
        "g = x.cpu().numpy()",
        "h = x.tolist()",
        "i = torch.nonzero(x)",
        "stream.synchronize()",
    ]


def test_hot_path_nested_def_inherits_tag(tmp_path):
    src = """
        # reprolint: hot-path
        def outer(x):
            def inner():
                return x.cpu()
            return inner()
    """
    res = lint(tmp_path, src, rules=[HotPathSyncRule()])
    assert len(res.fresh) == 1 and ".cpu()" in res.fresh[0].message


HOT_CASES = [
    # (statement inside a hot function, findings it must raise)
    ("y = x.cpu()", 1),
    ("y = x.tolist()", 1),
    ("y = x.numpy()", 1),
    ('y = x.to("cpu")', 1),
    ('y = x.to(device="cpu")', 1),
    ('y = x.to(torch.device("cpu"))', 1),
    ("y = x.cpu().numpy()", 1),
    ("torch.cuda.synchronize()", 1),
    ("torch.cuda.current_stream().synchronize()", 1),
    ("y = torch.nonzero(x)", 1),
    ("y = x.nonzero()", 1),
    ("y = torch.unique(x)", 1),
    ("y = torch.masked_select(x, m)", 1),
    ("y = torch.repeat_interleave(x, r)", 1),
    ("y = torch.where(m)", 1),
    ("y = np.array(x)", 1),
    ("y = bool(step(x))", 1),
    ("y = sp.fence(x).cpu()", 0),
    ("y = sp.fence(x).cpu().numpy()", 0),
    ("y = sp.fence(x).tolist()", 0),
    ("y = sp.fence(x)[0].item()", 0),
    ("y = np.asarray(sp.fence(x))", 0),
    ("y = int(sp.fence(x).sum())", 0),
    ("y = [int(v) for v in sp.fence(torch.stack([x, m])).cpu()]", 0),
    ("y = torch.repeat_interleave(x, r, output_size=n)", 0),
    ("y = torch.where(m, x, 0)", 0),
    ("y = np.unique(x)", 0),
    ("y = np.asarray([1, 2], np.int64)", 0),
    ("y = x.to(dev)", 0),
    ("y = int(n)", 0),
]


@pytest.mark.parametrize("stmt,n", HOT_CASES, ids=[c[0] for c in HOT_CASES])
def test_hot_path_torch_sync_cases(tmp_path, stmt, n):
    src = f"""
import numpy as np
import torch

# reprolint: hot-path
def hot(sp, step, x, m, r, n, dev):
    {stmt}
    return None

def cold(x):
    {stmt}
"""
    res = run_analysis([str(_write(tmp_path, "mod.py", src))], rules=[HotPathSyncRule()])
    assert len(res.fresh) == n, render_text(res)
    assert all(f.line == 7 for f in res.fresh)


# ------------------------------------------------------------- capture-purity
CAPTURE_BAD_SRC = """
    import time
    import torch

    events = []
    cache = {}

    class Thing:
        def build(self):
            def step(x):
                self.seen = x          # self-mutation at capture time
                events.append(1)       # closed-over container
                cache["k"] = x         # closed-over subscript store
                t = time.time()        # host nondeterminism
                y = torch.sum(x)       # fine: imported module
                zs = []
                zs.append(y)           # fine: local
                return y + t
            return torch.cuda.make_graphed_callables(step, (torch.zeros(4),))
"""


def test_capture_purity_flags_impure_captured_fn(tmp_path):
    res = lint(tmp_path, CAPTURE_BAD_SRC, rules=[CapturePurityRule()])
    msgs = " | ".join(f.message for f in res.fresh)
    assert len(res.fresh) == 4
    assert "self.seen" in msgs
    assert "'events." in msgs
    assert "'cache'" in msgs
    assert "time.time" in msgs


def test_capture_purity_decorator_and_clean_fn(tmp_path):
    src = """
        import torch
        from functools import partial

        @torch.compile
        def pure(x):
            acc = {}
            acc["k"] = torch.sum(x)
            return acc["k"]

        def helper(x):
            out = []
            out.append(x)
            return out[0]

        stepped = torch.compile(partial(helper))
        graphed = torch.cuda.make_graphed_callables((helper,), ((torch.zeros(2),),))
    """
    res = lint(tmp_path, src, rules=[CapturePurityRule()])
    assert res.fresh == []


def test_capture_purity_only_checks_captured_functions(tmp_path):
    src = """
        import time

        def uncaptured():
            return time.time()  # ordinary host code: not the rule's business
    """
    res = lint(tmp_path, src, rules=[CapturePurityRule()])
    assert res.fresh == []


CAPTURE_CASES = [
    ("decorator", """
        import random
        import torch

        seen = []

        @torch.jit.script
        def f(x):
            seen.append(x)
            return x * random.random()
     """, 2),
    ("decorator_with_args", """
        import torch

        @torch.compile(mode="reduce-overhead")
        def f(x):
            out = {}
            out["y"] = x
            return out["y"]
     """, 0),
    ("make_graphed_callables_tuple", """
        import time
        import torch

        def a(x):
            return x + 1

        def b(x):
            return x * time.perf_counter()

        fa, fb = torch.cuda.make_graphed_callables((a, b), ((torch.zeros(1),), (torch.zeros(1),)))
     """, 1),
    ("jit_trace_partial", """
        import functools
        import torch
        import numpy as np

        def f(x, k):
            return x + np.random.rand()

        g = torch.jit.trace(functools.partial(f, k=2), (torch.zeros(2),))
     """, 1),
    ("graph_body_bad", """
        import torch

        log = []

        class Engine:
            def capture(self, x):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    y = x * 2
                    self.static_out = y
                    log.append(y)
                return g
     """, 2),
    ("graph_body_clean", """
        import torch

        class Engine:
            def capture(self, x, static_out):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    y = x * 2
                    parts = {}
                    parts["y"] = y
                    static_out.copy_(y)
                self.graph = g
                return g
     """, 0),
]


@pytest.mark.parametrize("src,n", [c[1:] for c in CAPTURE_CASES],
                         ids=[c[0] for c in CAPTURE_CASES])
def test_capture_purity_torch_cases(tmp_path, src, n):
    res = lint(tmp_path, src, rules=[CapturePurityRule()])
    assert len(res.fresh) == n, render_text(res)
    assert all(f.rule == "capture-purity" for f in res.fresh)


# ------------------------------------------------------- no-inplace-in-plane
INPLACE_SRC = """
    import torch

    def build(st, tab, ones):
        st["ev_mem_n"].index_add_(0, tab, ones)
"""


def test_no_inplace_fires_only_in_plane_files(tmp_path):
    bad = lint(tmp_path, INPLACE_SRC, name=PLANE, rules=[NoInplaceInPlaneRule()])
    assert [f.rule for f in bad.fresh] == ["no-inplace-in-plane"]
    also = lint(tmp_path, INPLACE_SRC, name="src/repro_torch/core/dist_query.py",
                rules=[NoInplaceInPlaneRule()])
    assert len(also.fresh) == 1
    ok = lint(tmp_path, INPLACE_SRC, name="src/repro_torch/core/elsewhere.py",
              rules=[NoInplaceInPlaneRule()])
    assert ok.fresh == []


def test_no_inplace_inline_suppression(tmp_path):
    src = INPLACE_SRC.replace(
        "index_add_(0, tab, ones)",
        "index_add_(0, tab, ones)  # reprolint: disable=no-inplace-in-plane",
    )
    res = lint(tmp_path, src, name=PLANE, rules=[NoInplaceInPlaneRule()])
    assert res.fresh == []


INPLACE_CASES = [
    # (id, body of a method ``f(self, st, x, idx, v, p)``, findings)
    ("param_subscript", "st['ev_base_k'][idx] = 0", 1),
    ("param_view_subscript", "st['ev_mem_k'].view(-1)[idx] = v", 1),
    ("param_augmented", "x[idx] += v", 1),
    ("param_method", "x.index_add_(0, idx, v)", 1),
    ("param_scatter_reduce", "x.scatter_reduce_(0, idx, v, 'amax')", 1),
    ("param_zero", "st['ev_base_n'].zero_()", 1),
    ("param_out", "torch.add(x, v, out=st['ev_base_k'])", 1),
    ("self_method", "self.buf.copy_(v)", 1),
    ("self_subscript", "self.buf[:] = 0", 1),
    ("alias_of_param", "slab = st['ev_base_k'].reshape(-1)\n        slab[idx] = 0", 1),
    ("alias_unbind", "a, b = x.unbind(0)\n        a.fill_(0)", 1),
    ("entry_of_container", "self.state['k'][idx] = 0", 1),
    ("fresh_zeros", "y = torch.zeros(4)\n        y[idx] = v\n        y.add_(1)", 0),
    ("fresh_like", "y = torch.full_like(x, 3)\n        y.index_add_(0, idx, v)", 0),
    ("fresh_clone", "y = x.clone()\n        y[idx] = v", 0),
    ("fresh_where", "y = torch.where(x > 0, x, 0)\n        y[idx] = v", 0),
    ("fresh_numpy", "y = np.empty(4, np.int64)\n        y[idx] = 1", 0),
    ("fresh_dict", "out = {}\n        out[idx] = v", 0),
    ("fresh_out", "y = torch.empty(4)\n        torch.add(x, v, out=y)", 0),
    ("rebound_param", "x = x.clone()\n        x[idx] = v", 0),
    ("str_key", "st['ev_base_k'] = v", 0),
    ("fstring_key", "st[f'{p}_base_k'] = torch.where(x > 0, v, 0)", 0),
    ("container_attr", "self.cache[idx] = v", 0),
    ("container_field", "self.gens[idx] = v", 0),
    ("container_entry", "self.state['k'] = v", 0),
    ("bare_augmented", "x += v", 0),
    ("unknown_origin", "y = make(x)\n        y[idx] = v", 0),
    ("module_level", "pass", 0),
    ("suppressed", "x[idx] = v  # reprolint: disable=no-inplace-in-plane", 0),
]


@pytest.mark.parametrize("body,n", [c[1:] for c in INPLACE_CASES],
                         ids=[c[0] for c in INPLACE_CASES])
def test_no_inplace_torch_cases(tmp_path, body, n):
    src = f"""
import numpy as np
import torch
from typing import Dict, List

GLOBAL = torch.zeros(4)
GLOBAL[0] = 1


class Plane:
    def __init__(self):
        self.cache = {{}}
        self.gens: List[int] = [0] * 4
        self.state: Dict[str, torch.Tensor] = {{}}
        self.buf = torch.zeros(4)

    def f(self, st, x, idx, v, p):
        {body}
"""
    res = run_analysis([str(_write(tmp_path, PLANE, src))], rules=[NoInplaceInPlaneRule()])
    assert len(res.fresh) == n, render_text(res)
    assert all(f.rule == "no-inplace-in-plane" for f in res.fresh)


# ------------------------------------------------------------- kernel-contract
def _write(root: Path, rel: str, body: str) -> Path:
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(body))
    return p


COMMON = """
def pow2(n):
    return 1 << (n - 1).bit_length()

def count_launch(namespace):
    namespace["launches"] += 1
"""

GOOD_OPS = """
from ..common import count_launch
from .ref import scan_ref

launches = 0

def scan(x, n):
    if x.device.type == "cpu":
        return scan_ref(x, n)
    if x.device.type != "cuda":
        raise ValueError(x.device)
    out = x.new_empty(n)
    count_launch(globals())
    return out

def host_scan(x):
    return scan(x, 4).cpu().numpy()
"""


def test_kernel_contract_good_package(tmp_path):
    _write(tmp_path, "kernels/common.py", COMMON)
    _write(tmp_path, "kernels/goodpkg/__init__.py",
           "from .ops import scan, host_scan\nfrom .ref import scan_ref\n")
    _write(tmp_path, "kernels/goodpkg/ops.py", GOOD_OPS)
    _write(tmp_path, "kernels/goodpkg/ref.py", "def scan_ref(x, n):\n    return x\n")
    res = run_analysis([str(tmp_path / "kernels")], rules=[KernelContractRule()])
    assert res.fresh == []


def test_kernel_contract_bad_package(tmp_path):
    _write(tmp_path, "kernels/common.py", COMMON)
    _write(tmp_path, "kernels/badpkg/__init__.py", "from .ops import scan, fallback\n")
    _write(tmp_path, "kernels/badpkg/ops.py", """
        from ..common import count_launch
        from .ref import scan_ref

        launches = 0

        def scan(x, n):
            out = x.new_empty(n)
            count_launch(globals())
            return out

        def fallback(x, n):
            if x.device.type == "cpu":
                return scan_ref(x, n)
            try:
                count_launch(globals())
            except RuntimeError:
                return scan_ref(x, n)
            return x

        def _pow2(n):
            return 1
    """)
    _write(tmp_path, "kernels/badpkg/ref.py", "def scan_ref(x, n):\n    return x\n")
    res = run_analysis([str(tmp_path / "kernels")], rules=[KernelContractRule()])
    msgs = [f.message for f in res.fresh]
    assert len(msgs) == 4, msgs
    assert any("does not re-export from .ref" in m for m in msgs)
    assert any("'scan' has no CPU branch into .ref" in m for m in msgs)
    assert any("'fallback' holds a try" in m for m in msgs)
    assert any("re-implements shared kernel helper 'pow2'" in m for m in msgs)


def test_kernel_contract_missing_ref_file(tmp_path):
    _write(tmp_path, "kernels/noref/__init__.py", "")
    _write(tmp_path, "kernels/noref/ops.py", "def f(x):\n    return x\n")
    res = run_analysis([str(tmp_path / "kernels")], rules=[KernelContractRule()])
    assert len(res.fresh) == 1 and "missing ref.py" in res.fresh[0].message


KERNEL_CASES = [
    # (id, ops.py source, findings)
    ("cpu_branch_via_module", """
        from ..common import count_launch
        from . import ref

        def scan(x):
            if x.device.type == "cpu":
                return [ref.scan_ref(r) for r in x]
            count_launch(globals())
            return x
     """, 0),
    ("cpu_branch_on_device_name", """
        from ..common import count_launch
        from .ref import scan_ref

        def scan(x):
            dev = x.device
            if dev.type == "cpu":
                return scan_ref(x)
            count_launch(globals())
            return x
     """, 0),
    ("cpu_branch_not_into_ref", """
        from ..common import count_launch
        from .ref import scan_ref

        def scan(x):
            if x.device.type == "cpu":
                return x.sort().values
            count_launch(globals())
            return x
     """, 1),
    ("try_finally", """
        from ..common import count_launch
        from .ref import scan_ref

        def scan(x):
            if x.device.type == "cpu":
                return scan_ref(x)
            try:
                count_launch(globals())
            finally:
                pass
            return x
     """, 1),
    ("no_launch_no_contract", """
        from .ref import scan_ref

        def host(x):
            try:
                return scan_ref(x)
            except ValueError:
                return x
     """, 0),
]


@pytest.mark.parametrize("ops,n", [c[1:] for c in KERNEL_CASES],
                         ids=[c[0] for c in KERNEL_CASES])
def test_kernel_contract_wrapper_cases(tmp_path, ops, n):
    _write(tmp_path, "kernels/common.py", COMMON)
    _write(tmp_path, "kernels/pkg/__init__.py",
           "from .ops import *  # noqa: F401\nfrom .ref import scan_ref  # noqa: F401\n")
    _write(tmp_path, "kernels/pkg/ops.py", ops)
    _write(tmp_path, "kernels/pkg/ref.py", "def scan_ref(x):\n    return x\n")
    res = run_analysis([str(tmp_path / "kernels")], rules=[KernelContractRule()])
    assert len(res.fresh) == n, render_text(res)


def test_kernel_contract_quiet_on_the_reference_kernels():
    """The reference's Pallas packages call no count_launch: the port's rule
    holds them to the shape checks alone, which they meet."""
    res = run_analysis([str(REPO / "src" / "repro" / "kernels")], rules=[KernelContractRule()])
    assert res.fresh == [] and res.parse_errors == []


# ------------------------------------------------- suppression + baseline
def test_disable_all_suppresses_every_rule(tmp_path):
    src = GUARDED_SRC.replace(
        "return self._fill + 1",
        "return self._fill + 1  # reprolint: disable=all",
    )
    res = lint(tmp_path, src, rules=[GuardedByRule()])
    assert res.fresh == []


def test_baseline_match_and_ratchet(tmp_path):
    res = lint(tmp_path, GUARDED_SRC, rules=[GuardedByRule()])
    (f,) = res.fresh
    entry = BaselineEntry(
        rule=f.rule, file=f.path, snippet=f.snippet, justification="known"
    )
    stale_entry = BaselineEntry(
        rule=f.rule, file=f.path, snippet="gone_line()", justification="old"
    )
    # Matching entry: finding moves to `baselined`, run passes.
    ok = run_analysis(
        [str(tmp_path / "mod.py")], rules=[GuardedByRule()],
        baseline=Baseline(None, [entry]),
    )
    assert ok.fresh == [] and len(ok.baselined) == 1 and not ok.failed
    # A stale entry is itself a failure: the baseline only shrinks.
    stale = run_analysis(
        [str(tmp_path / "mod.py")], rules=[GuardedByRule()],
        baseline=Baseline(None, [entry, stale_entry]),
    )
    assert stale.stale_baseline == [stale_entry] and stale.failed


def test_baseline_requires_justification(tmp_path):
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps({
        "version": 1,
        "entries": [{"rule": "r", "file": "f.py", "snippet": "x", "justification": "  "}],
    }))
    with pytest.raises(ValueError, match="justification"):
        load_baseline(str(p))


def test_reporters_render(tmp_path):
    res = lint(tmp_path, GUARDED_SRC, rules=[GuardedByRule()])
    text = render_text(res)
    assert "[guarded-by]" in text and "1 finding(s)" in text
    doc = json.loads(render_json(res))
    assert doc["failed"] and doc["counts"]["fresh"] == 1
    assert doc["findings"][0]["rule"] == "guarded-by"


def test_parse_error_fails_run(tmp_path):
    (tmp_path / "broken.py").write_text("def f(:\n")
    res = run_analysis([str(tmp_path / "broken.py")], rules=[GuardedByRule()])
    assert res.parse_errors and res.failed


# --------------------------------------------------------------- CLI contract
def _run_cli(*argv, cwd=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *argv],
        capture_output=True, text=True, env=env, cwd=cwd or str(REPO),
    )


def test_cli_exit_codes_and_json(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(GUARDED_SRC))
    proc = _run_cli(str(bad), "--no-baseline", "--format=json")
    assert proc.returncode == 1
    doc = json.loads(proc.stdout)
    assert doc["failed"] and doc["counts"]["fresh"] == 1
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    proc = _run_cli(str(good), "--no-baseline")
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_list_rules_in_report_order():
    proc = _run_cli("--list-rules")
    assert proc.returncode == 0, proc.stderr
    names = [line.split(":")[0] for line in proc.stdout.splitlines()]
    assert names == ["guarded-by", "no-sync-in-hot-path", "capture-purity",
                     "no-inplace-in-plane", "kernel-contract"]


# ----------------------------------------------------------- self-clean gates
def test_repo_tree_is_reprolint_clean():
    """The port's gate in library form: src/repro_torch has zero fresh
    findings against the port's baseline, no stale entry, no parse error."""
    baseline = load_baseline(default_baseline_path())
    assert baseline.path == str(PORT / "analysis" / "baseline.json")
    assert all(e.justification.strip() for e in baseline.entries)
    res = run_analysis([str(PORT)], baseline=baseline)
    assert res.parse_errors == []
    assert res.fresh == [], render_text(res)
    assert res.stale_baseline == []


def test_cli_gates_the_port_tree(tmp_path):
    """With no path the CLI lints the port's own package and exits 0; with
    --no-baseline it fails exactly when the baseline grandfathers
    something. It runs from any directory."""
    proc = _run_cli(cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout and "0 stale" in proc.stdout
    n = len(load_baseline(default_baseline_path()).entries)
    proc = _run_cli("--no-baseline", "--format=json")
    doc = json.loads(proc.stdout)
    assert doc["counts"]["fresh"] == n
    assert proc.returncode == (1 if n else 0)


def test_guarded_by_catches_removed_lock_in_dist_ingest_copy(tmp_path):
    """Mutation test on the real plane: strip ONE lock wrapper from a
    scratch copy of the port's core/dist_ingest.py and guarded-by must
    fire on the now-unprotected shared state; the unmodified copy stays
    clean."""
    src = (PORT / "core" / "dist_ingest.py").read_text()
    clean = lint(tmp_path, src, name="clean/dist_ingest.py", rules=[GuardedByRule()])
    assert clean.fresh == []

    mutated = _mutate_telemetry_lock(src)
    res = lint(tmp_path, mutated, name="mut/dist_ingest.py", rules=[GuardedByRule()])
    assert res.fresh, "removing the telemetry lock hold must trip guarded-by"
    attrs = " ".join(f.message for f in res.fresh)
    assert "session_stats" in attrs


def _mutate_telemetry_lock(src):
    marker = 'with self._meta_lock.hold("bookkeeping"):'
    i = src.index("def telemetry(")
    j = src.index(marker, i)
    return src[:j] + "if True:" + src[j + len(marker):]


def test_registry_covers_all_five_rules():
    names = [cls.name for cls in REGISTRY]
    assert names == [
        "guarded-by",
        "no-sync-in-hot-path",
        "capture-purity",
        "no-inplace-in-plane",
        "kernel-contract",
    ]


# -------------------------------------------------------- mutation tests
def _inject(src, anchor, line, after=True):
    """Insert ``line`` (indented like ``anchor``'s line) after or before the
    first line holding ``anchor``."""
    lines = src.splitlines(keepends=True)
    i = next(k for k, text in enumerate(lines) if anchor in text)
    indent = lines[i][: len(lines[i]) - len(lines[i].lstrip())]
    lines.insert(i + 1 if after else i, indent + line + "\n")
    return "".join(lines)


def _mutate_fold(src):
    i = src.index("def _fold_into_base(")
    head, tail = src[:i], src[i:]
    return head + _inject(tail, "kept = total.clamp(max=c)",
                          'st[f"{p}_base_n"].index_add_(0, kept.long(), total)')


def _mutate_scan_fence(src):
    i = src.index("def scan_range(")
    head, tail = src[:i], src[i:]
    old = "ts = sp.fence(top_ts).cpu().numpy()"
    assert old in tail
    return head + tail.replace(old, "ts = top_ts.cpu().numpy()", 1)


def _mutate_member_mask(src):
    old = """    check(
        getattr(lib, _ENTRY[a.dtype])(
            a_c.data_ptr(), b_c.data_ptr(), rows, n, m, out.data_ptr(), stream,
        ),
        "merge_intersect",
    )
"""
    assert old in src
    wrapped = "    try:\n" + textwrap.indent(old, "    ") + (
        "    except RuntimeError:\n        return member_mask_keys(a, b)\n")
    return src.replace(old, wrapped, 1)


MUTATIONS = [
    # (id, port file, scratch name, mutation, rule, what the finding names)
    ("inplace_fold", "core/dist_ingest.py", PLANE, _mutate_fold,
     NoInplaceInPlaneRule, "index_add_"),
    ("unfenced_scan_copy", "core/dist_query.py", "src/repro_torch/core/dist_query.py",
     _mutate_scan_fence, HotPathSyncRule, ".cpu()"),
]


@pytest.mark.parametrize("rel,name,mutate,rule,word", [m[1:] for m in MUTATIONS],
                         ids=[m[0] for m in MUTATIONS])
def test_mutation_of_port_file_trips_rule(tmp_path, rel, name, mutate, rule, word):
    src = (PORT / rel).read_text()
    clean = lint(tmp_path / "clean", src, name=name, rules=[rule()])
    assert clean.fresh == [], render_text(clean)
    res = lint(tmp_path / "mut", mutate(src), name=name, rules=[rule()])
    assert len(res.fresh) == 1, render_text(res)
    assert word in res.fresh[0].message or word in res.fresh[0].snippet


def test_kernel_contract_catches_try_in_member_mask_copy(tmp_path):
    """Mutation test on the real kernels: wrap member_mask's launch in a
    try that falls back to member_mask_keys in a scratch copy of the
    port's kernels/; kernel-contract fires there and is quiet on the
    unmodified copy."""
    for tag, mutate in (("clean", None), ("mut", _mutate_member_mask)):
        dst = tmp_path / tag / "kernels"
        shutil.copytree(PORT / "kernels", dst, ignore=shutil.ignore_patterns(
            "__pycache__", "csrc"))
        if mutate is not None:
            ops = dst / "merge_intersect" / "ops.py"
            ops.write_text(mutate(ops.read_text()))
        res = run_analysis([str(dst)], rules=[KernelContractRule()])
        if mutate is None:
            assert res.fresh == [], render_text(res)
        else:
            assert [f.message.split(" — ")[0] for f in res.fresh] == [
                "launching wrapper 'member_mask' holds a try"]


# ---------------------------------------------------- parity with the reference
def _parity_corpus(tmp_path):
    """(id, path) of the files both engines read: the reference test's
    guarded-by snippets, copies of the port's dist_ingest.py (clean and
    with the telemetry lock removed) and serve_db/service.py."""
    ingest = (PORT / "core" / "dist_ingest.py").read_text()
    files = {
        "guarded_src": textwrap.dedent(GUARDED_SRC),
        "guarded_dotted": textwrap.dedent(GUARDED_DOTTED_SRC),
        "dist_ingest": ingest,
        "dist_ingest_mutated": _mutate_telemetry_lock(ingest),
        "service": (PORT / "serve_db" / "service.py").read_text(),
    }
    out = {}
    for key, text in files.items():
        p = tmp_path / "src" / "repro_torch" / f"{key}.py"
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
        out[key] = str(p)
    return out


PARITY_IDS = ["guarded_src", "guarded_dotted", "dist_ingest", "dist_ingest_mutated", "service"]


def _keys(findings):
    return [(f.key(), f.line, f.message) for f in findings]


@pytest.mark.parametrize("which", PARITY_IDS)
def test_parity_guarded_by_findings(tmp_path, which):
    path = _parity_corpus(tmp_path)[which]
    ours = engine.run_analysis([path], rules=[GuardedByRule()])
    theirs = ref_engine.run_analysis([path], rules=[RefGuardedByRule()])
    assert _keys(ours.findings) == _keys(theirs.findings)
    assert _keys(ours.fresh) == _keys(theirs.fresh)
    assert ours.parse_errors == theirs.parse_errors == []
    if which in ("guarded_src", "guarded_dotted", "dist_ingest_mutated"):
        assert ours.fresh  # the comparison covers real findings
    else:
        assert ours.fresh == []


@pytest.mark.parametrize("which", PARITY_IDS)
def test_parity_directive_maps(tmp_path, which):
    import ast

    path = _parity_corpus(tmp_path)[which]
    source = Path(path).read_text()
    tree = ast.parse(source)
    ours = engine.FileContext(path, source, tree)
    theirs = ref_engine.FileContext(path, source, tree)
    assert ours.hot_lines == theirs.hot_lines
    assert ours.guarded == theirs.guarded
    assert ours.holds == theirs.holds
    assert ours.disable == theirs.disable
    defs = [n for n in ast.walk(tree) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    assert [ours.is_hot_def(d) for d in defs] == [theirs.is_hot_def(d) for d in defs]
    assert [ours.holds_for_def(d) for d in defs] == [theirs.holds_for_def(d) for d in defs]
    if which == "service":
        assert ours.hot_lines and ours.guarded and ours.disable


@pytest.mark.parametrize("which", PARITY_IDS)
def test_parity_baseline_ratchet(tmp_path, which):
    """The same baseline file — an entry for the first finding of the
    mutated plane and of this file, and a stale entry —
    loads and splits identically in both packages; a blank justification
    is refused by both."""
    corpus = _parity_corpus(tmp_path)
    path = corpus[which]
    first = {}
    for f in ref_engine.run_analysis([corpus["dist_ingest_mutated"], path],
                                     rules=[RefGuardedByRule()]).findings:
        first.setdefault(f.path, f)
    entries = [{"rule": f.rule, "file": f.path, "snippet": f.snippet,
                "justification": "known"} for f in first.values()]
    entries.append({"rule": "guarded-by", "file": path, "snippet": "gone_line()",
                    "justification": "old"})
    bfile = tmp_path / "baseline.json"
    bfile.write_text(json.dumps({"version": 1, "entries": entries}))
    ours = engine.run_analysis([path], rules=[GuardedByRule()],
                               baseline=engine.load_baseline(str(bfile)))
    theirs = ref_engine.run_analysis([path], rules=[RefGuardedByRule()],
                                     baseline=ref_engine.load_baseline(str(bfile)))
    assert _keys(ours.fresh) == _keys(theirs.fresh)
    assert _keys(ours.baselined) == _keys(theirs.baselined)
    assert ([vars(e) for e in ours.stale_baseline]
            == [vars(e) for e in theirs.stale_baseline])
    assert ours.failed == theirs.failed and ours.stale_baseline
    entries[0]["justification"] = " "
    bfile.write_text(json.dumps({"version": 1, "entries": entries}))
    for eng in (engine, ref_engine):
        with pytest.raises(ValueError, match="justification"):
            eng.load_baseline(str(bfile))
