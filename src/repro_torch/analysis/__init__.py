"""The port's static analysis — the counterpart of ``repro.analysis``.

An AST pass with the reference's engine, directive grammar, baseline
ratchet, reporters and CLI, whose rules machine-check the concurrency,
hot-path and kernel invariants of the port's own idiom. Each rule names
the reference rule it stands for:

  guarded-by            lock discipline on annotated shared fields
                        (= repro's guarded-by, unchanged)
  no-sync-in-hot-path   hidden device syncs in latency-critical paths:
                        .item/.tolist/.cpu/.numpy/.to("cpu"), synchronize,
                        data-dependent-size ops (repro's no-sync-in-hot-path)
  capture-purity        no host side effects in code captured into a CUDA
                        graph or compiled (repro's jit-purity)
  no-inplace-in-plane   publish() aliasing forbids in-place writes to plane
                        buffers (repro's no-donate-in-plane)
  kernel-contract       every launching CUDA wrapper branches to its plain
                        version on CPU tensors and never falls back
                        (repro's kernel-contract)

Run as ``python -m repro_torch.analysis [paths...]`` (default: this
package's tree). Findings are suppressed inline with
``# reprolint: disable=<rule>`` or grandfathered (with a justification)
in ``analysis/baseline.json``; the same annotations serve both linters.
"""
from .engine import (  # noqa: F401
    AnalysisResult,
    Baseline,
    FileContext,
    Finding,
    all_rules,
    collect_files,
    load_baseline,
    render_json,
    render_text,
    run_analysis,
)

__all__ = [
    "AnalysisResult",
    "Baseline",
    "FileContext",
    "Finding",
    "all_rules",
    "collect_files",
    "load_baseline",
    "render_json",
    "render_text",
    "run_analysis",
]
