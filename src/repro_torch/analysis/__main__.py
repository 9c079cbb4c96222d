"""CLI: ``python -m repro_torch.analysis [paths...] [options]``.

Exit status 0 iff there are no fresh (non-baselined) findings, no stale
baseline entries, and no parse errors — the CI contract.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from .engine import (
    all_rules,
    default_baseline_path,
    load_baseline,
    render_json,
    render_text,
    run_analysis,
)

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static analysis of the PyTorch/CUDA port (rule catalog: "
        "repro_torch/analysis/__init__.py)",
    )
    parser.add_argument(
        "paths",
        nargs="*",
        default=[PACKAGE_DIR],
        help="files or directories to analyze (default: the repro_torch package)",
    )
    parser.add_argument(
        "--format", choices=("text", "json"), default="text", dest="fmt"
    )
    parser.add_argument(
        "--baseline",
        default=default_baseline_path(),
        help="baseline.json path (default: the checked-in analysis/baseline.json)",
    )
    parser.add_argument(
        "--no-baseline",
        action="store_true",
        help="ignore the baseline: report every finding as fresh",
    )
    parser.add_argument(
        "--allow-stale-baseline",
        action="store_true",
        help="do not fail on baseline entries that match no finding",
    )
    parser.add_argument(
        "--verbose",
        action="store_true",
        help="text format: also print baselined findings",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog and exit"
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.name}: {rule.description}")
        return 0

    baseline = None if args.no_baseline else load_baseline(args.baseline)
    result = run_analysis(args.paths, baseline=baseline)
    if args.allow_stale_baseline:
        result.stale_baseline = []
    print(render_json(result) if args.fmt == "json" else render_text(result, args.verbose))
    return 1 if result.failed else 0


if __name__ == "__main__":
    sys.exit(main())
