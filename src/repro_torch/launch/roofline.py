"""Assemble the dry-run's roofline tables from experiments/dryrun_torch
JSONs; the PyTorch port of the reference's launch/roofline.py.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--dir experiments/dryrun_torch]
                                                         [--baseline DIR] [--mesh single_pod]

Prints markdown tables: per (arch x shape) the three roofline terms on
the H100 rates of launch/cost_analysis.py, the bottleneck, the peak
memory, the traced FLOPs per device, the useful-FLOP ratio and the
roofline fraction, and (with --baseline) the deltas against another
sweep.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional

from .cost_analysis import PEAK_FLOPS

ARCH_ORDER = [
    "gemma2-9b", "internlm2-20b", "qwen1.5-4b", "gemma3-12b", "musicgen-medium",
    "moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b", "zamba2-2.7b",
    "llama-3.2-vision-11b", "mamba2-780m",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(directory: str) -> Dict:
    out = {}
    for p in sorted(Path(directory).glob("*.json")):
        if p.name.startswith("FAIL"):
            continue
        r = json.loads(p.read_text())
        out[(r["arch"], r["shape"], r["mesh"])] = r
    return out


def fmt_s(x: float) -> str:
    return f"{x:.2e}"


def roofline_fraction(r: Dict) -> Optional[float]:
    """Useful-compute fraction of the step's roofline-limited time:
    model-FLOPs time / max(three terms). 1.0 = at the hardware limit."""
    t = r["roofline"]
    dom = max(t["compute_s"], t["memory_s"], t["collective_s"])
    if dom <= 0:
        return None
    return (r["model_flops_per_device"] / PEAK_FLOPS) / dom


def table(results: Dict, mesh: str = "single_pod") -> List[str]:
    lines = [
        "| arch | shape | compute s | memory s | collective s | bound | peak GiB "
        "| GFLOP/dev | useful/traced | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = results.get((arch, shape, mesh))
            if r is None:
                if shape == "long_500k":
                    lines.append(f"| {arch} | {shape} | — | — | — | skipped(full-attention) "
                                 "| — | — | — | — |")
                continue
            t = r["roofline"]
            frac = roofline_fraction(r)
            ratio = r.get("useful_flop_ratio")
            lines.append(
                f"| {arch} | {shape} | {fmt_s(t['compute_s'])} | {fmt_s(t['memory_s'])} "
                f"| {fmt_s(t['collective_s'])} | {t['bottleneck'].replace('_s', '')} "
                f"| {r['memory']['peak_bytes'] / 2**30:.2f} "
                f"| {r['cost']['flops_per_device'] / 1e9:.1f} "
                f"| {(ratio if ratio else 0):.3f} | {(frac if frac else 0):.3f} |"
            )
    return lines


def delta_table(results: Dict, baseline: Dict, cells: List) -> List[str]:
    lines = ["| cell | metric | baseline | new | delta |", "|---|---|---|---|---|"]
    metrics = [
        ("peak GiB", lambda r: r["memory"]["peak_bytes"] / 2**30),
        ("FLOPs/dev", lambda r: float(r["cost"]["flops_per_device"])),
        ("collective B/dev", lambda r: float(r["collectives"]["total_bytes"])),
    ]
    for (arch, shape, mesh) in cells:
        b, r = baseline.get((arch, shape, mesh)), results.get((arch, shape, mesh))
        if not b or not r:
            continue
        for label, get in metrics:
            b0, r0 = get(b), get(r)
            if not b0 and not r0:
                continue
            d = (r0 - b0) / b0 * 100 if b0 else 0.0
            lines.append(f"| {arch}/{shape}/{mesh} | {label} | {b0:.4g} | {r0:.4g} | {d:+.1f}% |")
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--mesh", default="single_pod")
    args = ap.parse_args(argv)
    results = load(args.dir)
    print(f"## Roofline ({args.mesh}, {len(results)} cells loaded; H100 SXM data-sheet "
          "rates)\n")
    print("\n".join(table(results, args.mesh)))
    if args.baseline:
        baseline = load(args.baseline)
        cells = sorted(set(results) & set(baseline))
        print("\n## Deltas against the baseline\n")
        print("\n".join(delta_table(results, baseline, cells)))


if __name__ == "__main__":
    main()
