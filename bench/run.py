"""Run one cell of BENCHMARK.json on the card, once:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It makes its inputs from the seed, sets the port up and warms it, measures
for ``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON object as the last line of standard output
(``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its
per-layer metrics, the device's busy seconds and a breakdown). The numbers
compared, each beside its limit, close both that line and standard
error. It refuses to run without the CUDA cards the cell asks for, and
never falls back to the CPU.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # The program's build cache (build/) sits in the checkout already; a
    # Triton cache, were one used, goes there too, at a fixed path.
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    from bench import harness

    cell = harness.resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    phases = harness.Phases()
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_START,
                           phases=phases)
    found = harness.forbidden_loaded()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark may load neither JAX nor "
              "the JAX package", file=sys.stderr)
        return 3
    for name, s in phases.items():
        print(f"phase {name}: {s:.3f} s", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
