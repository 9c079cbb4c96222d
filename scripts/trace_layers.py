"""Run one cell of the benchmark traced, with the port's own tracer on over
the measured window:

    python3 scripts/trace_layers.py --workload <cell> --seed <n> --seconds <s>

It is ``bench/run.py --trace 1`` with ``bench/program_spans.py``'s
``ProgramWindow`` in place of the benchmark's device window. So the result
line's ``breakdown.idle_gaps`` puts each idle gap of the card under the
innermost program span open on each thread (the benchmark's own spans
where none is), and its metrics add those of ``PROGRAM_METRICS`` listed
for the cell, read from the program's records by
``bench/metrics/<name>.py``. Standard error ends with the records the
tracer kept and dropped. A run of ``bench/run.py --trace 1`` with the same
seed is the same cell with the program's tracer off: the two lines'
per-layer readings differ by what the tracer costs.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The per-layer metrics that read the program's spans, as BENCHMARK.json
# would list them once the benchmark's traced window turns the tracer on.
_INGEST, _SERVE = ["webproxy-1ts.ingest"], ["webproxy-8ts.analysts"]
PROGRAM_METRICS = [
    {"name": "append_plan_share", "unit": "fraction", "better": "lower",
     "source": "program_span", "layer": "core/dist_ingest.py (TabletGroup majors)",
     "moves": "store_bytes_per_row", "workloads": _INGEST},
    {"name": "append_enqueue_share", "unit": "fraction", "better": "lower",
     "source": "program_span", "layer": "core/dist_ingest.py (TabletGroup majors)",
     "moves": "store_bytes_per_row", "workloads": _INGEST},
    {"name": "step_wait_share", "unit": "fraction", "better": "lower",
     "source": "program_span", "layer": "core/dist_query.py (QueryRun and its steps)",
     "moves": "store_bytes_per_row", "workloads": _SERVE},
    {"name": "readbacks_per_query", "unit": "readbacks/query", "better": "lower",
     "source": "program_span", "layer": "core/dist_query.py (QueryRun and its steps)",
     "moves": "store_bytes_per_row", "workloads": _SERVE},
]


def main(argv=None) -> int:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from bench import harness, program_spans, run, tracing
    from repro_torch import obs

    resolve = harness.resolve

    def with_program_metrics(name, root=harness.ROOT):
        cell = resolve(name, root)
        cell.per_layer += [m for m in PROGRAM_METRICS if name in m["workloads"]]
        return cell

    harness.resolve = with_program_metrics
    tracing.DeviceWindow = program_spans.ProgramWindow  # what run_cell opens
    run.T_START = T_START
    rc = run.main(list(sys.argv[1:] if argv is None else argv) + ["--trace", "1"])
    tracer = obs.get_tracer()
    print(f"program records kept {len(tracer.records)}, dropped {tracer.dropped}",
          file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
