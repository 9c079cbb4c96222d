"""append_plan_share: of the seconds the ``ingest.append`` spans that end
in the window last (the append's hold of the group lock), the share their
``plan_s`` takes: room checks, each chunk's destinations, the host
mirrors (``TabletGroup._append_rows``). Read from the program's records
(bench/program_spans.py); None without them."""
from bench import program_spans


def read(run):
    return program_spans.append_share(run, "plan_s")
