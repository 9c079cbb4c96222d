"""readbacks_per_query: the host's waits on the card before a read-back
(``fence_n`` of every program span that ends in the window: three a group
step, one a density read) per request drained in the window (the base of
kernel_ms_per_query). Read from the program's records
(bench/program_spans.py); None without them."""
from bench import program_spans


def read(run):
    recs = program_spans.records(run)
    drained = getattr(run, "drained", None)
    n = drained() if recs and drained else 0
    if not n:
        return None
    return sum(r.get("fence_n", 0) for r in recs) / n
