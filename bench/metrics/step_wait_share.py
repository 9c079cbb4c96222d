"""step_wait_share: the seconds the group steps (``query.scan_range`` and
``query.scan_index_range`` spans) wait on the card before reading back
their counts and slates (``fence_s``), over the seconds of the
``query.step`` spans, the batches those group steps make up; both of the
spans that end in the window. Read from the program's records
(bench/program_spans.py); None without them."""
from bench import program_spans

GROUP_STEPS = ("query.scan_range", "query.scan_index_range")


def read(run):
    recs = program_spans.records(run) or ()
    steps = sum(r["dur"] for r in recs if r["name"] == "query.step")
    if not steps:
        return None
    return sum(r.get("fence_s", 0.0) for r in recs if r["name"] in GROUP_STEPS) / steps
