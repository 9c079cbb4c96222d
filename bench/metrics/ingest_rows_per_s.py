"""ingest_rows_per_s: rows that ingest() acknowledged in the window over
the window's seconds (an epoch the window cut counts the rows acknowledged
by then)."""


def read(run):
    return run.acked_in_window() / run.seconds
