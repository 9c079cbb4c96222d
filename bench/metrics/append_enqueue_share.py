"""append_enqueue_share: of the seconds the ``ingest.append`` spans that
end in the window last, the share their ``enqueue_s`` takes: the batch's
and each chunk's plan's copies to the card and the append's launches
(``TabletGroup._append_rows``). Read from the program's records
(bench/program_spans.py); None without them."""
from bench import program_spans


def read(run):
    return program_spans.append_share(run, "enqueue_s")
