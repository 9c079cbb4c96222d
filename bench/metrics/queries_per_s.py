"""queries_per_s: queries, aggregates and densities drained in full within
the window, over the window's seconds."""


def read(run):
    return run.drained() / run.seconds
