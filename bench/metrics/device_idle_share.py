"""device_idle_share: the share of the traced window in which no operation
ran on the card (the profiler's device events, their union)."""


def read(run):
    if run.trace is None or not run.trace.busy_s:
        return None
    return 1.0 - run.trace.busy_s / run.trace.window_s
