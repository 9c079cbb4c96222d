"""writer_blocked_share: writer seconds blocked on majors their appends
tripped (``plane_blocked_seconds_total`` of every epoch's plane) over the
writers' thread seconds in the window."""


def read(run):
    return sum(ep.blocked_s for ep in run.epochs) / (run.writers * run.seconds)
