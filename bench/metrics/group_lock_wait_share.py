"""group_lock_wait_share: seconds spent waiting for the tablet groups'
locks (``OwnedLock.snapshot`` total_wait_s of every epoch's groups) over
the writers' thread seconds in the window."""


def read(run):
    return sum(ep.group_wait_s for ep in run.epochs) / (run.writers * run.seconds)
