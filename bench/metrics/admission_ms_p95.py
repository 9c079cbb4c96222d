"""admission_ms_p95: the 95th percentile, in ms, of the QueryProfile
``admission`` stage (submit to the dispatcher's turn: the scheduler's queue
and the device lock) of each first result in the window."""
import numpy as np


def read(run):
    t = [a.profile["admission"] for a in run.first_results()]
    return float(np.percentile(t, 95)) * 1e3 if t else None
