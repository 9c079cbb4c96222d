"""ttfr_p95_ms: the 95th percentile, in ms, of every time to first result
in the window, each taken by the client thread from just before its
submit to holding its first result (numpy's linear percentile)."""
import numpy as np


def read(run):
    t = [a.t_first - a.t_submit for a in run.first_results()]
    return float(np.percentile(t, 95)) * 1e3 if t else None
