"""plan_ms_mean: the mean, in ms, of the QueryProfile ``plan`` and
``density_fence`` stages (run construction: snapshot, planner, program
preparation, the planner's density reads) of each first result in the
window."""


def read(run):
    t = [a.profile["plan"] + a.profile["density_fence"] for a in run.first_results()]
    return 1e3 * sum(t) / len(t) if t else None
