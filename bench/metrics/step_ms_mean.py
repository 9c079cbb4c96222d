"""step_ms_mean: the mean, in ms, of the QueryProfile ``device_step`` and
``epilogue`` stages (the first batch's device step and its host remainder)
of each first result in the window."""


def read(run):
    t = [a.profile["device_step"] + a.profile["epilogue"] for a in run.first_results()]
    return 1e3 * sum(t) / len(t) if t else None
