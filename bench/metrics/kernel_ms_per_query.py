"""kernel_ms_per_query: device ms in the port's own CUDA kernels (the
profiler's window) per request drained in it."""


def read(run):
    n, s = run.drained(), run.port_kernel_s()
    if not n or s is None:
        return None
    return s * 1e3 / n
