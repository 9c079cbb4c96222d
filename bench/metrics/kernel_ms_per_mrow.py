"""kernel_ms_per_mrow: device ms in the port's own CUDA kernels (the
profiler's window) per million rows ingest() acknowledged in it."""


def read(run):
    rows, s = run.acked_in_window(), run.port_kernel_s()
    if not rows or s is None:
        return None
    return s * 1e3 / (rows / 1e6)
